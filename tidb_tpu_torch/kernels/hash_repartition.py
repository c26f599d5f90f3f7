"""M3: the local half of the MPP hash exchange — rows into per-owner
send buffers.

Replaces the body of `local` in tidb_tpu/parallel/mesh.py:104
`hash_repartition` up to its `all_to_all` (the collectives are
torch.distributed calls, parallel/mesh.py). The CUDA kernels are
csrc/hash_repartition.cu (one sweep with look-back, then a fill of the
slots no row reached; their note gives the design and what bounds them);
`hash_repartition_ref` is the plain PyTorch version beside them.

`hash_repartition(keys, payload, valid, n_dev, cap)`:

  * keys, payload — int64 [N]; valid — bool [N]
  * owner = key mod n_dev, floored (jnp's `%`: a negative key still owns
    a device in [0, n_dev)); invalid rows own the bin n_dev
  * rows keep their order within an owner (the reference's stable argsort
    by owner); row r of owner o lands at send buffer [o, r] when r < cap
  → (keys [n_dev, cap], payload [n_dev, cap], valid bool [n_dev, cap],
    dropped int64 [1]): zeros where unused; dropped counts the valid rows
    with no slot under cap.

One behaviour of the reference is kept as it is: its scatter clips every
row's target into [0, cap), so a row without a slot (and, in the last
bucket, an invalid row) lands on slot cap - 1 too, and XLA's CPU scatter
keeps the last writer, a zero. So slot (o, cap - 1) comes back empty when
owner o has more than cap rows, or when o is the last owner, has exactly
cap rows and the shard holds an invalid row; that row is not counted in
`dropped`. With the default cap (the shard's row count) neither happens.

`hash_repartition` takes the plain version only for tensors on the CPU.
On a CUDA device it launches the kernels (two a call; the outputs are
views of one `torch.empty`, the look-back scratch is the stream's
`tables.stream_scratch`) or raises; `hash_repartition.launches` counts its calls that launched.
"""

from __future__ import annotations

import ctypes

import torch

from .build import count, library
from .tables import sm_count, stream_scratch

MAX_DEV = 1024


def _check(keys, payload, valid, n_dev: int, cap: int) -> int:
    n = keys.shape[0]
    if not 1 <= n_dev <= MAX_DEV or cap < 1 or n >= 1 << 31:
        raise ValueError(f"hash_repartition: 1 <= n_dev <= {MAX_DEV}, cap >= 1, fewer than 2^31 rows")
    if keys.dtype != torch.int64 or payload.dtype != torch.int64 or valid.dtype != torch.bool \
            or keys.shape != (n,) or payload.shape != (n,) or valid.shape != (n,):
        raise TypeError("hash_repartition: keys and payload int64 [N], valid bool [N]")
    return n


def hash_repartition_ref(keys, payload, valid, n_dev: int, cap: int):
    """Plain PyTorch version: the reference's stable sort by owner, counts,
    offsets and clipped scatter (its last-writer slot included)."""
    n = _check(keys, payload, valid, n_dev, cap)
    dev = keys.device
    own = torch.where(valid, torch.remainder(keys, n_dev), n_dev)
    order = torch.argsort(own, stable=True)
    own_s = own[order]
    counts = torch.bincount(own_s, minlength=n_dev + 1)
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(n, device=dev) - starts[own_s]
    ok = (own_s < n_dev) & (within < cap)
    o, w = own_s[ok], within[ok]
    buf_k = torch.zeros((n_dev, cap), dtype=torch.int64, device=dev)
    buf_p = torch.zeros((n_dev, cap), dtype=torch.int64, device=dev)
    buf_v = torch.zeros((n_dev, cap), dtype=torch.bool, device=dev)
    buf_k[o, w] = keys[order][ok]
    buf_p[o, w] = payload[order][ok]
    buf_v[o, w] = True
    # the reference's clipped scatter: a later row without a slot empties slot cap - 1
    emptied = counts[:n_dev] > cap
    if int(counts[n_dev - 1]) == cap and int(counts[n_dev]) > 0:
        emptied[n_dev - 1] = True
    buf_k[emptied, cap - 1] = 0
    buf_p[emptied, cap - 1] = 0
    buf_v[emptied, cap - 1] = False
    dropped = (counts[:n_dev] - cap).clamp(min=0).sum().reshape(1)
    return buf_k, buf_p, buf_v, dropped


_bound: set = set()


def _lib():
    lib = library("hash_repartition")
    if "hash_repartition" not in _bound:
        lib.tt_hash_repartition.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64] + \
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        lib.tt_hash_repartition.restype = ctypes.c_int
        lib.tt_hash_repartition_scratch.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.tt_hash_repartition_scratch.restype = ctypes.c_int64
        _bound.add("hash_repartition")
    return lib


def hash_repartition(keys, payload, valid, n_dev: int, cap: int):
    """The send buffers and the dropped count (module doc)."""
    dev = keys.device
    if dev.type == "cpu":
        return hash_repartition_ref(keys, payload, valid, n_dev, cap)
    if dev.type != "cuda":
        raise ValueError(f"hash_repartition: unsupported device {dev}")
    n = _check(keys, payload, valid, n_dev, cap)
    for t in (keys, payload, valid):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"hash_repartition: inputs must be contiguous tensors on {dev}")
    lib = _lib()
    # the outputs are views of one allocation; the kernels write every slot
    # and `dropped`, so nothing is zeroed here
    nc = n_dev * cap
    buf = torch.empty(2 * nc + 1 + (nc + 7) // 8, dtype=torch.int64, device=dev)
    buf_k, buf_p, dropped = buf[:nc].view(n_dev, cap), buf[nc:2 * nc].view(n_dev, cap), buf[2 * nc:2 * nc + 1]
    buf_v = buf[2 * nc + 1:].view(torch.bool)[:nc].view(n_dev, cap)
    with stream_scratch("hash_repartition", dev, lib.tt_hash_repartition_scratch(n, n_dev)) as scratch:
        rc = lib.tt_hash_repartition(keys.data_ptr(), payload.data_ptr(), valid.data_ptr(), n, n_dev, cap,
                                     buf_k.data_ptr(), buf_p.data_ptr(), buf_v.data_ptr(), dropped.data_ptr(),
                                     scratch.data_ptr(), sm_count(dev), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hash_repartition: kernel launch failed (cudaError {rc})")
    count(hash_repartition)
    return buf_k, buf_p, buf_v, dropped


hash_repartition.launches = 0
