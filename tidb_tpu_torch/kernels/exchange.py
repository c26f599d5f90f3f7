"""P2: the MPP hash exchange's device half — every row of a mask into its
owner's bucket of one send buffer, in row order, every lane at once.

Replaces `exchange_all` of tidb_tpu/parallel/mpp.py:1465-1514 up to its
`all_to_all`, with the owner key of `pack_keys` (:1451). The CUDA kernels
are csrc/exchange.cu (one sweep and a fill; their note gives the design
and the bound);
`exchange_ref` is the plain PyTorch version beside them, the reference's
jnp code step by step. The collective itself is the mesh's
(parallel/mesh.Mesh.all_to_all): one all_to_all of the whole send buffer
per exchange, not one per lane.

`exchange(n_dev, bcap, mask, keys, key_i32, probe, lanes)`:

  * keys    — [OwnerKey(data int64 [N], valid bool [N] or None, lo,
              stride)]: okey = sum of (d - lo) * stride (int64 wrap),
              truncated to int32 where `key_i32`; on a `probe` side a row
              whose key is not valid owns by its row index (the
              reference's where(pkv, pkey, arange(rows)))
  * mask    — bool [N]: owner = okey mod n_dev (floored, jnp's `%`) for
              the rows in it; the others go to no bucket
  * lanes   — [N] tensors of 8 (int64, float64), 4 (int32) or 1 (bool)
              bytes a row
  → (send int64 [n_dev, W], dropped int64 [1]): row o of `send` holds
    owner o's bucket of every lane, bcap slots each at the 16-byte-aligned
    byte offsets of `layout`, the owner's rows in row order (the
    reference's stable argsort), zero past the owner's count and in the
    padding; dropped = sum over the owners of max(count - bcap, 0).

`unpack(recv, lanes, n_dev, bcap)` cuts the buffer an all_to_all returns
(row s from peer s) into each lane's [n_dev * bcap] received rows, peer by
peer: the reference's `all_to_all(buf, axis, 0, 0, tiled=True)` reshaped.

`exchange` takes the plain version only for tensors on the CPU. On a CUDA
device it launches the kernels (two a call, whatever the lane count; the
send buffer and `dropped` are views of one `torch.empty`, which the
kernels write byte for byte; the look-back scratch is the stream's
`tables.stream_scratch`) or raises; `exchange.launches` counts its calls
that launched.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .build import count, library
from .tables import host_words, sm_count, stream_scratch

MAX_DEV, MAX_KEYS = 64, 8
ALIGN = 16  # bytes: every lane's slots start on it, a send row is a multiple of it
_SIZES = {torch.int64: 8, torch.float64: 8, torch.int32: 4, torch.bool: 1}


class OwnerKey(NamedTuple):
    data: torch.Tensor
    valid: torch.Tensor | None
    lo: int
    stride: int


def bucket_cap(rows: int, n_dev: int) -> int:
    """Slots per owner: slack 2 and a small-size margin (ref: :1484-1485)."""
    return min(-(-rows * 2 // n_dev) + 64, rows)


def layout(lanes, bcap: int) -> tuple[list[int], int]:
    """(byte offset of each lane's bcap slots in a send row, the row's
    length in int64 words): 8-byte lanes first, then 4-, then 1-byte
    ones, each lane's slots starting on an ALIGN-byte boundary, the row a
    multiple of ALIGN bytes (at least one), so that the kernel writes
    every slot's 16-byte unit with one aligned store."""
    offs = [0] * len(lanes)
    at = 0
    for size in (8, 4, 1):
        for j, t in enumerate(lanes):
            if _SIZES[t.dtype] == size:
                offs[j] = at
                at += -(-bcap * size // ALIGN) * ALIGN
    return offs, max(at, ALIGN) // 8


def owner_key_ref(keys, key_i32: bool, probe: bool, n: int) -> torch.Tensor:
    """The int64 owner key of every row (module doc)."""
    acc = kv = None
    for k in keys:
        term = (k.data.to(torch.int64) - k.lo) * k.stride
        acc = term if acc is None else acc + term
        if k.valid is not None:
            kv = k.valid if kv is None else kv & k.valid
    if key_i32:
        acc = acc.to(torch.int32).to(torch.int64)
    if probe and kv is not None:
        acc = torch.where(kv, acc, torch.arange(n, dtype=torch.int64, device=acc.device))
    return acc


def _lane_view(buf: torch.Tensor, t: torch.Tensor, off: int, bcap: int) -> torch.Tensor:
    """Lane t's [n_dev, bcap] slots inside the int64 send / receive rows."""
    size = _SIZES[t.dtype]
    return buf.view(torch.uint8)[:, off:off + bcap * size].view(t.dtype)


def exchange_ref(n_dev: int, bcap: int, mask, keys, key_i32: bool, probe: bool, lanes):
    """Plain PyTorch version: the reference's stable sort by owner, counts,
    offsets and bucket gather."""
    n = _check(n_dev, bcap, mask, keys, lanes)
    dev = mask.device
    own = torch.where(mask, torch.remainder(owner_key_ref(keys, key_i32, probe, n), n_dev), n_dev)
    order = torch.argsort(own, stable=True)
    counts = torch.bincount(own, minlength=n_dev + 1)[:n_dev]
    starts = torch.cumsum(counts, 0) - counts
    kept = counts.clamp(max=bcap)
    dropped = (counts - kept).sum().reshape(1)
    slot = torch.arange(bcap, dtype=torch.int64, device=dev)
    src = order[(starts[:, None] + slot[None, :]).clamp(0, max(n - 1, 0))]
    filled = slot[None, :] < kept[:, None]
    offs, words = layout(lanes, bcap)
    send = torch.zeros((n_dev, words), dtype=torch.int64, device=dev)
    for t, off in zip(lanes, offs):
        zero = torch.zeros((), dtype=t.dtype, device=dev)
        _lane_view(send, t, off, bcap).copy_(torch.where(filled, t[src], zero))
    return send, dropped


def unpack(recv: torch.Tensor, lanes, n_dev: int, bcap: int) -> list:
    """Each lane's received rows, [n_dev * bcap] contiguous (module doc)."""
    offs, _ = layout(lanes, bcap)
    return [_lane_view(recv, t, off, bcap).reshape(n_dev * bcap) for t, off in zip(lanes, offs)]


def _check(n_dev, bcap, mask, keys, lanes) -> int:
    n = mask.shape[0]
    if mask.dtype != torch.bool or mask.dim() != 1 or n >= 1 << 31:
        raise TypeError("exchange: mask is bool [N], N < 2^31")
    if not 1 <= n_dev <= MAX_DEV or bcap < 1 or not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"exchange: 1 <= n_dev <= {MAX_DEV}, bcap >= 1, 1..{MAX_KEYS} keys")
    for k in keys:
        if k.data.dtype != torch.int64 or k.data.shape != (n,) or \
                (k.valid is not None and (k.valid.dtype != torch.bool or k.valid.shape != (n,))):
            raise TypeError(f"exchange: a key is int64 [{n}] with an optional bool [{n}] valid lane")
    for t in lanes:
        if t.dtype not in _SIZES or t.shape != (n,):
            raise TypeError(f"exchange: a lane is [{n}] of int64, float64, int32 or bool, got {t.dtype}")
    return n


_bound: set = set()


def _lib():
    lib = library("exchange")
    if "exchange" not in _bound:
        lib.tt_exchange.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.tt_exchange.restype = ctypes.c_int
        lib.tt_exchange_scratch.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.tt_exchange_scratch.restype = ctypes.c_int64
        lib.tt_exchange_max_lanes.restype = ctypes.c_int
        _bound.add("exchange")
    return lib


def exchange(n_dev: int, bcap: int, mask, keys, key_i32: bool, probe: bool, lanes):
    """The send buffer and the local dropped count (module doc)."""
    dev = mask.device
    if dev.type == "cpu":
        return exchange_ref(n_dev, bcap, mask, keys, key_i32, probe, lanes)
    if dev.type != "cuda":
        raise ValueError(f"exchange: unsupported device {dev}")
    n = _check(n_dev, bcap, mask, keys, lanes)
    for t in [mask] + [t for k in keys for t in (k.data, k.valid) if t is not None] + list(lanes):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"exchange: inputs must be contiguous tensors on {dev}")
    lib = _lib()
    if len(lanes) > lib.tt_exchange_max_lanes():
        raise ValueError(f"exchange: at most {lib.tt_exchange_max_lanes()} lanes a call")
    offs, words = layout(lanes, bcap)
    # the send buffer and `dropped` are views of one allocation; the kernels
    # write every byte of both, so nothing is zeroed here
    buf = torch.empty(n_dev * words + 1, dtype=torch.int64, device=dev)
    send, dropped = buf[:n_dev * words].view(n_dev, words), buf[n_dev * words:]
    w = [n, n_dev, bcap, mask.data_ptr(), send.data_ptr(), words * 8, dropped.data_ptr(),
         len(keys), int(bool(key_i32)), int(bool(probe))]
    for k in keys:
        w += [k.data.data_ptr(), 0 if k.valid is None else k.valid.data_ptr(), k.lo, k.stride]
    w.append(len(lanes))
    for t, off in zip(lanes, offs):
        w += [t.data_ptr(), off, _SIZES[t.dtype]]
    with stream_scratch("exchange", dev, lib.tt_exchange_scratch(n, n_dev)) as scratch:
        rc = lib.tt_exchange(host_words(w), len(w), scratch.data_ptr(), sm_count(dev),
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exchange: kernel launch failed (cudaError {rc})")
    count(exchange)
    return send, dropped


exchange.launches = 0
