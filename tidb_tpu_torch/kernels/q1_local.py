"""M1: one shard's fused TPC-H Q1 — filter, group code and six exact
int64 partial sums.

Replaces tidb_tpu/parallel/mesh.py:57 `q1_local_kernel`, the flagship
program `__graft_entry__.entry()` compiles. The CUDA kernel is
csrc/q1_local.cu (its note gives the design and what bounds it);
`q1_local_ref` is the plain PyTorch version beside it.

`q1_local(nseg, cutoff, qty, price, disc, tax, rf, ls, ship, row_valid)`:

  * int64 [N] lanes: quantity, extended price, discount and tax (decimals
    at scale 2), the returnflag and linestatus dict codes, the packed
    shipdate; row_valid bool [N]
  * mask = row_valid & (ship <= cutoff); segment = rf * 2 + ls for a
    masked-in row, dropped when outside [0, nseg) (jax's segment_sum
    drops it: the overflow slot nseg is sliced off, other ids fall out)
  → int64 [6, nseg]: per segment the row count and the sums of quantity,
    price, disc_price = price * (100 - disc) (scale 4), charge =
    disc_price * (100 + tax) (scale 6) and discount, every product and sum
    wrapping mod 2^64 as XLA's int64 arithmetic does. Wrapping sums are
    exact whatever their order, so the result is bit-exact.

On the card, for nseg <= NS (the main path's: 8 in entry()'s spec, 6 in
the dryrun's), the kernel is a persistent grid of one block an SM over
tiles of TILE rows, each tile's eight streams copied into shared memory by
bulk copies STAGES tiles ahead, and one merge of the blocks' partials
through the stream's scratch (csrc/q1_local.cu;
tests/test_torch_dense_q1_plans.py models its tile schedule and copy
windows: every row read once, from inside its own 16-byte chunks, at any
start offset).

`q1_local` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernel or raises; `q1_local.launches` counts
the launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import count, library
from .tables import sm_count, stream_scratch

N_SUMS = 6
NS = 8  # the staged kernel's nseg at most (csrc/q1_local.cu NS)
TILE = 512  # rows a tile (csrc TILE)
STAGES = 4  # tiles a block keeps in flight (csrc STAGES)
PARTS_AT = 2  # scratch words before the blocks' partials: the ticket (csrc PARTS_AT)


def _check(nseg: int, lanes, row_valid) -> int:
    n = row_valid.shape[0]
    if nseg < 1:
        raise ValueError("q1_local: nseg >= 1")
    if row_valid.dtype != torch.bool or row_valid.dim() != 1:
        raise TypeError("q1_local: row_valid is bool [N]")
    for t in lanes:
        if t.dtype != torch.int64 or t.shape != (n,):
            raise TypeError(f"q1_local: lanes are int64 [{n}]")
    return n


def q1_local_ref(nseg: int, cutoff: int, qty, price, disc, tax, rf, ls, ship, row_valid) -> torch.Tensor:
    """Plain PyTorch version: the reference's jnp code, step by step."""
    _check(nseg, (qty, price, disc, tax, rf, ls, ship), row_valid)
    mask = row_valid & (ship <= cutoff)
    seg = torch.where(mask, rf * 2 + ls, nseg)
    seg = torch.where((seg >= 0) & (seg <= nseg), seg, nseg)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    vals = torch.stack([mask.to(torch.int64)]
                       + [torch.where(mask, x, 0) for x in (qty, price, disc_price, charge, disc)])
    out = torch.zeros((N_SUMS, nseg + 1), dtype=torch.int64, device=mask.device)
    return out.index_add_(1, seg, vals)[:, :nseg].contiguous()


_bound: set = set()


def _lib():
    lib = library("q1_local")
    if "q1_local" not in _bound:
        lib.tt_q1_local.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                                            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                                            ctypes.c_void_p]
        lib.tt_q1_local.restype = ctypes.c_int
        lib.tt_q1_grid.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.tt_q1_grid.restype = ctypes.c_int64
        _bound.add("q1_local")
    return lib


def q1_local(nseg: int, cutoff: int, qty, price, disc, tax, rf, ls, ship, row_valid) -> torch.Tensor:
    """int64 [6, nseg] partial sums of one shard (module doc)."""
    lanes = (qty, price, disc, tax, rf, ls, ship)
    dev = row_valid.device
    if dev.type == "cpu":
        return q1_local_ref(nseg, cutoff, *lanes, row_valid)
    if dev.type != "cuda":
        raise ValueError(f"q1_local: unsupported device {dev}")
    n = _check(nseg, lanes, row_valid)
    for t in lanes + (row_valid,):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"q1_local: inputs must be contiguous tensors on {dev}")
    out = torch.empty((N_SUMS, nseg), dtype=torch.int64, device=dev)
    n_sms, lib = sm_count(dev), _lib()
    args = [t.data_ptr() for t in lanes] + [row_valid.data_ptr(), n, nseg, cutoff, out.data_ptr(), n_sms]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if nseg <= NS:  # the staged kernel: its ticket and its blocks' partials in the stream's scratch
        with stream_scratch("q1_local", dev, PARTS_AT + lib.tt_q1_grid(n, n_sms) * N_SUMS * nseg) as buf:
            rc = lib.tt_q1_local(*args, buf.data_ptr(), stream)
    else:
        rc = lib.tt_q1_local(*args, None, stream)
    if rc != 0:
        raise RuntimeError(f"q1_local: kernel launch failed (cudaError {rc})")
    count(q1_local)
    return out


q1_local.launches = 0
