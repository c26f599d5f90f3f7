"""P9: the exact top k of a long score lane (score descending, equal scores
by position), and the rows of the clustered aggregation's result.

Replaces tidb_tpu/parallel/mpp.py:2008-2045 (`_block_topk`) and the tail
of `clustered_agg_stage` (:1914-1929). The CUDA kernels are
csrc/block_topk.cu: two launches a call, no host read — the chunk maxima
by warp reductions and, in the last block, the kk best chunks; then the
kk best entries of each of those chunks and, in the last block, their
merge, sort and result rows (its note gives the order, the argument and
the bound). `block_topk_ref` is the plain PyTorch version beside it, the
reference's block-maximum extraction step by step.

`block_topk(v, k, emit=None)`:

  * v — int64 or float64 [n], the score lane; 1 <= k <= n
  * emit — optional `Emit(rows, valid, gpos, lanes)`: rows an int64
    [2 + len(lanes), >= k] view of the packed result's rows, valid bool
    [n], gpos int64 [n], lanes int64/float64 [n] each. For pick t at ti:
      tvalid = valid[ti] & v[ti] > floor (INT64_MIN or -inf)
      rows[0, t] = tvalid ? gpos[ti] : -1,  rows[1, t] = tvalid,
      rows[2 + j, t] = lanes[j][ti] (float64 as its bits)
  → (vals, idx): the k picks' scores and positions.

The order is jnp.argmax's: NaN above everything (first NaN first), -0.0
tied with +0.0. Picks past the last score above the floor are masked by
tvalid; there the reference repeats positions, this kernel does not, so
only valid picks compare (they agree in value, position and slot).

`block_topk` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernels or raises; `block_topk.launches`
counts the calls that launched.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .build import count, library
from .tables import sm_count, stream_scratch

BLK = 1024
MAX_K = 512  # the final picks are sorted by one 512-thread block
MAX_LANES = 32
_I64_MIN = -(1 << 63)


class Emit(NamedTuple):
    rows: torch.Tensor
    valid: torch.Tensor
    gpos: torch.Tensor
    lanes: list


def block_topk_ref(v, k: int, blk: int = BLK):
    """Plain PyTorch version of the reference's _block_topk: block maxima,
    then k rounds of (take the best block's maximum, recompute that
    block's maximum with the taken positions masked out)."""
    n = v.shape[0]
    if v.dtype == torch.float64:
        lo = torch.full((), float("-inf"), dtype=v.dtype, device=v.device)
    else:
        lo = torch.full((), _I64_MIN, dtype=v.dtype, device=v.device)
    pad = (-n) % blk
    vp = torch.cat([v, lo.expand(pad)]) if pad else v
    m2 = vp.reshape(-1, blk)
    bm = _max(m2, 1)
    bi = _argmax(m2, 1).to(torch.int32)
    vals, idxs = [], []
    tb = torch.full((k,), -1, dtype=torch.int32, device=v.device)
    tp = torch.full((k,), -1, dtype=torch.int32, device=v.device)
    car = torch.arange(blk, dtype=torch.int32, device=v.device)
    for t in range(k):
        j = int(_argmax(bm, 0))
        vals.append(bm[j].clone())
        idxs.append(j * blk + int(bi[j]))
        tb[t] = j
        tp[t] = bi[j]
        row = m2[j]
        taken = torch.zeros(blk, dtype=torch.bool, device=v.device)
        for u in range(t + 1):
            taken = taken | ((tb[u] == j) & (car == tp[u]))
        row = torch.where(taken, lo, row)
        bm[j] = _max(row, 0)
        bi[j] = _argmax(row, 0).to(torch.int32)
    return torch.stack(vals), torch.clip(torch.tensor(idxs, dtype=torch.int64, device=v.device), 0, n - 1)


def _nan_low(x):
    """NaN → -inf, ±inf kept (nan_to_num's default would clip them)."""
    return torch.nan_to_num(x, nan=float("-inf"), posinf=float("inf"), neginf=float("-inf"))


def _max(x, dim):
    """jnp.max: NaN propagates."""
    if x.dtype == torch.float64:
        nan = torch.isnan(x).any(dim)
        return torch.where(nan, torch.full((), float("nan"), dtype=x.dtype, device=x.device),
                           torch.amax(_nan_low(x), dim))
    return torch.amax(x, dim)


def _argmax(x, dim):
    """jnp.argmax: the first NaN, else the first maximum (-0.0 == +0.0)."""
    if x.dtype == torch.float64:
        isn = torch.isnan(x)
        has = isn.any(dim)
        first_nan = torch.argmax(isn.to(torch.int8), dim)
        xm = _nan_low(x)
        top = torch.amax(xm, dim, keepdim=True)
        first_max = torch.argmax((xm == top).to(torch.int8), dim)
        return torch.where(has, first_nan, first_max)
    top = torch.amax(x, dim, keepdim=True)
    return torch.argmax((x == top).to(torch.int8), dim)


def _floor(v):
    if v.dtype == torch.float64:
        return torch.full((), float("-inf"), dtype=v.dtype, device=v.device)
    return torch.full((), _I64_MIN, dtype=v.dtype, device=v.device)


def emit_ref(vals, idx, v, emit: Emit) -> None:
    """Plain PyTorch version of the result rows (ref: :1922-1929)."""
    k = idx.shape[0]
    tvalid = emit.valid[idx] & (vals > _floor(v))
    emit.rows[0, :k] = torch.where(tvalid, emit.gpos[idx], torch.full((), -1, dtype=torch.int64, device=v.device))
    emit.rows[1, :k] = tvalid.to(torch.int64)
    for j, lane in enumerate(emit.lanes):
        x = lane[idx]
        emit.rows[2 + j, :k] = x.view(torch.int64) if x.dtype == torch.float64 else x


def _check(v, k, emit):
    n = v.shape[0]
    if v.dtype not in (torch.int64, torch.float64) or v.dim() != 1 or n < 1:
        raise TypeError("block_topk: the score lane is int64/float64 [n >= 1]")
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"block_topk: k={k} outside 1..min(n, {MAX_K})")
    if emit is not None:
        if len(emit.lanes) > MAX_LANES:
            raise ValueError(f"block_topk: at most {MAX_LANES} lanes")
        if emit.rows.dtype != torch.int64 or emit.rows.dim() != 2 or emit.rows.shape[0] != 2 + len(emit.lanes) \
                or emit.rows.shape[1] < k:
            raise TypeError(f"block_topk: rows is int64 [{2 + len(emit.lanes)}, >= {k}]")
        if emit.valid.dtype != torch.bool or emit.valid.shape != (n,) or emit.gpos.dtype != torch.int64 \
                or emit.gpos.shape != (n,):
            raise TypeError(f"block_topk: valid is bool [{n}], gpos int64 [{n}]")
        for lane in emit.lanes:
            if lane.dtype not in (torch.int64, torch.float64) or lane.shape != (n,):
                raise TypeError(f"block_topk: a lane is int64/float64 [{n}]")
    return n


_bound: set = set()


def _lib():
    lib = library("block_topk")
    if "block_topk" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_bt_scratch_words.argtypes = [L, I]
        lib.tt_bt_scratch_words.restype = L
        lib.tt_bt_run.argtypes = [C, I, L, I, C, C, C, C, I, I, C]
        lib.tt_bt_run.restype = I
        _bound.add("block_topk")
    return lib


def block_topk(v, k: int, emit: Emit | None = None):
    """(vals, idx) of the k best scores; with `emit`, the result rows."""
    dev = v.device
    n = _check(v, k, emit)
    if dev.type == "cpu":
        vals, idx = block_topk_ref(v, k)
        if emit is not None:
            emit_ref(vals, idx, v, emit)
        return vals, idx
    if dev.type != "cuda":
        raise ValueError(f"block_topk: unsupported device {dev}")
    tensors = [v] + ([] if emit is None else [emit.rows[i] for i in range(emit.rows.shape[0])]
                     + [emit.valid, emit.gpos] + list(emit.lanes))
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"block_topk: inputs must be contiguous tensors on {dev}")
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    idx = torch.empty(k, dtype=torch.int64, device=dev)
    vals = torch.empty(k, dtype=v.dtype, device=dev)
    words = None
    if emit is not None:
        words = np.array([len(emit.lanes), emit.valid.data_ptr(), emit.gpos.data_ptr()]
                         + [x.data_ptr() for x in emit.lanes]
                         + [emit.rows[i].data_ptr() for i in range(emit.rows.shape[0])], dtype=np.int64)
    with stream_scratch("block_topk", dev, lib.tt_bt_scratch_words(n, k)) as ws:
        rc = lib.tt_bt_run(v.data_ptr(), int(v.dtype == torch.float64), n, k, ws.data_ptr(), idx.data_ptr(),
                           vals.data_ptr(), 0 if words is None else words.ctypes.data,
                           0 if words is None else len(words), sm_count(dev), stream)
    if rc != 0:
        raise RuntimeError(f"block_topk: kernel launch failed (cudaError {rc})")
    count(block_topk)
    return vals, idx


block_topk.launches = 0
