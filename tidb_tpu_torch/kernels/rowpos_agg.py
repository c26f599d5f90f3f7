"""P6: the rowpos MPP aggregation — partials scattered by the group's
build row, then the k best build rows by the fused ORDER BY aggregate.

Replaces `rowpos_agg_stage` of tidb_tpu/parallel/mpp.py:1788-1848, with
the lanes of `_agg_partials` (:2048-2080): at n_dev 1 (where psum_scatter
/ pmin / pmax are the identity), and over n_dev ranks, where the
collectives between the scatter and the picks come from the caller. The B-wide scatter is K4's
segment-lane mode (kernels/seg_agg.py), whose partials are the
reference's bit for bit (its NULL rows skipped, where the reference folds
a sentinel equal to the op's identity; a uint64 min / max lane, whose
sentinel takes part, is handed to K4 with the sentinel folded in); the k
best are picked by K6 (kernels/topk.py, lax.top_k's order). The CUDA
kernels of this module are csrc/rowpos_agg.cu: the segment lane, the
validity and score per build row, and the result rows at the picks.
`rowpos_agg_ref` is the plain PyTorch version beside them, the
reference's jnp code step by step.

`rowpos_agg(mask, rid, nseg, lanes, pres, score_lane, desc, k, ship_from,
rows=None, n_dev=1, collect=None)`:

  * mask  — bool [N], the chain's row mask
  * rid   — int64 [N], the build row id of the group level per row
  * nseg  — B, the build side's rows
  * lanes — red.RedLane partial lanes in `_agg_partials` order, the
            dedicated presence lane (a count over the mask) first where
            one is needed
  * pres / score_lane — the lanes holding the presence count and the
            ORDER BY aggregate; desc, k — its direction and LIMIT
  * ship_from — the first lane the result rows carry (1 past a dedicated
            presence lane)
  * rows  — optional int64 [2 + len(lanes) - ship_from, W >= kk] rows of
            the packed result: [gidx, valid, lanes...] at the picks
  * n_dev / collect — over n_dev > 1 ranks the scatter fills Bp =
            ceil(nseg / n_dev) * n_dev rows, and collect(full, ops) →
            (the rank's block of every lane, [blk] each; the block's first
            build row) applies the reference's collectives (psum_scatter,
            pmin / pmax and a slice); the picks run over that block
  → RowposAgg(idx, gidx, valid, full, score): kk = min(max(k,
    len(lanes) + 4), rows picked from) picks in lax.top_k's order, gidx =
    where(valid[idx], base + idx, -1), valid = presence > 0 per build row,
    the partial lanes picked from and the top-k score.

Integer lanes are bit-exact with the reference; float sums differ by
summation order (K4 adds with atomics).

`rowpos_agg` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernels or raises; `rowpos_agg.launches`
counts its calls that launched.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import red
from .build import count, library
from .seg_agg import seg_agg
from .topk import topk, topk_ref

MAX_LANES = 32


class RowposAgg(NamedTuple):
    idx: torch.Tensor
    gidx: torch.Tensor
    valid: torch.Tensor
    full: list
    score: torch.Tensor


def picks(k: int, n_lanes: int, nseg: int) -> int:
    """kk, widened to the output lane count (ref: :1840)."""
    return min(max(k, n_lanes + 4), nseg)


def rowpos_agg_ref(mask, rid, nseg, lanes, pres, score_lane, desc, k, ship_from, rows=None, n_dev=1,
                   collect=None) -> RowposAgg:
    """Plain PyTorch version: the reference's stage, step by step."""
    dev = mask.device
    space = -(-nseg // n_dev) * n_dev
    seg = torch.where(mask, torch.clip(rid, 0, nseg - 1), space)
    full = [red.scatter_ref(red.values_ref(ln, mask), seg, space, ln.op) for ln in lanes]
    base = 0
    if collect is not None:
        full, base = collect(full, [ln.op for ln in lanes])
    blk = full[0].shape[0]
    valid = full[pres] > 0
    score = red.topk_score_ordered(full[score_lane], valid, desc, False)
    kk = picks(k, len(lanes), blk)
    idx, _ = topk_ref(score, None, torch.ones(blk, dtype=torch.bool, device=dev), True, kk)
    i = idx.long()
    gidx = torch.where(valid[i], base + i, torch.full((), -1, dtype=torch.int64, device=dev))
    if rows is not None:
        rows[0, :kk] = gidx
        rows[1, :kk] = valid[i].to(torch.int64)
        for j, f in enumerate(full[ship_from:]):
            rows[2 + j, :kk] = red.bits(f[i])
    return RowposAgg(idx, gidx, valid, full, score)


def _check(mask, rid, nseg, lanes, pres, score_lane, ship_from, k):
    n = mask.shape[0]
    if mask.dtype != torch.bool or rid.dtype != torch.int64 or rid.shape != (n,) or nseg < 1:
        raise TypeError(f"rowpos_agg: mask bool [{n}], rid int64 [{n}], nseg >= 1")
    if not 1 <= len(lanes) <= MAX_LANES:
        raise ValueError(f"rowpos_agg: 1..{MAX_LANES} lanes")
    red.check_lanes(lanes, n, "rowpos_agg")
    if any(ln.op == "sum_u64" for ln in lanes):
        raise ValueError("rowpos_agg: _agg_partials sums a uint64 lane as int64 (sum_i64)")
    for j in (pres, score_lane):
        if not 0 <= j < len(lanes) or not lanes[j].is_sum or lanes[j].op.endswith("u64"):
            raise ValueError("rowpos_agg: the presence and score lanes are int64 / float64 sums or counts")
    if lanes[pres].is_float or not 0 <= ship_from <= pres + 1 or k < 0:
        raise ValueError("rowpos_agg: an integer presence lane, ship_from within the lanes, k >= 0")
    return n


_bound: set = set()


def _lib():
    lib = library("rowpos_agg")
    if "rowpos_agg" not in _bound:
        for fn in ("tt_rp_seg", "tt_rp_score", "tt_rp_emit"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        _bound.add("rowpos_agg")
    return lib


def _call(fn, words, dev):
    w = np.array(words, dtype=np.int64)
    rc = getattr(_lib(), fn)(w.ctypes.data, len(w), torch.cuda.get_device_properties(dev).multi_processor_count,
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rowpos_agg: {fn} launch failed (cudaError {rc})")


def rowpos_agg(mask, rid, nseg: int, lanes, pres: int, score_lane: int, desc: bool, k: int, ship_from: int,
               rows=None, n_dev: int = 1, collect=None) -> RowposAgg:
    """The rowpos aggregation and its top-k picks (module doc)."""
    dev = mask.device
    n = _check(mask, rid, nseg, lanes, pres, score_lane, ship_from, k)
    if dev.type == "cpu":
        return rowpos_agg_ref(mask, rid, nseg, lanes, pres, score_lane, desc, k, ship_from, rows, n_dev, collect)
    if dev.type != "cuda":
        raise ValueError(f"rowpos_agg: unsupported device {dev}")
    space = -(-nseg // n_dev) * n_dev
    if space >= 1 << 31:
        raise ValueError(f"rowpos_agg: {nseg} build rows exceed the int32 segment lane")
    for t in [mask, rid] + [t for ln in lanes for t in (ln.data, ln.valid) if t is not None]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"rowpos_agg: inputs must be contiguous tensors on {dev}")
    seg = torch.empty(n, dtype=torch.int32, device=dev)
    _call("tt_rp_seg", [n, nseg, rid.data_ptr(), seg.data_ptr()], dev)
    iout, fout = seg_agg(mask, [], [red.seg_lane(ln) for ln in lanes], space, seg=seg)
    full, ni, nf = [], 0, 0
    for ln in lanes:
        if ln.is_float:
            full.append(fout[nf])
            nf += 1
        else:
            full.append(iout[ni])
            ni += 1
    base = 0
    if collect is not None:
        full, base = collect(full, [ln.op for ln in lanes])
        full = [f.contiguous() for f in full]
    blk = full[0].shape[0]
    valid = torch.empty(blk, dtype=torch.bool, device=dev)
    sc = full[score_lane]
    score = torch.empty(blk, dtype=sc.dtype, device=dev)
    _call("tt_rp_score", [blk, int(bool(desc)), int(sc.dtype == torch.float64), full[pres].data_ptr(),
                          sc.data_ptr(), valid.data_ptr(), score.data_ptr()], dev)
    kk = picks(k, len(lanes), blk)
    idx, _ = topk(score, None, torch.ones(blk, dtype=torch.bool, device=dev), True, kk)
    gidx = torch.empty(kk, dtype=torch.int64, device=dev)
    shipped = full[ship_from:]
    if rows is not None and (rows.dtype != torch.int64 or rows.dim() != 2 or rows.shape[0] != 2 + len(shipped)
                             or rows.shape[1] < kk or rows.stride(1) != 1):
        raise TypeError(f"rowpos_agg: the result rows are int64 [{2 + len(shipped)}, >= {kk}], rows contiguous")
    words = [kk, len(shipped), idx.data_ptr(), valid.data_ptr(), base, gidx.data_ptr(),
             0 if rows is None else rows.data_ptr(), 0 if rows is None else rows.stride(0)]
    words += [f.data_ptr() for f in shipped]
    _call("tt_rp_emit", words, dev)
    count(rowpos_agg)
    return RowposAgg(idx, gidx, valid, full, score)


rowpos_agg.launches = 0
