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

On the card a call is host-bound (its device work is a few microseconds
a pass), so its host side is one pass and one copy: one workspace holds
the tables, seg, K4's rows, valid, score, K6's buffers and gidx (the
outputs are views of it); P6's parameter block, K4's one-task table
(`seg_agg.solo_desc`) and K6's task table (over a cached all-true mask,
`tables.all_true`) are written into a pinned staging buffer kept from
call to call (`tables.staging`) and go up in one copy; then seg → K4 →
(the collectives) → score → K6 → emit, with no host read. The score and
emit passes read the lanes through their strides (the mesh's blocks as
the collectives return them).

`rowpos_agg` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernels or raises; `rowpos_agg.launches`
counts its calls that launched.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import compact, red
from .build import count, library
from .seg_agg import LANE_DESC, TASK_DESC, launch_at, plan, seg_agg, solo_words
from .tables import all_true, sm_count, staging
from .topk import buffer_words as topk_buffer_words
from .topk import orders_in_kernel
from .topk import ordered as topk_ordered
from .topk import select_at as topk_select_at
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
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_rp_block_words.argtypes = []
        lib.tt_rp_block_words.restype = L
        lib.tt_rp_seg.argtypes = [C, L, I, C]
        lib.tt_rp_seg.restype = I
        for fn in ("tt_rp_score", "tt_rp_emit"):
            getattr(lib, fn).argtypes = [C, L, C, I, I, C]
            getattr(lib, fn).restype = I
        if lib.tt_rp_block_words() != len(BLOCK_FIELDS):
            raise RuntimeError("rowpos_agg: csrc/rowpos_agg.cu's RpBlock and BLOCK_FIELDS differ")
        _bound.add("rowpos_agg")
    return lib


def _raise(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"rowpos_agg: {fn} launch failed (cudaError {rc})")


# csrc/rowpos_agg.cu RpBlock: the call's parameter block, in order
BLOCK_FIELDS = ("n", "nseg", "rid", "seg", "blk", "desc", "is_float", "valid", "score", "kk", "idx", "gidx", "rows",
                "row_stride")


class Layout(NamedTuple):
    """One call's device workspace (int64 words; compact.workspace) and the
    table words it uploads: P6's parameter block, K4's one-task descriptor
    table, K6's task table — in one pinned copy to the workspace's head."""

    table_words: int
    k4_at: int  # word offsets in the workspace
    k6_at: int
    sizes: list  # the workspace's byte sizes, in order: tables, seg, iout, fout, valid, score, wide, narrow, okc, gidx


def layout(n: int, nl: int, n_f: int, space: int, blk: int, kk: int, wide: int, narrow: int) -> Layout:
    """The workspace of a call of n rows, nl lanes (n_f float) into `space`
    build rows, blk picked from, kk picks, K6's buffers of `wide` / `narrow`
    words (topk.buffer_words)."""
    k4 = TASK_DESC + LANE_DESC * nl
    k4_at = len(BLOCK_FIELDS)
    k6_at = k4_at + k4
    words = k6_at + 3
    return Layout(words, k4_at, k6_at, [8 * words, 4 * n, 8 * (nl - n_f) * space, 8 * n_f * space, blk, 8 * blk,
                                        8 * wide, 4 * narrow, kk, 8 * kk])


def block_words(base: int, offs: list, n: int, nseg: int, rid: int, blk: int, desc: bool, is_float: bool, kk: int,
                rows=None) -> list:
    """P6's parameter block for a workspace at device address `base` with
    the arrays at word offsets `offs` (layout's order), as BLOCK_FIELDS
    lists them."""
    at = [base + 8 * o for o in offs]
    return [n, nseg, rid, at[1], blk, int(bool(desc)), int(bool(is_float)), at[4], at[5], kk, at[7], at[9],
            0 if rows is None else rows.data_ptr(), 0 if rows is None else rows.stride(0)]


def lane_words(first: int, full: list, pres: int, score_lane: int, shipped: list) -> np.ndarray:
    """The lanes the score and emit passes read, by address and stride
    (csrc take_lanes), and the block's first build row `first`."""
    w = [first, full[pres].data_ptr(), full[pres].stride(0), full[score_lane].data_ptr(), full[score_lane].stride(0),
         len(shipped)]
    for f in shipped:
        w += [f.data_ptr(), f.stride(0)]
    return np.array(w, dtype=np.int64)


def rowpos_agg(mask, rid, nseg: int, lanes, pres: int, score_lane: int, desc: bool, k: int, ship_from: int,
               rows=None, n_dev: int = 1, collect=None) -> RowposAgg:
    """The rowpos aggregation and its top-k picks (module doc): one upload
    (the parameter block, K4's and K6's tables), no host read."""
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
    nl = len(lanes)
    blk = space // n_dev if collect is not None else space  # the rows the collectives leave this rank
    kk = picks(k, nl, blk)
    shipped_n = nl - ship_from
    if rows is not None and (rows.dtype != torch.int64 or rows.dim() != 2 or rows.shape[0] != 2 + shipped_n
                             or rows.shape[1] < kk or rows.stride(1) != 1 or rows.device != dev):
        raise TypeError(f"rowpos_agg: the result rows are int64 [{2 + shipped_n}, >= {kk}], rows contiguous")
    lib = _lib()
    n_f = sum(1 for ln in lanes if ln.is_float)
    sc_float = lanes[score_lane].is_float
    wide, narrow = topk_buffer_words(1, kk, blk)
    lay = layout(n, nl, n_f, space, blk, kk, wide, narrow)
    buf, offs = compact.workspace(dev, lay.sizes)
    base = buf.data_ptr()
    at = [base + 8 * o for o in offs]  # tables, seg, iout, fout, valid, score, wide, narrow, okc, gidx
    # K4 reads these lanes by address: a lane seg_lane makes (a uint64 min / max with NULLs) lives through the call
    seg_lanes = [red.seg_lane(ln) for ln in lanes]
    with staging("rowpos_agg", dev, lay.table_words) as st:  # the call's one upload
        host = st.host
        host[:lay.k4_at] = block_words(base, offs, n, nseg, rid.data_ptr(), blk, desc, sc_float, kk, rows)
        host[lay.k4_at:lay.k6_at] = solo_words(mask.data_ptr(), [], seg_lanes, base + 8 * lay.k4_at,
                                               at[2] if nl > n_f else 0, at[3] if n_f else 0, at[1])
        host[lay.k6_at:lay.table_words] = (at[5], 0, all_true(dev, blk).data_ptr())
        st.upload(buf, lay.table_words)
    n_sms, stream = sm_count(dev), torch.cuda.current_stream(dev).cuda_stream
    _raise(lib.tt_rp_seg(base, n, n_sms, stream), "tt_rp_seg")
    launch_at(base + 8 * lay.k4_at, dev, 1, n, 0, nl, space, False, plan(n, 1, 0, nl, space, n_sms), "seg_agg",
              stream)
    count(seg_agg)
    full, ni, nf = [], 0, 0  # K4's rows, views of the workspace
    for ln in lanes:
        if ln.is_float:
            o = offs[3] + nf * space
            full.append(buf[o:o + space].view(torch.float64))
            nf += 1
        else:
            o = offs[2] + ni * space
            full.append(buf[o:o + space])
            ni += 1
    first = 0
    if collect is not None:
        full, first = collect(full, [ln.op for ln in lanes])
        if any(f.dim() != 1 or f.shape[0] != blk or f.device != dev for f in full):
            raise ValueError(f"rowpos_agg: collect returns one [{blk}] block a lane on {dev}")
    lw = lane_words(first, full, pres, score_lane, full[ship_from:])
    _raise(lib.tt_rp_score(base, blk, lw.ctypes.data, lw.size, n_sms, stream), "tt_rp_score")
    topk_select_at(base + 8 * lay.k6_at, 1, sc_float, True, kk, blk, at[6], at[7], at[8], dev, stream)
    count(topk)
    idx = buf[offs[7]:offs[7] + (kk + 1) // 2].view(torch.int32)[:kk]  # K6's picks, where the block reads them
    if not orders_in_kernel(kk):  # past K6's ordering cap K8 orders them, back into place
        okc = buf[offs[8]:offs[8] + (kk + 7) // 8].view(torch.bool)[:kk]
        idx.copy_(topk_ordered(idx, buf[offs[6]:offs[6] + kk], okc, kk)[0])
    _raise(lib.tt_rp_emit(base, kk, lw.ctypes.data, lw.size, n_sms, stream), "tt_rp_emit")
    count(rowpos_agg)
    valid = buf[offs[4]:offs[4] + (blk + 7) // 8].view(torch.bool)[:blk]
    score = buf[offs[5]:offs[5] + blk]
    return RowposAgg(idx, buf[offs[9]:offs[9] + kk], valid, full, score.view(torch.float64) if sc_float else score)


rowpos_agg.launches = 0
