"""P7: per-run totals over a key-sorted stream — the clustered aggregation
of a fused MPP chain.

Replaces tidb_tpu/parallel/mpp.py:1850-1913 (`clustered_agg_stage` up to
its top-k) and :1984 `_topk_score`. The CUDA kernel is csrc/run_agg.cu
(one reverse sweep with look-back carries, one launch; its note gives the
design and the bound); `run_agg_ref` is the plain PyTorch version beside
it, the reference's cumsum and run-end gathers step by step.

`run_agg(kd, mask, lanes, cnt_lane, rid_lane, score_lane, desc)`:

  * kd    — int64 [L], the stream's group key (equal keys are contiguous)
  * mask  — bool [L], the chain's row mask
  * lanes — [(data, valid)]: data int64 or float64 [L], or None for a
            count lane; valid bool [L] or None (then ok = mask). A lane's
            row value is data where mask & valid, else 0 (a count lane: 1
            where mask & valid)
  * cnt_lane / rid_lane / score_lane — the lanes holding the group's
            match count, the sum of the matched rows' build row ids, and
            the ORDER BY aggregate
  * desc  — ORDER BY DESC
  → (totals, gpos, valid, score): per lane the sum from each row to the
    end of its run (at a run's first row: the run's total; the plain
    version sums a float run there directly, past the lane's first
    non-finite row it keeps the reference's prefix differences), the group's
    build row (rid_sum // cnt, -1 where cnt is 0), run start & cnt > 0,
    and the top-k score (where(valid, ±total, floor))

Integer totals are bit-exact with the reference, overflow or not (both
add modulo 2^64); float totals agree up to summation order. The outputs
of a call are views of one allocation (`outputs`); the kernel's look-back
scratch is the stream's (`tables.stream_scratch`).

`run_agg` takes the plain version only for tensors on the CPU. On a CUDA
device it launches the kernel or raises; `run_agg.launches` counts the
calls that launched.
"""

from __future__ import annotations

import ctypes

import torch

from .build import count, library
from .tables import stream_scratch

_I64_MAX = (1 << 63) - 1
MAX_LANES = 16


def topk_score(val, valid, desc: bool):
    """The top-k operand: invalid slots sink to the dtype floor, the
    ascending negation happens INSIDE the where (ref: mpp.py:1984)."""
    if val.dtype == torch.float64:
        floor = torch.full((), float("-inf"), dtype=torch.float64, device=val.device)
    else:
        floor = torch.full((), -_I64_MAX, dtype=torch.int64, device=val.device)
    return torch.where(valid, val if desc else -val, floor)


def _lane_values(mask, d, v):
    ok = mask if v is None else (mask & v)
    if d is None:
        return ok.to(torch.int64)
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return torch.where(ok, d, zero)


def run_agg_ref(kd, mask, lanes, cnt_lane: int, rid_lane: int, score_lane: int, desc: bool):
    """Plain PyTorch version: cumsum + run-end gathers (ref: :1863-1911)."""
    nloc = mask.shape[0]
    idx = torch.arange(nloc, dtype=torch.int64, device=kd.device)
    brk = kd[1:] != kd[:-1]
    one = torch.ones(1, dtype=torch.bool, device=kd.device)
    first = torch.cat([one, brk])
    last = torch.cat([brk, one])
    rend = -torch.cummax(torch.where(last, -idx, torch.full((), -(nloc - 1), dtype=torch.int64,
                                                              device=kd.device)).flip(0), 0).values.flip(0)

    def run_sum(vals):
        c = torch.cumsum(vals, 0)
        prev = torch.cat([torch.zeros(1, dtype=c.dtype, device=c.device), c[:-1]])
        out = c[rend] - prev
        if vals.dtype != torch.float64:
            return out
        # a float run's total, at its first row, summed directly when the
        # run ends before the lane's first non-finite row: the difference
        # of two large prefixes loses a short run's low bits (a 147.11 run
        # after a 3.3e9 prefix came out 1.6e-6 off). Past that row the
        # prefix differences stay, with the reference's NaN / inf
        run = torch.cumsum(first.to(torch.int64), 0) - 1
        direct = torch.zeros(nloc, dtype=vals.dtype, device=vals.device).index_add_(0, run, vals)
        poison = torch.where(torch.isfinite(vals), torch.full((), nloc, dtype=torch.int64, device=kd.device),
                             idx).min()
        return torch.where(first & (rend < poison), direct[run], out)

    totals = [run_sum(_lane_values(mask, d, v)) for d, v in lanes]
    match_cnt, rid_sum = totals[cnt_lane], totals[rid_lane]
    gpos = torch.where(match_cnt > 0, torch.div(rid_sum, torch.clamp(match_cnt, min=1), rounding_mode="floor"),
                       torch.full((), -1, dtype=torch.int64, device=kd.device))
    valid = first & (match_cnt > 0)
    return totals, gpos, valid, topk_score(totals[score_lane], valid, desc)


def _check(kd, mask, lanes, cnt_lane, rid_lane, score_lane):
    L = kd.shape[0]
    if kd.dtype != torch.int64 or kd.dim() != 1 or L < 1:
        raise TypeError("run_agg: kd is int64 [L >= 1]")
    if mask.dtype != torch.bool or mask.shape != (L,):
        raise TypeError(f"run_agg: mask is bool [{L}]")
    if not 1 <= len(lanes) <= MAX_LANES:
        raise ValueError(f"run_agg: 1..{MAX_LANES} lanes")
    for d, v in lanes:
        if d is not None and (d.dtype not in (torch.int64, torch.float64) or d.shape != (L,)):
            raise TypeError(f"run_agg: a lane's data is int64/float64 [{L}]")
        if v is not None and (v.dtype != torch.bool or v.shape != (L,)):
            raise TypeError(f"run_agg: a lane's valid is bool [{L}]")
    for i in (cnt_lane, rid_lane, score_lane):
        if not 0 <= i < len(lanes):
            raise ValueError("run_agg: lane index out of range")
    for i in (cnt_lane, rid_lane):
        d = lanes[i][0]
        if d is not None and d.dtype != torch.int64:
            raise TypeError("run_agg: the count and row-id lanes are integer")
    return L


_bound: set = set()


def _lib():
    lib = library("run_agg")
    if "run_agg" not in _bound:
        lib.tt_run_agg_scratch_words.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.tt_run_agg_scratch_words.restype = ctypes.c_int64
        lib.tt_run_agg.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.tt_run_agg.restype = ctypes.c_int
        _bound.add("run_agg")
    return lib


def outputs(L: int, kinds: list, score_lane: int, dev):
    """(totals, gpos, valid, score) of a call as views of one int64
    allocation: the lanes, gpos and score L words each, then the valid
    bytes."""
    nl = len(kinds)
    buf = torch.empty((nl + 2) * L + (L + 7) // 8, dtype=torch.int64, device=dev)

    def lane(j, f):
        t = buf[j * L:(j + 1) * L]
        return t.view(torch.float64) if f else t

    totals = [lane(j, f) for j, f in enumerate(kinds)]
    return totals, buf[nl * L:(nl + 1) * L], buf[(nl + 2) * L:].view(torch.bool)[:L], lane(nl + 1, kinds[score_lane])


def run_agg(kd, mask, lanes, cnt_lane: int, rid_lane: int, score_lane: int, desc: bool):
    """(totals, gpos, valid, score) of the clustered aggregation."""
    dev = kd.device
    L = _check(kd, mask, lanes, cnt_lane, rid_lane, score_lane)
    if dev.type == "cpu":
        return run_agg_ref(kd, mask, lanes, cnt_lane, rid_lane, score_lane, desc)
    if dev.type != "cuda":
        raise ValueError(f"run_agg: unsupported device {dev}")
    for t in [kd, mask] + [t for lane in lanes for t in lane if t is not None]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"run_agg: inputs must be contiguous tensors on {dev}")
    lib = _lib()
    kinds = [d is not None and d.dtype == torch.float64 for d, _ in lanes]
    totals, gpos, valid, score = outputs(L, kinds, score_lane, dev)
    words = [L, len(lanes), cnt_lane, rid_lane, score_lane, int(bool(desc)), kd.data_ptr(), mask.data_ptr()]
    for (d, v), f, out in zip(lanes, kinds, totals):
        words += [0 if d is None else d.data_ptr(), 0 if v is None else v.data_ptr(), int(f), out.data_ptr()]
    words += [gpos.data_ptr(), valid.data_ptr(), score.data_ptr(), 0]
    with stream_scratch("run_agg", dev, lib.tt_run_agg_scratch_words(L, len(lanes))) as scratch:
        words[-1] = scratch.data_ptr()
        w = (ctypes.c_int64 * len(words))(*words)
        rc = lib.tt_run_agg(w, len(words), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"run_agg: kernel launch failed (cudaError {rc})")
    count(run_agg)
    return totals, gpos, valid, score


run_agg.launches = 0
