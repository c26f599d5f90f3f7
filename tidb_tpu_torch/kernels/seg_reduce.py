"""P5: the sorted MPP aggregation — wide group keys reduced in sorted
runs, then the k best groups by the fused ORDER BY aggregate.

Replaces `sorted_agg_stage` of tidb_tpu/parallel/mpp.py:1655-1786: the
gcd-compressed group code (:1665-1673), `seg_reduce` (:1707-1750) and
`finish_topk` (:1752-1759); over n_dev ranks also its local reduce, the
exchange of whole groups to their owners and the final reduce
(:1765-1786). The CUDA kernels are csrc/seg_reduce.cu (their note gives
the steps and the bound): the code kernel compacts the rows whose code is
not INT64_MAX (kernels/compact.py: M of them, read with the bits they
vary in in the call's one host read), K8 (kernels/lex_sort.py, stable as
`jnp.argsort`) sorts only those, one sweep reduces them, K6
(kernels/topk.py, `lax.top_k`'s order) picks among their scores and the
emit kernel appends the INT64_MAX tail where it ranks. `seg_reduce_ref`
is the plain PyTorch version beside them, the reference's jnp code step
by step.

`seg_reduce(keys, mask, lanes, score_lane, desc, k, rows=None,
exchange=None, n_dev=1)`:

  * keys  — [GroupKey(data int64 [N], valid bool [N], lo, step, stride,
            is_int)]: an int key contributes ((d - lo) // step + 1) * v,
            a dict-coded key (d + 1) * v, each times its stride; masked
            rows take the code INT64_MAX
  * mask  — bool [N], the chain's row mask
  * lanes — red.RedLane partial lanes (count, sum_*, min_*, max_*)
  * score_lane / desc / k — the fused ORDER BY lane, its direction, LIMIT
  * rows  — optional int64 [2 + len(lanes), W >= kk] rows of the packed
            result: [fkey, valid, lane...] at the picks are written there
  * exchange — over n_dev > 1 ranks: fn(ukey, uvals, uvalid) of the local
            reduce's groups (in sorted order, as below) → (key int64 [M],
            [lane values [M]], moved mask bool [M]), the fragments this
            rank owns after P2's exchange (the mesh's all_to_all inside);
            they are reduced again, keyed where the mask is set and
            INT64_MAX elsewhere, each lane at its neutral off the mask (a
            count lane now sums counts), in runs of at most n_dev
  → SegReduce(idx, fkey, fvalid, totals, score), in sorted order: at a
    run's first row the run's totals (sum lanes 0 elsewhere, min / max
    lanes the suffix of the run), fvalid = run start & code != INT64_MAX,
    fkey = where(fvalid, code, INT64_MAX), the top-k score, and idx the
    kk = min(k, N) picks in lax.top_k's order — of the final reduce (N = M)
    where there is an exchange. On the card a totals lane is written at
    the valid run starts only (every other position keeps what torch.empty
    left there: no check reads it and no consumer ships it); fkey, fvalid
    and score are written at every position.

Integer sums are bit-exact with the reference (modulo 2^64); float sums
are direct run sums in the kernel and the plain version alike, where the
reference differences prefix sums: they agree within rtol 1e-9 / atol
1e-6 at run starts, the rows the picks can ship as valid, and a run
whose sorted prefix holds a NaN or an infinity totals NaN, as the
reference's difference does (written as the positive quiet NaN; the
reference's NaN from inf - inf is x86's negative one, which orders
differently only among NaN scores). Min / max propagate NaN as
jnp.minimum / jnp.maximum do.

Min / max lanes double their window as the reference's up to the run
bound (N, or n_dev in the final reduce); a uint64 lane then folds the
reference's neutral where the window reaches past the run (`span`).

`seg_reduce` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernels or raises; `seg_reduce.launches`
counts its calls that launched.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import compact, red
from .build import count, library
from .tables import sm_count, stream_scratch
from .topk import topk, topk_ref

I64_MAX = red.I64_MAX
MAX_KEYS, MAX_LANES = 8, 32


class GroupKey(NamedTuple):
    data: torch.Tensor
    valid: torch.Tensor
    lo: int
    step: int
    stride: int
    is_int: bool


class SegReduce(NamedTuple):
    idx: torch.Tensor
    fkey: torch.Tensor
    fvalid: torch.Tensor
    totals: list
    score: torch.Tensor


def group_code_ref(keys, mask):
    """The gcd-compressed lexicographic group code (ref: :1665-1673)."""
    code = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    for k in keys:
        if k.is_int:
            kd = (torch.div(k.data - k.lo, k.step, rounding_mode="floor") + 1) * k.valid
        else:
            kd = (k.data + 1) * k.valid
        code = code + kd * k.stride
    return torch.where(mask, code, torch.full((), I64_MAX, dtype=torch.int64, device=mask.device))


def _shift(a, d, fill):
    return torch.cat([a[d:], torch.full((d,), fill, dtype=a.dtype, device=a.device)])


def span(max_run: int) -> int:
    """The window of the reference's distance doubling over runs of at most
    max_run rows: the least power of two >= max_run."""
    return 1 << max(int(max_run) - 1, 0).bit_length()


def final_op(op: str) -> str:
    """A lane's op in the final reduce: a count adds the fragments' counts."""
    return "sum_i64" if op == "count" else op


def _reduce_ref(code, mask, lanes, max_run: int):
    """(fkey, fvalid, totals) of the rows sorted by `code` (module doc);
    min / max lanes double their window up to max_run (ref: seg_reduce,
    :1707-1750)."""
    n = code.shape[0]
    order = torch.sort(code, stable=True).indices
    sk = code[order]
    dev = code.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, sk[1:] != sk[:-1]])
    last = torch.cat([sk[1:] != sk[:-1], one])
    rend = -torch.cummax(torch.where(last, -idx, -(n - 1)).flip(0), 0).values.flip(0)
    totals = []
    for ln in lanes:
        a = red.values_ref(ln, mask)[order]
        if ln.is_sum and ln.is_float:
            # a direct run sum: the reference's difference of two prefix
            # sums loses a short run's low bits behind a long prefix, and
            # torch.cumsum strays further than jnp.cumsum (as found for
            # P7's run totals). What the difference does keep: once a NaN or an
            # infinity is in the prefix before a run, the run's total is NaN
            run = torch.cumsum(first.to(torch.int64), 0) - 1
            tot = torch.zeros(n, dtype=a.dtype, device=dev).index_add_(0, run, a)
            bad = (~torch.isfinite(a)).to(torch.int64)
            poisoned = (torch.cumsum(bad, 0) - bad) > 0
            tot = torch.where(poisoned, torch.full((), float("nan"), dtype=a.dtype, device=dev), tot[run])
            a = torch.where(first, tot, torch.zeros((), dtype=a.dtype, device=dev))
        elif ln.is_sum:  # int64 prefix differences: exact modulo 2^64
            c = torch.cumsum(a, 0)
            prev = torch.cat([torch.zeros(1, dtype=a.dtype, device=dev), c[:-1]])
            a = torch.where(first, c[rend] - prev, torch.zeros((), dtype=a.dtype, device=dev))
        else:
            # distance doubling over the run with the reference's neutral
            # (`_neutral`: the sentinel where(ok, d, big) folds, which for a
            # uint64 lane is 2^63 - 1 / 2^63 and so takes part); NaN
            # propagates through torch.minimum / maximum as through jnp's
            nb = torch.full((), red.null_bits(ln.op), dtype=torch.int64, device=dev)
            if ln.is_float:
                o, fill = a, float(nb.view(torch.float64))
            else:
                o, fill = red.ordered(a, ln.op), int(red.ordered(nb, ln.op))
            fill_t = torch.full((), fill, dtype=o.dtype, device=dev)
            pick = torch.minimum if ln.op.startswith("min") else torch.maximum
            d = 1
            while d < max_run:  # max_run <= n
                same = torch.cat([sk[d:] == sk[:-d], torch.zeros(d, dtype=torch.bool, device=dev)])
                o = pick(o, torch.where(same, _shift(o, d, fill), fill_t))
                d *= 2
            a = o if ln.is_float else red.ordered(o, ln.op)
        totals.append(a)
    fvalid = first & (sk != I64_MAX)
    fkey = torch.where(fvalid, sk, torch.full((), I64_MAX, dtype=torch.int64, device=dev))
    return fkey, fvalid, totals


def _picks_ref(lanes, fkey, fvalid, totals, score_lane, desc, k, rows):
    n = fkey.shape[0]
    sl = lanes[score_lane]
    score = red.topk_score_ordered(totals[score_lane], fvalid, desc, sl.op.endswith("u64"))
    pick_idx, _ = topk_ref(score, None, torch.ones(n, dtype=torch.bool, device=fkey.device), True, min(k, n))
    if rows is not None:
        emit_ref(rows, pick_idx, fkey, fvalid, totals)
    return SegReduce(pick_idx, fkey, fvalid, totals, score)


def seg_reduce_ref(keys, mask, lanes, score_lane, desc, k, rows=None, exchange=None, n_dev: int = 1) -> SegReduce:
    """Plain PyTorch version: the reference's stage, step by step."""
    code = group_code_ref(keys, mask)
    n = code.shape[0]
    if exchange is None:
        fkey, fvalid, totals = _reduce_ref(code, mask, lanes, n)
        return _picks_ref(lanes, fkey, fvalid, totals, score_lane, desc, k, rows)
    ukey, uvalid, uvals = _reduce_ref(code, mask, lanes, n)
    key2, vals2, exm = exchange(ukey, uvals, uvalid)
    code2 = torch.where(exm, key2, torch.full((), I64_MAX, dtype=torch.int64, device=exm.device))
    lanes2 = [red.RedLane(final_op(ln.op), v) for ln, v in zip(lanes, vals2)]
    fkey, fvalid, totals = _reduce_ref(code2, exm, lanes2, n_dev)
    return _picks_ref(lanes2, fkey, fvalid, totals, score_lane, desc, k, rows)


def emit_ref(rows, idx, fkey, fvalid, totals) -> None:
    """[fkey, valid, lanes...] at the picks into the packed rows."""
    i = idx.long()
    kk = i.shape[0]
    rows[0, :kk] = fkey[i]
    rows[1, :kk] = fvalid[i].to(torch.int64)
    for j, t in enumerate(totals):
        rows[2 + j, :kk] = red.bits(t[i])


def _check(keys, mask, lanes, score_lane, k):
    n = mask.shape[0]
    if mask.dtype != torch.bool or n < 1:
        raise TypeError("seg_reduce: mask is bool [N >= 1]")
    if not 1 <= len(keys) <= MAX_KEYS or not 1 <= len(lanes) <= MAX_LANES:
        raise ValueError(f"seg_reduce: 1..{MAX_KEYS} keys and 1..{MAX_LANES} lanes")
    for kk in keys:
        if kk.data.dtype != torch.int64 or kk.data.shape != (n,) or kk.valid.dtype != torch.bool \
                or kk.valid.shape != (n,) or kk.step < 1:
            raise TypeError(f"seg_reduce: a key is (int64 [{n}], bool [{n}]) with step >= 1")
    red.check_lanes(lanes, n, "seg_reduce")
    if not 0 <= score_lane < len(lanes) or lanes[score_lane].op.startswith(("min", "max")) or k < 0:
        raise ValueError("seg_reduce: the score lane is a sum or count lane, k >= 0")
    return n


_bound: set = set()


def _lib():
    lib = library("seg_reduce")
    if "seg_reduce" not in _bound:
        for fn in ("tt_sr_code", "tt_sr_code_raw", "tt_sr_fill", "tt_sr_reduce", "tt_sr_emit"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        lib.tt_sr_code_scratch.argtypes = [ctypes.c_int64]
        lib.tt_sr_code_scratch.restype = ctypes.c_int64
        lib.tt_sr_reduce_scratch.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.tt_sr_reduce_scratch.restype = ctypes.c_int64
        _bound.add("seg_reduce")
    return lib


def _call(fn, words, dev):
    w = np.array(words, dtype=np.int64)
    rc = getattr(_lib(), fn)(w.ctypes.data, len(w), sm_count(dev), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"seg_reduce: {fn} launch failed (cudaError {rc})")


def _reduce(entry, words, n, lanes, score_lane: int, desc: bool, max_run: int, with_score: bool, dev):
    """_reduce_ref on the card: the code kernel `entry` (its `words`) with
    the compaction, K8 over the M kept codes, then tt_sr_reduce → (fkey,
    fvalid, totals, score or None, M)."""
    lib = _lib()
    buf, (o_comp, o_crow, o_res) = compact.workspace(dev, [8 * n, 4 * n, 24])
    base = buf.data_ptr()
    comp, res = buf[o_comp:o_comp + n], buf[o_res:o_res + 3]
    with stream_scratch("seg_reduce", dev, lib.tt_sr_code_scratch(n)) as ws:
        _call(entry, words + [comp.data_ptr(), base + 8 * o_crow, res.data_ptr(), ws.data_ptr()], dev)
    # the outputs while the code kernel runs: after the read, only launches
    totals = [torch.empty(n, dtype=torch.float64 if ln.is_float else torch.int64, device=dev) for ln in lanes]
    fkey = torch.empty(n, dtype=torch.int64, device=dev)
    fvalid = torch.empty(n, dtype=torch.bool, device=dev)
    score = None
    if with_score:
        score = torch.empty(n, dtype=torch.float64 if lanes[score_lane].is_float else torch.int64, device=dev)
    tail = [base + 8 * o_crow, comp.data_ptr()]
    for ln, t in zip(lanes, totals):
        tail += [red.OPS[ln.op], 0 if ln.data is None else ln.data.data_ptr(),
                 0 if ln.valid is None else ln.valid.data_ptr(), t.data_ptr()]
    tail += [fkey.data_ptr(), fvalid.data_ptr(), 0 if score is None else score.data_ptr()]
    fill = [n, fkey.data_ptr(), fvalid.data_ptr(), 0 if score is None else score.data_ptr(),
            red.OPS[lanes[score_lane].op]]
    m, orand = compact.read(res, behind=lambda: _call("tt_sr_fill", fill, dev))
    perm = compact.sort_kept(comp, m, orand)
    stage = torch.empty(len(lanes) * m, dtype=torch.int64, device=dev)  # the lanes in sorted order
    w = [n, m, len(lanes), score_lane, int(bool(desc)), span(max_run), perm.data_ptr()] + tail
    with stream_scratch("seg_reduce", dev, lib.tt_sr_reduce_scratch(m, len(lanes))) as ws:
        _call("tt_sr_reduce", w + [stage.data_ptr(), ws.data_ptr()], dev)
    return fkey, fvalid, totals, score, m


def _picks(lanes, score_lane, k, m, rows, fkey, fvalid, totals, score, dev):
    """K6 over the first M scores, then tt_sr_emit: the picks over all N
    (the tail positions M, M+1, ... after K6's picks at or above the
    floor) and, with `rows`, the packed rows at them → int32 [kk]."""
    n = fkey.shape[0]
    kk = min(k, n)
    kp = min(kk, m)
    pidx, _ = topk(score[:m], None, torch.ones(m, dtype=torch.bool, device=dev), True, kp)
    idx = torch.empty(kk, dtype=torch.int32, device=dev)
    w = [kk, kp, m, n, len(totals), red.OPS[lanes[score_lane].op], pidx.data_ptr(), score.data_ptr(),
         idx.data_ptr(), fkey.data_ptr(), fvalid.data_ptr()]
    if rows is None:
        w += [0, 0]
    else:
        if rows.dtype != torch.int64 or rows.dim() != 2 or rows.shape[0] != 2 + len(totals) or rows.shape[1] < kk \
                or rows.stride(1) != 1:
            raise TypeError(f"seg_reduce: the result rows are int64 [{2 + len(totals)}, >= {kk}], rows contiguous")
        w += [rows.data_ptr(), rows.stride(0)]
    _call("tt_sr_emit", w + [t.data_ptr() for t in totals], dev)
    return idx


def seg_reduce(keys, mask, lanes, score_lane: int, desc: bool, k: int, rows=None, exchange=None,
               n_dev: int = 1) -> SegReduce:
    """The sorted aggregation and its top-k picks (module doc)."""
    dev = mask.device
    n = _check(keys, mask, lanes, score_lane, k)
    if dev.type == "cpu":
        return seg_reduce_ref(keys, mask, lanes, score_lane, desc, k, rows, exchange, n_dev)
    if dev.type != "cuda":
        raise ValueError(f"seg_reduce: unsupported device {dev}")
    ts = [mask] + [t for kk in keys for t in (kk.data, kk.valid)]
    ts += [t for ln in lanes for t in (ln.data, ln.valid) if t is not None]
    for t in ts:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"seg_reduce: inputs must be contiguous tensors on {dev}")
    if n >= 1 << 31:
        raise ValueError(f"seg_reduce: {n} rows exceed the int32 row ids")
    words = [n, len(keys), mask.data_ptr()]
    for kk in keys:
        words += [kk.data.data_ptr(), kk.valid.data_ptr(), kk.lo, kk.step, kk.stride, int(kk.is_int)]
    if exchange is None:
        fkey, fvalid, totals, score, m = _reduce("tt_sr_code", words, n, lanes, score_lane, desc, n, True, dev)
    else:  # the local reduce, P2's exchange of its groups, the final reduce
        ukey, uvalid, uvals, _, _ = _reduce("tt_sr_code", words, n, lanes, score_lane, desc, n, False, dev)
        key2, vals2, exm = exchange(ukey, uvals, uvalid)
        key2, exm = key2.contiguous(), exm.contiguous()  # held through the launches that read them
        m2 = exm.shape[0]
        if key2.shape != (m2,) or exm.dtype != torch.bool or len(vals2) != len(lanes):
            raise TypeError("seg_reduce: the exchange returns (key int64 [M], one lane per lane, bool [M])")
        if m2 >= 1 << 31:
            raise ValueError(f"seg_reduce: {m2} fragments exceed the int32 row ids")
        lanes = [red.RedLane(final_op(ln.op), v.contiguous()) for ln, v in zip(lanes, vals2)]
        red.check_lanes(lanes, m2, "seg_reduce")
        fkey, fvalid, totals, score, m = _reduce("tt_sr_code_raw", [m2, exm.data_ptr(), key2.data_ptr()], m2, lanes,
                                                 score_lane, desc, n_dev, True, dev)
    idx = _picks(lanes, score_lane, k, m, rows, fkey, fvalid, totals, score, dev)
    count(seg_reduce)
    return SegReduce(idx, fkey, fvalid, totals, score)


seg_reduce.launches = 0
