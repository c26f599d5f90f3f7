"""Host-side plans of P5 (csrc/seg_reduce.cu) and P4 (csrc/sort_join.cu)
as redesigned for the H100, modelled in numpy and held to the reference:

  * the sentinel-last compaction (csrc/compact.cuh, kernels/compact.py):
    the kept rows stably sorted, then the others in row order, is
    torch.sort(stable=True) and the reference's jnp.argsort; K8's plan over
    the kept rows' OR/AND;
  * P5's one sweep over the M sorted rows, tile by tile with the carries
    the look-back hands on (a run's last row writes its total at its first
    row, a float-sum run past the first non-finite row is NaN, the uint64
    neutral by `span`), against the reference's reduce; its picks (K6 over
    the first M scores, the tail appended where it ranks) against
    lax.top_k's order over all N;
  * P4's directory search against np.searchsorted, its run lengths, its
    count list and slot-parallel expansion against the reference's
    searchsorted(opos, j, right) - 1, and the whole level against
    sort_join_ref;
  * the constants the sources and the wrappers share.

The kernels run only on the card (chip_smoke.py holds them to the plain
versions there); these tests need no card.
"""

from __future__ import annotations

import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (SEG_REDUCE_EDGE_SHAPES, SEG_REDUCE_SHAPES, SORT_JOIN_SHAPES, p4_args, p5_args,
                        seg_reduce_battery, sort_join_battery)
from tidb_tpu.jaxenv import jax, jnp  # the reference's JAX, int64 on
from tidb_tpu_torch.kernels import compact, red
from tidb_tpu_torch.kernels.topk import topk_ref

# the modules (the package re-exports their wrappers under the same names)
P5, P4, lex_sort = (importlib.import_module(f"tidb_tpu_torch.kernels.{m}") for m in ("seg_reduce", "sort_join",
                                                                                     "lex_sort"))

CSRC = Path(P4.__file__).resolve().parent.parent / "csrc"
I64_MAX = (1 << 63) - 1
I32_MAX = (1 << 31) - 1
M64 = (1 << 64) - 1


def _constant(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", (CSRC / src).read_text())
    assert m, (src, name)
    expr = m.group(1)
    for other in re.findall(r"[A-Z_]+", expr):
        expr = expr.replace(other, str(_constant(src, other)))
    return int(eval(expr))  # noqa: S307 — an integer expression of the source's own constants


RTILE = _constant("seg_reduce.cu", "RTILE")
ETILE = _constant("sort_join.cu", "ETILE")


def test_sources_and_wrappers_share_their_constants():
    assert P4.ETILE == ETILE
    assert P4.DIR_MAX_BITS == _constant("sort_join.cu", "DIR_MAX_BITS")
    assert RTILE == _constant("seg_reduce.cu", "RBLOCK") * _constant("seg_reduce.cu", "RITEMS")
    assert P5.MAX_LANES == int(re.search(r"constexpr int MAXL = (\d+);", (CSRC / "seg_scan.cuh").read_text()).group(1))
    # every kernel entry the wrappers bind exists in its source
    for mod, src in ((P5, "seg_reduce.cu"), (P4, "sort_join.cu")):
        text = (CSRC / src).read_text()
        for fn in re.findall(r'"(tt_s[rj]_\w+)"', Path(mod.__file__).read_text()):
            assert f"int {fn}(" in text or f"int64_t {fn}(" in text, fn


# --------------------------------------------------------------- compaction


def _compact(key: np.ndarray, sentinel: int):
    """compact.cuh's outputs: (comp, crow, tail, M, OR, AND of key ^ 2^63)."""
    keep = key != sentinel
    comp, crow, tail = key[keep], np.nonzero(keep)[0], np.nonzero(~keep)[0]
    u = [(int(x) & M64) ^ (1 << 63) for x in comp]
    o = 0
    na = 0
    for x in u:
        o |= x
        na |= ~x & M64
    return comp, crow, tail, len(comp), o, ~na & M64


def _keys(rng, n: int, kind: str, sentinel: int) -> np.ndarray:
    if kind == "i32":
        k = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int64)
    else:
        k = rng.integers(-(1 << 62), 1 << 62, n)
    k[rng.random(n) < 0.3] = k[0]  # ties
    k[rng.random(n) < 0.4] = sentinel  # masked rows, and valid keys equal to the sentinel
    return k


@pytest.mark.parametrize("kind", ["i64", "i32"])
@pytest.mark.parametrize("n,fill", [(1, "mixed"), (1, "none"), (1, "all"), (5000, "mixed"), (5000, "none"),
                                    (5000, "all"), (4097, "mixed")])
def test_sentinel_last_compaction_is_the_stable_sort(kind, n, fill):
    sentinel = I32_MAX if kind == "i32" else I64_MAX
    rng = np.random.default_rng(n + len(kind))
    key = _keys(rng, n, kind, sentinel)
    if fill == "none":  # M = N
        key[key == sentinel] = 7
    elif fill == "all":  # M = 0
        key[:] = sentinel
    comp, crow, tail, m, _, _ = _compact(key, sentinel)
    assert m == int((key != sentinel).sum())
    perm = np.concatenate([crow[np.argsort(comp, kind="stable")], tail])
    t = torch.from_numpy(key)
    want = torch.sort(t, stable=True).indices.numpy()
    assert np.array_equal(perm, want)
    assert np.array_equal(compact.sentinel_last_perm_ref(t, sentinel).numpy(), want)
    jkey = jnp.asarray(key.astype(np.int32) if kind == "i32" else key)
    assert np.array_equal(np.asarray(jnp.argsort(jkey, stable=True)), want)


def test_k8_sorts_the_kept_codes_in_their_own_bits():
    """Q3's group codes (o_orderkey's ~1M values times the date's stride)
    vary in 32 bits once the INT64_MAX rows are out: K8 sorts 4-byte keys
    in 4 passes; with the sentinel rows in the operand it took 8."""
    rng = np.random.default_rng(3)
    code = rng.integers(0, 2_877_000_000, 20_000)
    code[rng.random(20_000) < 0.95] = I64_MAX
    *_, m, o, a = _compact(code, I64_MAX)
    words = lex_sort.plan_words(np.array([o, a], dtype=np.uint64))
    assert len(words) == 1 and words[0].bits <= 32 and words[0].key_bytes == 4 and words[0].passes == 4
    u = (code.view(np.uint64) ^ np.uint64(1 << 63))
    every = lex_sort.plan_words(np.array([np.bitwise_or.reduce(u), np.bitwise_and.reduce(u)], dtype=np.uint64))
    assert every[0].passes == 8
    # M = 0: OR 0, AND all ones — K8 gets no rows
    *_, m0, o0, a0 = _compact(np.full(5, I64_MAX, dtype=np.int64), I64_MAX)
    assert (m0, o0, a0) == (0, 0, M64)


# ----------------------------------------------------------- P5: the sweep


def _null(op: str):
    return {"min_i64": I64_MAX, "min_u64": I64_MAX, "max_i64": 1 << 63, "max_u64": 1 << 63,
            "min_f64": math.inf, "max_f64": -math.inf}.get(op, 0.0 if op == "sum_f64" else 0)


def _identity(op: str):
    return {"min_u64": M64, "max_u64": 0}.get(op, _null(op))


def _s(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def _combine(op: str, a, b):
    if op == "sum_f64":
        return a + b
    if op in ("count", "sum_i64", "sum_u64"):
        return (a + b) & M64
    if op.endswith("f64"):
        if math.isnan(a):
            return a
        if math.isnan(b):
            return b
        return (b if b < a else a) if op.startswith("min") else (b if b > a else a)
    if op.endswith("u64"):
        return min(a, b) if op.startswith("min") else max(a, b)
    return (b if _s(b) < _s(a) else a) if op.startswith("min") else (b if _s(b) > _s(a) else a)


def _lane_values(ln):
    d = None if ln.data is None else ln.data.numpy()
    v = None if ln.valid is None else ln.valid.numpy()
    return d, v


def _value(ln, d, v, o):
    ok = v is None or bool(v[o])
    if ln.op == "count":
        return 1 if ok else 0
    if not ok:
        return _null(ln.op)
    return float(d[o]) if ln.is_float else int(d[o]) & M64


def _floor(op: str):
    return -math.inf if op == "sum_f64" else ((-I64_MAX) & M64) ^ (1 << 63 if op == "sum_u64" else 0)


def model_reduce(code: np.ndarray, lanes, max_run: int, score_lane: int, desc: bool):
    """seg_reduce.cu's sweep: the compaction, K8's order of the kept codes,
    then tiles of RTILE sorted rows in order, each seeded with the carry the
    look-back hands it (the run open at its start, the last run start, and
    per float-sum lane the first non-finite sorted position up to the tile's
    end); a run's last row writes the run's total at its first row. →
    (M, fkey, fvalid, {lane: {start: total}}, score)."""
    n = len(code)
    comp, crow, _, m, _, _ = _compact(code, I64_MAX)
    order = np.argsort(comp, kind="stable")
    sk, rows = comp[order], crow[order]
    span = P5.span(max_run)
    fkey = np.full(n, I64_MAX, dtype=np.int64)
    fvalid = np.zeros(n, dtype=bool)
    sop = lanes[score_lane].op
    score = [_floor(sop)] * n
    first = np.ones(m, dtype=bool)
    first[1:] = sk[1:] != sk[:-1]
    last = np.ones(m, dtype=bool)
    last[:-1] = sk[1:] != sk[:-1]
    fkey[:m] = np.where(first, sk, I64_MAX)
    fvalid[:m] = first
    vals = [_lane_values(ln) for ln in lanes]
    out = [{} for _ in lanes]
    carry = [(False, _identity(ln.op), None) for ln in lanes]  # (flag, value, first non-finite)
    start = -1
    for t0 in range(0, m, RTILE):
        t1 = min(t0 + RTILE, m)
        xs = [[_value(ln, d, v, rows[i]) for i in range(t0, t1)] for ln, (d, v) in zip(lanes, vals)]
        starts = []
        s = start
        for i in range(t0, t1):
            if first[i]:
                s = i
            starts.append(s)
        for li, ln in enumerate(lanes):
            f, acc, fb = carry[li]
            if ln.op == "sum_f64":
                bad = [t0 + j for j, x in enumerate(xs[li]) if not math.isfinite(x)]
                if bad and (fb is None or bad[0] < fb):
                    fb = bad[0]
            for j, i in enumerate(range(t0, t1)):
                x = xs[li][j]
                acc = x if first[i] else _combine(ln.op, acc, x)
                f = f or bool(first[i])
                if not last[i]:
                    continue
                s, val = starts[j], acc
                if ln.op == "sum_f64" and fb is not None and fb < s:
                    val = math.nan
                if ln.op == "sum_f64" and val == 0.0:
                    val = 0.0  # -0.0 totals +0.0
                if ln.op in ("min_u64", "max_u64") and not s + span - 1 <= i:
                    val = _combine(ln.op, val, _null(ln.op))
                out[li][s] = val
                if li == score_lane:
                    score[s] = (val if desc else -val) if sop == "sum_f64" else \
                        ((val if desc else -val) & M64) ^ (1 << 63 if sop == "sum_u64" else 0)
            carry[li] = (f, acc, fb)
        start = starts[-1]
    return m, fkey, fvalid, out, score


def _lane_bits(x, is_float):
    if is_float:
        return x
    return _s(int(x) & M64)


def _hold_reduce(code, mask, lanes, max_run, score_lane, desc):
    m, fkey, fvalid, out, score = model_reduce(code.numpy(), lanes, max_run, score_lane, desc)
    wk, wv, wt = P5._reduce_ref(code, mask, lanes, max_run)
    assert np.array_equal(fkey, wk.numpy()) and np.array_equal(fvalid, wv.numpy())
    starts = np.nonzero(fvalid)[0]
    for li, (ln, t) in enumerate(zip(lanes, wt)):
        for s in starts:
            g, w = out[li][int(s)], t.numpy()[s]
            if ln.is_float:
                assert np.isclose(g, w, rtol=1e-9, atol=1e-6, equal_nan=True), (ln.op, s, g, w)
            else:
                assert _lane_bits(g, False) == int(w), (ln.op, s, g, int(w))
    sl = lanes[score_lane]
    want = red.topk_score_ordered(wt[score_lane], wv, desc, sl.op.endswith("u64")).numpy()
    got = np.array([_lane_bits(x, sl.is_float) for x in score], dtype=want.dtype)
    ok = fvalid
    assert np.array_equal(got[~ok], want[~ok])
    if sl.is_float:
        assert np.allclose(got[ok], want[ok], rtol=1e-9, atol=1e-6, equal_nan=True)
        zero = ok & (want == 0)  # ±0.0 order apart in top_k: the sign is held too
        assert np.array_equal(np.signbit(got[zero]), np.signbit(want[zero]))
    else:
        assert np.array_equal(got[ok], want[ok])
    return m, got


def model_picks(score: np.ndarray, m: int, kk: int, sop: str) -> np.ndarray:
    """seg_reduce.cu's picks: K6 over the first M scores (min(kk, M) of
    them), then tt_sr_emit's order over all N — K6's picks at or above the
    floor, the tail positions M, M+1, ..., K6's picks below the floor."""
    n = len(score)
    kp = min(kk, m)
    pidx = topk_ref(torch.from_numpy(score[:m]), None, torch.ones(m, dtype=torch.bool), True, kp)[0].numpy()

    def rank(x):
        if sop != "sum_f64":
            return int(x)
        b = int(np.float64(x).view(np.int64))
        return b ^ I64_MAX if b < 0 else b

    fl = rank(np.array(_floor(sop)).astype(score.dtype)) if sop == "sum_f64" else _s(_floor(sop))
    c = 0
    while c < kp and rank(score[pidx[c]]) >= fl:
        c += 1
    tail = min(kk - c, n - m)
    return np.concatenate([pidx[:c], np.arange(m, m + tail), pidx[c:kk - tail]]).astype(np.int32)


@pytest.mark.parametrize("n,case", [s for s in SEG_REDUCE_SHAPES + SEG_REDUCE_EDGE_SHAPES if s[0] <= 5000])
def test_one_sweep_and_its_picks_equal_the_reference(n, case):
    b = seg_reduce_battery(np.random.default_rng(n + 13), n, case)
    keys, mask, lanes, score_lane, desc, k = p5_args(b, "cpu")
    code = P5.group_code_ref(keys, mask)
    m, _ = _hold_reduce(code, mask, lanes, n, score_lane, desc)
    want = P5.seg_reduce_ref(keys, mask, lanes, score_lane, desc, k)
    # the picks over the reference's own scores (a NaN total's sign follows
    # the order of the additions that made it, which the model does not
    # share with torch's index_add_)
    assert np.array_equal(model_picks(want.score.numpy(), m, min(k, n), lanes[score_lane].op), want.idx.numpy())
    if case in ("masked95", "all_masked", "kk_above", "floor_nan"):
        assert min(k, n) > int(want.fvalid.sum())  # more picks than groups: the tail is picked


@pytest.mark.parametrize("n,case,n_dev", [(1000, "runs", 3), (5000, "masked95", 4), (4096, "all_masked", 2),
                                          (5000, "sentinel", 4), (5000, "floor_nan", 2)])
def test_final_reduce_sweep_over_exchanged_fragments(n, case, n_dev):
    """The final reduce: the exchanged fragments keyed where the moved mask
    is set, runs of at most n_dev (span from n_dev), a count now a sum."""
    b = seg_reduce_battery(np.random.default_rng(n + n_dev), n, case)
    keys, mask, lanes, score_lane, desc, k = p5_args(b, "cpu")
    ukey, uvalid, uvals = P5._reduce_ref(P5.group_code_ref(keys, mask), mask, lanes, n)
    key2, exm = ukey.repeat(n_dev), uvalid.repeat(n_dev)
    lanes2 = [red.RedLane(P5.final_op(ln.op), v.repeat(n_dev)) for ln, v in zip(lanes, uvals)]
    code2 = torch.where(exm, key2, torch.full((), I64_MAX, dtype=torch.int64))
    m, _ = _hold_reduce(code2, exm, lanes2, n_dev, score_lane, desc)
    ex = lambda uk, uv, uvd: (uk.repeat(n_dev), [v.repeat(n_dev) for v in uv], uvd.repeat(n_dev))  # noqa: E731
    want = P5.seg_reduce_ref(keys, mask, lanes, score_lane, desc, k, exchange=ex, n_dev=n_dev)
    kk = min(k, n * n_dev)
    assert np.array_equal(model_picks(want.score.numpy(), m, kk, lanes2[score_lane].op), want.idx.numpy())


@pytest.mark.parametrize("sop", ["sum_i64", "sum_u64", "sum_f64"])
@pytest.mark.parametrize("kk", [1, 7, 40, 200])
def test_picks_with_the_tail_equal_top_k_over_all_rows(sop, kk):
    """Scores at the floor among the first M (non-start rows, a valid total
    at the floor) come before the tail; scores below it (INT64_MIN, an
    unsigned 0, a NaN with the sign set) after it; +NaN and +inf first."""
    rng = np.random.default_rng(kk)
    n, m = 200, 60
    fl = _floor(sop)
    if sop == "sum_f64":
        s = np.full(n, -np.inf)
        s[:m] = rng.standard_normal(m)
        s[rng.choice(m, 15, replace=False)] = -np.inf
        s[[3, 9]] = -np.nan  # below the floor
        s[[5]] = np.nan
        s[[11]] = np.inf
        s[[13]] = -0.0
    else:
        s = np.full(n, _s(fl), dtype=np.int64)
        s[:m] = rng.integers(-50, 50, m)
        s[rng.choice(m, 15, replace=False)] = _s(fl)
        s[[3, 9]] = -(1 << 63) if sop == "sum_i64" else 0  # below the floor (1 for an unsigned lane)
    got = model_picks(s, m, kk, sop)
    want = topk_ref(torch.from_numpy(s), None, torch.ones(n, dtype=torch.bool), True, kk)[0].numpy()
    assert np.array_equal(got, want)
    _, jidx = jax.lax.top_k(jnp.asarray(s), kk)
    assert np.array_equal(got, np.asarray(jidx))


# ------------------------------------------------------ P4: the directory


def model_directory(sk: np.ndarray, bits: int) -> np.ndarray:
    """sorted_kernel's directory over the M sorted kept keys: position i
    writes its bucket's entries after the previous key's bucket, position M
    the buckets after the last key's."""
    m = len(sk)
    nb = 1 << bits
    d = np.full(nb + 1, -1, dtype=np.int64)
    if m == 0:
        d[:] = 0
        return d
    kmin, kmax = int(sk[0]), int(sk[-1])
    shift = _shift(kmin, kmax, bits)
    b = [((int(x) - kmin) & M64) >> shift for x in sk]
    for i in range(m):
        d[(b[i - 1] + 1 if i else 0):b[i] + 1] = i
    d[b[-1] + 1:] = m
    assert (d >= 0).all()  # every entry written once
    return d


def _shift(kmin, kmax, bits):
    return max(0, ((kmax - kmin) & M64).bit_length() - bits)


def model_lower(sk: np.ndarray, d: np.ndarray, bits: int, key: int) -> int:
    """lower_bound of sort_join.cu: searchsorted left over all B positions."""
    m = len(sk)
    if m == 0 or key <= sk[0]:
        return 0
    if key > sk[-1]:
        return m
    kmin, kmax = int(sk[0]), int(sk[-1])
    bkt = ((key - kmin) & M64) >> _shift(kmin, kmax, bits)
    lo, hi = int(d[bkt]), int(d[bkt + 1])
    return lo + int(np.searchsorted(sk[lo:hi], key, "left"))


def model_run_length(sk: np.ndarray, i: int) -> int:
    """run_length of sort_join.cu: a galloping search from a run start."""
    m, key, lo, step = len(sk), sk[i], i, 1
    while lo + step < m and sk[lo + step] == key:
        lo += step
        step <<= 1
    hi = min(lo + step, m)
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        if sk[mid] == key:
            lo = mid
        else:
            hi = mid
    return hi - i


@pytest.mark.parametrize("sentinel", [I64_MAX, I32_MAX])
@pytest.mark.parametrize("m,spread,bits", [(0, 10, 0), (1, 10, 1), (3000, 40, None), (3000, 1 << 40, None),
                                           (3000, 40, 3), (2000, 1 << 62, None), (50, 1 << 20, 20)])
def test_directory_search_is_searchsorted(sentinel, m, spread, bits):
    rng = np.random.default_rng(m + bits if bits is not None else m)
    lo = -spread // 3
    sk = np.sort(lo + rng.integers(0, spread, m)) if m else np.zeros(0, dtype=np.int64)
    if m > 10:
        sk[m // 3: m // 3 + m // 4] = sk[m // 3]  # a long run of duplicates
        sk[-3:] = sk[-1]
        sk = np.sort(sk)
    if sentinel == I32_MAX:
        sk = np.clip(sk, -(1 << 31), I32_MAX - 1)
    B = m + 37
    full = np.concatenate([sk, np.full(B - m, sentinel, dtype=np.int64)])
    bits = P4.dir_bits(m) if bits is None else bits
    d = model_directory(sk, bits)
    probes = np.concatenate([sk, sk - 1, sk + 1, [sentinel, sentinel - 1, -(1 << 62) if sentinel == I64_MAX
                                                   else -(1 << 31)],
                             lo + rng.integers(-5, spread + 5, 400)]).astype(np.int64)
    probes = np.clip(probes, None, sentinel)
    for key in probes.tolist():
        left = model_lower(sk, d, bits, key)
        assert left == int(np.searchsorted(full, key, "left")), key
        if left < B and full[left] == key:  # a run start: its length is the upper bound's distance
            run = model_run_length(sk, left) if left < m else B - m
            assert left + run == int(np.searchsorted(full, key, "right")), key


# ------------------------------------------------------ P4: the expansion


def model_expand(cnt: np.ndarray, cap: int):
    """count_kernel's list and first-entry table, then expand_kernel's slot
    search: → (src row, slot within the row) for every slot below
    min(total, cap), and total."""
    n = len(cnt)
    opos = np.cumsum(cnt) - cnt
    total = int(cnt.sum())
    ent = np.nonzero(cnt > 0)[0]
    etiles = -(-cap // ETILE)
    first = np.full(etiles + 1, -1, dtype=np.int64)
    for k, r in enumerate(ent):
        e = -(-int(opos[r]) // ETILE)
        while e <= etiles and e * ETILE < opos[r] + cnt[r]:
            first[e] = k
            e += 1
    src = np.full(min(total, cap), -1, dtype=np.int64)
    for b in range(etiles):
        j0 = b * ETILE
        if j0 >= total:
            break
        k0 = first[b]
        k1 = first[b + 1] + 1 if (b + 1) * ETILE < total else len(ent)
        assert 0 < k1 - k0 <= ETILE + 1
        eo = opos[ent[k0:k1]]
        for j in range(j0, min(j0 + ETILE, cap, total)):
            src[j] = ent[k0 + int(np.searchsorted(eo, j, "right")) - 1]
    assert n >= 1
    return src, opos, total


@pytest.mark.parametrize("case", ["zeros_between", "one_row_past_a_tile", "cap_below_total", "all_zero",
                                  "every_row_one", "tail_past_total"])
def test_slot_expansion_is_searchsorted_over_opos(case):
    rng = np.random.default_rng(len(case))
    n = 3000
    cnt = rng.integers(0, 4, n) * (rng.random(n) < 0.3)
    cap = int(cnt.sum()) + 64
    if case == "one_row_past_a_tile":
        cnt[[10, 1500, n - 1]] = [3 * ETILE + 5, ETILE, 2 * ETILE - 1]
        cap = int(cnt.sum()) + 64
    elif case == "cap_below_total":
        cnt[100] = 2 * ETILE
        cap = int(cnt.sum()) // 2
    elif case == "all_zero":
        cnt[:] = 0
        cap = 64
    elif case == "every_row_one":
        cnt[:] = 1
        cap = n
    elif case == "tail_past_total":
        cap = int(cnt.sum()) + 3 * ETILE + 17
    src, opos, total = model_expand(cnt, cap)
    j = np.arange(len(src))
    want = np.clip(np.searchsorted(opos, j, "right") - 1, 0, n - 1)
    assert np.array_equal(src, want)
    assert (j - opos[src] < cnt[src]).all()  # every slot below total is emitted by its row
    if total < cap:  # past total the reference's source is the last row
        jt = np.arange(total, cap)
        assert (np.clip(np.searchsorted(opos, jt, "right") - 1, 0, n - 1) == n - 1).all()


# ------------------------------------------------------ P4: the whole level


def model_sort_join(args):
    """sort_join.cu's level in numpy: pack and compact the build side, sort
    the kept keys, lay out sk / sv / order over all B positions with the
    directory and run lengths, then probe1 or count + expand."""
    (pkeys, bkeys, lo, stride, key_i32, pmask, bmask, brow, mult, left, cap, gathers, probe_lanes, prows) = args

    def pack(keys):
        acc, ok = P4.pack_keys(keys, lo, stride, key_i32)
        return acc.to(torch.int64).numpy(), ok.numpy()

    pk, pkv = pack(pkeys)
    bk, bkv = pack(bkeys)
    pmask, bmask, brow = pmask.numpy(), bmask.numpy(), brow.numpy()
    n, B = len(pk), len(bk)
    key_max = I32_MAX if key_i32 else I64_MAX
    bvalid = bmask & bkv
    comp, crow, tail, m, _, _ = _compact(np.where(bvalid, bk, key_max), key_max)
    perm = np.argsort(comp, kind="stable")
    sk = np.concatenate([comp[perm], np.full(B - m, key_max, dtype=np.int64)])
    sv = np.concatenate([np.ones(m, dtype=bool), bvalid[tail]])
    order = np.concatenate([crow[perm], tail])
    bits = P4.dir_bits(m)
    d = model_directory(sk[:m], bits)
    lft = np.array([model_lower(sk[:m], d, bits, int(x)) for x in pk], dtype=np.int64)
    gd = [(g.numpy().view(np.int64), v.numpy()) for g, v in gathers]
    if mult == 1:
        pos = np.minimum(lft, B - 1)
        match = pmask & pkv & sv[pos] & (sk[pos] == pk)
        bsel = order[pos]
        return {"mask": pmask if left else match, "rowid": np.where(match, brow[bsel], -1),
                "gathered": [(g[bsel], v[bsel] & match) for g, v in gd]}
    hit = (lft < B) & (sk[np.minimum(lft, B - 1)] == pk)
    hitv = pmask & pkv & hit
    rlen = np.array([(model_run_length(sk[:m], x) if x < m else B - m) if h else 0 for x, h in zip(lft, hitv)])
    cnt = np.where(hitv, rlen, 0)
    if left:
        cnt = np.maximum(cnt, pmask.astype(np.int64))
    src, opos, total = model_expand(cnt, cap)
    L = cap
    out = {"mask": np.zeros(L, dtype=bool), "rowid": np.full(L, -1, dtype=np.int64)}
    gath = [(np.zeros(L, dtype=np.int64), np.zeros(L, dtype=bool)) for _ in gd]
    plan = [(np.zeros(L, dtype=np.int64), np.zeros(L, dtype=bool)) for _ in probe_lanes]
    pl = [(a.numpy().view(np.int64), v.numpy()) for a, v in probe_lanes]
    pr = [r.numpy() for r in prows]
    prow_out = [np.full(L, -1, dtype=np.int64) for _ in prows]
    for j in range(L):
        if j < min(total, cap):
            r = src[j]
            bpos = min(max(lft[r] + j - opos[r], 0), B - 1)
            match = bool(hitv[r] and sv[bpos])
            for (od, ov), (a, v) in zip(plan, pl):
                od[j], ov[j] = a[r], v[r]
            for po, p in zip(prow_out, pr):
                po[j] = p[r]
            out["mask"][j] = True if left else match
        else:
            r = n - 1
            bpos = min(max(lft[r] + j - opos[r], 0), B - 1)
            match = False
            for (od, ov), (a, v) in zip(plan, pl):
                od[j], ov[j] = a[r], False
        bsel = order[bpos]
        for (od, ov), (g, v) in zip(gath, gd):
            od[j], ov[j] = g[bsel], v[bsel] and match
        if match:
            out["rowid"][j] = brow[bsel]
    out.update(gathered=gath, probe_lanes=plan, prows=prow_out, dropped=max(total - cap, 0))
    return out


@pytest.mark.parametrize("n,B,case", [s for s in SORT_JOIN_SHAPES if s[0] <= 5000])
def test_level_model_equals_the_reference_bit_for_bit(n, B, case):
    b = sort_join_battery(np.random.default_rng(n * 7 + B), n, B, case)
    args = p4_args(b, "cpu")
    want = P4.sort_join_ref(*args)
    got = model_sort_join(args)
    assert np.array_equal(got["mask"], want.mask.numpy())
    assert np.array_equal(got["rowid"], want.rowid.numpy())
    for (gd, gv), (wd, wv) in zip(got["gathered"], want.gathered):
        assert np.array_equal(gd, wd.numpy().view(np.int64)) and np.array_equal(gv, wv.numpy())
    if b["mult"] > 1:
        assert got["dropped"] == int(want.dropped[0])
        for (gd, gv), (wd, wv) in zip(got["probe_lanes"], want.probe_lanes):
            assert np.array_equal(gd, wd.numpy().view(np.int64)) and np.array_equal(gv, wv.numpy())
        for g, w in zip(got["prows"], want.prows):
            assert np.array_equal(g, w.numpy())
    if case == "skew":  # a probe row owns more than a tile of slots
        pk = P4.pack_keys(args[0], args[2], args[3], args[4])[0]
        assert int((pk == pk[0]).sum()) > 1 and int(want.mask.sum()) > 2 * ETILE
