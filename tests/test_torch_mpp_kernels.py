"""P3, P7 and P9 — the MPP kernels' plain versions — held to the reference
on the CPU.

* P9 `block_topk_ref` against the reference's own `MPPEngine._block_topk`
  (a staticmethod) on chip_smoke.py's battery: ties, ±0.0, NaN and -NaN,
  fewer scores above the floor than k, n not a multiple of 1024; the
  valid picks (score above the floor) agree in slot, position and score.
  `topk_score` against `MPPEngine._topk_score`.
* P9's two launches (csrc/block_topk.cu) as a numpy model — the chunk
  maxima, the radix select of the kk best chunks and their worst maximum
  T, each picked chunk's kk best entries no worse than T, the merge's
  select and sort — against `block_topk_ref` and the reference on
  chip_smoke.py's edge battery (TOPK_EDGE_SHAPES: equal keys, sorted
  lanes, every winner in one chunk, winners tied across chunk edges, NaN /
  ±0.0 / ±inf, the int64 floor, n = 1, 1023, 1024, 1025 and kk × 1024 ± 1,
  kk 1, 16 and 512): every pick above the floor in the same slot, position
  and bits.
* P3 and P7 through the one-device program: synthetic plans built by
  both packages from one spec (test_torch_mpp.Pkg) run on the
  reference's MPPEngine over `make_mesh(1)` and on the port's
  MPPEngine(device="cpu"):
    - P3 in rows mode: probe keys with NULLs and values outside the build
      domain on both sides, build keys with gaps (absent LUT slots), a
      two-key LUT, a build mask from a pushed condition, a stream
      prefiltered on a nullable column, two levels, residual ON
      conditions (NULL-able) on both levels;
    - P7 in the clustered mode: an int64 lane whose prefix overflows,
      float lanes, a NULL-able argument (the dedicated presence lane), a
      giant run, ascending order, fewer groups than k, the pad tail of the
      pow2 stream.
  Joined rows and partial chunks compare exactly (floats within rtol
  1e-9 / atol 1e-6).
* P7's and P3's plain versions against numpy: integer run totals equal
  the exact suffix sums modulo 2^64; float run totals at run starts
  within tolerance of math.fsum, as the reference's are at every row.
"""

import math

import numpy as np
import pytest
import torch
from chip_smoke import (LUT_SHAPES, RUN_SHAPES, TOPK_EDGE_SHAPES, TOPK_SHAPES, lut_battery, p3_args, p7_args,
                        run_battery, same_block_topk, topk_battery, topk_edge_battery)
from test_torch_engine import _assert_same_chunk
from test_torch_mpp import run_spec

from tidb_tpu.jaxenv import jnp
from tidb_tpu.parallel.mpp import MPPEngine as RefEngine

from tidb_tpu_torch.kernels import block_topk, block_topk_ref, lut_join, lut_join_ref, run_agg, run_agg_ref
from tidb_tpu_torch.kernels.run_agg import topk_score
from tidb_tpu_torch.parallel.mpp import MPPEngine

RTOL, ATOL = 1e-9, 1e-6
SMALL_TOPK = [s for s in TOPK_SHAPES if s[0] < 1 << 20]


@pytest.mark.parametrize("n,k,case", SMALL_TOPK)
def test_block_topk_matches_the_reference(n, k, case):
    v = topk_battery(np.random.default_rng(n + k), n, case)
    rv, ri = RefEngine._block_topk(jnp.asarray(v), k)
    want = (torch.from_numpy(np.asarray(rv).copy()), torch.from_numpy(np.asarray(ri).astype(np.int64)))
    t = torch.from_numpy(v)
    got = block_topk_ref(t, k)
    same_block_topk(got, want, t, case)
    assert torch.equal(block_topk(t, k)[1], got[1])  # the wrapper takes the plain version on the CPU
    assert block_topk.launches == 0


def test_block_topk_reference_order_on_the_main_path_size():
    """One main-path shape (2^22 scores, k 10) against the reference."""
    n, k = 1 << 22, 10
    v = topk_battery(np.random.default_rng(3), n, "floats")
    rv, ri = RefEngine._block_topk(jnp.asarray(v), k)
    t = torch.from_numpy(v)
    same_block_topk(block_topk_ref(t, k),
                    (torch.from_numpy(np.asarray(rv).copy()), torch.from_numpy(np.asarray(ri).astype(np.int64))),
                    t, "floats 2^22")


# --- P9's two launches, modelled in numpy ----------------------------------------

CHUNK = 1024
NONE = (1 << 63) - 1
U = np.uint64


def order_keys(v: np.ndarray) -> np.ndarray:
    """csrc/block_topk.cu's order_key: uint64 keys whose order is the
    score's (NaN highest, -0.0 = +0.0, int64 with its sign bit flipped)."""
    if v.dtype == np.float64:
        b = np.where(v == 0.0, 0.0, v).view(U)
        u = np.where(b >> U(63) == U(1), ~b, b | U(1 << 63))
        return np.where(np.isnan(v), ~U(0), u)
    return v.view(U) ^ U(1 << 63)


def radix_select(u: np.ndarray, p: np.ndarray, keep: np.ndarray, k: int) -> np.ndarray:
    """block_select: the indices (in list order) of the k best kept entries
    of a list in position order — 8-bit digits from the top of u, stopping
    once the entries on the chosen prefix are exactly those still needed;
    of the entries on the prefix, the first in list order."""
    idx = np.flatnonzero(keep & (p != NONE))
    if len(idx) <= k:
        return idx
    prefix, mask, need = U(0), U(0), k
    for shift in range(56, -8, -8):
        on = idx[(u[idx] & mask) == prefix]
        hist = np.bincount(((u[on] >> U(shift)) & U(0xFF)).astype(np.int64), minlength=256)
        above = 0
        for d in range(255, -1, -1):
            if above + hist[d] >= need:
                break
            above += hist[d]
        need -= above
        prefix |= U(d) << U(shift)
        mask |= U(0xFF) << U(shift)
        if hist[d] == need:
            break
    m = u[idx] & mask
    return np.sort(np.concatenate([idx[m > prefix], idx[m == prefix][:need]]))


def model_block_topk(v: np.ndarray, kk: int):
    """(vals, idx) by csrc/block_topk.cu's plan, step by step."""
    n = len(v)
    u = order_keys(v)
    nb = -(-n // CHUNK)
    # launch 1: each chunk's best (key, position), no sort; then the kq best
    # chunk maxima in chunk order, and T, the worst of them (no cut when
    # there are fewer than kk chunks)
    mu, mp = np.empty(nb, U), np.empty(nb, np.int64)
    for c in range(nb):
        seg = u[c * CHUNK:(c + 1) * CHUNK]
        j = int(np.flatnonzero(seg == seg.max())[0])
        mu[c], mp[c] = seg[j], c * CHUNK + j
    sel = radix_select(mu, mp, np.ones(nb, bool), min(kk, nb))
    picked = mp[sel] // CHUNK
    assert np.all(np.diff(picked) > 0)
    if nb >= kk:
        low = sel[mu[sel] == mu[sel].min()]
        tu, tp = mu[low[-1]], mp[low[-1]]
    else:
        tu, tp = U(0), NONE
    # launch 2: per picked chunk its kk best entries no worse than T, in
    # position order; the merge of the lists, its kk best, sorted
    lu, lp = [], []
    for c in picked:
        cu = u[c * CHUNK:(c + 1) * CHUNK]
        cp = np.arange(c * CHUNK, c * CHUNK + len(cu))
        s = radix_select(cu, cp, (cu > tu) | ((cu == tu) & (cp <= tp)), kk)
        assert len(s) <= kk
        lu.append(cu[s])
        lp.append(cp[s])
    lu, lp = np.concatenate(lu), np.concatenate(lp)
    assert np.all(np.diff(lp) > 0)  # the merged list is in position order
    s = radix_select(lu, lp, np.ones(len(lu), bool), kk)
    assert len(s) == kk
    order = np.lexsort((lp[s], ~lu[s]))
    idx = lp[s][order]
    return v[idx], idx


def same_picks(got, want, v: np.ndarray, what: str) -> None:
    """Every slot whose wanted score is not the floor (NaN included): the
    same position and the same bits. At the floor the reference may repeat
    a position."""
    floor = -np.inf if v.dtype == np.float64 else -(1 << 63)
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    real = ~(wv == floor)
    assert real.any() or len(wv) == 0
    assert np.array_equal(gi[real], wi[real]), what
    assert np.array_equal(gv[real].view(np.int64), v[wi[real]].view(np.int64)), what
    assert np.array_equal(gv.view(np.int64), v[gi].view(np.int64)), what


@pytest.mark.parametrize("n,kk,case", TOPK_EDGE_SHAPES, ids=[f"{c}-n{n}-k{k}" for n, k, c in TOPK_EDGE_SHAPES])
def test_two_launch_model_matches_the_plain_version(n, kk, case):
    v = topk_edge_battery(np.random.default_rng(n + kk), n, case)
    got = model_block_topk(v, kk)
    want = block_topk_ref(torch.from_numpy(v), kk)
    same_picks(got, (want[0].numpy(), want[1].numpy()), v, case)


@pytest.mark.parametrize("n,kk,case", [s for s in TOPK_EDGE_SHAPES if s[1] <= 16] + SMALL_TOPK,
                         ids=[f"{c}-n{n}-k{k}" for n, k, c in [s for s in TOPK_EDGE_SHAPES if s[1] <= 16] + SMALL_TOPK])
def test_two_launch_model_matches_the_reference(n, kk, case):
    rng = np.random.default_rng(n + kk)
    v = topk_edge_battery(rng, n, case)
    rv, ri = RefEngine._block_topk(jnp.asarray(v), kk)
    same_picks(model_block_topk(v, kk), (np.asarray(rv), np.asarray(ri).astype(np.int64)), v, case)


def test_radix_select_stops_early_and_keeps_list_order_on_ties():
    u = np.array([5, 9, 9, 3, 9, 9], dtype=U)
    p = np.arange(6)
    assert radix_select(u, p, np.ones(6, bool), 3).tolist() == [1, 2, 4]  # the first three 9s
    assert radix_select(u, p, np.ones(6, bool), 5).tolist() == [0, 1, 2, 4, 5]
    assert radix_select(u, p, np.array([1, 0, 1, 1, 1, 1], bool), 2).tolist() == [2, 4]
    assert radix_select(u, p, np.ones(6, bool), 6).tolist() == list(range(6))


@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("desc", [True, False])
def test_topk_score_is_the_reference(dtype, desc):
    rng = np.random.default_rng(9)
    if dtype == "int64":
        val = rng.integers(-(1 << 63), (1 << 63) - 1, 2000, dtype=np.int64)
        val[:3] = [-(1 << 63), (1 << 63) - 1, 0]
    else:
        val = rng.standard_normal(2000)
        val[:4] = [np.inf, -np.inf, -0.0, np.nan]
    valid = rng.random(2000) < 0.7
    want = np.asarray(RefEngine._topk_score(jnp.asarray(val), jnp.asarray(valid), desc))
    got = topk_score(torch.from_numpy(val), torch.from_numpy(valid), desc).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("n,B,sizes", LUT_SHAPES)
def test_lut_join_plain_version_against_numpy(n, B, sizes):
    b = lut_battery(np.random.default_rng(n + B), n, B, sizes)
    match, rowid, out = lut_join_ref(*p3_args(b, "cpu"))
    acc = np.zeros(n, dtype=np.int64)
    pkv = np.ones(n, dtype=bool)
    for (d, v), lo, sz, st in zip(b["keys"], b["lo"], b["size"], b["stride"]):
        pkv &= v & (d >= lo) & (d < lo + sz)
        acc += (d - lo) * st
    pos = b["lut"][np.clip(acc, 0, len(b["lut"]) - 1)]
    bsel = np.clip(pos, 0, B - 1)
    m = b["pmask"] & pkv & (pos >= 0) & b["bmask"][bsel]
    assert np.array_equal(match.numpy(), m)
    assert np.array_equal(rowid.numpy(), np.where(m, b["brow"][bsel], -1))
    for (d, v), (gd, gv) in zip(b["gathers"], out):
        assert np.array_equal(gd.numpy().view(np.int64), d[bsel].view(np.int64))
        assert np.array_equal(gv.numpy(), v[bsel] & m)
    got = lut_join(*p3_args(b, "cpu"))
    assert torch.equal(got[0], match) and torch.equal(got[1], rowid) and lut_join.launches == 0


def _suffix_sums(kd, x):
    """Exact sum from each row to the end of its run (Python ints /
    math.fsum)."""
    L = len(kd)
    out = [0] * L
    i = L - 1
    while i >= 0:
        j = i
        while j > 0 and kd[j - 1] == kd[i]:
            j -= 1
        run = x[j:i + 1]
        for r in range(j, i + 1):
            rest = run[r - j:]
            out[r] = math.fsum(rest) if x.dtype.kind == "f" else sum(int(a) for a in rest)
        i = j - 1
    return out


@pytest.mark.parametrize("L,case", [s for s in RUN_SHAPES if s[0] <= 4096] + [(3000, "pad_tail"), (3000, "asc")])
def test_run_agg_plain_version_int_lanes_are_exact_modulo_2_64(L, case):
    b = run_battery(np.random.default_rng(L), L, case)
    totals, gpos, valid, score = run_agg_ref(*p7_args(b, "cpu"))
    kd, mask = b["kd"], b["mask"]
    first = np.concatenate([[True], kd[1:] != kd[:-1]])
    for j, (d, v) in enumerate(b["lanes"]):
        ok = mask if v is None else mask & v
        x = ok.astype(np.int64) if d is None else np.where(ok, d, np.zeros((), d.dtype))
        exact = _suffix_sums(kd, x)
        got = totals[j].numpy()
        if x.dtype.kind == "f":
            assert np.allclose(got[first], np.asarray(exact)[first], rtol=RTOL, atol=ATOL)
        else:
            assert got.tolist() == [((e + (1 << 63)) % (1 << 64)) - (1 << 63) for e in exact]
    cnt, rid = totals[b["cnt_lane"]].numpy(), totals[b["rid_lane"]].numpy()
    assert np.array_equal(gpos.numpy(), np.where(cnt > 0, rid // np.maximum(cnt, 1), -1))
    assert np.array_equal(valid.numpy(), first & (cnt > 0))
    assert torch.equal(run_agg(*p7_args(b, "cpu"))[1], gpos) and run_agg.launches == 0


def test_float_run_totals_at_run_starts_are_exact_within_tolerance():
    """A float lane's run totals are differences of one prefix sum over the
    stream (clustered_agg_stage, mpp.py:1870-1873), at every row. The
    reference's jnp.cumsum keeps them within rtol 1e-9 / atol 1e-6 of the
    exact suffix sums even inside a 270,000-row run; the plain version's
    torch.cumsum adds sequentially and strays inside such a run, where the
    suffix is small next to the prefix. Run starts, the only rows shipped
    as valid, stay within tolerance in both, so P7 (which sums each run
    directly) is held to the plain version there."""
    L = 300_000
    b = run_battery(np.random.default_rng(2), L, "giant_run")
    kd, mask = b["kd"], b["mask"]
    d, v = b["lanes"][2]
    x = np.where(mask & v, d, 0.0)
    prefix = np.asarray(jnp.cumsum(jnp.asarray(x)))
    got = run_agg_ref(*p7_args(b, "cpu"))[0][2].numpy()
    first = np.nonzero(np.concatenate([[True], kd[1:] != kd[:-1]]))[0]
    ends = np.append(first[1:], L) - 1
    big = int(np.argmax(ends - first))
    s, e = first[big], ends[big]
    assert e - s > 100_000
    rows = np.concatenate([np.arange(s, e + 1, 997), np.arange(e - 300, e + 1)])
    exact = np.array([math.fsum(x[r:e + 1]) for r in rows])
    ref_diff = prefix[e] - np.where(rows > 0, prefix[rows - 1], 0.0)
    assert np.allclose(ref_diff, exact, rtol=RTOL, atol=ATOL)
    starts_exact = np.array([math.fsum(x[a:z + 1]) for a, z in zip(first, ends)])
    assert np.allclose(got[first], starts_exact, rtol=RTOL, atol=ATOL)


def test_a_short_float_run_after_a_large_prefix_keeps_its_low_bits():
    """P7's plain version sums a float run directly at its first row: the
    reference's prefix difference there (on the card: 3.3e9 of prefix
    before a run of 147.11) was 1.6e-6 off, past atol 1e-6, where the
    kernel's direct sum is exact; here 2e12 of prefix. Past a non-finite row the prefix differences (and the
    reference's NaN / inf) stay."""
    n = 40_001
    kd = np.arange(n, dtype=np.int64)  # a run a row
    x = np.full(n, 49_999_999.37)
    x[-1] = 147.11
    x[n // 2] = np.inf
    mask = np.ones(n, bool)
    x[-2] = 0.07
    lanes = [(torch.from_numpy(x), None), (None, None)]
    totals = run_agg_ref(torch.from_numpy(kd), torch.from_numpy(mask), lanes, 1, 1, 0, True)[0][0].numpy()
    assert totals[n // 2 - 1] == 49_999_999.37 and np.isinf(totals[n // 2])
    with np.errstate(invalid="ignore"):
        prefix = np.cumsum(x)  # the reference's recipe past the inf: NaN
        assert np.isnan(totals[-1]) and np.isnan(prefix[-1] - prefix[-2])
    x[n // 2] = 1.0
    totals = run_agg_ref(torch.from_numpy(kd), torch.from_numpy(mask), lanes, 1, 1, 0, True)[0][0].numpy()
    assert totals[-1] == 147.11 and totals[-2] == 0.07
    prefix = np.cumsum(x)
    assert abs((prefix[-1] - prefix[-2]) - 147.11) > 1e-6  # what the prefix difference gives


# --- through the one-device program ----------------------------------------

LUT_SPEC_TABLES = {
    "f": [("fid", "bigint!"), ("k1", "bigint"), ("k2", "bigint"), ("v", "double"), ("fv", "bigint")],
    "d": [("id", "bigint!"), ("id2", "bigint!"), ("seg", "bigint!"), ("x", "double"), ("y", "bigint"),
          ("ek", "bigint")],
    "e": [("eid", "bigint!"), ("w", "bigint")],
}


def _lut_tables(rng, n=20_000, nd=2_000, ne=300):
    ids = np.sort(rng.choice(np.arange(10, 3000), nd, replace=False))  # gaps: absent LUT slots
    f = {"fid": np.arange(n), "k1": rng.integers(0, 3100, n), "k2": rng.integers(0, 30, n),
         "v": np.round(rng.standard_normal(n), 3), "fv": rng.integers(-5, 5, n)}
    d = {"id": ids, "id2": rng.integers(5, 25, nd), "seg": rng.integers(0, 3, nd),
         "x": rng.standard_normal(nd), "y": rng.integers(-(1 << 62), 1 << 62, nd), "ek": rng.integers(-3, ne + 3, nd)}
    e = {"eid": np.arange(ne), "w": rng.integers(0, 100, ne)}
    valid = {"f": {n_: rng.random(n) > 0.1 for n_ in ("k1", "k2", "v")},
             "d": {"x": rng.random(nd) > 0.1, "y": rng.random(nd) > 0.1, "ek": rng.random(nd) > 0.1},
             "e": {"w": rng.random(ne) > 0.1}}
    for t, masks in valid.items():
        tbl = {"f": f, "d": d, "e": e}[t]
        for c, m in masks.items():
            tbl[c] = np.where(m, tbl[c], np.zeros((), tbl[c].dtype))
    return {"f": f, "d": d, "e": e}, valid


LUT_SPECS = {
    "one_key": {"scans": ["f", "d"], "joins": [(["f.k1"], ["d.id"])],
                "pushed": {"d": [("ne", ("col", "seg"), ("int", 1))], "f": [("gt", ("col", "v"), ("float", -0.5))]}},
    "two_key": {"scans": ["f", "d"], "joins": [(["f.k1", "f.k2"], ["d.id", "d.id2"])],
                "pushed": {"d": [("lt", ("col", "seg"), ("int", 2))]}},
    "two_levels": {"scans": ["f", "d", "e"], "joins": [(["f.k1"], ["d.id"]), (["d.ek"], ["e.eid"])],
                   "pushed": {"e": [("gt", ("col", "w"), ("int", 10))], "f": [("ne", ("col", "fv"), ("int", 0))]}},
    "on_conditions": {"scans": ["f", "d", "e"], "joins": [(["f.k1"], ["d.id"]), (["d.ek"], ["e.eid"])],
                      "post": {0: [("lt", ("col", "f.fv"), ("col", "d.id2"))],
                               1: [("ne", ("col", "e.w"), ("col", "f.k2"))]}},
}


@pytest.mark.parametrize("case", sorted(LUT_SPECS))
def test_lut_join_through_the_program_matches_the_reference(case):
    tables, valid = _lut_tables(np.random.default_rng(11))
    spec = {"tables": LUT_SPEC_TABLES, **LUT_SPECS[case]}
    spec["tables"] = {t: LUT_SPEC_TABLES[t] for t in spec["scans"]}
    ref, port, want, got = run_spec(spec, tables, valid)
    assert want is not None and got is not None and got[1] == want[1] is False
    assert got[0].num_rows > 100
    _assert_same_chunk(want[0], got[0])
    assert port.last_fuse_outcome == ref.last_fuse_outcome == "fused"


RUN_SPEC_TABLES = {
    "f": [("fid", "bigint!"), ("did", "bigint!"), ("big", "bigint"), ("v", "double!"), ("w", "double"),
          ("q", "bigint!")],
    "d": [("id", "bigint!"), ("seg", "bigint!")],
}


def _run_tables(rng, case, n=30_000, nd=5_000):
    ids = np.arange(nd) * 97 + 3  # a wide key domain: not the dense mode
    if case == "giant_run":
        did = np.sort(np.where(rng.random(n) < 0.6, ids[17], rng.choice(ids, n)))
    elif case == "few_groups":
        did = np.sort(rng.choice(ids[:6], n))
    else:
        did = np.sort(np.where(rng.random(n) < 0.97, rng.choice(ids, n), 1))  # some keys miss
    f = {"fid": np.arange(n), "did": did,
         "big": np.where(rng.random(n) < 0.5, 1, -1) * ((1 << 62) + rng.integers(0, 1 << 40, n)),
         "v": np.round(rng.random(n) * 1e4, 2), "w": np.round(rng.standard_normal(n) * 100, 3),
         "q": rng.integers(0, 10, n)}
    d = {"id": ids, "seg": rng.integers(0, 4, nd)}
    valid = {"f": {"big": rng.random(n) > 0.1, "w": rng.random(n) > 0.1}}
    for c, m in valid["f"].items():
        f[c] = np.where(m, f[c], np.zeros((), f[c].dtype))
    return {"f": f, "d": d}, valid


RUN_SPECS = {
    "float_desc": ([("sum", ("col", "f.v"))], (0, True, 10), "runs"),
    "int_overflow_presence_lane": ([("sum", ("col", "f.big")), ("avg", ("col", "f.w"))], (0, True, 10), "runs"),
    "count_and_sums": ([("sum", ("col", "f.big")), ("count",), ("sum", ("col", "f.w"))], (1, True, 12), "runs"),
    "float_asc": ([("sum", ("col", "f.w")), ("count",)], (0, False, 10), "runs"),
    "giant_run": ([("sum", ("col", "f.v")), ("sum", ("col", "f.big"))], (1, True, 10), "giant_run"),
    "fewer_groups_than_k": ([("sum", ("col", "f.v"))], (0, True, 20), "few_groups"),
}


@pytest.mark.parametrize("case", sorted(RUN_SPECS))
def test_clustered_agg_through_the_program_matches_the_reference(case):
    aggs, topn, data = RUN_SPECS[case]
    tables, valid = _run_tables(np.random.default_rng(17), data)
    spec = {"tables": RUN_SPEC_TABLES, "scans": ["f", "d"], "joins": [(["f.did"], ["d.id"])],
            "pushed": {"d": [("ne", ("col", "seg"), ("int", 3))], "f": [("ne", ("col", "q"), ("int", 0))]},
            "agg": {"group_by": ["d.id"], "aggs": aggs}, "topn": topn}
    ref, port, want, got = run_spec(spec, tables, valid)
    assert want is not None and got is not None and got[1] == want[1] is True
    prog = next(iter(port._programs.values()))
    assert prog.agg_meta["mode"] == "clustered"
    assert (prog.agg_meta["rp_presence"] is None) == (case == "int_overflow_presence_lane")
    if case == "fewer_groups_than_k":
        assert 0 < got[0].num_rows < topn[2]
    else:
        assert got[0].num_rows >= topn[2]
    _assert_same_chunk(want[0], got[0])
    assert port.last_fuse_outcome == ref.last_fuse_outcome == "fused"
