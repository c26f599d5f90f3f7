"""P4, P5, P6 and P8 — the MPP modes' plain versions — held to the
reference on the CPU.

* P8 `dense_agg_ref` and P6 `rowpos_agg_ref` against the reference's own
  `MPPEngine._agg_partials` (a staticmethod, with the reference's
  `TPUEngine._eval_device`) on chip_smoke.py's batteries: int64 sums that
  overflow, float sums with -0.0, float min with NaN, int64 max at the
  extremes, uint64 min / max above and below 2^63 (whose sentinel takes
  part in the reference), dict-code min, NULLs and empty segments; P8's
  int32 code against the reference's expression for keys above 2^31; P6's
  picks against `_topk_score` and `lax.top_k` (fewer groups than k
  included).
* P4 `sort_join_ref` against a nested-loop join on the batteries: unique
  and duplicate build keys, inner and left, two keys, int32 keys whose
  NULL data wraps, valid keys equal to the sort sentinel, a capacity
  below the output (the dropped count); the slot order of a duplicate key
  is the build side's row order (the reference's stable argsort).
* P4, P5, P6 and P8 through the one-device program (test_torch_mpp.Pkg
  builds one spec in both packages, run on the reference's MPPEngine over
  `make_mesh(1)` and on the port's): the sorted mode (wide keys, fused
  OFF) with NaN, ±0, overflowing int64 and uint64 lanes and fewer groups
  than k; the dense mode with a key above 2^31, dict-coded min / max and
  uint64 lanes; the rowpos mode with min / max lanes; a two-key
  duplicate-key level.

Picks are compared where valid (as for P9); the scores of these cases
are integer sums or counts, so the picks are exact. Floats within rtol
1e-9 / atol 1e-6, everything else exactly.
"""

import numpy as np
import pytest
import torch
from chip_smoke import (DENSE_SHAPES, ROWPOS_SHAPES, SEG_REDUCE_SHAPES, SORT_JOIN_SHAPES, dense_battery, p4_args,
                        p5_args, p6_args, p8_args, rowpos_battery, seg_reduce_battery, sort_join_battery)
from test_torch_engine import _assert_same_chunk
from test_torch_mpp import run_spec

from tidb_tpu.copr.tpu_engine import TPUEngine
from tidb_tpu.jaxenv import jax, jnp
from tidb_tpu.parallel.mpp import MPPEngine as RefEngine

from tidb_tpu_torch.kernels import (dense_agg, dense_agg_ref, rowpos_agg, rowpos_agg_ref, seg_reduce,
                                    seg_reduce_ref, sort_join, sort_join_ref)
from tidb_tpu_torch.kernels.dense_agg import dense_code_ref

RTOL, ATOL = 1e-9, 1e-6
I64_MAX = np.iinfo(np.int64).max


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_lane(got, want, what):
    got, want = _np(got), _np(want)
    if want.dtype == np.uint64:
        want = want.view(np.int64)
    if got.dtype == np.uint64:
        got = got.view(np.int64)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} vs {want.dtype}"
    if want.dtype.kind == "f":
        assert np.allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True), what
    else:
        assert np.array_equal(got, want), what


# --- _agg_partials: P8 and P6 against the reference's own partials ---------

def _ref_agg(op):
    """The reference aggregate whose _agg_partials value lane is `op`."""
    from tidb_tpu.expr.aggregation import AggDesc
    from tidb_tpu.expr.expression import Column
    from tidb_tpu.mysqltypes.field_type import ft_double, ft_longlong

    ft = ft_double() if op.endswith("f64") else ft_longlong(op.endswith("u64"))
    name = {"sum": "sum", "min": "min", "max": "max"}[op.split("_")[0]]
    return AggDesc.make(name, [Column(0, ft, "x")])


def _ref_partials(battery_lanes, mask, seg, nseg):
    """The battery's lanes through the reference's _agg_partials: each
    value lane with the count lane after it (they share its valid), and
    count lanes through a COUNT(x)."""
    from tidb_tpu.expr.aggregation import AggDesc
    from tidb_tpu.expr.expression import Column
    from tidb_tpu.mysqltypes.field_type import ft_longlong

    out, j = [], 0
    jmask, jseg = jnp.asarray(mask), jnp.asarray(seg)
    while j < len(battery_lanes):
        op, d, v = battery_lanes[j]
        if op == "count":
            vv = np.ones(len(mask), bool) if v is None else v
            a = AggDesc.make("count", [Column(0, ft_longlong(), "x")])
            lanemap = {0: (jnp.zeros(len(mask), jnp.int64), jnp.asarray(vv))}
            out += RefEngine._agg_partials(a, [a.args[0]], lanemap, jmask, jseg, nseg, TPUEngine._eval_device)
            j += 1
            continue
        a = _ref_agg(op)
        dd = d.view(np.uint64) if op.endswith("u64") else d
        lanemap = {0: (jnp.asarray(dd), jnp.asarray(v))}
        out += RefEngine._agg_partials(a, [a.args[0]], lanemap, jmask, jseg, nseg, TPUEngine._eval_device)
        assert battery_lanes[j + 1][0] == "count"  # the battery pairs each value lane with its count
        j += 2
    return [np.asarray(x) for x, _ in out]


@pytest.mark.parametrize("n,case", [s for s in DENSE_SHAPES if s[0] <= 200_000])
def test_dense_agg_plain_version_is_the_reference_partials(n, case):
    b = dense_battery(np.random.default_rng(n), n, case)
    mask, keys, nseg, lanes = p8_args(b, "cpu")
    # the reference's int32 code (mpp.py:1962-1967), its expression as written
    code = jnp.zeros(n, dtype=jnp.int32)
    for d, v, lo, dom in b["keys"]:
        code = code * (dom + 1) + (jnp.asarray(d).astype(jnp.int32) - lo + 1) * jnp.asarray(v)
    seg = np.asarray(jnp.where(jnp.asarray(b["mask"]), code, nseg))
    assert np.array_equal(dense_code_ref(mask, keys, nseg).numpy(), seg)
    want = _ref_partials(b["lanes"], b["mask"], seg, nseg)
    got = dense_agg_ref(mask, keys, nseg, lanes)
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        _same_lane(g, w, f"{case} lane {j} ({lanes[j].op})")
    assert dense_agg.launches == 0
    rows = torch.zeros((len(lanes), nseg + 3), dtype=torch.int64)
    for g, r in zip(dense_agg(mask, keys, nseg, lanes, rows=rows), got):  # the wrapper takes the plain version
        _same_lane(g, r, case)
    assert not rows[:, nseg:].any()


def test_dense_code_of_keys_above_2_31_is_the_int64_code():
    """int32 wrap arithmetic on both sides of the subtraction gives the
    narrow domain's exact offsets, as the reference's jnp code does."""
    b = dense_battery(np.random.default_rng(4), 3000, "big_keys")
    d, v, lo, dom = b["keys"][0]
    assert lo > 1 << 31
    seg = dense_code_ref(*p8_args(b, "cpu")[:2], b["nseg"]).numpy()
    want = np.where(b["mask"], np.where(v, d - lo + 1, 0), b["nseg"])
    assert np.array_equal(seg, want)


@pytest.mark.parametrize("n,B,case", [s for s in ROWPOS_SHAPES if s[0] <= 200_000])
def test_rowpos_agg_plain_version_is_the_reference_stage(n, B, case):
    """rowpos_agg_stage at n_dev 1 (mpp.py:1797-1848) with its own
    staticmethods: _agg_partials, _topk_score, then lax.top_k."""
    b = rowpos_battery(np.random.default_rng(n + B), n, B, case)
    args = p6_args(b, "cpu")
    got = rowpos_agg_ref(*args)
    seg = np.where(b["mask"], np.clip(b["rid"], 0, B - 1), B)
    full = _ref_partials(b["lanes"], b["mask"], seg, B)
    for j, (g, w) in enumerate(zip(got.full, full)):
        _same_lane(g, w, f"{case} lane {j}")
    valid = full[b["pres"]] > 0
    score = RefEngine._topk_score(jnp.asarray(full[b["score_lane"]]), jnp.asarray(valid), b["desc"])
    kk = min(max(b["k"], len(full) + 4), B)
    _, idx = jax.lax.top_k(score, kk)
    idx = np.asarray(idx)
    assert np.array_equal(got.idx.numpy(), idx)
    assert np.array_equal(got.gidx.numpy(), np.where(valid[idx], idx, -1))
    if case == "few":
        assert valid.sum() < kk  # the picks run out: invalid picks ship with valid False
    out = rowpos_agg(*args)
    assert torch.equal(out.gidx, got.gidx) and rowpos_agg.launches == 0


# --- P4 against a nested-loop join -------------------------------------------

def _nested_loop(b):
    """(probe row, build row or -1) pairs in output order: each probe row
    in turn with its matching build rows in build row order; a left join
    keeps an unmatched probe row once. NULL keys and masked rows never
    match; an int32 level compares the truncated packed keys; a key equal
    to the sort sentinel as the reference's sort-probe meets it."""
    def packed(keys):
        acc = np.zeros(len(keys[0][0]), dtype=np.int64)
        ok = np.ones(len(keys[0][0]), dtype=bool)
        for (d, v), lo, st in zip(keys, b["lo"], b["stride"]):
            acc = acc + (d - lo) * st
            ok &= v
        return (acc.astype(np.int32).astype(np.int64) if b["key_i32"] else acc), ok

    pk, pok = packed(b["pkeys"])
    bk, bok = packed(b["bkeys"])
    bval = bok & b["bmask"]
    by_key = {}
    for j in np.nonzero(bval)[0]:
        by_key.setdefault(int(bk[j]), []).append(int(j))
    key_max = (1 << 31) - 1 if b["key_i32"] else I64_MAX
    # invalid build rows sort as the sentinel: a probe key equal to it meets
    # the first such row in row order, and matches only if that one is valid
    at_max = np.nonzero(np.where(bval, bk, key_max) == key_max)[0]
    if len(at_max):
        by_key[key_max] = [int(at_max[0])] if bval[at_max[0]] else []
    pairs = []
    for i in range(len(pk)):
        hits = by_key.get(int(pk[i]), []) if b["pmask"][i] and pok[i] else []
        if hits:
            pairs += [(i, j) for j in hits]
        elif b["left"] and b["pmask"][i]:
            pairs.append((i, -1))
    return pairs


@pytest.mark.parametrize("n,B,case", [s for s in SORT_JOIN_SHAPES if s[0] <= 5000])
def test_sort_join_plain_version_is_the_nested_loop_join(n, B, case):
    b = sort_join_battery(np.random.default_rng(n + B), n, B, case)
    args = p4_args(b, "cpu")
    res = sort_join_ref(*args)
    pairs = _nested_loop(b)
    brow = b["brow"]
    if b["mult"] == 1:
        mask = res.mask.numpy()
        rowid = res.rowid.numpy()
        want = dict(pairs)
        assert mask.tolist() == [(i in want) for i in range(n)]
        assert rowid.tolist() == [int(brow[want[i]]) if want.get(i, -1) >= 0 else -1 for i in range(n)]
        for (gd, gv), (d, v) in zip(res.gathered, b["gathers"]):
            for i in range(n):  # a matched row carries its build row's lane
                if want.get(i, -1) >= 0:
                    j = want[i]
                    assert gv[i].item() == v[j] and (not v[j] or _np(gd)[i:i + 1].view(np.int64)[0]
                                                     == d[j:j + 1].view(np.int64)[0])
        assert res.dropped is None
    else:
        total = len(pairs)
        C = b["cap"]
        assert int(res.dropped[0]) == max(total - C, 0)
        if total > C:
            assert case == "overflow"
            return
        mask, rowid = res.mask.numpy(), res.rowid.numpy()
        prow0 = res.prows[0].numpy()
        got = [(int(prow0[j]) // 3, int(rowid[j])) for j in range(total)]
        want = [(i, int(brow[j]) if j >= 0 else -1) for i, j in pairs]
        assert got == want
        assert mask[:total].tolist() == [(j >= 0) or b["left"] for _, j in pairs]
        assert not mask[total:].any() and (rowid[total:] == -1).all() and (prow0[total:] == -1).all()
        for (pd, pv), (d, v) in zip(res.probe_lanes, b["probe_lanes"]):
            src = np.array([i for i, _ in pairs], dtype=np.int64)
            assert np.array_equal(_np(pv)[:total], v[src]) and not _np(pv)[total:].any()
            assert np.array_equal(_np(pd)[:total].view(np.int64), d[src].view(np.int64))
    got = sort_join(*args)
    assert torch.equal(got.mask, res.mask) and sort_join.launches == 0


def _seg_totals(b):
    """{group code: [per lane total]} of a seg_reduce_battery in numpy:
    sums modulo 2^64 (floats by math.fsum; NaN for a group whose smaller
    codes hold a NaN or an infinity, as the reference's prefix difference
    gives), min / max NaN-first, every value where(ok, d, sentinel), and a
    uint64 min / max combined once more with the reference's neutral
    (2^63 - 1 / 2^63) unless one run spans all rows and their count is a
    power of two."""
    import math

    n = len(b["mask"])
    code = np.zeros(n, dtype=np.int64)
    for d, v, lo, step, st, is_int in b["keys"]:
        kd = ((d - lo) // step + 1) if is_int else d + 1
        code = code + np.where(v, kd, 0) * st
    code = np.where(b["mask"], code, I64_MAX)
    single = len(set(code.tolist())) == 1 and n & (n - 1) == 0
    # per float-sum lane the least code holding a non-finite value: the
    # groups after it total NaN (the reference's prefix difference)
    poison = []
    for op, d, v in b["lanes"]:
        ok = b["mask"] & (v if v is not None else True)
        bad = ok & ~np.isfinite(d) if op == "sum_f64" else np.zeros(n, bool)
        poison.append(code[bad].min() if bad.any() else None)
    out = {}
    for c in np.unique(code):
        rows = np.nonzero(code == c)[0]
        tot = []
        for (op, d, v), pz in zip(b["lanes"], poison):
            ok = b["mask"][rows] & (v[rows] if v is not None else True)
            if op == "count":
                tot.append(int(ok.sum()))
                continue
            x = d[rows]
            if op == "sum_f64" and pz is not None and pz < c:
                tot.append(np.nan)
                continue
            if op == "sum_f64" and not np.isfinite(x[ok]).all():
                tot.append(float(np.sum(x[ok])))
                continue
            if op.startswith("sum"):
                tot.append(math.fsum(x[ok]) if op.endswith("f64")
                           else int(np.sum(np.where(ok, x, 0).astype(np.uint64), dtype=np.uint64).view(np.int64)))
                continue
            big = {"min": (np.inf, I64_MAX), "max": (-np.inf, -I64_MAX - 1)}[op[:3]]
            if op.endswith("f64"):
                x = np.where(ok, x, big[0])
                tot.append(np.nan if np.isnan(x).any() else (x.min() if op[:3] == "min" else x.max()))
                continue
            x = np.where(ok, x, big[1])
            if op.endswith("u64"):
                x = x.view(np.uint64)
                if not single:
                    x = np.append(x, np.uint64(big[1] & ((1 << 64) - 1)))
            tot.append(int((x.min() if op[:3] == "min" else x.max()).astype(np.uint64).view(np.int64)
                           if op.endswith("u64") else (x.min() if op[:3] == "min" else x.max())))
        out[int(c)] = tot
    return out


@pytest.mark.parametrize("n,case", [s for s in SEG_REDUCE_SHAPES if s[0] <= 5000])
def test_seg_reduce_plain_version_totals_are_the_groups(n, case):
    """At each run's first row (the rows the picks can ship as valid) the
    totals are the group's, by a numpy group-by; the integer sum lanes are
    0 at the other rows; the picks are lax.top_k's of the reference's
    score; the wrapper takes the plain version on the CPU."""
    b = seg_reduce_battery(np.random.default_rng(n), n, case)
    args = p5_args(b, "cpu")
    got = seg_reduce_ref(*args)
    want = _seg_totals(b)
    fkey, valid = got.fkey.numpy(), got.fvalid.numpy()
    assert valid.sum() == len([c for c in want if c != I64_MAX])
    for i in np.nonzero(valid)[0]:
        for j, (ln, t) in enumerate(zip(args[2], got.totals)):
            g, w = t.numpy()[i], want[int(fkey[i])][j]
            if ln.is_float:
                assert np.isclose(g, w, rtol=RTOL, atol=ATOL, equal_nan=True), (case, j, g, w)
            else:
                assert int(g) == int(w), (case, j, ln.op, int(g), int(w))
    for ln, t in zip(args[2], got.totals):
        if ln.is_sum and not ln.is_float:  # (a float sum past a poisoned row is NaN everywhere)
            assert not t.numpy()[~valid].any()
    # the picks: lax.top_k of the score, from the reference's _topk_score
    score = RefEngine._topk_score(jnp.asarray(got.totals[b["score_lane"]].numpy()), jnp.asarray(valid), b["desc"])
    _, idx = jax.lax.top_k(score, min(b["k"], n))
    assert np.array_equal(got.idx.numpy(), np.asarray(idx))
    out = seg_reduce(*args)
    assert torch.equal(out.idx, got.idx) and seg_reduce.launches == 0


# --- through the one-device program ----------------------------------------

HAZARD_TABLES = {
    "f": [("fid", "bigint!"), ("k", "bigint!"), ("g1", "bigint"), ("g2", "bigint"), ("big", "bigint"),
          ("v", "double"), ("u", "ubig"), ("s", "str"), ("kb", "bigint")],
    "d": [("id", "bigint!"), ("seg", "bigint!"), ("id2", "bigint!"), ("name", "str")],
}


def _hazard_tables(rng, n=6000, nd=5000, few=False):
    ids = np.arange(nd) * 17 + 5  # a key domain past DIRECT_GROUP_MAX: grouping by it is not dense
    f = {"fid": np.arange(n), "k": np.where(rng.random(n) < 0.97, rng.choice(ids, n), 4),
         "g1": rng.choice([0, 100_000, 200_000], n) if few else rng.integers(0, 400_000, n) * 3,
         "g2": rng.integers(-5, 5, n),
         "big": np.where(rng.random(n) < 0.5, 1, -1) * ((1 << 62) + rng.integers(0, 1 << 40, n)),
         "v": np.round(rng.standard_normal(n) * 100, 3), "u": rng.integers(0, 1 << 64, n, dtype=np.uint64),
         "s": rng.choice(np.array(["ant", "bee", "cat", "dog", "eel"], dtype=object), n),
         "kb": 3_000_000_000 + rng.integers(0, 30, n)}
    f["v"][rng.random(n) < 0.01] = np.nan
    f["v"][rng.random(n) < 0.05] = -0.0
    f["u"][rng.random(n) < 0.5] >>= np.uint64(1)
    d = {"id": ids, "seg": rng.integers(0, 6, nd), "id2": rng.integers(0, 3, nd),
         "name": rng.choice(np.array(["x", "y", "z"], dtype=object), nd)}
    valid = {"f": {c: rng.random(n) > 0.1 for c in ("g1", "g2", "big", "v", "u", "s", "kb")}}
    for c, m in valid["f"].items():
        f[c] = np.where(m, f[c], None if f[c].dtype == object else np.zeros((), f[c].dtype))
    return {"f": f, "d": d}, valid


MINMAX = [("min", ("col", "f.v")), ("max", ("col", "f.v")), ("min", ("col", "f.u")), ("max", ("col", "f.u"))]
HAZARD_SPECS = {
    # wide group keys, a fused TopN: the sorted mode (fused OFF)
    "sorted": ({"group_by": ["f.g1", "f.g2"], "aggs": [("sum", ("col", "f.big")), ("count",)] + MINMAX
                + [("sum", ("col", "f.u")), ("avg", ("col", "f.v"))]}, (0, True, 10), {"tidb_tpu_mpp_fused": "OFF"},
               False, "sorted"),
    "sorted_few_groups": ({"group_by": ["f.g1"], "aggs": [("count",), ("max", ("col", "f.u"))]}, (0, False, 50),
                          {"tidb_tpu_mpp_fused": "OFF"}, True, "sorted"),
    # narrow keys: the dense mode, dict-coded and uint64 min / max
    "dense": ({"group_by": ["d.seg", "f.g2"], "aggs": [("sum", ("col", "f.big")), ("min", ("col", "f.s")),
                                                      ("max", ("col", "f.s"))] + MINMAX
               + [("avg", ("col", "f.v")), ("count", ("col", "f.v"))]}, None, {}, False, "dense"),
    "dense_key_above_2_31": ({"group_by": ["f.kb"], "aggs": [("count",), ("sum", ("col", "f.big"))] + MINMAX},
                             None, {}, False, "dense"),
    # group by the unique build key with min / max: rowpos (agg_needs_minmax)
    "rowpos": ({"group_by": ["d.id"], "aggs": [("sum", ("col", "f.big"))] + MINMAX + [("count", ("col", "f.v"))]},
               (0, True, 10), {}, False, "rowpos"),
    "rowpos_few": ({"group_by": ["d.id"], "aggs": [("count", ("col", "f.u")), ("min", ("col", "f.v"))]},
                   (0, True, 80), {}, True, "rowpos"),
}


@pytest.mark.parametrize("case", sorted(HAZARD_SPECS))
def test_mode_hazards_through_the_program_match_the_reference(case):
    agg, topn, variables, few, mode = HAZARD_SPECS[case]
    tables, valid = _hazard_tables(np.random.default_rng(31), few=few)
    if case == "rowpos_few":  # a handful of build rows matched: fewer groups than k
        tables["f"]["k"] = np.random.default_rng(2).choice(tables["d"]["id"][[3, 70, 900]], len(tables["f"]["k"]))
    spec = {"tables": HAZARD_TABLES, "scans": ["f", "d"], "joins": [(["f.k"], ["d.id"])],
            "pushed": {"d": [("ne", ("col", "id2"), ("int", 1))]}, "agg": agg, "topn": topn}
    ref, port, want, got = run_spec(spec, tables, valid, variables)
    assert want is not None and got is not None and got[1] == want[1] is True
    prog = next(iter(port._programs.values()))
    assert prog.agg_meta["mode"] == mode
    assert got[0].num_rows > 0
    if topn is not None and few:
        assert got[0].num_rows < topn[2]
    _assert_same_chunk(want[0], got[0])
    assert (port.last_fuse_outcome, port.fallback_counts) == (ref.last_fuse_outcome, ref.fallback_counts)


def test_two_key_duplicate_level_through_the_program_matches_the_reference():
    rng = np.random.default_rng(41)
    tables, valid = _hazard_tables(rng)
    tables["d"]["id"] = rng.integers(0, 2000, len(tables["d"]["id"]))  # duplicate build keys
    tables["f"]["k"] = rng.integers(0, 2000, len(tables["f"]["k"]))
    spec = {"tables": HAZARD_TABLES, "scans": ["f", "d"], "joins": [(["f.k", "f.g2"], ["d.id", "d.id2"])]}
    ref, port, want, got = run_spec(spec, tables, valid)
    assert want is not None and got is not None and got[0].num_rows > 100
    _assert_same_chunk(want[0], got[0])
    lvl = next(iter(next(iter(port._programs.values())).levels.values()))
    assert lvl.mult == 2 and not lvl.use_lut and lvl.key_i32
    assert port.last_fuse_reasons == ref.last_fuse_reasons == {0: "dup_build_keys"}


def test_clustered_float_sums_past_a_nan_are_nan_as_the_reference():
    """The clustered mode's run totals are prefix differences in the
    reference (mpp.py:1870-1873): past a NaN or an infinity in a float
    lane every run totals NaN. The port's P7 (kernel and plain version)
    keeps that; the card holds the kernel to the plain version on the
    same hazard (chip_smoke.py's run_battery 'nan')."""
    from test_torch_mpp_kernels import RUN_SPEC_TABLES, _run_tables

    tables, valid = _run_tables(np.random.default_rng(17), "runs")
    w = tables["f"]["w"]
    w[np.random.default_rng(3).choice(len(w), 4, replace=False)] = [np.nan, np.inf, -np.inf, np.nan]
    spec = {"tables": RUN_SPEC_TABLES, "scans": ["f", "d"], "joins": [(["f.did"], ["d.id"])],
            "agg": {"group_by": ["d.id"], "aggs": [("sum", ("col", "f.v")), ("sum", ("col", "f.w"))]},
            "topn": (0, True, 10)}
    ref, port, want, got = run_spec(spec, tables, valid)
    assert next(iter(port._programs.values())).agg_meta["mode"] == "clustered"
    w_sums = got[0].columns[2].data  # the group key, sum(v), sum(w)
    assert np.isnan(w_sums).any() and not np.isnan(w_sums).all()
    _assert_same_chunk(want[0], got[0])
