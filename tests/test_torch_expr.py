"""The port's expression program (expr/program.py + kernels/expr_eval)
against the reference on the CPU.

* Seeded random trees over all 16 builtins of the slice and every lane
  kind (int64 at its limits, uint64 above 2^63, float64 with NaN, ±inf,
  ±0.0 and subnormals, decimals at scales 0..12 with the `_round_div`
  branch, dates, int32 dict codes with -1, NULL lanes; NULL, BIGINT
  UNSIGNED and float literals) are built once from each package's own
  expression classes. The reference evaluates them with the static
  `TPUEngine._eval_device` and `_mask` (JAX on the CPU); the port compiles
  them and runs `expr_eval_ref`. Data and valid lanes, and masks, must be
  bit-identical for ints and bools; floats within rtol 1e-9 / atol 1e-6.
* K4's bitwise ops (the plain version) against the reference's per-bit
  partials, nseg 1 and past 64.
* Engine parity for Q1, Q6, both TopNs, Q18's subquery and a window's
  scan, compression ON and OFF, with the fallbacks and the program
  launches counted.
* A deep tree runs and is not declined; a program wider than its
  register budget reloads its lanes and gives the same answer.
"""

import numpy as np
import pytest
import torch

from tidb_tpu.copr.tilecache import ColumnBatch as RefBatch
from tidb_tpu.copr.tpu_engine import TPUEngine
from tidb_tpu.jaxenv import jnp

from tidb_tpu_torch.copr.gpu_engine import TorchEngine
from tidb_tpu_torch.entry import batch_from_numpy
from tidb_tpu_torch.expr import program as P
from tidb_tpu_torch.expr.program import ProgramCache, ValueSpec, compile_program, evaluate
from tidb_tpu_torch.expr.xp_torch import U64
from tidb_tpu_torch.kernels.seg_agg import SegLane, seg_agg_ref

from test_torch_engine import COL, LINEITEM_COLS, PORT, REF, TPCH_SPECS, _assert_same_chunk

RTOL, ATOL = 1e-9, 1e-6
N = 48
I64 = np.iinfo(np.int64)

# name, FieldType kind of Pkg.ft (or "code": an int32 dict-code lane under BIGINT), decimal scale
COLS = [("i", "bigint", 0), ("u", "ubigint", 0), ("f", "double", 0), ("d0", "dec", 0), ("d2", "dec", 2),
        ("d6", "dec", 6), ("d12", "dec", 12), ("dt", "date", 0), ("c", "code", 0), ("k", "bigint", 0)]


def _ft(pkg, kind, scale):
    if kind == "dec":
        return pkg.F.ft_decimal(30, scale)
    if kind == "code":
        return pkg.F.ft_longlong()
    return pkg.ft(kind)


def _lanes(seed: int):
    """numpy (data, valid) per column; NULL slots zeroed as the storage does."""
    rng = np.random.default_rng(seed)
    edge_i = np.array([I64.min, I64.max, -1, 0, 1, I64.min + 1, 12345], dtype=np.int64)
    f_edge = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, -1e-310, 2.2250738585072014e-308, 1e300,
                       0.5, 2.5, -2.5, 1e19, -1e19], dtype=np.float64)
    out = {}
    out["i"] = np.where(rng.random(N) < 0.3, rng.choice(edge_i, N),
                        np.where(rng.random(N) < 0.5, rng.integers(-10**6, 10**6, N),
                                 rng.integers(I64.min, I64.max, N, dtype=np.int64)))
    u = rng.integers(0, 1 << 63, N).astype(np.uint64) | (rng.integers(0, 2, N).astype(np.uint64) << np.uint64(63))
    u = np.where(rng.random(N) < 0.3, rng.integers(0, 100, N).astype(np.uint64), u)
    u[:2] = [np.uint64((1 << 64) - 1), np.uint64(1 << 63)]
    out["u"] = u
    out["f"] = np.where(rng.random(N) < 0.4, rng.choice(f_edge, N), np.round(rng.standard_normal(N) * 100, 3))
    out["d0"] = rng.integers(-10**12, 10**12, N)
    out["d2"] = rng.integers(-10**9, 10**9, N)
    out["d6"] = rng.integers(-10**12, 10**12, N)
    out["d12"] = rng.integers(-10**15, 10**15, N)
    out["dt"] = rng.integers(1992, 1999, N) * (13 * 32 * 24 * 3600 * 1_000_000) + rng.integers(0, 400, N)
    out["c"] = rng.integers(-1, 6, N).astype(np.int32)
    out["k"] = rng.integers(-3, 4, N)
    valid = {}
    for name, *_ in COLS:
        v = rng.random(N) < 0.85
        valid[name] = v
        out[name] = np.where(v, out[name], 0).astype(out[name].dtype)
    return out, valid


def _const(pkg, spec):
    E, V, F = pkg.E, pkg.V, pkg.F
    op, *a = spec
    if op == "null":
        return E.Constant(V.Datum.null(), F.ft_longlong())
    if op == "int":
        return E.Constant(V.Datum.i(a[0]), F.ft_longlong())
    if op == "uint":
        return E.Constant(V.Datum.u(a[0]), F.ft_longlong(unsigned=True))
    if op == "float":
        return E.Constant(V.Datum.f(a[0]), F.ft_double())
    if op == "dec":
        return E.Constant(V.Datum.d(pkg.dec(a[0])), F.ft_decimal(30, a[1]))
    raise ValueError(op)


def build(pkg, spec):
    """One package's expression for a spec tree."""
    op, *a = spec
    if op == "col":
        j = [c[0] for c in COLS].index(a[0])
        return pkg.E.Column(j, _ft(pkg, COLS[j][1], COLS[j][2]), a[0])
    if op in ("null", "int", "uint", "float", "dec"):
        return _const(pkg, spec)
    if op == "mulcap":  # a decimal product whose result scale was capped: _round_div
        return pkg.E.ScalarFunc(pkg.E.FUNCS["mul"], [build(pkg, a[0]), build(pkg, a[1])],
                                pkg.F.ft_decimal(30, a[2]))
    return pkg.E.make_func(op, *[build(pkg, x) for x in a])


BINARY = ["plus", "minus", "mul", "eq", "ne", "lt", "le", "gt", "ge", "nulleq", "and", "or"]
UNARY = ["unaryminus", "not", "isnull"]


def random_tree(rng, depth: int):
    if depth == 0 or rng.random() < 0.25:
        r = rng.random()
        if r < 0.65:
            return ("col", COLS[rng.integers(len(COLS))][0])
        k = rng.integers(6)
        if k == 0:
            return ("null",)
        if k == 1:
            return ("int", int(rng.choice([0, 1, -1, 3, 24, 10**6, I64.max, I64.min])))
        if k == 2:
            return ("uint", int(rng.choice([(1 << 63) + 5, (1 << 64) - 1, 1 << 63])))
        if k == 3:
            return ("float", float(rng.choice([0.5, -0.0, 1e-320, 2.5, 1e19, -3.75])))
        return ("dec", str(rng.choice(["0.05", "-12.34", "1.5", "100"])), int(rng.choice([0, 2, 4, 6])))
    r = rng.random()
    if r < 0.55:
        return (BINARY[rng.integers(len(BINARY))], random_tree(rng, depth - 1), random_tree(rng, depth - 1))
    if r < 0.75:
        return (UNARY[rng.integers(len(UNARY))], random_tree(rng, depth - 1))
    if r < 0.9:
        return ("in",) + tuple(random_tree(rng, depth - 1) for _ in range(rng.integers(2, 6)))
    pairs = [("d2", "d6", 4), ("d6", "d12", 6), ("d2", "d2", 2), ("d12", "d12", 12)]
    x, y, s = pairs[rng.integers(len(pairs))]
    return ("mulcap", ("col", x), ("col", y), s)


def _ref_lanes(data, valid):
    return {j: (jnp.asarray(data[name]), jnp.asarray(valid[name])) for j, (name, *_) in enumerate(COLS)}


def _port_lanes(data, valid):
    out = {}
    for j, (name, *_) in enumerate(COLS):
        d = data[name]
        t = torch.from_numpy(d.view(np.int64) if d.dtype == np.uint64 else d)
        out[j] = (U64(t) if d.dtype == np.uint64 else t, torch.from_numpy(valid[name]))
    return out


def _same_lane(want, got, kind, what):
    want = np.broadcast_to(np.asarray(want), (N,))
    want_kind = {"uint64": "u64", "int64": "i64", "float64": "f64", "int32": "i32", "bool": "i64"}[str(want.dtype)]
    assert kind == want_kind, f"{what}: kind {kind} vs {want_kind}"
    g = got.numpy()
    if kind == "f64":
        assert np.allclose(g, want, rtol=RTOL, atol=ATOL, equal_nan=True), f"{what}: {g} vs {want}"
        assert (np.isnan(g) == np.isnan(want)).all()
    else:
        w = want.view(np.int64) if kind == "u64" else want.astype(np.int64)
        assert np.array_equal(g.astype(np.int64), w), f"{what}: {g} vs {w}"


TREES_PER_CASE = 12


@pytest.mark.parametrize("case", range(25))
def test_random_trees_match_reference(case):
    """12 seeded trees per case: each tree's (data, valid) lanes, then a
    mask over three of them, against the reference."""
    rng = np.random.default_rng(1000 + case)
    data, valid = _lanes(case)
    rl, pl = _ref_lanes(data, valid), _port_lanes(data, valid)
    trees = [random_tree(rng, int(rng.integers(1, 5))) for _ in range(TREES_PER_CASE)]
    for t in trees:
        re, pe = build(REF, t), build(PORT, t)
        wd, wv = TPUEngine._eval_device(re, rl)
        _, [((gd,), gv, kind)] = evaluate(ProgramCache(), [], [ValueSpec(pe)], pl, None, N, mask=False)
        _same_lane(wd, gd, kind, f"data of {t}")
        assert np.array_equal(np.broadcast_to(np.asarray(wv), (N,)), gv.numpy()), f"valid of {t}"
    rv = rng.random(N) < 0.9
    conds = trees[:3]
    want = TPUEngine()._mask([build(REF, c) for c in conds], rl, jnp.asarray(rv))
    got, _ = evaluate(ProgramCache(), [build(PORT, c) for c in conds], [], pl, torch.from_numpy(rv), N)
    assert np.array_equal(np.broadcast_to(np.asarray(want), (N,)), got.numpy()), f"mask of {conds}"


# every builtin and lane kind at least once, by name
DIRECTED = {
    "subnormal_compare_is_zero": ("gt", ("col", "f"), ("float", 0.0)),
    "nan_is_true_in_and": ("and", ("col", "f"), ("col", "i")),
    "nan_ne": ("ne", ("col", "f"), ("col", "f")),
    "uint_vs_int_mixed": ("lt", ("col", "u"), ("col", "i")),
    "uint_vs_uint_literal": ("ge", ("col", "u"), ("uint", (1 << 63) + 5)),
    "uint_to_float": ("plus", ("col", "u"), ("float", 0.5)),
    "decimal_rescale": ("eq", ("col", "d2"), ("col", "d6")),
    "decimal_to_float": ("mul", ("col", "d12"), ("col", "f")),
    "decimal_product_capped": ("mulcap", ("col", "d6"), ("col", "d12"), 6),
    "decimal_product_at_int64_min": ("mulcap", ("int", I64.min), ("col", "d2"), 0),
    "int_wrap": ("mul", ("col", "i"), ("int", I64.max)),
    "negate_int64_min": ("unaryminus", ("col", "i")),
    "negate_float": ("unaryminus", ("col", "f")),
    "codes_in_with_absent": ("in", ("col", "c"), ("int", -1), ("int", 2), ("null",)),
    "in_float_domain": ("in", ("col", "f"), ("float", 2.5), ("col", "d2"), ("int", 0)),
    "in_int2": ("in", ("col", "i"), ("uint", (1 << 64) - 1), ("col", "u")),
    "nulleq_nulls": ("nulleq", ("col", "i"), ("null",)),
    "nulleq_float": ("nulleq", ("col", "f"), ("col", "d0")),
    "or_three_valued": ("or", ("isnull", ("col", "d0")), ("lt", ("col", "k"), ("int", 0))),
    "not_float": ("not", ("col", "f")),
    "date_vs_int": ("le", ("col", "dt"), ("col", "k")),
    "constants_only": ("eq", ("int", 1), ("int", 1)),
    "null_is_null": ("isnull", ("null",)),
}


@pytest.mark.parametrize("name", sorted(DIRECTED))
def test_directed_trees_match_reference(name):
    data, valid = _lanes(7)
    t = DIRECTED[name]
    re, pe = build(REF, t), build(PORT, t)
    wd, wv = TPUEngine._eval_device(re, _ref_lanes(data, valid))
    _, [((gd,), gv, kind)] = evaluate(ProgramCache(), [], [ValueSpec(pe)], _port_lanes(data, valid), None, N,
                                      mask=False)
    _same_lane(wd, gd, kind, name)
    assert np.array_equal(np.broadcast_to(np.asarray(wv), (N,)), gv.numpy())


def _chain(depth: int, cols):
    """plus(plus(...), col) nested `depth` deep, cycling through `cols`."""
    t = ("col", cols[0])
    for j in range(depth):
        t = ("plus", t, ("col", cols[(j + 1) % len(cols)])) if j % 2 else ("plus", ("col", cols[j % len(cols)]), t)
    return t


def test_deep_tree_runs_and_is_not_declined():
    """A 200-deep tree (both nestings) through the engine: no fallback,
    the reference's partials."""
    data, valid = _lanes(3)
    n = N
    table_cols = [("i", "bigint"), ("k", "bigint"), ("d2", "dec")]
    rt, pt = REF.table(table_cols), PORT.table(table_cols)
    d = {"i": data["i"] % 1000, "k": data["k"], "d2": data["d2"]}
    v = {c: valid[c] for c in d}
    rb = RefBatch(rt, np.arange(1, n + 1, dtype=np.int64), [d[c] for c, _ in table_cols],
                  [v[c] for c, _ in table_cols], version=0)
    deep = ("gt", _chain(200, ["i", "k", "d2"]), ("int", 0))
    spec = dict(conds=[deep], aggs=[("sum", _chain(60, ["k", "i"])), ("count",)])
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    want = ref.execute(REF.dag(rt, **spec), rb)
    got = port.execute(PORT.dag(pt, **spec), batch_from_numpy(pt, d, v))
    assert ref.fallbacks == port.fallbacks == 0
    _assert_same_chunk(want, got)


def test_wide_program_reloads_lanes_past_its_register_budget():
    """Every column held live needs more registers than a budget of 6; the
    program then reloads each lane at its use, needs fewer, and agrees."""
    data, valid = _lanes(5)
    cols = ["i", "k", "d0", "d2", "d6", "dt", "c"]

    def left_deep(names):
        t = ("col", names[0])
        for c in names[1:]:
            t = ("plus", t, ("col", c))
        return t

    # every lane read twice, far apart: held, all seven stay live in between
    t = ("and", ("gt", left_deep(cols), ("int", 0)),
         ("in", left_deep(cols[::-1]), ("col", "f"), ("col", "u"), ("int", 3)))
    pe = build(PORT, t)
    pl = _port_lanes(data, valid)
    kinds = {j: P.lane_kind(pl[j][0]) for j in range(len(COLS))}
    held = compile_program([], [ValueSpec(pe)], kinds, mask=False)
    reloaded = compile_program([], [ValueSpec(pe)], kinds, mask=False, max_regs=6)
    assert not held.reload and held.nregs > 6
    assert reloaded.reload and reloaded.nregs <= 6
    outs = [P.run(p, pl, None, N)[1][0] for p in (held, reloaded)]
    wd, wv = TPUEngine._eval_device(build(REF, t), _ref_lanes(data, valid))
    for (gd,), gv, kind in outs:
        _same_lane(wd, gd, kind, "wide tree")
        assert np.array_equal(np.asarray(wv), gv.numpy())


def test_ranks_at_once_share_one_program_and_one_table_pair():
    """A mesh's ranks compile and upload from their threads at once: each
    gets the program the cache keeps and the (ops, consts) pair it keeps,
    so no rank's pair can be freed before its launch reads it, and the
    shared program still agrees with the reference."""
    import threading

    data, valid = _lanes(7)
    pl = _port_lanes(data, valid)
    t = ("gt", ("plus", ("col", "i"), ("col", "k")), ("int", 0))
    pe = build(PORT, t)
    kinds = {j: P.lane_kind(pl[j][0]) for j in range(len(COLS))}
    cache, ranks = ProgramCache(), 8
    start = threading.Barrier(ranks)
    got: list = [None] * ranks

    def rank(r):
        start.wait()
        prog = cache.get([], [ValueSpec(pe)], kinds, False)
        got[r] = (prog, prog.tables(torch.device("cpu")))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(ranks)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert all(g[0] is got[0][0] and g[1] is got[0][1] for g in got)
    (gd,), gv, kind = P.run(got[0][0], pl, None, N)[1][0]
    wd, wv = TPUEngine._eval_device(build(REF, t), _ref_lanes(data, valid))
    _same_lane(wd, gd, kind, "shared program")
    assert np.array_equal(np.asarray(wv), gv.numpy())


@pytest.mark.parametrize("nseg", [1, 100])
@pytest.mark.parametrize("op", ["bit_and", "bit_or", "bit_xor"])
def test_bitwise_ops_match_reference_per_bit_partials(op, nseg):
    """K4's and_i64 / or_i64 / xor_i64 (plain version) against the
    reference's 64 per-bit segment reductions, empty segments included."""
    rng = np.random.default_rng(nseg)
    n = 3000
    x = np.where(rng.random(n) < 0.2, rng.choice(np.array([I64.min, I64.max, -1, 0], dtype=np.int64), n),
                 rng.integers(I64.min, I64.max, n, dtype=np.int64))
    ok = rng.random(n) < 0.8
    seg = np.where(rng.random(n) < 0.9, rng.integers(0, max(nseg - 3, 1), n), nseg)  # the last segments stay empty
    shifts = jnp.arange(64, dtype=jnp.int64)
    bits = ((jnp.asarray(x)[:, None] >> shifts[None, :]) & 1).astype(jnp.int32)
    import jax

    if op == "bit_and":
        red = jax.ops.segment_min(jnp.where(jnp.asarray(ok)[:, None], bits, 1), jnp.asarray(seg), num_segments=nseg + 1)
    elif op == "bit_or":
        red = jax.ops.segment_max(jnp.where(jnp.asarray(ok)[:, None], bits, 0), jnp.asarray(seg), num_segments=nseg + 1)
    else:
        red = jax.ops.segment_sum(jnp.where(jnp.asarray(ok)[:, None], bits, 0), jnp.asarray(seg),
                                  num_segments=nseg + 1) % 2
    want = np.asarray(((red[:nseg] & 1).astype(jnp.int64) << shifts[None, :]).sum(axis=1))
    k4op, fill = {"bit_and": ("and_i64", -1), "bit_or": ("or_i64", 0), "bit_xor": ("xor_i64", 0)}[op]
    mask = torch.from_numpy(seg < nseg)
    got, _ = seg_agg_ref(mask, [], [SegLane(k4op, torch.from_numpy(x), torch.from_numpy(ok), fill)], nseg,
                         seg=torch.from_numpy(np.minimum(seg, nseg).astype(np.int32)))
    assert np.array_equal(got[0].numpy(), want)


# --- engine parity over the TPC-H shapes ---------------------------------

_ENGINE_SPECS = {
    "q1": (TPCH_SPECS["q1"], None),
    "q6": (TPCH_SPECS["q6"], None),
    "tpch_topn": (dict(topn=[(COL("l_extendedprice"), True)]), 100),
    "multikey_topn": (dict(conds=[("lt", COL("l_quantity"), ("int", 40))],
                           topn=[(COL("l_extendedprice"), True), (COL("l_orderkey"), False),
                                 (COL("l_linenumber"), False)]), 50),
    "q18_inner": (dict(group_by=[COL("l_orderkey")], aggs=[("sum", COL("l_quantity"))]), None),
    "window_scan": (dict(), None),
}


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
@pytest.mark.parametrize("q", sorted(_ENGINE_SPECS))
def test_engine_routes_through_the_program_and_matches_reference(q, compress, monkeypatch):
    from tidb_tpu_torch.models import tpch

    n = 12_000
    data = tpch.gen_lineitem(n, seed=17)
    rt, pt = REF.table(LINEITEM_COLS), PORT.table(LINEITEM_COLS)
    rb = RefBatch(rt, np.arange(1, n + 1, dtype=np.int64), [data[c] for c, _ in LINEITEM_COLS],
                  [np.ones(n, dtype=bool)] * len(LINEITEM_COLS), version=0)
    spec, limit = _ENGINE_SPECS[q]
    rdag, pdag = REF.dag(rt, **spec), PORT.dag(pt, **spec)
    if limit is not None:
        rdag.topn.n = pdag.topn.n = limit
    calls = []
    real = P.kernel()
    monkeypatch.setattr(P, "kernel", lambda: lambda *a: calls.append(1) or real(*a))
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.tile_compression = port.tile_compression = compress
    want = ref.execute(rdag, rb)
    got = port.execute(pdag, batch_from_numpy(pt, data))
    assert ref.fallbacks == port.fallbacks == 0
    _assert_same_chunk(want, got)
    # a condition, a computed argument or the filter program: one program launch
    assert len(calls) == (0 if q in ("q18_inner", "tpch_topn") else 1)
