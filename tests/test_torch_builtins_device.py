"""Every device builtin of the port against the reference's jitted device
evaluation, on the CPU.

The reference runs a pushed tree by calling each builtin's kernel over
jax.numpy inside its jitted program (`TPUEngine._eval_device`); here the
same tree, built from each package's own classes, goes once through
`jax.jit` of `_eval_device` (lanes as arguments, constants as literals,
so XLA folds and rewrites as on the reference's device) and once through
the port's compiler and `expr_eval_ref`. One jitted reference program
runs the trees of a family. Integer, decimal, date and flag lanes must be
bit-identical, valid lanes equal, float lanes within rtol 1e-9 / atol
1e-6 (NaN where NaN), and each result's dtype the reference's.

The edge battery: NULLs, zero divisors, INT64_MIN and -1, ±0.0,
subnormals, NaN, ±inf, uint64 above 2^63, shift counts 63, 64, 65 and
-1, month ends, the zero date, negative durations, fracs from -3 to 4.

Also pinned here:
  * `lane_as_float` of a decimal is x * 10^-s, the reciprocal XLA's
    jitted program multiplies by (the port divided until this slice);
  * FLOOR(LOG2(x)) at x = 8 and FLOOR(LOG10(x)) at 1e15 over lanes, as
    the jitted reference computes log(x) * (1 / ln 2) and
    log(x) * 0.4342944819032518;
  * ROUND(decimal, 1), ROUND(int, -1) and TRUNCATE(decimal, 1), where the
    reference's jitted device raises (`_const_frac` calls int() on a
    traced constant): the port computes them, equal to the reference's
    kernel run eagerly and to its host kernel;
  * a cast to a string type and a host-only builtin raise
    DeviceFatalError in the port's compiler;
  * ~x and x << 62 on the host follow the reference's host kernels
    (int64 results), on the device its device (uint64 bits).
"""

import jax
import numpy as np
import pytest
import torch

from tidb_tpu.copr.tpu_engine import TPUEngine
from tidb_tpu.jaxenv import jnp

from tidb_tpu_torch.errors import DeviceFatalError
from tidb_tpu_torch.expr.program import ProgramCache, ValueSpec, compile_program, evaluate
from tidb_tpu_torch.expr.xp_torch import U64

from test_torch_engine import PORT, REF

RTOL, ATOL = 1e-9, 1e-6
N = 64
I64 = np.iinfo(np.int64)
US = 1_000_000

# name → (FieldType kind, decimal scale)
COLS = {"i": ("bigint", 0), "u": ("ubigint", 0), "f": ("double", 0), "d0": ("dec", 0), "d2": ("dec", 2),
        "d6": ("dec", 6), "d12": ("dec", 12), "dt": ("date", 0), "ts": ("datetime", 0), "tm": ("time", 0),
        "c": ("code", 0), "k": ("bigint", 0), "sh": ("bigint", 0), "p": ("double", 0), "fr": ("bigint", 0)}
NAMES = list(COLS)


def _ft(pkg, name):
    kind, scale = COLS[name]
    F = pkg.F
    if kind == "dec":
        return F.ft_decimal(30, scale)
    if kind in ("code", "bigint"):
        return F.ft_longlong()
    if kind == "datetime":
        return F.FieldType(F.TypeCode.Datetime)
    if kind == "time":
        return F.FieldType(F.TypeCode.Duration)
    return pkg.ft(kind)


def _pack(y, mo, d, h=0, mi=0, s=0, us=0):
    return ((((y * 13 + mo) * 32 + d) * 24 + h) * 60 + mi) * 60 * US + s * US + us


def _lanes(seed: int):
    """numpy (data, valid) per column, NULL slots zeroed as the storage does."""
    rng = np.random.default_rng(seed)
    f_edge = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, -5e-324, -1e-310,
                       2.2250738585072014e-308, 1e300, 0.5, -0.5, 2.5, -2.5, 1.5, 1e19, -1e19, 8.0, 1e15], np.float64)
    i_edge = np.array([I64.min, I64.max, -1, 0, 1, I64.min + 1, 7, -7, 25], np.int64)
    out = {
        "i": np.where(rng.random(N) < 0.4, rng.choice(i_edge, N), rng.integers(-10**6, 10**6, N)),
        "u": np.where(rng.random(N) < 0.5, rng.integers(0, 100, N).astype(np.uint64),
                      rng.integers(0, 1 << 63, N).astype(np.uint64) | np.uint64(1 << 63)),
        "f": np.where(rng.random(N) < 0.5, rng.choice(f_edge, N), np.round(rng.standard_normal(N) * 100, 3)),
        "d0": np.where(rng.random(N) < 0.2, rng.choice(i_edge, N), rng.integers(-10**12, 10**12, N)),
        "d2": np.where(rng.random(N) < 0.2, rng.choice(np.array([0, 5, -5, 15, -15, 25, 250, -250, 99, 100]), N),
                       rng.integers(-10**9, 10**9, N)),
        "d6": rng.integers(-10**12, 10**12, N),
        "d12": rng.integers(-10**15, 10**15, N),
        "dt": np.array([_pack(int(y), int(m), int(d)) for y, m, d in zip(
            rng.integers(1992, 2001, N), rng.integers(1, 13, N), rng.choice([1, 15, 28, 29, 30, 31], N))]),
        "ts": np.array([_pack(int(y), int(m), int(d), int(h), int(mi), int(s), int(us)) for y, m, d, h, mi, s, us in zip(
            rng.integers(1992, 2001, N), rng.integers(1, 13, N), rng.integers(1, 32, N), rng.integers(0, 24, N),
            rng.integers(0, 60, N), rng.integers(0, 60, N), rng.integers(0, US, N))]),
        "tm": rng.integers(-50 * 3600 * US, 50 * 3600 * US, N),
        "c": rng.integers(-1, 6, N).astype(np.int32),
        "k": rng.integers(-3, 4, N),
        "sh": rng.choice(np.array([0, 1, 3, 62, 63, 64, 65, -1, -64, 100]), N),
        "p": np.where(rng.random(N) < 0.3, rng.choice(np.array([8.0, 1e15, 1024.0, 1000.0, 1.0, 0.25, 0.0, -1.0]), N),
                      np.abs(rng.standard_normal(N)) * 1000),
        "fr": rng.integers(-3, 5, N),
    }
    out["dt"][:2] = [0, _pack(2000, 2, 29)]  # the zero date, a leap day
    out["d2"][:3] = [I64.min, I64.max, -1]
    valid = {}
    for name in NAMES:
        v = rng.random(N) < 0.85
        v[:3] = True
        valid[name] = v
        out[name] = np.where(v, out[name], 0).astype(out[name].dtype)
    return out, valid


def _ref_lanes(data, valid):
    return {j: (jnp.asarray(data[n]), jnp.asarray(valid[n])) for j, n in enumerate(NAMES)}


def _port_lanes(data, valid):
    out = {}
    for j, n in enumerate(NAMES):
        d = data[n]
        t = torch.from_numpy(d.view(np.int64) if d.dtype == np.uint64 else d)
        out[j] = (U64(t) if d.dtype == np.uint64 else t, torch.from_numpy(valid[n]))
    return out


def _const(pkg, op, a):
    E, V, F = pkg.E, pkg.V, pkg.F
    if op == "null":
        return E.Constant(V.Datum.null(), F.ft_longlong())
    if op == "int":
        return E.Constant(V.Datum.i(a[0]), F.ft_longlong())
    if op == "uint":
        return E.Constant(V.Datum.u(a[0]), F.ft_longlong(unsigned=True))
    if op == "float":
        return E.Constant(V.Datum.f(a[0]), F.ft_double())
    return E.Constant(V.Datum.d(pkg.dec(a[0])), F.ft_decimal(30, a[1]))


CAST_TARGETS = {"double": lambda F: F.ft_double(), "signed": lambda F: F.ft_longlong(),
                "unsigned": lambda F: F.ft_longlong(unsigned=True), "dec2": lambda F: F.ft_decimal(15, 2),
                "dec0": lambda F: F.ft_decimal(10, 0), "dec6": lambda F: F.ft_decimal(20, 6),
                "char": lambda F: F.ft_varchar(20), "date": lambda F: F.FieldType(F.TypeCode.Date)}


def build(pkg, spec):
    op, *a = spec
    if op == "col":
        return pkg.E.Column(NAMES.index(a[0]), _ft(pkg, a[0]), a[0])
    if op in ("null", "int", "uint", "float", "dec"):
        return _const(pkg, op, a)
    if op == "cast":
        return pkg.E.ScalarFunc(pkg.E.FUNCS["cast"], [build(pkg, a[1])], CAST_TARGETS[a[0]](pkg.F))
    return pkg.E.make_func(op, *[build(pkg, x) for x in a])


def C(name):
    return name if isinstance(name, tuple) else ("col", name)


def I(v):  # noqa: E743
    return ("int", v)


def FL(v):
    return ("float", v)


NUMS = ["i", "u", "f", "d0", "d2", "d6", "k", "c"]
FAMILIES = {
    "arith": [("div", C(x), C(y)) for x in ("i", "f", "d2", "d6", "u") for y in ("k", "d2", "f", "i")]
    + [("div", C("d2"), I(7)), ("div", C("f"), I(7)), ("div", C("f"), FL(0.0)), ("div", C("f"), ("null",)),
       ("div", C("f"), ("plus", I(3), I(4))), ("div", C("d2"), ("minus", C("k"), I(0))),
       ("div", C("i"), I(0)), ("div", C("d12"), C("d6"))]
    + [("intdiv", C(x), C(y)) for x in ("i", "u", "f", "d2", "k") for y in ("k", "i", "u", "f", "d2")]
    + [("intdiv", C("i"), I(-1)), ("intdiv", I(I64.min), I(-1)), ("intdiv", C("f"), FL(7.0)),
       ("intdiv", C("d2"), I(100)), ("intdiv", C("u"), ("uint", (1 << 63) + 5)), ("intdiv", C("i"), ("uint", 3))]
    + [("mod", C(x), C(y)) for x in ("i", "f", "d2", "d6", "k", "u") for y in ("k", "i", "d2", "f")]
    + [("mod", C("f"), FL(7.0)), ("mod", C("f"), I(0)), ("mod", I(I64.min), I(-1)), ("mod", C("i"), I(3)),
       ("mod", C("d2"), ("dec", "0.07", 2))],
    "control": [("if", C(c), C(a), C(b)) for c, a, b in (("k", "i", "f"), ("f", "d2", "d6"), ("i", "u", "u"),
                                                          ("d2", "dt", "ts"), ("k", "i", ("null",)), ("u", "d2", "i"))]
    + [("if", ("gt", C("i"), I(0)), C("d2"), ("null",)), ("if", C("c"), C("c"), C("k"))]
    + [("ifnull", C(a), C(b)) for a, b in (("i", "k"), ("f", "i"), ("d2", "d6"), ("u", "u"), (("null",), "d2"))]
    + [("coalesce", C("i"), C("d2"), C("f")), ("coalesce", C("k")), ("coalesce", ("null",), C("d6"), C("i")),
       ("coalesce", ("nullif", ("mod", C("k"), I(3)), I(0)), ("unaryminus", I(1)))]
    + [("case", ("gt", C("k"), I(0)), C("i"), ("lt", C("k"), I(0)), C("d2"), C("f")),
       ("case", C("k"), C("d2"), ("isnull", C("i")), C("d6")), ("case", C("f"), C("i")),
       ("case", ("ge", C("d2"), ("dec", "0.05", 2)), ("mul", C("d2"), ("minus", I(1), C("d2"))), C("d2"))]
    + [("nullif", C(a), C(b)) for a, b in (("i", "k"), ("f", "d2"), ("u", "i"), ("u", "u"), ("d2", "k"),
                                           ("c", "k"), ("k", ("null",)), ("f", "f"))]
    + [(op, C(a)) for op in ("istrue", "isfalse") for a in ("k", "f", "d2", "u")]
    + [("xor", C(a), C(b)) for a, b in (("k", "i"), ("f", "k"), ("d2", ("null",)), ("u", "f"))],
    "rounding": [("abs", C(a)) for a in NUMS]
    + [("sign", C(a)) for a in NUMS]
    + [(op, C(a)) for op in ("ceil", "ceiling", "floor") for a in ("i", "f", "d2", "d6", "d0", "u", "c")]
    + [("round", C(a)) for a in ("i", "f", "d2", "d6", "u")]
    + [("round", C("f"), I(fr)) for fr in (2, 1, 0, 4, -2)]
    + [("round", C(a), ("unaryminus", I(fr))) for a in ("f", "d2") for fr in (1, 2)]
    + [("round", C("f"), C("fr")), ("round", C("d2"), C("fr")), ("round", C("f"), ("null",)),
       ("round", ("mul", ("mul", C("d2"), FL(1.0)), ("minus", I(1), C("d2"))), I(2))]
    + [("truncate", C("f"), I(fr)) for fr in (2, 1, 0, 4, -2)]
    + [("truncate", C("f"), ("unaryminus", I(2))), ("truncate", C("f"), C("fr")),
       ("truncate", C("d6"), C("fr"))],
    "math": [(fn, C(a)) for fn in ("sqrt", "exp", "ln", "log", "log2", "log10", "sin", "cos", "tan", "asin",
                                   "acos", "atan", "cot", "degrees", "radians")
             for a in ("f", "p", "d2", "k")]
    + [(fn, C(a), C(b)) for fn in ("pow", "power", "atan2", "atan") for a, b in (("p", "f"), ("d2", "k"), ("f", "p"))]
    + [("pow", C("f"), I(e)) for e in (0, 1, 2, 3, -1, 4)] + [("pow", C("p"), FL(0.5)), ("pow", C("f"), ("null",)),
                                                           ("pow", C("d2"), I(2)), ("pow", C("p"), FL(-0.5))]
    + [("pi",), ("floor", ("log2", C("p"))), ("floor", ("log10", C("p"))), ("mul", ("pi",), C("f"))]
    + [(fn, C(a), C(b)) for fn in ("greatest", "least")
       for a, b in (("i", "k"), ("f", "d2"), ("u", "u"), ("u", "i"), ("d2", "d6"), ("dt", "ts"), ("f", "f"), ("i", "c"))]
    + [("greatest", C("i"), C("d2"), C("f")), ("least", C("k"), ("null",), C("i")),
       ("greatest", C("d2"), ("mul", C("d2"), I(100)))],
    "time": [(fn, C(a)) for fn in ("year", "month", "day", "dayofmonth", "hour", "minute", "second",
                                   "microsecond", "date", "time_to_sec") for a in ("dt", "ts", "tm")]
    + [("sec_to_time", C(a)) for a in ("i", "k", "f", "d2")],
    "bits": [(op, C(a), C(b)) for op in ("bitand", "bitor", "bitxor") for a, b in (("i", "k"), ("u", "i"), ("f", "d2"))]
    + [(op, C(a), C("sh")) for op in ("lshift", "rshift") for a in ("i", "u", "k", "f")]
    + [(op, C("i"), I(s)) for op in ("lshift", "rshift") for s in (63, 64, -1, 62)]
    + [("bitneg", C(a)) for a in ("i", "u", "k", "d2", "f")]
    + [("eq", ("bitand", C("k"), I(1)), I(1)), ("rshift", C("u"), I(3))],
    "cast": [("cast", t, C(a)) for t in ("double", "signed", "unsigned", "dec2", "dec0", "dec6", "date")
             for a in ("i", "u", "f", "d0", "d2", "d6", "dt")],
}


def _check(want, got, what):
    (wd, wv), ((gd,), gv, kind) = want, got
    wd = np.broadcast_to(np.asarray(wd), (N,))
    want_kind = {"uint64": "u64", "int64": "i64", "float64": "f64", "int32": "i32", "bool": "i64"}[str(wd.dtype)]
    assert kind == want_kind, f"{what}: kind {kind} vs {want_kind}"
    g = gd.numpy()
    if kind == "f64":
        gf = g.view(np.float64) if g.dtype == np.int64 else g
        close = np.isclose(gf, wd, rtol=RTOL, atol=ATOL, equal_nan=True) & (np.isnan(gf) == np.isnan(wd))
        bad = np.nonzero(~close)[0]
        assert not len(bad), f"{what}: rows {bad[:5]}: {gf[bad[:5]]} vs {wd[bad[:5]]}"
    else:
        w = wd.view(np.int64) if kind == "u64" else wd.astype(np.int64)
        bad = np.nonzero(g.astype(np.int64) != w)[0]
        assert not len(bad), f"{what}: rows {bad[:5]}: {g[bad[:5]]} vs {w[bad[:5]]}"
    assert np.array_equal(np.broadcast_to(np.asarray(wv), (N,)), gv.numpy()), f"{what}: valid"


def _ref_jit(specs):
    """One jitted reference program evaluating every tree of `specs`."""
    trees = [build(REF, s) for s in specs]
    return jax.jit(lambda lanes: [TPUEngine._eval_device(t, lanes) for t in trees])


def _port(spec, pl):
    _, vals = evaluate(ProgramCache(), [], [ValueSpec(build(PORT, spec))], pl, None, N, mask=False)
    return vals[0]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_device_functions_match_the_jitted_reference(family, seed):
    data, valid = _lanes(seed)
    specs = FAMILIES[family]
    want = _ref_jit(specs)(_ref_lanes(data, valid))
    pl = _port_lanes(data, valid)
    for spec, w in zip(specs, want):
        _check(w, _port(spec, pl), str(spec))


def test_every_device_builtin_is_in_the_battery():
    from tidb_tpu.expr.expression import FUNCS

    names = set()

    def walk(s):
        if s[0] not in ("col", "null", "int", "uint", "float", "dec"):
            names.add(s[0])
            for a in s[1:]:
                if isinstance(a, tuple):
                    walk(a)

    for specs in FAMILIES.values():
        for s in specs:
            walk(s)
    device = {n for n, f in FUNCS.items() if f.pushable}
    assert device - names <= {"plus", "minus", "mul", "unaryminus", "eq", "ne", "lt", "le", "gt", "ge", "nulleq",
                              "in", "and", "or", "not", "isnull"}, sorted(device - names)


# --- the reciprocal (lane_as_float of a decimal) --------------------------------


@pytest.mark.parametrize("scale", [2, 4, 6])
def test_lane_as_float_is_the_jitted_reciprocal_product(scale):
    """x / 10^s under jit is x * 10^-s: the port's FMULK must give the
    jitted reference's bits on every row (IEEE division, which the port
    computed before, differs on about one row in eight). A decimal times
    the double 1.0 (XLA drops the * 1.0) and a CAST AS DOUBLE."""
    rng = np.random.default_rng(scale)
    n = 4096
    d = rng.integers(-10**11, 10**11, n)
    v = np.ones(n, bool)
    assert ((d * (1.0 / 10 ** scale)).view(np.int64) != (d / 10.0 ** scale).view(np.int64)).any()

    def trees(pkg):
        col = pkg.E.Column(0, pkg.F.ft_decimal(15, scale), "x")
        one = pkg.E.Constant(pkg.V.Datum.f(1.0), pkg.F.ft_double())
        out = [pkg.E.make_func("mul", col, one)]
        if "cast" in pkg.E.FUNCS:
            out.append(pkg.E.ScalarFunc(pkg.E.FUNCS["cast"], [col], pkg.F.ft_double()))
        return out

    ref = trees(REF)
    want = jax.jit(lambda lanes: [TPUEngine._eval_device(t, lanes)[0] for t in ref])({0: (d, v)})
    lanes = {0: (torch.from_numpy(d), torch.from_numpy(v))}
    for e, w in zip(trees(PORT), want):
        _, [((got,), _, kind)] = evaluate(ProgramCache(), [], [ValueSpec(e)], lanes, None, n, mask=False)
        assert kind == "f64"
        assert np.array_equal(got.numpy().view(np.int64), np.asarray(w).view(np.int64))


def test_log2_and_log10_of_exact_powers_floor_as_the_jitted_reference():
    """The jitted reference computes LOG2 as log(x) * (1 / ln 2) and LOG10
    as log(x) * 0.4342944819032518: FLOOR(LOG2(8)) is 2 and
    FLOOR(LOG10(1e15)) is 14 on its device (log2(8) = 2.9999999999999996,
    log10(1e15) = 14.999999999999998), 3 and 15 on its host (numpy). The
    port's device path gives the device's answers; its host the host's."""
    from tidb_tpu.chunk.chunk import Chunk as RChunk, Column as RColumn
    from tidb_tpu_torch.chunk.chunk import Chunk as PChunk, Column as PColumn

    p = np.array([8.0, 1e15, 1024.0, 1000.0, 2.0 ** 40, 1e-3])
    ones = np.ones(len(p), bool)
    pl = {0: (torch.from_numpy(p), torch.from_numpy(ones))}
    for fn, dev_want, host_want in (("log2", 2.0, 3.0), ("log10", 14.0, 15.0)):
        r = REF.E.make_func("floor", REF.E.make_func(fn, REF.E.Column(0, REF.F.ft_double())))
        want = np.asarray(jax.jit(lambda lanes: TPUEngine._eval_device(r, lanes)[0])({0: (p, ones)}))
        e = PORT.E.make_func("floor", PORT.E.make_func(fn, PORT.E.Column(0, PORT.F.ft_double())))
        _, [((got,), _, _)] = evaluate(ProgramCache(), [], [ValueSpec(e)], pl, None, len(p), mask=False)
        got = got.numpy().view(np.float64)
        assert np.array_equal(got, want)
        at = 0 if fn == "log2" else 1
        assert got[at] == want[at] == dev_want
        host_ref = r.eval(RChunk([RColumn(REF.F.ft_double(), p, ones)]))[0]
        host_port = e.eval(PChunk([PColumn(PORT.F.ft_double(), p, ones)]))[0]
        assert host_ref[at] == host_port[at] == host_want


# --- where the reference's jitted device raises ---------------------------------

RAISING = {"round_dec_1": ("round", C("d2"), I(1)), "round_int_minus_1": ("round", C("i"), I(-1)),
           "truncate_dec_1": ("truncate", C("d6"), I(1))}


@pytest.mark.parametrize("name", sorted(RAISING))
def test_the_references_device_raises_where_the_port_computes(name):
    data, valid = _lanes(3)
    spec = RAISING[name]
    tree = build(REF, spec)
    with pytest.raises(Exception, match="(?i)concret|tracer"):
        jax.jit(lambda lanes: TPUEngine._eval_device(tree, lanes))(_ref_lanes(data, valid))
    eager = TPUEngine._eval_device(tree, _ref_lanes(data, valid))
    got = _port(spec, _port_lanes(data, valid))
    _check(eager, got, name)
    # and the reference's host kernel over numpy
    from tidb_tpu.chunk.chunk import Chunk as RChunk, Column as RColumn

    cols = [RColumn(_ft(REF, n), data[n], valid[n]) for n in NAMES]
    hd, hv = tree.eval(RChunk(cols))
    assert np.array_equal(np.asarray(hd).astype(np.int64)[hv], got[0][0].numpy()[hv])


def test_a_cast_to_a_string_and_a_host_only_builtin_raise_device_fatal():
    for spec in (("cast", "char", C("i")), ("concat", C("i"), C("k")), ("length", C("i"))):
        e = build(PORT, spec)
        with pytest.raises(DeviceFatalError):
            compile_program([], [ValueSpec(e)], {j: "i64" for j in range(len(NAMES))}, mask=False)


def test_bitneg_and_shift_host_follow_the_host_device_the_device():
    """~x and x << 62: the reference's host kernels give int64 (-2 for
    ~1), its device the same bits, which an unsigned result type reads as
    18446744073709551614; the port's host and device give the same bits
    as the reference's host and device."""
    data, valid = _lanes(4)
    pl = _port_lanes(data, valid)
    from tidb_tpu.chunk.chunk import Chunk as RChunk, Column as RColumn
    from tidb_tpu_torch.chunk.chunk import Chunk as PChunk, Column as PColumn

    for spec in (("bitneg", C("k")), ("lshift", C("k"), I(62)), ("lshift", C("i"), I(62))):
        rtree, ptree = build(REF, spec), build(PORT, spec)
        want_dev = jax.jit(lambda lanes: TPUEngine._eval_device(rtree, lanes))(_ref_lanes(data, valid))
        _check(want_dev, _port(spec, pl), str(spec))
        rc = RChunk([RColumn(_ft(REF, n), data[n], valid[n]) for n in NAMES])
        pc = PChunk([PColumn(_ft(PORT, n), data[n], valid[n]) for n in NAMES])
        try:
            wd, wv = rtree.eval(rc)
        except OverflowError as e:  # the reference's host raises on x << 62 past int64
            with pytest.raises(type(e)):
                ptree.eval(pc)
            continue
        gd, gv = ptree.eval(pc)
        assert np.array_equal(np.asarray(wv), np.asarray(gv))
        assert np.array_equal(np.asarray(wd)[wv], np.asarray(gd)[gv])
    assert rtree.ret_type.is_unsigned and ptree.ret_type.is_unsigned


def _fma_lanes():
    """Five double lanes, a DECIMAL(30,2) lane and a BIGINT lane (10%
    NULL, zeroed as the storage does)."""
    rng = np.random.default_rng(11)
    n = 4096
    data = [rng.standard_normal(n) * 100 for _ in range(5)]
    data += [rng.integers(-10**9, 10**9, n), rng.integers(-10**6, 10**6, n)]
    valid = [rng.random(n) >= 0.1 for _ in data]
    return [np.where(v, x, 0).astype(x.dtype) for x, v in zip(data, valid)], valid


def _fma_tree(pkg, spec):
    op, *a = spec
    if op == "f":
        return pkg.E.Column(a[0], pkg.F.ft_double())
    if op == "dec":
        return pkg.E.Column(5, pkg.F.ft_decimal(30, 2))
    if op == "int":
        return pkg.E.Column(6, pkg.F.ft_longlong())
    if op == "k":
        return pkg.E.Constant(pkg.V.Datum.f(a[0]), pkg.F.ft_double())
    return pkg.E.make_func(op, *[_fma_tree(pkg, x) for x in a])


def _fma_run(specs):
    """[(want, got)] of (data, valid) per tree of one program: the jitted
    reference's and the port's (compiler + expr_eval_ref)."""
    data, valid = _fma_lanes()
    rtrees = [_fma_tree(REF, sp) for sp in specs]
    want = jax.jit(lambda lanes: [TPUEngine._eval_device(t, lanes) for t in rtrees])(
        {j: (x, v) for j, (x, v) in enumerate(zip(data, valid))})
    lanes = {j: (torch.from_numpy(x), torch.from_numpy(v)) for j, (x, v) in enumerate(zip(data, valid))}
    _, outs = evaluate(ProgramCache(), [], [ValueSpec(_fma_tree(PORT, sp)) for sp in specs], lanes, None,
                       len(data[0]), mask=False)
    return [((np.asarray(wd).view(np.int64), np.asarray(wv)), (g[0][0].numpy().view(np.int64), g[1].numpy()))
            for (wd, wv), g in zip(want, outs)]


def _P(i, j):
    return ("mul", ("f", i), ("f", j))


_A, _B, _C, _D, _E = (("f", j) for j in range(5))
# every shape the contraction probe pinned down as a rule of the tree: an
# add or subtract of a float product with no other use in its tree is one
# fused multiply-add — a product of lanes, by a literal, a division by a
# constant, pow(x, 2), a decimal or an integer read as a float, a negated
# product, nested under further adds, inside a function or a branch; the
# left product's where both operands are products; no contraction where
# the product is used twice in the tree; each tree of a program alone
FMA_SHAPES = {
    "a+b*c": [("plus", _A, _P(1, 2))], "b*c+a": [("plus", _P(1, 2), _A)],
    "b*c-a": [("minus", _P(1, 2), _A)], "a-b*c": [("minus", _A, _P(1, 2))],
    "a*b+c*d": [("plus", _P(0, 1), _P(2, 3))], "a*b-c*d": [("minus", _P(0, 1), _P(2, 3))],
    "c*d+a*b": [("plus", _P(2, 3), _P(0, 1))], "(a+b*c)+d": [("plus", ("plus", _A, _P(1, 2)), _D)],
    "d+(a+b*c)": [("plus", _D, ("plus", _A, _P(1, 2)))],
    "a+b*(c+d*e)": [("plus", _A, ("mul", _B, ("plus", _C, _P(3, 4))))],
    "(a*b)*c+d": [("plus", ("mul", _P(0, 1), _C), _D)], "a-b*c-d": [("minus", ("minus", _A, _P(1, 2)), _D)],
    "(a+b)*c+d": [("plus", ("mul", ("plus", _A, _B), _C), _D)],
    "a+b*2.5": [("plus", _A, ("mul", _B, ("k", 2.5)))], "a+b/7": [("plus", _A, ("div", _B, ("k", 7.0)))],
    "(b*c)/7+a": [("plus", ("div", _P(1, 2), ("k", 7.0)), _A)], "1.5+b*c": [("plus", ("k", 1.5), _P(1, 2))],
    "pow(b,2)+a": [("plus", ("pow", _B, ("k", 2.0)), _A)],
    "a+-(b*c)": [("plus", _A, ("unaryminus", _P(1, 2)))], "-(b*c)+a": [("plus", ("unaryminus", _P(1, 2)), _A)],
    "a-(-(b*c))": [("minus", _A, ("unaryminus", _P(1, 2)))], "-(b*c)-a": [("minus", ("unaryminus", _P(1, 2)), _A)],
    "dec+b*c": [("plus", ("dec",), _P(1, 2))], "dec-b*c": [("minus", ("dec",), _P(1, 2))],
    "a+dec": [("plus", _A, ("dec",))], "dec-a": [("minus", ("dec",), _A)],
    "dec*b+c": [("plus", ("mul", ("dec",), _B), _C)], "int+b*c": [("plus", ("int",), _P(1, 2))],
    "int*b+c": [("plus", ("mul", ("int",), _B), _C)], "int*b+dec": [("plus", ("mul", ("int",), _B), ("dec",))],
    "floor(b*c+a)": [("floor", ("plus", _P(1, 2), _A))], "abs(a-b*c)": [("abs", ("minus", _A, _P(1, 2)))],
    "if(a>0,b*c+d,e)": [("if", ("gt", _A, ("k", 0.0)), ("plus", _P(1, 2), _D), _E)],
    "a+b*c>0": [("gt", ("plus", _A, _P(1, 2)), ("k", 0.0))],
    "(a*b+c*d)+e*c": [("plus", ("plus", _P(0, 1), _P(2, 3)), _P(4, 2))],
    "a*b+(c*d+e*a)": [("plus", _P(0, 1), ("plus", _P(2, 3), _P(4, 0)))],
    "(a*b-c*d)+e*a": [("plus", ("minus", _P(0, 1), _P(2, 3)), _P(4, 0))],
    "twice: b*c+(a+b*c)": [("plus", _P(1, 2), ("plus", _A, _P(1, 2)))],
    "twice: (a+b*c)*(b*c)": [("mul", ("plus", _A, _P(1, 2)), _P(1, 2))],
    "a*(b*c)+b*c": [("plus", ("mul", _A, _P(1, 2)), _P(1, 2))],
    "two trees: a+b*c, d+b*c": [("plus", _A, _P(1, 2)), ("plus", _D, _P(1, 2))],
}
# the shapes where XLA's choice is not a rule of the tree (ROADMAP Queue
# 3): two products added where the left one's factor is read again later
# in the tree, a float product plus a decimal read as a float, and a
# product one tree of the program stores bare — XLA contracts the other
# product, or none
FMA_DEPARTURES = {
    "(a*b+c*d)+e*a": ([("plus", ("plus", _P(0, 1), _P(2, 3)), _P(4, 0))], 0),
    "((a*b+c*d)*e)+a": ([("plus", ("mul", ("plus", _P(0, 1), _P(2, 3)), _E), _A)], 0),
    "b*c+dec": ([("plus", _P(1, 2), ("dec",))], 0),
    "two trees: a+b*c, b*c": ([("plus", _A, _P(1, 2)), _P(1, 2)], 0),
}


@pytest.mark.parametrize("shape", list(FMA_SHAPES))
def test_a_float_product_plus_a_float_is_one_fused_multiply_add_as_jit_contracts_it(shape):
    """XLA's CPU contracts a + b * c into one fused multiply-add under
    jit where the product has no other use; the port's compiler emits
    FFMA there (expr/program.py `Emitter.fused`) and rounds once: every
    pinned shape's data lanes bit-identical to the jitted reference's
    where valid, its valid lanes equal."""
    for (wd, wv), (gd, gv) in _fma_run(FMA_SHAPES[shape]):
        assert np.array_equal(wv, gv)
        assert np.array_equal(wd[wv], gd[gv])


@pytest.mark.parametrize("shape", list(FMA_DEPARTURES))
def test_the_contractions_xla_decides_past_the_tree_differ_in_the_last_bits(shape):
    """A departure (ROADMAP Queue 3): on these shapes XLA's choice of the
    product to contract depends on more than the tree's shape; the port
    contracts the left one (or the one it stores), so the two differ in
    the last bits of some rows and agree within rtol 1e-9."""
    specs, at = FMA_DEPARTURES[shape]
    (wd, wv), (gd, gv) = _fma_run(specs)[at]
    assert np.array_equal(wv, gv)
    assert (wd[wv] != gd[gv]).any()
    assert np.allclose(gd[gv].view(np.float64), wd[wv].view(np.float64), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("build", ["q1_dag", "q6_dag", "checksum_dag", "fn_mix_dag", "fn_math_dag"])
def test_the_main_paths_programs_hold_no_float_product_sum(build):
    """TPC-H Q1's, Q6's and the checksum's programs hold no FFMA (their
    sums are decimal) and keep the base instantiation; FN_MIX's and
    FN_MATH's floats add no product either (a product is rounded, then
    ROUNDed, SUMmed or multiplied), so their device floats are the ones
    chip_smoke.py has held to the plain version all along."""
    from tidb_tpu_torch.expr.program import OP, compile_program
    from tidb_tpu_torch.models import tpch

    dag = getattr(tpch, build)()
    conds = dag.selection.conds if dag.selection is not None else []
    values = [ValueSpec(a) for agg in dag.agg.aggs for a in agg.args]
    prog = compile_program(conds, values, {c: "i64" for c in range(16)})
    assert OP["FFMA"] not in set(prog.ops[:, 0].tolist())
    assert prog.ext == build.startswith("fn_")
