"""The port's GPU cop engine against the reference TPUEngine, on the CPU.

The same numpy region data becomes a reference ColumnBatch and, through
`batch_from_numpy`, the port's; the same DAG is built once from each
package's own expression classes (one spec, built twice). The reference
runs it on `TPUEngine().execute` (JAX on the CPU), the port on
`TorchEngine(device="cpu").execute` (the plain versions of its kernels).
Partial chunks must agree column by column: ints, decimals, dates and
dict-coded strings bit for bit, floats within rtol 1e-9 / atol 1e-6;
decisions to decline (`fallbacks`) must agree too. Every case runs with
tile compression ON and OFF.
"""

import importlib

import numpy as np
import pytest

from tidb_tpu.copr.tilecache import ColumnBatch as RefBatch
from tidb_tpu.copr.tpu_engine import TPUEngine

from tidb_tpu_torch.copr.gpu_engine import TorchEngine
from tidb_tpu_torch.entry import batch_from_numpy

RTOL, ATOL = 1e-9, 1e-6


class Pkg:
    """One package's constructors, so a single spec builds both DAGs."""

    def __init__(self, root: str):
        m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        m("expr.builtins")  # populate the function registry
        self.E, self.A, self.D = m("expr.expression"), m("expr.aggregation"), m("copr.dag")
        self.F, self.V = m("mysqltypes.field_type"), m("mysqltypes.datum")
        self.S, self.dec = m("catalog.schema"), m("mysqltypes.mydecimal").dec_from_string
        self.parse_dt = m("mysqltypes.coretime").parse_datetime

    def ft(self, kind: str):
        F = self.F
        ft = {
            "bigint": lambda: F.ft_longlong(), "ubigint": lambda: F.ft_longlong(unsigned=True),
            "dec": lambda: F.ft_decimal(15, 2), "double": lambda: F.ft_double(),
            "str": lambda: F.ft_varchar(20), "date": lambda: F.FieldType(F.TypeCode.Date),
        }[kind.split(":")[0]]()
        if kind.startswith("str:"):
            ft.collate = kind.split(":")[1]
        return ft

    def table(self, cols):
        return self.S.TableInfo(7, "t", [self.S.ColumnInfo(10 + i, n, self.ft(k), i)
                                         for i, (n, k) in enumerate(cols)])

    def expr(self, spec, table):
        E, V = self.E, self.V
        op, *args = spec
        if op == "col":
            c = table.col_by_name(args[0])
            return E.Column(c.offset, c.ft, c.name)
        if op == "int":
            return E.Constant(V.Datum.i(args[0]), self.F.ft_longlong())
        if op == "dec":
            return E.Constant(V.Datum.d(self.dec(args[0])), self.F.ft_decimal(30, args[1]))
        if op == "float":
            return E.Constant(V.Datum.f(args[0]), self.F.ft_double())
        if op == "str":
            return E.Constant(V.Datum.s(args[0]), self.F.ft_varchar(20))
        if op == "date":
            return E.Constant(V.Datum.t(self.parse_dt(args[0])), self.ft("date"))
        return E.make_func(op, *[self.expr(a, table) for a in args])

    def dag(self, table, conds=(), group_by=None, aggs=None, topn=None):
        D = self.D
        scan = D.ScanNode(table.id, [c.offset for c in table.columns], [c.ft for c in table.columns],
                          [c.id for c in table.columns])
        sel = D.SelectionNode([self.expr(c, table) for c in conds]) if conds else None
        agg = None
        if aggs is not None:
            agg = D.AggNode([self.expr(g, table) for g in group_by or []],
                            [self.A.AggDesc.make(name, [self.expr(a, table) for a in args])
                             for name, *args in aggs])
        tn = D.TopNNode([(self.expr(e, table), desc) for e, desc in topn], 10) if topn else None
        return D.DAGRequest(scan=scan, selection=sel, agg=agg, topn=tn)


REF, PORT = Pkg("tidb_tpu"), Pkg("tidb_tpu_torch")

COLS = [("i", "bigint"), ("u", "ubigint"), ("d", "dec"), ("f", "double"), ("s", "str:utf8mb4_bin"),
        ("sci", "str:utf8mb4_general_ci"), ("dt", "date"), ("k", "bigint"), ("k2", "bigint")]


def _region(n: int, seed: int = 3):
    """Column lanes + NOT-NULL masks for the test table."""
    rng = np.random.default_rng(seed)
    words = np.array(["apple", "Banana", "cherry", "date", "Éclair", "fig"], dtype=object)
    data = {
        "i": rng.integers(-10**6, 10**6, n),
        "u": rng.integers(0, 1 << 63, n).astype(np.uint64) | (rng.integers(0, 2, n).astype(np.uint64) << np.uint64(63)),
        "d": rng.integers(-10**9, 10**9, n),
        "f": np.round(rng.standard_normal(n) * 100, 2),
        "s": rng.choice(words, n),
        "sci": rng.choice(np.array(["abc", "ABC", "Abd", "xyz", "XYZ"], dtype=object), n),
        "dt": (rng.integers(1992, 1999, n) * 13 * 32 + rng.integers(1, 13, n) * 32 + rng.integers(1, 29, n))
        * (24 * 3600 * 1_000_000),
        "k": rng.integers(5, 9, n),
        "k2": rng.integers(-2, 1, n),
    }
    valid = {name: rng.random(n) < 0.9 for name in ("i", "u", "d", "f", "s", "sci", "dt")}
    for name, v in valid.items():  # the storage layer zeroes NULL slots
        data[name] = np.where(v, data[name], None if data[name].dtype == object else 0).astype(data[name].dtype)
    return data, valid


def _batches(data, valid, ref_table, port_table):
    n = len(next(iter(data.values())))
    cols = [c.name for c in ref_table.columns]
    rb = RefBatch(ref_table, np.arange(1, n + 1, dtype=np.int64),
                  [data[c] for c in cols], [valid.get(c, np.ones(n, dtype=bool)) for c in cols], version=0)
    return rb, batch_from_numpy(port_table, data, valid)


def _assert_same_chunk(want, got):
    assert got.num_cols == want.num_cols
    assert got.num_rows == want.num_rows
    for j, (w, g) in enumerate(zip(want.columns, got.columns)):
        assert np.array_equal(w.valid, g.valid), f"column {j}: valid"
        wd, gd = np.where(w.valid, w.data, np.zeros((), w.data.dtype) if w.data.dtype != object else None), \
            np.where(g.valid, g.data, np.zeros((), g.data.dtype) if g.data.dtype != object else None)
        assert wd.dtype == gd.dtype, f"column {j}: dtype {wd.dtype} vs {gd.dtype}"
        if wd.dtype.kind == "f":
            assert np.allclose(wd, gd, rtol=RTOL, atol=ATOL, equal_nan=True), f"column {j}"
        else:
            assert wd.tolist() == gd.tolist(), f"column {j}"


def _run_both(spec: dict, compress: bool, n: int = 3000, mutate=None):
    data, valid = _region(n)
    if mutate is not None:
        mutate(data, valid)
    rt, pt = REF.table(COLS), PORT.table(COLS)
    rb, pb = _batches(data, valid, rt, pt)
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.tile_compression = port.tile_compression = compress
    want = ref.execute(REF.dag(rt, **spec), rb)
    got = port.execute(PORT.dag(pt, **spec), pb)
    return ref, port, want, got


COL = lambda n: ("col", n)  # noqa: E731

CASES = {
    "filter_only": dict(conds=[("gt", COL("i"), ("int", 5)), ("in", COL("s"), ("str", "apple"), ("str", "fig"))]),
    "count_star_no_groupby": dict(conds=[("le", COL("dt"), ("date", "1996-06-30"))], aggs=[("count",)]),
    "min_max_first_row": dict(
        conds=[("not", ("isnull", COL("f")))], group_by=[COL("k")],
        aggs=[("min", COL("i")), ("max", COL("i")), ("min", COL("u")), ("max", COL("u")), ("min", COL("d")),
              ("max", COL("f")), ("min", COL("dt")), ("min", COL("s")), ("max", COL("s")),
              ("first_row", COL("i")), ("first_row", COL("s")), ("count", COL("d"))]),
    "var_stddev": dict(
        group_by=[COL("k"), COL("k2")],
        aggs=[("var_pop", COL("d")), ("stddev_samp", COL("d")), ("var_samp", COL("f")),
              ("stddev_pop", COL("f")), ("avg", COL("f")), ("sum", COL("u"))]),
    "bit_ops": dict(
        conds=[("ge", COL("d"), ("dec", "-1000000.00", 2))], group_by=[COL("k")],
        aggs=[("bit_and", COL("i")), ("bit_or", COL("i")), ("bit_xor", COL("d")), ("bit_and", COL("f"))]),
    "dict_key_with_nulls": dict(
        conds=[("or", ("lt", COL("s"), ("str", "cherry")), ("isnull", COL("f")))], group_by=[COL("s"), COL("k")],
        aggs=[("sum", ("mul", COL("d"), ("minus", ("int", 1), COL("d")))), ("avg", COL("d")), ("count",)]),
    "arith_and_unsigned_compare": dict(
        conds=[("gt", COL("u"), ("int", 1 << 62)), ("ne", ("unaryminus", COL("i")), ("int", 3))],
        aggs=[("sum", ("plus", COL("i"), ("mul", COL("f"), ("float", 0.5)))), ("max", COL("u"))]),
}


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_partials_match_reference(case, compress):
    ref, port, want, got = _run_both(CASES[case], compress)
    assert ref.fallbacks == port.fallbacks == 0
    _assert_same_chunk(want, got)
    assert got.num_rows > 0


def test_multi_tile_batch_matches_reference():
    """A batch over one 64Ki tile: T = 2 with a padded last tile."""
    spec = dict(conds=[("gt", COL("d"), ("int", 0))], group_by=[COL("k")],
                aggs=[("sum", COL("d")), ("min", COL("i")), ("first_row", COL("dt"))])
    ref, port, want, got = _run_both(spec, True, n=70_000)
    _assert_same_chunk(want, got)


DECLINED = {
    # dict codes collapse a ci weight class batch-wide: min/max over a ci
    # string goes to the host on both sides
    "min_ci_string": dict(group_by=[COL("k")], aggs=[("min", COL("sci")), ("count",)]),
    "unsupported_aggregate": dict(group_by=[COL("k")], aggs=[("group_concat", COL("s"))]),
    "string_vs_column": dict(conds=[("eq", COL("s"), COL("sci"))]),
    "groupby_expression": dict(group_by=[("plus", COL("k"), ("int", 1))], aggs=[("count",)]),
    "topn_on_string_expression": dict(topn=[(("eq", COL("s"), COL("sci")), True)]),
}


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_declines_match_reference(case):
    ref, port, want, got = _run_both(DECLINED[case], True)
    assert ref.fallbacks == port.fallbacks == 1
    _assert_same_chunk(want, got)


TOPN_CASES = {
    # single key: lax.top_k order, NULLs last DESC / first ASC
    "int_desc": [(COL("i"), True)], "int_asc": [(COL("i"), False)],
    "decimal_desc": [(COL("d"), True)], "date_asc": [(COL("dt"), False)],
    "dict_string_desc": [(COL("s"), True)], "double_asc": [(COL("f"), False)],
    "double_desc": [(COL("f"), True)], "uint64_desc": [(COL("u"), True)], "uint64_asc": [(COL("u"), False)],
    "duplicate_keys_desc": [(COL("k"), True)], "duplicate_keys_asc": [(COL("k2"), False)],
    # multi key: the stable chain of sorts, ties by row
    "multi_dup_int_double": [(COL("k"), False), (COL("f"), True)],
    "multi_string_date_uint": [(COL("s"), True), (COL("dt"), False), (COL("u"), True)],
    "multi_dup_only": [(COL("k2"), True), (COL("k"), False)],
    "multi_decimal_ci_string": [(COL("d"), False), (COL("sci"), True)],
}


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
@pytest.mark.parametrize("case", sorted(TOPN_CASES))
def test_topn_partials_match_reference(case, compress):
    spec = dict(conds=[("ne", COL("k"), ("int", 6))], topn=TOPN_CASES[case])
    ref, port, want, got = _run_both(spec, compress)
    assert ref.fallbacks == port.fallbacks == 0
    _assert_same_chunk(want, got)
    assert got.num_rows == 10


@pytest.mark.parametrize("by", [[(COL("i"), True)], [(COL("k"), False), (COL("f"), True)]],
                         ids=["single_key", "multi_key"])
def test_topn_limit_zero_matches_reference(by):
    data, valid = _region(500)
    rt, pt = REF.table(COLS), PORT.table(COLS)
    rb, pb = _batches(data, valid, rt, pt)
    rdag, pdag = REF.dag(rt, topn=by), PORT.dag(pt, topn=by)
    rdag.topn.n = pdag.topn.n = 0
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    want, got = ref.execute(rdag, rb), port.execute(pdag, pb)
    assert ref.fallbacks == port.fallbacks == 0
    _assert_same_chunk(want, got)
    assert got.num_rows == 0


SORTED_AGG_CASES = {
    # NULL-able, float (with +-0.0), uint64, dict-string and multi-column
    # keys go through the sort path; every aggregate K4 supports
    "nullable_int_key": dict(group_by=[COL("i")], aggs=[("count",), ("sum", COL("d")), ("first_row", COL("s"))]),
    "double_key_signed_zero": dict(
        conds=[("lt", COL("i"), ("int", 500000))], group_by=[COL("f")],
        aggs=[("count",), ("avg", COL("d")), ("min", COL("u")), ("max", COL("dt"))]),
    "uint64_key": dict(group_by=[COL("u")], aggs=[("sum", COL("i")), ("max", COL("f")), ("first_row", COL("d"))]),
    "multi_column_key": dict(
        group_by=[COL("s"), COL("k"), COL("dt")],
        aggs=[("count", COL("i")), ("min", COL("s")), ("max", COL("s")), ("var_pop", COL("d")),
              ("stddev_samp", COL("f")), ("bit_and", COL("i")), ("bit_or", COL("k")), ("bit_xor", COL("d")),
              ("first_row", COL("f"))]),
    "all_rows_filtered": dict(conds=[("gt", COL("k"), ("int", 100))], group_by=[COL("i")], aggs=[("count",)]),
}


def _signed_zeros(data, valid):
    f = data["f"].copy()
    f[::5] = 0.0
    f[1::5] = -0.0
    f[2::97] = 5e-324  # a subnormal folds into the zero group, as XLA's flushed x == 0.0 makes it
    data["f"] = np.where(valid["f"], f, 0.0)


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
@pytest.mark.parametrize("case", sorted(SORTED_AGG_CASES))
def test_sorted_agg_partials_match_reference(case, compress):
    ref, port, want, got = _run_both(SORTED_AGG_CASES[case], compress, mutate=_signed_zeros)
    assert ref.fallbacks == port.fallbacks == 0
    _assert_same_chunk(want, got)
    assert got.num_rows > 0 or case == "all_rows_filtered"


@pytest.mark.parametrize("gcap0", [4, 64, 1 << 16])
def test_sorted_agg_capacity_escalation_matches_reference(gcap0):
    """A small initial capacity overflows on both engines; the escalated
    capacity (x4 steps, remembered per DAG shape) and the chunk match, and
    a second run starts at the remembered capacity."""
    spec = dict(group_by=[COL("i"), COL("k")], aggs=[("count",), ("sum", COL("d")), ("first_row", COL("dt"))])
    data, valid = _region(3000)
    rt, pt = REF.table(COLS), PORT.table(COLS)
    rb, pb = _batches(data, valid, rt, pt)
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.gcap0 = port.gcap0 = gcap0
    for _ in range(2):
        want = ref.execute(REF.dag(rt, **spec), rb)
        got = port.execute(PORT.dag(pt, **spec), pb)
        _assert_same_chunk(want, got)
        assert sorted(port._gcap.values()) == sorted(ref._gcap.values())
    ng = got.num_rows
    assert ng > 64
    assert bool(port._gcap) == (ng > gcap0)
    if port._gcap:
        (cap,) = port._gcap.values()
        assert cap >= ng and cap // 4 < ng


def test_function_outside_the_slice_raises_when_the_dag_is_built():
    """Every builtin of the reference is in the port (DIV included); a name
    neither registry holds raises the reference's error when the DAG is
    built."""
    pt, rt = PORT.table(COLS), REF.table(COLS)
    PORT.dag(pt, conds=[("div", COL("i"), ("int", 2))])
    for pkg, t in ((PORT, pt), (REF, rt)):
        with pytest.raises(ValueError, match="unknown function no_such_function"):
            pkg.dag(t, conds=[("no_such_function", COL("i"), ("int", 2))])


LINEITEM_COLS = [("l_orderkey", "bigint"), ("l_partkey", "bigint"), ("l_suppkey", "bigint"),
                 ("l_linenumber", "bigint"), ("l_quantity", "dec"), ("l_extendedprice", "dec"),
                 ("l_discount", "dec"), ("l_tax", "dec"), ("l_returnflag", "str:utf8mb4_bin"),
                 ("l_linestatus", "str:utf8mb4_bin"), ("l_shipdate", "date"), ("l_commitdate", "date"),
                 ("l_receiptdate", "date")]
_PRICE, _DISC = COL("l_extendedprice"), COL("l_discount")
_DISC_PRICE = ("mul", _PRICE, ("minus", ("int", 1), _DISC))
TPCH_SPECS = {
    "q1": dict(conds=[("le", COL("l_shipdate"), ("date", "1998-09-02"))],
               group_by=[COL("l_returnflag"), COL("l_linestatus")],
               aggs=[("sum", COL("l_quantity")), ("sum", _PRICE), ("sum", _DISC_PRICE),
                     ("sum", ("mul", _DISC_PRICE, ("plus", ("int", 1), COL("l_tax")))),
                     ("avg", COL("l_quantity")), ("avg", _PRICE), ("avg", _DISC), ("count",)]),
    "q6": dict(conds=[("ge", COL("l_shipdate"), ("date", "1994-01-01")),
                      ("lt", COL("l_shipdate"), ("date", "1995-01-01")),
                      ("ge", _DISC, ("dec", "0.05", 2)), ("le", _DISC, ("dec", "0.07", 2)),
                      ("lt", COL("l_quantity"), ("int", 24))],
               aggs=[("sum", ("mul", _PRICE, _DISC))]),
}


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
@pytest.mark.parametrize("q", ["q1", "q6"])
def test_tpch_partials_match_reference(q, compress):
    """Q1/Q6 over lineitem: the reference engine on the spec's DAG, the port
    on the DAG models/tpch.py makes, same rows."""
    from tidb_tpu_torch.models import tpch

    data = tpch.gen_lineitem(20_000, seed=11)
    rt = REF.table(LINEITEM_COLS)
    rb = RefBatch(rt, np.arange(1, 20_001, dtype=np.int64), [data[c] for c, _ in LINEITEM_COLS],
                  [np.ones(20_000, dtype=bool)] * len(LINEITEM_COLS), version=0)
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.tile_compression = port.tile_compression = compress
    want = ref.execute(REF.dag(rt, **TPCH_SPECS[q]), rb)
    dag = getattr(tpch, f"{q}_dag")()
    assert repr(dag.agg.aggs) == repr(PORT.dag(PORT.table(LINEITEM_COLS), **TPCH_SPECS[q]).agg.aggs)
    got = port.execute(dag, batch_from_numpy(tpch.LINEITEM, data))
    assert ref.fallbacks == port.fallbacks == 0
    _assert_same_chunk(want, got)


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
def test_q18_inner_takes_the_sort_path_and_matches_reference(compress):
    """Q18's GROUP BY l_orderkey over more than 65,536 key values: the sort
    path on both engines, escalating past gcap0 = 65,536 to the same
    capacity."""
    from tidb_tpu_torch.models import tpch

    n = 280_000  # l_orderkey spans n / 4 = 70,000 values
    data = tpch.gen_lineitem(n, seed=5)
    rt = REF.table(LINEITEM_COLS)
    rb = RefBatch(rt, np.arange(1, n + 1, dtype=np.int64), [data[c] for c, _ in LINEITEM_COLS],
                  [np.ones(n, dtype=bool)] * len(LINEITEM_COLS), version=0)
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.tile_compression = port.tile_compression = compress
    spec = dict(group_by=[COL("l_orderkey")], aggs=[("sum", COL("l_quantity"))])
    want = ref.execute(REF.dag(rt, **spec), rb)
    got = port.execute(tpch.q18_inner_dag(), batch_from_numpy(tpch.LINEITEM, data))
    assert ref.fallbacks == port.fallbacks == 0
    _assert_same_chunk(want, got)
    assert got.num_rows > 1 << 16
    assert list(port._gcap.values()) == list(ref._gcap.values()) == [1 << 18]


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
@pytest.mark.parametrize("x", [float("nan"), float("inf"), float("-inf"), 1e19, -1e19, 2.5],
                         ids=["nan", "inf", "-inf", "1e19", "-1e19", "2.5"])
def test_bitwise_aggregates_over_non_finite_and_huge_floats_match_reference(x, compress):
    """bit_or / bit_and / bit_xor over f = [x, 3.0]: the saturating rint
    (NaN → 0, ±inf and ±1e19 → INT64_MAX / INT64_MIN, half to even) XLA's
    conversion gives the reference."""
    cols = [("f", "double")]
    rt, pt = REF.table(cols), PORT.table(cols)
    data, valid = {"f": np.array([x, 3.0])}, {"f": np.ones(2, dtype=bool)}
    rb, pb = _batches(data, valid, rt, pt)
    spec = dict(aggs=[("bit_or", COL("f")), ("bit_and", COL("f")), ("bit_xor", COL("f"))])
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.tile_compression = port.tile_compression = compress
    want = ref.execute(REF.dag(rt, **spec), rb)
    got = port.execute(PORT.dag(pt, **spec), pb)
    assert ref.fallbacks == port.fallbacks == 0
    _assert_same_chunk(want, got)
