"""The port's statistics (tidb_tpu_torch/statistics/) against the
reference's, on the CPU.

* The same seeded numpy columns — ints with a heavy value, unsigned ints,
  decimals, dates, dictionary strings, doubles, and NULLs in several of
  them — go through both packages' `build_table_stats` over the same
  batches: the stats JSON (histogram buckets, CM sketch table, TopN,
  NDV, NULL counts) is equal, and so is `estimate_conds` for a set of
  conditions built the same way in both packages. Object lanes hash
  through Python's `hash`, so both run in this one process.
* The FM sketch: the same hashes give the same mask, set and wire form,
  and the same merge.
* `approx_count_distinct` through the port's host engine gives the
  reference host engine's partial chunk (the per-group FM sketches).
* `Storage.stats.analyze_table` over the port's store (its TileCache
  batches) gives the stats JSON that the reference's ANALYZE TABLE gives
  over the same rows; the stats survive a reload from the store.
"""

import copy
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

from tidb_tpu.models import tpch as r_tpch
from tidb_tpu.session import Session

import chip_smoke as cs
from tidb_tpu_torch.catalog.schema import TableInfo as PTableInfo
from tidb_tpu_torch.models import tpch
from tidb_tpu_torch.storage import Storage

from test_torch_engine import _assert_same_chunk

N = 6000
COLS = [("i", "bigint"), ("u", "ubig"), ("d", "dec2"), ("dt", "date"), ("s", "str"), ("f", "double"), ("n", "bigint")]
DATES = ["1992-01-01", "1993-06-30", "1995-03-15", "1996-12-31", "1998-08-02", "1995-03-16"]


class Pkg:
    """One package's constructors: table, batches, expressions."""

    def __init__(self, root: str):
        m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        m("expr.builtins")
        self.root = root
        self.E, self.A, self.F = m("expr.expression"), m("expr.aggregation"), m("mysqltypes.field_type")
        self.V, self.S, self.D = m("mysqltypes.datum"), m("catalog.schema"), m("copr.dag")
        self.T, self.ST = m("copr.tilecache"), m("statistics")
        self.DEC, self.CT = m("mysqltypes.mydecimal"), m("mysqltypes.coretime")
        self.H, self.FM = m("copr.host_engine"), m("statistics.fmsketch")
        self.SEL = m("statistics.selectivity")

    def ft(self, kind):
        F = self.F
        if kind == "dec2":
            return F.ft_decimal(12, 2)
        if kind == "date":
            return F.FieldType(F.TypeCode.Date)
        return {"bigint": F.ft_longlong, "ubig": lambda: F.ft_longlong(True), "double": F.ft_double,
                "str": lambda: F.ft_varchar(20)}[kind]()

    def table(self):
        return self.S.TableInfo(7, "st", [self.S.ColumnInfo(70 + i, n, self.ft(k), i) for i, (n, k) in enumerate(COLS)])

    def batches(self, table, data, valid, cuts):
        out, lo = [], 0
        for hi in cuts + [N]:
            out.append(self.T.ColumnBatch(table, np.arange(lo + 1, hi + 1, dtype=np.int64),
                                          [d[lo:hi] for d in data], [v[lo:hi] for v in valid], version=0))
            lo = hi
        return out

    def const(self, kind, v):
        V, F = self.V.Datum, self.F
        if kind == "int":
            return self.E.Constant(V.i(v), F.ft_longlong())
        if kind == "dec":
            d = self.DEC.dec_from_string(v)
            return self.E.Constant(V.d(d), F.ft_decimal(30, d.scale))
        if kind == "date":
            return self.E.Constant(V.t(self.CT.parse_datetime(v)), self.ft("date"))
        if kind == "str":
            return self.E.Constant(V.s(v), F.ft_varchar(len(v)))
        return self.E.Constant(V.f(v), F.ft_double())

    def cond(self, table, spec):
        op, col, *args = spec
        c = table.col_by_name(col)
        ref = self.E.Column(c.offset, c.ft, c.name)
        consts = [self.const(k, v) for k, v in args]
        if op == "isnull":
            return self.E.make_func("isnull", ref)
        if op.startswith("rev_"):
            return self.E.make_func(op[4:], consts[0], ref)
        return self.E.make_func(op, ref, *consts)


REF, PORT = Pkg("tidb_tpu"), Pkg("tidb_tpu_torch")


def columns(seed: int = 11):
    rng = np.random.default_rng(seed)
    from tidb_tpu_torch.mysqltypes.coretime import parse_datetime

    i = np.where(rng.random(N) < 0.3, 42, rng.integers(-500, 500, N)).astype(np.int64)
    u = rng.integers(0, 1 << 63, N, dtype=np.uint64) | np.uint64(1 << 63)
    d = rng.integers(-10_000, 100_000, N).astype(np.int64)
    dt = np.array([parse_datetime(DATES[k]) for k in rng.integers(0, len(DATES), N)], dtype=np.int64)
    vocab = np.array([f"w{k:02d}" for k in range(30)], dtype=object)
    s = vocab[np.minimum(rng.geometric(0.15, N) - 1, 29)]
    f = rng.normal(0, 100, N)
    n = rng.integers(0, 50, N).astype(np.int64)
    data = [i, u, d, dt, s, f, n]
    valid = [np.ones(N, bool), np.ones(N, bool), rng.random(N) > 0.05, np.ones(N, bool),
             rng.random(N) > 0.1, np.ones(N, bool), rng.random(N) > 0.6]
    return data, valid


CONDS = [
    ("eq", "i", ("int", 42)), ("eq", "i", ("int", 7)), ("lt", "i", ("int", 0)), ("ge", "i", ("int", 250)),
    ("in", "i", ("int", 42), ("int", 1), ("int", 2)), ("rev_lt", "i", ("int", 100)),
    ("gt", "u", ("int", 1 << 62)), ("le", "d", ("dec", "250.50")), ("eq", "d", ("dec", "12.34")),
    ("lt", "dt", ("date", "1995-03-15")), ("eq", "dt", ("date", "1996-12-31")), ("ge", "dt", ("str", "1995-03-15")),
    ("eq", "s", ("str", "w00")), ("in", "s", ("str", "w03"), ("str", "w29"), ("str", "zz")),
    ("lt", "s", ("str", "w10")), ("gt", "f", ("float", 12.5)), ("eq", "f", ("float", 0.0)), ("isnull", "n"),
    ("isnull", "i"), ("eq", "n", ("int", 3)),
    ("ne", "i", ("int", 42)),
]


@pytest.fixture(scope="module")
def stats():
    data, valid = columns()
    out = {}
    for pkg in (REF, PORT):
        t = pkg.table()
        out[pkg.root] = (t, pkg.ST.build_table_stats(t, pkg.batches(t, data, valid, [1000, 3500]), 7))
    return out


def test_table_stats_are_the_references(stats):
    (_, want), (_, got) = stats["tidb_tpu"], stats["tidb_tpu_torch"]
    assert got.to_json() == want.to_json()
    j = got.to_json()
    assert j["row_count"] == N and len(j["columns"]) == len(COLS)
    cols = {c: j["columns"][str(70 + k)] for k, (c, _) in enumerate(COLS)}
    assert cols["i"]["topn"] and cols["n"]["null_count"] > 0 and cols["s"]["ndv"] <= 30
    assert all(v["hist"] is not None for v in cols.values())
    assert json.loads(json.dumps(j)) == j
    assert PORT.ST.TableStats.from_json(j).to_json() == REF.ST.TableStats.from_json(j).to_json()


@pytest.mark.parametrize("k", range(len(CONDS)))
def test_selectivity_is_the_references(stats, k):
    (rt, want), (pt, got) = stats["tidb_tpu"], stats["tidb_tpu_torch"]
    rc, pc = REF.cond(rt, CONDS[k]), PORT.cond(pt, CONDS[k])
    assert repr(pc) == repr(rc)
    r_sel = REF.SEL.estimate_conds(want, [rc], rt.visible_columns())
    p_sel = PORT.SEL.estimate_conds(got, [pc], pt.visible_columns())
    assert p_sel == r_sel and 0.0 <= p_sel <= 1.0
    assert PORT.SEL.estimate_conds(None, [pc], pt.visible_columns()) == REF.SEL.estimate_conds(None, [rc], [])


def test_conjunctions_estimate_the_same(stats):
    (rt, want), (pt, got) = stats["tidb_tpu"], stats["tidb_tpu_torch"]
    for ks in ((0, 9), (2, 7, 12), (3, 16, 17, 19), tuple(range(len(CONDS)))):
        rc = [REF.cond(rt, CONDS[k]) for k in ks]
        pc = [PORT.cond(pt, CONDS[k]) for k in ks]
        assert PORT.SEL.estimate_conds(got, pc, pt.visible_columns()) == \
            REF.SEL.estimate_conds(want, rc, rt.visible_columns())


def test_fm_sketch_is_the_references():
    rng = np.random.default_rng(3)
    hs = [rng.integers(0, 1 << 63, n, dtype=np.uint64) for n in (50, 30_000, 12_000)]
    hs[2][:6000] = hs[1][:6000]
    r, p = [REF.FM.FMSketch(1000) for _ in hs], [PORT.FM.FMSketch(1000) for _ in hs]
    for a, b, h in zip(r, p, hs):
        a.insert_hashes(h)
        b.insert_hashes(h)
        assert (int(b.mask), b.hashset, b.ndv(), b.serialize()) == (int(a.mask), a.hashset, a.ndv(), a.serialize())
    r[1].merge(r[2])
    p[1].merge(p[2])
    assert p[1].serialize() == r[1].serialize() and p[1].ndv() == r[1].ndv()
    back = PORT.FM.FMSketch.deserialize(p[1].serialize(), 1000)
    assert back.ndv() == p[1].ndv()


@pytest.mark.parametrize("col", ["i", "s", "d", "f"])
def test_approx_count_distinct_through_the_host_engine_is_the_references(col):
    data, valid = columns(5)
    chunks = []
    for pkg in (REF, PORT):
        t = pkg.table()
        batch = pkg.batches(t, data, valid, [])[0]
        vis = t.visible_columns()
        scan = pkg.D.ScanNode(t.id, [c.offset for c in vis], [c.ft for c in vis], [c.id for c in vis])
        c = t.col_by_name(col)
        g = t.col_by_name("dt")
        agg = pkg.D.AggNode([pkg.E.Column(g.offset, g.ft, g.name)],
                            [pkg.A.AggDesc.make("approx_count_distinct", [pkg.E.Column(c.offset, c.ft, c.name)]),
                             pkg.A.AggDesc.make("count", [])])
        chunks.append(pkg.H.execute_dag_host(pkg.D.DAGRequest(scan=scan, agg=agg), batch))
    want, got = chunks
    _assert_same_chunk(want, got)
    sketches = [PORT.FM.FMSketch.deserialize(b) for b in got.columns[1].data]
    assert len(sketches) == len(DATES) and all(s.ndv() > 0 for s in sketches)


@pytest.fixture(scope="module")
def both_stores():
    """The reference Session and the port's store over the same lineitem,
    orders and customer rows (the port's TableInfos carried from the
    reference's DDL by JSON)."""
    ref = Session()
    for ddl in (r_tpch.LINEITEM_DDL, r_tpch.ORDERS_DDL, r_tpch.CUSTOMER_DDL):
        ref.execute(ddl)
    port = cs.StoreSession(Storage())
    for name in ("lineitem", "orders", "customer"):
        port.create_table(PTableInfo.from_json(ref.infoschema().table(ref.current_db, name).to_json()))
    for (name, cols), mine in zip(zip(("lineitem", "orders", "customer"), r_tpch.generated_columns(N, 42)),
                                  tpch.generated_columns(N, 42)):
        r_tpch.bulk_load(ref, name, cols)
        tpch.bulk_load(port, name, mine)
    return ref, port


def _without_version(j):
    j = copy.deepcopy(j)
    j.pop("version")
    return j


@pytest.mark.parametrize("name", ["lineitem", "orders", "customer"])
def test_analyze_over_the_ports_store_gives_the_references_stats(both_stores, name):
    ref, port = both_stores
    ref.execute(f"ANALYZE TABLE {name}")
    rinfo = ref.infoschema().table(ref.current_db, name)
    want = ref.store.stats.get(rinfo.id).to_json()
    pinfo = port.infoschema().table("test", name)
    got = port.store.stats.analyze_table(port, pinfo).to_json()
    assert pinfo.id == rinfo.id
    assert _without_version(got) == _without_version(want)
    cols = tpch.generated_columns(N, 42)[("lineitem", "orders", "customer").index(name)]
    assert got["row_count"] == len(next(iter(cols.values())))
    # persisted in the store: a fresh handle reads back what the
    # reference's reads back from its own store
    fresh, r_fresh = type(port.store.stats)(port.store), type(ref.store.stats)(ref.store)
    assert _without_version(fresh.get(pinfo.id).to_json()) == _without_version(r_fresh.get(rinfo.id).to_json())
    assert port.store.stats.get(pinfo.id) is port.store.stats.cache[pinfo.id]


def test_stats_handle_deltas_and_dump_are_the_references(both_stores):
    ref, port = both_stores
    pinfo = port.infoschema().table("test", "orders")
    h = port.store.stats
    if h.get(pinfo.id) is None:
        h.analyze_table(port, pinfo)
    gen = h.generation
    rows = h.get(pinfo.id).row_count
    h.report_delta(pinfo.id, 10, 4)
    assert h.generation == gen + 1 and h.get(pinfo.id).row_count == rows + 4
    assert not h.needs_analyze(pinfo.id)
    h.report_delta(pinfo.id, rows, 0)
    assert h.needs_analyze(pinfo.id)
    assert h.auto_analyze(port) == [pinfo.id] and h.get(pinfo.id).modify_count == 0
    d = h.dump(port, pinfo)
    assert d["table_name"] == "orders" and d["col_names"] == {str(c.id): c.name for c in pinfo.columns}
    assert SimpleNamespace(**d).stats == h.get(pinfo.id).to_json()
