"""The port's planner (parser → PlanBuilder → optimize → slice_plan) against
the reference's, on the CPU.

Two catalogs, each in the reference Session and in the port's store (the
port's TableInfos carried from the reference's DDL by JSON, the same rows
in both): the schema of tests/test_plan_golden.py, and TPC-H lineitem,
orders and customer at 20,000 lineitem rows (models/tpch.setup_tpch's
generator). Then:

  * every golden `QUERIES` entry and every TPC-H SQL constant is planned
    by the reference's `Session.plan_select` and the port's
    `entry.plan_select`, without ANALYZE and again after ANALYZE on both
    sides; the optimized trees are equal node by node — node types,
    out_cols (name, field type, table offset), conditions by repr, the
    access path, index, key ranges as bytes, point handles, pruned
    partitions, the join order — and so are the `REORDER_STATS` moves;
  * `entry.mpp_plan` of each MPP query equals what the reference's
    executor builder runs (`slice_plan` with the fused TopN attached) and
    the hand-built plan of models/tpch.py, root step included;
  * `run_mpp` of each planned plan on the CPU gives the reference
    Session's rows (its host join): Q3, Q10, Q18, Q3_TOP100, SEG_REVENUE
    and SCALAR_REVENUE (442517679.5435), and Q3 with fusion OFF;
  * every hand-built cop DAG of models/tpch.py is what the port's planner
    pushes for its SQL (conditions, group keys, aggregates, TopN keys and
    count), and the port declines what the reference declines.
"""

import copy
import dataclasses

import numpy as np
import pytest

from tidb_tpu.executor.executors import _mpp_topn_spec as r_topn_spec
from tidb_tpu.models import tpch as r_tpch
from tidb_tpu.parser import ast as r_ast, parse_one as r_parse_one
from tidb_tpu.planner import optimizer as r_optimizer
from tidb_tpu.planner.fragment import slice_plan as r_slice_plan
from tidb_tpu.planner.plans import Aggregation as RAggregation, Join as RJoin, Limit as RLimit, Sort as RSort
from tidb_tpu.session import Session

import chip_smoke as cs
from tidb_tpu_torch import entry
from tidb_tpu_torch.catalog.schema import TableInfo as PTableInfo
from tidb_tpu_torch.errors import NotPortedError
from tidb_tpu_torch.models import tpch
from tidb_tpu_torch.mysqltypes.datum import Datum as PDatum
from tidb_tpu_torch.mysqltypes.field_type import FieldType as PFieldType, TypeCode as PTypeCode
from tidb_tpu_torch.mysqltypes.mydecimal import dec_from_string
from tidb_tpu_torch.parallel.mpp import MPPEngine
from tidb_tpu_torch.planner import optimizer as p_optimizer
from tidb_tpu_torch.storage import Storage

import test_plan_golden

N = 20_000
TPCH_TABLES = ("lineitem", "orders", "customer")
# every SELECT of models/tpch.py over the three tables (the pt queries read
# the launch batcher's table, which is not in this catalog)
TPCH_SQL = {name: getattr(tpch, name) for name in
            ("Q1", "Q6", "TOPN", "MULTIKEY_TOPN", "Q18_INNER", "Q3", "Q10", "Q3_TOP100", "SEG_REVENUE", "CHECKSUM",
             "FN_MIX", "FN_MATH", "SCALAR_REVENUE", "Q18", "WINDOW_SUM_PARTITION", "WINDOW_RANK_FRAMES")}
MPP = {"q3": ("Q3", "q3_mpp_plan", ()), "q10": ("Q10", "q10_mpp_plan", ()), "q18": ("Q18", "q18_mpp_plan", ()),
       "q3_top100": ("Q3_TOP100", "q3_mpp_plan", (100,)), "seg_revenue": ("SEG_REVENUE", "seg_revenue_mpp_plan", ()),
       "scalar_revenue": ("SCALAR_REVENUE", "scalar_revenue_mpp_plan", ())}
DAGS = {"Q1": "q1_dag", "Q6": "q6_dag", "TOPN": "topn_dag", "MULTIKEY_TOPN": "multikey_topn_dag",
        "Q18_INNER": "q18_inner_dag", "CHECKSUM": "checksum_dag", "FN_MIX": "fn_mix_dag", "FN_MATH": "fn_math_dag"}


# --- describing a plan --------------------------------------------------------


def norm(v):
    """A package-free value: expressions and descriptors by repr, tables and
    indexes by name, dataclasses by their fields."""
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted(norm(x) for x in v)
    if isinstance(v, dict):
        return sorted((repr(k), norm(x)) for k, x in v.items())
    if v is None or isinstance(v, (str, int, float, bool, bytes)):
        return v
    name = type(v).__name__
    if name in ("TableInfo", "IndexInfo", "PartitionDef"):
        return (name, v.name)
    if dataclasses.is_dataclass(v) and name not in ("Column", "Constant", "ScalarFunc", "FieldType"):
        return (name, [(f.name, norm(getattr(v, f.name))) for f in dataclasses.fields(v)])
    return (name, repr(v))


# `_uncacheable` is the Session's plan-cache mark, not the planner's
SKIP = {"children", "out_cols", "storage", "provider", "_uncacheable"}


def plan_desc(node):
    attrs = sorted((k, norm(v)) for k, v in vars(node).items() if k not in SKIP)
    cols = [(c.name, repr(c.ft), c.orig_offset, c.table_alias) for c in node.out_cols]
    return (type(node).__name__, node.describe(), cols, attrs, [plan_desc(c) for c in node.children])


# --- the two catalogs -----------------------------------------------------------


def subquery_hook(ref_sess, ref_ast):
    """A run_subquery hook for the port's builder: the subquery's AST
    carried into the reference's classes, run by the reference Session,
    its rows and types carried back."""

    def to_ref(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            cls = getattr(ref_ast, type(x).__name__)
            return cls(**{f.name: to_ref(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, list):
            return [to_ref(v) for v in x]
        if isinstance(x, tuple):
            return tuple(to_ref(v) for v in x)
        if type(x).__name__ == "Dec":
            from tidb_tpu.mysqltypes.mydecimal import dec_from_string as r_dec

            return r_dec(str(x))
        return x

    def to_port_datum(d):
        val = dec_from_string(str(d.val)) if type(d.val).__name__ == "Dec" else d.val
        return PDatum(d.kind, val)

    def run(select):
        rows, fts = ref_sess._run_subquery(to_ref(select))
        pfts = [PFieldType(**{f.name: getattr(ft, f.name) for f in dataclasses.fields(ft)}) for ft in fts]
        for ft in pfts:
            ft.tp = PTypeCode(int(ft.tp))
        return [[to_port_datum(d) for d in r] for r in rows], pfts

    return run


class Both:
    """A reference Session and the port's StoreSession over one catalog."""

    def __init__(self, ddls, loads):
        self.ref = Session()
        self.ref.vars["tidb_enable_cop_result_cache"] = "OFF"
        self.port = cs.StoreSession(Storage())
        for ddl in ddls:
            self.ref.execute(ddl)
            name = r_parse_one(ddl).table.name
            info = self.ref.infoschema().table(self.ref.current_db, name)
            self.port.create_table(PTableInfo.from_json(info.to_json()))
        for name, ref_cols, port_cols in loads:
            r_tpch.bulk_load(self.ref, name, ref_cols)
            tpch.bulk_load(self.port, name, port_cols)
        self.hook = subquery_hook(self.ref, r_ast)

    def analyze(self, names):
        for name in names:
            self.ref.execute(f"ANALYZE TABLE {name}")
            self.port.store.stats.analyze_table(self.port, self.port.infoschema().table("test", name))

    def plan_both(self, sql):
        """(reference plan, port plan, REORDER_STATS moves of each)."""
        r0, p0 = dict(r_optimizer.REORDER_STATS), dict(p_optimizer.REORDER_STATS)
        stmt = r_parse_one(sql)
        # the statement's hints, as Session.run_select hands them on
        self.ref._cur_hints = list(getattr(stmt, "hints", []) or [])
        try:
            want = self.ref.plan_select(stmt)
        finally:
            self.ref._cur_hints = None
        r1 = dict(r_optimizer.REORDER_STATS)
        got = entry.plan_select(sql, self.port.infoschema(), "test", self.port.store.stats, dict(self.ref.vars),
                                run_subquery=self.hook)
        p1 = dict(p_optimizer.REORDER_STATS)
        moves = ({k: r1[k] - r0[k] for k in r0}, {k: p1[k] - p0[k] for k in p0})
        return want, got, moves


GOLDEN_DDL = [
    "create table t (id int primary key, a int, b int, c varchar(20), key ia (a), unique key ib (b))",
    "create table s (id int primary key, x int)",
    "create table u (id int primary key)",
    "create table p (k int primary key, v int) partition by range (k) ("
    "partition p0 values less than (100), partition p1 values less than (300))",
]


def _golden_loads():
    i = np.arange(200, dtype=np.int64)
    t = {"id": i, "a": i % 10, "b": i * 2, "c": np.array([f"v{k}" for k in range(200)], dtype=object)}
    s = {"id": np.arange(10, dtype=np.int64), "x": np.arange(10, dtype=np.int64)}
    u = {"id": np.array([1, 2], dtype=np.int64)}
    return [(name, copy.deepcopy(cols), cols) for name, cols in (("t", t), ("s", s), ("u", u))]


def _plan_all(both, queries, names):
    out = {}
    for state in ("plain", "analyzed"):
        if state == "analyzed":
            both.analyze(names)
        for key, sql in queries.items():
            want, got, moves = both.plan_both(sql)
            out[(key, state)] = (plan_desc(want), plan_desc(got), moves, got)
    return out


@pytest.fixture(scope="module")
def golden():
    both = Both(GOLDEN_DDL, _golden_loads())
    both.ref.execute("insert into p values (50, 1), (150, 2)")
    return _plan_all(both, {q: q for q in test_plan_golden.QUERIES}, ("t", "s", "u"))


@pytest.fixture(scope="module")
def tpch_both():
    ddls = [r_tpch.LINEITEM_DDL, r_tpch.ORDERS_DDL, r_tpch.CUSTOMER_DDL]
    loads = [(name, r, p) for name, r, p in zip(TPCH_TABLES, r_tpch.generated_columns(N, 42),
                                                  tpch.generated_columns(N, 42))]
    both = Both(ddls, loads)
    plain = {}
    for key, sql in TPCH_SQL.items():
        want, got, moves = both.plan_both(sql)
        plain[key] = (plan_desc(want), plan_desc(got), moves, want, got)
    return both, plain


@pytest.fixture(scope="module")
def tpch_plans(tpch_both):
    both, plain = tpch_both
    out = {(k, "plain"): v[:3] for k, v in plain.items()}
    both.analyze(TPCH_TABLES)
    for key, sql in TPCH_SQL.items():
        want, got, moves = both.plan_both(sql)
        out[(key, "analyzed")] = (plan_desc(want), plan_desc(got), moves)
    return out


# --- the optimized trees --------------------------------------------------------


@pytest.mark.parametrize("state", ["plain", "analyzed"])
@pytest.mark.parametrize("i", range(len(test_plan_golden.QUERIES)))
def test_golden_queries_plan_the_same(golden, i, state):
    want, got, (r_moves, p_moves), _ = golden[(test_plan_golden.QUERIES[i], state)]
    assert got == want
    assert p_moves == r_moves


@pytest.mark.parametrize("state", ["plain", "analyzed"])
@pytest.mark.parametrize("q", sorted(TPCH_SQL))
def test_tpch_queries_plan_the_same(tpch_plans, q, state):
    want, got, (r_moves, p_moves) = tpch_plans[(q, state)]
    assert got == want
    assert p_moves == r_moves


def test_the_golden_access_paths_are_planned(golden):
    """The golden queries reach the optimizer's access paths (so the trees
    compared above hold key ranges, indexes and point handles)."""
    text = repr([golden[(q, "analyzed")][1] for q in test_plan_golden.QUERIES])
    for word in ("'point'", "'index'", "key_ranges", "pruned_parts", "hint_use_index"):
        assert word in text, word


def test_a_plan_time_subquery_without_a_hook_is_not_ported(tpch_both):
    both, _ = tpch_both
    for sql in ("SELECT o_orderkey FROM orders WHERE o_custkey = (SELECT MAX(c_custkey) FROM customer)",
                "SELECT o_orderkey FROM orders WHERE o_custkey IN "
                "(SELECT MAX(c_custkey) FROM customer GROUP BY c_mktsegment)"):
        with pytest.raises(NotPortedError, match="4.3"):
            entry.plan_select(sql, both.port.infoschema(), "test")
        want, got, _ = both.plan_both(sql)
        assert plan_desc(got) == plan_desc(want)
        assert "const(" in repr(plan_desc(got))


# --- the cut ---------------------------------------------------------------------


def ref_mpp_plan(plan):
    """The MPPPlan the reference's executor builder runs for `plan`:
    slice_plan under the host operators, the fused TopN attached."""
    node, above = plan, []
    while not isinstance(node, (RAggregation, RJoin)):
        above.append(node)
        node = node.children[0]
    mplan = r_slice_plan(node)
    for lim, srt in zip(above, above[1:]):
        if isinstance(lim, RLimit) and isinstance(srt, RSort):
            spec = r_topn_spec(srt, srt.children[0])
            if spec is not None and mplan.agg is spec[2]:
                mplan.topn = (spec[0], spec[1], lim.count + lim.offset)
    return mplan


def _no_step(d):
    return {k: v for k, v in d.items() if k != "root_step"}


@pytest.mark.parametrize("q", sorted(MPP))
def test_the_planned_mpp_plan_is_the_references_and_the_hand_built_one(tpch_both, q):
    _, plain = tpch_both
    sql_name, builder, args = MPP[q]
    _, _, _, want, got = plain[sql_name]
    mplan = entry.mpp_plan(got)
    assert mplan is not None
    assert _no_step(cs.mpp_desc(mplan)) == _no_step(cs.mpp_desc(ref_mpp_plan(want)))
    assert cs.mpp_desc(mplan) == cs.mpp_desc(getattr(tpch, builder)(*args))


@pytest.fixture(scope="module")
def tables():
    li, orders, cust = tpch.generated_columns(N, 42)
    return {"lineitem": li, "orders": orders, "customer": cust}


def _str_rows(rows):
    return [tuple(str(x) for x in r) for r in rows]


ANSWERS = {"q3": ("Q3", {}), "q10": ("Q10", {}), "q18": ("Q18", {}), "q3_top100": ("Q3_TOP100", {}),
           "seg_revenue": ("SEG_REVENUE", {}), "scalar_revenue": ("SCALAR_REVENUE", {}),
           "q3_unfused": ("Q3", {"tidb_tpu_mpp_fused": "OFF"})}


@pytest.mark.parametrize("q", sorted(ANSWERS))
def test_run_mpp_of_the_planned_plan_gives_the_reference_session_rows(tpch_both, tables, q):
    both, _ = tpch_both
    sql_name, variables = ANSWERS[q]
    sql = getattr(tpch, sql_name)
    plan = entry.plan_select(sql, both.port.infoschema(), "test", variables=dict(variables))
    mplan = entry.mpp_plan(plan, variables)
    got = _str_rows(run := entry.run_mpp(mplan, tables, device="cpu", variables=variables).to_pylist())
    both.ref.vars["tidb_allow_mpp"], both.ref.vars["tidb_cop_engine"] = "OFF", "host"
    try:
        want = _str_rows(both.ref.must_query(sql))
    finally:
        both.ref.vars["tidb_allow_mpp"], both.ref.vars["tidb_cop_engine"] = "ON", "auto"
    assert run and len(got) == len(want)
    assert (sorted(got) == sorted(want)) if q == "seg_revenue" else (got == want)
    if q == "scalar_revenue":
        assert got == [("442517679.5435",)]


def test_a_declined_slice_is_counted_as_the_reference_counts_it(tpch_both):
    """A join on a string key: slice_plan declines with the typed reason,
    the engine counts it, and no MPPPlan comes back."""
    both, _ = tpch_both
    sql = ("SELECT COUNT(*) FROM customer c JOIN orders o ON c.c_name = o.o_orderpriority "
           "GROUP BY c.c_mktsegment")
    plan = entry.plan_select(sql, both.port.infoschema(), "test")
    engine = MPPEngine("cpu")
    assert entry.mpp_plan(plan, engine=engine) is None
    reason = []
    want = both.ref.plan_select(r_parse_one(sql))
    join = want
    while not isinstance(join, RJoin):
        join = join.children[0]
    assert r_slice_plan(join, reason) is None
    assert engine.fallback_counts == {reason[0][0]: 1} and engine.last_fallback_reason == reason[0][1]
    assert entry.mpp_plan(plan, {"tidb_allow_mpp": "OFF"}) is None
    assert entry.mpp_plan(entry.plan_select(tpch.Q1, both.port.infoschema(), "test")) is None


# --- the hand-built cop DAGs -----------------------------------------------------


@pytest.mark.parametrize("q", sorted(DAGS))
def test_every_hand_built_cop_dag_is_what_the_planner_pushes(tpch_both, q):
    both, plain = tpch_both
    plan = plain[q][4]
    assert cs.cop_parts(plan) == cs.dag_parts(getattr(tpch, DAGS[q])())


def test_the_card_run_plans_every_query_from_its_sql():
    """chip_smoke.plan_sql over catalog_session (the three TableInfos of
    models/tpch.py in a store with no rows, no ANALYZE): every MPP query
    of the card run equals its hand-built plan, every cop query pushes its
    hand-built DAG, and each planning phase is timed."""
    got = cs.plan_sql(cs.catalog_session(), reps=1)
    assert sorted(got["mpp"]) == sorted(q for q, *_ in cs.MPP_QUERIES)
    assert all(got["equal"].values()) and all(got["cop_equal"].values())
    assert len(got["cop_equal"]) == len(DAGS) == len(cs.COP_SQL)
    assert all(ms["total"] > 0 for ms in got["ms"].values())
    assert set(got["ms"]["q3_mpp"]) == {"parse", "build", "optimize", "cut", "total"}
    assert set(got["ms"]["q1"]) == {"parse", "build", "optimize", "total"}
    assert cs.mpp_desc(got["mpp"]["q3_unfused"]) == cs.mpp_desc(tpch.q3_mpp_plan())


def test_a_planning_failure_fails_the_card_run(monkeypatch):
    """No fallback to a hand-built plan: a query whose plan differs from
    the hand-built one, or that the planner cannot cut, fails plan_sql."""
    sess = cs.catalog_session()
    monkeypatch.setitem(cs.MPP_SQL, "q10_mpp", "Q3")
    with pytest.raises(AssertionError, match="q10_mpp"):
        cs.plan_sql(sess, reps=1)
    monkeypatch.setitem(cs.MPP_SQL, "q10_mpp", "Q1")
    with pytest.raises(AssertionError, match="no MPP plan"):
        cs.plan_sql(sess, reps=1)


def test_the_card_runs_sql_line_analyzes_the_store(tpch_both):
    """chip_smoke.run_sql_path (main.sql) over the port's store at this
    size: ANALYZE of lineitem through Storage.stats over the TileCache
    batches, the stats served by the handle, the planning record kept."""
    both, _ = tpch_both
    info = both.port.infoschema().table("test", "lineitem")
    out = {"sql": cs.plan_sql(cs.catalog_session(), reps=1)}
    with pytest.raises(AssertionError, match="without checked rows"):
        cs.run_sql_path(both.port, info, N, "card", out)
    out["sql"]["rows_equal_oracle"] = dict.fromkeys(out["sql"]["equal"], True)  # what main.mpp records
    cs.run_sql_path(both.port, info, N, "card", out)
    line = out["main.sql"]
    assert line["analyze_rows"] == N and line["analyze_s"] > 0
    assert line["analyze_ndv"]["l_returnflag"] == 3 and all(line["equal"].values())
    assert both.port.store.stats.get(info.id).row_count == N


@pytest.mark.parametrize("q", ["Q3", "Q10", "SEG_REVENUE"])
def test_the_dp_join_reorder_plans_the_same(tpch_both, q):
    """tidb_opt_join_reorder_threshold past the group's three leaves: both
    optimizers take the subset-DP solver (REORDER_STATS["dp"] moves once
    in each) and build the same tree."""
    both, _ = tpch_both
    saved = dict(both.ref.vars)
    both.ref.vars["tidb_opt_join_reorder_threshold"] = "7"
    try:
        want, got, (r_moves, p_moves) = both.plan_both(getattr(tpch, q))
    finally:
        both.ref.vars.clear()
        both.ref.vars.update(saved)
    assert plan_desc(got) == plan_desc(want)
    assert p_moves == r_moves == {"dp": 1, "greedy": 0}
