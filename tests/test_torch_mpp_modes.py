"""Every single-device MPP mode of the port held to the reference on the CPU.

* The plans: `models/tpch.q18_mpp_plan` (with its HAVING, projection and
  TopN above the gather), `q3_mpp_plan(100)` and `seg_revenue_mpp_plan`
  equal what the reference's `slice_plan` cuts from its optimized plan
  for Q18, Q3_TOP100 and SEG_REVENUE.
* The engine: each plan through the reference's MPPEngine on a
  one-device mesh (`make_mesh(1)`) and the port's MPPEngine(device="cpu")
  over the same numpy columns gives the same partial chunk or the same
  joined rows (in order), the same fusion outcome and reasons, the same
  aggregation mode and clustered reason, the same fallback accounting:
    - Q18 at 60,000 lineitem rows: a duplicate-key sort-probe level (P4,
      mult 2), the dense aggregation (P8);
    - Q18 at 270,000 rows: 67,500 orders exceed DIRECT_GROUP_MAX, no fused
      TopN: rows mode (the host aggregates the joined rows);
    - Q3 and Q10 with tidb_tpu_mpp_fused OFF: two unique-key sort-probe
      levels, the sorted aggregation (P5) / rows mode;
    - Q3 LIMIT 100 (the clustered guard demotes: topn_too_wide) and Q3
      over a shuffled lineitem (stream_not_clustered): rowpos (P6);
    - SEG_REVENUE: the dense aggregation with count, sum, avg, min, max;
    - left joins through sort-probe levels, unique and duplicate keys, in
      rows mode and under the dense aggregation (synthetic plans built by
      both packages from one spec, test_torch_mpp.Pkg);
    - a duplicate-key level whose capacity is forced below its output:
      both engines count capacity_overflow and return nothing.
* The answers: `entry.run_mpp(device="cpu")` gives the rows the reference
  Session gives with MPP on (its 8-device virtual mesh) and with MPP off
  (the host join), in order where the query orders them.

Decimals, keys, row ids and order compare exactly; floats within rtol
1e-9 / atol 1e-6.
"""

import numpy as np
import pytest
from test_torch_engine import _assert_same_chunk
from test_torch_mpp import PORT, REF, _frag_tree, _agg_desc, _str_rows, ref_scans, run_spec

from tidb_tpu.executor.executors import _mpp_topn_spec
from tidb_tpu.models import tpch as ref_tpch
from tidb_tpu.parallel.mesh import make_mesh
from tidb_tpu.parallel.mpp import MPPEngine as RefEngine
from tidb_tpu.parser import parse_one
from tidb_tpu.planner.fragment import slice_plan
from tidb_tpu.planner.plans import Aggregation as RefAggregation, Join, Limit, Projection, Selection, Sort
from tidb_tpu.session import Session

from tidb_tpu_torch.entry import run_mpp
from tidb_tpu_torch.errors import NotPortedError
from tidb_tpu_torch.executor import mpp_gather
from tidb_tpu_torch.models import tpch
from tidb_tpu_torch.parallel.mpp import MPPEngine

N = 60_000
N_ROWS_MODE = 270_000


@pytest.fixture(scope="module")
def session():
    s = Session()
    ref_tpch.setup_tpch(s, N)
    s.vars["tidb_enable_cop_result_cache"] = "OFF"
    return s


@pytest.fixture(scope="module")
def tables():
    li, orders, cust = tpch.generated_columns(N, 42)
    return {"lineitem": li, "orders": orders, "customer": cust}


def plan_nodes(session, sql):
    """The reference's optimized plan for `sql`: (the MPPPlan slice_plan
    cuts under it, with the fused TopN the executor builder attaches, and
    the nodes above it)."""
    node = session.plan_select(parse_one(sql))
    above = []
    while not isinstance(node, (RefAggregation, Join)):
        above.append(node)
        node = node.children[0]
    mplan = slice_plan(node)
    lim = next((a for a in above if isinstance(a, Limit)), None)
    if lim is not None:
        srt = lim.children[0]
        spec = _mpp_topn_spec(srt, srt.children[0])
        if spec is not None and mplan.agg is spec[2]:
            mplan.topn = (spec[0], spec[1], lim.count + lim.offset)
    return mplan, above


PLANS = {"q18": (ref_tpch.Q18, tpch.q18_mpp_plan), "q3_top100": (tpch.Q3_TOP100, lambda: tpch.q3_mpp_plan(100)),
         "seg_revenue": (tpch.SEG_REVENUE, tpch.seg_revenue_mpp_plan),
         "scalar_revenue": (tpch.SCALAR_REVENUE, tpch.scalar_revenue_mpp_plan)}


@pytest.mark.parametrize("q", sorted(PLANS))
def test_hand_built_plan_is_the_reference_slice(session, q):
    sql, builder = PLANS[q]
    (want, above), got = plan_nodes(session, sql), builder()
    assert got.explain() == want.explain()
    assert _frag_tree(got.root) == _frag_tree(want.root)
    assert [_frag_tree(s) for s in got.scans] == [_frag_tree(s) for s in want.scans]
    assert _agg_desc(got.agg) == _agg_desc(want.agg)
    assert got.topn == want.topn
    # the steps above the gather: HAVING, projection, ORDER BY, LIMIT
    step = got.root_step
    sel = [c for a in above if isinstance(a, Selection) for c in a.conds]
    assert repr(step.having) == repr(sel)
    proj = next(a for a in above if isinstance(a, Projection))
    assert [e.idx for e in proj.exprs] == step.proj
    srt = next((a for a in above if isinstance(a, Sort)), None)
    assert [(e.idx, d) for e, d in srt.by] == [(e.idx, d) for e, d in step.by] if srt else step.by == []
    lim = next((a for a in above if isinstance(a, Limit)), None)
    assert step.n == (lim.count + lim.offset if lim else None)
    assert tpch.Q18 == ref_tpch.Q18 and tpch.Q3_TOP100 == ref_tpch.Q3.replace("LIMIT 10", "LIMIT 100")


def _engines(session, sql, builder, tables, variables=None, ref_tables=None, hook=None):
    """(reference engine, port engine, reference result, port result)."""
    rplan, _ = plan_nodes(session, sql)
    pplan = builder()
    ref, port = RefEngine(), MPPEngine("cpu")
    if hook is not None:
        hook(ref)
        hook(port)
    want = ref.execute(rplan, ref_scans(rplan, ref_tables or tables, ref), make_mesh(1), variables or {})
    got = port.execute(pplan, mpp_gather.scan_datas(pplan, tables, port), variables or {})
    return ref, port, want, got


def _same_outcome(ref, port):
    assert port.last_fuse_outcome == ref.last_fuse_outcome
    assert port.last_fuse_reasons == ref.last_fuse_reasons
    assert port.fallback_counts == ref.fallback_counts
    assert port.last_fallback_reason == ref.last_fallback_reason
    assert port._decline_key == ref._decline_key
    assert port.compile_count == ref.compile_count


def _mode(port):
    prog = next(iter(port._programs.values()))
    am = prog.agg_meta
    return (am["mode"], am.get("clustered_reason")) if am is not None else ("rows", None)


def _shuffled(tables, seed=5):
    li = tables["lineitem"]
    perm = np.random.default_rng(seed).permutation(len(next(iter(li.values()))))
    return dict(tables, lineitem={k: v[perm] for k, v in li.items()})


# (sql, builder, variables, tables transform, mode, clustered reason, fuse outcome, fuse reasons)
ENGINE_CASES = {
    "q18_dense": (ref_tpch.Q18, tpch.q18_mpp_plan, {}, None, "dense", None, "unfused", {0: "dup_build_keys"}),
    "q3_fused_off": (ref_tpch.Q3, tpch.q3_mpp_plan, {"tidb_tpu_mpp_fused": "OFF"}, None, "sorted", None, "off", {}),
    "q10_fused_off": (ref_tpch.Q10, tpch.q10_mpp_plan, {"tidb_tpu_mpp_fused": "OFF"}, None, "rows", None, "off", {}),
    "q3_top100": (tpch.Q3_TOP100, lambda: tpch.q3_mpp_plan(100), {}, None, "rowpos", "topn_too_wide", "fused", {}),
    "q3_shuffled_stream": (ref_tpch.Q3, tpch.q3_mpp_plan, {}, _shuffled, "rowpos", "stream_not_clustered", "fused", {}),
    "seg_revenue": (tpch.SEG_REVENUE, tpch.seg_revenue_mpp_plan, {}, None, "dense", None, "fused", {}),
    # no GROUP BY: the dense mode with no key, one segment
    "scalar_revenue": (tpch.SCALAR_REVENUE, tpch.scalar_revenue_mpp_plan, {}, None, "dense", None, "fused", {}),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_outputs_match_the_one_device_reference(session, tables, case):
    sql, builder, variables, transform, mode, creason, outcome, reasons = ENGINE_CASES[case]
    t = transform(tables) if transform else tables
    ref, port, want, got = _engines(session, sql, builder, t, variables)
    assert want is not None and got is not None
    assert got[1] == want[1] == (mode != "rows")
    assert got[0].num_rows > 0
    _assert_same_chunk(want[0], got[0])
    assert _mode(port) == (mode, creason)
    assert port.last_fuse_outcome == outcome and port.last_fuse_reasons == reasons
    _same_outcome(ref, port)


def test_q18_past_the_direct_group_limit_takes_rows_mode(session):
    """67,500 orders > DIRECT_GROUP_MAX and no fused TopN (two sort keys):
    the reference joins on the device (P4, duplicate keys) and leaves the
    aggregation to the host; the joined rows ship in slot order — the
    build side's stable sorted order within each probe row."""
    li, orders, cust = tpch.generated_columns(N_ROWS_MODE, 42)
    big = {"lineitem": li, "orders": orders, "customer": cust}
    ref, port, want, got = _engines(session, ref_tpch.Q18, tpch.q18_mpp_plan, big)
    assert want[1] is got[1] is False
    assert got[0].num_rows == N_ROWS_MODE  # every lineitem row joins its order
    _assert_same_chunk(want[0], got[0])
    assert _mode(port) == ("rows", None)
    assert port.last_fallback_reason == "agg on host: group-key domain too wide"
    _same_outcome(ref, port)


def test_forced_capacity_overflow_is_counted_as_the_reference_counts_it(session, tables):
    """A duplicate-key level whose exact cardinality is understated: the
    dropped-row counter is non-zero, both engines count capacity_overflow
    and return nothing; the port's gather raises with that reason."""

    def understate(engine):
        prepare = engine.prepare

        def low(*a, **kw):
            meta = prepare(*a, **kw)
            for lvl in meta["levels"].values():
                if lvl.mult > 1:
                    lvl.expected_out //= 3
            return meta
        engine.prepare = low

    ref, port, want, got = _engines(session, ref_tpch.Q18, tpch.q18_mpp_plan, tables, hook=understate)
    assert want is None and got is None
    assert port.fallback_counts == ref.fallback_counts == {"capacity_overflow": 1}
    assert port.last_fallback_reason == ref.last_fallback_reason
    assert "rows" in port.last_fallback_reason
    eng = MPPEngine("cpu")
    understate(eng)
    plan = tpch.q18_mpp_plan()
    with pytest.raises(NotPortedError, match="capacity_overflow"):
        mpp_gather.gather(plan, mpp_gather.scan_datas(plan, tables, eng), eng)


def test_a_warm_sort_probe_run_uploads_nothing(tables):
    plan = tpch.q18_mpp_plan()
    eng = MPPEngine("cpu")
    first = run_mpp(plan, tables, device="cpu", engine=eng)
    assert eng.last_h2d_bytes > 0
    again = run_mpp(plan, tables, device="cpu", engine=eng)
    assert eng.last_h2d_bytes == 0 and eng.compile_count == 1
    _assert_same_chunk(first, again)


# --- left joins through sort-probe levels (synthetic plans) ----------------

LEFT_TABLES = {"f": [("fid", "bigint!"), ("k", "bigint"), ("v", "double"), ("q", "bigint")],
               "d": [("id", "bigint"), ("w", "bigint"), ("seg", "bigint!"), ("x", "double")]}


def _left_tables(rng, dup: bool, n=4000, nd=900):
    ids = rng.integers(0, 700, nd) if dup else rng.choice(np.arange(5, 2000), nd, replace=False)
    f = {"fid": np.arange(n), "k": rng.integers(-5, 2100, n), "v": np.round(rng.standard_normal(n), 3),
         "q": rng.integers(-50, 50, n)}
    d = {"id": ids, "w": rng.integers(-(1 << 62), 1 << 62, nd), "seg": rng.integers(0, 4, nd),
         "x": rng.standard_normal(nd)}
    valid = {"f": {"k": rng.random(n) > 0.1, "v": rng.random(n) > 0.1},
             "d": {"id": rng.random(nd) > 0.05, "w": rng.random(nd) > 0.1, "x": rng.random(nd) > 0.1}}
    for t, masks in valid.items():
        tbl = {"f": f, "d": d}[t]
        for c, m in masks.items():
            tbl[c] = np.where(m, tbl[c], np.zeros((), tbl[c].dtype))
    return {"f": f, "d": d}, valid


LEFT_SPECS = {
    "unique_rows": (False, {}),
    "dup_rows": (True, {"pushed": {"d": [("ne", ("col", "seg"), ("int", 2))]}}),
    "dup_dense_agg": (True, {"agg": {"group_by": ["d.seg"], "aggs": [("count",), ("sum", ("col", "d.w")),
                                                                      ("max", ("col", "f.v")),
                                                                      ("min", ("col", "d.x"))]}}),
}


@pytest.mark.parametrize("case", sorted(LEFT_SPECS))
def test_left_join_through_a_sort_probe_level_matches_the_reference(case):
    dup, extra = LEFT_SPECS[case]
    tables, valid = _left_tables(np.random.default_rng(21), dup)
    spec = {"tables": LEFT_TABLES, "scans": ["f", "d"], "joins": [(["f.k"], ["d.id"])], "kinds": {0: "left"},
            "pushed": {"f": [("gt", ("col", "q"), ("int", -40))]}, **extra}
    ref, port, want, got = run_spec(spec, tables, valid)
    assert want is not None and got is not None and got[1] == want[1] == ("agg" in spec)
    _assert_same_chunk(want[0], got[0])
    assert port.last_fuse_reasons == ref.last_fuse_reasons == {0: "outer_join"}
    lvl = next(iter(next(iter(port._programs.values())).levels.values()))
    assert not lvl.use_lut and lvl.mult == (2 if dup else 1)
    if "agg" not in spec:  # unmatched probe rows emit one row each, NULL on the build side
        assert got[0].num_rows >= 3000 and not got[0].columns[4].valid.all()
    _same_outcome(ref, port)


def test_the_engines_build_the_same_plans_from_one_spec():
    spec = {"tables": LEFT_TABLES, "scans": ["f", "d"], "joins": [(["f.k"], ["d.id"])], "kinds": {0: "left"}}
    assert _frag_tree(PORT.plan(spec).root) == _frag_tree(REF.plan(spec).root)


# --- the answers against the reference Session ------------------------------

SESSION_CASES = {
    "q18": (ref_tpch.Q18, tpch.q18_mpp_plan, {}, 10),
    "q3_fused_off": (ref_tpch.Q3, tpch.q3_mpp_plan, {"tidb_tpu_mpp_fused": "OFF"}, 10),
    "q10_fused_off": (ref_tpch.Q10, tpch.q10_mpp_plan, {"tidb_tpu_mpp_fused": "OFF"}, 20),
    "q3_top100": (tpch.Q3_TOP100, lambda: tpch.q3_mpp_plan(100), {}, 100),
    "seg_revenue": (tpch.SEG_REVENUE, tpch.seg_revenue_mpp_plan, {}, 5),
}


@pytest.mark.parametrize("q", sorted(SESSION_CASES))
def test_run_mpp_gives_the_reference_session_rows(session, tables, q):
    """In order where the query orders its rows; SEG_REVENUE (no ORDER BY)
    in the order of the reference's MPP gather (group key order), and as
    a set against the host join."""
    sql, builder, variables, nrows = SESSION_CASES[q]
    got = _str_rows(run_mpp(builder(), tables, device="cpu", variables=variables).to_pylist())
    session.vars["tidb_allow_mpp"] = "ON"
    session.vars["tidb_cop_engine"] = "auto"
    for k, v in variables.items():
        session.vars[k] = v
    try:
        mpp = _str_rows(session.must_query(sql))
        session.vars["tidb_allow_mpp"] = "OFF"
        session.vars["tidb_cop_engine"] = "host"
        host = _str_rows(session.must_query(sql))
    finally:
        session.vars["tidb_allow_mpp"] = "ON"
        session.vars["tidb_cop_engine"] = "auto"
        for k in variables:
            session.vars[k] = "ON"
    assert len(got) == nrows
    assert got == mpp
    assert (sorted(got) == sorted(host)) if q == "seg_revenue" else (got == host)



def test_join_aggregate_without_group_by_runs_as_the_reference_dense_mode():
    """f(fid, k, v) ⋈ d(id, w) on f.k = d.id, SUM(f.v) and COUNT(*), no
    group key, 1,000 probe rows: the reference's dense mode with every
    row coded 0 (nseg 1), fused, on both engines."""
    rng = np.random.default_rng(8)
    n, nd = 1000, 300
    tables = {"f": {"fid": np.arange(n), "k": rng.integers(0, nd, n), "v": rng.integers(-5, 6, n)},
              "d": {"id": np.arange(nd), "w": rng.integers(0, 100, nd)}}
    spec = {"tables": {"f": [("fid", "bigint"), ("k", "bigint"), ("v", "bigint")],
                       "d": [("id", "bigint"), ("w", "bigint")]},
            "scans": ["f", "d"], "joins": [(["f.k"], ["d.id"])],
            "agg": {"group_by": [], "aggs": [("sum", ("col", "f.v")), ("count",)]}}
    ref, port, want, got = run_spec(spec, tables)
    assert want is not None and got is not None and got[1] == want[1] is True
    _assert_same_chunk(want[0], got[0])
    assert got[0].num_rows == 1 and got[0].columns[-1].data.tolist() == [n]
    assert _mode(port) == ("dense", None) and port.last_fuse_outcome == ref.last_fuse_outcome == "fused"
    _same_outcome(ref, port)


def test_scalar_revenue_gives_the_reference_session_answer():
    """SCALAR_REVENUE through run_mpp on the CPU, against the reference
    Session at setup_tpch(s, 20000) with MPP on: 442517679.5435."""
    s = Session()
    ref_tpch.setup_tpch(s, 20_000)
    s.vars["tidb_allow_mpp"] = "ON"
    s.vars["tidb_cop_engine"] = "auto"
    want = _str_rows(s.must_query(tpch.SCALAR_REVENUE))
    li, orders, cust = tpch.generated_columns(20_000, 42)
    got = _str_rows(run_mpp(tpch.scalar_revenue_mpp_plan(), {"lineitem": li, "orders": orders, "customer": cust},
                            device="cpu").to_pylist())
    assert got == want == [("442517679.5435",)]
