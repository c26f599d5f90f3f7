"""FN_MIX and FN_MATH (the builtins past arithmetic on the cop path)
through the port, held to the reference on the CPU.

* The DAGs: `models/tpch.fn_mix_dag` / `fn_math_dag` are the DAGs the
  reference planner pushes for the SQL (every node's repr and FieldType).
* The answers: `entry.run_query(device="cpu")` over the same generated
  lineitem (20,000 rows) gives the reference Session's rows with its cop
  engine on its device ('tpu'), compression ON and OFF, with no fallback
  in either engine: integers and decimals exactly, floats within rtol
  1e-9 / atol 1e-6.
* The declines: GROUP BY YEAR(l_shipdate) (a group key that is not a
  column) falls back in both engines with one fallback each, and gives
  the host's rows.
* A launch group (K10's task mode) runs FN_MIX over four region batches
  with one expression program for the group, equal to each region's solo
  execute; an MPP plan with MOD and ROUND in its scan selection and a
  CASE / DIV aggregate argument equals the reference's engine.
"""

import numpy as np
import pytest

from tidb_tpu.models import tpch as ref_tpch
from tidb_tpu.session import Session

from tidb_tpu_torch.copr.gpu_engine import TorchEngine
from tidb_tpu_torch.entry import batch_from_numpy, run_many, run_query
from tidb_tpu_torch.expr import program as P
from tidb_tpu_torch.models import tpch

from test_torch_engine import _assert_same_chunk
from test_torch_tpch import _capture

N = 20_000
RTOL, ATOL = 1e-9, 1e-6
QUERIES = {"FN_MIX": "fn_mix_dag", "FN_MATH": "fn_math_dag"}


@pytest.fixture(scope="module")
def ref_session():
    s = Session()
    ref_tpch.setup_lineitem(s, N)
    return s


def _node(e):
    ft = e.ret_type
    return (type(e).__name__, getattr(getattr(e, "sig", None), "name", None), repr(e), int(ft.tp), ft.decimal,
            ft.flag, ft.flen, [_node(a) for a in getattr(e, "args", [])])


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_port_builds_the_dag_the_planner_pushes(ref_session, q):
    seen, _ = _capture(ref_session, getattr(tpch, q))
    assert len(seen) == 1
    ref_dag, dag = seen[0], getattr(tpch, QUERIES[q])()
    assert dag.scan.col_offsets == ref_dag.scan.col_offsets
    assert [_node(c) for c in dag.selection.conds] == [_node(c) for c in ref_dag.selection.conds]
    assert repr(dag.agg.group_by) == repr(ref_dag.agg.group_by)
    assert [(a.name, [_node(x) for x in a.args]) for a in dag.agg.aggs] == \
        [(a.name, [_node(x) for x in a.args]) for a in ref_dag.agg.aggs]
    assert [(ft.tp, ft.decimal, ft.flag) for ft in dag.output_types()] == \
        [(ft.tp, ft.decimal, ft.flag) for ft in ref_dag.output_types()]


def _same_rows(got, want, float_cols):
    assert len(got) == len(want) > 0
    for g, w in zip(sorted(got), sorted(want)):
        assert len(g) == len(w)
        for j, (x, y) in enumerate(zip(g, w)):
            if j in float_cols:
                assert np.isclose(float(x), float(y), rtol=RTOL, atol=ATOL), (j, g, w)
            else:
                assert x == y, (j, g, w)


def _float_cols(dag):
    fts = [g.ret_type for g in dag.agg.group_by] + [a.ret_type for a in dag.agg.aggs]
    return {j for j, ft in enumerate(fts) if ft.is_float()}


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
@pytest.mark.parametrize("q", sorted(QUERIES))
def test_run_query_gives_the_reference_device_rows(ref_session, q, compress):
    eng = ref_session.store.sched.tpu_engine
    prev = ref_session.vars.get("tidb_cop_engine"), eng.tile_compression
    ref_session.vars["tidb_cop_engine"] = "tpu"
    eng.tile_compression = compress
    f0 = eng.fallbacks
    try:
        want = ref_session.execute(getattr(tpch, q)).rows()
    finally:
        ref_session.vars["tidb_cop_engine"], eng.tile_compression = prev
    assert eng.fallbacks == f0
    dag = getattr(tpch, QUERIES[q])()
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(N))
    engine = TorchEngine(device="cpu")
    engine.tile_compression = compress
    got = run_query(dag, batch, device="cpu", engine=engine).to_pylist()
    assert engine.fallbacks == 0
    _same_rows(got, want, _float_cols(dag))
    assert len(got) == 6


def test_fn_mix_round_column_is_the_devices_not_the_hosts(ref_session):
    """SUM(ROUND(price * 1.0e0 * (1 - disc), 2)): the reference's host and
    device disagree past rtol 1e-9 on some group (rows at a half cent
    round apart, lane_as_float being x * 0.01 on the device); the port
    gives the device's."""
    rows = {}
    for engine in ("host", "tpu"):
        ref_session.vars["tidb_cop_engine"] = engine
        rows[engine] = sorted(ref_session.execute(tpch.FN_MIX).rows())
    ref_session.vars["tidb_cop_engine"] = "auto"
    got = sorted(run_query(tpch.fn_mix_dag(), batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(N)),
                           device="cpu").to_pylist())
    host = [float(r[-1]) for r in rows["host"]]
    dev = [float(r[-1]) for r in rows["tpu"]]
    mine = [float(r[-1]) for r in got]
    assert not np.allclose(host, dev, rtol=RTOL, atol=ATOL)
    assert np.allclose(mine, dev, rtol=RTOL, atol=ATOL)


def test_group_by_an_expression_is_declined_as_the_reference_declines_it(ref_session):
    sql = "SELECT YEAR(l_shipdate), COUNT(*), SUM(l_quantity) FROM lineitem GROUP BY YEAR(l_shipdate)"
    eng = ref_session.store.sched.tpu_engine
    ref_session.vars["tidb_cop_engine"] = "tpu"
    f0 = eng.fallbacks
    try:
        seen, want = _capture(ref_session, sql)
    finally:
        ref_session.vars["tidb_cop_engine"] = "auto"
    assert eng.fallbacks - f0 == 1 and len(seen) == 1
    from tidb_tpu_torch.copr.dag import AggNode, DAGRequest
    from tidb_tpu_torch.expr.aggregation import AggDesc
    from tidb_tpu_torch.expr.expression import make_func

    col = tpch._col
    dag = DAGRequest(scan=tpch._scan(), agg=AggNode([make_func("year", col("l_shipdate"))],
                                                    [AggDesc.make("count", []), AggDesc.make("sum", [col("l_quantity")])]))
    assert repr(dag.agg.group_by) == repr(seen[0].agg.group_by) and repr(dag.agg.aggs) == repr(seen[0].agg.aggs)
    engine = TorchEngine(device="cpu")
    got = run_query(dag, batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(N)), device="cpu", engine=engine)
    assert engine.fallbacks == 1
    assert sorted(got.to_pylist()) == sorted(want)


def test_a_launch_group_runs_one_program_for_its_tasks(monkeypatch):
    """FN_MIX over four region batches through run_many: K10's task mode of
    the expression kernel once for the group (the program's extended ops
    included), each task's partial equal to its region's solo execute."""
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(N))
    regions = tpch.region_batches(batch, 5000)
    assert len(regions) == 4
    dag = tpch.fn_mix_dag()
    calls = []
    real = P.kernel_tasks()
    monkeypatch.setattr(P, "kernel_tasks", lambda: lambda prog, ins, w: calls.append(prog) or real(prog, ins, w))
    engine = TorchEngine(device="cpu")
    got = run_many([(dag, b) for b in regions], device="cpu", engine=engine)
    assert engine.fallbacks == 0
    assert calls and all(p.ext for p in calls)
    solo = TorchEngine(device="cpu")
    for g, b in zip(got, regions):
        _assert_same_chunk(solo.execute(dag, b), g)


def test_an_mpp_plan_with_the_new_builtins_matches_the_reference():
    from test_torch_mpp import run_spec

    rng = np.random.default_rng(9)
    n = 4000
    tables = {"f": {"fid": np.arange(n), "did": rng.integers(0, 500, n), "v": np.round(rng.random(n) * 100, 2),
                    "w": rng.integers(-50, 50, n)},
              "d": {"id": np.arange(500), "x": rng.random(500), "seg": rng.integers(0, 5, 500)}}
    spec = {"tables": {"f": [("fid", "bigint"), ("did", "bigint"), ("v", "double"), ("w", "bigint")],
                       "d": [("id", "bigint"), ("x", "double"), ("seg", "bigint")]},
            "scans": ["f", "d"], "joins": [(["f.did"], ["d.id"])],
            "pushed": {"f": [("ne", ("mod", ("col", "w"), ("int", 7)), ("int", 0)),
                             ("gt", ("round", ("col", "v"), ("int", 0)), ("int", 10))]},
            "agg": {"group_by": ["d.seg"],
                    "aggs": [("count",), ("sum", ("case", ("gt", ("col", "f.w"), ("int", 0)),
                                                   ("intdiv", ("col", "f.w"), ("int", 3)), ("int", -1))),
                             ("sum", ("sqrt", ("col", "f.v")))]}}
    ref, port, want, got = run_spec(spec, tables)
    assert want is not None and got is not None
    assert port.fallback_counts == ref.fallback_counts == {}
    _assert_same_chunk(want[0], got[0])


def test_a_string_constant_outside_a_rewritten_comparison_is_declined(ref_session):
    sql = "SELECT l_returnflag, COUNT(*) FROM lineitem WHERE CAST(l_linenumber AS CHAR) = '3' GROUP BY l_returnflag"
    eng = ref_session.store.sched.tpu_engine
    ref_session.vars["tidb_cop_engine"] = "tpu"
    f0 = eng.fallbacks
    try:
        seen, want = _capture(ref_session, sql)
    finally:
        ref_session.vars["tidb_cop_engine"] = "auto"
    assert eng.fallbacks - f0 == 1 and len(seen) == 1
    from tidb_tpu_torch.copr.dag import AggNode, DAGRequest, SelectionNode
    from tidb_tpu_torch.expr.aggregation import AggDesc
    from tidb_tpu_torch.expr.expression import FUNCS, Constant, ScalarFunc, make_func
    from tidb_tpu_torch.mysqltypes.datum import Datum
    from tidb_tpu_torch.mysqltypes.field_type import ft_varchar

    ref_cond = seen[0].selection.conds[0]
    cast = ScalarFunc(FUNCS["cast"], [tpch._col("l_linenumber")], ref_cond.args[0].ret_type.clone())
    cond = make_func("eq", cast, Constant(Datum.s("3"), ft_varchar()))
    assert repr(cond) == repr(ref_cond)
    dag = DAGRequest(scan=tpch._scan(), selection=SelectionNode([cond]),
                     agg=AggNode([tpch._col("l_returnflag")], [AggDesc.make("count", [])]))
    engine = TorchEngine(device="cpu")
    got = run_query(dag, batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(N)), device="cpu", engine=engine)
    assert engine.fallbacks == 1
    assert sorted(got.to_pylist()) == sorted(want)


def test_max_of_a_cast_to_char_raises_device_fatal_in_both_engines():
    """MAX(CAST(l_linenumber AS CHAR)): the reference's device fails in the
    cast kernel (`assert xp is np`), which its engine boundary classifies
    as DeviceFatalError; the port's compiler raises DeviceFatalError."""
    from tidb_tpu.copr.retry import classify_device_error
    from tidb_tpu.copr.tilecache import ColumnBatch as RefBatch
    from tidb_tpu.copr.tpu_engine import TPUEngine
    from tidb_tpu.errors import DeviceFatalError as RefFatal

    from tidb_tpu_torch.errors import DeviceFatalError

    from test_torch_engine import LINEITEM_COLS, PORT, REF

    def dag(pkg, table):
        d = pkg.dag(table, aggs=[("count",)])
        col = table.col_by_name("l_linenumber")
        arg = pkg.E.ScalarFunc(pkg.E.FUNCS["cast"], [pkg.E.Column(col.offset, col.ft, col.name)], pkg.F.ft_varchar(21))
        d.agg.aggs = [pkg.A.AggDesc.make("max", [arg])]
        return d

    cols = tpch.gen_lineitem(2000)
    rt, pt = REF.table(LINEITEM_COLS), PORT.table(LINEITEM_COLS)
    names = [c for c, _ in LINEITEM_COLS]
    rb = RefBatch(rt, np.arange(1, 2001, dtype=np.int64), [cols[n] for n in names],
                  [np.ones(2000, bool) for _ in names], version=0)
    with pytest.raises(Exception) as ref_exc:
        TPUEngine().execute(dag(REF, rt), rb)
    assert isinstance(classify_device_error(ref_exc.value), RefFatal)
    with pytest.raises(DeviceFatalError):
        TorchEngine(device="cpu").execute(dag(PORT, pt), batch_from_numpy(pt, {n: cols[n] for n in names}))
