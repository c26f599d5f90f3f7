"""TPC-H queries through the port, held to the reference Session on the CPU.

Q1, Q6, the TopN of tpch.TOPN, bench.py's multi-key TopN (MULTIKEY_TOPN)
and Q18's subquery (Q18_INNER).

* The DAG check: the reference planner's pushed DAG for each query
  is captured by a recording wrapper installed on ONE engine instance
  (the session store's `sched._tpu`; no tidb_tpu name is rebound), and the
  port's DAG functions must give the same structure.
* The answer check: the same generated lineitem rows through
  `tidb_tpu_torch.entry.run_query(device="cpu")` must give exactly the
  rows the reference Session gives for the same SQL.
"""

import numpy as np
import pytest

from tidb_tpu.models import tpch as ref_tpch
from tidb_tpu.session import Session

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.copr.gpu_engine import TorchEngine
from tidb_tpu_torch.entry import batch_from_numpy, run_query, run_window
from tidb_tpu_torch.models import tpch

N = 20_000


@pytest.fixture(scope="module")
def ref_session():
    s = Session()
    ref_tpch.setup_lineitem(s, N)
    return s


def _capture(s, sql):
    """The DAGs the reference pushes for `sql`, recorded on this session's
    own engine instance."""
    prev = s.vars.get("tidb_cop_engine")
    s.vars["tidb_cop_engine"] = "tpu"
    eng = s.store.sched.tpu_engine
    seen = []
    orig_execute, orig_many = eng.execute, eng.execute_many

    def execute(dag, batch, *a, **kw):
        seen.append(dag)
        return orig_execute(dag, batch, *a, **kw)

    def execute_many(items, *a, **kw):
        seen.extend(dag for dag, _ in items)
        return orig_many(items, *a, **kw)

    eng.execute, eng.execute_many = execute, execute_many
    try:
        rows = s.execute(sql).rows()
    finally:
        del eng.execute, eng.execute_many  # back to the class methods
        s.vars["tidb_cop_engine"] = prev
    return seen, rows


@pytest.mark.parametrize("q", ["Q1", "Q6"])
def test_port_builds_the_dag_the_planner_pushes(ref_session, q):
    seen, _ = _capture(ref_session, getattr(ref_tpch, q))
    assert seen, "the reference pushed nothing to its device engine"
    ref_dag = seen[0]
    dag = getattr(tpch, f"{q.lower()}_dag")()
    assert repr(dag.selection.conds) == repr(ref_dag.selection.conds)
    assert repr(dag.agg.group_by) == repr(ref_dag.agg.group_by)
    assert repr(dag.agg.aggs) == repr(ref_dag.agg.aggs)
    assert dag.scan.col_offsets == ref_dag.scan.col_offsets
    assert [(ft.tp, ft.decimal) for ft in dag.output_types()] == \
        [(ft.tp, ft.decimal) for ft in ref_dag.output_types()]
    for mine, theirs in zip(dag.selection.conds, ref_dag.selection.conds):
        assert [a.ret_type.tp for a in mine.args] == [a.ret_type.tp for a in theirs.args]


def test_port_generator_is_the_reference_generator():
    mine, theirs = tpch.gen_lineitem(1000, 9), ref_tpch.gen_lineitem(1000, 9)
    assert list(mine) == list(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype and np.array_equal(mine[k], theirs[k]), k


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
@pytest.mark.parametrize("q", ["Q1", "Q6"])
def test_run_query_gives_the_reference_session_rows(ref_session, q, compress):
    want = ref_session.execute(getattr(ref_tpch, q)).rows()
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(N))
    engine = TorchEngine(device="cpu")
    engine.tile_compression = compress
    got = run_query(getattr(tpch, f"{q.lower()}_dag")(), batch, device="cpu", engine=engine).to_pylist()
    assert got == want
    assert engine.fallbacks == 0
    assert len(got) == (6 if q == "Q1" else 1)


NEW_QUERIES = {"TOPN": "topn_dag", "MULTIKEY_TOPN": "multikey_topn_dag", "Q18_INNER": "q18_inner_dag"}


@pytest.mark.parametrize("q", sorted(NEW_QUERIES))
def test_port_builds_the_sort_path_dags_the_planner_pushes(ref_session, q):
    seen, _ = _capture(ref_session, getattr(tpch, q))
    assert seen, "the reference pushed nothing to its device engine"
    ref_dag, dag = seen[0], getattr(tpch, NEW_QUERIES[q])()
    assert dag.scan.col_offsets == ref_dag.scan.col_offsets
    assert dag.selection is None and ref_dag.selection is None
    assert dag.limit is None and ref_dag.limit is None
    if dag.topn is not None:
        assert ref_dag.agg is None and ref_dag.topn is not None
        assert repr(dag.topn.by) == repr(ref_dag.topn.by) and dag.topn.n == ref_dag.topn.n
        assert [e.ret_type.tp for e, _ in dag.topn.by] == [e.ret_type.tp for e, _ in ref_dag.topn.by]
    else:
        assert ref_dag.topn is None
        assert repr(dag.agg.group_by) == repr(ref_dag.agg.group_by)
        assert repr(dag.agg.aggs) == repr(ref_dag.agg.aggs)
        assert [(ft.tp, ft.decimal) for ft in dag.output_types()] == \
            [(ft.tp, ft.decimal) for ft in ref_dag.output_types()]


def test_bench_multikey_sql_is_not_pushed_by_the_reference(ref_session):
    """bench.py's multikey_topn selects no l_linenumber: the planner puts a
    Projection between the Limit and the Sort and pushes no TopN, which is
    why MULTIKEY_TOPN selects l_linenumber. Both give the same rows."""
    sql = ("SELECT l_orderkey, l_extendedprice FROM lineitem"
           " ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber LIMIT 50")
    seen, rows = _capture(ref_session, sql)
    assert seen and all(d.topn is None for d in seen)
    _, pushed_rows = _capture(ref_session, tpch.MULTIKEY_TOPN)
    assert rows == [r[:2] for r in pushed_rows]


# the SELECT list of each query, as offsets of the scan's columns
PROJECT = {"TOPN": [0, 5], "MULTIKEY_TOPN": [0, 5, 3], "Q18_INNER": None}


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
@pytest.mark.parametrize("q", sorted(NEW_QUERIES))
def test_run_query_gives_the_reference_session_rows_on_the_sort_paths(ref_session, q, compress):
    want = ref_session.execute(getattr(tpch, q)).rows()
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(N))
    engine = TorchEngine(device="cpu")
    engine.tile_compression = compress
    res = run_query(getattr(tpch, NEW_QUERIES[q])(), batch, device="cpu", engine=engine)
    if PROJECT[q] is not None:
        res = Chunk([res.columns[i] for i in PROJECT[q]])
        assert res.to_pylist() == want  # ORDER BY ... LIMIT: the order is the answer
    else:  # no ORDER BY: compare the rows as a set; run_query orders by the key
        assert sorted(res.to_pylist()) == sorted(want)
    assert engine.fallbacks == 0
    assert res.num_rows == len(want) > 0


def test_port_builds_the_checksum_dag_the_planner_pushes(ref_session):
    seen, _ = _capture(ref_session, tpch.CHECKSUM)
    assert seen, "the reference pushed nothing to its device engine"
    ref_dag, dag = seen[0], tpch.checksum_dag()
    assert repr(dag.selection.conds) == repr(ref_dag.selection.conds)
    assert repr(dag.agg.group_by) == repr(ref_dag.agg.group_by)
    assert repr(dag.agg.aggs) == repr(ref_dag.agg.aggs)
    assert [(ft.tp, ft.flag, ft.decimal) for ft in dag.output_types()] == \
        [(ft.tp, ft.flag, ft.decimal) for ft in ref_dag.output_types()]


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
def test_run_query_gives_the_reference_session_rows_for_the_checksum(ref_session, compress):
    """CHECKSUM (BIT_XOR / BIT_OR / BIT_AND per l_returnflag, one argument
    a decimal product) through run_query: K4's bitwise ops, then the final
    merge of the partials; as a set (no ORDER BY)."""
    want = ref_session.execute(tpch.CHECKSUM).rows()
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(N))
    engine = TorchEngine(device="cpu")
    engine.tile_compression = compress
    got = run_query(tpch.checksum_dag(), batch, device="cpu", engine=engine).to_pylist()
    assert sorted(got) == sorted(want) and len(got) == 3
    assert engine.fallbacks == 0


# --- the window slice: run_window against the reference Session --------------

# query → (spec builder, the SELECT list as offsets of the scan + window columns)
WINDOW_QUERIES = {"WINDOW_SUM_PARTITION": ("window_sum_partition_spec", [13]),
                  "WINDOW_RANK_FRAMES": ("window_rank_frames_spec", [0, 13, 14, 15, 16, 17])}


def _capture_window(s, sql, monkeypatch):
    """The reference's WindowExec for `sql` (its plan's spec, its child's
    pushed DAG, the engine it ran on) and the Session's rows, under
    tidb_cop_engine='tpu'."""
    from tidb_tpu.executor import executors as ref_ex

    seen = []
    orig = ref_ex.WindowExec.next

    def spy(self):
        out = orig(self)
        if out is not None:
            seen.append(dict(part_by=self.part_by, order_by=self.order_by, funcs=self.funcs,
                             out_fts=self.out_fts, dag=self.child.dag, engine=self.last_engine))
        return out

    prev = s.vars.get("tidb_cop_engine")
    s.vars["tidb_cop_engine"] = "tpu"
    monkeypatch.setattr(ref_ex.WindowExec, "next", spy)
    try:
        rows = s.execute(sql).rows()
    finally:
        monkeypatch.undo()
        s.vars["tidb_cop_engine"] = prev
    return seen, rows


@pytest.mark.parametrize("q", sorted(WINDOW_QUERIES))
def test_port_builds_the_window_spec_the_planner_builds(ref_session, q, monkeypatch):
    seen, _ = _capture_window(ref_session, getattr(tpch, q), monkeypatch)
    assert len(seen) == 1 and seen[0]["engine"] == "tpu"
    ref = seen[0]
    dag, (part_by, order_by, funcs, out_fts) = getattr(tpch, WINDOW_QUERIES[q][0])()
    assert repr(part_by) == repr(ref["part_by"])
    assert repr(order_by) == repr(ref["order_by"])
    assert repr(funcs) == repr(ref["funcs"])
    assert [(f.ret_type.tp, f.ret_type.decimal, f.ret_type.flen, f.ret_type.flag) for f in funcs] == \
        [(f.ret_type.tp, f.ret_type.decimal, f.ret_type.flen, f.ret_type.flag) for f in ref["funcs"]]
    assert [(ft.tp, ft.decimal, ft.flag) for ft in out_fts] == [(ft.tp, ft.decimal, ft.flag) for ft in ref["out_fts"]]
    assert dag.scan.col_offsets == ref["dag"].scan.col_offsets
    assert dag.selection is None and ref["dag"].selection is None and ref["dag"].agg is None


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
@pytest.mark.parametrize("q", sorted(WINDOW_QUERIES))
def test_run_window_gives_the_reference_session_rows(ref_session, q, compress, monkeypatch):
    seen, want = _capture_window(ref_session, getattr(tpch, q), monkeypatch)
    assert seen[0]["engine"] == "tpu"  # the reference answered on its device path
    builder, cols = WINDOW_QUERIES[q]
    dag, spec = getattr(tpch, builder)()
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(N))
    engine = TorchEngine(device="cpu")
    engine.tile_compression = compress
    res = run_window(dag, spec, batch, device="cpu", engine=engine)
    got = Chunk([res.columns[i] for i in cols]).to_pylist()
    assert got == want  # every row, in scan order
    assert len(got) == N and engine.fallbacks == 0
    host = run_window(dag, spec, batch, device="cpu", mode="host")
    assert Chunk([host.columns[i] for i in cols]).to_pylist() == want
