"""The port's MPP path held to the reference's on the CPU.

* The plans: `models/tpch.q3_mpp_plan` / `q10_mpp_plan` equal what the
  reference's `slice_plan` cuts from its optimized plan for the same SQL
  (EXPLAIN text, keys, condition reprs, aggregates, the fused TopN).
* The engine: the same plan and the same numpy columns through the
  reference's MPPEngine on a one-device mesh (`make_mesh(1)`) and through
  the port's MPPEngine(device="cpu") (P3, P7 and P9 through their plain
  versions) give the same partial chunk (Q3: the clustered mode's k best
  groups) or the same joined rows (Q10: rows mode), the same fusion
  outcome and the same fallback accounting.
* The answers: `entry.run_mpp(device="cpu")` gives, in order, the rows
  the reference Session gives with MPP on (its 8-device virtual mesh) and
  with MPP off (the host join).
* Q18 (a duplicate-key level) runs on both engines with the same fusion
  outcome and reasons; the other modes are held in
  test_torch_mpp_modes.py. The reference's declines are mirrored by
  reason on synthetic plans, one spec built by both packages
  (`Pkg.plan`).

Decimals, keys, row ids and order compare exactly; floats within rtol
1e-9 / atol 1e-6.
"""

import importlib

import numpy as np
import pytest
from test_torch_engine import _assert_same_chunk

from tidb_tpu.executor.executors import _mpp_topn_spec
from tidb_tpu.models import tpch as ref_tpch
from tidb_tpu.parallel.mesh import make_mesh
from tidb_tpu.parallel.mpp import MPPEngine as RefEngine, ScanData as RefScanData
from tidb_tpu.parser import parse_one
from tidb_tpu.planner.fragment import slice_plan
from tidb_tpu.planner.plans import Aggregation as RefAggregation, Join, Limit
from tidb_tpu.session import Session

from chip_smoke import agg_desc as _agg_desc, frag_tree as _frag_tree
from tidb_tpu_torch.entry import run_mpp
from tidb_tpu_torch.executor import mpp_gather
from tidb_tpu_torch.models import tpch
from tidb_tpu_torch.parallel.mpp import MPPEngine

N = 60_000


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


def ref_plan(session, sql):
    """The reference's MPPPlan for `sql`: slice_plan over the optimized
    plan's Aggregation(Join) and, where the Limit(Sort) above it orders by
    one sum/count, the fused TopN the executor builder attaches."""
    plan = session.plan_select(parse_one(sql))
    node = plan
    while not isinstance(node, Limit):
        node = node.children[0]
    srt = node.children[0]
    spec = _mpp_topn_spec(srt, srt.children[0])
    n = srt.children[0]
    while not isinstance(n, (RefAggregation, Join)):
        n = n.children[0]
    mplan = slice_plan(n)
    if spec is not None and mplan.agg is spec[2]:
        mplan.topn = (spec[0], spec[1], node.count + node.offset)
    return mplan


def ref_scans(mplan, tables, engine, valid=None):
    """Reference ScanData over the same numpy columns the port reads."""
    out = []
    for sf in mplan.scans:
        cols = tables[sf.ds.table.name]
        names = [sf.ds.table.columns[pc.orig_offset].name for pc in sf.ds.out_cols]
        masks = (valid or {}).get(sf.ds.table.name, {})
        data = [np.asarray(cols[n]) for n in names]
        val = [np.asarray(masks[n], bool) if n in masks else np.ones(len(d), bool) for n, d in zip(names, data)]
        out.append(RefScanData(sf, data, val, version=0, shared=engine,
                               orig_offs=[pc.orig_offset for pc in sf.ds.out_cols]))
    return out


PLANS = {"q3": (ref_tpch.Q3, tpch.q3_mpp_plan), "q10": (ref_tpch.Q10, tpch.q10_mpp_plan)}


@pytest.mark.parametrize("q", sorted(PLANS))
def test_hand_built_plan_is_the_reference_slice(session, q):
    sql, builder = PLANS[q]
    want, got = ref_plan(session, sql), builder()
    assert got.explain() == want.explain()
    assert _frag_tree(got.root) == _frag_tree(want.root)
    assert [_frag_tree(s) for s in got.scans] == [_frag_tree(s) for s in want.scans]
    assert _agg_desc(got.agg) == _agg_desc(want.agg)
    assert got.topn == want.topn
    assert [(c.name, repr(c.ft)) for c in got.out_cols] == [(c.name, repr(c.ft)) for c in want.out_cols]
    assert tpch.Q3 == ref_tpch.Q3 and tpch.Q10 == ref_tpch.Q10 and tpch.Q18 == ref_tpch.Q18


def test_generated_tables_are_the_reference_generator():
    for got, want in zip(tpch.generated_columns(5000, 7), ref_tpch.generated_columns(5000, 7)):
        assert list(got) == list(want)
        for name in got:
            assert got[name].dtype == want[name].dtype and got[name].tolist() == want[name].tolist(), name


def _run_both(session, tables, q, variables=None):
    sql, builder = PLANS[q]
    rplan, pplan = ref_plan(session, sql), builder()
    ref, port = RefEngine(), MPPEngine("cpu")
    want = ref.execute(rplan, ref_scans(rplan, tables, ref), make_mesh(1), variables or {}, fused=True)
    got = port.execute(pplan, mpp_gather.scan_datas(pplan, tables, port), variables or {})
    return ref, port, want, got


@pytest.mark.parametrize("q", sorted(PLANS))
def test_engine_outputs_match_the_one_device_reference(session, tables, q):
    ref, port, want, got = _run_both(session, tables, q)
    assert want is not None and got is not None
    assert got[1] == want[1]  # agg done on the device (Q3) or left to the host (Q10)
    _assert_same_chunk(want[0], got[0])
    assert want[0].num_rows == (10 if q == "q3" else got[0].num_rows) and got[0].num_rows > 0
    assert port.last_fuse_outcome == ref.last_fuse_outcome == "fused"
    assert port.last_fuse_reasons == ref.last_fuse_reasons == {}
    assert port.fallback_counts == ref.fallback_counts == {}
    assert port.last_fallback_reason == ref.last_fallback_reason
    assert port.compile_count == ref.compile_count == 1


def test_q3_takes_the_clustered_mode_and_a_warm_run_uploads_nothing(tables):
    plan = tpch.q3_mpp_plan()
    eng = MPPEngine("cpu")
    run_mpp(plan, tables, device="cpu", engine=eng)
    prog = next(iter(eng._programs.values()))
    assert prog.agg_meta["mode"] == "clustered" and prog.agg_meta["clustered_reason"] is None
    assert eng.last_h2d_bytes > 0
    cached = (len(eng._dev_cache), len(eng._lut_cache))
    run_mpp(plan, tables, device="cpu", engine=eng)
    assert eng.last_h2d_bytes == 0
    assert (len(eng._dev_cache), len(eng._lut_cache)) == cached
    assert eng.compile_count == 1


def _str_rows(rows):
    return [tuple(str(x) for x in r) for r in rows]


@pytest.mark.parametrize("q", sorted(PLANS))
def test_run_mpp_gives_the_reference_session_rows(session, tables, q):
    sql, builder = PLANS[q]
    got = _str_rows(run_mpp(builder(), tables, device="cpu").to_pylist())
    session.vars["tidb_allow_mpp"] = "ON"
    session.vars["tidb_cop_engine"] = "auto"
    mpp = _str_rows(session.must_query(sql))
    session.vars["tidb_allow_mpp"] = "OFF"
    session.vars["tidb_cop_engine"] = "host"
    try:
        host = _str_rows(session.must_query(sql))
    finally:
        session.vars["tidb_allow_mpp"] = "ON"
        session.vars["tidb_cop_engine"] = "auto"
    assert len(got) == (10 if q == "q3" else 20)
    assert got == mpp == host


def test_q18_fuse_reasons_match_the_reference(session, tables):
    """Q18 runs on both engines' unfused program (a duplicate-key level:
    P4), with the same outcome, reasons and partial chunk."""
    rplan = ref_plan(session, ref_tpch.Q18)
    ref = RefEngine()
    want = ref.execute(rplan, ref_scans(rplan, tables, ref), make_mesh(1), {}, fused=True)
    eng = MPPEngine("cpu")
    plan = tpch.q18_mpp_plan()
    got = eng.execute(plan, mpp_gather.scan_datas(plan, tables, eng), {})
    assert want is not None and got is not None
    assert (eng.last_fuse_outcome, eng.last_fuse_reasons) == (ref.last_fuse_outcome, ref.last_fuse_reasons)
    assert eng.last_fuse_reasons == {0: "dup_build_keys"}
    _assert_same_chunk(want[0], got[0])


def test_run_mpp_without_a_card_raises(tables):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        run_mpp(tpch.q3_mpp_plan(), tables)


# --- synthetic plans, one spec built by both packages ----------------------


class Pkg:
    """One package's constructors for MPP plans."""

    def __init__(self, root: str):
        m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        m("expr.builtins")
        self.root = root
        self.E, self.A, self.F = m("expr.expression"), m("expr.aggregation"), m("mysqltypes.field_type")
        self.V, self.S, self.FR = m("mysqltypes.datum"), m("catalog.schema"), m("planner.fragment")
        self.P = m("planner.plans")

    def ft(self, kind):
        F = self.F
        ft = {"bigint": F.ft_longlong, "ubig": lambda: F.ft_longlong(True), "double": F.ft_double,
              "str": lambda: F.ft_varchar(20)}[kind.rstrip("!")]()
        if kind.endswith("!"):
            ft.flag |= F.NOT_NULL_FLAG
        return ft

    def table(self, tid, name, cols):
        return self.S.TableInfo(tid, name, [self.S.ColumnInfo(100 * tid + i, n, self.ft(k), i)
                                            for i, (n, k) in enumerate(cols)])

    def expr(self, spec, resolve):
        E, V, F = self.E, self.V, self.F
        op, *args = spec
        if op == "col":
            idx, ft, name = resolve(args[0])
            return E.Column(idx, ft, name)
        if op == "int":
            return E.Constant(V.Datum.i(args[0]), F.ft_longlong())
        if op == "float":
            return E.Constant(V.Datum.f(args[0]), F.ft_double())
        if op == "str":
            return E.Constant(V.Datum.s(args[0]), F.ft_varchar(20))
        return E.make_func(op, *[self.expr(a, resolve) for a in args])

    def plan(self, spec):
        """MPPPlan of `spec`: scans in slice order (the first is the
        probe), one join level per further scan (`post[i]`: level i's
        residual ON conditions; `kinds[i]`: its join kind, inner unless
        given)."""
        tables = {name: self.table(i + 1, name, cols) for i, (name, cols) in enumerate(spec["tables"].items())}
        frags, off = {}, 0
        for alias in spec["scans"]:
            t = tables[alias]
            cols = [self.P.PlanCol(c.name, c.ft, alias, c.offset) for c in t.columns]
            ds = self.P.DataSource(t, alias, cols)
            frags[alias] = self.FR.ScanFrag(ds, off)
            off += len(cols)

        def joined(ref):
            alias, name = ref.split(".")
            c = tables[alias].col_by_name(name)
            return frags[alias].side_offset + c.offset, c.ft, c.name

        for alias, conds in spec.get("pushed", {}).items():
            def local(name, _a=alias):
                c = tables[_a].col_by_name(name)
                return c.offset, c.ft, c.name
            frags[alias].ds.pushed_conds = [self.expr(c, local) for c in conds]
        root = frags[spec["scans"][0]]
        for i, (alias, (pk, bk)) in enumerate(zip(spec["scans"][1:], spec["joins"])):
            kind = spec.get("kinds", {}).get(i, "inner")
            root = self.FR.JoinFrag(root, frags[alias], kind, [joined(k)[0] for k in pk], [joined(k)[0] for k in bk],
                                    [self.expr(c, joined) for c in spec.get("post", {}).get(i, [])])
        agg = None
        if "agg" in spec:
            group_by = [self.expr(("col", g), joined) for g in spec["agg"]["group_by"]]
            aggs = [self.A.AggDesc.make(name, [self.expr(a, joined) for a in args])
                    for name, *args in spec["agg"]["aggs"]]
            cols = [self.P.PlanCol(f"g{i}", g.ret_type) for i, g in enumerate(group_by)]
            cols += [self.P.PlanCol(f"a{i}", a.ret_type) for i, a in enumerate(aggs)]
            agg = self.P.Aggregation(None, group_by, aggs, cols)
        out_cols = [pc for a in spec["scans"] for pc in frags[a].ds.out_cols]
        return self.FR.MPPPlan(root, [frags[a] for a in spec["scans"]], agg, out_cols, topn=spec.get("topn"))


REF, PORT = Pkg("tidb_tpu"), Pkg("tidb_tpu_torch")


def run_spec(spec, tables, valid=None, variables=None):
    """(reference engine, port engine, reference result, port result) of
    one synthetic spec over the same numpy columns."""
    rplan, pplan = REF.plan(spec), PORT.plan(spec)
    ref, port = RefEngine(), MPPEngine("cpu")
    want = ref.execute(rplan, ref_scans(rplan, tables, ref, valid), make_mesh(1), variables or {})
    got = port.execute(pplan, mpp_gather.scan_datas(pplan, tables, port, valid), variables or {})
    return ref, port, want, got


def _decline_tables(rng, n=3000):
    f = {"fid": np.arange(n), "did": rng.integers(0, 500, n), "v": rng.random(n),
         "s": rng.choice(np.array(["a", "b", "c"], dtype=object), n),
         "s2": rng.choice(np.array(["a", "c"], dtype=object), n), "big": rng.integers(-(1 << 40), 1 << 40, n)}
    d = {"id": np.arange(500), "x": rng.random(500), "seg": rng.integers(0, 3, 500),
         "big": rng.integers(-(1 << 40), 1 << 40, 500)}
    return {"f": f, "d": d}


DECLINES = {
    "float_join_key": {"joins": [(["f.v"], ["d.x"])]},
    "non_lowerable_cond": {"joins": [(["f.did"], ["d.id"])], "pushed": {"f": [("gt", ("col", "s"), ("col", "s2"))]}},
    "domain_overflow": {"joins": [(["f.big", "f.big"], ["d.big", "d.big"])]},
}


@pytest.mark.parametrize("case", sorted(DECLINES))
def test_declines_match_the_reference(case):
    spec = {"tables": {"f": [("fid", "bigint"), ("did", "bigint"), ("v", "double"), ("s", "str"), ("s2", "str"),
                             ("big", "bigint")],
                       "d": [("id", "bigint"), ("x", "double"), ("seg", "bigint"), ("big", "bigint")]},
            "scans": ["f", "d"], **DECLINES[case]}
    ref, port, want, got = run_spec(spec, _decline_tables(np.random.default_rng(3)))
    assert want is None and got is None
    assert port.fallback_counts == ref.fallback_counts == {case: 1}
    assert port.last_fallback_reason == ref.last_fallback_reason
    assert port._decline_key == ref._decline_key == case
