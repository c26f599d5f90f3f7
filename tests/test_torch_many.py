"""The port's grouped cop launches (`TorchEngine.execute_many`, K10)
against the reference's `TPUEngine.execute_many`, on the CPU.

One list of (DAG, batch) items goes through both engines, compression ON
and OFF: point aggregations over `pt` id ranges (tools/bench_sched.py's
workload), direct GROUP BY aggregations, a float-key sorted aggregation
whose capacity escalates inside its group (gcap0 forced low), a range
filter with and without LIMIT, single- and multi-key TopNs, a DAG the
reference declines, and two-tile tasks of 70,000 rows whose last tile
narrows. Each port chunk equals the reference's (ints, decimals, dates
and dict-coded strings bit for bit, floats within rtol 1e-9 / atol 1e-6)
and the port's own solo `execute` bit for bit; the fallbacks, the groups
(the multiset of (gcap, width)) and the moves of compile_count are the
reference's.
"""

import numpy as np
import pytest

from tidb_tpu.copr.tilecache import ColumnBatch as RefBatch
from tidb_tpu.copr.tpu_engine import TPUEngine

from tidb_tpu_torch.copr.gpu_engine import TorchEngine
from tidb_tpu_torch.copr.tilecache import ColumnBatch as PortBatch
from tidb_tpu_torch.models import tpch

from test_torch_engine import COL, COLS, PORT, REF, _assert_same_chunk, _batches, _region

PT_COLS = [("id", "bigint"), ("v", "bigint"), ("w", "bigint")]
SPECS = {
    "group_by_k": dict(conds=[("gt", COL("i"), ("int", -500000))], group_by=[COL("k")],
                       aggs=[("count",), ("sum", COL("d")), ("min", COL("u")), ("max", COL("f")),
                             ("first_row", COL("s")), ("bit_xor", COL("i")), ("avg", COL("f"))]),
    "group_by_dict": dict(group_by=[COL("s")], aggs=[("count", COL("i")), ("var_pop", COL("d"))]),
    "float_key_sorted": dict(group_by=[COL("f")], aggs=[("count",), ("sum", COL("d")), ("max", COL("dt"))]),
    "range_filter": dict(conds=[("ge", COL("i"), ("int", -200000)), ("lt", COL("i"), ("int", 300000))]),
    "topn_single": dict(conds=[("ne", COL("k"), ("int", 6))], topn=[(COL("i"), True)]),
    "topn_multi": dict(conds=[("ne", COL("k"), ("int", 6))], topn=[(COL("k"), False), (COL("f"), True)]),
    "declined": dict(group_by=[COL("k")], aggs=[("min", COL("sci")), ("count",)]),
}
SIZES = (3000, 3000, 2500, 1800, 900, 70_000, 70_000)


def _items():
    """(reference items, port items): every spec over every region, the
    range filter once more with a LIMIT, then the point aggregations."""
    rt, pt = REF.table(COLS), PORT.table(COLS)
    ref, port = [], []
    for j, n in enumerate(SIZES):
        data, valid = _region(n, seed=20 + j)
        rb, pb = _batches(data, valid, rt, pt)
        for name, spec in SPECS.items():
            rd, pd = REF.dag(rt, **spec), PORT.dag(pt, **spec)
            ref.append((rd, rb))
            port.append((pd, pb))
        rd, pd = REF.dag(rt, **SPECS["range_filter"]), PORT.dag(pt, **SPECS["range_filter"])
        rd.limit, pd.limit = REF.D.LimitNode(37), PORT.D.LimitNode(37)
        ref.append((rd, rb))
        port.append((pd, pb))
    prt, ppt = REF.table(PT_COLS), PORT.table(PT_COLS)
    spec = dict(aggs=[("count",), ("sum", COL("v")), ("min", COL("v")), ("max", COL("w"))])
    for b in tpch.point_agg_table(6, 4096):
        cols = [np.asarray(x) for x in b.data]
        ones = [np.ones(b.n_rows, dtype=bool)] * 3
        ref.append((REF.dag(prt, **spec), RefBatch(prt, b.handles, cols, ones, version=0)))
        port.append((PORT.dag(ppt, **spec), PortBatch(ppt, b.handles, cols, ones, version=0)))
    return ref, port


@pytest.fixture(scope="module", params=[True, False], ids=["compress_on", "compress_off"])
def runs(request):
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.tile_compression = port.tile_compression = request.param
    ref.gcap0 = port.gcap0 = 16  # the float-key GROUP BY escalates inside its group
    ritems, pitems = _items()
    counts = []
    outs = []
    for _ in range(2):  # the second call runs every program key warm
        c0 = (ref.compile_count, port.compile_count, port.fetches)
        outs.append((ref.execute_many(ritems), port.execute_many(pitems)))
        counts.append((ref.compile_count - c0[0], port.compile_count - c0[1], port.fetches - c0[2]))
    solo = TorchEngine(device="cpu")
    solo.tile_compression = request.param
    solo.gcap0 = 16
    return {"ref": ref, "port": port, "outs": outs, "counts": counts,
            "solo": [solo.execute(d, b) for d, b in pitems], "n": len(pitems)}


def test_chunks_match_reference(runs):
    for want, got in runs["outs"]:
        assert len(got) == runs["n"]
        for w, g in zip(want, got):
            _assert_same_chunk(w, g)


def test_chunks_match_solo_execute_bit_for_bit(runs):
    for _, got in runs["outs"]:
        for so, g in zip(runs["solo"], got):
            assert g.num_rows == so.num_rows and g.num_cols == so.num_cols
            for a, b in zip(so.columns, g.columns):
                assert np.array_equal(a.valid, b.valid)
                assert a.data.dtype == b.data.dtype
                if a.data.dtype == object:
                    assert a.data.tolist() == b.data.tolist()
                else:
                    assert a.data.tobytes() == b.data.tobytes()


def test_fallbacks_match_reference(runs):
    ref, port = runs["ref"], runs["port"]
    assert ref.fallbacks == port.fallbacks == 2 * len(SIZES)


def test_groups_match_reference(runs):
    ref, port = runs["ref"], runs["port"]
    want = sorted(((k[1], k[2]) for k in ref._vprograms), key=repr)
    got = sorted(((k[1], k[2]) for k in port._vprograms), key=repr)
    assert got == want
    assert any(g == 8 for g, _ in got)  # the six point aggregations: one group, gcap 8
    assert any(w is not None and w % (1 << 16) for _, w in got)  # a narrowed last tile


def test_compile_count_moves_as_the_reference(runs):
    (r1, p1, _), (r2, p2, _) = runs["counts"]
    assert (p1, p2) == (r1, r2)
    assert p1 > 0


def test_one_fetch_per_call(runs):
    assert [f for _, _, f in runs["counts"]] == [1, 1]


def test_escalated_capacity_matches_reference(runs):
    assert sorted(runs["port"]._gcap.values()) == sorted(runs["ref"]._gcap.values())
    assert all(v > 16 for v in runs["port"]._gcap.values())


def test_execute_many_of_nothing_is_nothing():
    port = TorchEngine(device="cpu")
    assert port.execute_many([]) == []
    assert port.fetches == 0
