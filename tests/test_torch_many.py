"""The port's grouped cop launches (`TorchEngine.execute_many`, K10)
against the reference's `TPUEngine.execute_many`, on the CPU.

One list of (DAG, batch) items goes through both engines, compression ON
and OFF: point aggregations over `pt` id ranges (tools/bench_sched.py's
workload), direct GROUP BY aggregations, a float-key sorted aggregation
whose capacity escalates inside its group (gcap0 forced low), a range
filter with and without LIMIT, single- and multi-key TopNs at LIMIT 10
and at LIMIT 5,000 (past the width of the groups of short tasks, so the
task modes take k = width), a DAG the reference declines, and two-tile
tasks of 70,000 rows whose last tile
narrows. Each port chunk equals the reference's (ints, decimals, dates
and dict-coded strings bit for bit, floats within rtol 1e-9 / atol 1e-6)
and the port's own solo `execute` bit for bit; the fallbacks, the groups
(the multiset of (gcap, width)) and the moves of compile_count are the
reference's. The sort-aggregation and TopN groups run K10's task-grid
modes (K9 / K6 / K7 with K8), never their members' solo kernels, and two
tasks of one group that overflow the capacity to different sizes escalate
it as the reference's per-task reruns do.
"""

from collections import Counter

import numpy as np
import pytest

from tidb_tpu.copr.tilecache import ColumnBatch as RefBatch
from tidb_tpu.copr.tpu_engine import TPUEngine

from tidb_tpu_torch.copr import gpu_engine
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
LIMIT_PAST_WIDTH = 5000  # past the 4,096-row width of the short tasks' groups


def _items():
    """(reference items, port items): every spec over every region, the
    range filter once more with a LIMIT, both TopNs once more at LIMIT
    5,000, then the point aggregations."""
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
        for name in ("topn_single", "topn_multi"):
            rd, pd = REF.dag(rt, **SPECS[name]), PORT.dag(pt, **SPECS[name])
            rd.topn.n = pd.topn.n = LIMIT_PAST_WIDTH
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


SORT_MODES = ("sort_groups_tasks", "topk_tasks", "topn_multi_tasks")
SOLO = ("sort_groups", "topk", "topn_multi")


@pytest.fixture(scope="module", params=[True, False], ids=["compress_on", "compress_off"])
def runs(request):
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.tile_compression = port.tile_compression = request.param
    ref.gcap0 = port.gcap0 = 16  # the float-key GROUP BY escalates inside its group
    ritems, pitems = _items()
    counts = []
    outs = []
    calls = Counter()  # the engine's calls of the sort modes and of the solo sort kernels
    k6 = []  # (k, width) of each K6 task-mode call
    mp = pytest.MonkeyPatch()
    for name in SORT_MODES:
        mp.setattr(gpu_engine, name, lambda *a, _f=getattr(gpu_engine, name), _n=name, **kw: (
            calls.update([_n]), _n == "topk_tasks" and k6.append(a[4:6]), _f(*a, **kw))[2])
    for name in SOLO:
        mp.setattr(port, name, lambda *a, _f=getattr(port, name), _n=name, **kw: (calls.update([_n]), _f(*a, **kw))[1])
    for _ in range(2):  # the second call runs every program key warm
        c0 = (ref.compile_count, port.compile_count, port.fetches)
        outs.append((ref.execute_many(ritems), port.execute_many(pitems)))
        counts.append((ref.compile_count - c0[0], port.compile_count - c0[1], port.fetches - c0[2]))
    mp.undo()
    solo = TorchEngine(device="cpu")
    solo.tile_compression = request.param
    solo.gcap0 = 16
    return {"ref": ref, "port": port, "outs": outs, "counts": counts, "calls": calls, "k6": k6,
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


def _classes(port) -> tuple[Counter, Counter]:
    """(multi-task groups, tasks alone) per kind of program key that one
    call of the item list forms (the same partition in both calls)."""
    per_key = Counter(p.key for p in (port._plan_for(d, b) for d, b in _items()[1]) if p is not None)
    return (Counter(k[0] for k, c in per_key.items() if c > 1), Counter(k[0] for k, c in per_key.items() if c == 1))


def test_sort_and_topn_groups_run_their_task_modes(runs):
    port, calls = runs["port"], runs["calls"]
    groups, _ = _classes(port)
    assert groups["aggsort"] and groups["topn"] and groups["topn_multi"]
    # each group: one call of its mode in each of the two execute_many calls
    assert calls["sort_groups_tasks"] == 2 * groups["aggsort"]
    assert calls["topk_tasks"] == 2 * groups["topn"]
    assert calls["topn_multi_tasks"] == 2 * groups["topn_multi"]
    for key, group in port._raw.items():
        if key[0] in ("aggsort", "topn", "topn_multi"):
            assert callable(group)  # no sort or TopN key runs back to back


def test_topn_limit_past_the_width_takes_the_width(runs):
    """A LIMIT 5,000 TopN group of short tasks runs K6's task mode at
    k = width < 5,000 (the chunks are held to the reference's and to solo
    execute's above); the two-tile groups take k = 5,000."""
    assert any(k == w < LIMIT_PAST_WIDTH for k, w in runs["k6"])
    assert any(k == LIMIT_PAST_WIDTH < w for k, w in runs["k6"])
    assert all(k <= w for k, w in runs["k6"])


def test_solo_sort_kernels_run_only_for_groups_of_one(runs):
    calls = runs["calls"]
    _, alone = _classes(runs["port"])
    assert calls["sort_groups"] == 2 * alone["aggsort"]
    assert calls["topk"] == 2 * alone["topn"]
    assert calls["topn_multi"] == 2 * alone["topn_multi"]


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
def test_two_tasks_escalating_to_different_capacities_match_reference(compress):
    """Two tasks of one sort-aggregation group, ~40 and ~600 float keys
    over gcap0 = 4: the first escalates to 64, the second to 1024, in task
    order, as the reference's per-task reruns; then a warm call at the
    remembered capacity. A -0.0 in each key lane keeps it dense under
    compression (tilecache: no dict or rle for a lane holding -0.0), so
    both tasks share one program key."""
    rt, pt = REF.table(COLS), PORT.table(COLS)
    spec = dict(group_by=[COL("f")], aggs=[("count",), ("sum", COL("d")), ("min", COL("i"))])
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.tile_compression = port.tile_compression = compress
    ref.gcap0 = port.gcap0 = 4
    ritems, pitems = [], []
    for j, ndv in enumerate((40, 600)):
        data, valid = _region(3000, seed=60 + j)
        data["f"] = np.round(np.random.default_rng(j).integers(0, ndv, 3000) * 0.5, 1)
        data["f"][7], valid["f"][7] = -0.0, True
        rb, pb = _batches(data, valid, rt, pt)
        ritems.append((REF.dag(rt, **spec), rb))
        pitems.append((PORT.dag(pt, **spec), pb))
    for _ in range(2):
        c0 = (ref.compile_count, port.compile_count)
        want, got = ref.execute_many(ritems), port.execute_many(pitems)
        assert port.compile_count - c0[1] == ref.compile_count - c0[0]
        for w, g in zip(want, got):
            _assert_same_chunk(w, g)
        assert sorted(port._gcap.values()) == sorted(ref._gcap.values()) == [1024]
        assert sorted(((k[1], k[2]) for k in port._vprograms), key=repr) == \
            sorted(((k[1], k[2]) for k in ref._vprograms), key=repr)
    assert sorted(k[-1] for k in port._programs if k[0] == "aggsort") == \
        sorted(k[-1] for k in ref._programs if k[0] == "aggsort") == [4, 64, 1024]
    assert any(g == 2 for g, _ in (((k[1], k[2]) for k in port._vprograms)))
