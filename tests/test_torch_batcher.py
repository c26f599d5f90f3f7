"""The port's launch batcher, device lanes, breakers and fault triage on
the CPU.

The batcher cases of tests/test_sched.py (TestLaunchBatcher) replayed
against the port's LaunchBatcher over `TorchEngine(device="cpu")`, on the
same table t(id INT PRIMARY KEY, g INT, v INT) of 4,096 rows: coalesced
results bit-identical to serial execution, coalescing that happens, an
armed `sched/before-launch` failpoint releasing every follower with the
error, snapshot dedup; then the engine surface against the reference's
TPUEngine: tile buckets over a row-count sweep, placement and occupancy,
the breakers' open error, a CircuitBreaker driven through the same
success / failure / clock sequence, and the fault triage of the device
boundary; a grouped launch on a bound timeline, and the admission
scheduler with its resource groups.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tidb_tpu.copr import retry as ref_retry
from tidb_tpu.copr.tilecache import ColumnBatch as RefBatch
from tidb_tpu.copr.tpu_engine import TPUEngine
from tidb_tpu.errors import CircuitBreakerOpen as RefBreakerOpen

from tidb_tpu_torch.copr import retry
from tidb_tpu_torch.copr.gpu_engine import DeviceLane, TorchEngine
from tidb_tpu_torch.copr.tilecache import ColumnBatch
from tidb_tpu_torch.entry import run_burst
from tidb_tpu_torch.errors import (CircuitBreakerOpen, DeviceFatalError, DeviceTransientError,
                                   QueryInterrupted)
from tidb_tpu_torch.models import tpch
from tidb_tpu_torch.sched import LaunchBatcher
from tidb_tpu_torch.utils import metrics as M
from tidb_tpu_torch.utils.failpoint import FP

from test_torch_engine import COL, PORT, REF

T_COLS = [("id", "bigint"), ("g", "bigint"), ("v", "bigint")]


def _table_t(pkg=PORT, batch_cls=ColumnBatch):
    """test_sched.py's t: id, id % 7, id * 3 over 4,096 rows."""
    ids = np.arange(4096, dtype=np.int64)
    table = pkg.table(T_COLS)
    ones = [np.ones(4096, dtype=bool)] * 3
    return table, batch_cls(table, ids.copy(), [ids, ids % 7, ids * 3], ones, version=0)


def _pairs():
    table, batch = _table_t()
    group = PORT.dag(table, group_by=[COL("g")],
                     aggs=[("sum", COL("v")), ("min", COL("v")), ("max", COL("v")), ("count",)])
    count = PORT.dag(table, conds=[("gt", COL("v"), ("int", 600))], aggs=[("count",)])
    return [(group, batch), (count, batch)]


def _chunks_equal(a, b) -> bool:
    if a.num_cols != b.num_cols or a.num_rows != b.num_rows:
        return False
    return all(np.array_equal(ca.data, cb.data) and np.array_equal(ca.valid, cb.valid)
               for ca, cb in zip(a.columns, b.columns))


def _threads(fn, n):
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait()
        fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads), "a batcher thread was stranded"


# --- tests/test_sched.py's batcher cases, on the port ------------------------


def test_coalesced_results_bit_identical_to_serial():
    eng, batcher = TorchEngine(device="cpu"), LaunchBatcher()
    pairs = _pairs()
    serial = [eng.execute(dag, batch) for dag, batch in pairs]
    jobs = [pairs[i % len(pairs)] for i in range(len(pairs) * 3)]
    results: dict = {}
    _threads(lambda i: results.__setitem__(i, batcher.execute(eng, *jobs[i])), len(jobs))
    for i in range(len(jobs)):
        assert _chunks_equal(results[i], serial[i % len(pairs)]), f"job {i}: coalesced chunk differs"


def _batcher():
    """A LaunchBatcher whose leader waits 50 ms for followers (the
    product's 2 ms window races thread start-up on a loaded test host)."""
    b = LaunchBatcher()
    b.WINDOW_S = 0.05
    return b


def test_coalescing_actually_happens():
    eng, batcher = TorchEngine(device="cpu"), _batcher()
    dag, batch = _pairs()[0]
    # one more task in flight: no thread takes the solo bypass (a thread
    # that arrives alone on a loaded host would), every one joins a group
    batcher._inflight = 1
    for _ in range(5):  # the barrier makes coalescing near-certain; retry races
        n0, sum0 = M.SCHED_BATCH_OCCUPANCY._n, M.SCHED_BATCH_OCCUPANCY._sum
        _threads(lambda i: batcher.execute(eng, dag, batch), 4)
        groups = M.SCHED_BATCH_OCCUPANCY._n - n0
        if groups and M.SCHED_BATCH_OCCUPANCY._sum - sum0 > groups:
            return
    pytest.fail("no multi-task launch group formed in 5 attempts")


def test_failed_launch_releases_followers_with_error():
    eng, batcher = TorchEngine(device="cpu"), _batcher()
    dag, batch = _pairs()[0]
    outcomes: dict = {}
    # one more task in flight: no thread takes the solo bypass, every one
    # joins a group whose leader meets the armed failpoint
    batcher._inflight = 1

    def run(i):
        try:
            outcomes[i] = ("ok", batcher.execute(eng, dag, batch))
        except Exception as e:  # noqa: BLE001
            outcomes[i] = ("err", e)

    with FP.enabled("sched/before-launch", RuntimeError("boom")):
        t0 = time.monotonic()
        _threads(run, 4)
    assert time.monotonic() - t0 < 30
    assert len(outcomes) == 4
    for i, (kind, val) in outcomes.items():
        assert kind == "err" and isinstance(val, RuntimeError), f"member {i}: {kind} {val!r}"
    assert batcher._inflight == 1


def test_snapshot_dedup_shares_one_execution():
    eng, batcher = TorchEngine(device="cpu"), _batcher()
    dag, batch = _pairs()[0]
    stats: dict = {}
    batcher._inflight = 1  # every thread joins a group, none takes the solo bypass

    def bump(key, n=1):
        stats[key] = stats.get(key, 0) + n

    for _ in range(5):
        stats.clear()
        results = []
        _threads(lambda i: results.append(batcher.execute(eng, dag, batch, dedup_key=("k", 1), stats=bump)), 3)
        if stats.get("dedup_tasks"):
            assert all(_chunks_equal(r, results[0]) for r in results)
            return
    pytest.fail("dedup never triggered in 5 attempts")


def test_burst_of_64_point_aggregations_matches_serial():
    """run_burst over bench_sched's workload (64 tasks; 1,024 rows each
    here): every chunk equals the serial one, and a multi-task launch
    formed."""
    eng = TorchEngine(device="cpu")
    pairs = [(tpch.point_agg_dag(), b) for b in tpch.point_agg_table(64, 1024)]
    serial = [eng.execute(d, b) for d, b in pairs]
    n0, sum0 = M.SCHED_BATCH_OCCUPANCY._n, M.SCHED_BATCH_OCCUPANCY._sum
    batcher = _batcher()
    res, lat = run_burst(pairs, "cpu", eng, batcher)
    assert all(_chunks_equal(r, s) for r, s in zip(res, serial))
    assert len(lat) == 64 and min(lat) > 0
    groups = M.SCHED_BATCH_OCCUPANCY._n - n0
    assert groups and M.SCHED_BATCH_OCCUPANCY._sum - sum0 > groups
    assert batcher.serial_fallbacks == 0


def test_a_failed_group_runs_its_jobs_one_by_one_and_is_counted():
    """When execute_many raises, every job of the group still gets its own
    answer from a solo execute, and the batcher counts the fallback."""
    eng = TorchEngine(device="cpu")
    pairs = [(tpch.point_agg_dag(), b) for b in tpch.point_agg_table(4, 1024)]
    serial = [eng.execute(d, b) for d, b in pairs]

    def broken(items, lane=None):
        raise RuntimeError("grouped launch failed")

    eng.execute_many = broken
    batcher = _batcher()
    batcher._inflight = 1  # every thread joins a group, none takes the solo bypass
    results: dict = {}
    _threads(lambda i: results.__setitem__(i, batcher.execute(eng, *pairs[i])), 4)
    assert all(_chunks_equal(results[i], serial[i]) for i in range(4))
    assert batcher.serial_fallbacks >= 1


# --- the engine surface against the reference --------------------------------


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
def test_tile_bucket_and_count_match_reference(compress):
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.tile_compression = port.tile_compression = compress
    for n in (0, 1, 255, 256, 257, 1000, 4096, 4097, 65535, 65536, 65537, 70_000, 131_072, 2_097_152, 2_097_153):
        b = type("B", (), {"n_rows": n})()
        assert port.tile_bucket(b) == ref.tile_bucket(b), n
        assert port.tile_count(b) == ref.tile_count(b), n


def _lanes8(port):
    """Eight CPU lanes on the port's engine, as the reference has eight
    devices on the test mesh."""
    port._all_lanes = []
    for i in range(8):
        lane = DeviceLane(i, torch.device("cpu", i), None)
        lane.breaker = retry.CircuitBreaker(label=f"test/{lane.name}")
        port._all_lanes.append(lane)
    port.lanes = list(port._all_lanes)


def test_placement_and_occupancy_match_reference():
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    _lanes8(port)
    assert len(ref._all_lanes) == len(port._all_lanes) == 8
    _, rb = _table_t(REF, RefBatch)
    _, pb = _table_t()

    def snapshot(eng):
        return [l.occupancy for l in eng._all_lanes]

    # an unplaced burst spreads over the least-occupied lanes, in order
    rl = [ref.place(rb) for _ in range(10)]
    pl = [port.place(pb) for _ in range(10)]
    assert [l.idx for l in pl] == [l.idx for l in rl]
    assert snapshot(port) == snapshot(ref)
    for r, p in zip(rl[::2], pl[::2]):
        ref.release_lane(r)
        port.release_lane(p)
    assert snapshot(port) == snapshot(ref)
    assert [port.place(pb).idx for _ in range(3)] == [ref.place(rb).idx for _ in range(3)]
    # the width knobs
    for eng in (ref, port):
        eng.limit_lanes(3)
    assert len(port.lanes) == len(ref.lanes) == 3
    for eng in (ref, port):
        eng.limit_lanes(5)  # never widens
    assert len(port.lanes) == len(ref.lanes) == 3
    for eng in (ref, port):
        eng.set_active_lanes(0)
    assert len(port.lanes) == len(ref.lanes) == 8
    # weighted placement: a slow lane yields to a healthy sibling
    for eng, lanes in ((ref, ref._all_lanes), (port, port._all_lanes)):
        for l in lanes:
            eng.note_lane(l, 1.0)
        eng.note_lane(lanes[0], 50.0, ok=False)
    assert [l.ewma_ms for l in port._all_lanes] == [l.ewma_ms for l in ref._all_lanes]
    assert port.place(pb, weighted=True).idx == ref.place(rb, weighted=True).idx


def test_residency_keeps_a_batch_on_its_lane():
    port = TorchEngine(device="cpu")
    _lanes8(port)
    dag, batch = _pairs()[0]
    lane = port._all_lanes[5]
    port.execute(dag, batch, lane=lane)
    assert port.place(batch).idx == 5
    other = _table_t()[1]
    assert port.place(other).idx != 5 or port._all_lanes[5].occupancy > 1


def test_breakers_open_error_matches_reference():
    ref, port = TPUEngine(), TorchEngine(device="cpu")
    ref.limit_lanes(1)
    for eng in (ref, port):
        for _ in range(eng.breaker.threshold):
            eng.breaker.record_failure()
    with pytest.raises(RefBreakerOpen) as want:
        ref.raise_breakers_open()
    with pytest.raises(CircuitBreakerOpen) as got:
        port.raise_breakers_open()
    assert str(got.value) == str(want.value)
    assert got.value.code == want.value.code == 9015
    # and at every lane of a wider engine
    _lanes8(port)
    for l in port.lanes:
        for _ in range(l.breaker.threshold):
            l.breaker.record_failure()
    assert port.place(_pairs()[0][1], gate_breakers=True) is None
    with pytest.raises(CircuitBreakerOpen, match="every device lane's circuit breaker"):
        port.raise_breakers_open()


def test_circuit_breaker_follows_the_reference_through_one_sequence():
    now = {"t": 0.0}
    clock = lambda: now["t"]  # noqa: E731
    ref = ref_retry.CircuitBreaker(threshold=3, cooldown_s=10.0, clock=clock, label="ref")
    port = retry.CircuitBreaker(threshold=3, cooldown_s=10.0, clock=clock, label="port")
    e1, e2 = RuntimeError("a"), RuntimeError("b")
    steps = [("fail", e1), ("fail", e1), ("success", None), ("fail", None), ("fail", None), ("fail", e2),
             ("allow", None), ("tick", 11.0), ("allow", None), ("allow", None), ("fail", None), ("allow", None),
             ("tick", 10.5), ("allow", None), ("aborted", None), ("allow", None), ("success", None),
             ("allow", None), ("fail", e1)]
    for op, arg in steps:
        if op == "tick":
            now["t"] += arg
            continue
        outs = []
        for b in (ref, port):
            if op == "fail":
                outs.append(b.record_failure(arg))
            elif op == "success":
                outs.append(b.record_success())
            elif op == "aborted":
                outs.append(b.record_aborted())
            else:
                outs.append(b.allow())
        assert outs[0] == outs[1], (op, outs)
        assert (port.state, port.trips, port._consecutive) == (ref.state, ref.trips, ref._consecutive)
        assert port.describe() == ref.describe()


def test_classify_passes_typed_device_errors_through():
    t, f = DeviceTransientError("busy"), DeviceFatalError("crashed")
    assert retry.classify_device_error(t) is t
    assert retry.classify_device_error(f) is f
    assert retry.classify_device_error(QueryInterrupted("killed")) is None
    assert isinstance(retry.classify_device_error(RuntimeError("UNAVAILABLE: tunnel")), DeviceTransientError)
    assert isinstance(retry.classify_device_error(RuntimeError("bad kernel")), DeviceFatalError)


def test_device_boundary_types_the_cards_faults():
    with pytest.raises(DeviceTransientError, match="OutOfMemoryError"):
        with retry.device_boundary(on_card=True):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    with pytest.raises(DeviceFatalError, match="cudaError 700"):
        with retry.device_boundary(on_card=True):
            raise RuntimeError("seg_agg: kernel launch failed (cudaError 700)")
    with pytest.raises(RuntimeError, match="plain"):  # on the CPU a bug stays a bug
        with retry.device_boundary(on_card=False):
            raise RuntimeError("plain")
    with pytest.raises(QueryInterrupted):
        with retry.device_boundary(on_card=True):
            raise QueryInterrupted("killed")
    # a typed error from the boundary feeds a breaker as a fault, once
    b = retry.CircuitBreaker(threshold=1, label="boundary")
    try:
        with retry.device_boundary(on_card=True):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
    except DeviceFatalError as e:
        assert retry.classify_device_error(e) is e
        assert b.record_failure(e) and b.state == "open"


def test_a_grouped_launch_lands_on_the_bound_timeline():
    """With a timeline ring bound to the submitting threads, a coalesced
    launch records one `cop.launch` event on the lane (occupancy > 1 for
    a group) and the enqueue / leader-elected lifecycle on the group
    lanes, as the reference's batcher does."""
    from tidb_tpu_torch.utils import timeline as TL

    eng, batcher = TorchEngine(device="cpu"), _batcher()
    dag, batch = _pairs()[0]
    ring = TL.TimelineRing()
    for _ in range(5):
        ring.clear()

        def run(i):
            with TL.bind(ring, "rg"):
                batcher.execute(eng, dag, batch)

        _threads(run, 4)
        events = ring.snapshot()
        launches = [e for e in events if e.name == "cop.launch"]
        if any(e.args.get("occupancy", 1) > 1 for e in launches):
            names = {e.name for e in events}
            assert {"launch.enqueue", "launch.leader_elected", "launch.fanout"} <= names
            assert all(e.lane == "cpu:0" for e in launches)
            return
    pytest.fail("no grouped launch reached the timeline in 5 attempts")


def test_admission_scheduler_and_resource_groups():
    """The scheduler the engine's placement reads (running / queue depth)
    and its groups: admission, release, the queue's hard edge, and the
    resource-group DDL errors with the reference's codes."""
    from tidb_tpu_torch.errors import ResourceGroupExists, ResourceGroupNotExists, ResourceGroupQueueFull
    from tidb_tpu_torch.sched import AdmissionScheduler, ResourceGroupManager, SchedCtx

    groups = ResourceGroupManager()
    groups.create("rg1", {"ru_per_sec": 1000, "priority": "HIGH"})
    with pytest.raises(ResourceGroupExists) as e:
        groups.create("rg1", {})
    assert e.value.code == 8248
    groups.alter("rg1", {"priority": "LOW"})
    assert groups.get("RG1").priority == "LOW" and groups.get("nope").name == "default"
    sched = AdmissionScheduler(groups, max_concurrency=1)
    sched.MAX_QUEUE = 0
    t = sched.acquire(SchedCtx(group="rg1"))
    assert sched.running() == 1 and sched.queue_depth() == 0
    with pytest.raises(ResourceGroupQueueFull) as e:
        sched.acquire(SchedCtx(group="rg1"))
    assert e.value.code == 8252
    sched.release(t, ru=2.5)
    assert sched.running() == 0
    assert M.RU_CONSUMED.value(group="rg1") >= 2.5
    groups.drop("rg1")
    with pytest.raises(ResourceGroupNotExists) as e:
        groups.drop("rg1")
    assert e.value.code == 8249
