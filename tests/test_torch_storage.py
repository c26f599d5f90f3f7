"""The port's in-memory store (tidb_tpu_torch/storage) against the reference's.

The reference's own storage cases (tests/test_storage.py: MemKV, MVCC
prewrite / commit / rollback / delete versions and scans, 2PC visibility,
optimistic conflicts, membuffer merges, lock resolution, GC, region split
and locate) run over both packages. Then seeded sequences of transactions
— puts, deletes, reads, scans, commits, rollbacks, interleaved writers
that conflict, pessimistic locks, bulk ingests under them — run on a
store of each package side by side: every read, scan and error class is
the same, and so is every table's data version after each commit. The
durable store's arguments and the services of later slices raise
NotPortedError.
"""

import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("tidb_tpu", "tidb_tpu_torch")


def _pkg(root):
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    st = m("storage")
    return SimpleNamespace(E=m("errors"), MemKV=st.MemKV, Storage=st.Storage, RegionMap=st.RegionMap,
                           mvcc=m("storage.mvcc"), tc=m("codec.tablecodec"))


@pytest.fixture(params=PKGS)
def P(request):
    return _pkg(request.param)


# --- the reference's cases, over both packages --------------------------------


def test_memkv_basic(P):
    kv = P.MemKV()
    kv.put(b"b", b"2")
    kv.put(b"a", b"1")
    kv.put(b"c", b"3")
    assert kv.get(b"b") == b"2"
    assert [k for k, _ in kv.scan(b"a", b"c")] == [b"a", b"b"]
    kv.delete(b"b")
    assert kv.get(b"b") is None
    assert len(kv) == 2


def test_memkv_delete_range(P):
    kv = P.MemKV()
    for i in range(10):
        kv.put(bytes([i]), b"v")
    assert kv.delete_range(bytes([2]), bytes([5])) == 3
    assert len(kv) == 7


def test_mvcc_prewrite_commit_get(P):
    s = P.Storage()
    t1 = s.begin()
    mv = s.mvcc
    mv.prewrite([P.mvcc.Mutation(P.mvcc.OP_PUT, b"k1", b"v1")], b"k1", t1.start_ts)
    with pytest.raises(P.E.LockedError):
        mv.get(b"k1", s.tso.next())
    assert mv.get(b"k1", t1.start_ts - 1) is None
    cts = s.tso.next()
    mv.commit([b"k1"], t1.start_ts, cts)
    assert mv.get(b"k1", s.tso.next()) == b"v1"
    assert mv.get(b"k1", cts - 1) is None


def test_mvcc_write_conflict(P):
    s = P.Storage()
    t1, t2 = s.begin(), s.begin()
    s.mvcc.prewrite([P.mvcc.Mutation(P.mvcc.OP_PUT, b"k", b"a")], b"k", t2.start_ts)
    s.mvcc.commit([b"k"], t2.start_ts, s.tso.next())
    with pytest.raises(P.E.WriteConflict):
        s.mvcc.prewrite([P.mvcc.Mutation(P.mvcc.OP_PUT, b"k", b"b")], b"k", t1.start_ts)


def test_mvcc_rollback_blocks_late_prewrite(P):
    s = P.Storage()
    t = s.begin()
    s.mvcc.rollback([b"k"], t.start_ts)
    with pytest.raises(P.E.TxnAborted):
        s.mvcc.prewrite([P.mvcc.Mutation(P.mvcc.OP_PUT, b"k", b"v")], b"k", t.start_ts)


def test_mvcc_delete_version(P):
    s = P.Storage()
    M = P.mvcc
    t1 = s.begin()
    s.mvcc.prewrite([M.Mutation(M.OP_PUT, b"k", b"v")], b"k", t1.start_ts)
    c1 = s.tso.next()
    s.mvcc.commit([b"k"], t1.start_ts, c1)
    t2 = s.begin()
    s.mvcc.prewrite([M.Mutation(M.OP_DEL, b"k")], b"k", t2.start_ts)
    c2 = s.tso.next()
    s.mvcc.commit([b"k"], t2.start_ts, c2)
    assert s.mvcc.get(b"k", s.tso.next()) is None
    assert s.mvcc.get(b"k", c2 - 1) == b"v"


def test_mvcc_scan_versions(P):
    s = P.Storage()
    M = P.mvcc
    for i in range(5):
        t = s.begin()
        s.mvcc.prewrite([M.Mutation(M.OP_PUT, b"k%d" % i, b"v%d" % i)], b"k%d" % i, t.start_ts)
        s.mvcc.commit([b"k%d" % i], t.start_ts, s.tso.next())
    t = s.begin()
    s.mvcc.prewrite([M.Mutation(M.OP_DEL, b"k2")], b"k2", t.start_ts)
    s.mvcc.commit([b"k2"], t.start_ts, s.tso.next())
    got = s.mvcc.scan(b"k0", b"k9", s.tso.next())
    assert [k for k, _ in got] == [b"k0", b"k1", b"k3", b"k4"]
    assert got[0][1] == b"v0"


def test_txn_commit_visibility(P):
    s = P.Storage()
    t1 = s.begin()
    t1.put(b"a", b"1")
    t1.put(b"b", b"2")
    assert t1.get(b"a") == b"1"
    t2 = s.begin()
    t1.commit()
    assert t2.get(b"a") is None
    assert s.begin().get(b"a") == b"1"


def test_txn_optimistic_conflict(P):
    s = P.Storage()
    t1, t2 = s.begin(), s.begin()
    t1.put(b"k", b"from-t1")
    t2.put(b"k", b"from-t2")
    t2.commit()
    with pytest.raises((P.E.WriteConflict, P.E.TxnAborted)):
        t1.commit()
    assert s.snapshot().get(b"k") == b"from-t2"


def test_txn_delete_and_scan_membuf_merge(P):
    s = P.Storage()
    t = s.begin()
    t.put(b"a", b"1")
    t.put(b"c", b"3")
    t.commit()
    t2 = s.begin()
    t2.delete(b"a")
    t2.put(b"b", b"2")
    assert [k for k, _ in t2.scan(b"a", b"z")] == [b"b", b"c"]
    t2.commit()
    assert [k for k, _ in s.begin().scan(b"a", b"z")] == [b"b", b"c"]


def test_txn_resolve_crashed_txn(P):
    s = P.Storage()
    dead_ts = s.tso.next()
    s.mvcc.prewrite([P.mvcc.Mutation(P.mvcc.OP_PUT, b"k", b"v")], b"k", dead_ts, ttl_ms=0)
    assert s.snapshot().get(b"k") is None  # resolves (rolls back) the dead lock


def test_txn_commit_idempotent_after_resolver_rolled_forward(P):
    s = P.Storage()
    M = P.mvcc
    ty = s.begin()
    s.mvcc.prewrite([M.Mutation(M.OP_PUT, b"p", b"vp"), M.Mutation(M.OP_PUT, b"s", b"vs")], b"p", ty.start_ts)
    cts = s.tso.next()
    s.mvcc.commit([b"p"], ty.start_ts, cts)
    lock = M.Lock.decode(s.kv.get(b"l" + b"s"))
    assert s.mvcc.resolve_lock(b"s", lock, now_ms=0)
    tx = s.begin()
    s.mvcc.prewrite([M.Mutation(M.OP_PUT, b"s", b"vx")], b"s", tx.start_ts)
    s.mvcc.commit([b"s"], ty.start_ts, cts)
    assert s.mvcc.get(b"s", cts) == b"vs"
    s.mvcc.commit([b"s"], tx.start_ts, s.tso.next())
    assert s.mvcc.get(b"s", s.tso.next()) == b"vx"


def test_txn_live_lock_not_stolen_after_ttl(P):
    s = P.Storage()
    t = s.begin()
    s.mvcc.prewrite([P.mvcc.Mutation(P.mvcc.OP_PUT, b"k", b"v")], b"k", t.start_ts, ttl_ms=0)
    lock = P.mvcc.Lock.decode(s.kv.get(b"l" + b"k"))
    assert not s.mvcc.resolve_lock(b"k", lock, int(time.time() * 1000) + 60_000)
    assert s.kv.get(b"l" + b"k") is not None
    s.mvcc.commit([b"k"], t.start_ts, s.tso.next())
    t.rollback()
    assert s.mvcc.get(b"k", s.tso.next()) == b"v"


def test_txn_gc(P):
    s = P.Storage()
    for i in range(3):
        t = s.begin()
        t.put(b"k", b"v%d" % i)
        t.commit()
    assert s.gc(s.tso.next()) > 0
    assert s.snapshot().get(b"k") == b"v2"


def test_regions_split_and_locate(P):
    rm = P.RegionMap()
    rm.split(b"m")
    assert rm.locate(b"a").id == 1
    assert rm.locate(b"z").start == b"m"
    rm.split_many([b"f", b"t"])
    assert len(rm.regions) == 4


def test_regions_split_ranges(P):
    rm = P.RegionMap()
    rm.split_many([b"d", b"m", b"t"])
    assert [(s, e) for _, s, e in rm.split_ranges(b"b", b"p")] == [(b"b", b"d"), (b"d", b"m"), (b"m", b"p")]
    assert len(rm.split_ranges(b"", b"")) == 4


def test_pessimistic_deadlock_is_detected(P):
    """Two pessimistic txns lock a key each, then wait on each other's:
    the later waiter gets DeadlockError; the first keeps its locks."""
    s = P.Storage()
    t1, t2 = s.begin(pessimistic=True), s.begin(pessimistic=True)
    t1.lock_keys_for_update([b"a"])
    t2.lock_keys_for_update([b"b"])
    s.detector.register(t1.start_ts, t2.start_ts)  # t1 waits on t2 (as a blocked lock_keys_for_update records)
    with pytest.raises(P.E.DeadlockError):
        t2.lock_keys_for_update([b"a"])
    s.detector.done(t1.start_ts)
    t2.rollback()
    t1.put(b"a", b"1")
    t1.commit()
    assert s.snapshot().get(b"a") == b"1"


def test_ingest_runs_split_regions_and_shadow_by_commit_ts(P):
    """mvcc.ingest of fixed-width pairs: the split hook cuts the regions
    at every region_split_size-th key; a later txn write shadows the run's
    entry, a txn delete hides it, and scan / scan_segments agree."""
    s = P.Storage()
    s.region_split_size = 64
    tc = P.tc
    kvs = [(tc.record_key(5, h), b"row%d" % h) for h in range(1, 301)]
    s.mvcc.ingest(kvs, s.tso.next())
    assert [r.start for r in s.regions.regions[1:]] == [tc.record_key(5, 1 + 64 * i) for i in (1, 2, 3, 4)]
    t = s.begin()
    t.put(tc.record_key(5, 10), b"new")
    t.delete(tc.record_key(5, 20))
    t.commit()
    got = s.snapshot().scan(tc.record_prefix(5), tc.record_prefix(6))
    assert len(got) == 299 and dict(got)[tc.record_key(5, 10)] == b"new"
    segs, loose = s.snapshot().scan_segments(tc.record_prefix(5), tc.record_prefix(6))
    assert sum(x.n_rows for x in segs) == 298 and loose == [(tc.record_key(5, 10), b"new")]


# --- seeded transaction sequences, both stores side by side ------------------


def _run_sequence(seed: int, root: str) -> list:
    """A seeded mix of transactions over three tables' record keys →
    the log of every observable outcome (reads, scans, error classes,
    data versions after each commit)."""
    P = _pkg(root)
    rng = np.random.default_rng(seed)
    s = P.Storage()
    s.region_split_size = 16
    tc = P.tc
    log = []
    if seed % 2:  # half the sequences start over a bulk-ingested run
        s.mvcc.ingest([(tc.record_key(2, h), b"bulk%d" % h) for h in range(40)], s.tso.next())
        s.bump_version([tc.record_prefix(2)])
    key = lambda: tc.record_key(int(rng.integers(1, 4)), int(rng.integers(0, 40)))  # noqa: E731
    live = []
    for step in range(60):
        op = rng.random()
        if op < 0.35 or not live:
            live.append(s.begin(pessimistic=bool(rng.random() < 0.3)))
            t = live[-1]
            for _ in range(int(rng.integers(1, 5))):
                k = key()
                if t.pessimistic and rng.random() < 0.5:
                    try:
                        t.lock_keys_for_update([k])
                        log.append(("lock", step))
                    except P.E.TiDBError as e:
                        log.append(("lock-err", step, type(e).__name__))
                if rng.random() < 0.25:
                    t.delete(k)
                else:
                    t.put(k, b"v%d-%d" % (seed, step))
            log.append(("read", step, t.get(key())))
        elif op < 0.8:
            t = live.pop(int(rng.integers(0, len(live))))
            if rng.random() < 0.15:
                t.rollback()
                log.append(("rollback", step))
                continue
            try:
                t.commit()
                log.append(("commit", step, tuple(s.data_version(tc.table_prefix(i))[0] for i in (1, 2, 3))))
            except P.E.TiDBError as e:
                log.append(("commit-err", step, type(e).__name__))
        else:
            lo = int(rng.integers(1, 4))
            snap = s.snapshot()
            log.append(("scan", step, snap.scan(tc.record_prefix(lo), tc.record_prefix(lo + 1))))
            log.append(("get", step, snap.get(key())))
    for t in live:
        t.rollback()
    log.append(("final", s.snapshot().scan(b"t", b"u"), [(r.start, r.end) for r in s.regions.regions]))
    return log


@pytest.mark.parametrize("seed", range(8))
def test_a_seeded_transaction_sequence_reads_the_same_on_both_stores(seed):
    want, got = _run_sequence(seed, "tidb_tpu"), _run_sequence(seed, "tidb_tpu_torch")
    assert got == want
    assert any(x[0] == "commit" for x in got)


# --- what this slice leaves for later ----------------------------------------


def test_the_durable_store_and_later_services_raise_not_ported():
    from tidb_tpu_torch.errors import NotPortedError
    from tidb_tpu_torch.storage import Storage

    for kw in ({"data_dir": "x"}, {"standby": True}, {"spare_dirs": ["x"]}, {"wal_recovery_mode": "absolute"}):
        with pytest.raises(NotPortedError, match="durable store"):
            Storage(**kw)
    s = Storage()
    for name in ("ddl", "mem", "sched", "build_cache", "workload", "gc_worker", "compactor", "plugins",
                 "shipper", "trace_ring"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            getattr(s, name)
    from tidb_tpu_torch.statistics.handle import StatsHandle
    from tidb_tpu_torch.utils.stmtstats import StmtStats

    assert isinstance(s.stats, StatsHandle) and s.stats is s.stats
    assert isinstance(s.stmt_stats, StmtStats) and s.stmt_stats is s.stmt_stats
    for call in (s.checkpoint, s.promote, s.rejoin):
        with pytest.raises(NotPortedError):
            call()
    assert s.wal is None and not s.io_degraded and s.timeline is s.timeline
