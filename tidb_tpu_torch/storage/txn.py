"""Storage facade + transaction client (copy of tidb_tpu/storage/txn.py, in
memory; ref: kv/kv.go Storage/Transaction interfaces; the 2PC flow
re-implements what tikv client-go provides).

A `Storage` owns the MVCC store, TSO, and region map, and hands out
`Snapshot`s and `Txn`s. `Txn` buffers writes in a membuffer and commits
via percolator 2PC: prewrite all keys (primary first in the mutation
order), fetch commit_ts, commit primary, then secondaries — with
lock-resolution retries (ref: unistore tikv/server.go:331,353 semantics).

The port's store lives in memory. The durable store (the WAL, its
snapshots and recovery modes, warm standbys and their shipping, spare
media, the delta-main compactor and the GC worker) is a later slice, and
so are the store's services that hang off other front-door modules (the
online-DDL worker, the memory arbiter, the resource controller, the MPP
build-side cache, the workload history, plugins, the trace ring): each
such argument, property or method raises NotPortedError (a
NotImplementedError) naming the slice that brings it. The stats handle
(statistics/handle.py) and the statement stats (utils/stmtstats.py) are
the reference's.
"""

from __future__ import annotations

import logging
import time
from threading import Lock

log = logging.getLogger(__name__)

from ..errors import (
    DeadlockError,
    LockedError,
    NotPortedError,
    RetryableError,
    TxnAborted,
    WriteConflict,
)
from ..utils.failpoint import inject as _fp
from .memkv import MemKV
from .mvcc import MVCCStore, Mutation, OP_DEL, OP_LOCK, OP_PUT
from .regions import RegionMap
from .tso import TSO

TOMBSTONE = b"\x00__del__"

# the later slices a Storage argument, property or method outside this one needs
DURABLE = "the durable store (storage/wal.py, ship.py, compact.py, gcworker.py)"
FRONT_DOOR = "the SQL front door's later slices (ROADMAP Queue 1, item 4)"


class Snapshot:
    def __init__(self, store: "Storage", read_ts: int):
        self.store = store
        self.read_ts = read_ts

    def get(self, key: bytes) -> bytes | None:
        return self._with_resolve(lambda: self.store.mvcc.get(key, self.read_ts))

    def batch_get(self, keys: list[bytes]) -> dict[bytes, bytes]:
        return self._with_resolve(lambda: self.store.mvcc.batch_get(keys, self.read_ts))

    def scan(self, start: bytes, end: bytes, limit: int | None = None):
        return self._with_resolve(lambda: self.store.mvcc.scan(start, end, self.read_ts, limit))

    def scan_segments(self, start: bytes, end: bytes):
        """Zero-materialization scan → (segments, loose pairs); the columnar
        decode path (copr/tilecache.py) gathers straight from run buffers."""
        return self._with_resolve(lambda: self.store.mvcc.scan_segments(start, end, self.read_ts))

    RESOLVE_DEADLINE_S = 8.0  # > lock TTL: orphan locks must expire within this

    def _with_resolve(self, fn):
        """Reads resolve blocking locks via the primary (client-go
        behavior). Deadline-based: an orphaned prewrite lock only becomes
        resolvable once its TTL expires, so the wait must outlive the TTL
        (ref: Backoffer maxSleep in store/copr)."""
        backoff = 0.002
        deadline = time.time() + self.RESOLVE_DEADLINE_S
        while True:
            try:
                return fn()
            except LockedError as e:
                # deadline bounds BOTH outcomes: a stream of resolvable
                # locks must not spin a reader forever either
                if time.time() > deadline:
                    raise RetryableError("could not resolve locks for read") from e
                now_ms = int(time.time() * 1000)
                if not self.store.mvcc.resolve_lock(e.key, e.lock, now_ms):
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 0.25)


class Txn:
    """Buffered transaction: optimistic by default; with pessimistic=True,
    DML acquires pessimistic locks at statement time via lock_keys_for_update
    (ref: client-go pessimistic txns + unistore KvPessimisticLock)."""

    LOCK_WAIT_S = 3.0  # innodb_lock_wait_timeout analog (shortened)

    def __init__(self, store: "Storage", start_ts: int, pessimistic: bool = False):
        self.store = store
        self.start_ts = start_ts
        self.membuf: dict[bytes, bytes] = {}  # TOMBSTONE value = delete
        self.snapshot = Snapshot(store, start_ts)
        self.committed = False
        self.commit_ts = 0
        self._locked_keys: set[bytes] = set()
        self.pessimistic = pessimistic
        self.for_update_ts = start_ts
        self._pess_keys: set[bytes] = set()
        self._pess_primary: bytes | None = None
        store._txn_started(start_ts)

    def lock_keys_for_update(self, keys) -> None:
        """Pessimistic DML lock acquisition with deadlock detection and a
        lock-wait timeout; optimistic txns record the keys for commit-time
        locking (SELECT FOR UPDATE semantics)."""
        keys = sorted(set(keys) - self._pess_keys)
        if not keys:
            return
        if not self.pessimistic:
            self._locked_keys.update(keys)
            return
        mvcc = self.store.mvcc
        # the primary is only PINNED once an acquisition succeeds — a
        # never-locked primary would read as rolled_back to waiters, who
        # would then steal our live locks
        primary = self._pess_primary if self._pess_primary is not None else keys[0]
        deadline = time.time() + self.LOCK_WAIT_S
        backoff = 0.002
        while True:
            self.for_update_ts = self.store.tso.next()
            try:
                mvcc.acquire_pessimistic_lock(keys, primary, self.start_ts, self.for_update_ts)
                self.store.detector.done(self.start_ts)
                if self._pess_primary is None:
                    self._pess_primary = primary
                self._pess_keys.update(keys)
                self._locked_keys.update(keys)
                return
            except LockedError as e:
                try:
                    # raises DeadlockError when this edge closes a cycle
                    self.store.detector.register(self.start_ts, e.lock.start_ts)
                except DeadlockError:
                    self.store.detector.done(self.start_ts)
                    raise
                now_ms = int(time.time() * 1000)
                if not mvcc.resolve_lock(e.key, e.lock, now_ms):
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 0.05)
                if time.time() > deadline:
                    self.store.detector.done(self.start_ts)
                    raise RetryableError("pessimistic lock wait timeout")
            except WriteConflict:
                # a commit landed after our for_update_ts: take a fresh one
                # (bounded by the same lock-wait deadline)
                if time.time() > deadline:
                    self.store.detector.done(self.start_ts)
                    raise RetryableError("pessimistic lock kept conflicting")
                time.sleep(backoff)
                backoff = min(backoff * 2, 0.05)

    # --- reads see own writes ---------------------------------------------

    def get(self, key: bytes) -> bytes | None:
        if key in self.membuf:
            v = self.membuf[key]
            return None if v == TOMBSTONE else v
        return self.snapshot.get(key)

    def batch_get(self, keys: list[bytes]) -> dict[bytes, bytes]:
        out = {}
        missing = []
        for k in keys:
            if k in self.membuf:
                if self.membuf[k] != TOMBSTONE:
                    out[k] = self.membuf[k]
            else:
                missing.append(k)
        out.update(self.snapshot.batch_get(missing))
        return out

    def scan(self, start: bytes, end: bytes, limit: int | None = None):
        """Merge membuffer over snapshot (the UnionScan semantic,
        ref: executor/union_scan.go)."""
        return self._scan_with(self.snapshot, start, end, limit)

    def scan_current(self, start: bytes, end: bytes, limit: int | None = None):
        """Pessimistic current read: scan at a FRESH for_update_ts so
        commits after start_ts are visible (ref: client-go for_update_ts
        statement reads), still merged under the membuffer."""
        self.for_update_ts = self.store.tso.next()
        return self._scan_with(Snapshot(self.store, self.for_update_ts), start, end, limit)

    def _scan_with(self, snapshot: Snapshot, start: bytes, end: bytes, limit: int | None):
        dirty = sorted(
            (k, v) for k, v in self.membuf.items() if start <= k and (not end or k < end)
        )
        # deletes can shrink the snapshot below the limit: fetch unlimited
        # when dirty keys overlap, then clip after the merge
        snap = snapshot.scan(start, end, None if dirty else limit)
        if not dirty:
            return snap
        merged: dict[bytes, bytes] = dict(snap)
        for k, v in dirty:
            if v == TOMBSTONE:
                merged.pop(k, None)
            else:
                merged[k] = v
        out = sorted(merged.items())
        return out[:limit] if limit is not None else out

    # --- writes ------------------------------------------------------------

    def put(self, key: bytes, value: bytes) -> None:
        self.membuf[key] = value

    def delete(self, key: bytes) -> None:
        self.membuf[key] = TOMBSTONE

    def lock_key(self, key: bytes) -> None:
        """SELECT ... FOR UPDATE: lock without writing."""
        self._locked_keys.add(key)

    @property
    def size(self) -> int:
        return sum(len(k) + len(v) for k, v in self.membuf.items())

    # --- 2PC ---------------------------------------------------------------

    def commit(self) -> int:
        if self.committed:
            raise TxnAborted("transaction already committed")
        if not self.membuf and not self._locked_keys and not self._pess_keys:
            self.committed = True
            self.store._txn_done(self.start_ts)
            return self.start_ts
        muts = []
        for k, v in self.membuf.items():
            if v == TOMBSTONE:
                muts.append(Mutation(OP_DEL, k))
            else:
                muts.append(Mutation(OP_PUT, k, v))
        locked = self._locked_keys | self._pess_keys
        # _pess_keys beyond _locked_keys = locks taken by statements that
        # later failed (the statement savepoint restores _locked_keys
        # only); committing them as lock-only mutations both releases the
        # physical lock and leaves a commit record for resolvers
        for k in locked:
            if k not in self.membuf:
                muts.append(Mutation(OP_LOCK, k))
        muts.sort(key=lambda m: m.key)
        primary = muts[0].key
        mvcc = self.store.mvcc

        if self.pessimistic and self._pess_primary is not None:
            # keys were locked under this primary; keep resolve paths valid
            primary = self._pess_primary

        # phase 1: prewrite with lock-resolution retry
        _fp("txn/before-prewrite")
        backoff = 0.002
        fut = self.for_update_ts if self.pessimistic else 0
        for attempt in range(12):
            try:
                mvcc.prewrite(
                    muts, primary, self.start_ts, ttl_ms=3000, for_update_ts=fut,
                    pess_keys=frozenset(self._pess_keys),
                )
                break
            except LockedError as e:
                now_ms = int(time.time() * 1000)
                if not mvcc.resolve_lock(e.key, e.lock, now_ms):
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 0.1)
            except (WriteConflict, TxnAborted):
                # partially-prewritten locks must not linger for their TTL;
                # the txn is dead — release its start_ts or it pins the GC
                # safepoint for the whole leak horizon
                mvcc.rollback([m.key for m in muts], self.start_ts)
                self.store._txn_done(self.start_ts)
                raise
        else:
            mvcc.rollback([m.key for m in muts], self.start_ts)
            self.store._txn_done(self.start_ts)
            raise RetryableError("prewrite kept hitting live locks")

        # phase 2
        _fp("txn/commit-after-prewrite")
        # crashpoint: prewrite locks appended (possibly flushed), primary
        # commit record not — recovery must leave resolvable orphan locks
        _fp("txn/between-prewrite-and-commit")
        self.commit_ts = self.store.tso.next()
        try:
            mvcc.commit([primary], self.start_ts, self.commit_ts)
        except TxnAborted:
            mvcc.rollback([m.key for m in muts], self.start_ts)
            self.store._txn_done(self.start_ts)
            raise
        _fp("txn/commit-after-primary")
        secondaries = [m.key for m in muts if m.key != primary]
        if secondaries:
            mvcc.commit(secondaries, self.start_ts, self.commit_ts)
        self.committed = True
        self.store._txn_done(self.start_ts)
        self.store.bump_version([m.key for m in muts])
        # change feed: the txn is committed (primary committed); a
        # post-commit hook must never turn a durable commit into an
        # error (ref: binlog.go commit hook)
        cdc = getattr(self.store, "cdc", None)
        if cdc is not None and cdc.active:
            try:
                cdc.publish(self.start_ts, self.commit_ts, muts)
            except Exception:  # noqa: BLE001
                log.exception("change-feed sink failed post-commit (dropped)")
        return self.commit_ts

    def rollback(self) -> None:
        if self._pess_keys:
            self.store.mvcc.pessimistic_rollback(sorted(self._pess_keys), self.start_ts)
            self._pess_keys.clear()
        self.store.detector.done(self.start_ts)
        self.membuf.clear()
        self._locked_keys.clear()
        self.committed = True
        self.store._txn_done(self.start_ts)


class Storage:
    """The kv.Storage of the framework: MVCC + TSO + regions + versions,
    in memory (the durable store is a later slice: `data_dir`,
    `wal_recovery_mode`, `standby` and `spare_dirs` raise NotPortedError)."""

    def __init__(self, data_dir: str | None = None, wal_recovery_mode: str | None = None,
                 standby: bool = False, spare_dirs: list[str] | None = None):
        if data_dir is not None or wal_recovery_mode is not None or standby or spare_dirs:
            raise NotPortedError("storage/txn.py Storage(data_dir, wal_recovery_mode, standby, spare_dirs)",
                                 f"comes with {DURABLE}")
        self.standby = False
        self.wal = None  # no journal: the store lives in memory
        self.data_dir = None
        self.kv = MemKV()
        self.mvcc = MVCCStore(self.kv)
        self.mvcc.txn_live = self.txn_is_active
        self.tso = TSO()
        # SET GLOBAL overrides: seed new sessions, serve @@global.x reads
        self.global_vars: dict[str, str] = {}
        # commit-time change feed (ref: cdclog/binlog hooks) — inert
        # until a sink subscribes
        from ..cdc import ChangeFeed

        self.cdc = ChangeFeed()
        # distinguishes stores in process-wide caches (table ids restart
        # per store, so (table_id, version) alone is ambiguous)
        import uuid as _uuid

        self.store_uid = _uuid.uuid4().hex[:16]
        self.start_time = time.time()  # cluster_info uptime
        self.regions = RegionMap()
        # auto-split: regions split when a bulk ingest lands more than
        # this many keys (PD's size-based split policy analog; ref:
        # unistore cluster.go region management + executor/split.go).
        # Sized like the reference's 96MB regions (~2M short rows): each
        # cop task pays a device launch + fetch round trip, so undersized
        # regions tax warm queries for no parallelism
        self.region_split_size = 1 << 21
        self.mvcc.split_hook = self._auto_split_run
        # bulk-ingest windows: table_id → active window count (the
        # ingest/DDL exclusion contract — see br/ingest.BulkIngest); the
        # lock guards ONLY this dict. RLock: a GC-triggered
        # BulkIngest.__del__ finalizer may fire while the owning thread is
        # INSIDE the registry — a plain Lock would self-deadlock
        from threading import RLock as _IngestRLock

        self._ingest_lock = _IngestRLock()
        self._ingesting: dict[int, int] = {}
        # pessimistic-lock wait-for graph (ref: unistore tikv/detector.go)
        from .detector import DeadlockDetector

        self.detector = DeadlockDetector()
        # active-txn registry: GC clamps its safepoint to the oldest live
        # start_ts so long transactions keep their snapshot readable
        # (ref: store/gcworker/gc_worker.go:397 min-start-ts calculation)
        self._active_starts: dict[int, float] = {}
        self._active_lock = Lock()
        import threading as _threading

        self._processes: dict = {}
        self._proc_lock = _threading.Lock()
        # table-prefix data-version counters: the tile cache (TiFlash-
        # columnar-replica analog) invalidates on these.
        self._versions: dict[bytes, int] = {}

    @property
    def io_degraded(self) -> bool:
        return False  # no journal to fail: an in-memory store never degrades

    def check_writable(self) -> None:
        """Every write entry point's gate: an in-memory store has no
        journal to poison and is never a standby, so it always accepts."""

    def wal_sync(self) -> None:
        """The commit durability point: an in-memory store has no journal
        to sync (group commit and semi-sync come with the durable store)."""

    # --- bulk-ingest windows ----------------------------------------------

    def begin_table_ingest(self, table_id: int) -> None:
        with self._ingest_lock:
            self._ingesting[table_id] = self._ingesting.get(table_id, 0) + 1

    def end_table_ingest(self, table_id: int) -> None:
        with self._ingest_lock:
            c = self._ingesting.get(table_id, 0) - 1
            if c <= 0:
                self._ingesting.pop(table_id, None)
            else:
                self._ingesting[table_id] = c

    def table_ingesting(self, table_id: int) -> bool:
        with self._ingest_lock:
            return table_id in self._ingesting

    def begin(self, pessimistic: bool = False) -> Txn:
        return Txn(self, self.tso.next(), pessimistic=pessimistic)

    def snapshot(self, read_ts: int | None = None) -> Snapshot:
        return Snapshot(self, read_ts if read_ts is not None else self.tso.next())

    def current_version(self) -> int:
        return self.tso.current()

    # --- data-version tracking (for tile-cache invalidation) --------------

    def bump_version(self, keys: list[bytes]) -> None:
        prefixes = {k[:9] for k in keys if len(k) >= 9}  # b't' + table_id
        ts = self.tso.current()
        for p in prefixes:
            ver, _ = self._versions.get(p, (0, 0))
            self._versions[p] = (ver + 1, ts)

    def data_version(self, table_prefix: bytes) -> tuple[int, int]:
        """→ (version counter, last-commit ts) for the table key space."""
        return self._versions.get(table_prefix[:9], (0, 0))

    def gc(self, safe_point: int | None = None) -> int:
        sp = safe_point if safe_point is not None else self.tso.current()
        return self.mvcc.gc(sp)

    def mvcc_versions(self, key: bytes) -> list[tuple[int, int, int]]:
        """MVCC introspection for the HTTP /mvcc endpoint (ref:
        http_status.go mvccTxnHandler): [(start_ts, commit_ts, value_len)]
        newest first, across the write CF and ingest runs."""
        from .mvcc import WriteRecord, _dk, unrev_ts

        out = []
        for k, v in self.mvcc.kv.iter_from(b"w" + key):
            if not k.startswith(b"w" + key) or len(k) != 1 + len(key) + 8:
                break
            rec = WriteRecord.decode(v)
            cts = unrev_ts(k[-8:])
            val = self.mvcc.kv.get(_dk(key, rec.start_ts))
            out.append((rec.start_ts, cts, len(val) if val else 0))
        for run in reversed(self.mvcc.runs):
            i = run.find(key)
            if i >= 0:
                out.append((run.commit_ts, run.commit_ts, len(run.value(i))))
        return out

    # --- the durable store's verbs (a later slice) --------------------------

    def checkpoint(self) -> None:
        raise NotPortedError("storage/txn.py Storage.checkpoint", f"comes with {DURABLE}")

    def receive_frames(self, payloads, seqs=None) -> int:
        raise NotPortedError("storage/txn.py Storage.receive_frames", f"comes with {DURABLE}")

    def promote(self) -> None:
        raise NotPortedError("storage/txn.py Storage.promote", f"comes with {DURABLE}")

    def rejoin(self, new_primary=None) -> None:
        raise NotPortedError("storage/txn.py Storage.rejoin", f"comes with {DURABLE}")

    def set_wal_recovery_mode(self, mode: str) -> None:
        raise NotPortedError("storage/txn.py Storage.set_wal_recovery_mode", f"comes with {DURABLE}")

    def set_wal_spare_dirs(self, csv: str) -> None:
        raise NotPortedError("storage/txn.py Storage.set_wal_spare_dirs", f"comes with {DURABLE}")

    @property
    def gc_worker(self):
        raise NotPortedError("storage/txn.py Storage.gc_worker", f"comes with {DURABLE}")

    @property
    def compactor(self):
        raise NotPortedError("storage/txn.py Storage.compactor", f"comes with {DURABLE}")

    @property
    def shipper(self):
        raise NotPortedError("storage/txn.py Storage._shipper (storage/ship.py ReplicaSet)", f"comes with {DURABLE}")

    # --- services of the front door's later slices ------------------------

    @property
    def ddl(self):
        raise NotPortedError("storage/txn.py Storage.ddl (ddl/worker.py DDLWorker)", f"comes with {FRONT_DOOR}")

    @property
    def stats(self):
        """Shared stats handle (ref: statistics/handle — hangs off Storage
        so all sessions over this store see one stats view)."""
        if getattr(self, "_stats", None) is None:
            from ..statistics.handle import StatsHandle

            self._stats = StatsHandle(self)
        return self._stats

    @property
    def mem(self):
        raise NotPortedError("storage/txn.py Storage.mem (utils/memory.py ServerMemTracker)",
                             f"comes with {FRONT_DOOR}: copr/client.py, item 4.3")

    @property
    def sched(self):
        raise NotPortedError("storage/txn.py Storage.sched (sched ResourceController)",
                             f"comes with {FRONT_DOOR}: copr/client.py, item 4.3")

    @property
    def build_cache(self):
        raise NotPortedError("storage/txn.py Storage.build_cache (copr/tilecache.py BuildSideCache)",
                             f"comes with {FRONT_DOOR}: copr/client.py, item 4.3")

    @property
    def workload(self):
        raise NotPortedError("storage/txn.py Storage.workload (utils/workload.py)",
                             f"comes with {FRONT_DOOR}: copr/client.py, item 4.3")

    @property
    def plugins(self):
        raise NotPortedError("storage/txn.py Storage.plugins (plugin.py)", f"comes with {FRONT_DOOR}")

    @property
    def stmt_stats(self):
        if getattr(self, "_stmt_stats", None) is None:
            from ..utils.stmtstats import StmtStats

            self._stmt_stats = StmtStats()
        return self._stmt_stats

    @property
    def trace_ring(self):
        raise NotPortedError("storage/txn.py Storage.trace_ring (utils/tracing.py TraceRing)",
                             f"comes with {FRONT_DOOR}")

    _timeline_init_lock = Lock()

    @property
    def timeline(self):
        """Per-store device timeline ring (utils/timeline.TimelineRing).
        Double-checked init: first access can come from parallel cop
        worker threads, and a racing second ring would silently swallow
        the loser's events."""
        if getattr(self, "_timeline", None) is None:
            from ..utils.timeline import TimelineRing

            with Storage._timeline_init_lock:
                if getattr(self, "_timeline", None) is None:
                    self._timeline = TimelineRing()
        return self._timeline

    # --- live statement registry (ref: PROCESSLIST + server conn registry)

    def register_process(self, conn_id: int, info: dict) -> None:
        with self._proc_lock:
            self._processes[conn_id] = info

    def clear_process(self, conn_id: int) -> None:
        with self._proc_lock:
            self._processes.pop(conn_id, None)

    def get_process(self, conn_id: int) -> dict | None:
        with self._proc_lock:
            return self._processes.get(conn_id)

    def process_snapshot(self) -> list:
        with self._proc_lock:
            return sorted(self._processes.items())

    # --- active-txn registry (GC safepoint clamp) --------------------------

    MAX_TXN_PIN_S = 3600.0  # leaked/abandoned txns stop blocking GC after this

    def _txn_started(self, start_ts: int) -> None:
        with self._active_lock:
            self._active_starts[start_ts] = time.time()

    def _txn_done(self, start_ts: int) -> None:
        with self._active_lock:
            self._active_starts.pop(start_ts, None)

    def txn_is_active(self, start_ts: int) -> bool:
        """Is `start_ts` a LIVE transaction of this process? The MVCC
        layer's `txn_live` hook: lock resolution must not TTL-expire a
        slow-but-alive owner's locks (the in-process stand-in for the
        reference's txn heartbeat). Entries past MAX_TXN_PIN_S read as
        dead, like the GC clamp — a leaked Txn object stops shielding
        its locks at the same horizon it stops pinning the safepoint."""
        horizon = time.time() - self.MAX_TXN_PIN_S
        with self._active_lock:
            t0 = self._active_starts.get(start_ts)
        return t0 is not None and t0 >= horizon

    def min_active_start_ts(self) -> int | None:
        """Oldest live transaction start-ts, or None. Entries pinned longer
        than MAX_TXN_PIN_S are dropped as leaks (the reference bounds this
        via txn max TTL + the session manager's process list)."""
        horizon = time.time() - self.MAX_TXN_PIN_S
        with self._active_lock:
            for ts, t0 in list(self._active_starts.items()):
                if t0 < horizon:
                    del self._active_starts[ts]
            return min(self._active_starts) if self._active_starts else None

    def _auto_split_run(self, run) -> None:
        """Split regions at every region_split_size-th key of a freshly
        ingested (sorted) run so large tables scan region-parallel."""
        step = self.region_split_size
        if run.n < 2 * step:
            return
        # key_at, not key_mat[i]: columnar runs synthesize the handful of
        # split keys without materializing the whole key matrix
        keys = [run.key_at(i) for i in range(step, run.n - step // 2, step)]
        self.regions.split_many(keys)
