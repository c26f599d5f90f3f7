"""Percolator MVCC over the ordered KV (copy of tidb_tpu/storage/mvcc.py,
in memory: the journal writes and the delta-main compaction's fold come
with the durable store; ref: unistore/tikv/mvcc — behavior spec; the
column-family encoding here is a fresh design).

Key layout inside one MemKV:
  lock   CF: b'l' + user_key                     → Lock record
  write  CF: b'w' + user_key + rev_ts(commit_ts) → WriteRecord
  default CF: b'd' + user_key + rev_ts(start_ts) → row value

rev_ts inverts the timestamp so ascending key order visits newest commits
first — a snapshot read is "seek to (key, read_ts), take first".

Transactional verbs (the tikv/server.go:149-466 surface): prewrite,
commit, rollback, check_txn_status, resolve, get/batch_get/scan.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..errors import LockedError, WriteConflict, TxnAborted
from .memkv import MemKV

OP_PUT = 0
OP_DEL = 1
OP_ROLLBACK = 2
OP_LOCK = 3  # lock-only record (SELECT FOR UPDATE)
OP_PESSIMISTIC = 4  # pessimistic lock, no staged data (ref: tikv LockType::Pessimistic)

_MAX = 0xFFFFFFFFFFFFFFFF


def rev_ts(ts: int) -> bytes:
    return struct.pack(">Q", _MAX - ts)


def unrev_ts(b: bytes) -> int:
    return _MAX - struct.unpack(">Q", b)[0]


@dataclass
class Lock:
    op: int
    primary: bytes
    start_ts: int
    ttl_ms: int
    for_update_ts: int = 0
    min_commit_ts: int = 0

    def encode(self) -> bytes:
        return struct.pack(">BQQQQH", self.op, self.start_ts, self.ttl_ms, self.for_update_ts, self.min_commit_ts, len(self.primary)) + self.primary

    @staticmethod
    def decode(b: bytes) -> "Lock":
        op, start_ts, ttl, fut, mct, plen = struct.unpack_from(">BQQQQH", b)
        off = struct.calcsize(">BQQQQH")
        return Lock(op, b[off : off + plen], start_ts, ttl, fut, mct)


@dataclass
class WriteRecord:
    op: int
    start_ts: int

    def encode(self) -> bytes:
        return struct.pack(">BQ", self.op, self.start_ts)

    @staticmethod
    def decode(b: bytes) -> "WriteRecord":
        op, start_ts = struct.unpack(">BQ", b[:9])
        return WriteRecord(op, start_ts)


@dataclass
class Mutation:
    op: int  # OP_PUT / OP_DEL / OP_LOCK
    key: bytes
    value: bytes = b""


def _lk(key: bytes) -> bytes:
    return b"l" + key


def _wk(key: bytes, ts: int) -> bytes:
    return b"w" + key + rev_ts(ts)


def _dk(key: bytes, ts: int) -> bytes:
    return b"d" + key + rev_ts(ts)


class MVCCStore:
    """One region-server's transactional KV (single process, many regions).

    Two planes:
      - mutable plane: lock/write/default CFs in the ordered MemKV — the
        percolator write path (prewrite/commit), versioned per key;
      - ingest plane: immutable sorted `Run` segments (storage/segment.py),
        one commit_ts per run — the Lightning-SST / TiFlash-replica analog.
    Reads merge both; newer commit_ts wins per key.
    """

    def __init__(self, kv: MemKV | None = None):
        # NOT `kv or MemKV()`: an empty MemKV is falsy (__len__ == 0) and
        # would silently orphan the caller's store
        self.kv = kv if kv is not None else MemKV()
        self.runs: list = []  # Run segments, ascending commit_ts
        # data-version counters per table-prefix space are maintained above
        # (storage.Storage) — the MVCC layer stays schema-agnostic.
        # liveness hook (start_ts -> bool), installed by the owning
        # Storage: the in-process analog of the reference's txn TTL
        # heartbeat. check_txn_status consults it before TTL-expiring a
        # primary lock — a CPU-starved but LIVE transaction must not have
        # its locks stolen by an impatient waiter (the bank-transfer
        # flake: a >TTL scheduler stall between lock acquisition and
        # commit let a sibling roll back a live txn, which then died with
        # TxnAborted instead of the retryable contract errors). Orphans
        # stay resolvable: a crashed process's recovered locks, and
        # simulated dead txns using raw TSO values, are not registered.
        self.txn_live = None

    # --- reads ------------------------------------------------------------

    def _check_lock(self, key: bytes, read_ts: int):
        raw = self.kv.get(_lk(key))
        if raw is None:
            return
        lock = Lock.decode(raw)
        if lock.op in (OP_LOCK, OP_PESSIMISTIC):
            return  # lock-only / pessimistic locks stage no data: reads pass
        if lock.start_ts <= read_ts:
            raise LockedError(f"key is locked by txn {lock.start_ts}", key=key, lock=lock)

    def _visible_write(self, key: bytes, read_ts: int) -> tuple[WriteRecord, int] | None:
        """Newest visible PUT/DEL record → (record, commit_ts)."""
        for k, v in self.kv.iter_from(_wk(key, read_ts)):
            if not k.startswith(b"w" + key) or len(k) != 1 + len(key) + 8:
                return None
            rec = WriteRecord.decode(v)
            if rec.op in (OP_PUT, OP_DEL):
                return rec, unrev_ts(k[-8:])
            # rollbacks / lock-records: keep looking at older versions
        return None

    def _run_get(self, key: bytes, read_ts: int) -> tuple[bytes | None, int]:
        """Newest run entry visible at read_ts → (value, commit_ts)."""
        for run in reversed(self.runs):
            if run.commit_ts > read_ts:
                continue
            i = run.find(key)
            if i >= 0:
                return run.value(i), run.commit_ts
        return None, 0

    def _run_newest_commit(self, key: bytes) -> int:
        for run in reversed(self.runs):
            if run.find(key) >= 0:
                return run.commit_ts
        return 0

    def get(self, key: bytes, read_ts: int) -> bytes | None:
        self._check_lock(key, read_ts)
        found = self._visible_write(key, read_ts)
        rval, rts = self._run_get(key, read_ts) if self.runs else (None, 0)
        if found is not None:
            rec, cts = found
            if cts >= rts:  # mutable write newer than any run entry
                if rec.op == OP_DEL:
                    return None
                return self.kv.get(_dk(key, rec.start_ts))
        return rval

    def batch_get(self, keys: list[bytes], read_ts: int) -> dict[bytes, bytes]:
        out = {}
        for k in keys:
            v = self.get(k, read_ts)
            if v is not None:
                out[k] = v
        return out

    def _scan_mut(self, start: bytes, end: bytes | None, read_ts: int):
        """Mutable-plane scan → [(user_key, value | None-for-delete, commit_ts)]."""
        out = []
        it = self.kv.iter_from(b"w" + start)
        last_key = None
        for k, v in it:
            if not k.startswith(b"w") or (end is not None and k[1:-8] >= end):
                break
            ukey = k[1:-8]
            if ukey < start:
                # iter_from(b"w"+start) can land mid-version-space of the
                # PRECEDING user key when `start` falls strictly inside a
                # stored key's (ukey || rev_ts) span — e.g. a region split
                # at a non-record-key boundary (chaos found this): the
                # rev_ts bytes of ukey's versions sort above start's
                # suffix. Half-open [start, end) means ukey >= start.
                continue
            if ukey == last_key:
                continue  # older version of an already-decided key
            ts = unrev_ts(k[-8:])
            if ts > read_ts:
                continue  # newer than snapshot; keep scanning same key
            last_key = ukey
            rec = WriteRecord.decode(v)
            if rec.op == OP_PUT:
                out.append((ukey, self.kv.get(_dk(ukey, rec.start_ts)), ts))
            elif rec.op == OP_DEL:
                out.append((ukey, None, ts))
            else:
                # rollback/lock record newest-visible: older versions may
                # still be visible — rare path, do a point get
                found = self._visible_write(ukey, read_ts)
                if found and found[0].op == OP_PUT:
                    out.append((ukey, self.kv.get(_dk(ukey, found[0].start_ts)), found[1]))
                elif found:
                    out.append((ukey, None, found[1]))
        return out

    def _check_range_locks(self, start: bytes, end: bytes | None, read_ts: int) -> None:
        # cap at b"m": the l-CF's end — an open-ended scan must not run
        # into the next CF's keys
        hi = _lk(end) if end is not None else b"m"
        for k, raw in self.kv.scan(_lk(start), hi):
            lock = Lock.decode(raw)
            if lock.op not in (OP_LOCK, OP_PESSIMISTIC) and lock.start_ts <= read_ts:
                raise LockedError("range contains locked key", key=k[1:], lock=lock)

    def scan_segments(self, start: bytes, end: bytes | None, read_ts: int):
        """Snapshot range scan without materializing per-row objects:
        → (segments: list[SegmentView], loose: list[(user_key, value)]).

        Segments are slices of ingest runs visible at read_ts; `loose` is
        the (usually small) mutable plane. Shadowing is resolved here:
        newer runs drop duplicate keys from older ones, and mutable writes
        newer than a run entry drop it (a mutable DELETE suppresses it)."""
        from .segment import SegmentView

        self._check_range_locks(start, end, read_ts)
        mut = self._scan_mut(start, end, read_ts)
        segs: list[SegmentView] = []
        for run in self.runs:  # ascending commit_ts
            if run.commit_ts > read_ts:
                continue
            i, j = run.range(start, end)
            if i < j:
                segs.append(SegmentView(run, i, j))
        # run-vs-run: a newer run shadows duplicate keys in older runs.
        # Pairs can only collide when key widths match (different widths
        # can't encode equal keys) and commit_ts differs (one bulk_load's
        # runs share a ts and are disjoint by construction) — so the
        # per-key set walk below runs only on genuine re-ingest overlap.
        for bi in range(1, len(segs)):
            b = segs[bi]
            for ai in range(bi):
                a = segs[ai]
                if (
                    a.run.w == b.run.w
                    and a.run.commit_ts != b.run.commit_ts
                    and a.min_key() <= b.max_key()
                    and b.min_key() <= a.max_key()
                ):
                    bkeys = {b.run.key_at(i) for i in range(b.i, b.j)}
                    drop = {idx for idx in range(a.i, a.j) if a.run.key_at(idx) in bkeys}
                    if drop:
                        a.drop = (a.drop or set()) | drop
        loose: list[tuple[bytes, bytes]] = []
        for k, v, ts in mut:
            shadowed = False
            for s in segs:
                idx = s.run.find(k)
                if s.i <= idx < s.j:
                    if s.run.commit_ts > ts:
                        shadowed = True  # run entry is newer — run wins
                    else:
                        s.drop = (s.drop or set()) | {idx}
            if not shadowed and v is not None:
                loose.append((k, v))
        return segs, loose

    def scan(self, start: bytes, end: bytes, read_ts: int, limit: int | None = None):
        """Snapshot range scan → list of (user_key, value), key-ordered."""
        segs, loose = self.scan_segments(start, end, read_ts)
        if not segs:
            out = loose
        else:
            segs.sort(key=lambda s: s.min_key())
            disjoint = all(
                segs[i].max_key() < segs[i + 1].min_key() for i in range(len(segs) - 1)
            )
            out = []
            for s in segs:
                out.extend(s.pairs())
            if loose or not disjoint:
                out.extend(loose)
                out.sort(key=lambda kv: kv[0])
        return out[:limit] if limit is not None else out

    # --- writes (percolator) ---------------------------------------------

    def prewrite(self, muts: list[Mutation], primary: bytes, start_ts: int, ttl_ms: int = 3000, for_update_ts: int = 0, pess_keys=frozenset()):
        """First phase: lock every key and stage values. Keys in
        `pess_keys` were pessimistically locked by this txn: finding them
        unlocked means a waiter resolved them away (TTL expiry) — the txn
        must abort (TiKV's PessimisticLockNotFound)."""
        with self.kv.lock:
            for m in muts:
                raw = self.kv.get(_lk(m.key))
                if raw is None and m.key in pess_keys:
                    raise TxnAborted(
                        f"pessimistic lock on {m.key!r} was resolved away (txn {start_ts})"
                    )
                if raw is not None:
                    lock = Lock.decode(raw)
                    if lock.start_ts != start_ts:
                        raise LockedError(f"key locked by {lock.start_ts}", key=m.key, lock=lock)
                    # our own lock: pessimistic→prewrite conversion (or an
                    # idempotent re-prewrite) replaces it and stages data
                    self.kv.put(_lk(m.key), Lock(m.op, primary, start_ts, ttl_ms, for_update_ts).encode())
                    if m.op == OP_PUT:
                        self.kv.put(_dk(m.key, start_ts), m.value)
                    continue
                # write-conflict check: any commit newer than our snapshot?
                for k, v in self.kv.iter_from(b"w" + m.key):
                    if not k.startswith(b"w" + m.key) or len(k) != 1 + len(m.key) + 8:
                        break
                    committed = unrev_ts(k[-8:])
                    rec = WriteRecord.decode(v)
                    if rec.op == OP_ROLLBACK and rec.start_ts == start_ts:
                        raise TxnAborted(f"txn {start_ts} already rolled back")
                    # keys the txn pessimistically locked never reach here
                    # (the own-lock branch above handles them). Unlocked
                    # keys ARE conflict-checked even in pessimistic txns —
                    # against the current-read horizon for_update_ts (TiKV
                    # constraint-check semantics), start_ts for optimistic.
                    if committed > max(start_ts, for_update_ts) and rec.op in (OP_PUT, OP_DEL):
                        raise WriteConflict(f"conflict at {committed} > start {start_ts}")
                    break
                if self.runs and self._run_newest_commit(m.key) > max(start_ts, for_update_ts):
                    raise WriteConflict(f"ingest-run conflict newer than start {start_ts}")
                self.kv.put(_lk(m.key), Lock(m.op, primary, start_ts, ttl_ms, for_update_ts).encode())
                if m.op == OP_PUT:
                    self.kv.put(_dk(m.key, start_ts), m.value)

    def _newest_commit_ts(self, key: bytes) -> int:
        """Newest PUT/DEL commit ts for a key across both planes."""
        newest = 0
        for k, v in self.kv.iter_from(b"w" + key):
            if not k.startswith(b"w" + key) or len(k) != 1 + len(key) + 8:
                break
            rec = WriteRecord.decode(v)
            if rec.op in (OP_PUT, OP_DEL):
                newest = unrev_ts(k[-8:])
                break
        if self.runs:
            newest = max(newest, self._run_newest_commit(key))
        return newest

    def high_water_ts(self) -> int:
        """Largest timestamp embedded anywhere in the store's durable
        state: commit timestamps in the write CF and segment runs, start
        timestamps staged in the data CF, and the timestamps carried by
        unresolved locks. Recovery and standby promotion seed the TSO
        with this (TSO.advance_to) so a reborn store never allocates a
        read or start timestamp at or below an already-durable commit."""
        hw = 0
        with self.kv.lock:
            for cf in (b"d", b"w"):
                for k, _ in self.kv.iter_from(cf):
                    if not k.startswith(cf):
                        break
                    if len(k) >= 9:
                        hw = max(hw, unrev_ts(k[-8:]))
            for k, raw in self.kv.iter_from(b"l"):
                if not k.startswith(b"l"):
                    break
                try:
                    lock = Lock.decode(raw)
                except (struct.error, IndexError):
                    continue
                hw = max(hw, lock.start_ts, lock.for_update_ts, lock.min_commit_ts)
        for r in self.runs:
            hw = max(hw, r.commit_ts)
        return hw

    def acquire_pessimistic_lock(
        self, keys: list[bytes], primary: bytes, start_ts: int, for_update_ts: int, ttl_ms: int = 3000
    ) -> None:
        """Lock keys at DML time without staging data (ref: unistore
        tikv/server.go:192 KvPessimisticLock). Raises LockedError when a
        key is held by another txn and WriteConflict when a commit newer
        than for_update_ts exists (caller retries with a fresh ts)."""
        with self.kv.lock:
            for key in keys:
                raw = self.kv.get(_lk(key))
                if raw is not None:
                    lock = Lock.decode(raw)
                    if lock.start_ts != start_ts:
                        raise LockedError(f"key locked by {lock.start_ts}", key=key, lock=lock)
                if self._newest_commit_ts(key) > for_update_ts:
                    raise WriteConflict(f"pessimistic lock sees commit newer than {for_update_ts}")
            for key in keys:
                self.kv.put(_lk(key), Lock(OP_PESSIMISTIC, primary, start_ts, ttl_ms, for_update_ts).encode())

    def pessimistic_rollback(self, keys: list[bytes], start_ts: int) -> None:
        """Release pessimistic locks without aborting the txn (no rollback
        tombstone — the txn may still prewrite later)."""
        with self.kv.lock:
            for key in keys:
                raw = self.kv.get(_lk(key))
                if raw is not None:
                    lock = Lock.decode(raw)
                    if lock.start_ts == start_ts and lock.op == OP_PESSIMISTIC:
                        self.kv.delete(_lk(key))

    def commit(self, keys: list[bytes], start_ts: int, commit_ts: int):
        with self.kv.lock:
            for key in keys:
                raw = self.kv.get(_lk(key))
                if raw is None:
                    # already committed (retry) or rolled back?
                    st = self._find_txn_write(key, start_ts)
                    if st is not None and st.op != OP_ROLLBACK:
                        continue  # idempotent
                    raise TxnAborted(f"commit of missing lock, txn {start_ts}")
                lock = Lock.decode(raw)
                if lock.start_ts != start_ts:
                    # a resolver may have rolled this key FORWARD already
                    # (our primary was committed, a blocked reader/writer
                    # resolved the secondary via check_txn_status) and a
                    # NEWER txn locked it since — commit is idempotent on
                    # an already-committed key (TiKV semantics); only a
                    # foreign lock with NO write record of ours is abort
                    st = self._find_txn_write(key, start_ts)
                    if st is not None and st.op != OP_ROLLBACK:
                        continue
                    raise TxnAborted(f"lock owned by {lock.start_ts}, not {start_ts}")
                op = OP_PUT if lock.op == OP_PUT else (OP_DEL if lock.op == OP_DEL else OP_LOCK)
                self.kv.put(_wk(key, commit_ts), WriteRecord(op, start_ts).encode())
                self.kv.delete(_lk(key))

    def rollback(self, keys: list[bytes], start_ts: int):
        with self.kv.lock:
            for key in keys:
                raw = self.kv.get(_lk(key))
                if raw is not None:
                    lock = Lock.decode(raw)
                    if lock.start_ts == start_ts:
                        self.kv.delete(_lk(key))
                        self.kv.delete(_dk(key, start_ts))
                # tombstone so late prewrites of this txn fail
                self.kv.put(_wk(key, start_ts), WriteRecord(OP_ROLLBACK, start_ts).encode())

    def _find_txn_write(self, key: bytes, start_ts: int) -> WriteRecord | None:
        for k, v in self.kv.iter_from(b"w" + key):
            if not k.startswith(b"w" + key) or len(k) != 1 + len(key) + 8:
                return None
            rec = WriteRecord.decode(v)
            if rec.start_ts == start_ts:
                return rec
        return None

    def check_txn_status(self, primary: bytes, start_ts: int, now_ms: int) -> tuple[str, int]:
        """→ ('committed', commit_ts) | ('rolled_back', 0) | ('locked', ttl) —
        and rolls back expired primary locks (ref: tikv/server.go:285)."""
        raw = self.kv.get(_lk(primary))
        if raw is not None:
            lock = Lock.decode(raw)
            if lock.start_ts == start_ts:
                from .tso import TSO

                # TTL counts from the LAST acquisition (for_update_ts is
                # refreshed per pessimistic lock round), so long-lived but
                # active txns aren't rolled back by impatient waiters
                base = max(start_ts, lock.for_update_ts)
                if TSO.physical_ms(base) + lock.ttl_ms < now_ms:
                    live = self.txn_live
                    if live is not None and live(start_ts):
                        # owner is a LIVE registered txn: an expired TTL
                        # means a slow owner, not an abandoned one — keep
                        # the lock; the waiter's own deadline bounds it
                        return "locked", lock.ttl_ms
                    self.rollback([primary], start_ts)
                    return "rolled_back", 0
                return "locked", lock.ttl_ms
        rec_ts = self._find_commit(primary, start_ts)
        if rec_ts is not None:
            return "committed", rec_ts
        # no lock, no commit: treat as rolled back (and tombstone it)
        self.rollback([primary], start_ts)
        return "rolled_back", 0

    def _find_commit(self, key: bytes, start_ts: int) -> int | None:
        for k, v in self.kv.iter_from(b"w" + key):
            if not k.startswith(b"w" + key) or len(k) != 1 + len(key) + 8:
                return None
            rec = WriteRecord.decode(v)
            if rec.start_ts == start_ts and rec.op in (OP_PUT, OP_DEL, OP_LOCK):
                return unrev_ts(k[-8:])
        return None

    def resolve_lock(self, key: bytes, lock: Lock, now_ms: int) -> bool:
        """Resolve one blocking lock via its primary. True if cleared."""
        status, commit_ts = self.check_txn_status(lock.primary, lock.start_ts, now_ms)
        if status == "committed":
            self.commit([key], lock.start_ts, commit_ts)
            return True
        if status == "rolled_back":
            self.rollback([key], lock.start_ts)
            return True
        return False

    def ingest_run(
        self,
        key_mat,
        vbuf: bytes,
        starts,
        lens,
        commit_ts: int,
        presorted: bool = False,
    ) -> None:
        """Bulk ingest one fixed-width-key segment, bypassing 2PC (ref:
        br/pkg/lightning local backend — builds SSTs and ingests). All
        entries become visible atomically at commit_ts."""
        from .segment import Run

        run = Run.build(key_mat, vbuf, starts, lens, commit_ts, presorted=presorted)
        self.ingest_runs([run])

    def ingest_runs(self, runs: list, precondition=None) -> None:
        """Atomic multi-run ingest: EVERY run — record plane plus index
        planes — lands under one lock hold, so a reader sees the whole
        ingest or none of it. Runs must already be sorted (the
        Run/ColumnarRun/IntIndexRun builders guarantee it).

        `precondition`, when given, runs UNDER the kv lock before the runs
        are published — the seam that closes the bulk route's
        check-then-publish race (a commit landing between an advance
        occupancy check and the publish must abort the ingest, never be
        silently shadowed). It must raise to refuse; nothing has been
        made visible at that point."""
        runs = [r for r in runs if r.n]
        if not runs:
            return
        with self.kv.lock:
            if precondition is not None:
                precondition()
            self.runs.extend(runs)
        hook = getattr(self, "split_hook", None)
        if hook is not None:
            for run in runs:
                hook(run)

    def ingest(self, kvs: list[tuple[bytes, bytes]], commit_ts: int) -> None:
        """Bulk ingest arbitrary (key, value) pairs: groups by key width
        into fixed-width runs (one run per width)."""
        import numpy as np

        by_w: dict[int, list[tuple[bytes, bytes]]] = {}
        for k, v in kvs:
            by_w.setdefault(len(k), []).append((k, v))
        for w, group in by_w.items():
            n = len(group)
            key_mat = np.frombuffer(b"".join(k for k, _ in group), dtype=np.uint8).reshape(n, w)
            vbuf = b"".join(v for _, v in group)
            lens = np.fromiter((len(v) for _, v in group), np.int64, n)
            starts = np.zeros(n, dtype=np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            self.ingest_run(key_mat, vbuf, starts, lens, commit_ts)

    def range_occupied(self, start: bytes, end: bytes) -> bool:
        """Any committed version, ingest-run entry or in-flight LOCK in
        the user-key range? The bulk route's require-empty witness —
        locks count because a prewritten txn's commit would land AFTER
        the ingest and be silently shadowed."""
        for cf in (b"w", b"l"):
            for k, _v in self.kv.iter_from(cf + start):
                if k.startswith(cf) and k[1:] < end:
                    return True
                break
        for run in self.runs:
            i, j = run.range(start, end)
            if i < j and (run.alive is None or run.alive[i:j].any()):
                return True
        return False

    def range_written_since(self, start: bytes, end: bytes, ts: int) -> bool:
        """Could a snapshot above `ts` read [start, end) differently from
        one at `ts`? True when the range holds a commit record newer than
        `ts`, any lock (a commit in flight), or a run entry committed after
        `ts`. The tile cache's witness that a region batch built at `ts`
        is still exact after a commit elsewhere in its table."""
        with self.kv.lock:
            for k, _v in self.kv.iter_from(b"w" + start):
                if not k.startswith(b"w") or k[1:-8] >= end:
                    break
                if k[1:-8] >= start and unrev_ts(k[-8:]) > ts:
                    return True
            for k, _v in self.kv.iter_from(b"l" + start):
                if k.startswith(b"l") and k[1:] < end:
                    return True
                break
            for run in self.runs:
                if run.commit_ts > ts:
                    i, j = run.range(start, end)
                    if i < j:
                        return True
        return False

    def kill_runs_range(self, start: bytes, end: bytes) -> int:
        n = 0
        for run in self.runs:
            n += run.kill_range(start, end)
        self.runs = [r for r in self.runs if r.alive is None or r.alive.any()]
        return n

    def unsafe_destroy_range(self, start: bytes, end: bytes) -> int:
        """Physically remove ALL versions/locks in a user-key range —
        the delete-range verb used when tables are dropped/truncated
        (ref: gc_worker delete-ranges; tikv UnsafeDestroyRange)."""
        n = 0
        for cf in (b"d", b"w", b"l"):
            n += self.kv.delete_range(cf + start, cf + end)
        n += self.kill_runs_range(start, end)
        return n

    # --- GC (ref: store/gcworker) -----------------------------------------

    def gc(self, safe_point: int) -> int:
        """Drop versions no snapshot at/after safe_point can see."""
        removed = 0
        with self.kv.lock:
            doomed_w: list[bytes] = []
            doomed_d: list[bytes] = []
            last_key = None
            kept_newest = False
            for k, v in list(self.kv.iter_from(b"w")):
                if not k.startswith(b"w"):
                    break
                ukey, ts = k[1:-8], unrev_ts(k[-8:])
                if ukey != last_key:
                    last_key, kept_newest = ukey, False
                rec = WriteRecord.decode(v)
                if ts > safe_point:
                    continue
                if rec.op not in (OP_PUT, OP_DEL):
                    # rollback/lock markers are not data versions: safe to
                    # drop once no pre-safepoint txn can prewrite again —
                    # and they must NOT count as the kept newest version
                    doomed_w.append(k)
                    continue
                if not kept_newest:
                    kept_newest = True
                    if rec.op == OP_DEL:  # newest visible is a delete: drop it too
                        doomed_w.append(k)
                        doomed_d.append(_dk(ukey, rec.start_ts))
                    continue
                doomed_w.append(k)
                doomed_d.append(_dk(ukey, rec.start_ts))
            for k in doomed_w + doomed_d:
                self.kv.delete(k)
                removed += 1
        return removed
