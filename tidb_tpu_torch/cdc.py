"""Change data capture (copy of tidb_tpu/cdc.py; ref: br/pkg/cdclog/ + the txn
layer's binlog.go — the commit-time hook TiCDC/binlog drain from, re-expressed as an
in-process change feed over the percolator commit path).

The reference emits row-change events at transaction commit: cdclog
writes (commit_ts, table, row) entries sinks replay in commit order;
binlog attaches prewrite values to the 2PC. Here `ChangeFeed` registers
on the Storage and receives every committed mutation batch exactly once,
AFTER the commit point (phase 2 succeeded on the primary — the txn is
durable), with decoded table/row identity for record keys.

Sinks: any callable(list[ChangeEvent]); `FileSink` appends the cdclog-
style JSON lines. Events within one txn share commit_ts and arrive in
key order; delivery holds the feed lock, so sinks see whole-txn batches
serially. Across CONCURRENT committers the delivery order may trail the
commit_ts order (commit_ts acquisition and publication are not one
atomic step) — every event carries its commit_ts, so strict replay
sorts by it, exactly like cdclog consumers resolve file interleaving.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class ChangeEvent:
    commit_ts: int
    start_ts: int
    table_id: int | None  # None: non-record key (index/meta)
    handle: int | None
    op: str  # 'put' | 'delete'
    key: bytes
    value: bytes | None  # encoded row (None for deletes)


class ChangeFeed:
    """Commit-time event bus; attach via Storage.cdc.subscribe()."""

    def __init__(self):
        self._sinks: list = []
        self._lock = threading.Lock()

    def subscribe(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def unsubscribe(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    @property
    def active(self) -> bool:
        return bool(self._sinks)

    def publish(self, start_ts: int, commit_ts: int, muts) -> None:
        """Called by Txn.commit after phase 2 on the primary. `muts` is
        the sorted mutation list (key order within the txn)."""
        if not self._sinks:
            return
        from .codec import tablecodec
        from .storage.mvcc import OP_DEL, OP_LOCK, OP_PUT

        events = []
        for m in muts:
            if m.op == OP_LOCK:
                continue
            tid = handle = None
            if tablecodec.is_record_key(m.key):
                tid = tablecodec.decode_table_id(m.key)
                handle = tablecodec.decode_record_handle(m.key)
            events.append(ChangeEvent(
                commit_ts, start_ts, tid, handle,
                "delete" if m.op == OP_DEL else "put",
                m.key, m.value if m.op == OP_PUT else None,
            ))
        if not events:
            return
        # deliver under the lock: sinks see txn batches one at a time
        with self._lock:
            for sink in list(self._sinks):
                sink(events)


class FileSink:
    """cdclog-style JSON-lines sink (ref: br/pkg/cdclog file layout —
    one ts-ordered log of row changes).

    Durable mode: `durable=True` fsyncs the file on a cadence
    (`fsync_interval_s`; 0 = every batch) so the sink honestly survives
    SIGKILL — the crashpoint CDC-not-ahead invariant is then checked
    against bytes that were really on disk, not page cache the crash may
    or may not have flushed. `rotate_bytes` caps segment size: a full
    segment renames to `<path>.NNNNNN` (dir-fsynced in durable mode) and
    a fresh live file opens; `segments(path)` lists rotated + live parts
    in write order for consumers/checkers."""

    def __init__(self, path: str, durable: bool = False,
                 fsync_interval_s: float = 0.0, rotate_bytes: int | None = None):
        self.path = path
        self.durable = durable
        self.fsync_interval_s = fsync_interval_s
        self.rotate_bytes = rotate_bytes
        self._lock = threading.Lock()
        self._f = None
        self._rotations = 0
        self._last_fsync = 0.0

    def __call__(self, events: list[ChangeEvent]) -> None:
        with self._lock:
            f = self._open_locked()
            for e in events:
                f.write(json.dumps({
                    "commit_ts": e.commit_ts,
                    "start_ts": e.start_ts,
                    "table_id": e.table_id,
                    "handle": e.handle,
                    "op": e.op,
                    "key": e.key.hex(),
                    "value": e.value.hex() if e.value is not None else None,
                }) + "\n")
            f.flush()
            if self.durable:
                now = time.time()
                if now - self._last_fsync >= self.fsync_interval_s:
                    os.fsync(f.fileno())
                    self._last_fsync = now
            if self.rotate_bytes is not None and f.tell() >= self.rotate_bytes:
                self._rotate_locked()

    def _open_locked(self):
        if self._f is None:
            self._f = open(self.path, "a", encoding="utf8")
            # resuming over earlier rotations: continue the numbering
            existing = glob.glob(self.path + ".*")
            if existing and self._rotations == 0:
                self._rotations = len(existing)
        return self._f

    def _rotate_locked(self) -> None:
        f = self._f
        if self.durable:
            os.fsync(f.fileno())
        f.close()
        self._f = None
        os.replace(self.path, f"{self.path}.{self._rotations:06d}")
        self._rotations += 1
        if self.durable:
            d = os.path.dirname(os.path.abspath(self.path))
            fd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                if self.durable:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                self._f.close()
                self._f = None

    @staticmethod
    def segments(path: str) -> list[str]:
        """Rotated segments (write order) + the live file, existing only."""
        out = sorted(glob.glob(path + ".*"))
        if os.path.exists(path):
            out.append(path)
        return out
