"""In-memory ordered KV engine (copy of tidb_tpu/storage/memkv.py without
the durable store's journal hooks, which come with the WAL; the
badger-LSM stand-in; ref: unistore's
lockstore MemStore — a skiplist. Here: sorted key array + dict, which gives
O(log n) point ops and cache-friendly range scans; the C++ engine can slot
in behind the same interface later).
"""

from __future__ import annotations

import bisect
from threading import RLock


class MemKV:
    """Sorted byte-key → byte-value store with range scans.

    Thread-safe via a coarse RLock (matches the single-writer pattern of
    the in-process store; scans snapshot the key array slice).
    """

    def __init__(self):
        self._keys: list[bytes] = []
        self._map: dict[bytes, bytes] = {}
        self.lock = RLock()

    def __len__(self):
        return len(self._keys)

    def get(self, key: bytes) -> bytes | None:
        return self._map.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        with self.lock:
            if key not in self._map:
                bisect.insort(self._keys, key)
            self._map[key] = value

    def delete(self, key: bytes) -> None:
        with self.lock:
            if key in self._map:
                del self._map[key]
                i = bisect.bisect_left(self._keys, key)
                if i < len(self._keys) and self._keys[i] == key:
                    self._keys.pop(i)

    def write_batch(self, puts: list[tuple[bytes, bytes]], deletes: list[bytes] = ()) -> None:
        with self.lock:
            for k, v in puts:
                if k not in self._map:
                    bisect.insort(self._keys, k)
                self._map[k] = v
            for k in deletes:
                self.delete(k)

    def scan(self, start: bytes, end: bytes | None = None, limit: int | None = None):
        """Yield (key, value) for start <= key < end in order."""
        with self.lock:
            i = bisect.bisect_left(self._keys, start)
            keys = self._keys[i : i + limit if limit is not None else None]
            if end is not None:
                j = bisect.bisect_left(keys, end)
                keys = keys[:j]
            snapshot = [(k, self._map[k]) for k in keys]
        return snapshot

    def iter_from(self, start: bytes):
        """Iterator over (key, value) from start; snapshots lazily in
        chunks. Chunks grow 8 → 64 → ... → 1024: most callers are MVCC
        point lookups that consume one or two entries (a fixed 1024-row
        snapshot per point get was the single largest allocation on the
        warmed statement hot path), while range scans amortize to the
        full chunk within three batches."""
        cur = start
        limit = 8
        while True:
            batch = self.scan(cur, None, limit)
            if not batch:
                return
            yield from batch
            cur = batch[-1][0] + b"\x00"
            limit = min(limit * 8, 1024)

    def bulk_load(self, pairs: list[tuple[bytes, bytes]]) -> None:
        """Bulk ingest (the Lightning local-backend analog): sorts only the
        NEW keys and merges with the existing sorted key array — O(m log m
        + n + m), and a pure append when the batch lands past the tail."""
        import heapq

        with self.lock:
            fresh = [k for k, _ in pairs if k not in self._map]
            self._map.update(pairs)
            if not fresh:
                return
            fresh = sorted(set(fresh))
            if not self._keys or fresh[0] > self._keys[-1]:
                self._keys.extend(fresh)
            else:
                self._keys = list(heapq.merge(self._keys, fresh))

    def count_range(self, start: bytes, end: bytes) -> int:
        """Number of keys in [start, end) — two bisects, no snapshot.
        The compactor's delta estimator: cheap enough to poll per table
        per tick without touching values."""
        with self.lock:
            i = bisect.bisect_left(self._keys, start)
            j = bisect.bisect_left(self._keys, end)
            return j - i

    def first_key_at_or_after(self, start: bytes) -> bytes | None:
        """Smallest key >= start, or None. Lets a caller enumerate the
        distinct table prefixes in a CF by leapfrogging (bisect per
        prefix) instead of walking every version entry."""
        with self.lock:
            i = bisect.bisect_left(self._keys, start)
            return self._keys[i] if i < len(self._keys) else None

    def delete_range(self, start: bytes, end: bytes) -> int:
        with self.lock:
            i = bisect.bisect_left(self._keys, start)
            j = bisect.bisect_left(self._keys, end)
            doomed = self._keys[i:j]
            for k in doomed:
                del self._map[k]
            del self._keys[i:j]
            return len(doomed)
