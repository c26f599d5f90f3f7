"""Timestamp oracle — the PD TSO stand-in (copy of tidb_tpu/storage/tso.py; ref: unistore/pd.go fake PD).

Timestamps are (physical_ms << 18) | logical, like TiDB's TSO, so they
embed wall time yet stay strictly monotonic under bursts.
"""

from __future__ import annotations

import time
from threading import Lock


class TSO:
    LOGICAL_BITS = 18

    def __init__(self):
        self._lock = Lock()
        self._last = 0

    def next(self) -> int:
        with self._lock:
            phys = int(time.time() * 1000) << self.LOGICAL_BITS
            ts = max(phys, self._last + 1)
            self._last = ts
            return ts

    def current(self) -> int:
        """A read-only timestamp (for stale reads / GC watermarks)."""
        with self._lock:
            return self._last

    def advance_to(self, ts: int) -> None:
        """Never allocate at or below `ts` again. A real PD persists its
        high water; this stand-in re-learns it at recovery/promotion from
        the durable state instead. Without the seed, a store reopened in
        the SAME millisecond as its predecessor's last commit hands out
        read timestamps below that commit_ts — the freshest committed
        write is invisible until the wall clock ticks over."""
        with self._lock:
            if ts > self._last:
                self._last = ts

    @staticmethod
    def physical_ms(ts: int) -> int:
        return ts >> TSO.LOGICAL_BITS
