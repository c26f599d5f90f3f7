"""First-waiter deadlock detector for pessimistic locks (copy of tidb_tpu/storage/detector.py)
(ref: store/mockstore/unistore/tikv/detector.go).

Each transaction waits on at most one holder at a time (the first lock it
blocks on), so the wait-for graph is a function txn → txn and cycle
detection is a pointer chase. The LATER waiter — the one whose edge
closes the cycle — gets the DeadlockError, matching the reference's
first-waiter victim policy.
"""

from __future__ import annotations

import time
from collections import deque
from threading import Lock

from ..errors import DeadlockError


class DeadlockDetector:
    def __init__(self, history_capacity: int = 64):
        self._lock = Lock()
        self._wait_for: dict[int, int] = {}  # waiter start_ts → holder start_ts
        # recent deadlocks for information_schema.deadlocks
        # (ref: util/deadlockhistory)
        self.history: deque = deque(maxlen=history_capacity)
        self._next_id = 1

    def register(self, waiter: int, holder: int) -> None:
        """Record waiter→holder; raises DeadlockError if it closes a cycle."""
        with self._lock:
            cur = holder
            for _ in range(len(self._wait_for) + 1):
                if cur == waiter:
                    self.history.append({
                        "id": self._next_id,
                        "time": time.time(),
                        "try_lock_trx": waiter,
                        "holding_trx": holder,
                    })
                    self._next_id += 1
                    raise DeadlockError(
                        f"Deadlock found when trying to get lock: txn {waiter} waits for {holder}"
                    )
                cur = self._wait_for.get(cur)
                if cur is None:
                    break
            self._wait_for[waiter] = holder

    def done(self, waiter: int) -> None:
        with self._lock:
            self._wait_for.pop(waiter, None)
