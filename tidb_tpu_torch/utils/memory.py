"""Memory quota tracker tree + server-level arbitration (ref:
util/memory/tracker.go:54 tracker tree + action.go:29 action chain +
util/servermemorylimit — the three-layer protection the reference runs:
per-statement quota cancel, server soft-limit actions, and a server hard
limit that kills the TOP consumer instead of whoever allocates next).

Layout: one `MemTracker` per statement, attached under its session's
tracker, attached under the store's `ServerMemTracker` (`Storage.mem`).
`consume` at chunk-materialization points propagates up the chain; each
layer owns its action:

  * statement — exceeding tidb_mem_quota_query raises
    MemoryQuotaExceeded (the classic OOM-kill analog, unchanged);
  * server soft limit (tidb_server_memory_limit ×
    tidb_memory_usage_alarm_ratio) — DEGRADE, not cancel: `engine='auto'`
    cop tasks reroute to the host engine (device h2d would only deepen
    the pressure) and the tile caches drop their column batches AND
    device mirrors (the biggest reclaimable pools);
  * server hard limit (tidb_server_memory_limit) — the arbiter kills the
    TOP-consuming statement through the scheduler's shared interrupt
    gate (sched.scheduler.raise_if_interrupted): the victim's session is
    flagged with reason "oom" and escapes at its next checkpoint, while
    innocent allocators proceed.

Device transfers (tpu_engine h2d/d2h) consume into the statement tracker
through a thread-local binding (`bind`/`consume_current`): the cop pool
and the launch batcher run engine work on threads where contextvars are
wrong by construction, the same reason utils/tracing carries its own TLS.
Transfer bytes are a VOLUME proxy, not a resident-set measure — they
unwind with the statement at `detach()`, which releases everything the
statement still holds from every ancestor (tree accounting can never
leak into the global tracker).

A copy of tidb_tpu/utils/memory.py's statement tracker tree and its
thread binding: the port imports nothing of the reference package. The
server-level arbiter (ServerMemTracker, the store's root) and
`chunk_bytes` are not ported — the port has no store; a tracker tree's
root here is a plain MemTracker, whose quota is the last layer.
"""

from __future__ import annotations

import threading

from ..errors import MemoryQuotaExceeded


class MemTracker:
    """One node of the tracker tree. `quota` 0 = unlimited (still
    tracked: the parent chain needs the bytes either way)."""

    def __init__(self, quota: int = 0, label: str = "query", parent: "MemTracker | None" = None,
                 session=None):
        self.quota = quota
        self.label = label
        self.parent = parent
        self.session = session  # statement trackers: the owning session
        self.sql = ""  # statement trackers: sample text for OOM events
        self.consumed = 0
        self.max_consumed = 0
        self._dead = False  # detached: late consumes become no-ops
        self._lock = threading.Lock()
        root = self
        while root.parent is not None:
            root = root.parent
        self.root = root

    def _add(self, nbytes: int) -> bool | None:
        """Charge this node; returns True when the node is now over its
        own quota, or None when the node is DEAD (detached concurrently
        — the TOCTOU between consume's entry check and detach: the node
        absorbed nothing, so the caller must stop before charging
        ancestors bytes that can never unwind). Never raises: every
        ancestor must receive the bytes before any quota verdict, or
        detach() would later subtract bytes an ancestor never saw and
        erase OTHER statements' accounting."""
        with self._lock:
            if self._dead:
                return None
            self.consumed += nbytes
            if self.consumed > self.max_consumed:
                self.max_consumed = self.consumed
            return bool(nbytes > 0 and self.quota and self.consumed > self.quota)

    def consume(self, nbytes: int) -> None:
        """Charge this tracker and every ancestor, THEN act: the
        innermost breached quota fires first (statement cancel beats
        server arbitration, like the reference's action-chain ordering);
        otherwise the root arbitrates with the allocating leaf
        identified, so a hard-limit breach can kill the top consumer
        instead of this allocator.

        The whole up-chain walk runs under the LEAF's lock (every walk —
        consume/release/detach — starts by taking it, and lock order is
        strictly child→parent), so a concurrent detach can never snapshot
        a leaf charge that hasn't reached the ancestors yet: a straggler
        either completes its walk before detach unwinds it, or sees
        `_dead` and drops its bytes entirely — the 'tree accounting never
        leaks into the global tracker' invariant."""
        exceeded = None
        with self._lock:
            if self._dead:
                # a cop-pool worker outliving its abandoned stream: the
                # statement already detached — charging now would inflate
                # the session/server trackers forever (nothing unwinds
                # after detach)
                return
            self.consumed += nbytes
            if self.consumed > self.max_consumed:
                self.max_consumed = self.consumed
            if nbytes > 0 and self.quota and self.consumed > self.quota:
                exceeded = self
            t = self.parent
            while t is not None:
                if t._add(nbytes) and exceeded is None:
                    exceeded = t
                t = t.parent
        if exceeded is not None:
            raise MemoryQuotaExceeded(
                f"Out Of Memory Quota! [{exceeded.label}] consumed "
                f"{exceeded.consumed} > quota {exceeded.quota}"
            )

    def release(self, nbytes: int) -> None:
        with self._lock:
            if self._dead:
                return
            self.consumed = max(0, self.consumed - nbytes)
            t = self.parent
            while t is not None:
                with t._lock:
                    t.consumed = max(0, t.consumed - nbytes)
                t = t.parent

    def detach(self) -> None:
        """Statement teardown: return everything still held to every
        ancestor and drop out of the arbiter's registry. After this the
        statement's footprint is zero at every layer — success, KILL and
        BackoffExhausted unwind identically through the one finally.
        Runs under the leaf lock like every walk (see consume): in-flight
        stragglers have either fully propagated (we unwind their bytes
        here) or will see `_dead` and drop."""
        with self._lock:
            self._dead = True
            left = self.consumed
            self.consumed = 0
            t = self.parent
            while t is not None:
                with t._lock:
                    t.consumed = max(0, t.consumed - left)
                t = t.parent


# --- per-thread statement-tracker binding (the cop/engine seam) -------------

_TLS = threading.local()


class bind:
    """Bind `tracker` (may be None) to this thread for a task's duration;
    the TPU engine's transfer accounting consumes through it."""

    __slots__ = ("tracker", "prev")

    def __init__(self, tracker: MemTracker | None):
        self.tracker = tracker

    def __enter__(self):
        self.prev = getattr(_TLS, "tracker", None)
        _TLS.tracker = self.tracker
        return self.tracker

    def __exit__(self, *exc):
        _TLS.tracker = self.prev
        return False


def current_tracker() -> MemTracker | None:
    return getattr(_TLS, "tracker", None)


def consume_current(nbytes: int) -> None:
    """Charge the thread's bound statement tracker (no-op unbound). May
    raise: a quota/server-limit breach at a device transfer is a real
    allocation failure, not a device fault — classify_device_error passes
    TiDBError through untouched."""
    t = getattr(_TLS, "tracker", None)
    if t is not None and nbytes:
        t.consume(int(nbytes))
