"""Cop-task admission scheduler — the unified-read-pool analog
(ref: the reference's tikv unified read pool + resource_control admission:
tasks queue per priority, a token-bucket debt check gates each resource
group, and the scheduler grants device slots to the highest-priority
admissible waiter first).

Admission is INLINE: the thread that will execute the cop task (a session
thread or a cop pool worker) blocks in `acquire` until a slot and its
group's RU budget are both available, then runs the task wherever it
already is and calls `release` with the measured RU cost. That keeps the
executor topology untouched (no second thread pool to hand work to) while
still giving global cross-session admission: every session over one store
shares one scheduler via `Storage.sched`.

Waiting is deadline- and kill-aware: a queued task whose statement
deadline (max_execution_time) passes fails with the MySQL timeout error
before it ever touches the device, and KILL marks propagate exactly like
the executor chunk-boundary checks (executor/executors.py:79).

A copy of tidb_tpu/sched/scheduler.py. The runaway watchdog a
SchedCtx may carry (sched/runaway.py) is not ported: `runaway` stays None.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass

from ..errors import MemoryQuotaExceeded, QueryInterrupted, ResourceGroupQueueFull
from ..utils import metrics as M
from ..utils.failpoint import inject as _fp
from .resource_group import PRIORITIES, ResourceGroupManager


@dataclass
class SchedCtx:
    """Per-statement admission context, captured on the session thread
    (contextvars do not cross the cop pool boundary)."""

    group: str = "default"
    deadline: float | None = None  # time.monotonic() deadline, from max_execution_time
    session: object = None  # for KILL checks while queued
    enabled: bool = True
    trace: object = None  # StatementTrace: per-statement spans + exec details
    backoff_budget_ms: float | None = None  # tidb_backoff_budget_ms (None = default)
    runaway: object = None  # RunawayChecker: QUERY_LIMIT watchdog + watch list
    mem: object = None  # statement MemTracker: device transfers consume here
    # workload-history feedback routing: the statement's digest
    # keys the store's WorkloadProfile; `feedback` mirrors the live
    # GLOBAL tidb_tpu_feedback_route (OFF = static heuristics, bit-exact)
    digest: str | None = None
    feedback: bool = False


@dataclass
class Ticket:
    group: object  # ResourceGroup
    est: float
    wait_s: float = 0.0


@dataclass
class _Waiter:
    priority: int
    seq: int
    group: object
    granted: bool = False


def ru_cost(rows: int, nbytes: float = 0.0, cpu_ms: float = 0.0) -> float:
    """RU model: one base unit per cop task plus one per KiRow scanned
    plus one per 64KiB of batch data touched (the read-request +
    read-byte split of the reference's RU formula — the byte term makes
    wide-row scans cost what they move, not just what they count; 64KiB
    per RU mirrors the reference's ReadBytesCost) plus one per 3ms of
    MEASURED host-engine CPU wall (the reference's CPUMsCost — the term
    this model was missing until the workload-history plane started
    measuring host walls per task; device-path tasks charge 0
    here, their cost lives in the byte term)."""
    return 1.0 + rows / 1024.0 + nbytes / 65536.0 + cpu_ms / 3.0


def raise_if_interrupted(session=None, deadline=None) -> None:
    """The deadline/KILL gate, shared by admission waits, cop-path
    backoff sleeps (copr/retry.py) AND executor chunk boundaries
    (executor/executors.py drain): one definition of "stop now" so a
    KILLed or timed-out statement escapes every wait the same way. The
    raised error carries `.reason` ("killed" | "timeout" | "oom" |
    "runaway") for metric labeling.

    Two protection layers piggyback this poll tick: a session KILLed by
    the server memory arbiter carries reason "oom" and raises the 8175
    quota error instead of a generic interrupt, and the statement's
    runaway checker (session._runaway, sched/runaway.py) ticks its
    QUERY_LIMIT thresholds here — no watchdog thread, the gate IS the
    watchdog's clock."""
    if session is not None:
        if getattr(session, "_killed", False):
            session._killed = False
            reason = getattr(session, "_kill_reason", None)
            if reason is not None:
                session._kill_reason = None
            if reason == "oom":
                from ..errors import ServerMemoryExceeded

                e = ServerMemoryExceeded(
                    "Out Of Memory Quota! statement killed by the server "
                    "memory arbiter (tidb_server_memory_limit exceeded; this "
                    "statement was the top consumer)"
                )
                e.reason = "oom"
                raise e
            e = QueryInterrupted("Query execution was interrupted")
            e.reason = "killed"
            raise e
        rc = getattr(session, "_runaway", None)
        if rc is not None:
            rc.tick()
    if deadline is not None and time.monotonic() >= deadline:
        e = QueryInterrupted(
            "Query execution was interrupted, maximum statement execution time exceeded"
        )
        e.reason = "timeout"
        raise e


def sleep_interruptible(seconds: float, deadline=None, session=None, stop=None) -> None:
    """Deadline/KILL-aware sleep: naps in scheduler-tick slices so a task
    backing off between retries observes KILL / max_execution_time within
    one poll interval instead of finishing its full backoff first. `stop`
    (optional () -> bool) aborts the wait the same way when its stream was
    abandoned — the drain path must not ride out full backoff budgets."""
    end = time.monotonic() + seconds
    while True:
        # abandon check FIRST: raise_if_interrupted consumes the one-shot
        # _killed flag, and an abandoned task's interrupt is swallowed by
        # the stream drain — it must not eat a KILL meant for live work
        if stop is not None and stop():
            e = QueryInterrupted("cop stream abandoned")
            e.reason = "abandoned"
            raise e
        raise_if_interrupted(session, deadline)
        now = time.monotonic()
        if now >= end:
            return
        nap = min(AdmissionScheduler._TICK_S, end - now)
        if deadline is not None:
            nap = min(nap, max(deadline - now, 0.001))
        time.sleep(nap)


class AdmissionScheduler:
    MAX_QUEUE = 256  # waiters beyond this hard-fail (backpressure edge)
    EST_RU = 1.0  # debited at admission, settled at release
    _TICK_S = 0.05  # poll cadence for bucket refills / kill marks
    # BURSTABLE borrow gate: a burstable group in RU debt may
    # still admit while the store runs below this fraction of its device
    # slots — measured headroom, not an unlimited bucket. At/above it
    # the group throttles at its reserved ru_per_sec like any other.
    BORROW_HEADROOM = 0.75

    def __init__(self, groups: ResourceGroupManager, max_concurrency: int = 32):
        self.groups = groups
        self.max_concurrency = max_concurrency
        self._cond = threading.Condition()
        self._running = 0
        self._waiting: list[_Waiter] = []
        self._seq = itertools.count()

    # --- introspection (memtables / tests) ---------------------------------

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._waiting)

    def running(self) -> int:
        with self._cond:
            return self._running

    def _headroom_locked(self) -> bool:
        """Measured store headroom for BURSTABLE borrowing: true while
        running work occupies less than BORROW_HEADROOM of the device
        slots (caller holds self._cond)."""
        return self._running < max(1, int(self.max_concurrency * self.BORROW_HEADROOM))

    # --- admission ----------------------------------------------------------

    def acquire(self, ctx: SchedCtx, stop=None) -> Ticket:
        """`stop` (optional () -> bool): abort the wait when the owning
        cop stream was abandoned — a drained task must not sit out the
        admission queue to run work whose result is already discarded."""
        _fp("sched/before-admit")
        g = self.groups.get(ctx.group)
        rc = getattr(ctx, "runaway", None)
        if rc is not None:
            # runaway control gates admission itself: a watch-listed
            # digest is rejected (KILL) or demoted (COOLDOWN) here,
            # before a ticket or RU estimate is consumed
            rc.on_admission()
        t0 = time.monotonic()
        with self._cond:
            if not self._waiting and self._running < self.max_concurrency \
                    and g.bucket.admissible(headroom=self._headroom_locked()):
                self._running += 1
                g.bucket.debit(self.EST_RU)
                M.SCHED_TASKS.inc(group=g.name, outcome="admitted")
                M.SCHED_WAIT.observe(0.0)
                if ctx.trace is not None and ctx.trace.recording:
                    ctx.trace.closed_span("sched.admission", 0.0, group=g.name, queued=False)
                return Ticket(g, self.EST_RU)
            if len(self._waiting) >= self.MAX_QUEUE:
                # backpressure hard edge — typed as ServerBusy so the cop
                # client retries it through the Backoffer's serverBusy
                # class before surfacing (the retry taxonomy, exercised here)
                M.SCHED_TASKS.inc(group=g.name, outcome="rejected")
                raise ResourceGroupQueueFull(
                    f"resource group '{g.name}' admission queue is full "
                    f"({self.MAX_QUEUE} waiting); retry later"
                )
            # a COOLDOWN-demoted statement queues at LOW priority no
            # matter what its group grants (the runaway demotion)
            prio = PRIORITIES["LOW"] if (rc is not None and rc.demoted) else g.priority_value
            w = _Waiter(prio, next(self._seq), g)
            self._waiting.append(w)
            M.SCHED_QUEUE_DEPTH.set(len(self._waiting))
            try:
                while True:
                    self._grant_locked()
                    if w.granted:
                        break
                    if stop is not None and stop():
                        M.SCHED_TASKS.inc(group=g.name, outcome="abandoned")
                        e = QueryInterrupted("cop stream abandoned")
                        e.reason = "abandoned"
                        raise e
                    try:
                        raise_if_interrupted(ctx.session, ctx.deadline)
                    except (QueryInterrupted, MemoryQuotaExceeded) as e:
                        # MemoryQuotaExceeded covers the oom-arbiter kill
                        # (ServerMemoryExceeded, reason "oom") — it is a
                        # quota error, not a QueryInterrupted subclass
                        M.SCHED_TASKS.inc(
                            group=g.name, outcome=getattr(e, "reason", "killed")
                        )
                        raise
                    if rc is not None and rc.demoted and w.priority != PRIORITIES["LOW"]:
                        # the COOLDOWN verdict fired while this task was
                        # ALREADY queued (rc.tick above): demote the live
                        # waiter now — the next _grant_locked pass sorts
                        # it behind every normal-priority waiter instead
                        # of honoring the priority it enqueued with
                        w.priority = PRIORITIES["LOW"]
                    now = time.monotonic()
                    timeout = self._TICK_S
                    if ctx.deadline is not None:
                        timeout = min(timeout, max(ctx.deadline - now, 0.001))
                    self._cond.wait(timeout)
            finally:
                if not w.granted and w in self._waiting:
                    self._waiting.remove(w)
                M.SCHED_QUEUE_DEPTH.set(len(self._waiting))
        wait = time.monotonic() - t0
        M.SCHED_WAIT.observe(wait)
        M.SCHED_TASKS.inc(group=g.name, outcome="admitted")
        if ctx.trace is not None and ctx.trace.recording:
            ctx.trace.closed_span("sched.admission", wait, group=g.name, queued=True)
        return Ticket(g, self.EST_RU, wait)

    def _grant_locked(self) -> None:
        """Grant free slots to waiters: strict priority order, FIFO within
        a priority, skipping groups whose bucket is in debt (they neither
        run nor block higher/other groups — no head-of-line starvation)."""
        granted_any = False
        while self._running < self.max_concurrency and self._waiting:
            chosen = None
            hr = self._headroom_locked()  # re-read per grant: each fills a slot
            for w in sorted(self._waiting, key=lambda x: (-x.priority, x.seq)):
                if w.group.bucket.admissible(headroom=hr):
                    chosen = w
                    break
            if chosen is None:
                break  # every waiting group is bucket-starved; refill will re-grant
            self._waiting.remove(chosen)
            chosen.group.bucket.debit(self.EST_RU)
            self._running += 1
            chosen.granted = True
            granted_any = True
        if granted_any:
            M.SCHED_QUEUE_DEPTH.set(len(self._waiting))
            self._cond.notify_all()

    def release(self, ticket: Ticket, ru: float | None = None) -> None:
        ru = ticket.est if ru is None else ru
        extra = ru - ticket.est
        if extra > 0:
            ticket.group.bucket.debit(extra)
        elif extra < 0:
            ticket.group.bucket.credit(-extra)
        M.RU_CONSUMED.inc(ru, group=ticket.group.name)
        with self._cond:
            self._running -= 1
            self._grant_locked()
            self._cond.notify_all()
