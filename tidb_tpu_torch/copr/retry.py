"""Typed retry/backoff + TPU-engine circuit breaker for the cop path
(ref: store/tikv/retry/backoff.go Backoffer/Config; kv/error.go).

The reference survives a hostile distributed substrate by classifying
every fault into a named backoff class (regionMiss, updateLeader,
serverBusy, ...) with its own exponential-with-jitter sleep curve, all
drawing from one per-request sleep budget. This module is that machinery
rebuilt for a heterogeneous substrate: region errors AND accelerator
faults share one Backoffer, and the TPU engine additionally sits behind a
circuit breaker so a *persistently* failing device path stops costing
every query an exception before the host fallback answers.

Waits are deadline/KILL-aware through the admission scheduler's shared
gate (`sched.scheduler.raise_if_interrupted`): a task sleeping in backoff
observes KILL or max_execution_time within one poll interval.

A copy of tidb_tpu/copr/retry.py with one deliberate change. The
reference triages a device fault by substrings of XLA's status text
(`_TRANSIENT_MARKERS`: XLA's RESOURCE_EXHAUSTED is retried). A card's
faults carry no such text — a `torch.cuda.OutOfMemoryError` matches no
marker, so it would count as fatal and trip the breaker. So the port's
device boundaries type their faults themselves (`device_boundary`, used
by copr/gpu_engine.py around every launch and fetch): running out of
device memory is a DeviceTransientError, any other runtime error of the
card (a refused launch, a CUDA fault) a DeviceFatalError, and
`classify_device_error` passes both through. The marker triage stays for
faults raised elsewhere.
"""

from __future__ import annotations

import itertools
import random
import time
import weakref
from dataclasses import dataclass
from threading import Lock

from ..errors import (
    BackoffExhausted,
    CircuitBreakerOpen,
    DeviceFatalError,
    DeviceTransientError,
    RegionError,
    TiDBError,
)
import torch

from ..sched.scheduler import sleep_interruptible
from ..utils import metrics as M


@dataclass(frozen=True)
class BackoffConfig:
    """One retriable-error class: its sleep curve (ref: retry.Config —
    base/cap exponential, jitter flavor) keyed by the name metrics and
    error messages use."""

    name: str
    base_ms: float
    cap_ms: float
    jitter: str = "full"  # "full" | "equal" | "none"

    def sleep_ms(self, attempt: int, rng: random.Random) -> float:
        raw = min(self.base_ms * (2.0 ** attempt), self.cap_ms)
        if self.jitter == "full":
            return rng.uniform(0.0, raw)
        if self.jitter == "equal":
            return raw / 2.0 + rng.uniform(0.0, raw / 2.0)
        return raw


# the typed classes (ref: retry.BoRegionMiss, BoUpdateLeader, BoTiKVServerBusy)
BO_REGION_MISS = BackoffConfig("regionMiss", 2.0, 500.0)
BO_UPDATE_LEADER = BackoffConfig("updateLeader", 1.0, 200.0)
BO_SERVER_BUSY = BackoffConfig("serverBusy", 5.0, 1000.0, "equal")
BO_DEVICE = BackoffConfig("deviceTransient", 1.0, 200.0)

# per-task sleep budget (ref: CopNextMaxBackoff = 20s, scaled to this
# store's in-process latencies)
COP_BACKOFF_BUDGET_MS = 2000.0

# default jitter source for every Backoffer (GIL-serialized; interleaved
# draws are fine for jitter)
_SHARED_RNG = random.Random()


class Backoffer:
    """Per-cop-task retry budget: every retriable fault calls
    `backoff(cfg, err)`, which sleeps per the class curve and accounts the
    sleep against one shared budget. Exhausting the budget raises
    `BackoffExhausted` naming the region, per-class attempt counts and the
    last error — the caller fails the stream with that, siblings retry on
    their own Backoffers (per-task isolation)."""

    def __init__(self, budget_ms: float = COP_BACKOFF_BUDGET_MS, deadline=None,
                 session=None, rng: random.Random | None = None, stats=None,
                 trace=None):
        self.budget_ms = budget_ms
        self.deadline = deadline
        self.session = session
        self.abort = None  # optional Event: owning stream was abandoned
        self.trace = trace  # StatementTrace: backoff sleeps become spans
        self.slept_ms = 0.0
        self.attempts: dict[str, int] = {}
        self.errors: list[BaseException] = []
        # shared module RNG by default: seeding a fresh Random() per
        # statement costs ~80µs of os.urandom — pure hot-path churn for
        # backoff jitter nobody needs to be independent (tests that want
        # determinism still pass their own rng)
        self._rng = rng or _SHARED_RNG
        self._stats = stats  # optional callable(key, n) — client counters
        self._runaway = None  # RunawayChecker, for in-flight COOLDOWN
        self._demote_applied = False

    @classmethod
    def for_ctx(cls, sctx, budget_ms: float | None = None, stats=None):
        """Build from a SchedCtx (or None) so backoff waits observe the
        same deadline/KILL state admission waits do. The budget comes from
        the context's `backoff_budget_ms` (the tidb_backoff_budget_ms
        sysvar / SET_VAR hint) unless overridden, falling back to the
        compiled-in default."""
        if budget_ms is None:
            budget_ms = getattr(sctx, "backoff_budget_ms", None)
        if budget_ms is None:
            budget_ms = COP_BACKOFF_BUDGET_MS
        rc = getattr(sctx, "runaway", None)
        if rc is not None and rc.demoted:
            # runaway COOLDOWN: a demoted statement gets a quarter of the
            # sleep budget — less patience for a known misbehaver
            budget_ms *= 0.25
        bo = cls(
            budget_ms,
            deadline=getattr(sctx, "deadline", None),
            session=getattr(sctx, "session", None),
            stats=stats,
            trace=getattr(sctx, "trace", None),
        )
        # keep the checker: a COOLDOWN verdict landing MID-statement must
        # demote the budget still unspent, not wait for the next statement
        bo._runaway = rc
        bo._demote_applied = rc is not None and rc.demoted
        return bo

    @property
    def total_attempts(self) -> int:
        return sum(self.attempts.values())

    def backoff(self, cfg: BackoffConfig, err: BaseException) -> None:
        """Record `err` under `cfg`'s class and sleep its next interval;
        raises BackoffExhausted when the budget can't cover the sleep, and
        QueryInterrupted the moment a KILL/deadline lands mid-sleep."""
        rc = self._runaway
        if rc is not None and rc.demoted and not self._demote_applied:
            # the COOLDOWN verdict fired while this statement was already
            # retrying: quarter the budget it has NOT yet slept, effective
            # from this very backoff — not from its next statement
            self._demote_applied = True
            self.budget_ms = self.slept_ms + (self.budget_ms - self.slept_ms) * 0.25
        n = self.attempts.get(cfg.name, 0)
        self.attempts[cfg.name] = n + 1
        self.errors.append(err)
        M.COP_RETRIES.inc(reason=cfg.name)
        if self._stats is not None:
            self._stats("retries", 1)
        sleep = cfg.sleep_ms(n, self._rng)
        if self.slept_ms + sleep > self.budget_ms:
            raise BackoffExhausted(self._exhausted_msg(err)) from err
        self.slept_ms += sleep
        if self._stats is not None:
            self._stats("backoff_ms", sleep)
        M.COP_BACKOFF.observe(sleep / 1000.0)
        sleep_interruptible(
            sleep / 1000.0, self.deadline, self.session,
            stop=self.abort.is_set if self.abort is not None else None,
        )
        if self.trace is not None and self.trace.recording:
            # after the sleep so the span is closed (back-dated) — a
            # KILL/deadline escape mid-sleep skips it with the exception
            self.trace.closed_span(
                f"backoff.{cfg.name}", sleep / 1000.0,
                attempt=n + 1, error=type(err).__name__,
            )

    def _exhausted_msg(self, last_err: BaseException) -> str:
        region = next(
            (e.region_id for e in reversed(self.errors)
             if isinstance(e, RegionError) and e.region_id is not None),
            None,
        )
        per_class = ", ".join(f"{k}:{v}" for k, v in sorted(self.attempts.items()))
        where = f"region {region}" if region is not None else "task"
        return (
            f"cop task backoff budget exhausted ({self.budget_ms:.0f}ms slept "
            f"{self.slept_ms:.0f}ms) for {where} after {self.total_attempts} "
            f"attempts ({per_class}); last error: {last_err}"
        )


# --- engine-boundary fault classification ---------------------------------

# substrings marking a device fault worth retrying on-device (XLA runtime
# status codes + tunnel/transport hiccups); everything else device-side is
# fatal and feeds the breaker
_TRANSIENT_MARKERS = (
    "resource_exhausted", "unavailable", "deadline_exceeded", "aborted",
    "cancelled", "preempt", "connection", "socket", "tunnel", "timed out",
    "timeout", "temporarily",
)


def classify_device_error(exc: BaseException):
    """Triage an exception escaping the TPU engine (replaces the blanket
    `except Exception` fallback): returns a DeviceTransientError /
    DeviceFatalError, or None when the exception is NOT a device fault at
    all (interrupts, quota, SQL runtime errors) and must propagate to the
    caller untouched — neither retried, breaker-counted, nor absorbed by
    the host fallback."""
    if isinstance(exc, (DeviceTransientError, DeviceFatalError)):
        return exc
    if isinstance(exc, TiDBError):
        return None
    msg = f"{type(exc).__name__}: {exc}"
    low = msg.lower()
    if any(m in low for m in _TRANSIENT_MARKERS):
        return DeviceTransientError(msg)
    return DeviceFatalError(msg)


class device_boundary:
    """`with device_boundary(on_card):` around device work: a
    `torch.cuda.OutOfMemoryError` leaves as a DeviceTransientError, and —
    when the work runs on a card — any other RuntimeError (a kernel
    wrapper's refused launch, a CUDA fault surfacing at a synchronization)
    as a DeviceFatalError; SQL errors (TiDBError), a path not ported yet
    (NotImplementedError) and argument errors pass untouched. On the CPU
    a RuntimeError is a bug of the plain versions, not a device fault, and
    passes untouched too."""

    __slots__ = ("on_card",)

    def __init__(self, on_card: bool):
        self.on_card = on_card

    def __enter__(self):
        return self

    def __exit__(self, et, exc, tb):
        if exc is None or isinstance(exc, (TiDBError, NotImplementedError)):
            return False
        if isinstance(exc, torch.cuda.OutOfMemoryError):
            raise DeviceTransientError(f"{type(exc).__name__}: {exc}") from exc
        if self.on_card and isinstance(exc, RuntimeError):
            raise DeviceFatalError(f"{type(exc).__name__}: {exc}") from exc
        return False


# --- the one shared device-boundary guard ----------------------------------


def guarded_device_call(fn, bo: "Backoffer", breakers=(), forced: bool = False,
                        failpoint: str | None = None):
    """Run a device-path callable under the unified fault domain — the
    MPP gather and the device window route share this with the cop
    path's inline boundary (client._run_engines), so every device entry
    point fails the same way:

      * escaping exceptions are CLASSIFIED (classify_device_error) —
        interrupts / quota / SQL errors propagate untouched (any claimed
        half-open probe slot is released, no fault counted);
      * every device fault feeds every breaker in `breakers` (one event
        per exception instance per breaker);
      * transients retry through `bo` (per-task budget, KILL/deadline-
        aware sleeps) while no breaker has tripped;
      * with `forced` (engine='tpu' / enforce), the typed error raises;
        otherwise the terminal fault is RETURNED so the caller degrades
        to host with a typed reason and zero further exception cost.

    Returns (result, None) on success — breakers hear record_success
    only when `result is not None`, because a None result means the
    callable declined before touching the device (a half-open probe must
    not close on no evidence) — or (None, err) when the device path
    lost. tools/lint_boundaries.py pins this as the ONE sanctioned
    blanket-except site for the MPP/window boundaries."""
    from ..utils.failpoint import inject as _fp

    while True:
        try:
            if failpoint is not None:
                _fp(failpoint)
            res = fn()
        except Exception as exc:  # noqa: BLE001 — classified, never absorbed
            err = classify_device_error(exc)
            if err is None:
                for b in breakers:
                    b.record_aborted()
                raise
            tripped = False
            for b in breakers:
                tripped = b.record_failure(exc) or tripped
            if isinstance(err, DeviceTransientError) and not tripped:
                try:
                    bo.backoff(BO_DEVICE, err)
                except BackoffExhausted as bex:
                    err = bex
                else:
                    continue
            if forced:
                raise err from exc
            return None, err
        if res is not None:
            for b in breakers:
                b.record_success()
        return res, None


# --- circuit breaker --------------------------------------------------------


class CircuitBreaker:
    """TPU-engine circuit breaker: closed → open after `threshold`
    CONSECUTIVE device faults (each success resets the run), open →
    half-open after `cooldown_s`, half-open admits exactly ONE probe —
    success closes the breaker, failure re-opens it for another cooldown.

    While open, `auto` traffic routes straight to the host engine at zero
    exception cost and `engine='tpu'` raises CircuitBreakerOpen carrying
    `describe()`. State/trips surface in /metrics (tidb_tpu_breaker_*)
    and EXPLAIN ANALYZE's tpu line."""

    FAIL_THRESHOLD = 5
    COOLDOWN_S = 30.0

    _STATE_GAUGE = {"closed": 0.0, "half-open": 1.0, "open": 2.0}
    _seq = itertools.count()

    def __init__(self, threshold: int | None = None, cooldown_s: float | None = None,
                 clock=time.monotonic, label: str | None = None):
        self.threshold = self.FAIL_THRESHOLD if threshold is None else threshold
        self.cooldown_s = self.COOLDOWN_S if cooldown_s is None else cooldown_s
        self._clock = clock
        self._lock = Lock()
        # breakers are per-engine: the published series is labeled so two
        # stores in one process can't clobber each other's state
        self.label = label if label is not None else f"e{next(self._seq)}"
        self.state = "closed"
        self.trips = 0
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False  # a half-open probe is in flight
        self._probe_at = 0.0
        # identity ring of already-counted fault events: WEAK refs — a
        # strong ring would pin up to 8 tracebacks (and the batch locals
        # in their frames) to this process-lifetime engine singleton
        self._counted: list = []
        # no eager publish: a series appears only on the first transition,
        # so idle breakers (one per short-lived embedded store) don't leak
        # dead label values into the process-global registry

    def allow(self) -> bool:
        """May the next task try the device path? Flips open → half-open
        once the cooldown has passed, and admits one probe at a time. A
        probe that never reported back (its thread died outside the
        record_* paths) goes stale after another cooldown and the probe
        slot is re-granted — the breaker can't wedge in half-open."""
        with self._lock:
            if self.state == "closed":
                return True
            now = self._clock()
            if self.state == "open" and now - self._opened_at >= self.cooldown_s:
                self.state = "half-open"
                self._probing = False
                self._publish_locked()
            if self.state == "half-open":
                if self._probing and now - self._probe_at >= self.cooldown_s:
                    self._probing = False  # lost probe: reclaim the slot
                if not self._probing:
                    self._probing = True
                    self._probe_at = now
                    return True
            return False

    def record_success(self) -> None:
        """A successful device run: resets the consecutive-fault count;
        closes the breaker only from half-open (the probe's success). A
        straggler admitted before a trip must NOT close an OPEN breaker —
        that would bypass the cooldown + single-probe protocol whenever a
        device faults for only some program keys."""
        with self._lock:
            self._consecutive = 0
            self._probing = False
            if self.state == "half-open":
                self.state = "closed"
                self._publish_locked()

    def record_aborted(self) -> None:
        """The device attempt ended for a NON-device reason (KILL, quota,
        queue-full): releases a held probe slot without counting a fault
        either way."""
        with self._lock:
            self._probing = False

    def record_failure(self, err: BaseException | None = None) -> bool:
        """Count one device fault; returns True when the breaker is (now)
        open. One fault EVENT counts once: co-batched/dedup'd cop tasks
        that all failed from a single launch share one exception instance
        (sched/batcher.py fans `j.exc` out to every follower), and N
        waiters of one blip must not masquerade as N consecutive faults.
        Real faults arrive as fresh instances and always count."""
        with self._lock:
            if err is not None:
                if any(r() is err for r in self._counted):
                    self._probing = False
                    return self.state == "open"
                try:
                    self._counted.append(weakref.ref(err))
                    del self._counted[:-8]
                except TypeError:
                    pass  # exception type without weakref support: count always
            self._consecutive += 1
            tripped = (
                self.state == "half-open"
                or (self.state == "closed" and self._consecutive >= self.threshold)
            )
            self._probing = False
            if tripped:
                self.state = "open"
                self._opened_at = self._clock()
                self.trips += 1
                M.BREAKER_TRIPS.inc(engine=self.label)
                self._publish_locked()
            return self.state == "open"

    def is_open(self) -> bool:
        with self._lock:
            return self.state == "open"

    def describe(self) -> str:
        with self._lock:
            return (
                f"state={self.state} consecutive_faults={self._consecutive} "
                f"trips={self.trips} cooldown_s={self.cooldown_s}"
            )

    def raise_open(self) -> None:
        raise CircuitBreakerOpen(
            f"TPU engine circuit breaker rejected the request ({self.describe()}); "
            f"use engine='host'/'auto' or wait out the cooldown"
        )

    def _publish_locked(self) -> None:
        M.BREAKER_STATE.set(self._STATE_GAUGE[self.state], engine=self.label)
