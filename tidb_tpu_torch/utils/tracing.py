"""Structured statement tracing (ref: util/tracing + executor/trace.go,
rebuilt for the heterogeneous cop path of SURVEY §5.8).

One `StatementTrace` per statement carries two layers:

  * counters — always on, near-zero cost: per-statement exec details
    (sched_wait_ms, retries, backoff_ms, compile_ms, transfer_bytes,
    batch_occupancy, ...) that feed the slow log and STATEMENTS_SUMMARY
    even when span recording is off;
  * spans — recorded only under `TRACE <sql>` or tidb_enable_trace=ON:
    a thread-safe span tree (trace_id / span_id / parent links) covering
    every layer a cop task crosses — admission wait, launch batching,
    backoff sleeps by error class, breaker events, and the device phases
    (compile / host↔device transfer / execute).

Cross-thread plumbing is explicit, not contextvar-based: the cop pool
and the launch batcher run work on threads (and for co-batched launches,
on a DIFFERENT statement's thread) where ambient context is wrong by
construction. `activate()` binds a trace to the current thread for the
duration of a task; the batcher captures each waiter's (trace, parent)
at enqueue time and FANS OUT the one shared launch span into every
co-batched waiter's tree with identical span/launch ids — device time
spent on a shared launch is attributable from every participant's trace.

Device phases use a separate thread-local collector (`push_phases` /
`pop_phases`): the engine reports compile/transfer/execute measurements
into whichever scope is active — the cop client's for solo launches, the
batcher leader's for grouped ones — without signature changes on the
engine seam (tests and benches monkeypatch those signatures).

A copy of tidb_tpu/utils/tracing.py without its transaction trace ids and
its per-store trace ring (the port has no session or store yet): the
port imports nothing of the reference package.
"""

from __future__ import annotations

import itertools
import threading
import time

_IDS = itertools.count(1)
_TLS = threading.local()


def _next_id() -> int:
    return next(_IDS)


class Span:
    """One timed operation. `start_ns` is relative to the owning trace's
    epoch; ids are process-unique so a span fanned out into several traces
    keeps ONE identity (the launch-id contract)."""

    __slots__ = ("span_id", "parent_id", "name", "start_ns", "dur_ns", "tags")

    def __init__(self, name: str, start_ns: int, dur_ns: int = 0,
                 parent_id: int = 0, span_id: int | None = None, tags: dict | None = None):
        self.span_id = _next_id() if span_id is None else span_id
        self.parent_id = parent_id
        self.name = name
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.tags = tags if tags is not None else {}

    def copy_with_parent(self, parent_id: int) -> "Span":
        """Same span (same id/name/timing/tags) re-parented for another
        trace — the fan-out primitive."""
        return Span(self.name, self.start_ns, self.dur_ns,
                    parent_id=parent_id, span_id=self.span_id, tags=self.tags)

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id, "parent_id": self.parent_id,
            "operation": self.name,
            "start_ms": round(self.start_ns / 1e6, 3),
            "duration_ms": round(self.dur_ns / 1e6, 3),
            "tags": {k: v for k, v in self.tags.items()},
        }


class _SpanCtx:
    """Context manager for an open span; closes + appends on exit."""

    __slots__ = ("trace", "span")

    def __init__(self, trace: "StatementTrace", span: Span):
        self.trace = trace
        self.span = span

    def tag(self, **kv) -> None:
        self.span.tags.update(kv)

    def __enter__(self):
        self.trace._push(self.span)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.span.dur_ns = self.trace._now_ns() - self.span.start_ns
        if exc is not None:
            self.span.tags.setdefault("error", type(exc).__name__)
        self.trace._pop(self.span)
        return False


class _NoopSpan:
    __slots__ = ()

    def tag(self, **kv) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class StatementTrace:
    """Per-statement trace: counters always, spans when `recording`.

    Thread-safe by design: counters and the span list append under one
    lock; the open-span STACK is per (trace, thread) so concurrently
    running cop tasks each nest their own children correctly."""

    _seq = itertools.count(1)

    def __init__(self, sql: str = "", session_id: int = 0, recording: bool = False):
        self.trace_id = f"tr-{next(self._seq):06x}"
        # statements inside one BEGIN…COMMIT share a txn_trace_id (the
        # session threads it); None outside explicit transactions
        self.txn_trace_id: str | None = None
        self.sql = sql
        self.session_id = session_id
        self.recording = recording
        self.start_ts = time.time()
        self._epoch_ns = time.perf_counter_ns()
        self.end_ns: int | None = None
        self.ok = True
        self.root_id = _next_id()
        self.counters: dict[str, float] = {}
        # table ids this statement's cop tasks scanned (set adds are
        # GIL-atomic) — the workload profile's invalidation index
        self.tables: set = set()
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local() if recording else None

    # --- counters (always on) ----------------------------------------------

    def add(self, key: str, n: float = 1.0) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + n

    def set_max(self, key: str, v: float) -> None:
        with self._lock:
            if v > self.counters.get(key, 0.0):
                self.counters[key] = v

    def details(self) -> dict:
        """The slow-log / STATEMENTS_SUMMARY exec-detail columns."""
        c = self.counters
        return {
            "sched_wait_ms": c.get("sched_wait_ms", 0.0),
            "batch_occupancy": int(c.get("batch_occupancy", 0)),
            "retries": int(c.get("retries", 0)),
            "backoff_ms": c.get("backoff_ms", 0.0),
            "compile_ms": c.get("compile_ms", 0.0),
            "transfer_bytes": int(c.get("transfer_bytes", 0)),
            "mem_bytes": int(c.get("mem_bytes", 0)),
            "mem_degraded_tasks": int(c.get("mem_degraded_tasks", 0)),
            "quorum_wait_ms": c.get("quorum_wait_ms", 0.0),
        }

    # --- spans (recording only) --------------------------------------------

    def enable_recording(self) -> None:
        """Flip span recording on mid-statement (the TRACE path: the
        statement trace exists before TRACE decides to record spans)."""
        if self._local is None:
            self._local = threading.local()
        self.recording = True

    def _now_ns(self) -> int:
        return time.perf_counter_ns() - self._epoch_ns

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        with self._lock:
            self.spans.append(span)

    def current_parent(self) -> int:
        """Innermost open span on THIS thread (else the root) — the parent
        a cross-thread child (e.g. a fanned-out launch span) links under."""
        if not self.recording:
            return self.root_id
        st = getattr(self._local, "stack", None)
        return st[-1].span_id if st else self.root_id

    def span(self, name: str, **tags):
        """Open a child span on this thread; no-op when not recording."""
        if not self.recording:
            return _NOOP
        st = getattr(self._local, "stack", None)
        parent = st[-1].span_id if st else self.root_id
        return _SpanCtx(self, Span(name, self._now_ns(), parent_id=parent, tags=tags))

    def closed_span(self, name: str, dur_s: float, **tags) -> None:
        """Record an already-elapsed operation ending now (admission
        waits, backoff sleeps — measured by their owners)."""
        if not self.recording:
            return
        dur_ns = int(dur_s * 1e9)
        st = getattr(self._local, "stack", None)
        parent = st[-1].span_id if st else self.root_id
        with self._lock:
            self.spans.append(Span(name, self._now_ns() - dur_ns, dur_ns,
                                   parent_id=parent, tags=tags))

    def adopt(self, span: Span, parent_id: int, children: tuple = ()) -> None:
        """Fan-out: link a SHARED span (one launch, many waiters) into this
        trace under `parent_id`, keeping its identity; `children` (device
        phase spans already parented to it) come along unchanged."""
        if not self.recording:
            return
        with self._lock:
            self.spans.append(span.copy_with_parent(parent_id))
            self.spans.extend(children)

    def add_phase_spans(self, phases: dict) -> None:
        """Record a solo launch's device phases (compile / h2d transfer /
        execute+d2h) as spans under the calling thread's current span.
        Frames carrying real boundary events (PhaseFrame.events) keep
        their captured timestamps; a bare counters dict falls back to
        back-to-back synthesis ending now."""
        if not self.recording:
            return
        events = getattr(phases, "events", None)
        if events:
            spans = real_phase_spans(events, self.current_parent(), self._epoch_ns)
        elif phases:
            spans = phase_spans(phases, self.current_parent(), self._now_ns())
        else:
            return
        with self._lock:
            self.spans.extend(spans)

    # --- lifecycle -----------------------------------------------------------

    def finish(self, ok: bool = True) -> None:
        self.end_ns = self._now_ns()
        self.ok = ok

    def duration_ns(self) -> int:
        return self.end_ns if self.end_ns is not None else self._now_ns()

    def tree(self, extra: list[Span] | None = None) -> list[tuple[int, Span]]:
        """Depth-first (depth, span) rows, root first. Spans whose parent
        is missing (recording flipped on mid-flight) attach to the root —
        a late joiner must never corrupt the tree."""
        with self._lock:
            spans = list(self.spans)
        if extra:
            spans = spans + list(extra)
        root = Span("session.execute", 0, self.duration_ns(),
                    parent_id=0, span_id=self.root_id)
        if self.txn_trace_id:
            root.tags["txn_trace_id"] = self.txn_trace_id
        by_parent: dict[int, list[Span]] = {}
        ids = {root.span_id} | {s.span_id for s in spans}
        for s in spans:
            pid = s.parent_id if s.parent_id in ids else root.span_id
            by_parent.setdefault(pid, []).append(s)
        out: list[tuple[int, Span]] = []

        def rec(span: Span, depth: int) -> None:
            out.append((depth, span))
            for ch in sorted(by_parent.get(span.span_id, ()), key=lambda x: x.start_ns):
                rec(ch, depth + 1)

        rec(root, 0)
        return out

    def to_dict(self) -> dict:
        rows = [s.to_dict() for _, s in self.tree()]
        with self._lock:  # a straggler task may still be adding counters
            counters = dict(self.counters)
        return {
            "trace_id": self.trace_id,
            "txn_trace_id": self.txn_trace_id,
            "session_id": self.session_id,
            "sql": self.sql[:512],
            "start_ts": self.start_ts,
            "duration_ms": round(self.duration_ns() / 1e6, 3),
            "ok": self.ok,
            "counters": counters,
            "spans": rows,
        }


# --- per-thread active trace (set by the cop client around task work) -------


class activate:
    """Bind `trace` (may be None) to the current thread for a task's
    duration; the batcher and backoff machinery read it from here."""

    __slots__ = ("trace", "prev")

    def __init__(self, trace: StatementTrace | None):
        self.trace = trace

    def __enter__(self):
        self.prev = getattr(_TLS, "trace", None)
        _TLS.trace = self.trace
        return self.trace

    def __exit__(self, *exc):
        _TLS.trace = self.prev
        return False


def current_trace() -> StatementTrace | None:
    return getattr(_TLS, "trace", None)


# --- device-phase collector (engine → whoever wrapped the launch) -----------


class PhaseFrame(dict):
    """One launch's device-phase measurements. The dict half is the
    counters contract (compile_ms, h2d_bytes/ms, execute_ms, d2h_bytes —
    what `phase_counters` folds into exec details); `events` carries the
    upgrade: individually-timestamped `(name, t_start_ns, t_end_ns,
    tags)` boundary events from ONE monotonic clock
    (`time.perf_counter_ns`), so trace spans show the REAL device
    timeline instead of walls synthesized back-to-back. Code that hands
    `_attribute`/`add_phase_spans` a plain dict (tests, external shims)
    still works — it just falls back to synthesis."""

    __slots__ = ("events",)

    def __init__(self):
        super().__init__()
        self.events: list[tuple[str, int, int, dict]] = []


def push_phases() -> tuple:
    prev = getattr(_TLS, "phases", None)
    d = PhaseFrame()
    _TLS.phases = d
    return prev, d


def pop_phases(token: tuple) -> PhaseFrame:
    _TLS.phases = token[0]
    return token[1]


class collect_phases:
    """`with collect_phases() as ph:` — ph accumulates the device-phase
    measurements (compile_ms, h2d_bytes/ms, execute_ms, d2h_bytes) the
    engine emits while the block runs on this thread."""

    __slots__ = ("_token",)

    def __enter__(self) -> dict:
        self._token = push_phases()
        return self._token[1]

    def __exit__(self, *exc):
        pop_phases(self._token)
        return False


def add_phase(key: str, n: float) -> None:
    d = getattr(_TLS, "phases", None)
    if d is not None:
        d[key] = d.get(key, 0.0) + n


def add_phase_event(name: str, t_start_ns: int, t_end_ns: int, **tags) -> None:
    """Record one individually-timestamped device boundary event
    (compile / h2d upload / execute+fetch / cache ref) into the active
    phase frame. Timestamps are absolute `time.perf_counter_ns` readings;
    consumers rebase against their own epoch (trace or timeline ring) —
    the clocks agree because there is only one."""
    d = getattr(_TLS, "phases", None)
    if d is not None:
        ev = getattr(d, "events", None)
        if ev is not None:
            ev.append((name, t_start_ns, t_end_ns, tags))


def real_phase_spans(events, parent_id: int, epoch_ns: int) -> list[Span]:
    """Device-phase child spans from REAL captured timestamps: each
    event's start rebases from the shared monotonic clock onto the
    consuming trace's epoch — gaps between phases survive, nothing is
    laid back-to-back."""
    return [
        Span(name, t0 - epoch_ns, t1 - t0, parent_id=parent_id, tags=dict(tags))
        for name, t0, t1, tags in events
    ]


def phase_counters(phases: dict) -> list[tuple[str, float]]:
    """(exec-detail key, value) pairs for a launch's device phases — the
    ONE phase→counter mapping, shared by solo attribution
    (copr/client._note_device_phases) and grouped fan-out
    (sched/batcher._attribute) so both EXPLAIN ANALYZE `device:` paths
    can never drift apart."""
    out = []
    if phases.get("compile_ms"):
        out.append(("compile_ms", phases["compile_ms"]))
    tb = phases.get("h2d_bytes", 0.0) + phases.get("d2h_bytes", 0.0)
    if tb:
        out.append(("transfer_bytes", tb))
    dm = phases.get("execute_ms", 0.0) + phases.get("h2d_ms", 0.0)
    if dm:
        out.append(("device_ms", dm))
    if phases.get("cache_ref_bytes"):
        # device-cache hits: bytes SERVED from a prior statement's upload
        # (zero-duration cache_ref annotation), never charged as transfer
        out.append(("cache_ref_bytes", phases["cache_ref_bytes"]))
    # tile-codec split of the h2d uploads: what the lanes represent
    # uncompressed vs what the narrowed/compressed form actually moved
    if phases.get("logical_bytes"):
        out.append(("logical_bytes", phases["logical_bytes"]))
    if phases.get("wire_bytes"):
        out.append(("wire_bytes", phases["wire_bytes"]))
    return out


def phase_spans(phases: dict, parent_id: int, end_ns: int) -> list[Span]:
    """Synthesize the device-phase child spans (compile → h2d transfer →
    execute+d2h) under `parent_id`, laid out back-to-back ending at
    `end_ns` (phase walls are measured, their gaps are not)."""
    segs = []
    if phases.get("compile_ms"):
        segs.append(("device.compile", phases["compile_ms"], {}))
    if phases.get("h2d_bytes") or phases.get("h2d_ms"):
        segs.append(("device.transfer", phases.get("h2d_ms", 0.0),
                     {"dir": "h2d", "bytes": int(phases.get("h2d_bytes", 0))}))
    if phases.get("execute_ms") or phases.get("d2h_bytes"):
        segs.append(("device.execute", phases.get("execute_ms", 0.0),
                     {"d2h_bytes": int(phases.get("d2h_bytes", 0))}))
    out = []
    start = end_ns - int(sum(d for _, d, _ in segs) * 1e6)
    for name, dur_ms, tags in segs:
        dur_ns = int(dur_ms * 1e6)
        out.append(Span(name, start, dur_ns, parent_id=parent_id, tags=tags))
        start += dur_ns
    return out
