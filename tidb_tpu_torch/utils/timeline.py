"""Device timeline profiler — individually-timestamped phase events.

Statement traces once carried device phases as walls accumulated in a
dict and synthesized back-to-back; tensor-runtime query engines need the
real device timeline (arXiv:2203.01877 attributes latency to
compile/transfer/kernel phases on it; arXiv:2604.28079 argues for
per-launch, per-lane profiling). This module is that timeline: a bounded
per-store ring (`Storage.timeline`, next to `trace_ring`) of events with
`t_start_ns`/`t_end_ns` captured from ONE monotonic clock
(`time.perf_counter_ns`) at the actual engine boundaries —
first-dispatch compile, each h2d upload, each jitted dispatch, each d2h
fetch (`copr/tpu_engine.py`) — and at the batcher's launch lifecycle
(enqueue → leader-elected → flush → fan-out, `sched/batcher.py`).

Lanes map to Chrome trace-event (pid, tid) pairs, loadable in Perfetto
via `/debug/timeline` (or `chrome://tracing`):

  * pid DEVICE — one tid per REAL device lane (`cpu:3`, `tpu:0`) when
    the per-device dispatch path bound one via `device_scope`
    (runner lanes are the mesh devices, serialized by each lane's launch
    lock), falling back to the runner thread's name for unpinned
    engine work. Events within a lane are PROPERLY NESTED by
    construction (one lock / one thread, one clock): phase events are
    pairwise disjoint, and a `cop.launch` — one per launch, solo or
    grouped, args carrying launch id, occupancy, shared-upload bytes
    and every co-batched waiter's trace id — fully encloses the phase
    events recorded during the launch (rendered as a nested slice).
    Partial overlap, which the Chrome format cannot represent on one
    tid, never occurs.
  * pid GROUPS — one tid per (resource group, thread): statement walls
    and launch lifecycle events, clustered by the leading group name in
    the UI. The thread split keeps concurrent same-group statements off
    one tid (complete events on a tid must not partially overlap).

Cross-thread plumbing mirrors `utils/tracing`: `bind()` attaches the
store's ring (plus the statement's resource group) to the current thread
for the duration of an engine call; the engine hooks read it from TLS,
so the uninstrumented path costs one TLS miss. `SET GLOBAL
tidb_enable_timeline` flips recording store-wide.

A copy of tidb_tpu/utils/timeline.py without its Chrome-trace export
(the port has no `/debug/timeline` reader yet): the port imports
nothing of the reference package.
"""

from __future__ import annotations

import threading
import time
from collections import deque

_TLS = threading.local()

# lane kinds → Chrome trace pids (process_name metadata at export)
PID_DEVICE = 1
PID_GROUPS = 2


class TimelineEvent:
    """One timed operation on the device timeline. Timestamps are
    absolute `time.perf_counter_ns()` readings — the ring's epoch (taken
    from the same clock) rebases them for export."""

    __slots__ = ("name", "cat", "t_start_ns", "t_end_ns", "pid", "lane", "args")

    def __init__(self, name: str, cat: str, t_start_ns: int, t_end_ns: int,
                 pid: int, lane: str, args: dict):
        self.name = name
        self.cat = cat
        self.t_start_ns = t_start_ns
        self.t_end_ns = t_end_ns
        self.pid = pid  # PID_DEVICE | PID_GROUPS
        self.lane = lane  # tid label: runner thread / resource group
        self.args = args


class TimelineRing:
    """Bounded per-store timeline (the TIDB_TIMELINE memtable /
    `/debug/timeline` backing store). Recording is O(1) append under one
    lock; Chrome-trace rendering happens only when a reader asks."""

    CAPACITY = 8192

    def __init__(self, capacity: int | None = None):
        self.epoch_ns = time.perf_counter_ns()  # the ONE monotonic clock
        self.epoch_wall = time.time()
        self.enabled = True  # SET GLOBAL tidb_enable_timeline
        self._ring: deque[TimelineEvent] = deque(maxlen=capacity or self.CAPACITY)
        self._lock = threading.Lock()

    def resize(self, capacity: int) -> None:
        """Live resize (SET GLOBAL tidb_timeline_ring_capacity): keeps
        the newest events — deque(iterable, maxlen) retains the tail."""
        with self._lock:
            self._ring = deque(self._ring, maxlen=max(1, int(capacity)))

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    # --- recording ---------------------------------------------------------

    def record(self, name: str, cat: str, t_start_ns: int, t_end_ns: int,
               pid: int = PID_DEVICE, lane: str = "", **args) -> None:
        if not self.enabled:
            return
        ev = TimelineEvent(name, cat, t_start_ns, t_end_ns, pid, lane, args)
        with self._lock:
            self._ring.append(ev)

    def device_event(self, name: str, cat: str, t_start_ns: int, t_end_ns: int,
                     **args) -> None:
        """Record on the bound REAL device lane (`device_scope`, held with
        that lane's launch lock ⇒ events on one device tid never partially
        overlap), falling back to the calling thread's name for unpinned
        engine work (one thread ⇒ events close before the next opens)."""
        self.record(name, cat, t_start_ns, t_end_ns,
                    pid=PID_DEVICE, lane=current_device_lane(), **args)

    # --- reading -----------------------------------------------------------

    def snapshot(self) -> list[TimelineEvent]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# --- per-thread binding (set by the cop client around engine work) ---------


class bind:
    """Attach `ring` (may be None) and the statement's resource group to
    the current thread for the duration of an engine call; the engine's
    boundary hooks and the launch batcher read them from here."""

    __slots__ = ("ring", "group", "prev")

    def __init__(self, ring: TimelineRing | None, group: str = "default"):
        self.ring = ring
        self.group = group or "default"

    def __enter__(self):
        self.prev = getattr(_TLS, "tl", None)
        _TLS.tl = (self.ring, self.group)
        return self.ring

    def __exit__(self, *exc):
        _TLS.tl = self.prev
        return False


def active() -> TimelineRing | None:
    """The bound ring, or None when unbound/disabled — the one check on
    the uninstrumented fast path."""
    t = getattr(_TLS, "tl", None)
    if t is None or t[0] is None or not t[0].enabled:
        return None
    return t[0]


def current_group() -> str:
    t = getattr(_TLS, "tl", None)
    return t[1] if t is not None else "default"


class device_scope:
    """Bind a REAL device lane label (`cpu:3`) to the current thread for
    the duration of a launch: engine-boundary events recorded inside land
    on that device's timeline lane instead of the thread's. The caller
    must hold the lane's launch lock — exclusivity is what keeps one
    device tid free of partial overlap. Re-entrant (nested launches on
    one lane re-bind the same label harmlessly)."""

    __slots__ = ("name", "prev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.prev = getattr(_TLS, "device_lane", None)
        _TLS.device_lane = self.name
        return self

    def __exit__(self, *exc):
        _TLS.device_lane = self.prev
        return False


def current_device_lane() -> str:
    """The bound device-lane label, or the calling thread's name for
    engine work outside any lane guard."""
    name = getattr(_TLS, "device_lane", None)
    return name if name is not None else threading.current_thread().name


def group_lane(group: str) -> str:
    """Track label for resource-group events: one track per (group,
    thread). Chrome complete events on one tid must never partially
    overlap; one thread's events are sequential, so splitting the group's
    lane by recording thread keeps every track well-formed while the
    leading group name still clusters them in the Perfetto UI."""
    return f"{group} ({threading.current_thread().name})"


def group_event(name: str, cat: str, t_start_ns: int, t_end_ns: int, **args) -> None:
    """Record on the bound statement's resource-group lane."""
    t = getattr(_TLS, "tl", None)
    if t is None or t[0] is None:
        return
    t[0].record(name, cat, t_start_ns, t_end_ns,
                pid=PID_GROUPS, lane=group_lane(t[1]), **args)
