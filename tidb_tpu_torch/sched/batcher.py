"""Cross-session device-launch micro-batcher.

Per-task device dispatch is the cop-path bottleneck (round-5 verdict:
p50 at 0.15x of the host engine): every task pays its own kernel
dispatch plus a blocking device→host fetch. Tensor-runtime query engines
win by amortizing launch cost over bucketed batches (arXiv:2203.01877
§4.2); this batcher applies the same move across sessions.

Concurrent cop tasks that lower to the SAME compiled program — same DAG
digest, same padded tile count (the static-shape bucket the program cache is
keyed on) — coalesce into one launch group. The group leader waits a
microscopic window for followers, then

  * tier 1 (dedup): tasks over the identical data snapshot (same digest,
    table version and handle span) execute ONCE and share the chunk — the
    same sharing rule the cop result cache already applies, without its
    min-scan-rows admission gate;
  * tier 2 (launch coalescing): remaining tasks dispatch back-to-back
    through `TorchEngine.execute_many`, which defers every device→host
    fetch to ONE fetch over the whole group.

Every task still runs its own per-task compiled program over its own
batch, so results are bit-identical to serial `execute` calls by
construction (no cross-task reduction reordering).

A solo task (nothing else in flight) bypasses the batcher entirely:
zero added latency on the uncontended path.

A copy of tidb_tpu/sched/batcher.py over the port's TorchEngine: its
`execute_many` runs a launch group's compatible tasks as one task-grid
launch of each kernel (K10, copr/gpu_engine.py) and fetches the whole
group with one host synchronization.
"""

from __future__ import annotations

import logging
import threading
import time

from ..errors import MemoryQuotaExceeded
from ..utils import memory
from ..utils import metrics as M
from ..utils import timeline as TL
from ..utils import tracing
from ..utils.failpoint import inject as _fp

log = logging.getLogger("tidb_tpu_torch.sched")


class _Job:
    __slots__ = ("dag", "batch", "dedup_key", "result", "exc", "followers", "mode",
                 "trace", "parent_id", "client", "mem")

    def __init__(self, dag, batch, dedup_key, client=None):
        self.dag = dag
        self.batch = batch
        self.dedup_key = dedup_key
        self.result = None
        self.exc = None
        self.followers: list["_Job"] = []
        self.mode = "leader"
        # fan-out attribution: the waiter's statement trace + the span the
        # shared launch span should hang under in THAT trace, captured on
        # the waiter's own thread at enqueue time
        self.trace = tracing.current_trace()
        self.parent_id = self.trace.current_parent() if self.trace is not None else 0
        # the waiter's CopClient: launch-wide device counters fan out
        # into every participating client's store-level `stats` (EXPLAIN
        # ANALYZE's `device:` line), once per client per launch
        self.client = client
        # the waiter's statement MemTracker, captured on its own thread:
        # the per-job serial fallback rebinds it so one statement's
        # quota/server-limit error can never poison co-batched neighbors
        self.mem = memory.current_tracker()


class _Group:
    __slots__ = ("jobs", "n_dedup", "done", "closed")

    def __init__(self):
        self.jobs: list[_Job] = []
        self.n_dedup = 0
        self.done = threading.Event()
        self.closed = False


class LaunchBatcher:
    WINDOW_S = 0.002  # follower collection window; >> a kernel dispatch, << a launch
    WAIT_TIMEOUT_S = 120.0  # follower safety valve (leader crashed hard)

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: dict[tuple, _Group] = {}
        self._inflight = 0
        # groups whose engine.execute_many raised and whose jobs then ran
        # one by one (_launch_on's per-job serial fallback)
        self.serial_fallbacks = 0

    def execute(self, engine, dag, batch, dedup_key=None, stats=None, client=None,
                lane=None):
        """Run one cop DAG over one batch through the engine, coalescing
        with concurrent compatible tasks ON ONE DEVICE RUNNER LANE: the
        placement policy (engine.place — residency affinity, spill to
        idle lanes under load, breaker gating on the client path) picks
        the lane up front, groups key on it, and sibling lanes launch in
        parallel. `lane` is the caller's pre-placed DeviceLane (the cop
        client places so it can record breaker outcomes on the same
        lane); None places here. `stats` is an optional callable
        `(key, n)` for the owning client's per-query counters; `client`
        is the owning CopClient whose store-level stats receive the
        launch's device counters (solo bypasses report through the
        caller's phase collector instead)."""
        placed = None
        if lane is None and hasattr(engine, "place"):
            lane = placed = engine.place(batch, stats=stats)
        with self._lock:
            self._inflight += 1
            concurrent = self._inflight > 1
        try:
            if not concurrent or lane is None:
                return engine.execute(dag, batch, lane=lane) if lane is not None \
                    else engine.execute(dag, batch)
            return self._coalesced(engine, dag, batch, lane, dedup_key, stats, client)
        finally:
            with self._lock:
                self._inflight -= 1
            if placed is not None:
                engine.release_lane(placed)

    # --- grouped path -------------------------------------------------------

    def _coalesced(self, engine, dag, batch, lane, dedup_key, stats, client=None):
        try:
            # the NARROWED (tile count, row bucket) class: two tasks can
            # only stack into one task-grid launch when they pad to the
            # same shape, which since the bucketed tile layout is the
            # power-of-two row bucket, not the legacy 64Ki tile count
            bucket_of = getattr(engine, "tile_bucket", engine.tile_count)
            tiles = bucket_of(batch)
        except Exception:  # noqa: BLE001 — engine without tiling: run solo
            return engine.execute(dag, batch, lane=lane)
        # groups are PER LANE: a group's tasks all run one task-grid launch
        # on one device, so only same-device (and same-program) tasks fuse
        ckey = (id(engine), lane.idx, dag.digest(), tiles)
        job = _Job(dag, batch, dedup_key, client=client)
        t_enq = time.perf_counter_ns()
        with self._lock:
            g = self._pending.get(ckey)
            if g is not None and not g.closed:
                if dedup_key is not None:
                    for j in g.jobs:
                        if j.dedup_key == dedup_key:
                            j.followers.append(job)
                            job.mode = "dedup"
                            g.n_dedup += 1
                            break
                if job.mode != "dedup":
                    g.jobs.append(job)
                    job.mode = "member"
                group = g
            else:
                group = _Group()
                group.jobs.append(job)
                self._pending[ckey] = group

        TL.group_event("launch.enqueue", "launch", t_enq, t_enq, mode=job.mode,
                       trace=job.trace.trace_id if job.trace is not None else None)
        if job.mode == "leader":
            time.sleep(self.WINDOW_S)
            with self._lock:
                group.closed = True
                if self._pending.get(ckey) is group:
                    del self._pending[ckey]
            TL.group_event("launch.leader_elected", "launch", t_enq,
                           time.perf_counter_ns(),
                           jobs=len(group.jobs), n_dedup=group.n_dedup,
                           device=lane.name)
            self._launch(engine, group, stats, lane)
        else:
            if not group.done.wait(self.WAIT_TIMEOUT_S):
                # leader died without completing the group (should be
                # impossible — _launch sets done unconditionally): fail
                # loudly rather than return a None chunk downstream
                raise RuntimeError(
                    "launch batcher follower timed out waiting for its group leader"
                )
            if stats is not None:
                stats("dedup_tasks" if job.mode == "dedup" else "batched_tasks", 1)
        if job.exc is not None:
            raise job.exc
        return job.result

    def _launch(self, engine, group: _Group, stats, lane=None) -> None:
        placed = None
        if lane is None and hasattr(engine, "place"):
            # direct callers (tests) without a pre-placed lane
            lane = placed = engine.place(group.jobs[0].batch)
        try:
            if lane is not None:
                # the lane's launch lock serializes device work per device
                # and keeps its timeline tid free of partial overlap; the
                # device_scope binding lands every engine-boundary event
                # recorded below on the REAL device lane
                with lane.lock, TL.device_scope(lane.name):
                    self._launch_on(engine, group, stats, lane)
            else:
                self._launch_on(engine, group, stats, lane)
        finally:
            if placed is not None:
                engine.release_lane(placed)

    def _launch_on(self, engine, group: _Group, stats, lane) -> None:
        jobs = group.jobs
        t0_ns = time.perf_counter_ns()
        # one launch identity shared by the timeline event and the trace
        # span fanned into every waiter (same id space as span ids)
        launch_id = tracing._next_id()
        # the group's shared uploads belong to NO statement (a neighbor's
        # bytes must not draw the leader's quota verdict) but the SERVER
        # arbiter must still see the volume: a detachable, quota-less
        # tracker hung straight off the server root carries it for the
        # launch's duration, then unwinds
        mem0 = next((j.mem for j in jobs if j.mem is not None), None)
        launch_mem = None
        if mem0 is not None and mem0.root is not mem0:
            launch_mem = memory.MemTracker(0, "cop.launch", parent=mem0.root)
        # the leader runs device work for OTHER statements' traces too:
        # collect the device phases (compile/transfer/execute) for the
        # whole launch here and fan them out with the shared launch span
        ph_token = tracing.push_phases()
        try:
            # everything before the engine call sits inside the guard too:
            # an armed failpoint (or metrics error) must still release the
            # followers via done.set(), never strand them on the 120s valve
            _fp("sched/before-launch")
            occupancy = len(jobs) + group.n_dedup
            M.SCHED_BATCH_OCCUPANCY.observe(occupancy)
            if stats is not None and occupancy > 1:
                stats("batched_tasks", 1)
            try:
                with memory.bind(launch_mem):
                    results = engine.execute_many(
                        [(j.dag, j.batch) for j in jobs], lane=lane
                    ) if lane is not None else engine.execute_many(
                        [(j.dag, j.batch) for j in jobs]
                    )
                for j, r in zip(jobs, results):
                    j.result = r
            except Exception:  # noqa: BLE001
                with self._lock:
                    self.serial_fallbacks += 1
                # one poisoned task must not fail its co-batched neighbors:
                # fall back to per-task serial execution with per-task
                # errors, each job under ITS OWN statement's memory
                # tracker — the group ran under the leader's, and a
                # leader-quota breach mid-upload must die with the leader
                # only, not with every waiter
                for j in jobs:
                    try:
                        with memory.bind(j.mem):
                            j.result = self._solo(engine, j.dag, j.batch, lane)
                    except Exception as e:  # noqa: BLE001
                        j.exc = e
        except BaseException as e:  # noqa: BLE001 — e.g. an armed failpoint
            # no job may be left with neither result nor error: a follower
            # would otherwise surface a None chunk downstream
            for j in jobs:
                if j.result is None and j.exc is None:
                    j.exc = e
            raise
        finally:
            phases = tracing.pop_phases(ph_token)
            if launch_mem is not None:
                launch_mem.detach()  # launch volume unwinds with the launch
            for j in jobs:
                for f in j.followers:
                    if j.exc is not None and isinstance(j.exc, MemoryQuotaExceeded):
                        # a statement-scoped quota verdict is the
                        # MEMBER's, not the work's: the dedup follower
                        # re-runs the task under ITS OWN tracker instead
                        # of dying of a neighbor's quota. The re-run runs
                        # AFTER pop_phases restored the leader's phase
                        # frame — collect_phases isolates its device
                        # phases so they can't inflate the leader's
                        # device: line / trace
                        try:
                            with memory.bind(f.mem), tracing.collect_phases():
                                f.result = self._solo(engine, f.dag, f.batch, lane)
                        except Exception as e:  # noqa: BLE001
                            f.exc = e
                    else:
                        f.result, f.exc = j.result, j.exc
            try:
                self._attribute(jobs, group, t0_ns, phases, launch_id=launch_id,
                                lane=lane)
            except Exception:  # noqa: BLE001 — attribution must never strand waiters
                log.warning("launch-span fan-out attribution failed", exc_info=True)
            group.done.set()
            TL.group_event("launch.fanout", "launch",
                           time.perf_counter_ns(), time.perf_counter_ns(),
                           launch_id=launch_id, waiters=len(jobs) + group.n_dedup)

    @staticmethod
    def _solo(engine, dag, batch, lane):
        """Per-job serial fallback / dedup re-run on the group's OWN lane
        — already inside the lane guard, so no solo launch event (the
        enclosing grouped `cop.launch` slice covers it)."""
        if lane is not None:
            return engine.execute(dag, batch, lane=lane, _solo_event=False)
        return engine.execute(dag, batch)

    def _attribute(self, jobs, group: _Group, t0_ns: int, phases: dict,
                   launch_id: int | None = None, lane=None) -> None:
        """Fan the ONE launch out into every co-batched waiter's trace:
        each participant (members, dedup followers, the leader itself)
        gets the SAME launch span — identical launch/span id, occupancy,
        which statement ran it, and the device-phase breakdown — linked
        as a child of its own cop-task span, plus the exec-detail
        counters the slow log / STATEMENTS_SUMMARY columns read."""
        waiters = []
        for j in jobs:
            waiters.append(j)
            waiters.extend(j.followers)
        occupancy = len(waiters)
        dur_ns = time.perf_counter_ns() - t0_ns
        # grouped-launch shared uploads: memory tracking deliberately
        # charges these bytes to NOBODY (a neighbor's data must not draw
        # the leader's quota verdict) — but the volume is real device
        # traffic, so it gets its own series and rides the shared launch
        # span/event as `shared_h2d` instead of vanishing
        shared_h2d = int(phases.get("h2d_bytes", 0)) if occupancy > 1 else 0
        if shared_h2d:
            M.TPU_SHARED_UPLOAD_BYTES.inc(shared_h2d)
        # ONE timeline event per launch on the runner's DEVICE lane —
        # every dispatch shows, 1-job groups included —
        # referenced by every co-batched waiter's trace id (the chrome
        # export turns the references into flow-event arrows)
        if lane is not None:
            lane.launches += 1
            M.TPU_LANE_LAUNCHES.inc(
                device=lane.name, mode="grouped" if occupancy > 1 else "solo"
            )
        tl = TL.active()
        if tl is not None:
            tl.device_event(
                "cop.launch", "launch", t0_ns, t0_ns + dur_ns,
                launch_id=launch_id, occupancy=occupancy, n_dedup=group.n_dedup,
                shared_h2d_bytes=shared_h2d,
                device=lane.name if lane is not None else "",
                waiters=[w.trace.trace_id for w in waiters if w.trace is not None],
            )
        # store-level stats fan-out: a co-batched launch's
        # compile/transfer/execute counters land in EVERY participating
        # client's `cop.stats` — once per client per launch — so EXPLAIN
        # ANALYZE's `device:` line covers grouped launches, not just
        # solos (the statement-level traces get theirs below)
        counters = tracing.phase_counters(phases)
        if shared_h2d:
            counters = counters + [("shared_h2d_bytes", shared_h2d)]
        clients = {}
        for w in waiters:
            if w.client is not None:
                clients[id(w.client)] = w.client
        for cl in clients.values():
            for key, n in counters:
                cl._bump(key, n)
        traces = []
        seen = set()
        for w in waiters:
            t = w.trace
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                traces.append(t)
        if not traces:
            return
        for t in traces:
            t.set_max("batch_occupancy", occupancy)
            for key, cnt in counters:
                t.add(key, cnt)
        if not any(t.recording for t in traces):
            return
        leader = jobs[0].trace
        span = tracing.Span("cop.launch", 0, dur_ns, span_id=launch_id)
        span.tags.update(
            launch_id=span.span_id, occupancy=occupancy, n_dedup=group.n_dedup,
            runner=leader.trace_id if leader is not None else "-",
        )
        if shared_h2d:
            span.tags["shared_h2d"] = shared_h2d
        failed = next((j.exc for j in jobs if j.exc is not None), None)
        if failed is not None:
            span.tags["error"] = type(failed).__name__
        # device phase children: real captured timestamps when the frame
        # carries boundary events (start_ns holds the ABSOLUTE clock
        # reading, rebased per adopting trace); plain-dict frames fall
        # back to back-to-back synthesis relative to the launch start
        events = getattr(phases, "events", None)
        if events:
            children = [
                tracing.Span(name, c_t0, c_t1 - c_t0,
                             parent_id=span.span_id, tags=dict(tags))
                for name, c_t0, c_t1, tags in events
            ]
        else:
            children = tracing.phase_spans(phases, span.span_id, dur_ns)
        adopted = set()
        for w in waiters:
            t = w.trace
            if t is None or not t.recording:
                continue
            if id(t) in adopted:
                # one launch appears ONCE per trace: a statement whose own
                # sibling cop tasks co-batched must not adopt the span (and
                # its children, which key off the shared span id) twice —
                # tree() would render the children cross-product
                continue
            adopted.add(id(t))
            sp = span.copy_with_parent(w.parent_id or t.root_id)
            if events:
                # real timestamps: rebase the one monotonic clock onto
                # this trace's epoch — gaps between phases survive
                sp.start_ns = t0_ns - t._epoch_ns
                kids = tuple(
                    tracing.Span(c.name, c.start_ns - t._epoch_ns, c.dur_ns,
                                 parent_id=c.parent_id, span_id=c.span_id,
                                 tags=c.tags)
                    for c in children
                )
            else:
                # synthesized: start relative to THIS trace's epoch, the
                # launch ends "now"
                sp.start_ns = t._now_ns() - dur_ns
                kids = tuple(
                    tracing.Span(c.name, sp.start_ns + c.start_ns, c.dur_ns,
                                 parent_id=c.parent_id, span_id=c.span_id,
                                 tags=c.tags)
                    for c in children
                )
            t.adopt(sp, sp.parent_id, children=kids)
