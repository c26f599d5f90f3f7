"""Runaway-query watchdog (copy of tidb_tpu/sched/runaway.py; ref: the reference's runaway control:
ddl QUERY_LIMIT group option + pkg/resourcegroup/runaway — a per-group
QUERY_LIMIT of EXEC_ELAPSED / RU / PROCESSED_ROWS thresholds with DRYRUN
/ COOLDOWN / KILL actions, plus a TTL watch list that rejects a KILLed
statement's digest at admission before it consumes anything).

The watchdog owns no thread: checks piggyback the scheduler's existing
poll tick. `RunawayChecker.tick()` is called from
`sched.scheduler.raise_if_interrupted` — the one shared "stop now?" gate
that admission waits, backoff sleeps and executor chunk boundaries
already poll — so a runaway observes its verdict within one tick slice
wherever it happens to be stuck. `on_admission()` runs once per
statement at `AdmissionScheduler.acquire`, where the watch list can
reject (KILL watch) or demote (COOLDOWN watch) a repeat offender before
a ticket is granted.

COOLDOWN semantics: the statement survives but its remaining cop tasks
are admitted at LOW priority and its Backoffer budget shrinks to a
quarter (a misbehaving statement gets less patience, not more).
"""

from __future__ import annotations

import logging
import re
import threading
import time
from collections import deque
from dataclasses import dataclass

from ..errors import RunawayKilled, RunawayQuarantined
from ..utils import metrics as M

log = logging.getLogger("tidb_tpu.runaway")

ACTIONS = ("DRYRUN", "COOLDOWN", "KILL")

_BARE_NUM = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*$")


def parse_duration_ms(s: str) -> float:
    """Go duration string → milliseconds: '800ms' / '10s' / '5m' / '1h'
    and compound forms like '1m30s' (delegates to the tidb_gc_* parser,
    storage/gcworker.parse_go_duration_ms); a bare number means seconds."""
    m = _BARE_NUM.match(str(s))
    if m is not None:
        return float(m.group(1)) * 1000.0
    from ..storage.gcworker import parse_go_duration_ms

    ms = parse_go_duration_ms(str(s))
    if ms is None:
        raise ValueError(f"invalid duration value {s!r}")
    return float(ms)


def format_duration(ms: float) -> str:
    if ms and ms % 60000.0 == 0:
        return f"{int(ms // 60000)}m"
    if ms and ms % 1000.0 == 0:
        return f"{int(ms // 1000)}s"
    return f"{ms:g}ms"


@dataclass(frozen=True)
class QueryLimit:
    """Parsed form of a group spec's `query_limit` dict."""

    exec_elapsed_ms: float | None = None
    ru: float | None = None
    processed_rows: int | None = None
    action: str = "DRYRUN"
    watch_ms: float | None = None  # explicit WATCH duration

    DEFAULT_WATCH_MS = 60_000.0  # KILLed digests watch this long when
    # the spec names no WATCH (repeat offenders must not re-enter free)

    @classmethod
    def from_spec(cls, d: dict) -> "QueryLimit | None":
        if not d:
            return None
        return cls(
            exec_elapsed_ms=d.get("exec_elapsed_ms"),
            ru=d.get("ru"),
            processed_rows=d.get("processed_rows"),
            action=str(d.get("action", "DRYRUN")).upper(),
            watch_ms=d.get("watch_ms"),
        )

    def render(self) -> str:
        parts = []
        if self.exec_elapsed_ms is not None:
            parts.append(f"EXEC_ELAPSED='{format_duration(self.exec_elapsed_ms)}'")
        if self.ru is not None:
            parts.append(f"RU={self.ru:g}")
        if self.processed_rows is not None:
            parts.append(f"PROCESSED_ROWS={self.processed_rows}")
        parts.append(f"ACTION={self.action}")
        if self.watch_ms is not None:
            parts.append(f"WATCH='{format_duration(self.watch_ms)}'")
        return ", ".join(parts)


@dataclass
class Watch:
    group: str
    action: str
    reason: str
    start: float  # wall clock, for the memtable
    until: float  # monotonic expiry
    until_wall: float = 0.0  # wall-clock expiry, for persistence


class RunawayChecker:
    """Per-statement watchdog state. `tick()` is on the interrupt-gate
    hot path: when the group has no limit (watch-only checker) or the
    action already fired it is two attribute loads and out."""

    __slots__ = ("manager", "session", "group", "limit", "digest", "trace",
                 "sql", "start", "demoted", "_fired", "_watch", "_lock",
                 "_kill_rule")

    def __init__(self, manager: "RunawayManager", session, group: str,
                 limit: QueryLimit | None, digest: str, trace, sql: str):
        self.manager = manager
        self.session = session
        self.group = group
        self.limit = limit
        self.digest = digest
        self.trace = trace
        self.sql = sql
        self.start = time.monotonic()
        self.demoted = False
        self._fired = False
        self._watch = None  # resolved watch verdict: (group, action, reason)
        self._kill_rule = None  # sticky KILL verdict: every tick re-raises
        self._lock = threading.Lock()

    # --- admission-time (watch list) ---------------------------------------

    def on_admission(self) -> None:
        """Admission gate: resolve the watch-list verdict ONCE per
        statement (a statement's parallel cop tasks share this checker —
        the lock keeps the hit event/metric single) and enforce it for
        EVERY task: a KILL watch rejects before a ticket is consumed, a
        COOLDOWN watch demotes. Then the normal threshold tick."""
        with self._lock:
            if self._watch is None:
                w = self.manager.watch_for(self.digest, self.group)
                if w is None:
                    self._watch = ()
                else:
                    self._watch = (w.group, w.action, w.reason)
                    M.RUNAWAY_WATCH_HITS.inc(group=w.group, action=w.action)
                    self.manager.record_event(w.group, self.digest, "watch",
                                              w.action, self.sql)
                    self._span("runaway.watch_hit", action=w.action)
                    if w.action == "COOLDOWN":
                        self.demoted = True
        if self._watch and self._watch[1] == "KILL":
            wg, _, wr = self._watch
            raise RunawayQuarantined(
                f"Quarantined and interrupted because of being in the "
                f"runaway watch list (digest {self.digest}, group "
                f"'{wg}', reason: {wr})"
            )
        self.tick()

    # --- the poll-tick check -----------------------------------------------

    def tick(self) -> None:
        if self._kill_rule is not None:
            # a parallel sibling task already drew the KILL verdict: the
            # whole statement dies, whichever task polls next
            self._raise_killed(self._kill_rule)
        lim = self.limit
        if lim is None or self._fired:
            return
        rule = None
        if (lim.exec_elapsed_ms is not None
                and (time.monotonic() - self.start) * 1000.0 > lim.exec_elapsed_ms):
            rule = "exec_elapsed"
        elif self.trace is not None and (lim.ru is not None or lim.processed_rows is not None):
            c = self.trace.counters  # read-mostly dict; snapshot-free peek
            if lim.ru is not None and c.get("ru", 0.0) > lim.ru:
                rule = "ru"
            elif lim.processed_rows is not None and c.get("processed_rows", 0.0) > lim.processed_rows:
                rule = "processed_rows"
        if rule is not None:
            self._fire(rule)

    def _span(self, name: str, **tags) -> None:
        if self.trace is not None and self.trace.recording:
            self.trace.closed_span(name, 0.0, group=self.group, **tags)

    def _fire(self, rule: str) -> None:
        with self._lock:
            if self._fired:
                return  # a parallel sibling drew the verdict first
            self._fired = True
        lim = self.limit
        action = lim.action if lim.action in ACTIONS else "DRYRUN"
        M.RUNAWAY_ACTIONS.inc(group=self.group, action=action, rule=rule)
        self.manager.record_event(self.group, self.digest, rule, action, self.sql)
        self._span(f"runaway.{action.lower()}", rule=rule)
        if action == "COOLDOWN":
            self.demoted = True
        if lim.watch_ms is not None and action in ("COOLDOWN", "DRYRUN"):
            # an explicit WATCH clause extends a non-kill verdict to the
            # digest's future statements (demote-on-arrival / dryrun note)
            self.manager.mark(self.digest, self.group, action, rule, lim.watch_ms)
        if action == "KILL":
            ttl = lim.watch_ms if lim.watch_ms is not None else QueryLimit.DEFAULT_WATCH_MS
            self.manager.mark(self.digest, self.group, "KILL", rule, ttl)
            self._kill_rule = rule
            self._raise_killed(rule)

    def _raise_killed(self, rule: str) -> None:
        raise RunawayKilled(
            f"Query execution was interrupted, identified as runaway query "
            f"(rule: {rule}, resource group '{self.group}')"
        )


class RunawayManager:
    """Store-wide watch list + event history (one per ResourceController,
    like the group table itself)."""

    EVENTS_CAP = 512

    def __init__(self, controller=None):
        self.controller = controller
        self._lock = threading.Lock()
        # keyed (digest, group): one digest may carry DIFFERENT verdicts
        # in different groups — rg2's DRYRUN watch must not overwrite
        # rg1's still-live KILL watch for the same digest
        self._watches: dict[tuple[str, str], Watch] = {}
        self.events: deque = deque(maxlen=self.EVENTS_CAP)
        # lazy one-shot load of watches persisted in the catalog meta: a
        # KILLed digest must stay rejected across store restart, not
        # only while the process that drew the verdict lives
        self._loaded = False

    # --- persistence (catalog meta, `m:rw:` keyspace) ----------------------

    @property
    def _storage(self):
        return getattr(self.controller, "storage", None)

    def _load_locked(self) -> None:
        """Rebuild the in-memory watch table from the catalog meta ONCE
        per manager (first touch). Entries whose wall-clock TTL lapsed
        while the store was down are swept from the meta here; survivors
        get a fresh monotonic expiry covering their remaining time."""
        if self._loaded:
            return
        self._loaded = True
        storage = self._storage
        if storage is None:
            return  # bare manager (unit tests): nothing to restore
        from ..catalog.meta import Meta

        try:
            txn = storage.begin()
            try:
                specs = Meta(txn).list_runaway_watches()
            finally:
                txn.rollback()
        except Exception:  # noqa: BLE001 — a cold/closed store: stay empty
            log.warning("runaway watch-list load failed", exc_info=True)
            return
        now_wall = time.time()
        now_mono = time.monotonic()
        expired = []
        for d in specs:
            remaining = float(d.get("until_wall", 0.0)) - now_wall
            if remaining <= 0:
                expired.append((d.get("group", ""), d.get("digest", "")))
                continue
            key = (d["digest"], d["group"])
            self._watches[key] = Watch(
                group=d["group"], action=d.get("action", "KILL"),
                reason=d.get("reason", ""), start=float(d.get("start", now_wall)),
                until=now_mono + remaining, until_wall=float(d["until_wall"]),
            )
        for group, digest in expired:
            self._meta_drop(group, digest)

    def _meta_put(self, digest: str, w: Watch) -> None:
        storage = self._storage
        if storage is None:
            return
        from ..catalog.meta import Meta

        try:
            txn = storage.begin()
            try:
                Meta(txn).put_runaway_watch({
                    "digest": digest, "group": w.group, "action": w.action,
                    "reason": w.reason, "start": w.start,
                    "until_wall": w.until_wall,
                })
                txn.commit()
            except BaseException:
                txn.rollback()
                raise
        except Exception:  # noqa: BLE001 — the verdict must still fire
            log.warning("runaway watch persist failed", exc_info=True)

    def _meta_drop(self, group: str, digest: str) -> None:
        storage = self._storage
        if storage is None:
            return
        from ..catalog.meta import Meta

        try:
            txn = storage.begin()
            try:
                Meta(txn).drop_runaway_watch(group, digest)
                txn.commit()
            except BaseException:
                txn.rollback()
                raise
        except Exception:  # noqa: BLE001 — expiry sweep is best-effort
            pass

    # --- per-statement entry ------------------------------------------------

    def checker_for(self, session, group, sql: str, trace) -> RunawayChecker | None:
        """Called once per statement. Fast-exits with None when the bound
        group carries no QUERY_LIMIT and the watch list is empty — the
        every-statement overhead of an idle watchdog is this check.
        Expired watches are swept here, not only on re-admission of the
        same digest: one long-forgotten KILL must not leave every future
        statement paying digest hashing + checker construction forever."""
        limit = group.parsed_limit()
        if limit is None and not self._any_watch():
            return None
        from ..utils.stmtstats import sql_digest

        return RunawayChecker(self, session, group.name, limit,
                              sql_digest(sql), trace, sql[:256])

    def _any_watch(self) -> bool:
        """True while an UNEXPIRED watch exists; purges expired entries
        so the idle fast path comes back once every TTL has lapsed."""
        if not self._loaded:
            with self._lock:
                self._load_locked()
        if not self._watches:
            return False
        now = time.monotonic()
        with self._lock:
            expired = [k for k, w in self._watches.items() if now >= w.until]
            for k in expired:
                del self._watches[k]
            alive = bool(self._watches)
        for digest, group in expired:
            self._meta_drop(group, digest)
        return alive

    # --- watch list ----------------------------------------------------------

    def watch_for(self, digest: str, group: str) -> Watch | None:
        """The unexpired watch for (digest, group): a KILL watch armed
        under 'rg1' must not quarantine the same digest running under a
        group that never opted into runaway control (the reference
        scopes watches per group; the RUNAWAY_WATCHES memtable column
        implies the same)."""
        now = time.monotonic()
        key = (digest, group)
        with self._lock:
            self._load_locked()
            w = self._watches.get(key)
            if w is None:
                return None
            if now >= w.until:
                del self._watches[key]
                w = None
        if w is None:
            self._meta_drop(group, digest)
        return w

    def mark(self, digest: str, group: str, action: str, reason: str, ttl_ms: float) -> None:
        now_wall = time.time()
        w = Watch(
            group=group, action=action, reason=reason,
            start=now_wall, until=time.monotonic() + ttl_ms / 1000.0,
            until_wall=now_wall + ttl_ms / 1000.0,
        )
        with self._lock:
            self._load_locked()
            self._watches[(digest, group)] = w
        # persist OUTSIDE the lock: the meta write opens its own txn and
        # must not serialize every admission-path watch probe behind it
        self._meta_put(digest, w)

    def watches_snapshot(self) -> list[tuple[str, Watch, float]]:
        """[(digest, watch, remaining_s)] of unexpired entries."""
        now = time.monotonic()
        with self._lock:
            self._load_locked()
            expired = [k for k, w in self._watches.items() if now >= w.until]
            for k in expired:
                del self._watches[k]
            out = [(k[0], w, w.until - now) for k, w in self._watches.items()]
        for digest, group in expired:
            self._meta_drop(group, digest)
        return out

    # --- events --------------------------------------------------------------

    def record_event(self, group: str, digest: str, rule: str, action: str, sql: str) -> None:
        self.events.append({
            "time": time.time(), "group": group, "digest": digest,
            "rule": rule, "action": action, "sql": sql,
        })
