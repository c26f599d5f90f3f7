"""Resource groups — RU token buckets with priority (ref:
tidb_tpu/sched/resource_group.py: TokenBucket and ResourceGroup copied;
the reference's ResourceGroupManager keeps its group specs in the catalog
meta KV of a Storage, which the port does not have, so the port's keeps
them in memory with the same read and DDL surface).

A group is a spec plus live runtime state (the token bucket). Buckets
survive an ALTER (debt must not reset on unrelated changes) unless the
group's rate or burst changed. The QUERY_LIMIT runaway watchdog
(sched/runaway.py) is not ported.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..errors import ResourceGroupExists, ResourceGroupNotExists

# admission order: HIGH beats MEDIUM beats LOW whenever slots are scarce
# (the reference's tri-level priority for resource groups)
PRIORITIES = {"LOW": 1, "MEDIUM": 8, "HIGH": 16}

DEFAULT_GROUP = "default"

class TokenBucket:
    """RU bucket with post-hoc debits: admission charges an estimate, the
    task settles the true cost after running, so tokens may go negative
    (debt). A group is admissible while it holds no debt; refill pays debt
    down at `rate` RU/s. rate <= 0 means unlimited (the default group).

    `burstable` buckets borrow from MEASURED headroom instead of
    being unlimited: while in debt they stay admissible only when the
    caller reports the store has free capacity (`admissible(headroom=...)`
    — AdmissionScheduler passes its slot utilization under BORROW_HEADROOM).
    Debt still accrues on every run and is repaid at the reserved rate, so
    a saturated store throttles a burstable group at its ru_per_sec."""

    def __init__(self, rate: float, burst: float | None = None,
                 burstable: bool = False):
        self.rate = float(rate)
        self.burstable = burstable
        self.capacity = float(burst) if burst else max(self.rate, 1.0)
        self.tokens = self.capacity
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        dt = now - self._t
        self._t = now
        if self.rate > 0 and dt > 0:
            self.tokens = min(self.tokens + dt * self.rate, self.capacity)

    def available(self, now: float | None = None) -> float:
        with self._lock:
            self._refill_locked(time.monotonic() if now is None else now)
            return self.tokens

    def admissible(self, now: float | None = None, headroom: bool = False) -> bool:
        if self.rate <= 0:
            return True
        if self.available(now) > 0.0:
            return True
        return self.burstable and headroom

    def debit(self, n: float) -> None:
        if self.rate <= 0:
            return
        with self._lock:
            self._refill_locked(time.monotonic())
            self.tokens -= n

    def credit(self, n: float) -> None:
        if self.rate <= 0:
            return
        with self._lock:
            self._refill_locked(time.monotonic())
            self.tokens = min(self.tokens + n, self.capacity)


@dataclass
class ResourceGroup:
    name: str
    ru_per_sec: int = 0  # 0 = unlimited
    priority: str = "MEDIUM"
    burstable: bool = False
    # QUERY_LIMIT runaway spec (sched/runaway.py): exec_elapsed_ms / ru /
    # processed_rows thresholds + action + watch_ms; None/{} = no limit
    query_limit: dict | None = None
    bucket: TokenBucket = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self):
        if self.bucket is None:
            # burstable groups borrow beyond their rate only while the
            # admission scheduler measures free device slots (the bucket's
            # burstable flag + the scheduler's headroom report);
            # ru_per_sec = 0 stays a genuinely unlimited bucket either way
            self.bucket = TokenBucket(self.ru_per_sec, burstable=self.burstable)

    @property
    def priority_value(self) -> int:
        return PRIORITIES.get(self.priority, PRIORITIES["MEDIUM"])

    def to_spec(self) -> dict:
        return {
            "name": self.name,
            "ru_per_sec": self.ru_per_sec,
            "priority": self.priority,
            "burstable": self.burstable,
            "query_limit": self.query_limit,
        }

    @classmethod
    def from_spec(cls, d: dict) -> "ResourceGroup":
        return cls(
            name=d["name"],
            ru_per_sec=int(d.get("ru_per_sec", 0)),
            priority=d.get("priority", "MEDIUM"),
            burstable=bool(d.get("burstable", False)),
            query_limit=d.get("query_limit") or None,
        )


class ResourceGroupManager:
    """The group table shared by every session of one engine: the
    reference's read side (`get` falls back to `default` for an unknown
    name) and DDL side (`create` / `alter` / `drop`, the `default` group
    synthetic and retuned in memory), over specs held in memory."""

    def __init__(self, storage=None):
        self.storage = storage  # unused: the reference reads specs from it
        self.notify_version = 0
        self._lock = threading.Lock()
        self._groups: dict[str, ResourceGroup] = {}

    # --- read side ---------------------------------------------------------

    def get(self, name: str) -> ResourceGroup:
        """Admission-time lookup: unknown names fall back to the default
        group (a group dropped mid-flight must not fail running queries)."""
        name = (name or DEFAULT_GROUP).lower()
        if name == DEFAULT_GROUP:
            return self.default
        with self._lock:
            return self._groups.get(name) or self.default

    def exists(self, name: str) -> bool:
        if (name or "").lower() == DEFAULT_GROUP:
            return True
        with self._lock:
            return name.lower() in self._groups

    def list(self) -> list[ResourceGroup]:
        with self._lock:
            return [self.default] + [self._groups[k] for k in sorted(self._groups)]

    @property
    def default(self) -> ResourceGroup:
        if not hasattr(self, "_default"):
            self._default = ResourceGroup(DEFAULT_GROUP, 0, "MEDIUM", True)
        return self._default

    # --- DDL side ----------------------------------------------------------
    # `spec` carries only the options the statement named (None = keep);
    # ALTER merges over the stored spec, CREATE fills defaults.

    def create(self, name: str, spec: dict, if_not_exists: bool = False) -> None:
        self._mutate("create", name, spec, if_not_exists=if_not_exists)

    def alter(self, name: str, spec: dict) -> None:
        self._mutate("alter", name, spec)

    def drop(self, name: str, if_exists: bool = False) -> None:
        self._mutate("drop", name, {}, if_exists=if_exists)

    def _mutate(self, kind: str, name: str, spec: dict,
                if_not_exists: bool = False, if_exists: bool = False) -> None:
        name = name.lower()
        opts = {k: v for k, v in spec.items() if v is not None}
        if name == DEFAULT_GROUP:
            if kind == "alter":
                # the default group is synthetic: retune it in memory.
                # Naming RU_PER_SEC without BURSTABLE turns bursting off
                d = self.default
                d.ru_per_sec = int(opts.get("ru_per_sec", d.ru_per_sec))
                d.priority = opts.get("priority", d.priority)
                if "burstable" in opts:
                    d.burstable = bool(opts["burstable"])
                elif "ru_per_sec" in opts:
                    d.burstable = False
                if "query_limit" in opts:
                    d.query_limit = opts["query_limit"] or None
                d.bucket = TokenBucket(d.ru_per_sec, burstable=d.burstable)
                self.bump()
                return
            if kind == "create":
                if if_not_exists:
                    return
                raise ResourceGroupExists(f"resource group '{name}' already exists")
            raise ResourceGroupNotExists(f"resource group '{name}' is reserved")
        with self._lock:
            cur = self._groups.get(name)
            if kind == "create":
                if cur is not None:
                    if if_not_exists:
                        return
                    raise ResourceGroupExists(f"resource group '{name}' already exists")
                full = ResourceGroup(name).to_spec()
                full.update(opts)
                self._groups[name] = ResourceGroup.from_spec(full)
            elif kind == "alter":
                if cur is None:
                    raise ResourceGroupNotExists(f"resource group '{name}' does not exist")
                merged = cur.to_spec()
                merged.update(opts)
                g = ResourceGroup.from_spec(merged)
                if (g.ru_per_sec, g.burstable) == (cur.ru_per_sec, cur.burstable):
                    g.bucket = cur.bucket  # keep accumulated debt/credit
                self._groups[name] = g
            else:  # drop
                if cur is None:
                    if if_exists:
                        return
                    raise ResourceGroupNotExists(f"resource group '{name}' does not exist")
                del self._groups[name]
        self.bump()

    def bump(self) -> None:
        with self._lock:
            self.notify_version += 1
