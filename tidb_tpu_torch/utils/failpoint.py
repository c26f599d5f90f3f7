"""Failpoint framework — conditional fault-injection sites
(ref: pingcap/failpoint; the reference compiles `failpoint.Inject` sites
into 94 files and enables them per test via Makefile failpoint-enable.
Here sites are always present and zero-cost when disarmed).

Actions an armed site can carry:
  * an Exception instance or class — raised at the site
  * a callable — invoked at the site
  * ("sleep", seconds) — blocks the site
  * ("crash", [exit_code]) — hard-kills the process via os._exit (no
    atexit, no flush — the closest in-process stand-in for SIGKILL;
    the crashpoint harness tools/crashpoint.py arms this at named
    sites inside a CHILD process and the parent checks recovery)
  * ("prob", p, action) — fires `action` with probability p per hit
    (the chaos-harness marker: 30%-probability device faults, random
    region churn)
  * ("nth", n, action) — fires `action` on every n-th hit (hit counts
    reset when the site is re-armed), for "fail exactly between step A
    and step B" regression tests

A copy of tidb_tpu/utils/failpoint.py: the port imports nothing of the
reference package.
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager


class Failpoints:
    def __init__(self):
        self._active: dict[str, object] = {}
        self._hits: dict[str, int] = {}
        self._lock = threading.Lock()
        self._rng = random.Random()

    def enable(self, name: str, action) -> None:
        """action: see the module docstring for the accepted shapes."""
        with self._lock:
            self._active[name] = action
            self._hits[name] = 0  # fresh count per arm cycle

    def disable(self, name: str) -> None:
        with self._lock:
            self._active.pop(name, None)

    def disable_all(self) -> None:
        with self._lock:
            self._active.clear()
            self._hits.clear()

    def seed(self, n: int) -> None:
        """Deterministic ("prob", ...) firing for reproducible chaos runs."""
        with self._lock:
            self._rng.seed(n)

    def hits(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)

    def armed(self, name: str) -> bool:
        """Is the site armed at all? The cheap state gate for rules that
        model a continuous condition (a black-holed link is black-holed
        for every byte while armed) rather than a per-hit decision."""
        with self._lock:
            return name in self._active

    def decide(self, name: str):
        """Resolve an armed site WITHOUT firing: returns the resolved
        action value, or None when the site is disarmed (or this hit's
        prob/nth decision says no). Hit counting and the conditional
        decision happen under the same lock as inject(). A bare
        ("prob", p) / ("nth", n) tuple resolves to True — the
        decision-rule shape netchaos arms (`should this frame drop?`);
        a carried action resolves to the action itself so the caller
        can _fire() it (crashpoint composing a ("crash",) at a chaos
        site)."""
        with self._lock:
            action = self._active.get(name)
            if action is None:
                return None
            hits = self._hits.get(name, 0) + 1
            self._hits[name] = hits
            if isinstance(action, tuple) and action:
                if action[0] == "prob":
                    if self._rng.random() >= action[1]:
                        return None
                    return action[2] if len(action) > 2 else True
                if action[0] == "nth":
                    if hits % action[1] != 0:
                        return None
                    return action[2] if len(action) > 2 else True
            return action

    def rand(self) -> float:
        """One draw from the seeded chaos RNG (jittered delays stay
        reproducible under FP.seed)."""
        with self._lock:
            return self._rng.random()

    def inject(self, name: str) -> None:
        """The site call: no-op unless armed. The action lookup, hit-count
        bump and conditional-firing decision happen under ONE lock hold —
        a concurrent disable_all between the read and the count can no
        longer resurrect the hit entry, and the nth counter can't race."""
        with self._lock:
            action = self._active.get(name)
            if action is None:
                return
            hits = self._hits.get(name, 0) + 1
            self._hits[name] = hits
            if isinstance(action, tuple) and action:
                if action[0] == "prob":
                    if self._rng.random() >= action[1]:
                        return
                    action = action[2]
                elif action[0] == "nth":
                    if hits % action[1] != 0:
                        return
                    action = action[2]
        # fire OUTSIDE the lock: sleeps and callables may block or re-enter
        self._fire(action)

    @staticmethod
    def _fire(action) -> None:
        if isinstance(action, BaseException):
            raise action
        if isinstance(action, type) and issubclass(action, BaseException):
            raise action()
        if isinstance(action, tuple) and action and action[0] == "sleep":
            time.sleep(action[1])
            return
        if isinstance(action, tuple) and action and action[0] == "crash":
            os._exit(action[1] if len(action) > 1 else 137)
        if callable(action):
            action()

    @contextmanager
    def enabled(self, name: str, action):
        self.enable(name, action)
        try:
            yield self
        finally:
            self.disable(name)


FP = Failpoints()


def inject(name: str) -> None:
    FP.inject(name)
