"""Metrics registry — Prometheus-style counters/histograms
(ref: metrics/metrics.go registry + per-subsystem files; exposed at
/metrics by server/http_status.go:115).

A copy of tidb_tpu/utils/metrics.py's registry with the reference's
metric names (they are the product's names), holding the series the
port's engine, launch batcher, scheduler and retry modules update.
"""

from __future__ import annotations

import threading
from collections import defaultdict

_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)


def _esc(v) -> str:
    """Prometheus text-format label-value escaping (exposition format
    §label values: backslash, double-quote and newline must be escaped)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key) -> str:
    return ",".join(f'{k}="{_esc(val)}"' for k, val in key)


class Counter:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._v = defaultdict(float)  # label tuple → value
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._v[key] += n

    def value(self, **labels) -> float:
        # .get, not [..]: a defaultdict read INSERTS the missing key, so
        # an unlocked probe could grow the dict mid-render (and the
        # registry's lock-free iteration would see a changed dict); the
        # lock makes the read coherent with concurrent inc()
        with self._lock:
            return self._v.get(tuple(sorted(labels.items())), 0.0)

    def total(self) -> float:
        """Sum over every label set — the 'how many, regardless of why'
        read consumers like the inspection memtable want."""
        with self._lock:
            return sum(self._v.values())

    def value_matching(self, **labels) -> float:
        """Sum over every label set CONTAINING the given pairs — the
        partial-match read for counters that carry extra dimensions
        (e.g. value_matching(outcome="follower") sums across reasons)."""
        want = set(labels.items())
        with self._lock:
            return sum(v for key, v in self._v.items() if want.issubset(key))

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:  # a concurrent inc() may insert a new label set
            items = sorted(self._v.items())
        for key, v in items:
            lbl = _fmt_labels(key)
            out.append(f"{self.name}{{{lbl}}} {v}" if lbl else f"{self.name} {v}")
        return out


class Gauge:
    """Settable point-in-time value (queue depths, in-flight counts)."""

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._v = defaultdict(float)  # label tuple → value
        self._lock = threading.Lock()

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._v[tuple(sorted(labels.items()))] = v

    def add(self, n: float = 1.0, **labels) -> None:
        with self._lock:
            self._v[tuple(sorted(labels.items()))] += n

    def value(self, **labels) -> float:
        # .get under the lock, like Counter.value: the defaultdict read
        # would otherwise insert the key and race a concurrent render
        with self._lock:
            return self._v.get(tuple(sorted(labels.items())), 0.0)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._v.items())
        for key, v in items:
            lbl = _fmt_labels(key)
            out.append(f"{self.name}{{{lbl}}} {v}" if lbl else f"{self.name} {v}")
        return out


class Histogram:
    """Histogram with optional labels: `observe(v)` feeds the base
    (unlabeled) series; `observe(v, resource_group="g")` feeds that label
    set's shard INSTEAD — label sets partition the observations exactly
    like Counter labels do, so consumers that sum a metric across its
    label instances (metrics_summary, MetricsHistory.base_rates) stay
    correct. The base series renders only while it has samples or no
    shards exist (a labeled histogram exposes labeled children only)."""

    def __init__(self, name: str, help_: str, buckets: tuple = _BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = buckets
        self._lock = threading.Lock()
        self._counts = [0] * (len(buckets) + 1)
        self._sum = 0.0
        self._n = 0
        # label tuple → [counts, sum, n]
        self._shards: dict[tuple, list] = {}

    def _observe_into(self, counts: list, v: float) -> None:
        for i, b in enumerate(self.buckets):
            if v <= b:
                counts[i] += 1
                return
        counts[-1] += 1

    def observe(self, v: float, **labels) -> None:
        with self._lock:
            if labels:
                key = tuple(sorted(labels.items()))
                shard = self._shards.get(key)
                if shard is None:
                    shard = self._shards[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
                shard[1] += v
                shard[2] += 1
                self._observe_into(shard[0], v)
            else:
                self._sum += v
                self._n += 1
                self._observe_into(self._counts, v)

    def _render_series(self, out: list[str], counts: list, total_sum: float,
                       n: int, lbl: str) -> None:
        sep = "," if lbl else ""
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += counts[i]
            out.append(f'{self.name}_bucket{{le="{b}"{sep}{lbl}}} {cum}')
        out.append(f'{self.name}_bucket{{le="+Inf"{sep}{lbl}}} {n}')
        suffix = f"{{{lbl}}}" if lbl else ""
        out.append(f"{self.name}_sum{suffix} {total_sum}")
        out.append(f"{self.name}_count{suffix} {n}")

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            if self._n or not self._shards:
                self._render_series(out, self._counts, self._sum, self._n, "")
            for key in sorted(self._shards):
                counts, s, n = self._shards[key]
                self._render_series(out, counts, s, n, _fmt_labels(key))
        return out


class Registry:
    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Counter(name, help_)
                self._metrics[name] = m
            return m

    def gauge(self, name: str, help_: str = "") -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Gauge(name, help_)
                self._metrics[name] = m
            return m

    def histogram(self, name: str, help_: str = "", buckets: tuple = _BUCKETS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help_, buckets)
                self._metrics[name] = m
            return m

    def _snapshot(self) -> list:
        """Metrics in name order, snapshotted under the registry lock —
        a reader must not iterate `_metrics` while a first-use
        counter()/gauge() call inserts into it."""
        with self._lock:
            return sorted(self._metrics.items())

    def render(self) -> str:
        lines: list[str] = []
        for _name, m in self._snapshot():
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def rows(self) -> list[tuple[str, str, float]]:
        """Flat (metric, labels, value) rows for the METRICS memtable."""
        out = []
        for name, m in self._snapshot():
            if isinstance(m, (Counter, Gauge)):
                # under the metric's lock: inc() can insert a label set
                # while this reader iterates
                with m._lock:
                    items = sorted(m._v.items())
                for key, v in items:
                    out.append((name, ",".join(f"{k}={val}" for k, val in key), v))
            else:
                # under the histogram's lock: observe() can insert a new
                # label shard while a metrics reader iterates
                with m._lock:
                    if m._n or not m._shards:
                        out.append((name + "_count", "", float(m._n)))
                        out.append((name + "_sum", "", m._sum))
                    for key in sorted(m._shards):
                        _, s, n = m._shards[key]
                        lbl = ",".join(f"{k}={val}" for k, val in key)
                        out.append((name + "_count", lbl, float(n)))
                        out.append((name + "_sum", lbl, s))
        return out


REGISTRY = Registry()


SCHED_TASKS = REGISTRY.counter(
    "tidb_sched_tasks_total", "cop tasks through the admission scheduler by outcome"
)
SCHED_QUEUE_DEPTH = REGISTRY.gauge(
    "tidb_sched_queue_depth", "cop tasks currently waiting for admission"
)
SCHED_WAIT = REGISTRY.histogram(
    "tidb_sched_wait_seconds", "admission wait time per cop task"
)
SCHED_BATCH_OCCUPANCY = REGISTRY.histogram(
    "tidb_sched_batch_occupancy", "cop tasks coalesced per device launch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
RU_CONSUMED = REGISTRY.counter(
    "tidb_resource_group_ru_total", "request units consumed per resource group"
)
COP_RETRIES = REGISTRY.counter(
    "tidb_cop_retries_total", "cop-task backoff retries by error class"
)
COP_BACKOFF = REGISTRY.histogram(
    "tidb_cop_backoff_seconds", "per-retry backoff sleep on the cop path"
)
BREAKER_STATE = REGISTRY.gauge(
    "tidb_tpu_breaker_state", "TPU engine circuit breaker state (0 closed, 1 half-open, 2 open)"
)
BREAKER_TRIPS = REGISTRY.counter(
    "tidb_tpu_breaker_trips_total", "TPU engine circuit breaker trips to open"
)
TPU_COMPILE_CACHE = REGISTRY.counter(
    "tidb_tpu_compile_cache_total", "device program-cache lookups by result"
)
TPU_TRANSFER_BYTES = REGISTRY.counter(
    "tidb_tpu_transfer_bytes_total", "host<->device transfer bytes by direction"
)
TPU_EXECUTE_SECONDS = REGISTRY.histogram(
    "tidb_tpu_device_execute_seconds",
    "device execute+fetch wall time (dispatch to device_get completion)",
)
TPU_SHARED_UPLOAD_BYTES = REGISTRY.counter(
    "tidb_tpu_shared_upload_bytes_total",
    "h2d bytes uploaded by grouped launches on behalf of the whole group",
)
TPU_FALLBACK = REGISTRY.counter(
    "tidb_tpu_fallback_total",
    "device-path declines/degrades to the host engine by path (cop|mpp|window) and typed reason",
)
TPU_LANE_OCCUPANCY = REGISTRY.gauge(
    "tidb_tpu_lane_occupancy",
    "in-flight cop tasks placed on each device runner lane",
)
TPU_LANE_LAUNCHES = REGISTRY.counter(
    "tidb_tpu_lane_launch_total",
    "device launches per runner lane, solo vs grouped",
)
TPU_LANE_REROUTES = REGISTRY.counter(
    "tidb_tpu_lane_reroutes_total",
    "placements diverted off the resident lane (reason: breaker | spill)",
)

# the store (ref: tidb_tpu/utils/metrics.py): transaction outcomes, and the
# bulk ingest's rows published and bytes by pipeline stage — encode
# (canonical columnar artifact bytes), wal (journaled; absent for
# in-memory stores), publish (artifact bytes made visible)
TXN_TOTAL = REGISTRY.counter("tidb_txn_total", "transaction outcomes")
INGEST_ROWS = REGISTRY.counter(
    "tidb_ingest_rows_total", "rows published by bulk-ingest commits"
)
INGEST_BYTES = REGISTRY.counter(
    "tidb_ingest_bytes_total",
    "bulk-ingest bytes by pipeline stage (parse | encode | wal | publish)",
)

# runaway-control series (ref: tidb_tpu/utils/metrics.py; sched/runaway.py)
RUNAWAY_ACTIONS = REGISTRY.counter(
    "tidb_runaway_actions_total",
    "runaway QUERY_LIMIT actions fired, by group, action and breached rule",
)
RUNAWAY_WATCH_HITS = REGISTRY.counter(
    "tidb_runaway_watch_hits_total",
    "statements matched against the runaway watch list at admission",
)
