"""Resource control for the cop path (ref: tidb_tpu/sched/__init__.py).

  ResourceGroupManager — RU token buckets + priority per group
      (sched/resource_group.py).
  AdmissionScheduler — the inline admission gate: per-priority wait
      queues, RU debt checks, deadline/KILL-aware waiting, hard
      backpressure beyond MAX_QUEUE (sched/scheduler.py).
  LaunchBatcher — cross-session micro-batching of compatible device
      launches (same DAG digest + tile bucket on one device lane): dedup
      of identical snapshot reads plus one grouped launch and one fetch
      through `TorchEngine.execute_many` (sched/batcher.py).

The runaway watchdog (sched/runaway.py) is the reference's; the per-store
facade that hangs it and the groups off a Storage (ResourceController)
comes with the cop client (copr/client.py), and the port's store
(storage/txn.py) raises NotPortedError for `Storage.sched` until then; a
caller holds its own engine and batcher (entry.run_burst).
"""

from __future__ import annotations

from .batcher import LaunchBatcher
from .resource_group import (
    DEFAULT_GROUP,
    PRIORITIES,
    ResourceGroup,
    ResourceGroupManager,
    TokenBucket,
)
from .scheduler import (
    AdmissionScheduler,
    SchedCtx,
    Ticket,
    raise_if_interrupted,
    ru_cost,
    sleep_interruptible,
)

__all__ = [
    "AdmissionScheduler", "DEFAULT_GROUP", "LaunchBatcher", "PRIORITIES",
    "ResourceGroup", "ResourceGroupManager", "SchedCtx", "Ticket",
    "TokenBucket", "raise_if_interrupted", "ru_cost", "sleep_interruptible",
]
