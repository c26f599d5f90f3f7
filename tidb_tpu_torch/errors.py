"""Errors of the port (the subset of `tidb_tpu/errors.py` the port raises,
with the reference's codes and messages, plus the port's own marker for
paths that have not been ported yet)."""

from __future__ import annotations


class TiDBError(Exception):
    """SQL-level error with a MySQL error code (ref: errors.go)."""

    code = 1105

    def __init__(self, msg: str = "", code: int | None = None):
        super().__init__(msg)
        self.msg = msg
        if code is not None:
            self.code = code


class ParseError(TiDBError):
    code = 1064


# --- schema and store errors (ref: errno/errno.go, kv/error.go) -------------


class UnknownDatabase(TiDBError):
    code = 1049


class UnknownTable(TiDBError):
    code = 1146


class UnknownColumn(TiDBError):
    code = 1054


class AmbiguousColumn(TiDBError):
    code = 1052


class DuplicateEntry(TiDBError):
    code = 1062


class WriteConflict(TiDBError):
    """Optimistic transaction write-write conflict (ref: kv/error.go ErrWriteConflict)."""

    code = 9007


class LockedError(TiDBError):
    """Key is locked by another in-flight transaction (percolator lock)."""

    code = 9008

    def __init__(self, msg="", key=None, lock=None):
        super().__init__(msg)
        self.key = key
        self.lock = lock


class DeadlockError(TiDBError):
    """Pessimistic lock wait closed a cycle (MySQL ER_LOCK_DEADLOCK)."""


class RetryableError(TiDBError):
    code = 9009


class TxnAborted(TiDBError):
    code = 9010


class QueryInterrupted(TiDBError):
    code = 1317


class MemoryQuotaExceeded(TiDBError):
    code = 8175


class ServerMemoryExceeded(MemoryQuotaExceeded):
    """The store-wide tidb_server_memory_limit was breached and THIS
    statement was the top consumer: the arbiter (utils/memory
    ServerMemTracker) fails the allocator in place instead of flagging
    its session (ref: util/servermemorylimit killSessIfNeeded)."""


class RunawayKilled(QueryInterrupted):
    """A statement crossed its resource group's QUERY_LIMIT with
    ACTION=KILL (ref: ErrResourceGroupQueryRunawayInterrupted, 8253).
    Subclasses QueryInterrupted so every interrupt-aware wait (admission,
    backoff, chunk boundaries) treats it like the kill it is."""

    code = 8253

    def __init__(self, msg: str = ""):
        super().__init__(msg)
        self.reason = "runaway"


class RunawayQuarantined(RunawayKilled):
    """A statement whose digest sits in the runaway watch list was
    rejected at admission, before consuming a ticket (ref:
    ErrResourceGroupQueryRunawayQuarantine, 8254)."""

    code = 8254


class ResourceGroupExists(TiDBError):
    """CREATE RESOURCE GROUP on an existing name (ref: ErrResourceGroupExists)."""

    code = 8248


class ResourceGroupNotExists(TiDBError):
    """ALTER/DROP/SET on an unknown resource group (ref: ErrResourceGroupNotExists)."""

    code = 8249


# --- cop-path retriable taxonomy (ref: store/tikv/retry + kv/error.go) ----
#
# The Backoffer (copr/retry.py) classifies every fault on the cop path into
# one of these before deciding whether/how long to back off; the blanket
# `except Exception` the device fallback used to hide behind is gone.


class RegionError(TiDBError):
    """A cop task's view of the region map went stale mid-flight — always
    retriable after re-locating (ref: errorpb region errors, 9005)."""

    code = 9005

    def __init__(self, msg: str = "", region_id: int | None = None):
        super().__init__(msg)
        self.region_id = region_id


class EpochNotMatch(RegionError):
    """Region split/merged since the task was built: the (id, epoch, span)
    no longer matches — re-split the remaining range (ref: EpochNotMatch)."""


class NotLeader(RegionError):
    """Region leadership moved stores; same data, new leader — retry the
    SAME task against the new leader, no re-split (ref: NotLeader)."""


class ServerBusy(RegionError):
    """Store rejected the task under load — retriable with a longer,
    decorrelated backoff (ref: ServerIsBusy, 9003)."""

    code = 9003


class ResourceGroupQueueFull(ServerBusy):
    """Admission queue overflow under sustained overload — the in-process
    ServerBusy: the cop client retries it through the Backoffer's
    serverBusy class before surfacing (ref: ErrResourceGroupThrottled
    8252; TiKV's ServerIsBusy→BoTiKVServerBusy loop)."""

    code = 8252


class DeviceError(TiDBError):
    """Base for TPU-engine faults classified at the engine boundary."""

    code = 9013


class DeviceTransientError(DeviceError):
    """Retriable device fault (preempted/ busy/ tunnel hiccup): worth a
    backoff-retry on the device path before conceding to the host."""


class DeviceFatalError(DeviceError):
    """Non-retriable device fault (miscompile, crashed runtime): feeds the
    circuit breaker; `auto` traffic falls back to host immediately."""

    code = 9014


class CircuitBreakerOpen(TiDBError):
    """TPU engine breaker is open: `engine='tpu'` requests fail fast with
    the breaker state instead of paying the fault cost per query."""

    code = 9015


class BackoffExhausted(TiDBError):
    """A cop task spent its whole backoff sleep budget and still failed;
    the message names the region, per-class attempt counts and last error."""

    code = 9004


class NotPortedError(NotImplementedError):
    """The reference runs this request on a path the port does not have yet.

    Raised instead of answering from the host: a DAG the reference would run
    on the device must never be answered quietly by another engine. `path`
    names the reference path (e.g. "tpu_engine._lower_agg_sorted")."""

    def __init__(self, path: str, detail: str = ""):
        self.path = path
        super().__init__(f"not ported yet: {path}" + (f" ({detail})" if detail else ""))
