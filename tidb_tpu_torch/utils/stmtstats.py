"""Slow-query log + statement summary (copy of tidb_tpu/utils/stmtstats.py; ref: executor/adapter.go:922
LogSlowQuery + util/stmtsummary/statement_summary.go — kept in memory and
read back as INFORMATION_SCHEMA.SLOW_QUERY / STATEMENTS_SUMMARY)."""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque


import functools


def _mask_literals(sql: str, lower: bool) -> str | None:
    """Tokenize and replace literal tokens with '?' — the single place
    that decides what counts as user data (digests + redaction agree)."""
    from ..parser.lexer import tokenize

    try:
        toks = tokenize(sql)
    except Exception:  # noqa: BLE001 — masking must never fail the statement
        return None
    parts = []
    for t in toks:
        if t.kind in ("num", "str", "hex"):
            parts.append("?")
        elif t.kind == "eof":
            break
        else:
            parts.append(t.text.lower() if lower else t.text)
    return " ".join(parts)


@functools.lru_cache(maxsize=2048)
def sql_digest(sql: str) -> str:
    """Normalized statement digest: literals → '?', idents lowercased
    (ref: parser digests used by stmtsummary/topsql)."""
    norm = _mask_literals(sql, lower=True)
    if norm is None:
        return hashlib.sha256(sql.encode()).hexdigest()[:16]
    return hashlib.sha256(norm.encode()).hexdigest()[:16]


@functools.lru_cache(maxsize=2048)
def normalize_sql(sql: str) -> str:
    """Literal-free statement text (tidb_redact_log: logs must carry no
    user data; ref: errors.RedactLogEnabled + parser.Normalize)."""
    out = _mask_literals(sql, lower=False)
    return out if out is not None else "<redacted>"


class StmtStats:
    """Shared per-store statement telemetry."""

    def __init__(self, slow_capacity: int = 512, summary_capacity: int = 512):
        self.slow: deque = deque(maxlen=slow_capacity)
        self.summary: dict[str, dict] = {}
        self.summary_capacity = summary_capacity
        self._lock = threading.Lock()

    # cop-path exec details carried per statement (utils/tracing
    # StatementTrace.details()); summed per digest in the summary,
    # verbatim on each slow-log entry (ref: util/execdetails fields of
    # LogSlowQuery / stmtsummary)
    DETAIL_KEYS = ("sched_wait_ms", "retries", "backoff_ms", "compile_ms",
                   "transfer_bytes", "mem_degraded_tasks", "quorum_wait_ms")

    def record(
        self, sql: str, dur_s: float, user: str, db: str, ok: bool,
        slow_threshold_s: float, cpu_s: float = 0.0, *,
        summary_on: bool = True, slow_log_on: bool = True,
        max_sql_len: int = 256, redact: bool = False,
        details: dict | None = None,
    ) -> None:
        """Record one statement. The keyword gates map the reference's
        knobs: tidb_enable_stmt_summary, tidb_enable_slow_log,
        tidb_stmt_summary_max_sql_length, tidb_redact_log (literals →
        '?' in every stored sample). summary_capacity is store-level,
        applied by SET GLOBAL tidb_stmt_summary_max_stmt_count.
        `details` carries the statement's cop-path exec details
        (sched_wait_ms, batch_occupancy, retries, backoff_ms, compile_ms,
        transfer_bytes)."""
        digest = sql_digest(sql)
        if redact:
            sql = normalize_sql(sql)
        now = time.time()
        d = details or {}
        with self._lock:
            if summary_on:
                st = self.summary.get(digest)
                if st is None:
                    if len(self.summary) >= self.summary_capacity:
                        # evict the least-executed entry (summary eviction)
                        victim = min(self.summary, key=lambda k: self.summary[k]["exec_count"])
                        del self.summary[victim]
                    st = {
                        "digest": digest,
                        "sample_sql": sql[:max_sql_len],
                        "exec_count": 0,
                        "sum_latency_s": 0.0,
                        "max_latency_s": 0.0,
                        "sum_cpu_s": 0.0,
                        "errors": 0,
                    }
                    self.summary[digest] = st
                st["exec_count"] += 1
                st["sum_latency_s"] += dur_s
                st["max_latency_s"] = max(st["max_latency_s"], dur_s)
                st["sum_cpu_s"] = st.get("sum_cpu_s", 0.0) + cpu_s
                if not ok:
                    st["errors"] += 1
                for k in self.DETAIL_KEYS:
                    st["sum_" + k] = st.get("sum_" + k, 0.0) + d.get(k, 0.0)
                st["max_batch_occupancy"] = max(
                    st.get("max_batch_occupancy", 0), int(d.get("batch_occupancy", 0))
                )
                # peak tracked memory is a high-water mark, not a sum
                st["max_mem_bytes"] = max(
                    st.get("max_mem_bytes", 0), int(d.get("mem_bytes", 0))
                )
                # how many executions of this digest a follower actually
                # served (the replica name itself is per-execution: slow
                # log carries it verbatim)
                st["replica_reads"] = st.get("replica_reads", 0) + (
                    1 if d.get("replica") else 0
                )
            if slow_log_on and dur_s >= slow_threshold_s:
                entry = {
                    "time": now,
                    "user": user,
                    "db": db,
                    "query_time_s": dur_s,
                    "digest": digest,
                    "query": sql[:512],
                    "succ": ok,
                    "batch_occupancy": int(d.get("batch_occupancy", 0)),
                    "mem_bytes": int(d.get("mem_bytes", 0)),
                    "replica": str(d.get("replica", "") or ""),
                }
                for k in self.DETAIL_KEYS:
                    entry[k] = d.get(k, 0.0)
                self.slow.append(entry)
