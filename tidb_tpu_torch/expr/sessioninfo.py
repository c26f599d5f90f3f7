"""Per-session info visible to builtin kernels (copy of
tidb_tpu/expr/sessioninfo.py; ref: sessionctx.Context
reaching builtin_info.go via the expression EvalContext).

The Session publishes a mutable dict through a contextvar at construction
and keeps it current per statement; info builtins (USER(), FOUND_ROWS(),
GET_LOCK(), ...) read it at eval time. Defaults keep the kernels usable
outside a session (tests, direct expression eval)."""

from __future__ import annotations

import contextvars

CURRENT: contextvars.ContextVar[dict] = contextvars.ContextVar("tidb_session_info")


def get(key: str, default=None):
    try:
        info = CURRENT.get()
    except LookupError:
        return default
    return info.get(key, default)


def now_epoch(vars_dict: dict | None = None) -> float:
    """NOW()'s clock: the `timestamp` sysvar freezes it when set (MySQL
    SET timestamp=N; replication/test determinism), else wall clock.
    Shared by plan-time constant folding and the runtime kernels so the
    two can never disagree on freeze semantics."""
    import time

    if vars_dict is None:
        vars_dict = get("vars") or {}
    frozen = vars_dict.get("timestamp", "")
    if frozen not in ("", "0", None):
        try:
            return float(frozen)
        except ValueError:
            pass
    return time.time()
