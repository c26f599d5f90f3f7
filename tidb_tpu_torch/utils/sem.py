"""Security-Enhanced Mode (copy of tidb_tpu/utils/sem.py; ref:
util/sem/sem.go): a process-level switch (config/CLI, NOT settable via
SQL) that hides high-risk surfaces even from SUPER users — restricted
system variables reject SET and read as empty, restricted introspection
tables disappear, and the FILE surface (SELECT INTO OUTFILE, LOAD_FILE,
LOAD DATA from server paths) is denied.
"""

from __future__ import annotations

_ENABLED = False

# sysvars invisible/unsettable under SEM (ref: sem.go restrictedVariables)
RESTRICTED_VARIABLES = frozenset((
    "tidb_general_log",
    "tidb_snapshot",
    "tidb_enable_telemetry",
    "tidb_force_priority",
    "tidb_row_format_version",
))

# information_schema tables hidden under SEM (ref: sem.go restrictedTables)
RESTRICTED_TABLES = frozenset((
    "slow_query",
    "metrics",
    "metrics_summary",
    "deadlocks",
    "top_sql",
))


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:  # tests only — the reference has no runtime off-switch
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def check_variable(name: str) -> None:
    if _ENABLED and name in RESTRICTED_VARIABLES:
        raise ValueError(
            f"Variable '{name}' is unsupported when security enhanced mode is enabled"
        )


def check_table(name: str) -> bool:
    """True when the memtable is visible under the current mode."""
    return not (_ENABLED and name.lower() in RESTRICTED_TABLES)


def check_file_access() -> None:
    if _ENABLED:
        from ..errors import TiDBError

        raise TiDBError(
            "FILE operations are not permitted when security enhanced mode is enabled"
        )
