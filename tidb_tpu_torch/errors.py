"""Errors of the port (the subset of `tidb_tpu/errors.py` this slice raises,
plus the port's own marker for paths that have not been ported yet)."""

from __future__ import annotations


class TiDBError(Exception):
    """SQL-level error with a MySQL error code (ref: errors.go)."""

    code = 1105

    def __init__(self, msg: str = "", code: int | None = None):
        super().__init__(msg)
        if code is not None:
            self.code = code


class NotPortedError(NotImplementedError):
    """The reference runs this request on a path the port does not have yet.

    Raised instead of answering from the host: a DAG the reference would run
    on the device must never be answered quietly by another engine. `path`
    names the reference path (e.g. "tpu_engine._lower_agg_sorted")."""

    def __init__(self, path: str, detail: str = ""):
        self.path = path
        super().__init__(f"not ported yet: {path}" + (f" ({detail})" if detail else ""))
