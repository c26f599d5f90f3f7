"""Selectivity estimation over pushed-down conjuncts (copy of tidb_tpu/statistics/selectivity.py; ref: statistics/
selectivity.go:177 Selectivity — simplified to per-conjunct independence,
which is what the planner needs for access-path and join-side choices)."""

from __future__ import annotations

from dataclasses import dataclass

from ..planner.ranger import _simple_cond, const_to_col_datum
from .tablestats import TableStats, surrogate_datum

SELECTION_FACTOR = 0.8  # default for unmatchable conds (ref: selectionFactor)


def cond_selectivity(ts: TableStats, cond, visible_cols) -> float:
    """Fraction of rows one conjunct keeps."""
    if ts.row_count <= 0:
        return 1.0
    s = _simple_cond(cond)
    if s is None:
        name = getattr(getattr(cond, "sig", None), "name", "")
        if name == "isnull":
            arg = cond.args[0]
            idx = getattr(arg, "idx", None)
            if idx is not None and 0 <= idx < len(visible_cols):
                cs = ts.col(visible_cols[idx].id)
                if cs is not None and cs.total > 0:
                    return cs.null_count / cs.total
        return SELECTION_FACTOR
    off, op, vals = s
    if off >= len(visible_cols):
        return SELECTION_FACTOR
    col = visible_cols[off]
    cs = ts.col(col.id)
    if cs is None or cs.total <= 0:
        return SELECTION_FACTOR
    if op in ("eq", "in"):
        rows = 0.0
        for v in vals:
            d = const_to_col_datum(v, col.ft)
            if d is None:
                continue
            sur = surrogate_datum(d, col.ft)
            if sur is None:
                continue
            rows += cs.eq_rows(sur)
        return min(rows / ts.row_count, 1.0)
    # range ops
    d = const_to_col_datum(vals[0], col.ft)
    sur = surrogate_datum(d, col.ft) if d is not None else None
    if sur is None:
        return 1 / 3.0
    if op in ("gt", "ge"):
        rows = cs.range_rows(sur, None, op == "ge", False)
    else:
        rows = cs.range_rows(None, sur, False, op == "le")
    return min(rows / ts.row_count, 1.0)


def estimate_conds(ts: TableStats | None, conds, visible_cols) -> float:
    """Combined selectivity of a conjunct list (independence assumption)."""
    if ts is None:
        sel = 1.0
        for _ in conds:
            sel *= SELECTION_FACTOR
        return sel
    sel = 1.0
    for c in conds:
        sel *= cond_selectivity(ts, c, visible_cols)
    return sel


@dataclass
class AccessEstimate:
    rows: float  # estimated rows the access path returns
    total: float  # table row count used
