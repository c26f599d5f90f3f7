"""Equi-depth histogram (copy of tidb_tpu/statistics/histogram.py; ref: statistics/histogram.go:48 — redesigned as
numpy bucket arrays over a numeric surrogate domain).

Values of every SQL type map to an order-preserving float64 surrogate
(ints/times as-is, decimals descaled, strings via an 8-byte big-endian
prefix of the key encoding), so one array-based histogram implementation
covers all types; estimates only need order, not exact values.
"""

from __future__ import annotations

import numpy as np


class Histogram:
    """`uppers[i]` is the inclusive upper bound of bucket i; `cum[i]` is the
    cumulative row count through bucket i. Built equi-depth from a sorted
    (possibly sampled) value array, scaled to the true non-null count."""

    __slots__ = ("uppers", "lowers", "cum", "total", "ndv")

    def __init__(self, uppers: np.ndarray, lowers: np.ndarray, cum: np.ndarray, total: float, ndv: int):
        self.uppers = uppers
        self.lowers = lowers
        self.cum = cum
        self.total = float(total)
        self.ndv = int(ndv)

    @staticmethod
    def build(values: np.ndarray, total_rows: int, ndv: int, n_buckets: int = 64) -> "Histogram | None":
        """values: non-null surrogate array (unsorted ok)."""
        n = len(values)
        if n == 0:
            return None
        v = np.sort(values.astype(np.float64))
        n_buckets = max(1, min(n_buckets, n))
        # equi-depth split points
        idx = np.linspace(0, n, n_buckets + 1).astype(np.int64)
        idx = np.unique(idx)
        uppers = v[np.clip(idx[1:] - 1, 0, n - 1)]
        lowers = v[np.clip(idx[:-1], 0, n - 1)]
        counts = np.diff(idx).astype(np.float64)
        scale = total_rows / n
        cum = np.cumsum(counts) * scale
        return Histogram(uppers, lowers, cum, total_rows, ndv)

    def less_row_count(self, x: float) -> float:
        """Rows with value < x (linear interpolation inside a bucket,
        ref: histogram.go lessRowCountWithBktIdx)."""
        if self.total <= 0:
            return 0.0
        b = int(np.searchsorted(self.uppers, x, side="left"))
        if b >= len(self.uppers):
            return self.total
        prev = self.cum[b - 1] if b > 0 else 0.0
        in_bucket = self.cum[b] - prev
        lo, hi = self.lowers[b], self.uppers[b]
        if x <= lo:
            frac = 0.0
        elif hi > lo:
            frac = min(max((x - lo) / (hi - lo), 0.0), 1.0)
        else:
            frac = 0.0
        return prev + in_bucket * frac

    def range_row_count(self, lo: float | None, hi: float | None, lo_incl: bool, hi_incl: bool) -> float:
        lo_cnt = 0.0 if lo is None else self.less_row_count(lo) + (0.0 if lo_incl else self.equal_row_count(lo))
        hi_cnt = self.total if hi is None else self.less_row_count(hi) + (self.equal_row_count(hi) if hi_incl else 0.0)
        return max(hi_cnt - lo_cnt, 0.0)

    def equal_row_count(self, x: float) -> float:
        """Average rows per distinct value (TopN handles heavy hitters)."""
        if self.ndv <= 0:
            return 0.0
        return self.total / self.ndv

    def to_json(self):
        return {
            "uppers": self.uppers.tolist(),
            "lowers": self.lowers.tolist(),
            "cum": self.cum.tolist(),
            "total": self.total,
            "ndv": self.ndv,
        }

    @staticmethod
    def from_json(d) -> "Histogram":
        return Histogram(
            np.asarray(d["uppers"], dtype=np.float64),
            np.asarray(d["lowers"], dtype=np.float64),
            np.asarray(d["cum"], dtype=np.float64),
            d["total"], d["ndv"],
        )
