"""Count-Min sketch + TopN (copy of tidb_tpu/statistics/cmsketch.py; ref: statistics/cmsketch.go:46,503 — vectorized
numpy build instead of per-row insertion)."""

from __future__ import annotations

import numpy as np

_PRIMES = np.array([2654435761, 2246822519, 3266489917, 668265263], dtype=np.uint64)
_DEPTH = 4


class CMSketch:
    __slots__ = ("width", "table")

    def __init__(self, width: int = 2048, table: np.ndarray | None = None):
        self.width = width
        self.table = table if table is not None else np.zeros((_DEPTH, width), dtype=np.int64)

    @staticmethod
    def _rows(hashes: np.ndarray, width: int) -> np.ndarray:
        """(depth, n) bucket indices from one 64-bit hash per value."""
        h = hashes.astype(np.uint64)
        return np.stack([((h * p) >> np.uint64(17)) % np.uint64(width) for p in _PRIMES])

    def insert_many(self, hashes: np.ndarray, counts: np.ndarray) -> None:
        rows = self._rows(hashes, self.width)
        for d in range(_DEPTH):
            np.add.at(self.table[d], rows[d], counts)

    def query_hash(self, h: int) -> int:
        rows = self._rows(np.array([h], dtype=np.uint64), self.width)
        return int(min(self.table[d][rows[d][0]] for d in range(_DEPTH)))

    def merge(self, other: "CMSketch") -> None:
        self.table += other.table

    def to_json(self):
        return {"width": self.width, "table": self.table.tolist()}

    @staticmethod
    def from_json(d) -> "CMSketch":
        return CMSketch(d["width"], np.asarray(d["table"], dtype=np.int64))


class TopN:
    """Heavy hitters kept exactly, excluded from the histogram/CMS domain
    (ref: cmsketch.go TopN)."""

    __slots__ = ("items",)

    def __init__(self, items: dict[int, int] | None = None):
        self.items = items or {}  # value hash → exact count

    def get(self, h: int) -> int | None:
        return self.items.get(h)

    @property
    def total(self) -> int:
        return sum(self.items.values())

    def to_json(self):
        return {str(k): v for k, v in self.items.items()}

    @staticmethod
    def from_json(d) -> "TopN":
        return TopN({int(k): v for k, v in d.items()})


def hash_values(values: np.ndarray) -> np.ndarray:
    """Order-free 64-bit hashes for a surrogate/object lane."""
    if values.dtype == object:
        return np.array([hash(v) & 0xFFFFFFFFFFFFFFFF for v in values], dtype=np.uint64)
    v = values.astype(np.float64).view(np.uint64)
    v = (v ^ (v >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
    return v ^ (v >> np.uint64(33))
