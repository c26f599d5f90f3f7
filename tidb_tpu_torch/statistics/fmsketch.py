"""Flajolet-Martin sketch for NDV estimation (copy of tidb_tpu/statistics/fmsketch.py; ref: statistics/fmsketch.go —
numpy mask-based redesign)."""

from __future__ import annotations

import numpy as np


class FMSketch:
    __slots__ = ("mask", "hashset", "max_size")

    def __init__(self, max_size: int = 10000):
        self.mask = np.uint64(0)
        self.hashset: set[int] = set()
        self.max_size = max_size

    def insert_hashes(self, hashes: np.ndarray) -> None:
        for h in hashes.tolist():
            h = int(h)
            if h & int(self.mask) != 0:
                continue
            self.hashset.add(h)
            while len(self.hashset) > self.max_size:
                self.mask = np.uint64((int(self.mask) << 1) | 1)
                self.hashset = {x for x in self.hashset if x & int(self.mask) == 0}

    def ndv(self) -> int:
        return (int(self.mask) + 1) * len(self.hashset)

    def merge(self, other: "FMSketch") -> None:
        mask = max(int(self.mask), int(other.mask))
        merged = {x for x in self.hashset | other.hashset if x & mask == 0}
        self.mask = np.uint64(mask)
        self.hashset = merged
        while len(self.hashset) > self.max_size:
            self.mask = np.uint64((int(self.mask) << 1) | 1)
            self.hashset = {x for x in self.hashset if x & int(self.mask) == 0}

    def serialize(self) -> bytes:
        """Wire form for APPROX_COUNT_DISTINCT partial transport: little-
        endian mask then the hash set (ref: aggfuncs approx_count_distinct
        partial encoding)."""
        import struct

        hs = np.array(sorted(self.hashset), dtype=np.uint64)
        return struct.pack("<Q", int(self.mask)) + hs.tobytes()

    @staticmethod
    def deserialize(b: bytes, max_size: int = 10000) -> "FMSketch":
        import struct

        sk = FMSketch(max_size)
        sk.mask = np.uint64(struct.unpack_from("<Q", b)[0])
        sk.hashset = set(np.frombuffer(b[8:], dtype=np.uint64).tolist())
        return sk
