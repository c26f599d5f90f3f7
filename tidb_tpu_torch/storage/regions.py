"""Region map — key-space sharding metadata (copy of tidb_tpu/storage/regions.py; ref: unistore/cluster.go,
mock_region.go; PD's region tree).

Regions partition the key space [start, end). The cop client splits key
ranges along region boundaries into tasks (copr/coprocessor.go:151 analog);
on the TPU side each region's rows become a shard of the device mesh.
"""

from __future__ import annotations

import bisect
import random
from dataclasses import dataclass, field
from threading import RLock


def _mid_key(start: bytes, end: bytes) -> bytes | None:
    """Lexicographic midpoint of [start, end) — an arbitrary but valid
    split key (region boundaries may land anywhere inside an encoded key).
    Open-ended bounds extend with a 0x80 probe byte; None when the range
    is too narrow to split."""
    if end == b"":
        return start + b"\x80"
    width = max(len(start), len(end)) + 1
    a = int.from_bytes(start.ljust(width, b"\x00"), "big")
    b = int.from_bytes(end.ljust(width, b"\x00"), "big")
    mid = (a + b) // 2
    if mid <= a:
        return None
    key = mid.to_bytes(width, "big").rstrip(b"\x00")
    return key if start < key and (end == b"" or key < end) else None


@dataclass
class Region:
    id: int
    start: bytes  # inclusive; b"" = -inf
    end: bytes  # exclusive; b"" = +inf
    leader_store: int = 1
    epoch: int = 1

    def contains(self, key: bytes) -> bool:
        return self.start <= key and (self.end == b"" or key < self.end)


class RegionMap:
    def __init__(self):
        self._lock = RLock()
        self._next_id = 2
        self.regions: list[Region] = [Region(1, b"", b"")]

    def _starts(self):
        return [r.start for r in self.regions]

    def locate(self, key: bytes) -> Region:
        with self._lock:
            i = bisect.bisect_right(self._starts(), key) - 1
            return self.regions[max(i, 0)]

    def split(self, split_key: bytes) -> Region | None:
        """Split the region containing split_key at that key."""
        with self._lock:
            i = bisect.bisect_right(self._starts(), split_key) - 1
            r = self.regions[max(i, 0)]
            if r.start == split_key or (r.end != b"" and split_key >= r.end):
                return None
            new = Region(self._next_id, split_key, r.end, r.leader_store, r.epoch + 1)
            self._next_id += 1
            r.end = split_key
            r.epoch += 1
            self.regions.insert(i + 1, new)
            return new

    def split_many(self, keys: list[bytes]) -> int:
        n = 0
        for k in sorted(set(keys)):
            if self.split(k) is not None:
                n += 1
        return n

    def regions_in_range(self, start: bytes, end: bytes | None) -> list[Region]:
        """All regions overlapping [start, end)."""
        with self._lock:
            out = []
            for r in self.regions:
                if end is not None and end != b"" and r.start >= end:
                    break
                if r.end != b"" and r.end <= start:
                    continue
                out.append(r)
            return out

    def transfer_leader(self, region_id: int | None = None, to_store: int | None = None,
                        stores: int = 3, rng: random.Random | None = None) -> Region | None:
        """Move a region's leadership to another store (PD's
        transfer-leader operator). Leadership moves do NOT bump the epoch
        — an in-flight cop task built against the old leader sees a
        NotLeader-shaped mismatch and must chase the new leader, not
        re-split (the distinction the typed retry taxonomy exists for)."""
        with self._lock:
            if region_id is None:
                r = (rng or random).choice(self.regions)
            else:
                r = next((x for x in self.regions if x.id == region_id), None)
                if r is None:
                    return None
            r.leader_store = to_store if to_store is not None else (r.leader_store % stores) + 1
            return r

    def chaos_step(self, rng: random.Random | None = None) -> str:
        """One random act of region chaos — a mid-query split at a byte
        midpoint or a leader transfer — the failpoint-armed helper behind
        tests/test_chaos.py (arm it on `cop/before-task` with
        ("prob", p, lambda: store.regions.chaos_step()))."""
        rng = rng or random
        with self._lock:
            if rng.random() < 0.5:
                self.transfer_leader(rng=rng if isinstance(rng, random.Random) else None)
                return "transfer"
            r = self.regions[rng.randrange(len(self.regions))]
            key = _mid_key(r.start, r.end)
            if key is not None and self.split(key) is not None:
                return "split"
            return "none"

    def split_ranges(self, start: bytes, end: bytes) -> list[tuple["Region", bytes, bytes]]:
        """Clip [start, end) against region boundaries → per-region subranges
        (the buildCopTasks region alignment, copr/coprocessor.go:151)."""
        out = []
        for r in self.regions_in_range(start, end):
            s = max(start, r.start)
            e = end if r.end == b"" else (min(end, r.end) if end != b"" else r.end)
            if e == b"" or s < e:
                out.append((r, s, e))
        return out
