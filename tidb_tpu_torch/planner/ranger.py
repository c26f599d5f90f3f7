"""Key-range helpers of the planner's ranger (ref: tidb_tpu/planner/ranger.py:200
`prefix_next`, copied; the range builder itself comes with the planner).
"""

from __future__ import annotations


def prefix_next(b: bytes) -> bytes:
    """Smallest key greater than every key having prefix b (kv.Key.PrefixNext)."""
    ba = bytearray(b)
    for i in range(len(ba) - 1, -1, -1):
        if ba[i] != 0xFF:
            ba[i] += 1
            return bytes(ba[: i + 1])
        ba[i] = 0
    return b + b"\xff"
