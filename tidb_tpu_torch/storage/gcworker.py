"""The GC worker's duration parser (copy of tidb_tpu/storage/gcworker.py:18
`parse_go_duration_ms`; the GCWorker itself comes with the durable store,
ROADMAP Queue 1 item 4.1). The runaway watchdog's durations
(sched/runaway.parse_duration_ms) read through it.
"""

from __future__ import annotations


def parse_go_duration_ms(s: str) -> int | None:
    """'10m0s' / '1h30m' / '90s' → milliseconds (the tidb_gc_* format,
    ref: gc_worker.go parseDuration)."""
    import re

    s = s.strip().lower()
    if not s:
        return None
    ms = 0.0
    pos = 0
    for m in re.finditer(r"(\d+(?:\.\d+)?)(ms|h|m|s)", s):
        if m.start() != pos:
            return None
        v = float(m.group(1))
        ms += v * {"h": 3_600_000, "m": 60_000, "s": 1_000, "ms": 1}[m.group(2)]
        pos = m.end()
    return int(ms) if pos == len(s) and pos else None
