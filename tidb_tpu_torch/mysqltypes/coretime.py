"""Datetime/date representation (copy of tidb_tpu/mysqltypes/coretime.py,
trimmed to packing, parsing and formatting; ref: types/time.go).

A datetime is packed into a single int64 whose natural integer order equals
chronological order, so packed times compare/sort/min/max directly as int64
lanes on device:

    packed = ((((((year*13 + month)*32 + day)*24 + hour)*60 + minute)*60
               + second) * 1_000_000) + microsecond

(The *13 month radix matches the reference's core time layout idea; zero
month/day values used by MySQL "zero dates" survive the packing.)
"""

from __future__ import annotations

import re

_US = 1_000_000

# Extraction divisors/moduli derived from the packing radices — the single
# source of truth shared with expr/builtins date functions.
DIV_SECOND = _US
DIV_MINUTE = DIV_SECOND * 60
DIV_HOUR = DIV_MINUTE * 60
DIV_DAY = DIV_HOUR * 24
DIV_MONTH = DIV_DAY * 32
DIV_YEAR = DIV_MONTH * 13
MOD_MICRO = _US
MOD_SECOND = 60
MOD_MINUTE = 60
MOD_HOUR = 24
MOD_DAY = 32
MOD_MONTH = 13


def pack_time(year: int, month: int, day: int, hour: int = 0, minute: int = 0, second: int = 0, micro: int = 0) -> int:
    ymd = (year * 13 + month) * 32 + day
    return ((((ymd * 24 + hour) * 60 + minute) * 60 + second)) * _US + micro


def unpack_time(packed: int):
    micro = packed % _US
    t = packed // _US
    second = t % 60
    t //= 60
    minute = t % 60
    t //= 60
    hour = t % 24
    t //= 24
    day = t % 32
    t //= 32
    month = t % 13
    year = t // 13
    return year, month, day, hour, minute, second, micro


_DT_RE = re.compile(
    r"^\s*(\d{4})[-/](\d{1,2})[-/](\d{1,2})"
    r"(?:[T ](\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:\.(\d{1,6}))?)?)?\s*$"
)


def parse_datetime(s: str) -> int | None:
    """Parse 'YYYY-MM-DD[ HH:MM:SS[.ffffff]]' → packed int64, None if invalid."""
    m = _DT_RE.match(s)
    if not m:
        return None
    year, month, day = int(m.group(1)), int(m.group(2)), int(m.group(3))
    hour = int(m.group(4) or 0)
    minute = int(m.group(5) or 0)
    second = int(m.group(6) or 0)
    frac = m.group(7) or ""
    micro = int(frac.ljust(6, "0")) if frac else 0
    if month > 12 or day > 31 or hour > 23 or minute > 59 or second > 59:
        return None
    return pack_time(year, month, day, hour, minute, second, micro)


def format_time(packed: int, is_date: bool = False, fsp: int = 0) -> str:
    y, mo, d, h, mi, s, us = unpack_time(packed)
    if is_date:
        return f"{y:04d}-{mo:02d}-{d:02d}"
    base = f"{y:04d}-{mo:02d}-{d:02d} {h:02d}:{mi:02d}:{s:02d}"
    if fsp > 0:
        base += "." + f"{us:06d}"[:fsp]
    return base
