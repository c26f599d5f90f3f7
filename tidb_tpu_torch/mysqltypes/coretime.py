"""Datetime/date representation (copy of tidb_tpu/mysqltypes/coretime.py;
ref: types/time.go, types/core_time.go).

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


def number_to_datetime(v: int) -> int | None:
    """MySQL numeric datetime forms: YYYYMMDD or YYYYMMDDHHMMSS
    (ref: types/time.go ParseDatetimeFromNum)."""
    if v <= 0:
        return 0 if v == 0 else None
    s = str(v)
    if len(s) <= 8:
        s = s.zfill(8)
        return parse_datetime(f"{s[:4]}-{s[4:6]}-{s[6:8]}")
    if len(s) <= 14:
        s = s.zfill(14)
        return parse_datetime(f"{s[:4]}-{s[4:6]}-{s[6:8]} {s[8:10]}:{s[10:12]}:{s[12:14]}")
    return None


def time_year(packed: int) -> int:
    return packed // (_US * 60 * 60 * 24 * 32 * 13)


def time_month(packed: int) -> int:
    return (packed // (_US * 60 * 60 * 24 * 32)) % 13


def time_day(packed: int) -> int:
    return (packed // (_US * 60 * 60 * 24)) % 32


def time_hour(packed: int) -> int:
    return (packed // (_US * 60 * 60)) % 24


def time_minute(packed: int) -> int:
    return (packed // (_US * 60)) % 60


def time_second(packed: int) -> int:
    return (packed // _US) % 60


_DUR_RE = re.compile(r"^\s*(-)?(\d+):(\d{1,2})(?::(\d{1,2})(?:\.(\d{1,6}))?)?\s*$")


def parse_duration(s: str) -> int | None:
    """'[-]HH:MM[:SS[.f]]' → signed microseconds; MySQL parses the
    two-part form as hours:minutes (ref: types/duration.go)."""
    m = _DUR_RE.match(s)
    if m is None:
        return None
    neg, h, mi, sec, frac = m.groups()
    mi = int(mi)
    sec = int(sec) if sec is not None else 0
    if mi > 59 or sec > 59:
        return None
    us = ((int(h) * 3600 + mi * 60 + sec) * 1_000_000) + int((frac or "0").ljust(6, "0"))
    return -us if neg else us
