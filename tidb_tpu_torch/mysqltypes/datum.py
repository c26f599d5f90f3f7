"""Datum — the boxed SQL value (copy of tidb_tpu/mysqltypes/datum.py; ref:
types/datum.go).

Used only at slow boundaries (constants, point values, result rendering);
the hot paths operate on columnar Chunk/Tile data, never on Datums.
"""

from __future__ import annotations

import math
from fractions import Fraction

from .mydecimal import Dec, dec_from_string, dec_from_float, pow10
from .field_type import FieldType, TypeCode
from .coretime import format_time

K_NULL = 0
K_INT = 1
K_UINT = 2
K_FLOAT = 3
K_DEC = 4
K_STR = 5
K_BYTES = 6
K_TIME = 7  # packed int64 datetime
K_DUR = 8  # nanoseconds int


class Datum:
    __slots__ = ("kind", "val")

    def __init__(self, kind: int, val=None):
        self.kind = kind
        self.val = val

    # --- constructors -------------------------------------------------
    @staticmethod
    def null() -> "Datum":
        return Datum(K_NULL)

    @staticmethod
    def i(v: int) -> "Datum":
        return Datum(K_INT, int(v))

    @staticmethod
    def u(v: int) -> "Datum":
        return Datum(K_UINT, int(v))

    @staticmethod
    def f(v: float) -> "Datum":
        return Datum(K_FLOAT, float(v))

    @staticmethod
    def d(v: Dec) -> "Datum":
        return Datum(K_DEC, v)

    @staticmethod
    def s(v: str) -> "Datum":
        return Datum(K_STR, v)

    @staticmethod
    def b(v: bytes) -> "Datum":
        return Datum(K_BYTES, v)

    @staticmethod
    def t(packed: int) -> "Datum":
        return Datum(K_TIME, int(packed))

    # --- predicates ---------------------------------------------------
    @property
    def is_null(self) -> bool:
        return self.kind == K_NULL

    # --- conversions --------------------------------------------------
    def to_float(self) -> float:
        k = self.kind
        if k in (K_INT, K_UINT, K_TIME, K_DUR):
            return float(self.val)
        if k == K_FLOAT:
            return self.val
        if k == K_DEC:
            return self.val.to_float()
        if k in (K_STR, K_BYTES):
            s = self.val if isinstance(self.val, str) else self.val.decode("utf8", "replace")
            try:
                return float(s.strip() or 0)
            except ValueError:
                # MySQL parses the numeric prefix
                import re

                m = re.match(r"\s*[-+]?\d*\.?\d*(e[-+]?\d+)?", s, re.I)
                try:
                    return float(m.group(0)) if m and m.group(0).strip() else 0.0
                except ValueError:
                    return 0.0
        raise TypeError(f"cannot convert kind {k} to float")

    def to_dec(self) -> Dec:
        k = self.kind
        if k == K_DEC:
            return self.val
        if k in (K_INT, K_UINT):
            return Dec(self.val, 0)
        if k == K_FLOAT:
            return dec_from_float(self.val)
        if k in (K_STR, K_BYTES):
            s = self.val if isinstance(self.val, str) else self.val.decode("utf8", "replace")
            try:
                return dec_from_string(s)
            except ValueError:
                return Dec(0, 0)
        raise TypeError(f"cannot convert kind {k} to decimal")

    def to_int(self) -> int:
        k = self.kind
        if k in (K_INT, K_UINT, K_TIME, K_DUR):
            return self.val
        if k == K_FLOAT:
            # half away from zero, matching Dec.rescale (MySQL rounding)
            v = self.val
            return math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5)
        if k == K_DEC:
            return self.val.to_int()
        if k in (K_STR, K_BYTES):
            return self.to_dec().to_int()
        raise TypeError(f"cannot convert kind {k} to int")

    def to_str(self) -> str:
        k = self.kind
        if k == K_STR:
            return self.val
        if k == K_BYTES:
            return self.val.decode("utf8", "replace")
        if k == K_FLOAT:
            v = self.val
            return str(int(v)) if v == int(v) and abs(v) < 1e15 else repr(v)
        return str(self.val)

    def render(self, ft: FieldType | None = None) -> str | None:
        """Result-set rendering (what a MySQL client would display)."""
        if self.is_null:
            return None
        if self.kind == K_TIME:
            is_date = ft is not None and ft.tp == TypeCode.Date
            fsp = ft.decimal if ft is not None and ft.decimal > 0 else 0
            return format_time(self.val, is_date=is_date, fsp=fsp)
        if self.kind == K_DUR:
            us = int(self.val)
            sign = "-" if us < 0 else ""
            us = abs(us)
            h, rem = divmod(us // 1_000_000, 3600)
            m, s = divmod(rem, 60)
            out = f"{sign}{h:02d}:{m:02d}:{s:02d}"
            fsp = ft.decimal if ft is not None and ft.decimal > 0 else 0
            if fsp > 0:
                out = (out + f".{us % 1_000_000:06d}")[: len(out) + 1 + fsp]
            return out
        return self.to_str()

    def __repr__(self):
        if self.is_null:
            return "NULL"
        return f"{self.to_str()}"

    def __eq__(self, other):
        if not isinstance(other, Datum):
            return NotImplemented
        return compare_datum(self, other) == 0 if not (self.is_null or other.is_null) else self.kind == other.kind

    def __hash__(self):
        """Consistent with __eq__: equal datums hash equal.

        Python guarantees hash(int) == hash(float) == hash(Fraction) for
        equal numeric values, so numeric kinds hash their exact value;
        strings and bytes hash their text (eq compares them as text).
        """
        k = self.kind
        if k == K_NULL:
            return hash(None)
        if k == K_DEC:
            return hash(Fraction(self.val.value, pow10(self.val.scale)))
        if k == K_BYTES:
            return hash(self.val.decode("utf8", "replace"))
        return hash(self.val)


_STRINGY = (K_STR, K_BYTES)


def compare_datum(a: Datum, b: Datum) -> int:
    """SQL comparison; NULL sorts first (ref: types/datum.go Compare)."""
    if a.is_null or b.is_null:
        return (not a.is_null) - (not b.is_null)
    ka, kb = a.kind, b.kind
    if ka == kb and ka not in _STRINGY:
        if ka == K_DEC:
            return a.val.cmp(b.val)
        va, vb = a.val, b.val
        return (va > vb) - (va < vb)
    if ka in _STRINGY and kb in _STRINGY:
        # varchar vs binary compares as text (binary collation)
        va, vb = a.to_str(), b.to_str()
        return (va > vb) - (va < vb)
    # mixed numeric comparison through float (string side parses numeric prefix)
    fa, fb = a.to_float(), b.to_float()
    return (fa > fb) - (fa < fb)
