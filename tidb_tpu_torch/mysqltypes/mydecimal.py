"""Fixed-point decimal (copy of tidb_tpu/mysqltypes/mydecimal.py; ref:
types/mydecimal.go).

The reference stores decimals as 9-digit "words"; here a decimal is an
arbitrary-precision scaled integer `(value, scale)` meaning value * 10^-scale.
This representation is device-friendly: columns of decimals with a shared
column scale become plain int64 arrays on device, and SUM/COUNT/AVG partials
are exact integer reductions (`psum` over int64 lanes).

MySQL scale rules implemented here:
  add/sub : result scale = max(s1, s2)
  mul     : result scale = s1 + s2 (capped at 30)
  div     : result scale = s1 + 4 (DivFracIncr, capped at 30)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

MAX_SCALE = 30
DIV_FRAC_INCR = 4


@lru_cache(maxsize=None)
def pow10(n: int) -> int:
    return 10**n


@dataclass(frozen=True)
class Dec:
    value: int  # scaled integer
    scale: int  # fractional digits

    def rescale(self, scale: int) -> "Dec":
        if scale == self.scale:
            return self
        if scale > self.scale:
            return Dec(self.value * pow10(scale - self.scale), scale)
        # shrink with round-half-away-from-zero (MySQL rounding)
        p = pow10(self.scale - scale)
        v, r = divmod(abs(self.value), p)
        if r * 2 >= p:
            v += 1
        return Dec(v if self.value >= 0 else -v, scale)

    def __add__(self, o: "Dec") -> "Dec":
        s = max(self.scale, o.scale)
        return Dec(self.rescale(s).value + o.rescale(s).value, s)

    def __sub__(self, o: "Dec") -> "Dec":
        s = max(self.scale, o.scale)
        return Dec(self.rescale(s).value - o.rescale(s).value, s)

    def __mul__(self, o: "Dec") -> "Dec":
        s = self.scale + o.scale
        d = Dec(self.value * o.value, s)
        return d.rescale(MAX_SCALE) if s > MAX_SCALE else d

    def div(self, o: "Dec") -> "Dec | None":
        """Returns None on division by zero (SQL NULL)."""
        if o.value == 0:
            return None
        s = min(self.scale + DIV_FRAC_INCR, MAX_SCALE)
        # numerator scaled to s + o.scale so the quotient has scale s
        num = self.value * pow10(s + o.scale - self.scale)
        q, r = divmod(abs(num), abs(o.value))
        if r * 2 >= abs(o.value):
            q += 1
        if (num < 0) != (o.value < 0):
            q = -q
        return Dec(q, s)

    def neg(self) -> "Dec":
        return Dec(-self.value, self.scale)

    def cmp(self, o: "Dec") -> int:
        s = max(self.scale, o.scale)
        a, b = self.rescale(s).value, o.rescale(s).value
        return (a > b) - (a < b)

    def to_float(self) -> float:
        return self.value / pow10(self.scale)

    def to_int(self) -> int:
        """Round to integer (half away from zero)."""
        return self.rescale(0).value

    def is_zero(self) -> bool:
        return self.value == 0

    def __str__(self) -> str:
        if self.scale == 0:
            return str(self.value)
        sign = "-" if self.value < 0 else ""
        v = abs(self.value)
        ip, fp = divmod(v, pow10(self.scale))
        return f"{sign}{ip}.{fp:0{self.scale}d}"

    __repr__ = __str__


def dec_from_string(s: str) -> Dec:
    s = s.strip()
    exp = 0
    for e in ("e", "E"):
        if e in s:
            s, es = s.split(e, 1)
            exp = int(es)
            break
    neg = s.startswith("-")
    s = s.lstrip("+-")
    if "." in s:
        ip, fp = s.split(".", 1)
    else:
        ip, fp = s, ""
    digits = (ip + fp) or "0"
    v = int(digits)
    scale = len(fp) - exp
    if scale < 0:
        v *= pow10(-scale)
        scale = 0
    if scale > MAX_SCALE:
        return Dec(-v if neg else v, scale).rescale(MAX_SCALE)
    return Dec(-v if neg else v, scale)


def dec_from_int(v: int) -> Dec:
    return Dec(v, 0)


def dec_from_float(f: float, scale: int | None = None) -> Dec:
    if scale is None:
        return dec_from_string(repr(f))
    return Dec(round(f * pow10(scale)), scale)


def dec_round(d: Dec, frac: int) -> Dec:
    """ROUND(d, frac) — keeps at most `frac` fractional digits."""
    if frac >= d.scale:
        return d
    if frac < 0:
        r = d.rescale(0)
        p = pow10(-frac)
        v, rem = divmod(abs(r.value), p)
        if rem * 2 >= p:
            v += 1
        v *= p
        return Dec(v if r.value >= 0 else -v, 0)
    return d.rescale(frac)
