"""Collation weight strings (ref: tidb_tpu/mysqltypes/collate.py, trimmed).

A collation maps a string to a WEIGHT string such that binary comparison
of weights == collated comparison of the originals. The port's host paths
(group-by factorization, min/max over strings, compare kernels) and the
dict encoder's sorted-vocab order run on weights under a case-insensitive
collation, and on the raw values under a binary one.

Ported: the binary collations, *_general_ci (per-character NFD base
letter, uppercased) and the NFKD + casefold approximation the reference
uses for *_0900_ai_ci / *_unicode_520_ci. Not ported: the exact UCA 4.0.0
table behind utf8mb4_unicode_ci / utf8_unicode_ci, which raises
NotPortedError.
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache

import numpy as np

_GENERAL_CI = {
    "utf8mb4_general_ci", "utf8_general_ci", "latin1_swedish_ci", "latin1_general_ci",
    "ascii_general_ci",
}
_UNICODE_CI = {
    "utf8mb4_unicode_ci", "utf8_unicode_ci", "utf8mb4_0900_ai_ci", "utf8mb4_unicode_520_ci",
}
_UCA400_EXACT = {"utf8mb4_unicode_ci", "utf8_unicode_ci"}
_BIN = {"binary", "utf8mb4_bin", "utf8_bin", "latin1_bin", "ascii_bin", "utf8mb4_0900_bin"}

SUPPORTED = _GENERAL_CI | _UNICODE_CI | _BIN

DEFAULT = "utf8mb4_bin"


def is_ci(coll: str | None) -> bool:
    return bool(coll) and coll in (_GENERAL_CI | _UNICODE_CI)


def is_supported(coll: str) -> bool:
    return coll in SUPPORTED


@lru_cache(maxsize=65536)
def _general_ci_char(ch: str) -> str:
    d = unicodedata.normalize("NFD", ch)
    base = "".join(c for c in d if not unicodedata.combining(c)) or d
    u = base.upper()
    return u[0] if u else ch


def weight(s: str, coll: str) -> str:
    """Weight string for one value under `coll` (identity for binary)."""
    if coll in _GENERAL_CI:
        return "".join(_general_ci_char(ch) for ch in s)
    if coll in _UCA400_EXACT:
        from ..errors import NotPortedError

        raise NotPortedError("mysqltypes/collate.py UCA 4.0.0 weights", coll)
    if coll in _UNICODE_CI:
        d = unicodedata.normalize("NFKD", s.casefold())
        return "".join(c for c in d if not unicodedata.combining(c))
    return s


def weight_lane(d: np.ndarray, coll: str) -> np.ndarray:
    """Object lane → weight-string lane (same array when binary). Cached
    per distinct value; bytes entries decode latin-1 like the rest of the
    engine's mixed-lane handling."""
    if not is_ci(coll):
        return d
    out = np.empty(len(d), dtype=object)
    cache: dict = {}
    for i, s in enumerate(d):
        w = cache.get(s)
        if w is None:
            if isinstance(s, (bytes, bytearray)):
                w = weight(bytes(s).decode("latin-1"), coll)
            elif isinstance(s, str):
                w = weight(s, coll)
            else:
                w = s  # non-string residue (NULL fill values): pass through
            cache[s] = w
        out[i] = w
    return out


def resolve(fts) -> str:
    """Collation for a comparison across operand types — the first
    case-insensitive string collation wins (the coercibility ladder
    collapsed: columns beat literals, which carry the default bin)."""
    for ft in fts:
        if ft is not None and ft.is_string() and is_ci(getattr(ft, "collate", None)):
            return ft.collate
    return DEFAULT
