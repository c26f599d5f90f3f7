"""Collation weight strings (copy of tidb_tpu/mysqltypes/collate.py; ref:
util/collate/, expression/collation.go,
charset/collations generated tables — redesigned over Unicode
normalization instead of shipped weight tables).

A collation maps a string to a WEIGHT string such that binary comparison
of weights == collated comparison of the originals. Everything that
compares/sorts/groups strings (expression compare kernels, lexicographic
sorts, group-by factorization, join key encoding, the device
dict-encoder's sorted-vocab order) runs on weights when the column's
collation is case-insensitive, and on the raw bytes for binary
collations.

Weight sources:
 - *_unicode_ci: EXACT UCA 4.0.0 primary weights (uca400_weights.npz,
   derived from the public allkeys-4.0.0.txt — the table MySQL's
   utf8mb4_unicode_ci implements; ref: util/collate/unicode_ci.go
   semantics: ignorables drop, supplementary planes weigh 0xFFFD, PAD
   SPACE truncates trailing spaces).
 - *_general_ci: per-character NFD base letter, uppercased (accent- and
   case-insensitive for Latin; code-point order elsewhere). ß folds to S
   (matches MySQL general_ci's ß=s single-character behavior).
 - *_0900_ai_ci / *_unicode_520_ci: NFKD + casefold + combining-mark
   strip — UCA primary-strength approximation (those need UCA 9.0/5.2
   tables; documented gap).
"""

from __future__ import annotations

import os
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


_UCA400_EXACT = {"utf8mb4_unicode_ci", "utf8_unicode_ci"}
_uca400 = None


def _uca400_tables():
    global _uca400
    if _uca400 is None:
        path = os.path.join(os.path.dirname(__file__), "uca400_weights.npz")
        z = np.load(path)
        _uca400 = (z["offsets"], z["weights"])
    return _uca400


@lru_cache(maxsize=65536)
def _uca400_char(ch: str) -> str:
    cp = ord(ch)
    if cp > 0xFFFF:
        return "�"  # supplementary planes: single implicit weight
    offsets, weights = _uca400_tables()
    run = weights[offsets[cp]:offsets[cp + 1]]
    return "".join(chr(int(w)) for w in run)


def weight(s: str, coll: str) -> str:
    """Weight string for one value under `coll` (identity for binary)."""
    if coll in _GENERAL_CI:
        return "".join(_general_ci_char(ch) for ch in s)
    if coll in _UCA400_EXACT:
        # PAD SPACE: trailing spaces never distinguish values
        return "".join(_uca400_char(ch) for ch in s.rstrip(" "))
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
