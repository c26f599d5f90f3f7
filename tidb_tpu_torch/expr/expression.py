"""Scalar expression framework (copy of tidb_tpu/expr/expression.py; ref:
expression/expression.go).

The reference has per-row `Eval*` plus vectorized `VecEval*` twins over
chunk columns (expression.go:62-82) — ~279 builtin classes with generated
vector code. Here each builtin is ONE generic array kernel written against
an array namespace `xp`; the host evaluator passes NP (numpy plus
`astype`), so every cast in a kernel is written `xp.astype(x, dtype)`.
The reference also hands jax.numpy to the same kernels on its device
path (`eval_xp`). The port's device path compiles a tree instead
(expr/program.py), by the same rules, into one kernel launch.

Value representation per lane (matches chunk/tile):
  int/time/duration → int64, float → float64, decimal → int64 scaled by
  ret_type.decimal, strings → object (numpy only; device uses dict codes),
  booleans → int64 {0,1} with a validity mask (SQL three-valued logic).

Evaluation returns (data, valid) pairs; `valid` is the NOT-NULL mask.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..mysqltypes.field_type import FieldType, ft_longlong
from ..mysqltypes.datum import Datum, K_STR, K_BYTES
from ..mysqltypes.mydecimal import pow10
from ..chunk.chunk import Chunk, col_numpy_dtype, VARLEN


class _HostXP:
    """numpy as the host evaluator's array namespace, plus `astype`
    (numpy gained a module-level astype only in 2.0)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def astype(x, dtype):
        return np.asarray(x).astype(dtype)


NP = _HostXP()


def is_host(xp) -> bool:
    return xp is NP or xp is np


class Expression:
    ret_type: FieldType

    def eval(self, chunk: Chunk):
        """numpy vectorized evaluation → (data ndarray, valid ndarray)."""
        raise NotImplementedError

    def collect_columns(self, out: set):
        pass

    def pushable(self) -> bool:
        """May this expression be encoded into a pushdown DAG?

        (ref: expression/expr_to_pb.go CanExprsPushDown + blocklist)
        """
        return False

    def equal(self, other) -> bool:
        return repr(self) == repr(other)


@dataclass
class Column(Expression):
    """Offset-based reference into the input schema (ref: expression.Column)."""

    idx: int
    ret_type: FieldType = field(default_factory=ft_longlong)
    name: str = ""

    def eval(self, chunk: Chunk):
        col = chunk.columns[self.idx]
        return col.data, col.valid

    def collect_columns(self, out: set):
        out.add(self.idx)

    def pushable(self) -> bool:
        return True

    def __repr__(self):
        return f"col#{self.idx}" + (f"({self.name})" if self.name else "")


@dataclass
class Constant(Expression):
    value: Datum = field(default_factory=Datum.null)
    ret_type: FieldType = field(default_factory=ft_longlong)

    def eval(self, chunk: Chunk):
        n = chunk.num_rows
        if self.value.is_null:
            dt = col_numpy_dtype(self.ret_type)
            data = np.empty(n, dtype=object) if dt is VARLEN else np.zeros(n, dtype=dt)
            return data, np.zeros(n, dtype=bool)
        v = self.scalar_value()
        dt = col_numpy_dtype(self.ret_type)
        if dt is VARLEN:
            data = np.empty(n, dtype=object)
            data[:] = v
        else:
            if dt is np.int64 and isinstance(v, int) and v > np.iinfo(np.int64).max:
                dt = np.uint64  # np.full would silently wrap the literal
            data = np.full(n, v, dtype=dt)
        return data, np.ones(n, dtype=bool)

    def scalar_value(self):
        """The lane-representation scalar (scaled int for decimals, etc.)."""
        d, ft = self.value, self.ret_type
        if d.is_null:
            return None
        if ft.is_decimal():
            return d.to_dec().rescale(max(ft.decimal, 0)).value
        if ft.is_float():
            return d.to_float()
        if d.kind in (K_STR, K_BYTES):
            return d.val
        return d.to_int()

    def pushable(self) -> bool:
        return True

    def __repr__(self):
        return f"const({self.value!r})"


@dataclass
class ScalarFunc(Expression):
    sig: "FuncSig"
    args: list[Expression]
    ret_type: FieldType

    def eval(self, chunk: Chunk):
        avals = [a.eval(chunk) for a in self.args]
        return self.sig.kernel(NP, avals, [a.ret_type for a in self.args], self.ret_type)

    def collect_columns(self, out: set):
        for a in self.args:
            a.collect_columns(out)

    def pushable(self) -> bool:
        return self.sig.pushable and all(a.pushable() for a in self.args)

    def __repr__(self):
        return f"{self.sig.name}({', '.join(map(repr, self.args))})"


@dataclass
class FuncSig:
    """A builtin function: type inference + one generic array kernel."""

    name: str
    infer: Callable  # (arg_fts) -> ret FieldType
    kernel: Callable  # (xp, [(data,valid)...], arg_fts, ret_ft) -> (data, valid)
    pushable: bool = True
    varargs: bool = False
    arity: int | tuple | None = None  # int exact, (min, max|None) range, None unchecked
    post_infer: Callable | None = None  # (args, ret_ft) -> ret FieldType


# registry filled by builtins.py
FUNCS: dict[str, FuncSig] = {}


def register(sig: FuncSig):
    FUNCS[sig.name] = sig
    return sig


def make_func(name: str, *args: Expression) -> ScalarFunc:
    sig = FUNCS.get(name.lower())
    if sig is None:
        raise ValueError(f"unknown function {name}")
    n = len(args)
    ar = sig.arity
    if ar is not None:
        lo, hi = (ar, ar) if isinstance(ar, int) else ar
        if n < lo or (hi is not None and n > hi):
            raise ValueError(f"wrong number of arguments to {sig.name.upper()}: got {n}")
    ret = sig.infer([a.ret_type for a in args])
    if sig.post_infer is not None:
        ret = sig.post_infer(list(args), ret)
    return ScalarFunc(sig, list(args), ret)


def eval_expr_np(expr: Expression, chunk: Chunk):
    return expr.eval(chunk)


# ---------------------------------------------------------------------------
# shared coercion helpers used by kernels (work for numpy and jax.numpy)
# ---------------------------------------------------------------------------


def collation_key_lane(d, ft: FieldType | None):
    """Sort/group/join KEY form of a lane: weight strings when `ft` is a
    case-insensitive-collated string column, the lane itself otherwise
    (ref: util/collate — every comparison surface keys on weights)."""
    from ..mysqltypes import collate as _c

    if (
        ft is not None
        and ft.is_string()
        and _c.is_ci(getattr(ft, "collate", None))
        and getattr(d, "dtype", None) == object
    ):
        return _c.weight_lane(d, ft.collate)
    return d


def datum_sort_key(dat, ft: FieldType | None):
    """Collation-aware comparable for one string datum: (weight, raw) —
    weight orders, raw breaks ties deterministically (binary-min wins)."""
    from ..mysqltypes import collate as _c

    s = dat.val if isinstance(dat.val, str) else (
        bytes(dat.val).decode("latin-1") if isinstance(dat.val, (bytes, bytearray)) else str(dat.val)
    )
    if ft is not None and ft.is_string() and _c.is_ci(getattr(ft, "collate", None)):
        return (_c.weight(s, ft.collate), s)
    return (s, s)


def lane_as_float(xp, data, ft: FieldType):
    """Coerce a lane to float64 honoring decimal scale."""
    if ft.is_decimal():
        return xp.astype(data, xp.float64) / pow10(max(ft.decimal, 0))
    if ft.is_string() and is_host(xp):
        out = np.zeros(len(data), dtype=np.float64)
        for i, v in enumerate(data):
            if v is not None:
                out[i] = Datum.s(v if isinstance(v, str) else v.decode("utf8", "replace")).to_float()
        return out
    return xp.astype(data, xp.float64)


def lane_as_decimal(xp, data, ft: FieldType, target_scale: int):
    """Coerce int/decimal lane to a scaled-int lane at target_scale (exact)."""
    s = max(ft.decimal, 0) if ft.is_decimal() else 0
    if target_scale == s:
        return xp.astype(data, xp.int64)
    return xp.astype(data, xp.int64) * pow10(target_scale - s)


def _string_lane_as_time(data, valid):
    """Parse a string lane as packed datetimes (host only). Unparseable → 0."""
    from ..mysqltypes.coretime import parse_datetime

    out = np.zeros(len(data), dtype=np.int64)
    for i in np.nonzero(valid)[0]:
        s = data[i]
        p = parse_datetime(s if isinstance(s, str) else s.decode("utf8", "replace"))
        out[i] = p if p is not None else 0
    return out


def numeric_common(xp, avals, fts):
    """Coerce arg lanes to a common numeric domain for comparison/arith.

    Returns (kind, lanes) where kind is 'int' | 'dec:<scale>' | 'float' | 'str'.
    A time mixed with strings compares chronologically: the string side is
    parsed as a datetime (ref: expression/builtin_compare.go
    GetAccurateCmpType + RefineComparedConstant semantics).
    """
    if all(ft.is_string() for ft in fts):
        return "str", [d for d, _ in avals]
    if any(ft.is_time() for ft in fts) and all(ft.is_time() or ft.is_string() for ft in fts):
        lanes = [
            xp.astype(d, xp.int64) if ft.is_time() else _string_lane_as_time(d, v)
            for (d, v), ft in zip(avals, fts)
        ]
        return "int", lanes
    if any(ft.is_float() or ft.is_string() for ft in fts):
        return "float", [lane_as_float(xp, d, ft) for (d, _), ft in zip(avals, fts)]
    if any(ft.is_decimal() for ft in fts):
        scale = max(max(ft.decimal, 0) for ft in fts if ft.is_decimal())
        return f"dec:{scale}", [lane_as_decimal(xp, d, ft, scale) for (d, _), ft in zip(avals, fts)]
    lanes = [d for d, _ in avals]
    if any(str(getattr(l, "dtype", "")) == "uint64" for l in lanes):
        if all(str(getattr(l, "dtype", "")) == "uint64" for l in lanes):
            return "uint", lanes
        # mixed signed/unsigned BIGINT: value-correct without widening
        # (ref: expression/builtin_compare.go CompareInt's sign-aware
        # branches). Each value maps to a lexicographic (class, lo) pair:
        #   class -1: negative signed            lo = x
        #   class  0: [0, 2^63) from either side lo = value
        #   class +1: unsigned >= 2^63           lo = u - 2^64 (monotone)
        # int64 wrap of the high uint half is order-preserving per class.
        return "int2", [int2_pair(xp, l) for l in lanes]
    return "int", [xp.astype(l, xp.int64) for l in lanes]


def int2_pair(xp, lane):
    """(class, lo) encoding for exact mixed signed/unsigned comparison."""
    if str(lane.dtype) == "uint64":
        hi = xp.astype(lane > xp.asarray(np.iinfo(np.int64).max, dtype=lane.dtype), xp.int64)
        return hi, xp.astype(lane, xp.int64)
    lo = xp.astype(lane, xp.int64)
    return -xp.astype(lo < 0, xp.int64), lo


def int2_as_float(xp, pair):
    """Approximate scalar value of an int2 pair (for arithmetic domains
    where exactness above 2^53 is not contractual)."""
    hi, lo = pair
    return xp.astype(lo, xp.float64) + (hi == 1) * np.float64(2.0**64)


def all_valid(xp, avals):
    v = avals[0][1]
    for _, vv in avals[1:]:
        v = v & vv
    return v
