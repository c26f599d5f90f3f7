"""Builtin scalar functions of the port — the subset of
tidb_tpu/expr/builtins.py that the slice's DAGs and tests use (ref:
expression/builtin_*.go).

Each builtin is registered once with a type-inference rule and ONE generic
kernel over the array namespace `xp` (expression.NP on the host; the
device path compiles the same rules, expr/program.py). Registered here:

  * arithmetic: plus, minus, mul, unaryminus (int, decimal, float)
  * comparisons: eq, ne, lt, le, gt, ge, nulleq, in
  * 3-valued logic: and, or, not, isnull

A string or date constant compared with a date column goes through
expression.numeric_common (the string side parses as a datetime on the
host; the device path declines bare string constants). Any other function
name raises in expression.make_func when a DAG is built: nothing routes
to the host silently.
"""

from __future__ import annotations

import numpy as np

from ..mysqltypes.field_type import FieldType, ft_longlong, ft_double, ft_decimal
from ..mysqltypes.mydecimal import pow10
from .expression import (
    FuncSig,
    register,
    lane_as_float,
    lane_as_decimal,
    numeric_common,
    all_valid,
)


# ---------------------------------------------------------------------------
# type inference helpers
# ---------------------------------------------------------------------------


def _scale(ft: FieldType) -> int:
    return max(ft.decimal, 0) if ft.is_decimal() else 0


# Decimal lanes are scaled int64: ~18 significant digits total. Results
# needing a finer scale cannot be represented exactly in a lane, so
# arithmetic degrades to float64 instead of silently wrapping int64
# (the reference's 65-digit MyDecimal words don't have this cliff; our
# device-representable domain covers real workloads — TPC-H uses scale ≤ 4).
DEC_LANE_MAX_SCALE = 12


def infer_arith(op: str):
    def infer(fts):
        if any(ft.is_float() or ft.is_string() for ft in fts):
            return ft_double()
        if any(ft.is_decimal() for ft in fts):
            if op == "mul":
                s = sum(_scale(ft) for ft in fts)
            else:
                s = max(_scale(ft) for ft in fts)
            if s > DEC_LANE_MAX_SCALE:
                return ft_double()
            return ft_decimal(30, s)
        return ft_longlong()

    return infer


def infer_bool(fts):
    return ft_longlong()


# ---------------------------------------------------------------------------
# arithmetic kernels
# ---------------------------------------------------------------------------


def _arith_kernel(op: str):
    def kernel(xp, avals, fts, ret_ft):
        valid = all_valid(xp, avals)
        if ret_ft.is_float():
            a, b = (lane_as_float(xp, d, ft) for (d, _), ft in zip(avals, fts))
            data = {"plus": lambda: a + b, "minus": lambda: a - b, "mul": lambda: a * b}[op]()
        elif ret_ft.is_decimal():
            rs = _scale(ret_ft)
            if op == "mul":
                a = xp.astype(avals[0][0], xp.int64)
                b = xp.astype(avals[1][0], xp.int64)
                data = a * b  # product scale is s1+s2
                ps = _scale(fts[0]) + _scale(fts[1])
                if ps > rs:  # infer capped at MAX_SCALE: round down to rs
                    data = _round_div(xp, data, xp.full_like(data, pow10(ps - rs)))
            else:
                a, b = (lane_as_decimal(xp, d, ft, rs) for (d, _), ft in zip(avals, fts))
                data = a + b if op == "plus" else a - b
        else:
            a, b = (xp.astype(d, xp.int64) for d, _ in avals)
            data = {"plus": lambda: a + b, "minus": lambda: a - b, "mul": lambda: a * b}[op]()
        return data, valid

    return kernel


def _round_div(xp, num, den):
    """Exact integer division rounding half away from zero (den != 0 lanes)."""
    den_safe = xp.where(den == 0, 1, den)
    q = xp.abs(num) // xp.abs(den_safe)
    r = xp.abs(num) - q * xp.abs(den_safe)
    q = q + xp.astype(2 * r >= xp.abs(den_safe), xp.int64)
    sign = xp.where((num < 0) != (den_safe < 0), -1, 1)
    return q * sign


def _unary_minus_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    if ret_ft.is_float():
        return -lane_as_float(xp, d, fts[0]), v
    return -xp.astype(d, xp.int64), v


register(FuncSig("plus", infer_arith("plus"), _arith_kernel("plus"), arity=2))
register(FuncSig("minus", infer_arith("minus"), _arith_kernel("minus"), arity=2))
register(FuncSig("mul", infer_arith("mul"), _arith_kernel("mul"), arity=2))
register(FuncSig("unaryminus", infer_arith("plus"), _unary_minus_kernel, arity=1))


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _int2_cmp(op, a, b):
    """Lexicographic compare of (class, lo) pairs — exact across the full
    signed+unsigned BIGINT value range."""
    (ha, la), (hb, lb) = a, b
    eq = (ha == hb) & (la == lb)
    lt = (ha < hb) | ((ha == hb) & (la < lb))
    return {
        "eq": lambda: eq,
        "ne": lambda: ~eq,
        "lt": lambda: lt,
        "le": lambda: lt | eq,
        "gt": lambda: ~(lt | eq),
        "ge": lambda: ~lt,
    }[op]()


def _ci_weight1(a, fts):
    """Collation weights for one string lane when the operands' derived
    collation is case-insensitive (ref: expression/collation.go)."""
    from ..mysqltypes import collate as _coll

    c = _coll.resolve(fts)
    if _coll.is_ci(c):
        return _coll.weight_lane(np.atleast_1d(np.asarray(a, dtype=object)), c)
    return a


def _ci_weights(a, b, fts):
    return _ci_weight1(a, fts), _ci_weight1(b, fts)


def _cmp_kernel(op: str):
    def kernel(xp, avals, fts, ret_ft):
        valid = all_valid(xp, avals)
        kind, lanes = numeric_common(xp, avals, fts)
        a, b = lanes
        if kind == "int2":
            return xp.astype(_int2_cmp(op, a, b), xp.int64), valid
        if kind == "str":
            # numpy-only path; device compares dictionary codes instead
            a = np.where(avals[0][1], a, "")
            b = np.where(avals[1][1], b, "")
            a, b = _ci_weights(a, b, fts)
        data = {
            "eq": lambda: a == b,
            "ne": lambda: a != b,
            "lt": lambda: a < b,
            "le": lambda: a <= b,
            "gt": lambda: a > b,
            "ge": lambda: a >= b,
        }[op]()
        return xp.astype(data, xp.int64), valid

    return kernel


for _op in ("eq", "ne", "lt", "le", "gt", "ge"):
    register(FuncSig(_op, infer_bool, _cmp_kernel(_op), arity=2))


def _nulleq_kernel(xp, avals, fts, ret_ft):
    va, vb = avals[0][1], avals[1][1]
    kind, (a, b) = numeric_common(xp, avals, fts)
    if kind == "int2":
        same = _int2_cmp("eq", a, b)
    else:
        if kind == "str":
            a = np.where(va, a, "")
            b = np.where(vb, b, "")
            a, b = _ci_weights(a, b, fts)
        same = a == b
    eq = same & va & vb | (~va & ~vb)
    return xp.astype(eq, xp.int64), xp.ones_like(va)


register(FuncSig("nulleq", infer_bool, _nulleq_kernel, arity=2))  # <=>


def _in_kernel(xp, avals, fts, ret_ft):
    # IN over a value list: any-equal w/ SQL NULL semantics
    valid0 = avals[0][1]
    kind, lanes = numeric_common(xp, avals, fts)
    a = lanes[0]
    if kind == "str":
        a = np.where(valid0, a, "")
        a = _ci_weight1(a, fts)
    hit = None
    any_null = ~valid0
    for (d, v), lane in zip(avals[1:], lanes[1:]):
        if kind == "int2":
            e = _int2_cmp("eq", a, lane) & v
        else:
            if kind == "str":
                b = np.where(v, lane, "")
                b = _ci_weight1(b, fts)
            else:
                b = lane
            e = (a == b) & v
        hit = e if hit is None else (hit | e)
        any_null = any_null | ~v
    valid = valid0 & (hit | ~any_null)
    return xp.astype(hit, xp.int64), valid


register(FuncSig("in", infer_bool, _in_kernel, varargs=True, arity=(2, None)))


# ---------------------------------------------------------------------------
# 3-valued logic
# ---------------------------------------------------------------------------


def _logic_and(xp, avals, fts, ret_ft):
    (da, va), (db, vb) = avals
    ta, tb = da != 0, db != 0
    false_any = (va & ~ta) | (vb & ~tb)
    valid = (va & vb) | false_any
    return xp.astype(ta & tb & va & vb, xp.int64), valid


def _logic_or(xp, avals, fts, ret_ft):
    (da, va), (db, vb) = avals
    ta, tb = (da != 0) & va, (db != 0) & vb
    true_any = ta | tb
    valid = (va & vb) | true_any
    return xp.astype(true_any, xp.int64), valid


def _logic_not(xp, avals, fts, ret_ft):
    d, v = avals[0]
    return xp.astype(d == 0, xp.int64), v


register(FuncSig("and", infer_bool, _logic_and, arity=2))
register(FuncSig("or", infer_bool, _logic_or, arity=2))
register(FuncSig("not", infer_bool, _logic_not, arity=1))


def _isnull_kernel(xp, avals, fts, ret_ft):
    _, v = avals[0]
    return xp.astype(~v, xp.int64), xp.ones_like(v)


register(FuncSig("isnull", infer_bool, _isnull_kernel, arity=1))
