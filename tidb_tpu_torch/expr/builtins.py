"""Builtin scalar functions of the port (copy of tidb_tpu/expr/builtins.py
and its three extensions; ref: expression/builtin_*.go, ~279 classes).

Each builtin is registered once with a type-inference rule and ONE generic
kernel over the array namespace `xp`: the host evaluator passes
expression.NP. The registry is the reference's, name for name, with the
same `pushable`, `arity`, `varargs`, `infer` and `post_infer`: arithmetic,
comparison, 3-valued logic, control flow, rounding/math, date extraction,
string basics and casts here; date arithmetic, string/math breadth and
JSON in builtins_ext; crypto, regexp, network, bit operators and the
temporal tail in builtins_ext2; JSON modification and the session-info
functions in builtins_ext3.

The host runs every builtin through its kernel below. The device path
(expr/program.py) compiles the pushable ones (pushable=True) by the same
rules as the reference's device runs these kernels over jax.numpy under
jit; a host-only builtin (pushable=False) or a cast to a string type
raises DeviceFatalError when a DAG is lowered, as the reference's device
raises on them. String kernels are host-only except equality/compare,
which the device engine handles via dictionary codes.
"""

from __future__ import annotations

import math
import re

import numpy as np

from ..errors import TiDBError as TiDBErrorBase
from ..mysqltypes.field_type import FieldType, TypeCode, ft_longlong, ft_double, ft_decimal, ft_varchar, UNSIGNED_FLAG
from ..mysqltypes.mydecimal import pow10, MAX_SCALE, DIV_FRAC_INCR
from .expression import (
    FuncSig,
    register,
    lane_as_float,
    lane_as_decimal,
    numeric_common,
    int2_as_float,
    all_valid,
    is_host,
)

_US = 1_000_000


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


def _div_frac_incr() -> int:
    """Division scale growth — div_precision_increment when a session is
    active (ref: expression/builtin_arithmetic.go deriveDivisionScale)."""
    from . import sessioninfo

    try:
        return int((sessioninfo.get("vars") or {}).get("div_precision_increment", DIV_FRAC_INCR))
    except (TypeError, ValueError):
        return DIV_FRAC_INCR


def infer_div(fts):
    if any(ft.is_float() or ft.is_string() for ft in fts):
        return ft_double()
    s = max((_scale(ft) for ft in fts), default=0) + _div_frac_incr()
    if s > DEC_LANE_MAX_SCALE:
        return ft_double()
    return ft_decimal(30, s)


def infer_bool(fts):
    return ft_longlong()


def infer_first(fts):
    return fts[0].clone()


def merge_types(fts: list[FieldType]) -> FieldType:
    """Result type of CASE/IF/COALESCE branches (ref: types/field_type.go MergeFieldType)."""
    fts = [ft for ft in fts if ft.tp != TypeCode.Null]
    if not fts:
        return ft_varchar()
    if all(ft.is_string() for ft in fts):
        return ft_varchar(max(ft.flen for ft in fts))
    if all(ft.is_time() for ft in fts):
        return fts[0].clone()
    if any(ft.is_string() or ft.is_float() or ft.is_time() for ft in fts):
        return ft_double()
    if any(ft.is_decimal() for ft in fts):
        return ft_decimal(30, max(_scale(ft) for ft in fts))
    # unsignedness survives only when every branch is unsigned (MySQL
    # MergeFieldType flag semantics)
    return ft_longlong(unsigned=all(ft.is_unsigned for ft in fts))


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
                a = avals[0][0].astype(xp.int64)
                b = avals[1][0].astype(xp.int64)
                data = a * b  # product scale is s1+s2
                ps = _scale(fts[0]) + _scale(fts[1])
                if ps > rs:  # infer capped at MAX_SCALE: round down to rs
                    data = _round_div(xp, data, xp.full_like(data, pow10(ps - rs)))
            else:
                a, b = (lane_as_decimal(xp, d, ft, rs) for (d, _), ft in zip(avals, fts))
                data = a + b if op == "plus" else a - b
        else:
            a, b = (d.astype(xp.int64) for d, _ in avals)
            data = {"plus": lambda: a + b, "minus": lambda: a - b, "mul": lambda: a * b}[op]()
        return data, valid

    return kernel


def _round_div(xp, num, den):
    """Exact integer division rounding half away from zero (den != 0 lanes)."""
    den_safe = xp.where(den == 0, 1, den)
    q = xp.abs(num) // xp.abs(den_safe)
    r = xp.abs(num) - q * xp.abs(den_safe)
    q = q + (2 * r >= xp.abs(den_safe)).astype(xp.int64)
    sign = xp.where((num < 0) != (den_safe < 0), -1, 1)
    return q * sign


def _div_kernel(xp, avals, fts, ret_ft):
    valid = all_valid(xp, avals)
    if ret_ft.is_float():
        a, b = (lane_as_float(xp, d, ft) for (d, _), ft in zip(avals, fts))
        valid = valid & (b != 0)
        return a / xp.where(b == 0, 1.0, b), valid
    rs = _scale(ret_ft)
    s1, s2 = _scale(fts[0]), _scale(fts[1])
    num = avals[0][0].astype(xp.int64) * pow10(rs - s1 + s2)
    den = avals[1][0].astype(xp.int64)
    valid = valid & (den != 0)
    return _round_div(xp, num, den), valid


def _intdiv_kernel(xp, avals, fts, ret_ft):
    valid = all_valid(xp, avals)
    kind, (a, b) = numeric_common(xp, avals, fts)
    if kind == "int2":  # mixed sign domain: float64 approximation
        a, b = int2_as_float(xp, a), int2_as_float(xp, b)
        kind = "float"
    if kind == "float":
        valid = valid & (b != 0)
        q = a / xp.where(b == 0, 1.0, b)
        return xp.trunc(q).astype(xp.int64), valid
    valid = valid & (b != 0)
    bs = xp.where(b == 0, 1, b)
    q = a // bs
    # python/numpy floor-div → truncate toward zero like MySQL DIV
    q = xp.where((q < 0) & (q * bs != a), q + 1, q)
    return q.astype(xp.int64), valid


def _mod_kernel(xp, avals, fts, ret_ft):
    valid = all_valid(xp, avals)
    if ret_ft.is_float():
        a, b = (lane_as_float(xp, d, ft) for (d, _), ft in zip(avals, fts))
        valid = valid & (b != 0)
        bs = xp.where(b == 0, 1.0, b)
        r = a - xp.trunc(a / bs) * bs
        return r, valid
    rs = _scale(ret_ft)
    a, b = (lane_as_decimal(xp, d, ft, rs) for (d, _), ft in zip(avals, fts))
    valid = valid & (b != 0)
    bs = xp.where(b == 0, 1, b)
    q = a // bs
    q = xp.where((q < 0) & (q * bs != a), q + 1, q)  # trunc toward zero
    return a - q * bs, valid


def _unary_minus_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    if ret_ft.is_float():
        return -lane_as_float(xp, d, fts[0]), v
    return -d.astype(xp.int64), v


register(FuncSig("plus", infer_arith("plus"), _arith_kernel("plus"), arity=2))
register(FuncSig("minus", infer_arith("minus"), _arith_kernel("minus"), arity=2))
register(FuncSig("mul", infer_arith("mul"), _arith_kernel("mul"), arity=2))
register(FuncSig("div", infer_div, _div_kernel, arity=2))
register(FuncSig("intdiv", lambda fts: ft_longlong(), _intdiv_kernel, arity=2))
register(FuncSig("mod", infer_arith("plus"), _mod_kernel, arity=2))
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
            return _int2_cmp(op, a, b).astype(xp.int64), valid
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
        return data.astype(xp.int64), valid

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
    return eq.astype(xp.int64), xp.ones_like(va)


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
    return hit.astype(xp.int64), valid


register(FuncSig("in", infer_bool, _in_kernel, varargs=True, arity=(2, None)))


# ---------------------------------------------------------------------------
# 3-valued logic
# ---------------------------------------------------------------------------


def _logic_and(xp, avals, fts, ret_ft):
    (da, va), (db, vb) = avals
    ta, tb = da != 0, db != 0
    false_any = (va & ~ta) | (vb & ~tb)
    valid = (va & vb) | false_any
    return (ta & tb & va & vb).astype(xp.int64), valid


def _logic_or(xp, avals, fts, ret_ft):
    (da, va), (db, vb) = avals
    ta, tb = (da != 0) & va, (db != 0) & vb
    true_any = ta | tb
    valid = (va & vb) | true_any
    return true_any.astype(xp.int64), valid


def _logic_xor(xp, avals, fts, ret_ft):
    (da, va), (db, vb) = avals
    return ((da != 0) != (db != 0)).astype(xp.int64), va & vb


def _logic_not(xp, avals, fts, ret_ft):
    d, v = avals[0]
    return (d == 0).astype(xp.int64), v


register(FuncSig("and", infer_bool, _logic_and, arity=2))
register(FuncSig("or", infer_bool, _logic_or, arity=2))
register(FuncSig("xor", infer_bool, _logic_xor, arity=2))
register(FuncSig("not", infer_bool, _logic_not, arity=1))


def _isnull_kernel(xp, avals, fts, ret_ft):
    _, v = avals[0]
    return (~v).astype(xp.int64), xp.ones_like(v)


def _istrue_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    return ((d != 0) & v).astype(xp.int64), xp.ones_like(v)


def _isfalse_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    return ((d == 0) & v).astype(xp.int64), xp.ones_like(v)


register(FuncSig("isnull", infer_bool, _isnull_kernel, arity=1))
register(FuncSig("istrue", infer_bool, _istrue_kernel, arity=1))
register(FuncSig("isfalse", infer_bool, _isfalse_kernel, arity=1))


# ---------------------------------------------------------------------------
# control flow: IF / IFNULL / COALESCE / CASE
# ---------------------------------------------------------------------------


def _coerce_to(xp, aval, ft: FieldType, ret_ft: FieldType):
    """Coerce a branch lane to the merged result type."""
    d, v = aval
    if ret_ft.is_float():
        return lane_as_float(xp, d, ft), v
    if ret_ft.is_decimal():
        return lane_as_decimal(xp, d, ft, _scale(ret_ft)), v
    if ret_ft.is_string():
        return d, v
    return d.astype(xp.int64), v


def _if_kernel(xp, avals, fts, ret_ft):
    (dc, vc) = avals[0]
    cond = (dc != 0) & vc
    (a, va) = _coerce_to(xp, avals[1], fts[1], ret_ft)
    (b, vb) = _coerce_to(xp, avals[2], fts[2], ret_ft)
    if ret_ft.is_string() and is_host(xp):
        data = np.where(cond, a, b)
    else:
        data = xp.where(cond, a, b)
    return data, xp.where(cond, va, vb)


def _ifnull_kernel(xp, avals, fts, ret_ft):
    (a, va) = _coerce_to(xp, avals[0], fts[0], ret_ft)
    (b, vb) = _coerce_to(xp, avals[1], fts[1], ret_ft)
    data = xp.where(va, a, b)
    return data, va | vb


def _coalesce_kernel(xp, avals, fts, ret_ft):
    lanes = [_coerce_to(xp, av, ft, ret_ft) for av, ft in zip(avals, fts)]
    data, valid = lanes[-1]
    for a, va in reversed(lanes[:-1]):
        data = xp.where(va, a, data)
        valid = va | valid
    return data, valid


def _case_kernel(xp, avals, fts, ret_ft):
    """case(when1, then1, when2, then2, ..., [else]) — pre-desugared."""
    npairs = len(avals) // 2
    has_else = len(avals) % 2 == 1
    if has_else:
        data, valid = _coerce_to(xp, avals[-1], fts[-1], ret_ft)
    else:
        d0, v0 = _coerce_to(xp, avals[1], fts[1], ret_ft)
        data, valid = xp.zeros_like(d0), xp.zeros_like(v0)
    for i in reversed(range(npairs)):
        dc, vc = avals[2 * i]
        cond = (dc != 0) & vc
        dt, vt = _coerce_to(xp, avals[2 * i + 1], fts[2 * i + 1], ret_ft)
        data = xp.where(cond, dt, data)
        valid = xp.where(cond, vt, valid)
    return data, valid


def _infer_if(fts):
    return merge_types(fts[1:])


def _infer_case(fts):
    np_ = len(fts) // 2
    branches = [fts[2 * i + 1] for i in range(np_)]
    if len(fts) % 2:
        branches.append(fts[-1])
    return merge_types(branches)


register(FuncSig("if", _infer_if, _if_kernel, arity=3))
register(FuncSig("ifnull", lambda fts: merge_types(fts), _ifnull_kernel, arity=2))
register(FuncSig("coalesce", lambda fts: merge_types(fts), _coalesce_kernel, varargs=True, arity=(1, None)))
register(FuncSig("case", _infer_case, _case_kernel, varargs=True, arity=(2, None)))


# ---------------------------------------------------------------------------
# math / rounding
# ---------------------------------------------------------------------------


def _abs_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    return xp.abs(d), v


def _f1(fn, domain=None):
    def kernel(xp, avals, fts, ret_ft):
        d, v = avals[0]
        x = lane_as_float(xp, d, fts[0])
        if domain is not None:
            ok = domain(xp, x)
            v = v & ok
            x = xp.where(ok, x, 1.0)
        return getattr(xp, fn)(x), v

    return kernel


def _ceil_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    ft = fts[0]
    if ft.is_float():
        return xp.ceil(d.astype(xp.float64)), v
    if ft.is_decimal():
        s = pow10(_scale(ft))
        return -((-d.astype(xp.int64)) // s), v
    return d.astype(xp.int64), v


def _floor_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    ft = fts[0]
    if ft.is_float():
        return xp.floor(d.astype(xp.float64)), v
    if ft.is_decimal():
        return d.astype(xp.int64) // pow10(_scale(ft)), v
    return d.astype(xp.int64), v


def _const_frac(avals):
    """Scalar frac from the (guaranteed-constant) second arg lane."""
    fd = avals[1][0]
    return int(fd[0]) if getattr(fd, "ndim", 0) else int(fd)


def _round_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    ft = fts[0]
    if ret_ft.is_float():
        # float path supports per-row (non-constant) frac
        x = lane_as_float(xp, d, ft)
        if len(avals) > 1:
            p = 10.0 ** avals[1][0].astype(xp.float64)
            v = v & avals[1][1]
        else:
            p = 1.0
        scaled = x * p
        r = xp.where(scaled >= 0, xp.floor(scaled + 0.5), xp.ceil(scaled - 0.5))
        return r / p, v
    # int/decimal paths require constant frac (enforced by post_infer)
    frac = _const_frac(avals) if len(avals) > 1 else 0
    if not ft.is_decimal():  # int input
        x = d.astype(xp.int64)
        if frac >= 0:
            return x, v
        p = pow10(-frac)
        return _round_div(xp, x, xp.full_like(x, p)) * p, v
    s = _scale(ft)
    x = d.astype(xp.int64)
    if frac >= s:  # no-op numerically; ret scale == s
        return x, v
    p = pow10(s - frac)  # frac may be negative: rounds past the point
    q = _round_div(xp, x, xp.full_like(x, p))
    if frac < 0:
        q = q * pow10(-frac)  # result has scale 0
    return q, v


def _infer_round(fts):
    ft = fts[0]
    if ft.is_float() or ft.is_string():
        return ft_double()
    if ft.is_decimal():
        return ft_decimal(30, _scale(ft))  # post_infer narrows using const frac
    return ft_longlong()


def _round_post_infer(args, ret_ft):
    """Narrow the decimal result scale once the const frac arg is known.

    Non-constant frac is only supported on the float path (the lane kernel
    needs a static scale for int/decimal inputs).
    """
    from .expression import Constant

    if not ret_ft.is_decimal():
        return ret_ft
    s = _scale(args[0].ret_type)
    frac = 0
    if len(args) > 1:
        if not isinstance(args[1], Constant):
            return ft_double()  # dynamic frac: degrade to the float path
        frac = args[1].value.to_int()
    return ft_decimal(30, min(max(frac, 0), s))


register(FuncSig("abs", infer_first, _abs_kernel, arity=1))
register(FuncSig("round", _infer_round, _round_kernel, arity=(1, 2), post_infer=_round_post_infer))


def _truncate_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    ft = fts[0]
    if ret_ft.is_float():
        x = lane_as_float(xp, d, ft)
        p = 10.0 ** avals[1][0].astype(xp.float64)
        v = v & avals[1][1]
        return xp.trunc(x * p) / p, v
    frac = _const_frac(avals)
    if not ft.is_decimal():
        x = d.astype(xp.int64)
        if frac >= 0:
            return x, v
        p = pow10(-frac)
        return (xp.sign(x) * (xp.abs(x) // p)) * p, v
    s = _scale(ft)
    x = d.astype(xp.int64)
    if frac >= s:
        return x, v
    p = pow10(s - frac)
    q = xp.sign(x) * (xp.abs(x) // p)
    if frac < 0:
        q = q * pow10(-frac)
    return q, v


register(FuncSig("truncate", _infer_round, _truncate_kernel, arity=2, post_infer=_round_post_infer))
register(FuncSig("ceil", lambda fts: ft_longlong() if not fts[0].is_float() else ft_double(), _ceil_kernel, arity=1))
register(FuncSig("ceiling", lambda fts: ft_longlong() if not fts[0].is_float() else ft_double(), _ceil_kernel, arity=1))
register(FuncSig("floor", lambda fts: ft_longlong() if not fts[0].is_float() else ft_double(), _floor_kernel, arity=1))
register(FuncSig("sqrt", lambda fts: ft_double(), _f1("sqrt", domain=lambda xp, x: x >= 0), arity=1))
register(FuncSig("exp", lambda fts: ft_double(), _f1("exp"), arity=1))
register(FuncSig("ln", lambda fts: ft_double(), _f1("log", domain=lambda xp, x: x > 0), arity=1))
register(FuncSig("log", lambda fts: ft_double(), _f1("log", domain=lambda xp, x: x > 0), arity=1))
register(FuncSig("log2", lambda fts: ft_double(), _f1("log2", domain=lambda xp, x: x > 0), arity=1))
register(FuncSig("log10", lambda fts: ft_double(), _f1("log10", domain=lambda xp, x: x > 0), arity=1))
register(FuncSig("sin", lambda fts: ft_double(), _f1("sin"), arity=1))
register(FuncSig("cos", lambda fts: ft_double(), _f1("cos"), arity=1))
register(FuncSig("tan", lambda fts: ft_double(), _f1("tan"), arity=1))
register(FuncSig("sign", lambda fts: ft_longlong(), lambda xp, a, f, r: (xp.sign(lane_as_float(xp, a[0][0], f[0])).astype(xp.int64), a[0][1]), arity=1))


def _pow_kernel(xp, avals, fts, ret_ft):
    a = lane_as_float(xp, avals[0][0], fts[0])
    b = lane_as_float(xp, avals[1][0], fts[1])
    return xp.power(a, b), all_valid(xp, avals)


register(FuncSig("pow", lambda fts: ft_double(), _pow_kernel, arity=2))
register(FuncSig("power", lambda fts: ft_double(), _pow_kernel, arity=2))


def _minmax_lanes(xp, avals, fts):
    kind, lanes = numeric_common(xp, avals, fts)
    if kind == "int2":
        lanes = [int2_as_float(xp, p) for p in lanes]
    if kind == "str":
        # mask NULL slots so object-lane comparison never sees None
        lanes = [np.where(v, l, "") for (_, v), l in zip(avals, lanes)]
    return lanes


def _greatest_kernel(xp, avals, fts, ret_ft):
    valid = all_valid(xp, avals)
    lanes = _minmax_lanes(xp, avals, fts)
    data = lanes[0]
    for l in lanes[1:]:
        data = xp.maximum(data, l)
    return _coerce_greatest(xp, data, ret_ft), valid


def _least_kernel(xp, avals, fts, ret_ft):
    valid = all_valid(xp, avals)
    lanes = _minmax_lanes(xp, avals, fts)
    data = lanes[0]
    for l in lanes[1:]:
        data = xp.minimum(data, l)
    return _coerce_greatest(xp, data, ret_ft), valid


def _coerce_greatest(xp, data, ret_ft):
    if ret_ft.is_float():
        return data.astype(xp.float64)
    return data


register(FuncSig("greatest", lambda fts: merge_types(fts), _greatest_kernel, varargs=True, arity=(2, None)))
register(FuncSig("least", lambda fts: merge_types(fts), _least_kernel, varargs=True, arity=(2, None)))


# ---------------------------------------------------------------------------
# date/time extraction over packed int64 (chronological-order packing)
# ---------------------------------------------------------------------------


def _time_extract(divisor: int, modulus: int | None):
    def kernel(xp, avals, fts, ret_ft):
        d, v = avals[0]
        x = d.astype(xp.int64) // divisor
        if modulus is not None:
            x = x % modulus
        return x, v

    return kernel


from ..mysqltypes import coretime as _ct

register(FuncSig("year", lambda fts: ft_longlong(), _time_extract(_ct.DIV_YEAR, None), arity=1))
register(FuncSig("month", lambda fts: ft_longlong(), _time_extract(_ct.DIV_MONTH, _ct.MOD_MONTH), arity=1))
register(FuncSig("day", lambda fts: ft_longlong(), _time_extract(_ct.DIV_DAY, _ct.MOD_DAY), arity=1))
register(FuncSig("dayofmonth", lambda fts: ft_longlong(), _time_extract(_ct.DIV_DAY, _ct.MOD_DAY), arity=1))
register(FuncSig("hour", lambda fts: ft_longlong(), _time_extract(_ct.DIV_HOUR, _ct.MOD_HOUR), arity=1))
register(FuncSig("minute", lambda fts: ft_longlong(), _time_extract(_ct.DIV_MINUTE, _ct.MOD_MINUTE), arity=1))
register(FuncSig("second", lambda fts: ft_longlong(), _time_extract(_ct.DIV_SECOND, _ct.MOD_SECOND), arity=1))
register(FuncSig("microsecond", lambda fts: ft_longlong(), _time_extract(1, _ct.MOD_MICRO), arity=1))


# ---------------------------------------------------------------------------
# strings (host-only kernels; device handles eq/cmp via dict codes)
# ---------------------------------------------------------------------------


def _obj_map(fn):
    """Lift a python scalar function over object lanes (numpy host only)."""

    def kernel(xp, avals, fts, ret_ft):
        assert is_host(xp), "string kernel is host-only"
        valid = all_valid(np, avals)
        n = len(avals[0][0])
        out = np.empty(n, dtype=object)
        idx = np.nonzero(valid)[0]
        if valid.ndim == 0:
            valid = np.asarray([bool(valid)])
        else:
            valid = valid.copy()
        args_data = [d for d, _ in avals]
        for i in idx:
            try:
                out[i] = fn(*[d[i] for d in args_data])
            except TiDBErrorBase:
                raise
            except Exception:  # noqa: BLE001 — malformed input → SQL NULL
                valid[i] = False
        return out, valid

    return kernel


def _as_str(v):
    return v if isinstance(v, str) else (v.decode("utf8", "replace") if isinstance(v, (bytes, bytearray)) else str(v))


register(FuncSig("concat", lambda fts: ft_varchar(), _obj_map(lambda *xs: "".join(_as_str(x) for x in xs)), pushable=False, varargs=True))
register(FuncSig("lower", lambda fts: ft_varchar(), _obj_map(lambda x: _as_str(x).lower()), pushable=False, arity=1))
register(FuncSig("upper", lambda fts: ft_varchar(), _obj_map(lambda x: _as_str(x).upper()), pushable=False, arity=1))
register(FuncSig("trim", lambda fts: ft_varchar(), _obj_map(lambda x: _as_str(x).strip()), pushable=False, arity=1))
register(FuncSig("ltrim", lambda fts: ft_varchar(), _obj_map(lambda x: _as_str(x).lstrip()), pushable=False, arity=1))
register(FuncSig("rtrim", lambda fts: ft_varchar(), _obj_map(lambda x: _as_str(x).rstrip()), pushable=False, arity=1))
register(FuncSig("reverse", lambda fts: ft_varchar(), _obj_map(lambda x: _as_str(x)[::-1]), pushable=False, arity=1))


def _length_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    out = np.zeros(len(d), dtype=np.int64)
    for i in np.nonzero(v)[0]:
        s = d[i]
        out[i] = len(s.encode("utf8")) if isinstance(s, str) else len(s)
    return out, v


def _char_length_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    out = np.zeros(len(d), dtype=np.int64)
    for i in np.nonzero(v)[0]:
        out[i] = len(_as_str(d[i]))
    return out, v


register(FuncSig("length", lambda fts: ft_longlong(), _length_kernel, pushable=False, arity=1))
register(FuncSig("char_length", lambda fts: ft_longlong(), _char_length_kernel, pushable=False, arity=1))


def _substr(s, pos, ln=None):
    s = _as_str(s)
    pos = int(pos)
    if pos == 0:
        return ""
    start = pos - 1 if pos > 0 else len(s) + pos
    if start < 0:
        return ""
    end = len(s) if ln is None else start + max(int(ln), 0)
    return s[start:end]


register(FuncSig("substr", lambda fts: ft_varchar(), _obj_map(_substr), pushable=False, varargs=True, arity=(2, 3)))
register(FuncSig("substring", lambda fts: ft_varchar(), _obj_map(_substr), pushable=False, varargs=True, arity=(2, 3)))
register(FuncSig("left", lambda fts: ft_varchar(), _obj_map(lambda s, n: _as_str(s)[: max(int(n), 0)]), pushable=False))
register(FuncSig("right", lambda fts: ft_varchar(), _obj_map(lambda s, n: _as_str(s)[-max(int(n), 0) :] if int(n) > 0 else ""), pushable=False))
register(FuncSig("replace", lambda fts: ft_varchar(), _obj_map(lambda s, a, b: _as_str(s).replace(_as_str(a), _as_str(b))), pushable=False, varargs=True))


def like_to_regex(pat: str, escape: str = "\\") -> re.Pattern:
    out = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if c == escape and i + 1 < len(pat):
            out.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.S | re.I)


def _like_kernel(xp, avals, fts, ret_ft):
    (d, v), (pd, pv) = avals[0], avals[1]
    valid = v & pv
    out = np.zeros(len(d), dtype=np.int64)
    idx = np.nonzero(valid)[0]
    if len(idx):
        # pattern is near-always constant; compile per distinct pattern
        cache: dict = {}
        for i in idx:
            pat = _as_str(pd[i])
            rx = cache.get(pat)
            if rx is None:
                rx = cache[pat] = like_to_regex(pat)
            out[i] = 1 if rx.match(_as_str(d[i])) else 0
    return out, valid


register(FuncSig("like", infer_bool, _like_kernel, pushable=False, arity=2))


# ---------------------------------------------------------------------------
# casts — one sig per target family (ref: expression/builtin_cast.go)
# ---------------------------------------------------------------------------


def _cast_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    src = fts[0]
    if ret_ft.is_float():
        return lane_as_float(xp, d, src), v
    if ret_ft.is_decimal():
        rs = _scale(ret_ft)
        if src.is_float():
            x = d.astype(xp.float64) * pow10(rs)
            r = xp.where(x >= 0, xp.floor(x + 0.5), xp.ceil(x - 0.5))
            return r.astype(xp.int64), v
        if src.is_string():
            out = np.zeros(len(d), dtype=np.int64)
            from ..mysqltypes.datum import Datum

            for i in np.nonzero(v)[0]:
                out[i] = Datum.s(_as_str(d[i])).to_dec().rescale(rs).value
            return out, v
        return lane_as_decimal(xp, d, src, rs), v
    if ret_ft.is_string():
        assert is_host(xp)
        out = np.empty(len(d), dtype=object)
        for i in np.nonzero(v)[0]:
            if src.is_decimal():
                from ..mysqltypes.mydecimal import Dec

                out[i] = str(Dec(int(d[i]), _scale(src)))
            elif src.is_time():
                from ..mysqltypes.coretime import format_time

                out[i] = format_time(int(d[i]), is_date=src.tp == TypeCode.Date, fsp=max(src.decimal, 0))
            else:
                out[i] = _as_str(d[i]) if src.is_string() else str(d[i])
        return out, v
    # int target
    if src.is_float():
        x = d.astype(xp.float64)
        r = xp.where(x >= 0, xp.floor(x + 0.5), xp.ceil(x - 0.5))
        return r.astype(xp.int64), v
    if src.is_decimal():
        return _round_div(xp, d.astype(xp.int64), xp.full_like(d.astype(xp.int64), pow10(_scale(src)))), v
    if src.is_string():
        from ..mysqltypes.datum import Datum

        out = np.zeros(len(d), dtype=np.int64)
        for i in np.nonzero(v)[0]:
            out[i] = Datum.s(_as_str(d[i])).to_int()
        return out, v
    return d.astype(xp.int64), v


CAST_SIG = FuncSig("cast", infer_first, _cast_kernel)
register(CAST_SIG)


# extended registry: date arithmetic, string/math breadth, JSON
from . import builtins_ext  # noqa: E402,F401  (registration side effects)
