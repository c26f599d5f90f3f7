"""K2/K3 + P1: the expression kernel — one launch evaluates a compiled
expression program (expr/program.py) over every row.

Replaces the device evaluation of tidb_tpu/copr/tpu_engine.py:1021
`_eval_device` and :1044 `_mask` inside the filter program (:1138-1158),
the aggregation program's argument lanes (:1287-1304, :1527-1617) and the
TopN keys (:1762, :1818), and of the MPP program's scan stage
(parallel/mpp.py:1431), post-join conditions (:1557, :1649) and aggregate
arguments (:1678, :1879, :2050). The CUDA kernel is csrc/expr_eval.cu, an
interpreter of the program (its note gives the design and what bounds
it); `expr_eval_ref` is the plain PyTorch version beside it, interpreting
the same program with one torch op per instruction over whole lanes.

`expr_eval(prog, ins, n)`:

  * prog — an expr.program.Program
  * ins  — one flat contiguous tensor [n] per input slot of the program,
           in slot order: int64 / float64 / int32 data lanes (uint64 as
           their int64 bits), bool valid lanes, the bool mask_in
  → one tensor [n] per output slot: int64 (float64 values as their bits)
    for an 8-byte slot, bool for a 1-byte slot

Where trouble lies, and what pins it (tests/test_torch_expr.py, the
chip_smoke.py battery):
  * int64 wrap: adds and multiplies wrap mod 2^64 (unsigned in CUDA);
  * float rounding: a multiply-add is contracted where XLA's CPU
    contracts it (FFMA: an add or subtract of a product with no other
    use, expr/program.py `Emitter.fused`; and the float MOD) — __fma_rn,
    which `_fma` emulates here — and nowhere else (__dmul_rn /
    __dadd_rn / __ddiv_rn); uint64 → float64
    rounds once; a division by a constant is a multiply by the host's
    reciprocal (FMULK: a decimal becomes a float as x * 10^-s);
  * XLA's CPU float rules, which the reference runs under: subnormal
    operands read as signed zero, subnormal results flush (not on
    negation, abs, sin and tan, nor pow's and atan2's operands); max and
    min return a NaN operand as it is, -0.0 below +0.0;
  * integer division: a zero divisor reads 1 (its row NULL), INT64_MIN /
    -1 is INT64_MIN (XLA's rule; CUDA's and the host's trap); a shift by
    64 or more, or by a negative count, is 0;
  * float → int64 saturates with NaN → 0 (XLA's conversion), and the
    bitwise aggregates' rint rounds half to even first.

`expr_eval` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernel or raises; `expr_eval.launches` counts
the launches. `launch_shape` sizes a launch from the program's registers
(tests/test_torch_launch_plans.py); `expr_eval_prepare` stops short of
the launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..expr.program import (DOM_F, DOM_GE0, DOM_GT0, DOM_U, DOM_X, EXT_FIRST, FDIV_GUARD, FDIV_MODK, FDIV_PLAIN,
                            FDIV_PRODUCT, FDIV_REG_SHIFT, FMA_NEG_ADDEND, FMA_NEG_PRODUCT, FUN1, FUN2, IDIV_U, IMOD_S,
                            KOPS, OP, ROWS, SEL_REG_BITS, SMEM_MAX, Program)
from .build import count, library
from .tables import sm_count

_NAMES = {v: k for k, v in OP.items()}
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_TWO63 = float(1 << 63)
_DBL_MIN = 2.2250738585072014e-308
_TWO32 = float(1 << 32)


def _f(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.float64)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64)


def _daz(x: torch.Tensor) -> torch.Tensor:
    """A subnormal as zero of its sign (XLA CPU's denormals-are-zero and
    flush-to-zero); NaN, ±inf and normal values unchanged."""
    return torch.where(x.abs() < _DBL_MIN, torch.copysign(torch.zeros_like(x), x), x)


def _sat_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 → int64 as XLA converts: saturating, NaN → 0 (x already
    integral or truncated by the caller)."""
    safe = torch.where(torch.isnan(x) | (x.abs() >= _TWO63), 0.0, x).to(torch.int64)
    out = torch.where(x >= _TWO63, _I64_MAX, safe)
    out = torch.where(x <= -_TWO63, _I64_MIN, out)
    return torch.where(torch.isnan(x), 0, out)


def _u2f(bits: torch.Tensor) -> torch.Tensor:
    hi = ((bits >> 32) & 0xFFFFFFFF).to(torch.float64)
    lo = (bits & 0xFFFFFFFF).to(torch.float64)
    return hi * _TWO32 + lo  # both halves exact: the sum rounds once


def _nz(d: torch.Tensor, is_float: int) -> torch.Tensor:
    return _daz(_f(d)) != 0 if is_float else d != 0


def _round_div(num: torch.Tensor, den: int) -> torch.Tensor:
    """expr/builtins._round_div for a positive constant divisor: exact,
    half away from zero (|INT64_MIN| wraps and floor-divides, as there)."""
    a = num.abs()
    q = torch.div(a, den, rounding_mode="floor")
    r = a - q * den
    q = q + (2 * r >= den).to(torch.int64)
    return q * torch.where(num < 0, -1, 1)


def _cmp(aux: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dom, pred = aux & 3, (aux >> 2) & 7
    if dom == DOM_F:
        a, b = _daz(_f(a)), _daz(_f(b))
    elif dom == DOM_U:  # unsigned order: flip the sign bits
        a, b = a ^ _I64_MIN, b ^ _I64_MIN
    elif dom == DOM_X:  # mixed signed / unsigned: (class, lo) order
        ca = (a < 0).to(torch.int64) * (1 if aux >> 5 & 1 else -1)
        cb = (b < 0).to(torch.int64) * (1 if aux >> 6 & 1 else -1)
        eq = (ca == cb) & (a == b)
        lt = (ca < cb) | ((ca == cb) & (a < b))
        return [eq, ~eq, lt, lt | eq, ~(lt | eq), ~lt][pred]
    return [a == b, a != b, a < b, a <= b, a > b, a >= b][pred]


def _neg(x: torch.Tensor) -> torch.Tensor:
    return 0 - x  # wraps: -INT64_MIN is INT64_MIN


def _iabs(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0, _neg(x), x)


def _tdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b truncated, b != 0; INT64_MIN / -1 is INT64_MIN (XLA's rule),
    never the host's overflow trap."""
    neg = b == -1
    q = torch.div(a, torch.where(neg, 1, b), rounding_mode="trunc")
    return torch.where(neg, _neg(q), q)


def _jfloordiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp's floor division of int64 (b != 0): the truncated quotient,
    one less where the signs differ and the remainder is not 0."""
    q = _tdiv(a, b)
    r = a - q * b
    return q - ((r != 0) & ((a < 0) != (b < 0))).to(torch.int64)


def _udiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint64 a / b over their int64 bit patterns (b != 0)."""
    big = b < 0  # b >= 2^63: the quotient is 0 or 1
    q1 = ((a ^ _I64_MIN) >= (b ^ _I64_MIN)).to(torch.int64)
    bs = torch.where(big, 1, b)
    q = torch.div((a >> 1) & _I64_MAX, bs, rounding_mode="floor") << 1
    r = a - q * bs
    q = q + ((r ^ _I64_MIN) >= (bs ^ _I64_MIN)).to(torch.int64)
    return torch.where(big, q1, q)


def _round_div_lane(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """expr/builtins._round_div over a divisor lane, with jnp's integer
    semantics (|INT64_MIN| wraps, floor division)."""
    ds = torch.where(den == 0, 1, den)
    an, ad = _iabs(num), _iabs(ds)
    q = _jfloordiv(an, ad)
    r = an - q * ad
    q = q + (2 * r >= ad).to(torch.int64)
    return q * torch.where((num < 0) != (ds < 0), -1, 1)


def _fmax(x: torch.Tensor, y: torch.Tensor, is_max: bool) -> torch.Tensor:
    """XLA CPU's max / min of doubles: operands flushed, a NaN operand
    returned as it is (the first one), -0.0 below +0.0."""
    x, y = _daz(x), _daz(y)
    sx = torch.signbit(x)
    if is_max:
        pick = torch.where(x == y, torch.where(sx, y, x), torch.where(x > y, x, y))
    else:
        pick = torch.where(x == y, torch.where(sx, x, y), torch.where(x < y, x, y))
    return torch.where(torch.isnan(x), x, torch.where(torch.isnan(y), y, pick))


_SPLIT = 134217729.0  # 2^27 + 1: Dekker's split of a double into two 26-bit halves


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once (the fused multiply-add), by Boldo and
    Melquiond's emulation: the exact product as two doubles (Dekker), its
    exact sum with c, the low parts added rounding to odd, then one
    rounding to nearest; operands past 2^900 scaled by 2^-200 first.
    Non-finite operands or products take a * b + c (the same NaN and
    infinities)."""
    def split(x):
        t = _SPLIT * x
        hi = t - (t - x)
        return hi, x - hi

    # scale a and b below 2^900 by powers of two (exact), c with them
    one = torch.ones_like(a)
    sa = torch.where(a.abs() >= 2.0 ** 900, one * 2.0 ** -200, one)
    sb = torch.where(b.abs() >= 2.0 ** 900, one * 2.0 ** -200, one)
    a0, b0, c0 = a, b, c
    a, b, c = a * sa, b * sb, c * (sa * sb)
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, p)
    v, ve = _two_sum(tl, e)
    vb = _bits(v)
    odd = (ve != 0) & ((vb & 1) == 0)  # inexact on an even last bit: the odd neighbour toward the error
    v = torch.where(odd, _f(vb + torch.where((ve > 0) == (v > 0), 1, -1)), v)
    r = (th + v) / (sa * sb)
    ok = torch.isfinite(a0) & torch.isfinite(b0) & torch.isfinite(c0) & torch.isfinite(p)
    return torch.where(ok, r, a0 * b0 + c0)


def _f1(fn: int, x: torch.Tensor) -> torch.Tensor:
    return [torch.sqrt, torch.exp, torch.log, torch.sin, torch.cos, torch.tan, torch.asin, torch.acos,
            torch.atan][fn](x)


def _ext(name: str, aux: int, x, va, y, vb, consts, b, D, V, ones):
    """One op of the extended instantiation → (data, valid)."""
    both = va & vb if vb is not None else None
    if name in ("IFLOORK", "IMODK", "ITRUNCK"):
        k = int(consts[b])
        if name == "IFLOORK":
            return torch.div(x, k, rounding_mode="floor"), va
        if name == "IMODK":
            return torch.remainder(x, k), va
        return torch.sign(x) * torch.div(_iabs(x), k, rounding_mode="floor"), va
    if name == "IDIV":
        ok = y != 0
        ys = torch.where(ok, y, 1)
        if aux == IDIV_U:
            return _udiv(x, ys), both & ok
        q = _tdiv(x, ys)
        return (x - q * ys if aux == IMOD_S else q), both & ok
    if name == "RDIV":
        return _round_div_lane(x, y), both & (y != 0)
    if name == "IABS":
        a = _iabs(x)
        return (a.to(torch.int32).to(torch.int64) if aux else a), va
    if name in ("MAX", "MIN"):
        if aux == DOM_F:
            return _bits(_fmax(_f(x), _f(y), name == "MAX")), both
        if aux == DOM_U:
            lt = (x ^ _I64_MIN) < (y ^ _I64_MIN)
            return torch.where(lt, y, x) if name == "MAX" else torch.where(lt, x, y), both
        return (torch.maximum(x, y) if name == "MAX" else torch.minimum(x, y)), both
    if name == "X2F":
        f = x.to(torch.float64)
        if aux:
            f = torch.where(x < 0, f + 2.0 ** 64, f)
        return _bits(f), va
    if name in ("BAND", "BOR", "BXOR"):
        return {"BAND": x & y, "BOR": x | y, "BXOR": x ^ y}[name], both
    if name == "BNOT":
        return ~x, va
    if name in ("SHL", "SHR"):
        ok = (y >= 0) & (y < 64)
        s = y & 63
        if name == "SHL":
            return torch.where(ok, x << s, 0), both
        mask = torch.where(s == 0, -1, (torch.ones_like(s) << (64 - s)) - 1)
        return torch.where(ok, (x >> s) & mask, 0), both
    if name == "XOR":
        return (_nz(x, aux & 1) != _nz(y, aux >> 1 & 1)).to(torch.int64), both
    if name in ("ISTRUE", "ISFALSE"):
        t = _nz(x, aux & 1)
        return ((t if name == "ISTRUE" else ~t) & va).to(torch.int64), ones
    if name == "SEL":
        c = aux & ((1 << SEL_REG_BITS) - 1)
        cond = _nz(D[c], aux >> SEL_REG_BITS & 1) & V[c]
        return torch.where(cond, x, y), torch.where(cond, va, vb)
    if name == "COAL":
        return torch.where(va, x, y), va | vb
    if name == "NULLIF":
        return x, va & ~((y != 0) & vb)
    if name == "VAND":
        return x, both
    if name == "FDIV":
        mode = aux & ((1 << FDIV_REG_SHIFT) - 1)
        fa, fb = _daz(_f(x)), _daz(_f(y))
        if mode == FDIV_PLAIN:
            return _bits(_daz(fa / fb)), both
        if mode == FDIV_GUARD:
            ok = fb != 0
            return _bits(_daz(fa / torch.where(ok, fb, 1.0))), both & ok
        if mode & FDIV_PRODUCT:  # a is x * k
            c = aux >> FDIV_REG_SHIFT
            fk = _daz(_f(D[c]))
            prod = _daz(fa * fk)
            both = both & V[c]
        else:
            prod = fa
        if mode & ~FDIV_PRODUCT == FDIV_MODK:  # b: a nonzero constant; the quotient by its reciprocal
            ok, bs = torch.ones_like(both), fb
            q = _daz(prod * (1.0 / fb))
        else:
            ok = fb != 0
            bs = torch.where(ok, fb, 1.0)
            q = _daz(prod / bs)
        t = torch.trunc(q)
        if mode & FDIV_PRODUCT:
            r = _fma(fa, fk, -_daz(t * bs))
        else:
            r = _fma(-t, bs, fa)
        return _bits(_daz(r)), both & ok
    if name == "FFMA":
        c = aux >> FDIV_REG_SHIFT
        fx, fy, fz = _daz(_f(x)), _daz(_f(y)), _daz(_f(D[c]))
        r = _fma(-fx if aux & FMA_NEG_PRODUCT else fx, fy, -fz if aux & FMA_NEG_ADDEND else fz)
        return _bits(_daz(r)), both & V[c]
    if name == "FABS":
        return x & _I64_MAX, va
    if name in ("FFLOOR", "FCEIL", "FTRUNC"):
        fn = {"FFLOOR": torch.floor, "FCEIL": torch.ceil, "FTRUNC": torch.trunc}[name]
        return _bits(fn(_daz(_f(x)))), va
    if name == "FRNDA":
        s = _daz(_f(x))
        return _bits(torch.where(s >= 0, torch.floor(_daz(s + 0.5)), torch.ceil(_daz(s - 0.5)))), va
    if name == "FSIGN":
        s = _daz(_f(x))
        return torch.where(torch.isnan(s) | (s == 0), 0, torch.where(s > 0, 1, -1)), va
    if name == "FUN1":
        fn, dom = aux & 15, aux >> 4
        if fn in (FUN1["sin"], FUN1["tan"]):  # no flush on either side
            return _bits(_f1(fn, _f(x))), va
        s = _daz(_f(x))
        ok = s >= 0 if dom == DOM_GE0 else s > 0 if dom == DOM_GT0 else torch.ones_like(va)
        return _bits(_daz(_f1(fn, torch.where(ok, s, 1.0)))), va & ok
    if name == "FUN2":
        if aux == FUN2["pow"]:  # neither operand flushed
            return _bits(_daz(torch.pow(_f(x), _f(y)))), both
        return _bits(_daz(torch.atan2(_f(x), _f(y)))), both
    raise ValueError(f"expr_eval: unknown opcode {name}")


def expr_eval_ref(prog: Program, ins: list, n: int) -> list:
    """Plain PyTorch version: the program, instruction by instruction,
    over whole lanes."""
    dev = ins[0].device if ins else torch.device("cpu")
    D: dict = {}
    V: dict = {}
    outs = [torch.empty(n, dtype=torch.int64 if w == 8 else torch.bool, device=dev) for w in prog.outputs]
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    consts = prog.consts
    for code, dst, a, b, aux in prog.ops.tolist():
        name = _NAMES[code]
        if name in ("LD8", "LD4"):
            t = ins[a]
            D[dst] = t.to(torch.int64) if name == "LD4" else _bits(t) if t.is_floating_point() else t
            V[dst] = ones if b < 0 else ins[b]
        elif name == "LDB":
            D[dst], V[dst] = ins[a].to(torch.int64), ones
        elif name == "LDK":
            D[dst] = torch.full((n,), int(consts[a]), dtype=torch.int64, device=dev)
            V[dst] = ones if aux else ~ones
        elif name in ("ST8", "STV", "STB"):
            src = D[a] if name == "ST8" else V[a] if name == "STV" else D[a] != 0
            outs[dst].copy_(src)
        elif name in ("IN", "MASK"):  # accumulators: read dst
            if name == "IN":
                e = _cmp(aux & 3 | aux & 0x60, D[a], D[b]) & V[b]
                D[dst], V[dst] = D[dst] | e.to(torch.int64), V[dst] | ~V[b]
            else:
                D[dst] = (D[dst].bool() & V[a] & _nz(D[a], aux & 1)).to(torch.int64)
                V[dst] = ones
        else:
            x, va = D.get(a), V.get(a)
            y, vb = (D.get(b), V.get(b)) if name not in KOPS else (None, None)
            both = va & vb if vb is not None else None
            if code >= EXT_FIRST:
                d, v = _ext(name, aux, x, va, y, vb, consts, b, D, V, ones)
            elif name == "I2F":
                d, v = _bits(x.to(torch.float64)), va
            elif name == "U2F":
                d, v = _bits(_u2f(x)), va
            elif name == "F2I":
                d, v = _sat_i64(torch.trunc(_f(x))), va
            elif name == "RINT":
                d, v = _sat_i64(torch.round(_f(x))), va
            elif name == "FMULK":
                # a 0-d tensor factor: the product IEEE-rounded once
                k = torch.tensor(np.array(consts[b], dtype=np.int64).view(np.float64), device=dev)
                d, v = _bits(_daz(_daz(_f(x)) * k)), va
            elif name == "IMULK":
                d, v = x * int(consts[b]), va
            elif name == "RDIVK":
                d, v = _round_div(x, int(consts[b])), va
            elif name in ("IADD", "ISUB", "IMUL"):
                d, v = {"IADD": x + y, "ISUB": x - y, "IMUL": x * y}[name], both
            elif name in ("FADD", "FSUB", "FMUL"):
                fx, fy = _daz(_f(x)), _daz(_f(y))
                d, v = _bits(_daz({"FADD": fx + fy, "FSUB": fx - fy, "FMUL": fx * fy}[name])), both
            elif name == "INEG":
                d, v = -x, va
            elif name == "FNEG":
                d, v = x ^ _I64_MIN, va  # the sign bit only
            elif name == "CMP":
                r = _cmp(aux, x, y)
                if aux >> 7 & 1:  # nulleq
                    d, v = ((r & va & vb) | (~va & ~vb)).to(torch.int64), ones
                else:
                    d, v = r.to(torch.int64), both
            elif name == "IN0":
                d, v = torch.zeros_like(x), ~va
            elif name == "INF":
                d, v = x, vb & (x.bool() | ~va)
            elif name == "AND":
                ta, tb = _nz(x, aux & 1), _nz(y, aux >> 1 & 1)
                false_any = (va & ~ta) | (vb & ~tb)
                d, v = (ta & tb & va & vb).to(torch.int64), (va & vb) | false_any
            elif name == "OR":
                ta, tb = _nz(x, aux & 1) & va, _nz(y, aux >> 1 & 1) & vb
                t = ta | tb
                d, v = t.to(torch.int64), (va & vb) | t
            elif name == "NOT":
                d, v = (~_nz(x, aux & 1)).to(torch.int64), va
            elif name == "ISNULL":
                d, v = (~va).to(torch.int64), ones
            elif name == "ZNULL":
                d, v = torch.where(va, x, 0), va
            elif name == "IHI":
                d, v = x >> 32, va
            elif name == "ILO":
                d, v = x & 0xFFFFFFFF, va
            else:
                raise ValueError(f"expr_eval: unknown opcode {code}")
            D[dst], V[dst] = d, v
    return outs


# --- the kernel ------------------------------------------------------------

MAX_PTRS = 192  # input and output pointers passed by value each (csrc/expr_eval.cu)


class _Params(ctypes.Structure):
    _fields_ = [("ops", ctypes.c_void_p), ("consts", ctypes.c_void_p), ("ext_in", ctypes.c_void_p),
                ("ext_out", ctypes.c_void_p), ("n", ctypes.c_int64), ("nops", ctypes.c_int),
                ("nk", ctypes.c_int), ("nregs", ctypes.c_int), ("n_in", ctypes.c_int), ("n_out", ctypes.c_int),
                ("threads", ctypes.c_int), ("blocks", ctypes.c_int), ("ops_in_smem", ctypes.c_int),
                ("nld", ctypes.c_int), ("ext_ops", ctypes.c_int), ("smem", ctypes.c_int64),
                ("in_ptrs", ctypes.c_int64 * MAX_PTRS), ("out_ptrs", ctypes.c_int64 * MAX_PTRS)]


_bound: set = set()


def _lib():
    lib = library("expr_eval")
    if "expr_eval" not in _bound:
        lib.tt_expr_eval.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        lib.tt_expr_eval.restype = ctypes.c_int
        _bound.add("expr_eval")
    return lib


MAX_THREADS = 256  # a block's threads at most (the kernel's launch bounds)
MIN_BLOCKS = 4  # blocks of MAX_THREADS an SM holds (the launch bounds: at most 64 registers a thread)
SM_THREADS = MAX_THREADS * MIN_BLOCKS  # resident threads of an SM, by registers
SM_SMEM = 228 * 1024  # shared memory of an SM (bytes)


def register_bytes(nregs: int, threads: int) -> int:
    """Shared bytes of a block's register file: ROWS 8-byte data words a
    register and thread, and a byte of ROWS valid bits (rounded to 16)."""
    return 8 * ROWS * nregs * threads + (nregs * threads + 15) // 16 * 16


def _shape(prog: Program, threads: int):
    """(shared bytes, ops in shared memory, resident blocks an SM) of a
    block of `threads`, or None when its register file does not fit."""
    tables = 8 * (len(prog.consts) + len(prog.inputs) + len(prog.outputs))
    regs = register_bytes(prog.nregs, threads)
    if tables + regs > SMEM_MAX:
        return None
    in_smem = tables + regs + 20 * len(prog.ops) <= SMEM_MAX
    smem = tables + regs + (20 * len(prog.ops) if in_smem else 0)
    return smem, in_smem, max(1, min(SM_THREADS // threads, SM_SMEM // (smem + 1024)))


def launch_shape(prog: Program, n: int, n_sms: int):
    """(threads, blocks, shared bytes, ops in shared memory) of a launch:
    the register file (nregs * (8 * ROWS + 1) bytes a thread) sizes the
    block — of the multiples of 32 up to MAX_THREADS whose file fits, the
    one that keeps the most threads on an SM (the largest of equals); the
    op table joins it in shared memory when it fits; the grid is as many
    blocks as every SM holds at once, or fewer when the rows run out, each
    thread taking ROWS rows at a time."""
    best = None
    for threads in range(MAX_THREADS, 31, -32):
        shape = _shape(prog, threads)
        if shape is not None and (best is None or shape[2] * threads > best[3] * best[0]):
            best = (threads,) + shape
    if best is None:
        raise ValueError(f"expression program: {prog.nregs} registers do not fit one block's shared memory")
    threads, smem, in_smem, per_sm = best
    groups = -(-n // ROWS)
    blocks = max(1, min(-(-groups // threads), n_sms * per_sm))
    return threads, blocks, smem, in_smem


def expr_eval(prog: Program, ins: list, n: int) -> list:
    """The program's output lanes (module doc)."""
    dev = ins[0].device if ins else torch.device("cpu")
    if dev.type == "cpu":
        return expr_eval_ref(prog, ins, n)
    if dev.type != "cuda":
        raise ValueError(f"expr_eval: unsupported device {dev}")
    outs, go = expr_eval_prepare(prog, ins, n)
    if go is not None:
        go()
        count(expr_eval)
    return outs


def expr_eval_prepare(prog: Program, ins: list, n: int):
    """The call on the card up to its launch: the outputs, and `go()`,
    which enqueues the kernel over them (None when n is 0)."""
    dev = ins[0].device
    if len(ins) != len(prog.inputs):
        raise ValueError(f"expr_eval: {len(prog.inputs)} input lanes, got {len(ins)}")
    for t in ins:
        if t.device != dev or not t.is_contiguous() or t.shape != (n,):
            raise ValueError(f"expr_eval: input lanes must be contiguous [{n}] tensors on {dev}")
        if t.element_size() not in (1, 4, 8):
            raise TypeError(f"expr_eval: lane dtype {t.dtype}")
    outs = [torch.empty(n, dtype=torch.int64 if w == 8 else torch.bool, device=dev) for w in prog.outputs]
    if n == 0:
        return outs, None
    ops, consts = prog.tables(dev)
    threads, blocks, smem, in_smem = launch_shape(prog, n, sm_count(dev))
    p = _Params(ops=ops.data_ptr(), consts=consts.data_ptr(), n=n, nops=len(prog.ops), nk=len(prog.consts),
                nregs=prog.nregs, n_in=len(ins), n_out=len(outs), threads=threads, blocks=blocks,
                ops_in_smem=int(in_smem), nld=prog.loads, ext_ops=int(prog.ext), smem=smem)
    keep = []
    for name, ts, fld in (("in", ins, "in_ptrs"), ("out", outs, "out_ptrs")):
        ptrs = [t.data_ptr() for t in ts]
        if len(ptrs) <= MAX_PTRS:
            getattr(p, fld)[:len(ptrs)] = ptrs
        else:  # a program this wide reads its pointer table from device memory
            table = torch.tensor(ptrs, dtype=torch.int64).to(dev)
            keep.append(table)
            setattr(p, "ext_" + name, table.data_ptr())

    def go(keep=keep, tables=(ops, consts)):  # what the kernel reads by address lives until it is enqueued
        rc = _lib().tt_expr_eval(ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"expr_eval: kernel launch failed (cudaError {rc})")

    return outs, go


expr_eval.launches = 0
