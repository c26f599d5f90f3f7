"""The expression compiler of the port: a rewritten expression tree → a
typed register program that one kernel launch interprets per row
(kernels/expr_eval.py, csrc/expr_eval.cu).

The reference evaluates a tree by calling every builtin's array kernel
over jax.numpy inside its jitted program (tidb_tpu/copr/tpu_engine.py:1021
`_eval_device`, :1044 `_mask`; the MPP scan stage, post-join masks and
aggregate arguments, parallel/mpp.py:1431, :1557, :1649, :1678, :1879,
:2050). Every decision those kernels make from dtypes and FieldTypes at
trace time (expr/builtins*.py, expression.numeric_common) is made here
once, by the same rules, for every pushable builtin of the registry:

  * the comparison domain of `numeric_common`: int (signed int64), uint
    (all operands BIGINT UNSIGNED: unsigned order), int2 (mixed signed
    and unsigned: exact (class, lo) order; `int2_as_float` where a
    function needs a value), dec:<scale> (`lane_as_decimal` rescales by
    10^k, wrapping), float (`lane_as_float`);
  * arithmetic by the result type the registry inferred: float, decimal
    (scaled int64: a product past the capped scale and a division round
    half away from zero, `_round_div`) or int64 with two's-complement
    wrap; DIV and MOD truncate toward zero, a zero divisor gives NULL;
  * SQL's three-valued `and` / `or` / `xor` / `not`, `isnull`, `istrue`,
    `isfalse`, `nulleq` and n-ary `in` with its NULL rule; `if`,
    `ifnull`, `coalesce`, `case` (n-ary, chained selects) over branches
    coerced to the merged type, `nullif` by the raw lanes' promotion;
  * rounding (abs, sign, ceil, floor, round, truncate: int, decimal and
    float paths, a per-row `frac` on the float path), the math functions
    (sqrt, exp, ln / log, log2, log10, pow, the trigonometric ones, pi;
    out-of-domain input is NULL), greatest / least, the time fields of a
    packed DATE / DATETIME / TIME lane (year .. microsecond, date,
    time_to_sec, sec_to_time), the bit operators (uint64 results) and
    casts to double, decimal(s) and the integer types;
  * 0-d constants: a NULL literal is int64 0 with valid False, a BIGINT
    UNSIGNED literal above 2^63 - 1 is a uint64, a float literal float64.

Floats follow XLA's CPU arithmetic under jit, which the reference runs
under: subnormal operands read as zero of their sign and subnormal
results are flushed (so `f > 0` is false for f = 5e-324), negation and
abs touch the sign bit only, a float add or subtract of a product with
no other use in its tree is one fused multiply-add (FFMA, the left
product's when both operands are products: `Emitter.fused`), as LLVM
contracts it under XLA, and the
algebraic simplifier's rewrites hold: a division by a constant (a
literal, or a subtree of constants, which XLA folds) is a multiply by
its reciprocal rounded once (`lane_as_float` of a decimal is x * 10^-s,
not x / 10^s), log2 is log(x) * (1 / ln 2) and log10 is
log(x) * 0.4342944819032518 (jax's own constants), and pow by a constant
0, 1, 2, 3 or -1 is 1, x, x*x, x*x*x or 1/x. A builtin that is not a
device function (pushable=False) and a cast to a string type raise
DeviceFatalError, as the reference's device raises on them
(`assert xp is np`).

A program computes, in one pass over the rows:

  * optionally the mask `mask_in & v_c & (d_c != 0)` over a list of
    conditions (`mask_in` is the row validity, or the mask so far);
  * any number of value outputs (`ValueSpec`): an expression's (data,
    valid) lanes — an aggregate argument, a TopN key — or the lanes the
    aggregation kernel reads for it: `var_dec` (the decimal limbs of
    var / stddev), `var_f` (x, x*x) and `bit` (the saturating rint of a
    bit_and / bit_or / bit_xor argument: NaN → 0, x >= 2^63 → INT64_MAX,
    x <= -2^63 → INT64_MIN, round half to even otherwise; a decimal is
    multiplied by 10^-s first).

A bare column needs no work: its lanes come back as they were given.

Each input lane is loaded once per row into a register and held until
its last use; the loads come first in the program (the kernel's load
phase issues them together, ahead of any arithmetic). Registers are
allocated by liveness after a Sethi-Ullman ordering of the tree, and the
kernel sizes its register file from the program. When the loads first
would need more registers than REG_BUDGET (or than `max_regs`), each lane
is loaded at its first use; when even that does not fit, the program
reloads a lane at each use, which needs about log2(tree size) registers:
no expression is declined for its depth or width.

The opcodes from EXT_FIRST on (the builtins past arithmetic, compares and
logic) run in the kernel's extended instantiation only; a program that
holds none of them (`Program.ext` False: TPC-H Q1's, Q6's and the
checksum's) runs the base instantiation, whose dispatch holds none.

An engine keeps its programs in a `ProgramCache`, keyed by the trees'
structure (every node's FieldType included), the lane kinds and the
options, as the reference keeps one program per key
(tpu_engine.py:1052); a program keeps its device copy per device
(`Program.tables`), so a warm query compiles and uploads nothing.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from threading import Lock

import numpy as np
import torch

from ..errors import DeviceFatalError
from ..mysqltypes import coretime as _ct
from ..mysqltypes.field_type import TypeCode
from ..mysqltypes.mydecimal import pow10
from .builtins import _scale
from .expression import Column as ExprCol, Constant, Expression, ScalarFunc

# opcodes; the csrc/expr_eval.cu enum holds the same numbers
BASE_OPS = ("NOP", "LD8", "LD4", "LDB", "LDK", "I2F", "U2F", "F2I", "RINT", "FMULK", "IMULK", "RDIVK",
            "IADD", "ISUB", "IMUL", "FADD", "FSUB", "FMUL", "INEG", "FNEG", "CMP", "IN0", "IN", "INF",
            "AND", "OR", "NOT", "ISNULL", "MASK", "ZNULL", "IHI", "ILO", "ST8", "STV", "STB")
# the extended instantiation's opcodes (module doc)
EXT_OPS = ("IDIV", "RDIV", "IFLOORK", "IMODK", "ITRUNCK", "IABS", "MAX", "MIN", "X2F", "BAND", "BOR", "BXOR",
           "BNOT", "SHL", "SHR", "XOR", "ISTRUE", "ISFALSE", "SEL", "COAL", "NULLIF", "VAND", "FDIV", "FABS",
           "FFLOOR", "FCEIL", "FTRUNC", "FRNDA", "FSIGN", "FUN1", "FUN2", "FFMA")
OP = {name: i for i, name in enumerate(BASE_OPS + EXT_OPS)}
EXT_FIRST = len(BASE_OPS)
# CMP domains and predicates (aux = dom | pred << 2 | ua << 5 | ub << 6 | nulleq << 7); MAX / MIN take dom
DOM_I, DOM_U, DOM_F, DOM_X = 0, 1, 2, 3
PRED = {"eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5}
# IDIV's aux: the signed quotient (truncated), the unsigned quotient, the signed remainder
IDIV_S, IDIV_U, IMOD_S = 0, 1, 2
# FDIV's aux = mode | c << FDIV_REG_SHIFT: a / b; a / where(b == 0, 1.0, b), NULL where b == 0;
# a - trunc(a / bs) * bs likewise, the product and the difference in one fused multiply-add as XLA's
# CPU contracts them; the same by a nonzero constant b (the quotient a times 1 / b). With
# FDIV_PRODUCT, a is the product a * c, which the multiply-add takes in place of trunc(q) * bs
# (LLVM contracts the subtraction's first operand when both are products)
FDIV_PLAIN, FDIV_GUARD, FDIV_MOD, FDIV_MODK, FDIV_PRODUCT = 0, 1, 2, 3, 4
FDIV_REG_SHIFT = 4
# FFMA's aux = flags | c << FDIV_REG_SHIFT: (±a) * b + (±c) rounded once, where XLA's CPU contracts a
# float add or subtract of a product (Emitter.fused)
FMA_NEG_PRODUCT, FMA_NEG_ADDEND = 1, 2
# FUN1's aux = function | domain << 4 (the domain's failures are NULL and read 1.0); FUN2's aux.
# XLA's CPU reads a subnormal operand as zero and flushes a subnormal result, but for sin and tan
# (a tiny x is its own result) and the operands of pow and atan2
FUN1 = {"sqrt": 0, "exp": 1, "log": 2, "sin": 3, "cos": 4, "tan": 5, "asin": 6, "acos": 7, "atan": 8}
DOM_ANY, DOM_GE0, DOM_GT0 = 0, 1, 2
FUN2 = {"pow": 0, "atan2": 1}
SEL_REG_BITS = 16  # SEL's aux: the condition's register, then its float flag

# which fields of an op name registers: (dst, a, b); an accumulator op
# (IN, MASK) also reads dst, which the emitter records as `acc`; SEL also
# reads the register in its aux's low bits, which the emitter records as `c`
_REGS = {
    "LD8": (1, 0, 0), "LD4": (1, 0, 0), "LDB": (1, 0, 0), "LDK": (1, 0, 0),
    "FMULK": (1, 1, 0), "IMULK": (1, 1, 0), "RDIVK": (1, 1, 0), "MASK": (1, 1, 0),
    "IFLOORK": (1, 1, 0), "IMODK": (1, 1, 0), "ITRUNCK": (1, 1, 0),
    "ST8": (0, 1, 0), "STV": (0, 1, 0), "STB": (0, 1, 0),
}
for _n in ("I2F", "U2F", "F2I", "RINT", "INEG", "FNEG", "NOT", "ISNULL", "ZNULL", "IHI", "ILO", "IN0",
           "IABS", "X2F", "BNOT", "ISTRUE", "ISFALSE", "FABS", "FFLOOR", "FCEIL", "FTRUNC", "FRNDA", "FSIGN",
           "FUN1"):
    _REGS[_n] = (1, 1, 0)
for _n in ("IADD", "ISUB", "IMUL", "FADD", "FSUB", "FMUL", "CMP", "AND", "OR", "IN", "INF", "IDIV", "RDIV",
           "MAX", "MIN", "BAND", "BOR", "BXOR", "SHL", "SHR", "XOR", "SEL", "COAL", "NULLIF", "VAND", "FDIV",
           "FUN2", "FFMA"):
    _REGS[_n] = (1, 1, 1)
# the constant-pool operand (b) of these ops
KOPS = ("FMULK", "IMULK", "RDIVK", "IFLOORK", "IMODK", "ITRUNCK")

SMEM_MAX = 227 * 1024  # a block's shared memory on Hopper (bytes)
ROWS = 4  # rows a thread of the kernel evaluates at once (csrc/expr_eval.cu U)
# registers (8 data bytes a row and a valid bit a row, in one byte, for
# ROWS rows) a block of 32 threads can hold beside a program's tables: the
# register budget of a program
REG_BUDGET = (SMEM_MAX - 64 * 1024) // (32 * (8 * ROWS + 1))
LOADS = ("LD8", "LD4", "LDB")  # the lane loads, which a program emits first
_I64_MAX = (1 << 63) - 1


@dataclass(frozen=True)
class ValueSpec:
    """One value output: `expr`'s lanes (derive "value"), its valid lane
    alone ("valid": a COUNT or FIRST_ROW argument), or the lanes
    the aggregation kernel reads for var / stddev ("var_dec", "var_f") or
    a bitwise aggregate ("bit"); `scale` is the argument's decimal scale
    for "bit" (-1 for a non-decimal)."""

    expr: Expression
    derive: str = "value"
    scale: int = -1


@dataclass
class ValueOut:
    """Where a value output lands: `data` is a list of ("out", slot) or
    ("col", idx) per data lane, `valid` one of those; `kind` the data's
    dtype as the reference's array would have it (i32 / i64 / u64 / f64)."""

    data: list
    valid: tuple
    kind: str


@dataclass
class Program:
    ops: np.ndarray  # int32 [nops, 5]: code, dst, a, b, aux (physical registers)
    consts: np.ndarray  # int64 [k]: bit patterns (doubles as their bits)
    nregs: int
    inputs: list  # per input slot: ("d", col) | ("v", col) | ("mask_in",)
    outputs: list  # per output slot: 8 (an int64 / float64 lane) or 1 (a bool lane)
    mask_slot: int | None  # output slot of the mask
    values: list  # ValueOut per ValueSpec
    reload: bool  # lanes reloaded at each use (the wide-program mode)
    _tables: dict = field(default_factory=dict)

    @property
    def launches_kernel(self) -> bool:
        return len(self.ops) > 0

    @property
    def ext(self) -> bool:
        """The program holds an opcode of the extended instantiation."""
        return bool(len(self.ops)) and int(self.ops[:, 0].max()) >= EXT_FIRST

    @property
    def loads(self) -> int:
        """The leading run of lane loads: the kernel's load phase."""
        names = {OP[n] for n in LOADS}
        k = 0
        while k < len(self.ops) and int(self.ops[k, 0]) in names:
            k += 1
        return k

    def tables(self, device: torch.device):
        """(ops, consts) on `device`, uploaded once. A mesh's ranks ask for
        them from their threads at once: every caller gets the one pair the
        program keeps (setdefault), so no caller's pair is freed under its
        launch."""
        key = str(device)
        t = self._tables.get(key)
        if t is None:
            t = self._tables.setdefault(key, (torch.from_numpy(self.ops.reshape(-1).copy()).to(device),
                                              torch.from_numpy(self.consts.copy()).to(device)))
        return t


# ---------------------------------------------------------------- emitting


def _fbits(x: float) -> int:
    return int(np.array(x, dtype=np.float64).view(np.int64))


def _bitsf(b: int) -> float:
    return float(np.array(b, dtype=np.int64).view(np.float64))


def _daz(x: float) -> float:
    return math.copysign(0.0, x) if abs(x) < 2.2250738585072014e-308 else x


def _fatal(what: str):
    return DeviceFatalError(f"expression program: {what} is not a device function (the reference's device "
                            "raises on it)")


# the time fields of a packed lane: (divisor, modulus) (builtins.py _time_extract)
_TIME_FIELDS = {
    "year": (_ct.DIV_YEAR, None), "month": (_ct.DIV_MONTH, _ct.MOD_MONTH), "day": (_ct.DIV_DAY, _ct.MOD_DAY),
    "dayofmonth": (_ct.DIV_DAY, _ct.MOD_DAY), "hour": (_ct.DIV_HOUR, _ct.MOD_HOUR),
    "minute": (_ct.DIV_MINUTE, _ct.MOD_MINUTE), "second": (_ct.DIV_SECOND, _ct.MOD_SECOND),
    "microsecond": (1, _ct.MOD_MICRO),
}
_US = 1_000_000
# the one-argument math functions: (FUN1 function, domain, constant multiplied after)
_MATH1 = {
    "sqrt": ("sqrt", DOM_GE0, None), "exp": ("exp", DOM_ANY, None), "ln": ("log", DOM_GT0, None),
    "log": ("log", DOM_GT0, None), "log2": ("log", DOM_GT0, 1.0 / math.log(2.0)),
    "log10": ("log", DOM_GT0, 0.4342944819032518), "sin": ("sin", DOM_ANY, None),
    "cos": ("cos", DOM_ANY, None), "tan": ("tan", DOM_ANY, None), "asin": ("asin", DOM_ANY, None),
    "acos": ("acos", DOM_ANY, None),
}
_TIME_FUNCS = ("date", "time_to_sec", "sec_to_time")
_BITS = {"bitand": "BAND", "bitor": "BOR", "bitxor": "BXOR", "lshift": "SHL", "rshift": "SHR"}
_F64_RESULT = ("sqrt", "exp", "ln", "log", "log2", "log10", "sin", "cos", "tan", "asin", "acos", "atan",
               "atan2", "cot", "degrees", "radians", "pi", "pow", "power")
_I64_RESULT = tuple(PRED) + ("nulleq", "in", "and", "or", "xor", "not", "isnull", "istrue", "isfalse",
                             "intdiv", "sign", "bitneg") + tuple(_TIME_FIELDS) + _TIME_FUNCS + tuple(_BITS)


class _Emitter:
    def __init__(self, lane_kinds: dict, reload: bool):
        self.lane_kinds = lane_kinds
        self.reload = reload
        self.code: list = []  # [name, dst, a, b, aux, acc, c]
        self.nv = 0
        self.consts: list = []
        self.const_at: dict = {}
        self.inputs: list = []
        self.input_at: dict = {}
        self.outputs: list = []
        self.loaded: dict = {}  # col -> vreg (lanes held in registers)
        self._need: dict = {}
        self._folded: dict = {}
        self.products: dict = {}  # vreg of an FMUL / FMULK -> its factors (a constant as ("k", pool index))
        self.negprods: dict = {}  # vreg of an FNEG of a contractable product -> the product's factors
        self.uses: dict = {}  # structural key -> occurrences in the tree being compiled

    # -- plumbing
    def vreg(self) -> int:
        self.nv += 1
        return self.nv - 1

    def emit(self, name, dst=-1, a=-1, b=-1, aux=0, acc=-1, c=-1):
        self.code.append([name, dst, a, b, aux, acc, c])
        return dst

    def op(self, name, a=-1, b=-1, aux=0, c=-1):
        r = self.emit(name, self.vreg(), a, b, aux, c=c)
        if name == "FMUL":
            self.products[r] = (a, b)
        elif name == "FMULK":
            self.products[r] = (a, ("k", b))
        return r

    def const(self, bits: int) -> int:
        bits = ((int(bits) + (1 << 63)) % (1 << 64)) - (1 << 63)
        if bits not in self.const_at:
            self.const_at[bits] = len(self.consts)
            self.consts.append(bits)
        return self.const_at[bits]

    def fconst(self, x: float) -> int:
        return self.const(_fbits(x))

    def ldk(self, bits: int, valid: bool = True) -> int:
        return self.op("LDK", self.const(bits), aux=int(valid))

    def fmulk(self, r, k: float):
        """r * k, k a double in the pool (a division by a constant c is
        fmulk(r, 1 / c): XLA's reciprocal, rounded once)."""
        return self.op("FMULK", r, self.fconst(k))

    def intk(self, name, r, k: int):
        if k > _I64_MAX:  # the reference's int64 constant overflows too
            raise OverflowError(f"expression program: constant {k} exceeds int64")
        return self.op(name, r, self.const(k))

    def slot(self, key) -> int:
        if key not in self.input_at:
            self.input_at[key] = len(self.inputs)
            self.inputs.append(key)
        return self.input_at[key]

    def out(self, width: int) -> int:
        self.outputs.append(width)
        return len(self.outputs) - 1

    # -- trees and XLA's multiply-add contraction
    def tree(self, e):
        """(vreg, kind) of a whole tree (a condition or a value): its
        subtrees are counted first, as XLA's CSE merges equal subtrees of
        one output and then contracts only a product with no other use."""
        self.uses = {}
        _count_subtrees(e, self.uses)
        return self.expr(e)

    def contractable(self, r, arg):
        """(x, y, negated) of the product `r` (arg's register) when XLA's
        CPU would contract it into the add or subtract reading it: a float
        multiply, a multiply by a constant (a literal, a division by a
        constant, a decimal read as a float) or the negation of one, used
        nowhere else in the tree; else None."""
        if self.uses.get(structural_key(arg), 0) != 1:
            return None
        if r in self.products:
            x, y = self.products[r]
            return x, y, False
        if r in self.negprods:
            x, y = self.negprods[r]
            return x, y, True
        return None

    def fused(self, name, a, b, args):
        """a + b or a - b as XLA's CPU computes it under jit, when one
        operand is a contractable product: one fused multiply-add (FFMA)
        over its factors, the left operand's when both are (ROADMAP lists
        the nested shapes where XLA picks otherwise); else None."""
        for side, r in ((0, a), (1, b)):
            p = self.contractable(r, args[side])
            if p is None:
                continue
            x, y, neg = p
            if isinstance(y, tuple):
                y = self.op("LDK", y[1], aux=1)
            addend = b if side == 0 else a
            neg_prod = neg ^ (name == "minus" and side == 1)
            neg_add = name == "minus" and side == 0
            aux = (FMA_NEG_PRODUCT if neg_prod else 0) | (FMA_NEG_ADDEND if neg_add else 0)
            return self.op("FFMA", x, y, aux, c=addend)
        return None

    # -- leaves
    def column(self, c: ExprCol):
        kind = self.lane_kinds[c.idx]
        if not self.reload and c.idx in self.loaded:
            return self.loaded[c.idx], kind
        r = self.op("LD4" if kind == "i32" else "LD8", self.slot(("d", c.idx)), self.slot(("v", c.idx)))
        if not self.reload:
            self.loaded[c.idx] = r
        return r, kind

    def constant(self, k: Constant):
        v = k.scalar_value()
        if v is None:
            return self.ldk(0, False), "i64"
        if k.ret_type.is_float():
            return self.op("LDK", self.fconst(float(v)), aux=1), "f64"
        if isinstance(v, (bytes, str)):
            raise TypeError("expression program: a string constant reaches the device only as dict codes")
        v = int(v)
        return self.ldk(v), ("u64" if v > _I64_MAX else "i64")

    def fold(self, e):
        """(data bits, valid, kind) of a subtree of constants as the device
        computes it (XLA folds such a subtree before its rewrites), or
        None when it reads a column."""
        key = id(e)
        if key not in self._folded:
            cols: set = set()
            e.collect_columns(cols)
            if cols:
                self._folded[key] = None
            else:
                from ..kernels.expr_eval import expr_eval_ref

                prog = compile_program([], [ValueSpec(e)], {}, mask=False)
                outs = expr_eval_ref(prog, [], 1)
                vo = prog.values[0]
                data = int(outs[vo.data[0][1]][0])
                valid = bool(outs[vo.valid[1]][0])
                self._folded[key] = (data, valid, vo.kind)
        return self._folded[key]

    # -- casts (xp.astype)
    def as_i64(self, r, kind):
        if kind == "f64":
            return self.op("F2I", r)
        return r  # int32 codes are widened by their load; uint64 keeps its bits

    def as_f64(self, r, kind):
        if kind == "f64":
            return r
        return self.op("U2F" if kind == "u64" else "I2F", r)

    def lane_as_float(self, r, kind, ft):
        x = self.as_f64(r, kind)
        if ft.is_decimal():
            s = max(ft.decimal, 0)
            if s:  # x / 10^s under jit: x * 10^-s (x / 1 is x itself)
                x = self.fmulk(x, 1.0 / float(pow10(s)))
        return x

    def lane_as_decimal(self, r, kind, ft, target: int):
        """→ (register, kind): the lane rescaled to `target` (exact); a
        narrower target multiplies by the float 10^(target - s), as the
        reference's int64 lane times pow10 of a negative power does, and
        gives a float64 lane."""
        s = max(ft.decimal, 0) if ft.is_decimal() else 0
        x = self.as_i64(r, kind)
        if target == s:
            return x, "i64"
        if target < s:
            return self.fmulk(self.op("I2F", x), float(pow10(target - s))), "f64"
        return self.intk("IMULK", x, pow10(target - s)), "i64"

    def as_kind(self, r, kind, want):
        """A lane promoted as jnp.where promotes its operands (i64 → f64)."""
        if kind == want or want != "f64":
            return r
        return self.as_f64(r, kind)

    # -- Sethi-Ullman need
    def need(self, e) -> int:
        k = id(e)
        if k not in self._need:
            if isinstance(e, ScalarFunc) and e.args:
                ns = sorted((self.need(a) for a in e.args), reverse=True)
                self._need[k] = max(n + i for i, n in enumerate(ns))
            else:
                self._need[k] = 1
        return self._need[k]

    def args_in_order(self, args):
        """Argument indices, the most demanding first."""
        return sorted(range(len(args)), key=lambda i: -self.need(args[i]))

    def args(self, e, skip=()):
        """(register, kind) of each argument but `skip`, emitted the most
        demanding first."""
        vals = [None] * len(e.args)
        for i in self.args_in_order(e.args):
            if i not in skip:
                vals[i] = self.expr(e.args[i])
        return vals

    # -- numeric_common
    def kind_of(self, e) -> str:
        """The dtype e's data lane has in the reference, without emitting."""
        if isinstance(e, ExprCol):
            return self.lane_kinds[e.idx]
        if isinstance(e, Constant):
            v = e.scalar_value()
            if v is None:
                return "i64"
            if e.ret_type.is_float():
                return "f64"
            return "u64" if int(v) > _I64_MAX else "i64"
        name, ret = e.sig.name, e.ret_type
        fts = [a.ret_type for a in e.args]
        if name in _F64_RESULT:
            return "f64"
        if name in _I64_RESULT:
            return "i64"
        if name in ("plus", "minus", "mul", "unaryminus", "div", "mod", "round", "truncate", "if", "ifnull",
                    "coalesce", "case"):
            return "f64" if ret.is_float() else "i64"
        if name in ("ceil", "ceiling", "floor"):
            return "f64" if fts[0].is_float() else "i64"
        if name in ("abs", "nullif"):
            k = self.kind_of(e.args[0])
            return "i64" if name == "abs" and k not in ("f64", "u64", "i32") else k
        if name in ("greatest", "least"):
            dom = self.domain(e)[0]
            return "f64" if ret.is_float() or dom in (DOM_F, DOM_X) else ("u64" if dom == DOM_U else "i64")
        if name == "cast":
            if ret.is_float():
                return "f64"
            if ret.is_decimal() and not fts[0].is_float() and _scale(ret) < _scale(fts[0]):
                return "f64"
            return "i64"
        return "i64"

    def domain(self, e: ScalarFunc):
        """(domain, unsigned flags, converter) of e's args as
        numeric_common coerces them; converter(i, vreg, kind) emits arg
        i's coercion."""
        fts = [a.ret_type for a in e.args]
        kinds = [self.kind_of(a) for a in e.args]
        n = len(fts)
        if all(ft.is_string() for ft in fts):
            raise TypeError("expression program: string comparisons reach the device as dict codes")
        if any(ft.is_time() for ft in fts) and all(ft.is_time() or ft.is_string() for ft in fts):
            return DOM_I, [0] * n, lambda i, r, k: self.as_i64(r, k)
        if any(ft.is_float() or ft.is_string() for ft in fts):
            return DOM_F, [0] * n, lambda i, r, k: self.lane_as_float(r, k, fts[i])
        if any(ft.is_decimal() for ft in fts):
            scale = max(max(ft.decimal, 0) for ft in fts if ft.is_decimal())
            return DOM_I, [0] * n, lambda i, r, k: self.lane_as_decimal(r, k, fts[i], scale)[0]
        if "u64" in kinds:
            dom = DOM_U if all(k == "u64" for k in kinds) else DOM_X
            return dom, [int(k == "u64" and dom == DOM_X) for k in kinds], lambda i, r, k: r
        return DOM_I, [0] * n, lambda i, r, k: self.as_i64(r, k)

    # -- trees
    def expr(self, e: Expression):
        """→ (vreg, kind) of e's (data, valid)."""
        if isinstance(e, ExprCol):
            return self.column(e)
        if isinstance(e, Constant):
            return self.constant(e)
        if not isinstance(e, ScalarFunc):
            raise TypeError(f"expression program: {type(e).__name__} is not lowerable")
        name = e.sig.name
        if not e.sig.pushable:
            raise _fatal(f"builtin {name!r}")
        handler = getattr(self, "fn_" + name, None)
        if handler is None:
            handler = self._GROUPS.get(name)
            if handler is None:
                raise NotImplementedError(f"expression program: builtin {name!r}")
            handler = getattr(self, handler)
        r, kind = handler(e)
        assert kind == self.kind_of(e), (name, kind, self.kind_of(e))
        return r, kind

    _GROUPS = {**{p: "fn_cmp" for p in PRED}, "nulleq": "fn_cmp", "plus": "fn_arith", "minus": "fn_arith",
               "mul": "fn_arith", **{f: "fn_time_field" for f in _TIME_FIELDS},
               **{f: "fn_math1" for f in _MATH1}, **{b: "fn_bits" for b in _BITS}, "ceiling": "fn_ceil",
               "power": "fn_pow", "atan2": "fn_atan", "greatest": "fn_minmax", "least": "fn_minmax",
               "istrue": "fn_is", "isfalse": "fn_is"}

    # comparisons and logic
    def fn_cmp(self, e):
        name = e.sig.name
        dom, flags, conv = self.domain(e)
        (ra, ka), (rb, kb) = self.args(e)
        a, b = conv(0, ra, ka), conv(1, rb, kb)
        aux = dom | PRED.get(name, 0) << 2 | flags[0] << 5 | flags[1] << 6 | (name == "nulleq") << 7
        return self.op("CMP", a, b, aux), "i64"

    def fn_in(self, e):
        """`in`, one list item at a time: hit |= (a == b_j) & v_j and
        any_null |= !v_j, from hit = 0 and any_null = !v_0; then valid =
        v_0 & (hit | !any_null), data = hit."""
        dom, flags, conv = self.domain(e)
        r, k = self.expr(e.args[0])
        a = conv(0, r, k)
        acc = self.op("IN0", a)
        for j in range(1, len(e.args)):
            r, k = self.expr(e.args[j])
            nxt = self.vreg()
            self.emit("IN", nxt, a, conv(j, r, k), dom | flags[0] << 5 | flags[j] << 6, acc=acc)
            acc = nxt
        return self.op("INF", acc, a), "i64"

    def fn_and(self, e):
        (ra, ka), (rb, kb) = self.args(e)
        return self.op("AND", ra, rb, (ka == "f64") | (kb == "f64") << 1), "i64"

    def fn_or(self, e):
        (ra, ka), (rb, kb) = self.args(e)
        return self.op("OR", ra, rb, (ka == "f64") | (kb == "f64") << 1), "i64"

    def fn_xor(self, e):
        (ra, ka), (rb, kb) = self.args(e)
        return self.op("XOR", ra, rb, (ka == "f64") | (kb == "f64") << 1), "i64"

    def fn_not(self, e):
        (r, k), = self.args(e)
        return self.op("NOT", r, aux=int(k == "f64")), "i64"

    def fn_isnull(self, e):
        (r, _), = self.args(e)
        return self.op("ISNULL", r), "i64"

    def fn_is(self, e):
        (r, k), = self.args(e)
        return self.op("ISTRUE" if e.sig.name == "istrue" else "ISFALSE", r, aux=int(k == "f64")), "i64"

    # arithmetic
    def fn_arith(self, e):
        name, ret = e.sig.name, e.ret_type
        fts = [a.ret_type for a in e.args]
        vals = self.args(e)
        (ra, ka), (rb, kb) = vals
        if ret.is_float():
            a, b = (self.lane_as_float(r, k, ft) for (r, k), ft in zip(vals, fts))
            r = self.fused(name, a, b, e.args) if name != "mul" else None
            if r is not None:
                return r, "f64"
            return self.op({"plus": "FADD", "minus": "FSUB", "mul": "FMUL"}[name], a, b), "f64"
        if ret.is_decimal():
            rs = _scale(ret)
            if name == "mul":
                d = self.op("IMUL", self.as_i64(ra, ka), self.as_i64(rb, kb))
                ps = _scale(fts[0]) + _scale(fts[1])
                if ps > rs:  # the scale was capped: round half away from zero
                    if pow10(ps - rs) > _I64_MAX:  # the reference's int64 divisor overflows too
                        raise OverflowError(f"expression program: divisor 10^{ps - rs} exceeds int64")
                    d = self.op("RDIVK", d, self.const(pow10(ps - rs)))
                return d, "i64"
            a, b = (self.lane_as_decimal(r, k, ft, rs)[0] for (r, k), ft in zip(vals, fts))
            return self.op("IADD" if name == "plus" else "ISUB", a, b), "i64"
        return self.op({"plus": "IADD", "minus": "ISUB", "mul": "IMUL"}[name],
                       self.as_i64(ra, ka), self.as_i64(rb, kb)), "i64"

    def fn_unaryminus(self, e):
        (r, k), = self.args(e)
        if e.ret_type.is_float():
            x = self.lane_as_float(r, k, e.args[0].ret_type)
            neg = self.op("FNEG", x)
            p = self.contractable(x, e.args[0])
            if p is not None and not p[2]:  # -(x * y) contracts as (-x) * y
                self.negprods[neg] = p[:2]
            return neg, "f64"
        return self.op("INEG", self.as_i64(r, k)), "i64"

    def fold_float(self, f, ft, x2f: int = -1) -> float:
        """A folded constant's lane as the float domain reads it:
        lane_as_float (x2f < 0) or int2_as_float with the unsigned flag
        x2f, as the device computes them."""
        bits, _, kind = f
        if kind == "f64":
            return _bitsf(bits)
        if x2f >= 0:
            return float(bits) + (2.0 ** 64 if x2f and bits < 0 else 0.0)
        x = float(bits % (1 << 64)) if kind == "u64" else float(bits)
        if ft.is_decimal() and max(ft.decimal, 0):
            x = _daz(_daz(x) * (1.0 / float(pow10(max(ft.decimal, 0)))))
        return x

    def fdiv_const(self, a, b: float, valid: bool):
        """a / where(b == 0, 1.0, b) for a constant b, which XLA folds: a
        times the reciprocal; NULL where b == 0 or b is NULL."""
        b = _daz(b)
        x = self.fmulk(a, 1.0 / (1.0 if b == 0 else b))
        if b == 0 or not valid:
            x = self.op("VAND", x, self.ldk(0, False))
        return x

    def fn_div(self, e):
        ret = e.ret_type
        fts = [a.ret_type for a in e.args]
        if ret.is_float():
            f = self.fold(e.args[1])
            vals = self.args(e, (1,) if f is not None else ())
            a = self.lane_as_float(*vals[0], fts[0])
            if f is not None:
                return self.fdiv_const(a, self.fold_float(f, fts[1]), f[1]), "f64"
            return self.op("FDIV", a, self.lane_as_float(*vals[1], fts[1]), FDIV_GUARD), "f64"
        vals = self.args(e)
        rs, s1, s2 = _scale(ret), _scale(fts[0]), _scale(fts[1])
        num = self.as_i64(*vals[0])
        if rs - s1 + s2:
            num = self.intk("IMULK", num, pow10(rs - s1 + s2))
        return self.op("RDIV", num, self.as_i64(*vals[1])), "i64"

    def fn_intdiv(self, e):
        dom, flags, conv = self.domain(e)
        if dom not in (DOM_F, DOM_X):
            (ra, ka), (rb, kb) = self.args(e)
            return self.op("IDIV", conv(0, ra, ka), conv(1, rb, kb), IDIV_U if dom == DOM_U else IDIV_S), "i64"
        # the float domain (int2: int2_as_float of each pair): trunc(a / b)
        fts = [a.ret_type for a in e.args]
        f = self.fold(e.args[1])
        vals = self.args(e, (1,) if f is not None else ())

        def flane(i, r, k):
            return self.op("X2F", r, aux=flags[i]) if dom == DOM_X else conv(i, r, k)

        a = flane(0, *vals[0])
        if f is not None:
            q = self.fdiv_const(a, self.fold_float(f, fts[1], flags[1] if dom == DOM_X else -1), f[1])
        else:
            q = self.op("FDIV", a, flane(1, *vals[1]), FDIV_GUARD)
        return self.op("F2I", self.op("FTRUNC", q)), "i64"

    def fn_mod(self, e):
        ret = e.ret_type
        fts = [a.ret_type for a in e.args]
        if ret.is_float():  # a - trunc(a / bs) * bs, bs = where(b == 0, 1.0, b)
            f = self.fold(e.args[1])
            vals = self.args(e, (1,) if f is not None else ())
            a = self.lane_as_float(*vals[0], fts[0])
            mode, c = FDIV_MOD, -1
            if a in self.products:  # a single-use product: its factors go to the multiply-add
                a, c = self.products[a]
                if isinstance(c, tuple):
                    c = self.op("LDK", c[1], aux=1)
                mode |= FDIV_PRODUCT
            if f is None:
                b = self.lane_as_float(*vals[1], fts[1])
                return self.op("FDIV", a, b, mode, c=c), "f64"
            bk = _daz(self.fold_float(f, fts[1]))
            b = self.op("LDK", self.fconst(1.0 if bk == 0 else bk), aux=1)
            r = self.op("FDIV", a, b, mode | FDIV_MODK, c=c)
            if bk == 0 or not f[1]:
                r = self.op("VAND", r, self.ldk(0, False))
            return r, "f64"
        rs = _scale(ret)
        vals = self.args(e)
        a, b = (self.lane_as_decimal(r, k, ft, rs)[0] for (r, k), ft in zip(vals, fts))
        return self.op("IDIV", a, b, IMOD_S), "i64"

    # control flow
    def coerce(self, val, ft, ret):
        """_coerce_to: a branch lane in the merged result type."""
        r, k = val
        if ret.is_float():
            return self.lane_as_float(r, k, ft), "f64"
        if ret.is_decimal():
            return self.lane_as_decimal(r, k, ft, _scale(ret))
        if ret.is_string():
            raise TypeError("expression program: string branches reach the device only as dict codes")
        return self.as_i64(r, k), "i64"

    def branches(self, e, idx):
        """The coerced lanes of the args at `idx`, in one kind (jnp.where's
        promotion: any float64 makes every branch float64)."""
        vals = self.args(e)
        fts = [a.ret_type for a in e.args]
        lanes = {i: self.coerce(vals[i], fts[i], e.ret_type) for i in idx}
        kind = "f64" if any(k == "f64" for _, k in lanes.values()) else "i64"
        return vals, {i: self.as_kind(r, k, kind) for i, (r, k) in lanes.items()}, kind

    def sel(self, cond, a, b):
        """where((d_c != 0) & v_c, a, b) on data and valid."""
        rc, kc = cond
        return self.op("SEL", a, b, aux=int(kc == "f64") << SEL_REG_BITS, c=rc)

    def fn_if(self, e):
        vals, lanes, kind = self.branches(e, (1, 2))
        return self.sel(vals[0], lanes[1], lanes[2]), kind

    def fn_ifnull(self, e):
        _, lanes, kind = self.branches(e, (0, 1))
        return self.op("COAL", lanes[0], lanes[1]), kind

    def fn_coalesce(self, e):
        n = len(e.args)
        _, lanes, kind = self.branches(e, range(n))
        acc = lanes[n - 1]
        for i in range(n - 2, -1, -1):
            acc = self.op("COAL", lanes[i], acc)
        return acc, kind

    def fn_case(self, e):
        n = len(e.args)
        npairs, has_else = n // 2, n % 2 == 1
        idx = [2 * i + 1 for i in range(npairs)] + ([n - 1] if has_else else [])
        vals, lanes, kind = self.branches(e, idx)
        acc = lanes[n - 1] if has_else else self.ldk(0, False)  # zeros_like(then_0), all NULL
        for i in reversed(range(npairs)):
            acc = self.sel(vals[2 * i], lanes[2 * i + 1], acc)
        return acc, kind

    def fn_nullif(self, e):
        """(a, v_a & !((a == b) & v_a & v_b)), a and b compared as jnp
        promotes their raw lanes."""
        (ra, ka), (rb, kb) = self.args(e)
        kinds = {ka, kb}
        if "f64" in kinds or (kinds & {"u64"} and kinds & {"i64", "i32"}):
            eq = self.op("CMP", self.as_f64(ra, ka), self.as_f64(rb, kb), DOM_F)
        else:
            eq = self.op("CMP", ra, rb, DOM_U if kinds == {"u64"} else DOM_I)
        return self.op("NULLIF", ra, eq), ka

    # rounding and math
    def fn_abs(self, e):
        (r, k), = self.args(e)
        if k == "f64":
            return self.op("FABS", r), "f64"
        if k == "u64":
            return r, "u64"
        return self.op("IABS", r, aux=int(k == "i32")), ("i32" if k == "i32" else "i64")

    def fn_sign(self, e):
        (r, k), = self.args(e)
        return self.op("FSIGN", self.lane_as_float(r, k, e.args[0].ret_type)), "i64"

    def fn_ceil(self, e):
        return self._ceil_floor(e, "FCEIL")

    def fn_floor(self, e):
        return self._ceil_floor(e, "FFLOOR")

    def _ceil_floor(self, e, fop):
        (r, k), = self.args(e)
        ft = e.args[0].ret_type
        if ft.is_float():
            return self.op(fop, self.as_f64(r, k)), "f64"
        x = self.as_i64(r, k)
        s = _scale(ft)
        if ft.is_decimal() and s:
            if fop == "FCEIL":  # -((-x) // 10^s)
                return self.op("INEG", self.intk("IFLOORK", self.op("INEG", x), pow10(s))), "i64"
            return self.intk("IFLOORK", x, pow10(s)), "i64"
        return x, "i64"

    def const_frac(self, e) -> int:
        """ROUND / TRUNCATE's frac on the int and decimal paths: a constant
        (the reference reads it with int() on the host)."""
        f = self.fold(e.args[1])
        if f is None:
            raise _fatal("a ROUND / TRUNCATE of an integer with a per-row frac")
        bits, _, kind = f
        return int(_bitsf(bits)) if kind == "f64" else bits

    def _round_trunc(self, e, fop):
        ret, ft = e.ret_type, e.args[0].ret_type
        if ret.is_float():
            f = self.fold(e.args[1]) if len(e.args) > 1 else (0, True, "i64")
            vals = self.args(e, (1,) if f is not None and len(e.args) > 1 else ())
            x = self.lane_as_float(*vals[0], ft)
            if f is not None:  # p = 10.0 ** frac folds: x * p, then r / p as r * (1 / p)
                bits, fv, kind = f
                fr = _bitsf(bits) if kind == "f64" else float(bits % (1 << 64) if kind == "u64" else bits)
                try:
                    p = 10.0 ** fr
                except OverflowError:
                    p = math.inf
                if p != 1.0:  # XLA drops x * 1.0 and r / 1.0
                    x = self.fmulk(x, p)
                r = self.op(fop, x)
                if p != 1.0:
                    r = self.fmulk(r, 1.0 / p)
                if not fv:
                    r = self.op("VAND", r, self.ldk(0, False))
                return r, "f64"
            fr = self.as_f64(*vals[1])
            p = self.op("FUN2", self.op("LDK", self.fconst(10.0), aux=1), fr, FUN2["pow"])
            return self.op("FDIV", self.op(fop, self.op("FMUL", x, p)), p, FDIV_PLAIN), "f64"
        frac = self.const_frac(e) if len(e.args) > 1 else 0
        (r, k), *_ = self.args(e, (1,) if len(e.args) > 1 else ())
        x = self.as_i64(r, k)
        s = _scale(ft)
        if frac >= s:
            return x, "i64"
        kop = "RDIVK" if fop == "FRNDA" else "ITRUNCK"
        q = self.intk(kop, x, pow10(s - frac))
        if frac < 0:
            q = self.intk("IMULK", q, pow10(-frac))
        return q, "i64"

    def fn_round(self, e):
        return self._round_trunc(e, "FRNDA")

    def fn_truncate(self, e):
        return self._round_trunc(e, "FTRUNC")

    def fn_math1(self, e):
        (r, k), = self.args(e)
        fn, dom, after = _MATH1[e.sig.name]
        x = self.op("FUN1", self.lane_as_float(r, k, e.args[0].ret_type), aux=FUN1[fn] | dom << 4)
        return (self.fmulk(x, after) if after is not None else x), "f64"

    def fn_atan(self, e):
        fts = [a.ret_type for a in e.args]
        vals = self.args(e)
        xs = [self.lane_as_float(r, k, ft) for (r, k), ft in zip(vals, fts)]
        if len(xs) == 2:
            return self.op("FUN2", xs[0], xs[1], FUN2["atan2"]), "f64"
        return self.op("FUN1", xs[0], aux=FUN1["atan"]), "f64"

    def fn_cot(self, e):
        (r, k), = self.args(e)
        t = self.op("FUN1", self.lane_as_float(r, k, e.args[0].ret_type), aux=FUN1["tan"])
        return self.op("FDIV", self.op("LDK", self.fconst(1.0), aux=1), t), "f64"

    def fn_degrees(self, e):
        (r, k), = self.args(e)
        return self.fmulk(self.lane_as_float(r, k, e.args[0].ret_type), 180.0 / math.pi), "f64"

    def fn_radians(self, e):
        (r, k), = self.args(e)
        return self.fmulk(self.lane_as_float(r, k, e.args[0].ret_type), math.pi / 180.0), "f64"

    def fn_pi(self, e):
        return self.op("LDK", self.fconst(math.pi), aux=1), "f64"

    def fn_pow(self, e):
        """lax.pow, with XLA's rewrites of a constant exponent: 0 → 1.0,
        1 → x, 2 → x*x, 3 → x*x*x, -1 → 1/x."""
        fts = [a.ret_type for a in e.args]
        f = self.fold(e.args[1])
        vals = self.args(e, (1,) if f is not None else ())
        x = self.lane_as_float(*vals[0], fts[0])
        if f is None:
            return self.op("FUN2", x, self.lane_as_float(*vals[1], fts[1]), FUN2["pow"]), "f64"
        y = self.fold_float(f, fts[1])
        if y == 0.0:
            r = self.op("VAND", self.op("LDK", self.fconst(1.0), aux=1), x)
        elif y == 1.0:
            r = x
        elif y == 2.0:
            r = self.op("FMUL", x, x)
        elif y == 3.0:
            r = self.op("FMUL", self.op("FMUL", x, x), x)
        elif y == -1.0:
            r = self.op("FDIV", self.op("LDK", self.fconst(1.0), aux=1), x)
        else:
            r = self.op("FUN2", x, self.op("LDK", self.fconst(y), aux=1), FUN2["pow"])
        if not f[1]:
            r = self.op("VAND", r, self.ldk(0, False))
        return r, "f64"

    def fn_minmax(self, e):
        dom, flags, conv = self.domain(e)
        vals = self.args(e)
        if dom == DOM_X:  # int2_as_float of each (class, lo) pair
            lanes = [self.op("X2F", r, aux=flags[i]) for i, (r, _) in enumerate(vals)]
            dom = DOM_F
        else:
            lanes = [conv(i, r, k) for i, (r, k) in enumerate(vals)]
        op = "MAX" if e.sig.name == "greatest" else "MIN"
        acc = lanes[0]
        for x in lanes[1:]:
            acc = self.op(op, acc, x, dom)
        kind = {DOM_F: "f64", DOM_U: "u64"}.get(dom, "i64")
        if e.ret_type.is_float() and kind != "f64":
            acc, kind = self.as_f64(acc, kind), "f64"
        return acc, kind

    # time
    def fn_time_field(self, e):
        (r, k), = self.args(e)
        div, mod = _TIME_FIELDS[e.sig.name]
        x = self.as_i64(r, k)
        if div != 1:
            x = self.intk("IFLOORK", x, div)
        if mod is not None:
            x = self.intk("IMODK", x, mod)
        return x, "i64"

    def fn_date(self, e):
        (r, k), = self.args(e)
        return self.intk("IMULK", self.intk("IFLOORK", self.as_i64(r, k), _ct.DIV_DAY), _ct.DIV_DAY), "i64"

    def fn_time_to_sec(self, e):
        (r, k), = self.args(e)
        x = self.as_i64(r, k)
        if e.args[0].ret_type.tp != TypeCode.Duration:  # a datetime: the microseconds within its day
            x = self.intk("IMODK", x, _ct.DIV_DAY)
        return self.intk("IFLOORK", x, _US), "i64"

    def fn_sec_to_time(self, e):
        (r, k), = self.args(e)
        return self.intk("IMULK", self.as_i64(r, k), _US), "i64"

    # bits
    def fn_bits(self, e):
        (ra, ka), (rb, kb) = self.args(e)
        return self.op(_BITS[e.sig.name], self.as_i64(ra, ka), self.as_i64(rb, kb)), "i64"

    def fn_bitneg(self, e):
        (r, k), = self.args(e)
        return self.op("BNOT", self.as_i64(r, k)), "i64"

    # casts
    def fn_cast(self, e):
        ret, src = e.ret_type, e.args[0].ret_type
        if ret.is_string() or src.is_string():
            raise _fatal(f"a cast from {src.tp.name} to {ret.tp.name}")
        (r, k), = self.args(e)
        if ret.is_float():
            return self.lane_as_float(r, k, src), "f64"
        if ret.is_decimal():
            rs = _scale(ret)
            if src.is_float():  # x * 10^rs rounded half away from zero
                return self.op("F2I", self.op("FRNDA", self.fmulk(self.as_f64(r, k), float(pow10(rs))))), "i64"
            return self.lane_as_decimal(r, k, src, rs)
        if src.is_float():
            return self.op("F2I", self.op("FRNDA", self.as_f64(r, k))), "i64"
        x = self.as_i64(r, k)
        if src.is_decimal() and _scale(src):
            return self.intk("RDIVK", x, pow10(_scale(src))), "i64"
        return x, "i64"

    # -- outputs
    def mask(self, conds):
        m = self.op("LDB", self.slot(("mask_in",)))
        for c in conds:
            r, k = self.tree(c)
            nxt = self.vreg()
            self.emit("MASK", nxt, r, aux=int(k == "f64"), acc=m)
            m = nxt
        slot = self.out(1)
        self.emit("STB", slot, m)
        return slot

    def store(self, r, is_float: bool = False) -> tuple:
        slot = self.out(8)
        self.emit("ST8", slot, r)
        return ("out", slot, is_float)

    def store_valid(self, r) -> tuple:
        slot = self.out(1)
        self.emit("STV", slot, r)
        return ("out", slot)

    def value(self, spec: ValueSpec) -> ValueOut:
        e = spec.expr
        bare = isinstance(e, ExprCol)
        if spec.derive in ("value", "valid") and bare:
            return ValueOut([("col", e.idx)], ("col", e.idx), self.lane_kinds[e.idx])
        r, kind = self.tree(e)
        valid = ("col", e.idx) if bare else self.store_valid(r)
        if spec.derive == "valid":
            return ValueOut([], valid, kind)
        if spec.derive == "value":
            return ValueOut([self.store(r, kind == "f64")], valid, kind)
        if spec.derive == "var_dec":
            xi = self.op("ZNULL", self.as_i64(r, kind))
            ai, bi = self.op("IHI", xi), self.op("ILO", xi)
            af, bf = self.op("I2F", ai), self.op("I2F", bi)
            data = [self.store(xi), self.store(self.op("I2F", xi), True),
                    self.store(self.op("IMUL", ai, ai)), self.store(self.op("FMUL", af, af), True),
                    self.store(self.op("IMUL", ai, bi)), self.store(self.op("FMUL", af, bf), True),
                    self.store(self.op("IMUL", bi, bi)), self.store(self.op("FMUL", bf, bf), True)]
            return ValueOut(data, valid, "i64")
        if spec.derive == "var_f":
            x = self.op("ZNULL", self.as_f64(r, kind))
            return ValueOut([self.store(x, True), self.store(self.op("FMUL", x, x), True)], valid, "f64")
        if spec.derive == "bit":
            if spec.scale >= 0:  # a decimal: its value as a double first, x * 10^-s (x / 1 is x)
                x = self.as_f64(r, kind)
                if spec.scale:
                    x = self.fmulk(x, 1.0 / float(pow10(spec.scale)))
                x = self.op("RINT", x)
            elif kind == "f64":
                x = self.op("RINT", r)
            else:
                x = self.as_i64(r, kind)
            return ValueOut([self.store(x)], valid, "i64")
        raise ValueError(f"expression program: unknown derivation {spec.derive!r}")


def _count_subtrees(e, uses: dict) -> None:
    """Occurrences of each subtree of e by its structural key."""
    k = structural_key(e)
    uses[k] = uses.get(k, 0) + 1
    if isinstance(e, ScalarFunc):
        for a in e.args:
            _count_subtrees(a, uses)


def _live(code: list) -> list:
    """`code` without the ops whose value nothing reads (a product a
    multiply-add took the factors of)."""
    while True:
        read = set()
        for name, _dst, a, b, _aux, acc, c in code:
            _d, ra, rb = _REGS[name]
            read.update(v for v, isreg in ((a, ra), (b, rb), (acc, True), (c, True)) if isreg and v >= 0)
        kept = [op for op in code if not _REGS[op[0]][0] or op[1] in read]
        if len(kept) == len(code):
            return code
        code = kept


def _allocate(code: list, nv: int):
    """Physical registers by liveness; → (int32 ops [n, 5], register count).
    SEL's condition register (`c`) goes into its aux's low bits."""
    last = [-1] * nv
    for i, (name, dst, a, b, _aux, acc, c) in enumerate(code):
        _d, ra, rb = _REGS[name]
        for v, isreg in ((a, ra), (b, rb), (acc, acc >= 0), (c, c >= 0)):
            if isreg and v >= 0:
                last[v] = i
    phys = [-1] * nv
    free: list = []
    top = 0
    out = np.zeros((len(code), 5), dtype=np.int32)
    for i, (name, dst, a, b, aux, acc, c) in enumerate(code):
        rd, ra, rb = _REGS[name]
        pa = phys[a] if ra else a
        pb = phys[b] if rb else b
        if c >= 0:
            aux |= phys[c] << (FDIV_REG_SHIFT if name in ("FDIV", "FFMA") else 0)
        for v in {x for x, isreg in ((a, ra), (b, rb), (c, c >= 0)) if isreg and x >= 0}:
            if last[v] == i and v != acc:
                heapq.heappush(free, phys[v])
        if rd:
            if acc >= 0:
                phys[dst] = phys[acc]
            elif free:
                phys[dst] = heapq.heappop(free)
            else:
                phys[dst] = top
                top += 1
            pd = phys[dst]
            if last[dst] < i:  # a value nothing reads (cannot happen for outputs)
                heapq.heappush(free, pd)
        else:
            pd = dst
        out[i] = (OP[name], pd, pa, pb, aux)
    return out, top


def _compile(conds, values, lane_kinds, with_mask: bool, reload: bool, hoist: bool = False):
    em = _Emitter(lane_kinds, reload)
    mask_slot = em.mask(conds) if with_mask else None
    outs = [em.value(s) for s in values]
    code = _live(em.code)
    if hoist:  # every lane load first, in order: the kernel's load phase, ahead of any arithmetic
        code = [c for c in code if c[0] in LOADS] + [c for c in code if c[0] not in LOADS]
    ops, nregs = _allocate(code, em.nv)
    return Program(ops, np.array(em.consts, dtype=np.int64), nregs, em.inputs, em.outputs, mask_slot, outs, reload)


# ---------------------------------------------------------------- cache


def _ft_key(ft):
    return (int(ft.tp), ft.flag, ft.decimal)


def structural_key(e: Expression):
    """A key that tells apart every tree the compiler would compile
    differently (repr alone omits the FieldTypes)."""
    if isinstance(e, ExprCol):
        return ("c", e.idx, _ft_key(e.ret_type))
    if isinstance(e, Constant):
        return ("k", e.value.kind, repr(e.value.val), _ft_key(e.ret_type))
    if isinstance(e, ScalarFunc):
        return ("f", e.sig.name, _ft_key(e.ret_type), tuple(structural_key(a) for a in e.args))
    return ("?", repr(e))


def compile_program(conds, values=(), lane_kinds=None, *, mask: bool = True, max_regs: int | None = None) -> Program:
    """The program of `conds` (→ the mask, when `mask`) and the `values`
    (ValueSpec) over lanes of `lane_kinds` ({column: "i32" | "i64" | "u64"
    | "f64"}). `max_regs` caps the register file (default REG_BUDGET)."""
    lane_kinds = dict(lane_kinds or {})
    cap = REG_BUDGET if max_regs is None else max_regs
    # the loads first where the registers allow it, else each lane loaded at
    # its first use, else reloaded at each use
    for reload, hoist in ((False, True), (False, False), (True, False)):
        prog = _compile(list(conds), list(values), lane_kinds, mask, reload=reload, hoist=hoist)
        if prog.nregs <= cap:
            return prog
    raise ValueError(f"expression program: {prog.nregs} live registers exceed {cap} even with "
                     "every lane reloaded at its use")


class ProgramCache:
    """An engine's compiled programs by key (the least recently added one
    goes past `size`)."""

    def __init__(self, size: int = 1024):
        self.size = size
        self._progs: dict = {}
        self._lock = Lock()

    def get(self, conds, values, lane_kinds, mask: bool) -> Program:
        key = (tuple(structural_key(c) for c in conds),
               tuple((structural_key(s.expr), s.derive, s.scale) for s in values),
               tuple(sorted(lane_kinds.items())), mask)
        with self._lock:
            prog = self._progs.get(key)
        if prog is None:
            prog = compile_program(conds, values, lane_kinds, mask=mask)
            with self._lock:  # ranks that compiled it at once share the first one kept
                if key not in self._progs and len(self._progs) >= self.size:
                    self._progs.pop(next(iter(self._progs)))
                prog = self._progs.setdefault(key, prog)
        return prog


# ---------------------------------------------------------------- running


def lane_kind(d) -> str:
    """The compiler's kind of a device lane (xp_torch.U64 → "u64")."""
    if hasattr(d, "bits"):
        return "u64"
    return {torch.int32: "i32", torch.int64: "i64", torch.float64: "f64"}[d.dtype]


def _flat(t, n: int) -> torch.Tensor:
    t = t.bits if hasattr(t, "bits") else t
    if t.dim() == 0:
        return t.expand(n).contiguous()
    return t.reshape(-1)


def kernel():
    """kernels.expr_eval's wrapper (imported at call time: that module
    imports this one). A caller may replace this function to observe the
    launches."""
    from ..kernels.expr_eval import expr_eval

    return expr_eval


def run(prog: Program, lanes: dict, mask_in: torch.Tensor | None, n: int, force: bool = False):
    """Evaluate `prog` over `lanes` ({column: (data, valid)}; a uint64
    lane as an xp_torch.U64) and `mask_in` (bool, n rows) through
    kernels.expr_eval: one launch, or none when the program has nothing to
    compute (no mask, bare columns only) and `force` is unset.
    → (flat bool mask or None, [(flat data lanes, valid lane, kind)] per
    ValueSpec): computed lanes are flat [n] (float64 where they hold
    doubles), a bare column's data comes back flat (uint64 as its int64
    bits) and its valid lane as it was given."""
    outs = None
    if prog.launches_kernel or force:
        ins = []
        for key in prog.inputs:
            if key[0] == "mask_in":
                ins.append(_flat(mask_in, n))
            else:
                d, v = lanes[key[1]]
                ins.append(_flat(d if key[0] == "d" else v, n))
        outs = kernel()(prog, ins, n)

    def data(ref):
        if ref[0] == "out":
            t = outs[ref[1]]
            return t.view(torch.float64) if ref[2] else t
        return _flat(lanes[ref[1]][0], n)

    def valid(ref):
        return outs[ref[1]] if ref[0] == "out" else lanes[ref[1]][1]

    mask = outs[prog.mask_slot] if prog.mask_slot is not None else None
    return mask, [([data(r) for r in vo.data], valid(vo.valid), vo.kind) for vo in prog.values]


def evaluate(cache: ProgramCache, conds, values, lanes: dict, mask_in, n: int, *, mask: bool = True,
             force: bool = False):
    """The program of `conds` and `values` over the kinds of the lanes the
    trees read, from `cache`, then run (→ run's result; the mask is
    `mask_in` itself when there is no condition and nothing forces a
    launch)."""
    used: set = set()
    for e in list(conds) + [s.expr for s in values]:
        e.collect_columns(used)
    kinds = {i: lane_kind(lanes[i][0]) for i in used}
    with_mask = mask and (bool(conds) or force)
    prog = cache.get(list(conds), list(values), kinds, with_mask)
    m, vals = run(prog, lanes, mask_in, n, force=force)
    if mask and not with_mask:
        m = mask_in
    return m, vals


def kernel_tasks():
    """kernels.expr_eval_tasks's wrapper (K10's task-grid mode), imported
    at call time like `kernel`; a caller may replace it to observe the
    launches."""
    from ..kernels.grouped import expr_eval_tasks

    return expr_eval_tasks


def evaluate_tasks(cache: ProgramCache, conds, values, lanes: list, masks_in: list, width: int, *,
                   force: bool = False):
    """`evaluate` for the G tasks of a launch group (K10): one program,
    from the first task's lane kinds (the group's tasks share them: the
    program key carries every lane's codec and dtype), launched once over
    every task's first `width` rows. `lanes[g]` and `masks_in[g]` are task
    g's. → (mask, values): the mask is a [G, width] tensor when the
    program computes it, else the tasks' `masks_in`; values[g] is task
    g's list of (flat data lanes, valid lane, kind) per ValueSpec, a
    computed lane being row g of its [G, width] output and a bare column
    the task's own lane."""
    used: set = set()
    for e in list(conds) + [s.expr for s in values]:
        e.collect_columns(used)
    kinds = {i: lane_kind(lanes[0][i][0]) for i in used}
    with_mask = bool(conds) or force
    prog = cache.get(list(conds), list(values), kinds, with_mask)
    outs = None
    if prog.launches_kernel or force:
        ins = []
        for task, mask_in in zip(lanes, masks_in):
            row = []
            for key in prog.inputs:
                if key[0] == "mask_in":
                    row.append(_flat(mask_in, width))
                else:
                    d, v = task[key[1]]
                    row.append(_flat(d if key[0] == "d" else v, width))
            ins.append(row)
        outs = kernel_tasks()(prog, ins, width)

    def per_task(g, task):
        def data(ref):
            if ref[0] == "out":
                t = outs[ref[1]][g]
                return t.view(torch.float64) if ref[2] else t
            return _flat(task[ref[1]][0], width)

        def valid(ref):
            return outs[ref[1]][g] if ref[0] == "out" else task[ref[1]][1]

        return [([data(r) for r in vo.data], valid(vo.valid), vo.kind) for vo in prog.values]

    mask = outs[prog.mask_slot] if prog.mask_slot is not None else list(masks_in)
    return mask, [per_task(g, task) for g, task in enumerate(lanes)]
