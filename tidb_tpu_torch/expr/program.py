"""The expression compiler of the port: a rewritten expression tree → a
typed register program that one kernel launch interprets per row
(kernels/expr_eval.py, csrc/expr_eval.cu).

The reference evaluates a tree by calling every builtin's array kernel
over jax.numpy inside its fused program (tidb_tpu/copr/tpu_engine.py:1021
`_eval_device`, :1044 `_mask`; the MPP scan stage, post-join masks and
aggregate arguments, parallel/mpp.py:1431, :1557, :1649, :1678, :1879,
:2050). Every decision those kernels make from dtypes and FieldTypes at
run time (expr/builtins.py, expression.numeric_common) is made here once,
by the same rules:

  * the comparison domain of `numeric_common`: int (signed int64), uint
    (all operands BIGINT UNSIGNED: unsigned order), int2 (mixed signed
    and unsigned: exact (class, lo) order), dec:<scale> (`lane_as_decimal`
    rescales by 10^k, wrapping), float (`lane_as_float`: an IEEE division
    of the int64 lane, as a double, by the exact double 10^s);
  * arithmetic by the result type `infer_arith` gave: float, decimal (a
    product past the capped scale rounds half away from zero,
    `_round_div`) or int64 with two's-complement wrap;
  * SQL's three-valued `and` / `or` / `not`, `isnull`, `nulleq` and n-ary
    `in` with its NULL rule;
  * 0-d constants: a NULL literal is int64 0 with valid False, a BIGINT
    UNSIGNED literal above 2^63 - 1 is a uint64, a float literal float64.

Floats follow XLA's CPU arithmetic, which the reference runs under:
subnormal operands read as zero of their sign and subnormal results are
flushed (so `f > 0` is false for f = 5e-324), negation flips the sign bit
only, and no multiply-add is contracted.

A program computes, in one pass over the rows:

  * optionally the mask `mask_in & v_c & (d_c != 0)` over a list of
    conditions (`mask_in` is the row validity, or the mask so far);
  * any number of value outputs (`ValueSpec`): an expression's (data,
    valid) lanes — an aggregate argument, a TopN key — or the lanes the
    aggregation kernel reads for it: `var_dec` (the decimal limbs of
    var / stddev), `var_f` (x, x*x) and `bit` (the saturating rint of a
    bit_and / bit_or / bit_xor argument: NaN → 0, x >= 2^63 → INT64_MAX,
    x <= -2^63 → INT64_MIN, round half to even otherwise; a decimal is
    divided by 10^s first).

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

An engine keeps its programs in a `ProgramCache`, keyed by the trees'
structure (every node's FieldType included), the lane kinds and the
options, as the reference keeps one program per key
(tpu_engine.py:1052); a program keeps its device copy per device
(`Program.tables`), so a warm query compiles and uploads nothing.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from threading import Lock

import numpy as np
import torch

from ..mysqltypes.mydecimal import pow10
from .expression import Column as ExprCol, Constant, Expression, ScalarFunc

# opcodes; the csrc/expr_eval.cu enum holds the same numbers
OP = {name: i for i, name in enumerate((
    "NOP", "LD8", "LD4", "LDB", "LDK", "I2F", "U2F", "F2I", "RINT", "FDIVK", "IMULK", "RDIVK",
    "IADD", "ISUB", "IMUL", "FADD", "FSUB", "FMUL", "INEG", "FNEG", "CMP", "IN0", "IN", "INF",
    "AND", "OR", "NOT", "ISNULL", "MASK", "ZNULL", "IHI", "ILO", "ST8", "STV", "STB"))}
# CMP domains and predicates (aux = dom | pred << 2 | ua << 5 | ub << 6 | nulleq << 7)
DOM_I, DOM_U, DOM_F, DOM_X = 0, 1, 2, 3
PRED = {"eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5}

# which fields of an op name registers: (dst, a, b); an accumulator op
# (IN, MASK) also reads dst, which the emitter records as `acc`
_REGS = {
    "LD8": (1, 0, 0), "LD4": (1, 0, 0), "LDB": (1, 0, 0), "LDK": (1, 0, 0),
    "FDIVK": (1, 1, 0), "IMULK": (1, 1, 0), "RDIVK": (1, 1, 0), "MASK": (1, 1, 0),
    "ST8": (0, 1, 0), "STV": (0, 1, 0), "STB": (0, 1, 0),
}
for _n in ("I2F", "U2F", "F2I", "RINT", "INEG", "FNEG", "NOT", "ISNULL", "ZNULL", "IHI", "ILO", "IN0"):
    _REGS[_n] = (1, 1, 0)
for _n in ("IADD", "ISUB", "IMUL", "FADD", "FSUB", "FMUL", "CMP", "AND", "OR", "IN", "INF"):
    _REGS[_n] = (1, 1, 1)

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


class _Emitter:
    def __init__(self, lane_kinds: dict, reload: bool):
        self.lane_kinds = lane_kinds
        self.reload = reload
        self.code: list = []  # [name, dst, a, b, aux, acc]
        self.nv = 0
        self.consts: list = []
        self.const_at: dict = {}
        self.inputs: list = []
        self.input_at: dict = {}
        self.outputs: list = []
        self.loaded: dict = {}  # col -> vreg (lanes held in registers)
        self._need: dict = {}

    # -- plumbing
    def vreg(self) -> int:
        self.nv += 1
        return self.nv - 1

    def emit(self, name, dst=-1, a=-1, b=-1, aux=0, acc=-1):
        self.code.append([name, dst, a, b, aux, acc])
        return dst

    def op(self, name, a=-1, b=-1, aux=0):
        return self.emit(name, self.vreg(), a, b, aux)

    def const(self, bits: int) -> int:
        bits = ((int(bits) + (1 << 63)) % (1 << 64)) - (1 << 63)
        if bits not in self.const_at:
            self.const_at[bits] = len(self.consts)
            self.consts.append(bits)
        return self.const_at[bits]

    def fconst(self, x: float) -> int:
        return self.const(int(np.array(x, dtype=np.float64).view(np.int64)))

    def slot(self, key) -> int:
        if key not in self.input_at:
            self.input_at[key] = len(self.inputs)
            self.inputs.append(key)
        return self.input_at[key]

    def out(self, width: int) -> int:
        self.outputs.append(width)
        return len(self.outputs) - 1

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
            return self.op("LDK", self.const(0), aux=0), "i64"
        if k.ret_type.is_float():
            return self.op("LDK", self.fconst(float(v)), aux=1), "f64"
        if isinstance(v, (bytes, str)):
            raise TypeError("expression program: a string constant reaches the device only as dict codes")
        v = int(v)
        return self.op("LDK", self.const(v), aux=1), ("u64" if v > _I64_MAX else "i64")

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
            if s:  # x / 1 is x itself
                x = self.op("FDIVK", x, self.fconst(float(pow10(s))))
        return x

    def lane_as_decimal(self, r, kind, ft, target: int):
        s = max(ft.decimal, 0) if ft.is_decimal() else 0
        x = self.as_i64(r, kind)
        if target == s:
            return x
        if target < s:
            raise ValueError(f"expression program: decimal scale {s} narrowed to {target}")
        return self.op("IMULK", x, self.const(pow10(target - s)))

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
        if e.sig.name in ("plus", "minus", "mul", "unaryminus") and e.ret_type.is_float():
            return "f64"
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
            return DOM_I, [0] * n, lambda i, r, k: self.lane_as_decimal(r, k, fts[i], scale)
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
        if name == "in":
            return self.in_list(e)
        cmp = name in PRED or name == "nulleq"
        if cmp:
            dom, flags, conv = self.domain(e)
        vals = [None] * len(e.args)
        for i in self.args_in_order(e.args):
            r, k = self.expr(e.args[i])
            vals[i] = (conv(i, r, k), k) if cmp else (r, k)
        fts = [a.ret_type for a in e.args]
        ret = e.ret_type
        if cmp:
            (a, _), (b, _) = vals
            aux = dom | PRED.get(name, 0) << 2 | flags[0] << 5 | flags[1] << 6 | (name == "nulleq") << 7
            return self.op("CMP", a, b, aux), "i64"
        if name in ("plus", "minus", "mul"):
            (ra, ka), (rb, kb) = vals
            if ret.is_float():
                a, b = (self.lane_as_float(r, k, ft) for (r, k), ft in zip(vals, fts))
                return self.op({"plus": "FADD", "minus": "FSUB", "mul": "FMUL"}[name], a, b), "f64"
            if ret.is_decimal():
                rs = max(ret.decimal, 0)
                if name == "mul":
                    d = self.op("IMUL", self.as_i64(ra, ka), self.as_i64(rb, kb))
                    ps = sum(max(ft.decimal, 0) if ft.is_decimal() else 0 for ft in fts)
                    if ps > rs:  # the scale was capped: round half away from zero
                        if pow10(ps - rs) > _I64_MAX:  # the reference's int64 divisor overflows too
                            raise OverflowError(f"expression program: divisor 10^{ps - rs} exceeds int64")
                        d = self.op("RDIVK", d, self.const(pow10(ps - rs)))
                    return d, "i64"
                a, b = (self.lane_as_decimal(r, k, ft, rs) for (r, k), ft in zip(vals, fts))
                return self.op("IADD" if name == "plus" else "ISUB", a, b), "i64"
            return self.op({"plus": "IADD", "minus": "ISUB", "mul": "IMUL"}[name],
                           self.as_i64(ra, ka), self.as_i64(rb, kb)), "i64"
        if name == "unaryminus":
            (r, k), = vals
            if ret.is_float():
                return self.op("FNEG", self.lane_as_float(r, k, fts[0])), "f64"
            return self.op("INEG", self.as_i64(r, k)), "i64"
        if name in ("and", "or"):
            (ra, ka), (rb, kb) = vals
            return self.op("AND" if name == "and" else "OR", ra, rb, (ka == "f64") | (kb == "f64") << 1), "i64"
        if name == "not":
            (r, k), = vals
            return self.op("NOT", r, aux=int(k == "f64")), "i64"
        if name == "isnull":
            (r, _), = vals
            return self.op("ISNULL", r), "i64"
        raise NotImplementedError(f"expression program: builtin {name!r}")

    def in_list(self, e: ScalarFunc):
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

    # -- outputs
    def mask(self, conds):
        m = self.op("LDB", self.slot(("mask_in",)))
        for c in conds:
            r, k = self.expr(c)
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
        r, kind = self.expr(e)
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
            if spec.scale >= 0:  # a decimal: its value as a double first (x / 1 is x)
                x = self.as_f64(r, kind)
                if spec.scale:
                    x = self.op("FDIVK", x, self.fconst(float(pow10(spec.scale))))
                x = self.op("RINT", x)
            elif kind == "f64":
                x = self.op("RINT", r)
            else:
                x = self.as_i64(r, kind)
            return ValueOut([self.store(x)], valid, "i64")
        raise ValueError(f"expression program: unknown derivation {spec.derive!r}")


def _allocate(code: list, nv: int):
    """Physical registers by liveness; → (int32 ops [n, 5], register count)."""
    last = [-1] * nv
    for i, (name, dst, a, b, _aux, acc) in enumerate(code):
        _d, ra, rb = _REGS[name]
        for v, isreg in ((a, ra), (b, rb), (acc, acc >= 0)):
            if isreg and v >= 0:
                last[v] = i
    phys = [-1] * nv
    free: list = []
    top = 0
    out = np.zeros((len(code), 5), dtype=np.int32)
    for i, (name, dst, a, b, aux, acc) in enumerate(code):
        rd, ra, rb = _REGS[name]
        pa = phys[a] if ra else a
        pb = phys[b] if rb else b
        for v in {x for x, isreg in ((a, ra), (b, rb)) if isreg and x >= 0}:
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
    code = em.code
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
