"""K8: stable lexicographic sort permutation over key operands.

Replaces tidb_tpu/copr/tpu_engine.py:195-208 lex_sort_perm: operands are
given most significant first, rows that tie on all of them keep their
row order. The CUDA kernels are csrc/lex_sort.cu (a one-sweep LSD radix
sort over packed composite words: an up-front histogram per word, then
one launch per 8-bit pass with decoupled look-back; 4-byte keys for a
word of at most 32 bits; its note says what bounds it);
`lex_sort_perm_ref` is the plain PyTorch version beside it (one stable
torch.sort per operand, least significant first — the reference's own
recipe).

An operand is a `SortOp(data [N], kind)`, or a tensor / xp_torch.U64 that
`sort_op` turns into one:

  * "i32" — int32 (flags, dict codes); bool/int8/int16 widen to it
  * "i64" — int64 (ints, scaled decimals, packed dates, bit-cast keys)
  * "u64" — uint64 carried as int64 bit patterns, ordered unsigned
  * "f64" — float64 in lax.sort's order: -0.0 == +0.0, every NaN equal
            and after +inf; subnormals equal zero, as XLA's flushed
            x == 0 test in that fold makes them

`lex_sort_perm` returns the int32 permutation. It takes the plain version
only for tensors on the CPU. On a CUDA device it launches the kernels or
raises; `lex_sort_perm.launches` counts its calls that launched.

`launch(ops, n, task_width)` is the kernels' driver, shared with K8's
task-leading mode (kernels/grouped.py `lex_sort_perm_tasks`: G tasks'
rows, [G, task_width], sorted by (task, operands) in one radix sort).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..expr.xp_torch import U64
from .build import count, library
from .tables import sm_count

KINDS = {"i32": 0, "i64": 1, "u64": 2, "f64": 3}
TASK_KIND = 4  # a word field holding the row's task, row / task_width (K_TASK)
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
DBL_MIN = 2.2250738585072014e-308  # smallest normal float64


@dataclass
class SortOp:
    data: torch.Tensor  # [N]: int32 for "i32", float64 for "f64", int64 otherwise
    kind: str


def sort_op(x) -> SortOp:
    """A tensor, U64 or SortOp as a SortOp (see the module doc)."""
    if isinstance(x, SortOp):
        return x
    if isinstance(x, U64):
        return SortOp(x.bits, "u64")
    if x.dtype == torch.float64:
        return SortOp(x, "f64")
    if x.dtype == torch.float32:
        return SortOp(x.to(torch.float64), "f64")
    if x.dtype == torch.int64:
        return SortOp(x, "i64")
    if x.dtype == torch.int32:
        return SortOp(x, "i32")
    if x.dtype in (torch.bool, torch.int8, torch.int16, torch.uint8):
        return SortOp(x.to(torch.int32), "i32")
    raise TypeError(f"lex_sort: no sort order for {x.dtype}")


def ordered_key(op: SortOp) -> torch.Tensor:
    """int64 whose signed order is the operand's sort order (the plain
    form of the kernel's order-preserving unsigned key, xor 2^63)."""
    d = op.data
    if op.kind in ("i32", "i64"):
        return d.to(torch.int64)
    if op.kind == "u64":
        return d ^ _I64_MIN
    x = torch.where(d.abs() < DBL_MIN, torch.zeros((), dtype=d.dtype, device=d.device), d)
    x = torch.where(torch.isnan(x), torch.full((), float("nan"), dtype=d.dtype, device=d.device), x)
    b = x.view(torch.int64)
    return torch.where(b < 0, b ^ _I64_MAX, b)


def _check(ops: list[SortOp]) -> int:
    if not ops:
        raise ValueError("lex_sort: no operands")
    n = ops[0].data.shape[0]
    for op in ops:
        if op.kind not in KINDS:
            raise ValueError(f"lex_sort: unknown kind {op.kind!r}")
        want = {"i32": torch.int32, "f64": torch.float64}.get(op.kind, torch.int64)
        if op.data.dtype != want or op.data.shape != (n,):
            raise ValueError(f"lex_sort: a {op.kind} operand must be {want} [{n}], "
                             f"got {op.data.dtype} {tuple(op.data.shape)}")
    return n


def lex_sort_perm_ref(ops) -> torch.Tensor:
    """Plain PyTorch version: successive stable single-key sorts."""
    ops = [sort_op(o) for o in ops]
    n = _check(ops)
    perm = torch.arange(n, dtype=torch.int64, device=ops[0].data.device)
    for op in reversed(ops):
        idx = torch.sort(ordered_key(op)[perm], stable=True).indices
        perm = perm[idx]
    return perm.to(torch.int32)


class Word(NamedTuple):
    """One composite word of the radix plan: its fields (operand,
    src_shift, width, dst_shift), least significant first, and its bits."""

    fields: list
    bits: int

    @property
    def key_bytes(self) -> int:
        """The bytes of the word's keys in the kernels: 4 when it fits 32 bits
        (a pass then moves 8 bytes a row less), else 8."""
        return 4 if self.bits <= 32 else 8

    @property
    def passes(self) -> int:
        return (self.bits + 7) // 8


def plan_words(orand: np.ndarray, task_bits: int = 0) -> list[Word]:
    """Composite words from each operand's (OR, AND) of ordered keys.

    → [Word(fields, bits)], least significant word first; a field is
    (operand, src_shift, width, dst_shift): the operand's varying bit
    range lo..hi, packed above the less significant operands' fields.
    A constant operand gets no field; a word never splits a field. With
    `task_bits`, the row's task (operand -1) is the most significant
    field, `task_bits` wide, at the top of the word's used bits (so in a
    word of at most 32 bits it stays below bit 32). No operand varying →
    [] (row order is the sorted order, within each task too)."""
    words, fields, used = [], [], 0

    def add(k, lo, width):
        nonlocal fields, used
        if used + width > 64:
            words.append(Word(fields, used))
            fields, used = [], 0
        fields.append((k, lo, width, used))
        used += width

    for k in reversed(range(len(orand) // 2)):
        vary = int(orand[2 * k]) ^ int(orand[2 * k + 1])
        if vary:
            lo = (vary & -vary).bit_length() - 1
            add(k, lo, vary.bit_length() - lo)
    if not fields:
        return []
    if task_bits:
        add(-1, 0, task_bits)
    words.append(Word(fields, used))
    return words


def op_table(ops: list[SortOp]) -> np.ndarray:
    """int64 [nops, 2] (address, kind): the host array tt_lex_orand hands to
    its kernel as parameters."""
    return np.array([[op.data.data_ptr(), KINDS[op.kind]] for op in ops], dtype=np.int64).reshape(-1, 2)


def field_table(ops: list[SortOp], words: list[Word]) -> tuple[np.ndarray, list[int]]:
    """Every word's field descriptors in ONE int64 [F, 3] table — (address
    or 0 for the task field, kind | src_shift << 32, width | dst_shift <<
    32), csrc/lex_sort.cu's FieldDesc — words in plan order; and each
    word's first row in it. The call uploads it in one pinned copy."""
    rows, offs = [], []
    for word in words:
        offs.append(len(rows))
        for k, src, width, dst in word.fields:
            rows.append([0, TASK_KIND, width | (dst << 32)] if k < 0 else
                        [ops[k].data.data_ptr(), KINDS[ops[k].kind] | (src << 32), width | (dst << 32)])
    return np.array(rows, dtype=np.int64).reshape(-1, 3), offs


_bound: set = set()


def _lib():
    lib = library("lex_sort")
    if "lex_sort" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_lex_flags_len.argtypes = [L]
        lib.tt_lex_flags_len.restype = L
        lib.tt_lex_orand.argtypes = [C, I, L, C, I, C]
        lib.tt_lex_orand.restype = I
        lib.tt_lex_sort_word.argtypes = [C, I, I, I, L, L, C, C, C, C, C, C, C, C, I, C, I, I, C]
        lib.tt_lex_sort_word.restype = I
        _bound.add("lex_sort")
    return lib


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"lex_sort: {what} launch failed (cudaError {rc})")


def check_on(ops: list[SortOp], what: str = "lex_sort") -> int:
    """The operands' row count, each checked as the kernels read it: one
    CUDA device, contiguous, fewer than 2^31 rows."""
    n = _check(ops)
    dev = ops[0].data.device
    for op in ops:
        if op.data.device != dev or not op.data.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous tensors on {dev}")
    if n >= 1 << 31:
        raise ValueError(f"{what}: {n} rows exceed the int32 row ids")
    return n


def launch(ops: list[SortOp], n: int, task_width: int, counted, orand: np.ndarray | None = None,
           keys: bool = False):
    """The kernels over checked CUDA operands → int32 [n] permutation. With
    `task_width`, the rows are n / task_width tasks of task_width rows and
    sort by (task, operands) (the task-leading mode). `counted` is the
    wrapper whose launches the call counts, after the one host read.
    `orand` (uint64 [2 * len(ops)]: each operand's OR and AND of ordered
    keys, as tt_lex_orand computes them) comes from a caller that has read
    them already (csrc/compact.cuh's compaction): the call then makes no
    host read of its own. With `keys`, the call returns (permutation,
    sorted keys, key bytes): where the plan is one word, that word's keys
    in sorted order (uint32 or uint64 as int32 / int64 [n], in the call's
    buffer; two rows' keys are equal exactly when every operand is), else
    None.

    Per call: one read of the OR/AND (the pass count follows the data) and
    one upload of every word's fields, both through one pinned buffer; one
    device buffer for the OR/AND, the fields, the zeroed scratch (the
    up-front counts, the tile counters, the look-back flags), the keys and
    the row ids; then per word one build_keys launch and one launch per
    8-bit pass."""
    dev = ops[0].data.device
    lib = _lib()
    cs = torch.cuda.current_stream(dev)
    stream = cs.cuda_stream
    n_sms = sm_count(dev)
    nops = len(ops)
    nf = 3 * (nops + 1)  # at most one field an operand, and the task's
    max_passes = 8 * (nops + 1)
    flags_len = lib.tt_lex_flags_len(n)
    # int64 slots of `buf`: OR/AND, fields, then the scratch — counts (uint32
    # [passes, 256]), tile counters (uint32 [passes]), flags — then two
    # key arrays, two row-id arrays and a permutation for a middle word
    zero0 = 2 * nops + nf
    keys0 = zero0 + 128 * max_passes + max_passes // 2 + flags_len
    buf = torch.empty(keys0 + 2 * n + n + (n + 1) // 2, dtype=torch.int64, device=dev)
    base = buf.data_ptr()
    pin = torch.empty(2 * nops + nf, dtype=torch.int64, pin_memory=True)
    if orand is None:
        desc = op_table(ops)  # kept alive through the call: the launch copies it into kernel parameters
        _raise(lib.tt_lex_orand(desc.ctypes.data, nops, n, base, n_sms, stream), "orand")
        pin[:2 * nops].copy_(buf[:2 * nops], non_blocking=True)
        cs.synchronize()  # the one host read
        orand = pin[:2 * nops].numpy().view(np.uint64)
    tasks = n // task_width if task_width else 1
    words = plan_words(orand, (tasks - 1).bit_length())
    count(counted)
    if not words or n == 0:  # every operand constant: row order is the sorted order
        perm = torch.arange(n, dtype=torch.int32, device=dev)
        return (perm, None, 0) if keys else perm
    table, offs = field_table(ops, words)
    pin.numpy()[2 * nops:2 * nops + table.size] = table.reshape(-1)
    buf[2 * nops:2 * nops + table.size].copy_(pin[2 * nops:2 * nops + table.size], non_blocking=True)  # the one upload
    buf[zero0:zero0 + 128 * max_passes + max_passes // 2 + flags_len].zero_()
    counts, ctrs, flags = 8 * zero0, 8 * zero0 + 1024 * max_passes, 8 * (keys0 - flags_len)
    key_at, vals, mid = 8 * keys0, 8 * (keys0 + 2 * n), 8 * (keys0 + 3 * n)
    perm_out = torch.empty(n, dtype=torch.int32, device=dev)
    keep = keys and len(words) == 1
    perm = 0
    for j, word in enumerate(words):
        # the words alternate between the two permutations, the last into perm_out
        out = perm_out.data_ptr() if (len(words) - 1 - j) % 2 == 0 else base + mid
        done = sum(w.passes for w in words[:j])
        _raise(lib.tt_lex_sort_word(
            base + 8 * 2 * nops + 24 * offs[j], len(word.fields), word.bits, word.key_bytes, n, task_width or n,
            perm, base + key_at, base + key_at + 8 * n, base + vals, base + vals + 4 * n, base + counts + 1024 * done,
            base + ctrs + 4 * done, base + flags, done, out, int(keep), n_sms, stream), "sort word")
        perm = out
    if not keys:
        return perm_out
    if not keep:
        return perm_out, None, 0
    # the last pass wrote the keys into key_b after an odd number of passes
    at = keys0 + (n if words[0].passes % 2 else 0)
    kb = words[0].key_bytes
    sk = buf[at:at + n]
    return perm_out, (sk.view(torch.int32)[:n] if kb == 4 else sk), kb


def lex_sort_perm(ops) -> torch.Tensor:
    """int32 [N] stable lexicographic permutation (module doc)."""
    ops = [sort_op(o) for o in ops]
    dev = ops[0].data.device
    if dev.type == "cpu":
        return lex_sort_perm_ref(ops)
    if dev.type != "cuda":
        raise ValueError(f"lex_sort: unsupported device {dev}")
    return launch(ops, check_on(ops), 0, lex_sort_perm)


lex_sort_perm.launches = 0
