"""K8: stable lexicographic sort permutation over key operands.

Replaces tidb_tpu/copr/tpu_engine.py:195-208 lex_sort_perm: operands are
given most significant first, rows that tie on all of them keep their
row order. The CUDA kernels are csrc/lex_sort.cu (an LSD radix sort over
packed composite words; its note says what bounds it);
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

import numpy as np
import torch

from ..expr.xp_torch import U64
from .build import count, library

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


def plan_words(orand: np.ndarray, task_bits: int = 0) -> list[tuple[list[tuple[int, int, int, int]], int]]:
    """Composite words from each operand's (OR, AND) of ordered keys.

    → [(fields, bits)], least significant word first; a field is
    (operand, src_shift, width, dst_shift): the operand's varying bit
    range lo..hi, packed above the less significant operands' fields.
    A constant operand gets no field; a word never splits a field. With
    `task_bits`, the row's task (operand -1) is the most significant
    field, `task_bits` wide. No operand varying → [] (row order is the
    sorted order, within each task too)."""
    words, fields, used = [], [], 0

    def add(k, lo, width):
        nonlocal fields, used
        if used + width > 64:
            words.append((fields, used))
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
    words.append((fields, used))
    return words


_bound: set = set()


def _lib():
    lib = library("lex_sort")
    if "lex_sort" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_lex_counts_len.argtypes = [L]
        lib.tt_lex_counts_len.restype = L
        lib.tt_lex_orand.argtypes = [C, I, L, C, I, C]
        lib.tt_lex_orand.restype = I
        lib.tt_lex_sort_word.argtypes = [C, I, I, L, L, C, C, C, C, C, C, C, C, I, C]
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


def launch(ops: list[SortOp], n: int, task_width: int, counted) -> torch.Tensor:
    """The kernels over checked CUDA operands → int32 [n] permutation. With
    `task_width`, the rows are n / task_width tasks of task_width rows and
    sort by (task, operands) (the task-leading mode). `counted` is the
    wrapper whose launches the call counts, after the one sync."""
    dev = ops[0].data.device
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    desc = torch.tensor([[op.data.data_ptr(), KINDS[op.kind]] for op in ops], dtype=torch.int64).to(dev)
    orand = torch.empty(2 * len(ops), dtype=torch.int64, device=dev)
    _raise(lib.tt_lex_orand(desc.data_ptr(), len(ops), n, orand.data_ptr(), n_sms, stream), "orand")
    tasks = n // task_width if task_width else 1
    # the one sync: pass count follows the data
    words = plan_words(orand.cpu().numpy().view(np.uint64), (tasks - 1).bit_length())
    count(counted)
    if not words or n == 0:  # every operand constant: row order is the sorted order
        return torch.arange(n, dtype=torch.int32, device=dev)
    key_a = torch.empty(n, dtype=torch.int64, device=dev)
    key_b = torch.empty_like(key_a)
    val_a = torch.empty(n, dtype=torch.int32, device=dev)
    val_b = torch.empty_like(val_a)
    counts = torch.empty(lib.tt_lex_counts_len(n), dtype=torch.int32, device=dev)
    totals = torch.empty(256, dtype=torch.int32, device=dev)
    perms = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    perm = None
    for j, (fields, bits) in enumerate(words):
        fd = torch.tensor([[0, TASK_KIND, width | (dst << 32)] if k < 0 else
                           [ops[k].data.data_ptr(), KINDS[ops[k].kind] | (src << 32), width | (dst << 32)]
                           for k, src, width, dst in fields], dtype=torch.int64).to(dev)
        out = perms[j % 2]
        _raise(lib.tt_lex_sort_word(
            fd.data_ptr(), len(fields), bits, n, task_width or n, 0 if perm is None else perm.data_ptr(),
            key_a.data_ptr(), key_b.data_ptr(), val_a.data_ptr(), val_b.data_ptr(),
            counts.data_ptr(), totals.data_ptr(), out.data_ptr(), n_sms, stream), "sort word")
        perm = out
    return perm


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
