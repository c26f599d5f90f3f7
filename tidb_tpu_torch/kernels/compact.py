"""Sentinel-last sorts: the compaction that P4 (kernels/sort_join.py), P5
(kernels/seg_reduce.py) and K9 (kernels/sort_groups.py) run before K8.

A stable sort of an operand whose masked rows all hold the sentinel, its
largest value, is the same permutation as: the rows whose operand is not
the sentinel, stably sorted among themselves, then the sentinel rows in
row order. A valid row whose operand equals the sentinel sorts among the
sentinel rows (the reference's jnp.argsort does the same), so the rows
are split on `operand != sentinel`, not on the mask.

On the card the split is csrc/compact.cuh's one pass, fused into the
kernel that computes the operand: it writes the kept operands and their
row ids in row order (`comp`, `crow`), the other rows' ids (`tail`, where
the caller needs them), and `res` = (M, OR, AND of the kept operands'
order-preserving keys). `read(res)` brings M and the OR/AND up in one
pinned copy (`workspace` gives a call's internal arrays one allocation);
`sort_kept` (one operand) and `sort_kept_ops` (several: K9's, whose
compaction keeps the masked-in rows, kernels/sort_groups.py) hand the
OR/AND to K8 (kernels/lex_sort.launch),
which then makes no host read of its own and sorts M rows in only the
bits they vary in. `sentinel_last_perm_ref` is the plain form of the
whole permutation.
"""

from __future__ import annotations

import numpy as np
import torch

from .lex_sort import SortOp, launch, lex_sort_perm


def sentinel_last_perm_ref(key: torch.Tensor, sentinel: int) -> torch.Tensor:
    """int64 [N]: the rows whose key is not `sentinel` stably sorted by key,
    then the others in row order — torch.sort(key, stable=True).indices
    when `sentinel` is the key's largest value."""
    keep = key != sentinel
    rows = torch.nonzero(keep).flatten()
    kept = rows[torch.sort(key[rows], stable=True).indices]
    return torch.cat([kept, torch.nonzero(~keep).flatten()])


def workspace(dev: torch.device, sizes: list[int]) -> tuple[torch.Tensor, list[int]]:
    """One int64 device buffer for a call's internal arrays, one allocation
    for all of them: (the buffer, each array's word offset in it); every
    array starts on a 16-byte boundary."""
    offs, at = [], 0
    for b in sizes:
        offs.append(at)
        at += -(-b // 16) * 2
    return torch.empty(max(at, 2), dtype=torch.int64, device=dev), offs


def fetch(words: torch.Tensor, behind=None) -> np.ndarray:
    """int64 `words` (a few, on the card) on the host: one pinned copy, the
    host waiting on its event alone. `behind()` enqueues work that needs
    none of them after the copy: the card runs it while the host goes on."""
    pin = torch.empty(words.numel(), dtype=torch.int64, pin_memory=True)
    pin.copy_(words, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(words.device))
    if behind is not None:
        behind()
    copied.synchronize()
    return pin.numpy().copy()


def read(res: torch.Tensor, behind=None) -> tuple[int, np.ndarray]:
    """(M, uint64 [OR, AND, ...]) from the compaction's `res`: the call's
    one host read (`fetch`)."""
    words = fetch(res, behind)
    return int(words[0]), words[1:].view(np.uint64)


def sort_kept(comp: torch.Tensor, m: int, orand: np.ndarray) -> torch.Tensor:
    """K8 over the M kept operands comp[:M] (int64), with the OR/AND the
    compaction read: int32 [M], positions into comp. Counted as a
    lex_sort_perm launch."""
    return launch([SortOp(comp[:m], "i64")], m, 0, lex_sort_perm, orand=orand)


def sort_kept_ops(ops: list, m: int, orand: np.ndarray):
    """K8 over several kept operands ([M] each, most significant first)
    with their OR/AND (uint64 [2 * len(ops)]) → (int32 [M] positions into
    them, K8's sorted word or None, its key bytes): the word where K8's plan
    is one word (kernels/lex_sort.launch's `keys`). Counted as a
    lex_sort_perm launch."""
    return launch(ops, m, 0, lex_sort_perm, orand=orand, keys=True)
