"""K7: the sort operands of a multi-key TopN.

Replaces the operand build of tidb_tpu/copr/tpu_engine.py:1812-1828
(TPUEngine._lower_topn_multi's kernel); K8 (kernels/lex_sort.py) sorts
rows by what it writes. The CUDA kernel is csrc/topn_multi.cu;
`topn_multi_ops_ref` is the plain PyTorch version beside it.

`topn_multi_ops(mask, keys)`:

  * mask — bool [N], the filter mask (row_valid included)
  * keys — [(data, valid, desc)], most significant first: data an int32 /
           int64 / float64 tensor or an xp_torch.U64 [N], valid bool [N]
           or None (all valid)
  → [SortOp]: the masked flag (int32, masked rows last), then per key its
    NULL flag (int32; NULLs first ASC, last DESC) and its value (zeroed
    under NULL; -x for a float DESC key, ~x for an int DESC key), of the
    key's own kind.

`topn_multi_ops` takes the plain version only for tensors on the CPU. On
a CUDA device it launches the kernel or raises;
`topn_multi_ops.launches` counts the launches.

`ops_prepare` builds the kernel's task table for G tasks; the solo call
is G = 1, and K10's task-grid mode is kernels/grouped.py
`topn_multi_ops_tasks`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import count, library
from .lex_sort import KINDS, SortOp, sort_op
from .tables import dev_index, lane_table, sm_count, to_card


def _ops_in(mask, keys):
    n = mask.shape[0]
    if mask.dtype != torch.bool or mask.shape != (n,):
        raise TypeError("topn_multi: mask must be bool [N]")
    out = []
    for data, valid, desc in keys:
        op = sort_op(data)
        if op.data.shape != (n,):
            raise ValueError(f"topn_multi: a key lane must be [{n}]")
        if valid is not None and (valid.dtype != torch.bool or valid.shape != (n,)):
            raise TypeError(f"topn_multi: valid must be bool [{n}]")
        out.append((op, valid, bool(desc)))
    return n, out


def topn_multi_ops_ref(mask, keys) -> list[SortOp]:
    """Plain PyTorch version (the reference's jnp.where chain)."""
    _, keys = _ops_in(mask, keys)
    ops = [SortOp((~mask).to(torch.int32), "i32")]
    for op, valid, desc in keys:
        v = torch.ones_like(mask) if valid is None else valid
        null = (~v if desc else v).to(torch.int32)
        x = torch.where(v, op.data, torch.zeros((), dtype=op.data.dtype, device=op.data.device))
        if desc:
            x = -x if op.kind == "f64" else ~x
        ops += [SortOp(null, "i32"), SortOp(x, op.kind)]
    return ops


_bound: set = set()


def _lib():
    lib = library("topn_multi")
    if "topn_multi" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_topn_multi_ops.argtypes = [C, I, L, C, I, C, I, C]
        lib.tt_topn_multi_ops.restype = I
        _bound.add("topn_multi")
    return lib


def ops_prepare(masks: list, keys: list, width: int, dev: torch.device):
    """The kernel over G tasks up to its launch: (K8's operands over the
    [G * width] outputs, `go()`, which enqueues the kernel over its table
    on the card). `masks[g]` is task g's mask, `keys[g]` its checked
    [(SortOp, valid, desc)] (the same kinds and orders in every task);
    each is read to `width` rows."""
    G, nk = len(masks), len(keys[0])
    n = G * width
    flag = torch.empty(n, dtype=torch.int32, device=dev)
    ops = [SortOp(flag, "i32")]
    tasks = lane_table(masks, keys, width, dev_index(dev), "topn_multi")
    kdesc = np.zeros((nk, 3), dtype=np.int64)  # the table's key rows, shared by the tasks
    for j, (op, _, is_desc) in enumerate(keys[0]):
        if any(ks[j][2] != is_desc for ks in keys):
            raise ValueError(f"topn_multi: key {j} differs in order across the tasks")
        null = torch.empty(n, dtype=torch.int32, device=dev)
        val = torch.empty(n, dtype=op.data.dtype, device=dev)
        ops += [SortOp(null, "i32"), SortOp(val, op.kind)]
        kdesc[j] = (KINDS[op.kind] | (int(is_desc) << 32), null.data_ptr(), val.data_ptr())
    tab = to_card(np.concatenate([tasks.reshape(-1), kdesc.reshape(-1)]), dev)
    n_sms = sm_count(dev)

    def go():
        rc = _lib().tt_topn_multi_ops(tab.data_ptr(), G, width, tab.data_ptr() + 8 * tasks.size, nk,
                                      flag.data_ptr(), n_sms, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"topn_multi: kernel launch failed (cudaError {rc})")

    return ops, go


def topn_multi_ops(mask: torch.Tensor, keys) -> list[SortOp]:
    """K8's operands for a multi-key TopN (module doc)."""
    dev = mask.device
    if dev.type == "cpu":
        return topn_multi_ops_ref(mask, keys)
    if dev.type != "cuda":
        raise ValueError(f"topn_multi: unsupported device {dev}")
    n, keys = _ops_in(mask, keys)
    ops, go = ops_prepare([mask], [keys], n, dev)
    if n:
        go()
    count(topn_multi_ops)
    return ops


topn_multi_ops.launches = 0
