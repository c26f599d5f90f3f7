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
"""

from __future__ import annotations

import ctypes

import torch

from .build import count, library
from .lex_sort import KINDS, SortOp, sort_op


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
        lib.tt_topn_multi_ops.argtypes = [C, L, C, I, C, I, C]
        lib.tt_topn_multi_ops.restype = I
        _bound.add("topn_multi")
    return lib


def topn_multi_ops(mask: torch.Tensor, keys) -> list[SortOp]:
    """K8's operands for a multi-key TopN (module doc)."""
    dev = mask.device
    if dev.type == "cpu":
        return topn_multi_ops_ref(mask, keys)
    if dev.type != "cuda":
        raise ValueError(f"topn_multi: unsupported device {dev}")
    n, keys = _ops_in(mask, keys)
    for t in [mask] + [t for op, v, _ in keys for t in (op.data, v) if t is not None]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"topn_multi: inputs must be contiguous tensors on {dev}")
    flag = torch.empty(n, dtype=torch.int32, device=dev)
    ops = [SortOp(flag, "i32")]
    desc = []
    for op, valid, is_desc in keys:
        null = torch.empty(n, dtype=torch.int32, device=dev)
        val = torch.empty_like(op.data)
        ops += [SortOp(null, "i32"), SortOp(val, op.kind)]
        desc.append([op.data.data_ptr(), 0 if valid is None else valid.data_ptr(),
                     KINDS[op.kind] | (int(is_desc) << 32), null.data_ptr(), val.data_ptr()])
    kd = torch.tensor(desc or [[0] * 5], dtype=torch.int64).to(dev)
    rc = _lib().tt_topn_multi_ops(
        mask.data_ptr(), n, kd.data_ptr(), len(keys), flag.data_ptr(),
        torch.cuda.get_device_properties(dev).multi_processor_count,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"topn_multi: kernel launch failed (cudaError {rc})")
    count(topn_multi_ops)
    return ops


topn_multi_ops.launches = 0
