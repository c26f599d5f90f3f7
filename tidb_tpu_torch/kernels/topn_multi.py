"""K7: the first k rows of a multi-key TopN.

Replaces the kernel of tidb_tpu/copr/tpu_engine.py:1796-1835
(TPUEngine._lower_topn_multi): the reference builds the sort operands of
every row, sorts every row by them with lex_sort_perm and keeps the first
n. The CUDA kernels are csrc/topn_multi.cu: a radix select over the
operands' composite key (the row id last), which reads a later key only
at the rows still tied on the keys before it, and orders its k rows
itself in shared memory; its note gives the key and what bounds it. For
k above `order_cap(nkeys)` the k rows come out unordered and K8
(kernels/lex_sort.py) orders them. `topn_multi_ref` is the plain PyTorch
version beside it: the operands (`topn_multi_ops_ref`), K8's plain
version, the first k.

`topn_multi(mask, keys, k)`:

  * mask — bool [N], the filter mask (row_valid included)
  * keys — [(data, valid, desc)], most significant first: data an int32 /
           int64 / float64 tensor or an xp_torch.U64 [N], valid bool [N]
           or None (all valid)
  * k    — the rows wanted (a LIMIT past N takes N)
  → (int64 [min(k, N)] row ids, bool [min(k, N)] their mask bits):
    lex_sort_perm's first rows over the operands — masked rows last, then
    per key NULLs first ASC / last DESC and the value (-x for a float
    DESC key, ~x for an integer one; floats in lax.sort's order), ties by
    row id.

`topn_multi` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernels or raises; `topn_multi.launches`
counts its calls.

`select_prepare` runs the select over G tasks; the solo call is G = 1,
and K10's task-grid mode is kernels/grouped.py `topn_multi_tasks`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import count, library
from .lex_sort import KINDS, SortOp, lex_sort_perm, lex_sort_perm_ref, sort_op
from .tables import dev_index, host_words, lane_table, sm_count, stream_scratch, to_card


def _ops_in(mask, keys):
    n = mask.shape[0]
    if mask.dtype != torch.bool or mask.shape != (n,):
        raise TypeError("topn_multi: mask must be bool [N]")
    if not keys:
        raise ValueError("topn_multi: no keys")
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
    """The reference's sort operands (its jnp.where chain): the masked
    flag (int32, masked rows last), then per key its NULL flag (int32;
    NULLs first ASC, last DESC) and its value (zeroed under NULL; -x for a
    float DESC key, ~x for an integer one), of the key's own kind."""
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


def topn_multi_ref(mask, keys, k: int):
    """Plain PyTorch version: the operands, K8's plain version, the first k."""
    n, _ = _ops_in(mask, keys)
    if k < 0:
        raise ValueError(f"topn_multi: k={k} < 0")
    idx = lex_sort_perm_ref(topn_multi_ops_ref(mask, keys))[:min(k, n)].long()
    return idx, mask[idx]


_bound: set = set()
_sizes: dict = {}


def _lib():
    lib = library("topn_multi")
    if "topn_multi" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_topn_multi_state_len.argtypes = []
        lib.tt_topn_multi_state_len.restype = L
        lib.tt_topn_multi_param_words.argtypes = []
        lib.tt_topn_multi_param_words.restype = I
        lib.tt_topn_multi_order_cap.argtypes = [I]
        lib.tt_topn_multi_order_cap.restype = I
        lib.tt_topn_multi_out_cap.argtypes = [L, I, I]
        lib.tt_topn_multi_out_cap.restype = L
        lib.tt_topn_multi.argtypes = [C, I, C, I, I, L, L, I, C, C, C, C, C, C, C, I, C]
        lib.tt_topn_multi.restype = I
        _bound.add("topn_multi")
    return lib


def _state_len() -> int:
    if "state" not in _sizes:
        _sizes["state"] = _lib().tt_topn_multi_state_len()
    return _sizes["state"]


def _param_words() -> int:
    if "param" not in _sizes:
        _sizes["param"] = _lib().tt_topn_multi_param_words()
    return _sizes["param"]


def order_cap(nkeys: int) -> int:
    """The largest k whose rows the kernel orders itself for `nkeys` keys
    (0: none), as the kernels' library decides it: a power of two up to
    4,096 whose shared-memory slots fit (4,096 for up to 5 keys)."""
    if ("cap", nkeys) not in _sizes:
        _sizes[("cap", nkeys)] = _lib().tt_topn_multi_order_cap(nkeys)
    return _sizes[("cap", nkeys)]


def orders_in_kernel(k: int, nkeys: int) -> bool:
    """Whether K7 orders its k rows itself (no K8 call, no host read), or
    leaves them to K8."""
    return k <= order_cap(nkeys)


def out_cap(k: int, nkeys: int) -> int:
    """The output slots a task needs (the library's `oc`): k, or the rows
    the select may hand the ordering when it orders them itself."""
    return _lib().tt_topn_multi_out_cap(k, nkeys, int(orders_in_kernel(k, nkeys)))


def select_prepare(masks: list, keys: list, k: int, width: int, dev: torch.device):
    """The select over G tasks up to its launch: `go()`, which enqueues the
    kernels on the card and returns (idx int64 [G, k], ok bool [G, k],
    words): task g's first k rows (of its first `width` rows) and their
    mask bits, in the composite order when orders_in_kernel(k, nkeys)
    (words None); above the cap unordered, with their composite words
    (int64 [2 * nkeys + 1, G * k], the row id last) for `ordered`.
    `masks[g]` is task g's mask, `keys[g]` its checked [(SortOp, valid,
    desc)] (the same kinds and orders in every task); 1 <= k <= width."""
    G, nk = len(masks), len(keys[0])
    for j, (_, _, is_desc) in enumerate(keys[0]):
        if any(ks[j][2] != is_desc for ks in keys):
            raise ValueError(f"topn_multi: key {j} differs in order across the tasks")
    kd = np.array([KINDS[op.kind] | (int(is_desc) << 8) for op, _, is_desc in keys[0]], dtype=np.int64)
    words = np.concatenate([kd, lane_table(masks, keys, width, dev_index(dev), "topn_multi").reshape(-1)])
    by_value = words.size <= _param_words()
    table = None if by_value else to_card(words, dev)
    in_kernel = orders_in_kernel(k, nk)
    oc, bcap = out_cap(k, nk), (width + 7) // 8
    narrow = torch.empty(G * oc + 2 * G * bcap, dtype=torch.int32, device=dev)  # the outputs, the buffers
    wide = torch.empty(G * k + 2 * G * (2 * nk + 1), dtype=torch.int64, device=dev)  # idx, T / KNOWN per word
    idx = wide[:G * k].view(G, k)
    ok = torch.empty((G, k), dtype=torch.bool, device=dev)
    keyw = None if in_kernel else torch.empty((2 * nk + 1, G * k), dtype=torch.int64, device=dev)
    n_sms, slen = sm_count(dev), _state_len()

    def go():
        stream = torch.cuda.current_stream(dev).cuda_stream
        with stream_scratch("topn_multi", dev, G * slen) as state:
            rc = _lib().tt_topn_multi(host_words(words) if by_value else None, words.size,
                                      None if by_value else table.data_ptr(), G, nk, width, k, int(in_kernel),
                                      state.data_ptr(), wide.data_ptr() + 8 * G * k, narrow.data_ptr(),
                                      narrow.data_ptr() + 4 * G * oc,
                                      idx.data_ptr(), ok.data_ptr(), None if in_kernel else keyw.data_ptr(), n_sms,
                                      stream)
        if rc != 0:
            raise RuntimeError(f"topn_multi: kernel launch failed (cudaError {rc})")
        return idx, ok, keyw

    return go


def ordered(idx: torch.Tensor, ok: torch.Tensor, words, sort):
    """The select's [G, k] rows in the composite order: as the kernel left
    them (words None), else ordered by `sort` (K8's lex_sort_perm, or its
    task-leading mode with the task width k) over their words."""
    if words is None:
        return idx, ok
    G, k = idx.shape
    perm = sort([SortOp(w, "u64") for w in words]).long()
    return idx.reshape(-1)[perm].reshape(G, k), ok.reshape(-1)[perm].reshape(G, k)


def topn_multi(mask: torch.Tensor, keys, k: int):
    """(int64 [min(k, N)] row ids, bool [min(k, N)] mask bits): the first
    rows of the multi-key order (module doc) — the select as a grid of one
    task, which orders its own rows for k up to order_cap (no host read);
    above it K8 orders them."""
    dev = mask.device
    if dev.type == "cpu":
        return topn_multi_ref(mask, keys, k)
    if dev.type != "cuda":
        raise ValueError(f"topn_multi: unsupported device {dev}")
    n, keys = _ops_in(mask, keys)
    if k < 0:
        raise ValueError(f"topn_multi: k={k} < 0")
    k = min(k, n)
    if k == 0:
        return torch.empty(0, dtype=torch.int64, device=dev), torch.empty(0, dtype=torch.bool, device=dev)
    idx, ok, words = select_prepare([mask], [keys], k, n, dev)()
    count(topn_multi)
    idx, ok = ordered(idx, ok, words, lex_sort_perm)
    return idx[0], ok[0]


topn_multi.launches = 0
