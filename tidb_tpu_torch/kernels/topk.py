"""K6: the k best rows of a single-key TopN.

Replaces the kernel of tidb_tpu/copr/tpu_engine.py:1759-1781
(TPUEngine._lower_topn): the sort key built from the row mask, the key's
validity and its data, then lax.top_k. The CUDA kernels are csrc/topk.cu
(a radix select over (key, ~row) that keeps its candidates in a compact
buffer once they are few, then orders its k rows itself in shared
memory; its note gives the key transform and what bounds it). For k above
ORDER_CAP the k rows come out unordered and K8 (kernels/lex_sort.py)
orders them. `topk_ref` is the plain PyTorch version beside it.

`topk(data, valid, mask, desc, k)`:

  * data  — int64 or float64 [N], the evaluated key (uint64 keys come as
            their int64 bits, as the reference's astype(int64) leaves them)
  * valid — bool [N], or None when every row's key is non-NULL
  * mask  — bool [N], the filter mask (row_valid included)
  * desc  — DESC (NULLs last) or ASC (negated key, NULLs first)
  * k     — 0 <= k <= N (a pushed LIMIT 0 asks for none)
  → (int32 [k] row ids, bool [k] their mask bits): lax.top_k's order,
    largest key first, equal keys lower row first. On the CPU lax.top_k
    orders floats by their IEEE total order (+0.0 above -0.0, +NaN above
    +inf, -NaN below -inf), and so does this.

`topk` takes the plain version only for tensors on the CPU. On a CUDA
device it launches the kernels or raises; `topk.launches` counts the
calls that launched.

The select runs over a task table (csrc/topk.cu: one radix select per
task, each with its own state); `topk` is its grid of one task, and K10's
task-grid mode is kernels/grouped.py `topk_tasks`. `select_at` launches
it over a table a caller uploaded with its own (P6).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import count, library
from .lex_sort import SortOp, lex_sort_perm
from .tables import dev_index, ptrs, sm_count, to_card

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _check(data, valid, mask, k):
    n = data.shape[0]
    if data.dtype not in (torch.int64, torch.float64) or data.shape != (n,):
        raise TypeError(f"topk: the key is int64/float64 [N], got {data.dtype} {tuple(data.shape)}")
    for what, t in (("valid", valid), ("mask", mask)):
        if t is not None and (t.dtype != torch.bool or t.shape != (n,)):
            raise TypeError(f"topk: {what} must be bool [{n}]")
    if not 0 <= k <= n:
        raise ValueError(f"topk: k={k} outside 0..{n}")
    return n


def sort_key(data, valid, mask, desc):
    """The reference's top_k operand (tpu_engine.py:1766-1778), exactly."""
    v = torch.ones_like(mask) if valid is None else valid
    if data.dtype == torch.float64:
        lo = torch.full((), float("-inf"), dtype=torch.float64, device=data.device)
        hi = torch.full((), float("inf"), dtype=torch.float64, device=data.device)
        neg = -data
    else:
        lo = torch.full((), _I64_MIN, dtype=torch.int64, device=data.device)
        hi = torch.full((), _I64_MAX - 1, dtype=torch.int64, device=data.device)
        neg = torch.where(data == _I64_MIN, data, -data)  # -INT64_MIN wraps onto itself
    if desc:
        return torch.where(mask & v, data, lo)
    return torch.where(mask, torch.where(v, neg, hi), lo)


def _total_order(key):
    """int64 whose signed order is top_k's order of `key`."""
    if key.dtype != torch.float64:
        return key
    b = key.view(torch.int64)
    return torch.where(b < 0, b ^ _I64_MAX, b)


def topk_ref(data, valid, mask, desc: bool, k: int):
    """Plain PyTorch version: a stable descending sort of the key."""
    _check(data, valid, mask, k)
    order = torch.sort(_total_order(sort_key(data, valid, mask, desc)), descending=True, stable=True).indices
    idx = order[:k].to(torch.int32)
    return idx, mask[idx]


ORDER_CAP = 4096  # the largest k K6 orders itself: csrc/topk.cu's kOrderCap (it refuses a larger one)


def orders_in_kernel(k: int) -> bool:
    """Whether K6 orders its k outputs itself (k <= ORDER_CAP: no K8 call
    and no host read), or leaves them to K8's (u desc, row asc) sort."""
    return k <= ORDER_CAP


_bound: set = set()


def _lib():
    lib = library("topk")
    if "topk" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_topk_state_len.argtypes = []
        lib.tt_topk_state_len.restype = L
        lib.tt_topk_buf_cap.argtypes = [L]
        lib.tt_topk_buf_cap.restype = L
        lib.tt_topk_select_tasks.argtypes = [C, I, I, I, L, L, C, C, C, C, C, C, I, I, C]
        lib.tt_topk_select_tasks.restype = I
        _bound.add("topk")
    return lib


def topk_table(datas: list, valids: list, masks: list, width: int, dev: int) -> np.ndarray:
    """The [G, 3] task table of csrc/topk.cu: key, valid (0 = all valid),
    mask, a column at a time."""
    host = np.zeros((len(datas), 3), dtype=np.int64)
    host[:, 0] = ptrs(datas, width, dev, datas[0].dtype, "topk: key")
    host[:, 1] = ptrs(valids, width, dev, torch.bool, "topk: valid")
    host[:, 2] = ptrs(masks, width, dev, torch.bool, "topk: mask")
    return host


def select_prepare(datas: list, valids: list, masks: list, desc: bool, k: int, width: int, dev: torch.device):
    """The radix select of G tasks up to its launch: ((int32 rows [G, k],
    uint64 u [G, k] as int64 bits, bool mask bits [G, k]), `go()`, which
    enqueues the select over the task table on the card). Task g's k rows
    are its rows (of its first `width`) holding the k largest keys: in
    lax.top_k's order when orders_in_kernel(k), else unordered (with their
    u, the order-preserving key, for K8)."""
    G = len(datas)
    tab = to_card(topk_table(datas, valids, masks, width, dev_index(dev)), dev)
    wn, nn = buffer_words(G, k, width)
    # the outputs' u, the state and the buffers' u in one int64 allocation;
    # the rows and the buffers' rows in one int32
    wide = torch.empty(wn, dtype=torch.int64, device=dev)
    narrow = torch.empty(nn, dtype=torch.int32, device=dev)
    candu, cand = wide[:G * k].view(G, k), narrow[:G * k].view(G, k)
    okc = torch.empty((G, k), dtype=torch.bool, device=dev)
    is_float = datas[0].dtype == torch.float64

    def go(tab=tab):
        select_at(tab.data_ptr(), G, is_float, desc, k, width, wide.data_ptr(), narrow.data_ptr(), okc.data_ptr(), dev)

    return (cand, candu, okc), go


_sizes: dict = {}


def _state_len() -> int:
    if "state" not in _sizes:
        _sizes["state"] = _lib().tt_topk_state_len()
    return _sizes["state"]


def buffer_words(G: int, k: int, width: int) -> tuple[int, int]:
    """(int64 words, int32 words) of the select's two buffers for G tasks:
    the outputs' u, the state and the candidate buffers' u; the rows and
    the candidate buffers' rows. Their first G * k entries are the outputs
    (candu, cand). csrc/topk.cu tt_topk_buf_cap: width / 8 candidates."""
    bcap = (width + 7) // 8
    return G * (k + _state_len() + 2 * bcap), G * (k + 2 * bcap)


def select_at(tab: int, G: int, is_float: bool, desc: bool, k: int, width: int, wide: int, narrow: int, okc: int,
              dev: torch.device, stream: int | None = None) -> None:
    """Enqueue the select over a task table at device address `tab` (for a
    caller that uploads it with its own tables in one copy: P6,
    kernels/rowpos_agg.py), into the buffers at addresses `wide` / `narrow`
    (`buffer_words`) and okc (bool [G, k]); `stream`: the current stream's
    handle, where the caller has it."""
    slen, bcap = _state_len(), (width + 7) // 8
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().tt_topk_select_tasks(tab, G, int(bool(is_float)), int(bool(desc)), width, k, wide + 8 * G * k,
                                     wide + 8 * G * (k + slen), narrow + 4 * G * k, narrow, wide, okc,
                                     int(orders_in_kernel(k)), sm_count(dev), stream)
    if rc != 0:
        raise RuntimeError(f"topk: kernel launch failed (cudaError {rc})")


def topk(data: torch.Tensor, valid: torch.Tensor | None, mask: torch.Tensor, desc: bool, k: int):
    """(int32 [k] row ids, bool [k] mask bits) in lax.top_k's order: the
    select as a grid of one task, which orders its own rows for k up to
    ORDER_CAP (no host read); above it K8 orders them."""
    dev = data.device
    if dev.type == "cpu":
        return topk_ref(data, valid, mask, desc, k)
    if dev.type != "cuda":
        raise ValueError(f"topk: unsupported device {dev}")
    n = _check(data, valid, mask, k)
    if k == 0:
        return torch.empty(0, dtype=torch.int32, device=dev), torch.empty(0, dtype=torch.bool, device=dev)
    (cand, candu, okc), go = select_prepare([data], [valid], [mask], desc, k, n, dev)
    go()
    count(topk)
    return ordered(cand[0], candu[0], okc[0], k)


def ordered(cand: torch.Tensor, candu: torch.Tensor, okc: torch.Tensor, k: int):
    """One task's k picks in lax.top_k's order: as the select left them
    within ORDER_CAP, else ordered by K8 over (u desc, row asc)."""
    if orders_in_kernel(k):
        return cand, okc
    # (u desc, row asc): ~u ascends as u descends; the row breaks ties
    perm = lex_sort_perm([SortOp(~candu, "u64"), SortOp(cand, "i32")]).long()
    return cand[perm], okc[perm]


topk.launches = 0
