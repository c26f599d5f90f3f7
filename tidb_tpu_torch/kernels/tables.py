"""Task tables: the int64 tables of device addresses through which a
task-grid kernel reads each task's lanes (the grid's y axis is the task,
row g of the table its lanes). Shared by the solo wrappers, which launch
their kernels as a grid of one task, and by K10's task-grid modes
(kernels/grouped.py).

  ptrs(ts, width, dev, dtype, what)   one column: the tensors' addresses,
                                      each checked as the kernel reads it
  rows(out, G)                        the addresses of a [G, ...] tensor's
                                      rows
  lane_table(masks, keys, width, dev, what)
                                      K7's and K9's [G, 1 + 2 * nkeys]
                                      table (mask, then per key data, valid)
  to_card(host, dev)                  a host-built table on the card, with
                                      no host synchronization
  dev_index(dev)                      the card's index, as get_device()
                                      gives it for a tensor
  sm_count(dev)                       the card's SM count, looked up once
  stream_scratch(name, dev, words)    a kernel's int64 scratch on the
                                      current stream, zeroed once when
                                      allocated, held for one call
  staging(name, dev, words)           a pinned int64 host buffer on the
                                      current stream (one of a few kept
                                      from call to call), for a call's one
                                      upload
  all_true(dev, n)                    a cached all-true bool [n] on the card
  host_words(words)                   this thread's int64 host buffer of a
                                      call's parameter words, which a kernel
                                      library reads before it returns
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch


def dev_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev: torch.device) -> int:
    """The card's streaming multiprocessors, looked up once per card (the
    lookup costs tens of microseconds of a small call's host time)."""
    return _sm_count(dev_index(dev))


def to_card(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host-built int64 table on the card, copied from pinned memory
    without a host synchronization (the copy is ordered before the launch
    on the current stream). The caller keeps the result alive until the
    launch is enqueued."""
    return torch.from_numpy(np.ascontiguousarray(host, dtype=np.int64)).pin_memory().to(dev, non_blocking=True)


def ptrs(ts: list, width: int, dev: int, dtype, what: str) -> np.ndarray:
    """The addresses of the tensors `ts` (0 for None), each checked as the
    kernel reads it: on card `dev` (its index; -1 is the CPU), contiguous,
    at least `width` elements, and of `dtype` unless that is None. The
    tensors of one table column are all present or all None."""
    out = np.zeros(len(ts), dtype=np.int64)
    absent = 0
    for g, t in enumerate(ts):
        if t is None:
            absent += 1
            continue
        if t.get_device() != dev or t.numel() < width or not t.is_contiguous():
            raise ValueError(f"{what}: a contiguous tensor of at least {width} rows on device {dev} is needed")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{what}: task {g} has {t.dtype}, task 0 {dtype}")
        out[g] = t.data_ptr()
    if 0 < absent < len(ts):
        raise ValueError(f"{what}: present in some tasks and absent in others")
    return out


def rows(out: torch.Tensor, G: int) -> np.ndarray:
    """Addresses of the G rows of a contiguous [G, ...] tensor (0 when it
    is empty: no kernel reads a row of it)."""
    if out.numel() == 0:
        return np.zeros(G, dtype=np.int64)
    return out.data_ptr() + np.arange(G, dtype=np.int64) * (out.stride(0) * out.element_size())


def lane_table(masks: list, keys: list, width: int, dev: int, what: str) -> np.ndarray:
    """The [G, 1 + 2 * nkeys] task table of K7's and K9's kernels
    (csrc/topn_multi.cu, csrc/sort_groups.cu): each task's mask, then per
    key its data and valid lanes (`keys[g][j]` = (SortOp, valid, ...)),
    built a column at a time; every key's kind is task 0's."""
    G, nk = len(masks), len(keys[0])
    tab = np.zeros((G, 1 + 2 * nk), dtype=np.int64)
    tab[:, 0] = ptrs(masks, width, dev, torch.bool, f"{what}: mask")
    for j, (op, *_) in enumerate(keys[0]):
        col = [ks[j] for ks in keys]
        if any(c[0].kind != op.kind for c in col):
            raise TypeError(f"{what}: key {j} differs in kind across the tasks")
        tab[:, 1 + 2 * j] = ptrs([c[0].data for c in col], width, dev, op.data.dtype, f"{what}: key {j}")
        tab[:, 2 + 2 * j] = ptrs([c[1] for c in col], width, dev, torch.bool, f"{what}: key {j} valid")
    return tab


_scratch: dict = {}
_scratch_locks: dict = {}
_scratch_guard = threading.Lock()


@contextlib.contextmanager
def stream_scratch(name: str, dev: torch.device, words: int):
    """An int64 buffer of at least `words` words for kernel `name` on the
    current stream of card `dev`, kept from call to call. It is zeroed when
    it is allocated (or grown); a kernel that needs words at zero leaves
    them at zero when it ends, so no call zeroes it again. The lock held
    while the caller enqueues its launches keeps two threads on one stream
    from interleaving their calls' launches over the one buffer."""
    key = (name, dev_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    with _scratch_guard:
        lock = _scratch_locks.setdefault(key, threading.Lock())
    with lock:
        buf = _scratch.get(key)
        if buf is None or buf.numel() < words:
            buf = torch.zeros(max(words, 2 * (0 if buf is None else buf.numel())), dtype=torch.int64, device=dev)
            _scratch[key] = buf
        yield buf


class Staging:
    """A pinned int64 host buffer (`host`, a numpy view) from which a call
    makes its one upload (`upload`)."""

    def __init__(self, words: int):
        self.pin = torch.empty(words, dtype=torch.int64, pin_memory=True)
        self.host = self.pin.numpy()
        self.copied = None

    def upload(self, dst: torch.Tensor, words: int) -> None:
        """host[:words] → dst[:words] (int64 on the card), ordered before the
        launches enqueued after it on the current stream."""
        dst[:words].copy_(self.pin[:words], non_blocking=True)
        self.record(dst.device)

    def record(self, dev: torch.device) -> None:
        """Mark the buffer as read by the work enqueued so far on the
        current stream of card `dev` (a copy made by `upload`, or by a
        kernel library from `pin`'s address): it is not refilled before
        that work has run."""
        if self.copied is None:
            self.copied = torch.cuda.Event()
        self.copied.record(torch.cuda.current_stream(dev))


STAGES = 4  # staging buffers a (kernel, stream) cycles through
_stages: dict = {}


@contextlib.contextmanager
def staging(name: str, dev: torch.device, words: int):
    """A Staging of kernel `name` on the current stream of card `dev`, of at
    least `words` words, held (under a lock) while the caller fills it and
    uploads from it. Calls cycle through STAGES buffers, so the host may run
    that many calls ahead of the card; a buffer whose last copy has not run
    yet is waited for, never overwritten."""
    key = (name, dev_index(dev), torch.cuda.current_stream(dev).cuda_stream)
    with _scratch_guard:
        lock = _scratch_locks.setdefault(("staging",) + key, threading.Lock())
    with lock:
        ring = _stages.setdefault(key, [0, [None] * STAGES])
        i = ring[0]
        ring[0] = (i + 1) % STAGES
        st = ring[1][i]
        if st is None or st.pin.numel() < words:
            st = ring[1][i] = Staging(max(words, 256, 0 if st is None else 2 * st.pin.numel()))
        elif st.copied is not None:
            st.copied.synchronize()  # its last copy has left the host buffer
        yield st


_all_true: dict = {}
_all_true_guard = threading.Lock()


def all_true(dev: torch.device, n: int) -> torch.Tensor:
    """bool [n] of True on card `dev`, from a per-card tensor kept and grown
    (never written after it is filled): a mask meaning every row."""
    i = dev_index(dev)
    with _all_true_guard:
        t = _all_true.get(i)
        if t is None or t.numel() < n:
            # the smaller one stays alive: a launch queued on another stream may still read it
            _all_true.setdefault(("kept", i), []).append(t)
            t = _all_true[i] = torch.ones(max(n, 1024, 0 if t is None else 2 * t.numel()), dtype=torch.bool,
                                          device=torch.device("cuda", i))
    return t[:n]


_words = threading.local()


def host_words(words: list) -> int:
    """`words` in this thread's int64 host buffer (kept from call to call,
    grown as needed) → its address, for a kernel library that reads them
    before it returns: no array is built a call."""
    buf = getattr(_words, "buf", None)
    if buf is None or buf.shape[0] < len(words):
        buf = _words.buf = np.zeros(max(len(words), 512), dtype=np.int64)
        _words.addr = buf.ctypes.data
    buf[:len(words)] = words
    return _words.addr
