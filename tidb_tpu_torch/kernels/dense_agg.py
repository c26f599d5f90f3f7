"""P8: the dense MPP aggregation — direct-address partials of a narrow
group-key domain, straight into the rows of the packed result.

Replaces the dense branch of `kernel` in tidb_tpu/parallel/mpp.py:1960-1973
(MPPEngine._build_program) with `_agg_partials` (:2048-2080), at n_dev 1
(psum / pmin / pmax are the identity there). The CUDA kernels are
csrc/dense_agg.cu: the int32 group code as a segment lane, then K4's
segment-lane mode (kernels/seg_agg.py) folds the partials, then a copy of
each lane into its row of the packed result. `dense_agg_ref` is the plain
PyTorch version beside them, the reference's jnp code step by step.

`dense_agg(mask, keys, nseg, lanes, rows=None)`:

  * mask  — bool [N], the chain's row mask
  * keys  — [DenseKey(data int64 [N], valid bool [N], lo, dom)]: the
            reference's int32 mixed-radix code, kd = (int32(d) - lo + 1)
            * v (int32 wrap: a narrow domain of keys above 2^31 codes as
            in int64), code = code * (dom + 1) + kd; masked rows and codes
            outside [0, nseg) are dropped (jax's scatter drops them). No
            key (an aggregate without GROUP BY) codes every row 0, nseg 1
  * lanes — red.RedLane partial lanes: the count over the mask first,
            then per aggregate (sum, cnt), (min | max, cnt) or cnt
  * rows  — optional int64 [len(lanes), W >= nseg] rows of the packed
            result to write into (float lanes as their bits)
  → [nseg] per lane (float lanes as float64 views of their rows): sums
    and counts, min / max with the reference's sentinel folded for NULL
    rows and the op's identity in empty segments.

Integer lanes are bit-exact with the reference; float sums differ by
summation order (K4 adds with atomics).

`dense_agg` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernels or raises; `dense_agg.launches`
counts its calls that launched.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import red
from .build import count, library
from .seg_agg import seg_agg

MAX_KEYS, MAX_LANES = 8, 32


class DenseKey(NamedTuple):
    data: torch.Tensor
    valid: torch.Tensor
    lo: int
    dom: int


def _i32(x: int) -> int:
    """A Python int as the int32 jnp's weak typing casts it to (wrapped)."""
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def dense_code_ref(mask, keys, nseg: int) -> torch.Tensor:
    """int64 [N] segment of each row: the int32 code, nseg where masked or
    out of range (ref: :1962-1967)."""
    code = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    for k in keys:
        kd = (k.data.to(torch.int32) - _i32(k.lo) + 1) * k.valid
        code = code * (k.dom + 1) + kd
    seg = torch.where(mask, code.to(torch.int64), nseg)
    return torch.where((seg >= 0) & (seg <= nseg), seg, nseg)


def dense_agg_ref(mask, keys, nseg: int, lanes, rows=None) -> list:
    """Plain PyTorch version: the reference's partials, step by step."""
    seg = dense_code_ref(mask, keys, nseg)
    outs = [red.scatter_ref(red.values_ref(ln, mask), seg, nseg, ln.op) for ln in lanes]
    if rows is None:
        return outs
    for j, o in enumerate(outs):
        rows[j, :nseg] = red.bits(o)
    return _views(rows, lanes, nseg)


def _views(rows, lanes, nseg):
    return [rows[j, :nseg].view(torch.float64) if ln.is_float else rows[j, :nseg] for j, ln in enumerate(lanes)]


def _check(mask, keys, nseg, lanes, rows):
    n = mask.shape[0]
    if mask.dtype != torch.bool or not 1 <= nseg < 1 << 31:
        raise TypeError("dense_agg: mask is bool [N], 1 <= nseg < 2^31")
    if not 0 <= len(keys) <= MAX_KEYS or not 1 <= len(lanes) <= MAX_LANES:
        raise ValueError(f"dense_agg: 0..{MAX_KEYS} keys and 1..{MAX_LANES} lanes")
    for k in keys:
        if k.data.dtype != torch.int64 or k.data.shape != (n,) or k.valid.dtype != torch.bool \
                or k.valid.shape != (n,) or k.dom < 1:
            raise TypeError(f"dense_agg: a key is (int64 [{n}], bool [{n}]) with dom >= 1")
    red.check_lanes(lanes, n, "dense_agg")
    if rows is not None and (rows.dtype != torch.int64 or rows.dim() != 2 or rows.shape[0] != len(lanes)
                             or rows.shape[1] < nseg or rows.stride(1) != 1):
        raise TypeError(f"dense_agg: the result rows are int64 [{len(lanes)}, >= {nseg}], rows contiguous")
    return n


_bound: set = set()


def _lib():
    lib = library("dense_agg")
    if "dense_agg" not in _bound:
        for fn in ("tt_dense_code", "tt_dense_emit"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        _bound.add("dense_agg")
    return lib


def _call(fn, words, dev):
    w = np.array(words, dtype=np.int64)
    rc = getattr(_lib(), fn)(w.ctypes.data, len(w), torch.cuda.get_device_properties(dev).multi_processor_count,
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dense_agg: {fn} launch failed (cudaError {rc})")


def dense_agg(mask, keys, nseg: int, lanes, rows=None) -> list:
    """The dense partial lanes (module doc)."""
    dev = mask.device
    n = _check(mask, keys, nseg, lanes, rows)
    if dev.type == "cpu":
        return dense_agg_ref(mask, keys, nseg, lanes, rows)
    if dev.type != "cuda":
        raise ValueError(f"dense_agg: unsupported device {dev}")
    for t in [mask] + [t for k in keys for t in (k.data, k.valid)] + \
            [t for ln in lanes for t in (ln.data, ln.valid) if t is not None]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"dense_agg: inputs must be contiguous tensors on {dev}")
    seg = torch.empty(n, dtype=torch.int32, device=dev)
    words = [n, len(keys), nseg, mask.data_ptr(), seg.data_ptr()]
    for k in keys:
        words += [k.data.data_ptr(), k.valid.data_ptr(), _i32(k.lo), k.dom]
    _call("tt_dense_code", words, dev)
    iout, fout = seg_agg(mask, [], [red.seg_lane(ln) for ln in lanes], nseg, seg=seg)
    srcs, ni, nf = [], 0, 0
    for ln in lanes:
        if ln.is_float:
            srcs.append(fout[nf])
            nf += 1
        else:
            srcs.append(iout[ni])
            ni += 1
    if rows is None:
        rows = torch.empty((len(lanes), nseg), dtype=torch.int64, device=dev)
    _call("tt_dense_emit", [len(lanes), nseg, rows.data_ptr(), rows.stride(0)] + [t.data_ptr() for t in srcs], dev)
    count(dense_agg)
    return _views(rows, lanes, nseg)


dense_agg.launches = 0
