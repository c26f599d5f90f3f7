"""P3: one fused MPP join level probing the build side's direct-address
table (LUT).

Replaces tidb_tpu/parallel/mpp.py:1516-1544 (`lut_join` inside
MPPEngine._build_program). The CUDA kernel is csrc/lut_join.cu (one
thread per probe row; its note gives the bound); `lut_join_ref` is the
plain PyTorch version beside it, the reference's jnp code step by step.

`lut_join(keys, lo, size, stride, pmask, lut, bmask, brow, gathers,
match_out=None, rowid_out=None, copies=())`:

  * keys    — [(int64 [n] data, bool [n] valid)], the probe key lanes
              (1 to 4 of them), packed in the BUILD-local domain
  * lo, size, stride — the level's per-key build domain and strides
  * pmask   — bool [n], the probe rows' mask
  * lut     — int32 [lut_dom], packed build key → build row (-1 absent)
  * bmask   — bool [B], the build rows' mask (pushed conditions)
  * brow    — int64 [B], the build rows' row ids
  * gathers — [(8-byte [B] data, bool [B] valid)], build lanes used
              downstream; each comes back as (d[bsel], v[bsel] & match)
  * match_out / rowid_out — optional [n] tensors to write match (bool,
              or int64 0/1 for a row of the packed result) and the row
              ids into; `copies` — [(int64 [n] src, int64 [n] dst)]
              copied in the same launch
  → (match, rowid, [(data, valid)] gathered)

`lut_join` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernel or raises; `lut_join.launches` counts
the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import count, library
from .tables import sm_count

_I64 = np.iinfo(np.int64)
MAX_KEYS, MAX_GATHERS, MAX_COPIES = 4, 32, 8


def lut_join_ref(keys, lo, size, stride, pmask, lut, bmask, brow, gathers):
    """Plain PyTorch version: the reference's probe, step by step."""
    acc = None
    pkv = None
    for (d, v), l, sz, st in zip(keys, lo, size, stride):
        dd = d.to(torch.int64)
        # the range check comes BEFORE the packing: an out-of-domain key
        # misses and never wraps into a false slot
        ok = v & (dd >= l) & (dd < l + sz)
        term = (dd - l) * st
        acc = term if acc is None else acc + term
        pkv = ok if pkv is None else (pkv & ok)
    B = bmask.shape[0]
    pos = lut[torch.clip(acc, 0, lut.shape[0] - 1)]
    bsel = torch.clip(pos.to(torch.int64), 0, B - 1)
    match = pmask & pkv & (pos >= 0) & bmask[bsel]
    out = [(d[bsel], v[bsel] & match) for d, v in gathers]
    rowid = torch.where(match, brow[bsel], torch.full((), -1, dtype=torch.int64, device=brow.device))
    return match, rowid, out


def _check(keys, lo, size, stride, pmask, lut, bmask, brow, gathers, copies):
    n = pmask.shape[0]
    if not 1 <= len(keys) <= MAX_KEYS or not len(keys) == len(lo) == len(size) == len(stride):
        raise ValueError(f"lut_join: 1..{MAX_KEYS} keys, each with lo, size and stride")
    if len(gathers) > MAX_GATHERS or len(copies) > MAX_COPIES:
        raise ValueError(f"lut_join: at most {MAX_GATHERS} gathered and {MAX_COPIES} copied lanes")
    for d, v in keys:
        if d.dtype != torch.int64 or d.shape != (n,) or v.dtype != torch.bool or v.shape != (n,):
            raise TypeError(f"lut_join: a probe key is (int64 [{n}], bool [{n}])")
    if pmask.dtype != torch.bool or pmask.dim() != 1:
        raise TypeError("lut_join: pmask is bool [n]")
    if lut.dtype != torch.int32 or lut.dim() != 1 or lut.shape[0] < 1:
        raise TypeError("lut_join: the LUT is int32 [lut_dom >= 1]")
    B = bmask.shape[0]
    if bmask.dtype != torch.bool or B < 1 or brow.dtype != torch.int64 or brow.shape != (B,):
        raise TypeError("lut_join: bmask is bool [B >= 1], brow int64 [B]")
    for d, v in gathers:
        if d.element_size() != 8 or d.shape != (B,) or v.dtype != torch.bool or v.shape != (B,):
            raise TypeError(f"lut_join: a gathered lane is (8-byte [{B}], bool [{B}])")
    for s, t in copies:
        if s.dtype != torch.int64 or t.dtype != torch.int64 or s.shape != (n,) or t.shape != (n,):
            raise TypeError(f"lut_join: a copied lane is int64 [{n}] → int64 [{n}]")
    for l, sz in zip(lo, size):
        if not _I64.min <= l + sz <= _I64.max:
            raise ValueError("lut_join: key domain end outside int64")
    return n, B


_bound: set = set()


def _lib():
    lib = library("lut_join")
    if "lut_join" not in _bound:
        lib.tt_lut_join.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.tt_lut_join.restype = ctypes.c_int
        _bound.add("lut_join")
    return lib


def lut_join(keys, lo, size, stride, pmask, lut, bmask, brow, gathers, match_out=None, rowid_out=None,
             copies=()):
    """(match, rowid, gathered build lanes) of one LUT join level."""
    dev = pmask.device
    n, B = _check(keys, lo, size, stride, pmask, lut, bmask, brow, gathers, copies)
    if dev.type == "cpu":
        match, rowid, out = lut_join_ref(keys, lo, size, stride, pmask, lut, bmask, brow, gathers)
        if match_out is not None:
            match_out.copy_(match.to(match_out.dtype))
            match = match_out
        if rowid_out is not None:
            rowid_out.copy_(rowid)
            rowid = rowid_out
        for s, t in copies:
            t.copy_(s)
        return match, rowid, out
    if dev.type != "cuda":
        raise ValueError(f"lut_join: unsupported device {dev}")
    match = torch.empty(n, dtype=torch.bool, device=dev) if match_out is None else match_out
    rowid = torch.empty(n, dtype=torch.int64, device=dev) if rowid_out is None else rowid_out
    if match.dtype not in (torch.bool, torch.int64) or match.shape != (n,) or rowid.shape != (n,) \
            or rowid.dtype != torch.int64:
        raise TypeError(f"lut_join: match_out is bool/int64 [{n}], rowid_out int64 [{n}]")
    out = [(torch.empty(n, dtype=d.dtype, device=dev), torch.empty(n, dtype=torch.bool, device=dev))
           for d, _ in gathers]
    tensors = [t for kv in keys for t in kv] + [pmask, lut, bmask, brow, match, rowid]
    tensors += [t for g in gathers for t in g] + [t for c in copies for t in c]
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"lut_join: inputs must be contiguous tensors on {dev}")
    words = [n, len(keys), len(gathers), len(copies), int(match.dtype == torch.int64)]
    for (d, v), l, sz, st in zip(keys, lo, size, stride):
        words += [d.data_ptr(), v.data_ptr(), l, l + sz, st]
    words += [pmask.data_ptr(), lut.data_ptr(), lut.shape[0], bmask.data_ptr(), brow.data_ptr(), B]
    for (d, v), (od, ov) in zip(gathers, out):
        words += [d.data_ptr(), v.data_ptr(), od.data_ptr(), ov.data_ptr()]
    words += [match.data_ptr(), rowid.data_ptr()]
    for s, t in copies:
        words += [s.data_ptr(), t.data_ptr()]
    w = np.array(words, dtype=np.int64)
    rc = _lib().tt_lut_join(w.ctypes.data, len(w), sm_count(dev),
                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lut_join: kernel launch failed (cudaError {rc})")
    count(lut_join)
    return match, rowid, out


lut_join.launches = 0
