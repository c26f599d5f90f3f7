"""P4: one sort-probe MPP join level, unique or duplicate build keys.

Replaces the non-LUT level of tidb_tpu/parallel/mpp.py:1546-1653
(`join_stage` inside MPPEngine._build_program) with `pack_keys`
(:1451-1463). The CUDA kernels are csrc/sort_join.cu (their note gives
the steps and the bound): the build pack compacts the rows whose key is
valid (kernels/compact.py: M of them, read with the bits they vary in in
the call's one host read), K8 (kernels/lex_sort.py, stable as
`jnp.argsort`) sorts only those, the sorted layout over all B positions
comes with a directory of the key range that the probe kernels search
through, and a duplicate level expands slot by slot. `sort_join_ref` is
the plain PyTorch version beside them, the reference's jnp code step by
step.

`sort_join(pkeys, bkeys, lo, stride, key_i32, pmask, bmask, brow, mult,
left, cap, gathers, probe_lanes=(), prows=(), out=None)`:

  * pkeys / bkeys — [(int64 [n] / [B] data, bool valid)], the level's
              probe and build key lanes, packed as (d - lo) * stride summed
              (int64 wrap), truncated to int32 where `key_i32`
  * pmask   — bool [n], the probe rows' mask; bmask bool [B] the build's
  * brow    — int64 [B], the build rows' row ids
  * mult    — 1: unique build keys (one output row per probe row);
              > 1: the compact cumsum-offset expansion into `cap` slots
  * left    — a left join (unmatched probe rows emit one row)
  * gathers — [(8-byte [B] data, bool [B] valid)]: build lanes, each
              coming back as (d[bsel], v[bsel] & match)
  * probe_lanes / prows — (mult > 1) the probe side's lanes [(8-byte [n],
              bool [n])] and row-id lanes (int64 [n]) re-gathered by each
              slot's source probe row
  * out     — optional {"mask": int64 row, "rowid": int64 row, "prows":
              [int64 rows]} of the packed result to write into (rows
              mode's root level; mult 1 copies `prows` into "prows")
  → SortJoin(mask, rowid, gathered, probe_lanes, prows, dropped):
    the level's mask (the match; the probe mask for a left join with
    unique keys), the build row ids (-1 unmatched), the gathered build
    lanes; with mult > 1 the expanded probe lanes and row ids and the
    int64 [1] dropped-row count max(total - cap, 0); with mult 1
    `probe_lanes` and `prows` as given and `dropped` None.

`sort_join` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernels or raises; `sort_join.launches`
counts its calls that launched.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import compact
from .build import count, library
from .tables import sm_count, stream_scratch

I64_MAX = (1 << 63) - 1
I32_MAX = (1 << 31) - 1
MAX_KEYS, MAX_LANES, MAX_ROWS = 4, 32, 8
ETILE = 1024  # output slots an expansion block: csrc/sort_join.cu's ETILE
DIR_MAX_BITS = 20  # csrc/sort_join.cu's DIR_MAX_BITS


class SortJoin(NamedTuple):
    mask: torch.Tensor
    rowid: torch.Tensor
    gathered: list
    probe_lanes: list
    prows: list
    dropped: torch.Tensor | None


def capacity(rows: int, B: int, expected_out: int | None, left: bool, n_dev: int = 1) -> int:
    """Output slots of a duplicate-key level (ref: :1601-1611): the exact
    bound at n_dev 1, else a per-device share with 2x skew slack; `rows`
    and `B` are the level's probe and build rows on this device."""
    if expected_out is None:
        C = 2 * max(rows, B) + 64
    elif n_dev == 1:
        C = expected_out + 64
    else:
        C = min(2 * (expected_out // n_dev) + 64 + rows, 2 * max(rows, B) + 64)
    return C + rows if left else C


def pack_keys(keys, lo, stride, key_i32: bool):
    """(packed key, key valid) of one side (ref: pack_keys :1451)."""
    acc = kv = None
    for (d, v), l, st in zip(keys, lo, stride):
        term = (d.to(torch.int64) - l) * st
        acc = term if acc is None else acc + term
        kv = v if kv is None else (kv & v)
    if key_i32:
        acc = acc.to(torch.int32)  # domain-checked on the host
    return acc, kv


def _cummax(x):
    return torch.cummax(x, 0).values


def sort_join_ref(pkeys, bkeys, lo, stride, key_i32, pmask, bmask, brow, mult, left, cap, gathers,
                  probe_lanes=(), prows=()):
    """Plain PyTorch version: the reference's level, step by step."""
    pkey, pkv = pack_keys(pkeys, lo, stride, key_i32)
    bkey, bkv = pack_keys(bkeys, lo, stride, key_i32)
    bvalid = bmask & bkv
    B = bkey.shape[0]
    key_max = I32_MAX if key_i32 else I64_MAX
    sop = torch.where(bvalid, bkey, torch.full((), key_max, dtype=bkey.dtype, device=bkey.device))
    order = torch.sort(sop, stable=True).indices
    sk, sv = sop[order], bvalid[order]
    neg1 = torch.full((), -1, dtype=torch.int64, device=brow.device)
    if mult == 1:
        pos = torch.clip(torch.searchsorted(sk, pkey), 0, B - 1)
        match = pmask & pkv & sv[pos] & (sk[pos] == pkey)
        bsel = order[pos]
        gathered = [(d[bsel], v[bsel] & match) for d, v in gathers]
        rowid = torch.where(match, brow[bsel], neg1)
        return SortJoin(pmask if left else match, rowid, gathered, list(probe_lanes), list(prows), None)
    rows = pkey.shape[0]
    C = cap
    lft = torch.searchsorted(sk, pkey, side="left")
    bidx = torch.arange(B, dtype=torch.int64, device=sk.device)
    brk = sk[1:] != sk[:-1]
    one = torch.ones(1, dtype=torch.bool, device=sk.device)
    bfirst, blast = torch.cat([one, brk]), torch.cat([brk, one])
    rstart = _cummax(torch.where(bfirst, bidx, 0))
    rend = -_cummax(torch.where(blast, -bidx, -(B - 1)).flip(0)).flip(0)
    run_len = rend - rstart + 1
    leftc = torch.clip(lft, 0, B - 1)
    hit = (lft < B) & (sk[leftc] == pkey)
    pvalid = pmask & pkv
    cnt = torch.where(pvalid & hit, run_len[leftc], 0).to(torch.int32)
    if left:
        cnt = torch.maximum(cnt, pmask.to(torch.int32))
    opos = (torch.cumsum(cnt, 0) - cnt).to(torch.int32)
    total = cnt.to(torch.int64).sum()
    dropped = torch.clamp(total - C, min=0).reshape(1)
    j = torch.arange(C, dtype=torch.int32, device=sk.device)
    src = torch.clip(torch.searchsorted(opos, j, right=True) - 1, 0, rows - 1)
    slot = j - opos[src]
    emitted = (j < total) & (slot < cnt[src])
    matched_probe = (pvalid & hit)[src] if left else cnt[src] > 0
    bpos = torch.clip(lft[src] + slot, 0, B - 1)
    match = emitted & matched_probe & pvalid[src] & sv[bpos] & (sk[bpos] == pkey[src])
    bsel = order[bpos]
    plan = [(d[src], v[src] & emitted) for d, v in probe_lanes]
    gathered = [(d[bsel], v[bsel] & match) for d, v in gathers]
    prow_out = [torch.where(emitted, r[src], neg1) for r in prows]
    rowid = torch.where(match, brow[bsel], neg1)
    mask = (emitted & pmask[src]) if left else match
    return SortJoin(mask, rowid, gathered, plan, prow_out, dropped)


def _check(pkeys, bkeys, lo, stride, pmask, bmask, brow, gathers, probe_lanes, prows):
    n, B = pmask.shape[0], bmask.shape[0]
    if not 1 <= len(pkeys) <= MAX_KEYS or not len(pkeys) == len(bkeys) == len(lo) == len(stride):
        raise ValueError(f"sort_join: 1..{MAX_KEYS} keys a side, each with lo and stride")
    if len(gathers) > MAX_LANES or len(probe_lanes) > MAX_LANES or len(prows) > MAX_ROWS:
        raise ValueError(f"sort_join: at most {MAX_LANES} lanes a side and {MAX_ROWS} row-id lanes")
    for keys, m, side in ((pkeys, n, "probe"), (bkeys, B, "build")):
        for d, v in keys:
            if d.dtype != torch.int64 or d.shape != (m,) or v.dtype != torch.bool or v.shape != (m,):
                raise TypeError(f"sort_join: a {side} key is (int64 [{m}], bool [{m}])")
    if pmask.dtype != torch.bool or bmask.dtype != torch.bool or n < 1 or B < 1:
        raise TypeError("sort_join: pmask bool [n >= 1], bmask bool [B >= 1]")
    if brow.dtype != torch.int64 or brow.shape != (B,):
        raise TypeError(f"sort_join: brow is int64 [{B}]")
    for lanes, m, side in ((gathers, B, "build"), (probe_lanes, n, "probe")):
        for d, v in lanes:
            if d.element_size() != 8 or d.shape != (m,) or v.dtype != torch.bool or v.shape != (m,):
                raise TypeError(f"sort_join: a {side} lane is (8-byte [{m}], bool [{m}])")
    for r in prows:
        if r.dtype != torch.int64 or r.shape != (n,):
            raise TypeError(f"sort_join: a row-id lane is int64 [{n}]")
    return n, B


_bound: set = set()


def _lib():
    lib = library("sort_join")
    if "sort_join" not in _bound:
        for fn in ("tt_sj_pack", "tt_sj_sorted", "tt_sj_probe1", "tt_sj_count", "tt_sj_expand"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        lib.tt_sj_scratch_words.argtypes = [ctypes.c_int64]
        lib.tt_sj_scratch_words.restype = ctypes.c_int64
        _bound.add("sort_join")
    return lib


def _call(fn: str, words: list[int], dev) -> None:
    w = np.array(words, dtype=np.int64)
    rc = getattr(_lib(), fn)(w.ctypes.data, len(w), sm_count(dev), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sort_join: {fn} launch failed (cudaError {rc})")


def dir_bits(m: int) -> int:
    """The directory's bits over M sorted keys: about one bucket a key,
    at most 2^DIR_MAX_BITS buckets."""
    return min(DIR_MAX_BITS, m.bit_length())


def _key_words(keys, lo, stride, key_i32) -> list[int]:
    words = [len(keys), int(key_i32)]
    for (d, v), l, st in zip(keys, lo, stride):
        words += [d.data_ptr(), v.data_ptr(), l, st]
    return words


def sort_join(pkeys, bkeys, lo, stride, key_i32, pmask, bmask, brow, mult, left, cap, gathers,
              probe_lanes=(), prows=(), out=None) -> SortJoin:
    """One sort-probe join level (module doc)."""
    dev = pmask.device
    n, B = _check(pkeys, bkeys, lo, stride, pmask, bmask, brow, gathers, probe_lanes, prows)
    if dev.type == "cpu":
        res = sort_join_ref(pkeys, bkeys, lo, stride, key_i32, pmask, bmask, brow, mult, left, cap, gathers,
                            probe_lanes, prows)
        if out is None:
            return res
        out["mask"].copy_(res.mask.to(torch.int64))
        out["rowid"].copy_(res.rowid)
        for r, t in zip(res.prows, out.get("prows", ())):
            t.copy_(r)
        return res._replace(mask=out["mask"], rowid=out["rowid"])
    if dev.type != "cuda":
        raise ValueError(f"sort_join: unsupported device {dev}")
    tensors = [t for kv in list(pkeys) + list(bkeys) + list(gathers) + list(probe_lanes) for t in kv]
    for t in tensors + [pmask, bmask, brow] + list(prows):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"sort_join: inputs must be contiguous tensors on {dev}")
    if mult > 1 and not 1 <= cap < 1 << 31:
        raise ValueError(f"sort_join: capacity {cap} outside 1..2^31-1")
    if max(n, B) >= 1 << 31:
        raise ValueError(f"sort_join: {max(n, B)} rows exceed the int32 row ids")
    lib = _lib()
    key_max = I32_MAX if key_i32 else I64_MAX
    # the build side: packed and compacted, the kept keys sorted, then laid
    # out over all B positions with the directory (and the run lengths); one
    # allocation for every array of the call that it does not return
    dup = mult > 1
    etiles = -(-cap // ETILE) if dup else 0
    buf, offs = compact.workspace(dev, [B, 8 * B, 4 * B, 4 * B, 24, 8 * B, B, 4 * B, 4 * ((1 << dir_bits(B)) + 1),
                                        4 * B * dup, 24 * n * dup, 4 * (etiles + 1) * dup, 40 * dup])
    a = [buf.data_ptr() + 8 * o for o in offs]
    bvalid, comp_a, crow, tail, res_a, sk, sv, order, dirs, rlen, entries, first, scal = a
    comp, res = buf[offs[1]:offs[1] + B], buf[offs[4]:offs[4] + 3]
    with stream_scratch("sort_join", dev, lib.tt_sj_scratch_words(max(n, B))) as ws:
        _call("tt_sj_pack", [B, key_max] + _key_words(bkeys, lo, stride, key_i32)
              + [bmask.data_ptr(), bvalid, comp_a, crow, tail, res_a, ws.data_ptr()], dev)
    # the outputs while the pack runs: after the read, only launches
    out = out or {}
    L = n if mult == 1 else cap
    mask = out.get("mask")
    if mask is None:
        mask = torch.empty(L, dtype=torch.bool, device=dev)
    rowid = out.get("rowid")
    if rowid is None:
        rowid = torch.empty(L, dtype=torch.int64, device=dev)
    if mask.shape != (L,) or mask.dtype not in (torch.bool, torch.int64) or rowid.shape != (L,) \
            or rowid.dtype != torch.int64:
        raise TypeError(f"sort_join: the mask row is bool/int64 [{L}], the row-id row int64 [{L}]")
    gathered = [(torch.empty(L, dtype=d.dtype, device=dev), torch.empty(L, dtype=torch.bool, device=dev))
                for d, _ in gathers]
    glanes = []
    for (d, v), (od, ov) in zip(gathers, gathered):
        glanes += [d.data_ptr(), v.data_ptr(), od.data_ptr(), ov.data_ptr()]
    if dup:
        plan = [(torch.empty(cap, dtype=d.dtype, device=dev), torch.empty(cap, dtype=torch.bool, device=dev))
                for d, _ in probe_lanes]
        prow_out = list(out.get("prows", ())) or [torch.empty(cap, dtype=torch.int64, device=dev) for _ in prows]
        if len(prow_out) != len(prows) or any(t.shape != (cap,) or t.dtype != torch.int64 for t in prow_out):
            raise TypeError(f"sort_join: one int64 [{cap}] output row per row-id lane")
    m, orand = compact.read(res)
    perm = compact.sort_kept(comp, m, orand)
    bits = dir_bits(m)
    _call("tt_sj_sorted", [B, m, bits, key_max, perm.data_ptr(), comp_a, crow, tail, bvalid, sk, sv, order, dirs,
                           rlen if dup else 0], dev)
    head = [n, B, m, bits, len(gathers), int(bool(left)), int(mask.dtype == torch.int64), pmask.data_ptr(),
            sk, sv, order, dirs, brow.data_ptr()]
    head += _key_words(pkeys, lo, stride, key_i32)
    if mult == 1:
        copies = list(zip(prows, out.get("prows", ())))
        words = head + [len(copies)] + glanes + [mask.data_ptr(), rowid.data_ptr()]
        for s, t in copies:
            if t.shape != (n,) or t.dtype != torch.int64:
                raise TypeError(f"sort_join: a copied row-id row is int64 [{n}]")
            words += [s.data_ptr(), t.data_ptr()]
        _call("tt_sj_probe1", words, dev)
        count(sort_join)
        return SortJoin(mask, rowid, gathered, list(probe_lanes), list(prows), None)
    # entries: (opos, row | left, cnt | hit) a row with cnt > 0; first: the
    # entry at each expansion tile's first slot; scal: total, dropped, the
    # last row's left and opos, the entries
    with stream_scratch("sort_join", dev, lib.tt_sj_scratch_words(max(n, B))) as ws:
        _call("tt_sj_count", head + [cap, rlen, entries, first, scal, ws.data_ptr()], dev)
    words = head + [len(probe_lanes), len(prows), cap, entries, first, scal] + glanes
    for (d, v), (od, ov) in zip(probe_lanes, plan):
        words += [d.data_ptr(), v.data_ptr(), od.data_ptr(), ov.data_ptr()]
    for s, t in zip(prows, prow_out):
        words += [s.data_ptr(), t.data_ptr()]
    words += [mask.data_ptr(), rowid.data_ptr()]
    _call("tt_sj_expand", words, dev)
    count(sort_join)
    return SortJoin(mask, rowid, gathered, plan, prow_out, buf[offs[12] + 1:offs[12] + 2])


sort_join.launches = 0
