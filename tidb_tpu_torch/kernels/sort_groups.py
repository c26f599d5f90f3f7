"""K9: dense group ids of a sort-based GROUP BY.

Replaces tidb_tpu/copr/tpu_engine.py:1351-1400 (the kernel of
TPUEngine._lower_agg_sorted) up to its segment reductions: the sort
operands, K8's permutation (kernels/lex_sort.py), group starts, n_groups,
capped segment ids and each group's key words. K4 (kernels/seg_agg.py,
its `seg` mode) reduces the value lanes over those ids. The CUDA kernels
are csrc/sort_groups.cu; `sort_groups_ref` is the plain PyTorch version
beside it.

`sort_groups(mask, keys, cap_of)`:

  * mask   — bool [N], the filter mask (row_valid included)
  * keys   — [(data, valid)]: data an int32 / int64 / float64 tensor or an
             xp_torch.U64 [N], valid bool [N] or None (all valid)
  * cap_of — n_groups → the group capacity to use (the engine's gcap
             escalation); called once, on the host
  → Groups(perm, n_groups, cap, seg, kval, kvalid):
      perm    int32 [N], K8's permutation over (masked flag, per key its
              NULL flag and value bits)
      seg     int32 [N] in ROW order: a masked-in row's group id, groups
              at or beyond cap folded into cap; masked rows get cap
      kval    int64 [nkeys, cap]: each group's key bits (float keys with
              -0.0 and subnormals folded into +0.0, as the reference's
              flushed x == 0.0 test folds them; uint64 as int64 bits),
              INT64_MIN past the groups
      kvalid  int64 [nkeys, cap]: 1 for a non-NULL key, 0 for NULL, -1
              past the groups
    Only [:n_groups] of kval/kvalid is the reference's partial; both
    versions fill the rest alike.

`sort_groups` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernels or raises; `sort_groups.launches`
counts the calls that launched.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .build import count, library
from .lex_sort import DBL_MIN, KINDS, SortOp, lex_sort_perm, lex_sort_perm_ref, sort_op

_I64_MIN = -(1 << 63)


@dataclass
class Groups:
    perm: torch.Tensor
    n_groups: int
    cap: int
    seg: torch.Tensor
    kval: torch.Tensor
    kvalid: torch.Tensor


def _keys_in(mask, keys):
    n = mask.shape[0]
    if mask.dtype != torch.bool or mask.shape != (n,):
        raise TypeError("sort_groups: mask must be bool [N]")
    if not keys:
        raise ValueError("sort_groups: no group keys")
    out = []
    for data, valid in keys:
        op = sort_op(data)
        if op.data.shape != (n,):
            raise ValueError(f"sort_groups: a key lane must be [{n}]")
        if valid is not None and (valid.dtype != torch.bool or valid.shape != (n,)):
            raise TypeError(f"sort_groups: valid must be bool [{n}]")
        out.append((op, valid))
    return n, out


def group_ops_ref(mask, keys) -> list[SortOp]:
    """The reference's sort operands (tpu_engine.py:1358-1379)."""
    _, keys = _keys_in(mask, keys)
    ops = [SortOp((~mask).to(torch.int32), "i32")]
    for op, valid in keys:
        v = torch.ones_like(mask) if valid is None else valid
        d = op.data
        if op.kind == "f64":
            zero = torch.zeros((), dtype=d.dtype, device=d.device)
            d = torch.where(d.abs() < DBL_MIN, zero, d).view(torch.int64)
        else:
            d = d.to(torch.int64)
        ops += [SortOp((~v).to(torch.int32), "i32"),
                SortOp(torch.where(v, d, torch.zeros((), dtype=torch.int64, device=d.device)), "i64")]
    return ops


def _finish_ref(ops, perm, cap_of):
    """Group starts, n_groups and the capped ids from sorted operands."""
    p = perm.long()
    n = p.shape[0]
    dev = p.device
    s = [op.data[p] for op in ops]
    s_mask = s[0] == 0
    diff = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        diff[0] = True
    for k in s[1:]:
        diff[1:] |= k[1:] != k[:-1]
    new = diff & s_mask
    seg0 = torch.cumsum(new.to(torch.int64), 0) - 1
    ng = int(new.sum())
    cap = int(cap_of(ng))
    seg_sorted = torch.where(s_mask, torch.clamp(seg0, max=cap), cap)
    seg = torch.empty(n, dtype=torch.int32, device=dev)
    seg[p] = seg_sorted.to(torch.int32)
    nk = (len(ops) - 1) // 2
    kval = torch.full((nk, cap), _I64_MIN, dtype=torch.int64, device=dev)
    kvalid = torch.full((nk, cap), -1, dtype=torch.int64, device=dev)
    first = torch.nonzero(new & (seg0 < cap)).reshape(-1)
    for j in range(nk):
        kval[j, seg0[first]] = s[2 + 2 * j][first]
        kvalid[j, seg0[first]] = 1 - s[1 + 2 * j][first].to(torch.int64)
    return Groups(perm, ng, cap, seg, kval, kvalid)


def sort_groups_ref(mask, keys, cap_of) -> Groups:
    """Plain PyTorch version: the reference's sort, diff and cumsum."""
    ops = group_ops_ref(mask, keys)
    return _finish_ref(ops, lex_sort_perm_ref(ops), cap_of)


_bound: set = set()


def _lib():
    lib = library("sort_groups")
    if "sort_groups" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_sg_tiles.argtypes = [L]
        lib.tt_sg_tiles.restype = L
        lib.tt_sg_ops.argtypes = [C, L, C, I, C, I, C]
        lib.tt_sg_ops.restype = I
        lib.tt_sg_count.argtypes = [C, C, I, C, L, C, C]
        lib.tt_sg_count.restype = I
        lib.tt_sg_segments.argtypes = [C, C, I, C, L, C, L, C, C, C, C]
        lib.tt_sg_segments.restype = I
        _bound.add("sort_groups")
    return lib


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"sort_groups: {what} launch failed (cudaError {rc})")


def sort_groups(mask: torch.Tensor, keys, cap_of) -> Groups:
    """Sorted dense group ids (module doc)."""
    dev = mask.device
    if dev.type == "cpu":
        return sort_groups_ref(mask, keys, cap_of)
    if dev.type != "cuda":
        raise ValueError(f"sort_groups: unsupported device {dev}")
    n, keys = _keys_in(mask, keys)
    for t in [mask] + [t for op, v in keys for t in (op.data, v) if t is not None]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"sort_groups: inputs must be contiguous tensors on {dev}")
    if not 0 < n < 1 << 31:
        raise ValueError(f"sort_groups: {n} rows outside 1..2^31-1")
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flag = torch.empty(n, dtype=torch.int32, device=dev)
    ops, desc, kops = [SortOp(flag, "i32")], [], []
    for op, valid in keys:
        null = torch.empty(n, dtype=torch.int32, device=dev)
        val = torch.empty(n, dtype=torch.int64, device=dev)
        ops += [SortOp(null, "i32"), SortOp(val, "i64")]
        desc.append([op.data.data_ptr(), 0 if valid is None else valid.data_ptr(), KINDS[op.kind],
                     null.data_ptr(), val.data_ptr()])
        kops.append([null.data_ptr(), val.data_ptr()])
    kd = torch.tensor(desc, dtype=torch.int64).to(dev)
    ko = torch.tensor(kops, dtype=torch.int64).to(dev)
    _raise(lib.tt_sg_ops(mask.data_ptr(), n, kd.data_ptr(), len(keys), flag.data_ptr(), n_sms, stream), "ops")
    count(sort_groups)
    perm = lex_sort_perm(ops)
    tiles = lib.tt_sg_tiles(n)
    tilecnt = torch.empty(tiles + 1, dtype=torch.int32, device=dev)
    _raise(lib.tt_sg_count(flag.data_ptr(), ko.data_ptr(), len(keys), perm.data_ptr(), n,
                           tilecnt.data_ptr(), stream), "count")
    ng = int(tilecnt[tiles])  # sync: the capacity follows n_groups
    cap = int(cap_of(ng))
    seg = torch.empty(n, dtype=torch.int32, device=dev)
    kval = torch.full((len(keys), cap), _I64_MIN, dtype=torch.int64, device=dev)
    kvalid = torch.full((len(keys), cap), -1, dtype=torch.int64, device=dev)
    _raise(lib.tt_sg_segments(flag.data_ptr(), ko.data_ptr(), len(keys), perm.data_ptr(), n,
                              tilecnt.data_ptr(), cap, seg.data_ptr(), kval.data_ptr(),
                              kvalid.data_ptr(), stream), "segments")
    return Groups(perm, ng, cap, seg, kval, kvalid)


sort_groups.launches = 0
