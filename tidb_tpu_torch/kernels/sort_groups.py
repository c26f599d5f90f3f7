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

`ops_prepare` / `finish` drive the kernels for G tasks; the solo call is
G = 1, and K10's task-grid mode is kernels/grouped.py
`sort_groups_tasks` (the group ids numbered on across the tasks, one
host read of every task's n_groups).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .build import count, library
from .lex_sort import DBL_MIN, KINDS, SortOp, lex_sort_perm, lex_sort_perm_ref, sort_op
from .tables import dev_index, lane_table, to_card

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
        lib.tt_sg_ops.argtypes = [C, I, L, C, I, C, I, C]
        lib.tt_sg_ops.restype = I
        lib.tt_sg_count.argtypes = [C, C, I, C, I, L, C, C, C]
        lib.tt_sg_count.restype = I
        lib.tt_sg_segments.argtypes = [C, C, I, C, I, L, C, L, C, C, C, C]
        lib.tt_sg_segments.restype = I
        _bound.add("sort_groups")
    return lib


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"sort_groups: {what} launch failed (cudaError {rc})")


def ops_prepare(masks: list, keys: list, width: int, dev: torch.device):
    """The ops kernel of G tasks up to its launch: (K8's operands over the
    [G * width] outputs, the key-operand table on the card, `go()`, which
    enqueues the kernel). `masks[g]` is task g's mask, `keys[g]` its
    checked [(SortOp, valid)] (the same kinds in every task); each is read
    to `width` rows."""
    G, nk = len(masks), len(keys[0])
    n = G * width
    flag = torch.empty(n, dtype=torch.int32, device=dev)
    ops, kops = [SortOp(flag, "i32")], []
    tasks = lane_table(masks, keys, width, dev_index(dev), "sort_groups")
    kdesc = np.zeros((nk, 3), dtype=np.int64)  # the table's key rows, shared by the tasks
    for j, (op, _) in enumerate(keys[0]):
        null = torch.empty(n, dtype=torch.int32, device=dev)
        val = torch.empty(n, dtype=torch.int64, device=dev)
        ops += [SortOp(null, "i32"), SortOp(val, "i64")]
        kdesc[j] = (KINDS[op.kind], null.data_ptr(), val.data_ptr())
        kops.append([null.data_ptr(), val.data_ptr()])
    tab = to_card(np.concatenate([tasks.reshape(-1), kdesc.reshape(-1)]), dev)
    ko = to_card(np.array(kops, dtype=np.int64), dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def go():
        _raise(_lib().tt_sg_ops(tab.data_ptr(), G, width, tab.data_ptr() + 8 * tasks.size, nk, flag.data_ptr(),
                                n_sms, torch.cuda.current_stream(dev).cuda_stream), "ops")

    return ops, ko, go


def finish(ops: list, ko: torch.Tensor, perm: torch.Tensor, G: int, width: int, cap_of):
    """Count and number the groups of K8's sorted operands: → (n_groups
    per task, capacity, seg, kval, kvalid). One host read of the counts;
    `cap_of(total)` chooses the capacity."""
    dev, nk = perm.device, len(ops) // 2
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tilecnt = torch.empty(G * lib.tt_sg_tiles(width) + 1, dtype=torch.int32, device=dev)
    counts = torch.empty(G, dtype=torch.int32, device=dev)
    _raise(lib.tt_sg_count(ops[0].data.data_ptr(), ko.data_ptr(), nk, perm.data_ptr(), G, width,
                           tilecnt.data_ptr(), counts.data_ptr(), stream), "count")
    per_task = counts.cpu().tolist()  # sync: the capacity follows n_groups
    cap = int(cap_of(sum(per_task)))
    seg = torch.empty(G * width, dtype=torch.int32, device=dev)
    kval = torch.full((nk, cap), _I64_MIN, dtype=torch.int64, device=dev)
    kvalid = torch.full((nk, cap), -1, dtype=torch.int64, device=dev)
    if cap > 0:
        _raise(lib.tt_sg_segments(ops[0].data.data_ptr(), ko.data_ptr(), nk, perm.data_ptr(), G, width,
                                  tilecnt.data_ptr(), cap, seg.data_ptr(), kval.data_ptr(), kvalid.data_ptr(),
                                  stream), "segments")
    else:  # no group at all: every row is past the (empty) capacity
        seg.zero_()
    return per_task, cap, seg, kval, kvalid


def sort_groups(mask: torch.Tensor, keys, cap_of) -> Groups:
    """Sorted dense group ids (module doc)."""
    dev = mask.device
    if dev.type == "cpu":
        return sort_groups_ref(mask, keys, cap_of)
    if dev.type != "cuda":
        raise ValueError(f"sort_groups: unsupported device {dev}")
    n, keys = _keys_in(mask, keys)
    if not 0 < n < 1 << 31:
        raise ValueError(f"sort_groups: {n} rows outside 1..2^31-1")
    ops, ko, go = ops_prepare([mask], [keys], n, dev)
    go()
    count(sort_groups)
    perm = lex_sort_perm(ops)
    (ng,), cap, seg, kval, kvalid = finish(ops, ko, perm, 1, n, cap_of)
    return Groups(perm, ng, cap, seg, kval, kvalid)


sort_groups.launches = 0
