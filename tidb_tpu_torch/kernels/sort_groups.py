"""K9: dense group ids of a sort-based GROUP BY.

Replaces tidb_tpu/copr/tpu_engine.py:1351-1400 (the kernel of
TPUEngine._lower_agg_sorted) up to its segment reductions: the sort
operands, K8's permutation (kernels/lex_sort.py), group starts, n_groups,
capped segment ids and each group's key words. K4 (kernels/seg_agg.py,
its `seg` mode) reduces the value lanes over those ids. The CUDA kernels
are csrc/sort_groups.cu (its note gives the steps and the bound);
`sort_groups_ref` is the plain PyTorch version beside them.

`sort_groups(mask, keys, cap_of)`:

  * mask   — bool [N], the filter mask (row_valid included)
  * keys   — [(data, valid)]: data an int32 / int64 / float64 tensor or an
             xp_torch.U64 [N], valid bool [N] or None (all valid); any
             number of keys (the kernels read them through a table on
             the card, KEY_FIELDS a row)
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

On the card the call compacts the masked-in rows with their operands
(csrc/compact.cuh's tile; M of them, with each operand's OR/AND, in its
first host read), K8 sorts those M rows alone (`compact.sort_kept_ops`),
one sweep numbers the groups (n_groups is the second read), and one
kernel writes the keys and the masked rows' ids; every kernel reads the
keys through a key table on the card (KEY_FIELDS a row), which the
compaction's entry point writes from the call's words. `perm` is built when it
is first read (`Groups.perm`): the kept rows in K8's order, then the
masked rows sorted by their own operands (a stable sort by (flag, keys)
is that: `split_perm_ref` is its plain form). The engine never reads it.
Until then the Groups holds the kept and masked rows' ids (8 bytes a row)
and K8's permutation of the kept rows, not the call's workspace; the
read waits for the call's stream, and reads the key lanes again, so the
caller keeps them unchanged until it reads `perm`.

`sort_groups` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernels or raises; `sort_groups.launches`
counts the calls that launched.

K10's task-grid mode is kernels/grouped.py `sort_groups_tasks`: the ops
kernel over every task's rows (`ops_prepare`, which also counts each
task's masked-in rows and takes every operand's OR / AND: the first host
read, `read_orand`), K8's task-leading sort of (task, flag, keys) with
that OR / AND, and `group_tasks` — the same sweep and the task mode's
finish kernel, the ids numbered on across the tasks, every task's count
in the second.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import compact
from . import lex_sort as k8
from .build import count, library
from .lex_sort import DBL_MIN, KINDS, SortOp, lex_sort_perm_ref, sort_op
from .tables import dev_index, lane_table, sm_count, stream_scratch, to_card

_I64_MIN = -(1 << 63)
KEY_FIELDS = ("kind", "data", "valid", "nul", "val")  # a key's row of the key table: csrc/sort_groups.cu KeyRow


class Groups:
    """K9's outputs (module doc). `perm` may be given as a function that
    builds it: it is built on its first read (on the card, from the key
    lanes as they are then)."""

    def __init__(self, perm, n_groups: int, cap: int, seg: torch.Tensor, kval: torch.Tensor, kvalid: torch.Tensor):
        self._perm = perm
        self.n_groups, self.cap, self.seg, self.kval, self.kvalid = n_groups, cap, seg, kval, kvalid

    @property
    def perm(self) -> torch.Tensor:
        if callable(self._perm):
            self._perm = self._perm()
        return self._perm


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


def split_perm_ref(ops: list[SortOp]) -> torch.Tensor:
    """The permutation the card builds, in plain form: the rows whose flag
    operand (ops[0]) is 0 stably sorted by the other operands, then the
    others, stably sorted by them too — lex_sort_perm_ref(ops) for a flag
    of 0 / 1."""
    keep = ops[0].data == 0
    parts = []
    for sel in (keep, ~keep):
        rows = torch.nonzero(sel).flatten()
        if rows.numel():
            sub = lex_sort_perm_ref([SortOp(o.data[rows], o.kind) for o in ops[1:]]).long()
            parts.append(rows[sub])
    if not parts:
        return torch.empty(0, dtype=torch.int32, device=ops[0].data.device)
    return torch.cat(parts).to(torch.int32)


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
        for fn in ("tt_sg_compact", "tt_sg_sweep", "tt_sg_finish_solo", "tt_sg_finish_tasks", "tt_sg_tail_ops",
                   "tt_sg_perm"):
            getattr(lib, fn).argtypes = [C, I, I, C]
            getattr(lib, fn).restype = I
        lib.tt_sg_compact_scratch.argtypes = [L, I]
        lib.tt_sg_compact_scratch.restype = L
        lib.tt_sg_sweep_scratch.argtypes = [L]
        lib.tt_sg_sweep_scratch.restype = L
        lib.tt_sg_ops.argtypes = [C, I, L, C, I, C, C, C, I, C]
        lib.tt_sg_ops.restype = I
        _bound.add("sort_groups")
    return lib


def _call(fn: str, words: list, dev: torch.device) -> None:
    w = np.array(words, dtype=np.int64)
    rc = getattr(_lib(), fn)(w.ctypes.data, len(w), sm_count(dev), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sort_groups: {fn} launch failed (cudaError {rc})")


def _ptr(t) -> int:
    """A tensor's address, an address as it is, 0 for None."""
    return 0 if t is None else t if isinstance(t, int) else t.data_ptr()


def _key_rows(keys, nuls, vals, lanes: bool = True) -> np.ndarray:
    """int64 [nk, KEY_FIELDS] key table of checked keys [(SortOp, valid)]:
    per key its kind, its lanes' addresses (0 without `lanes`: the task
    mode's task table holds each task's) and its operands'."""
    out = np.zeros((len(vals), len(KEY_FIELDS)), dtype=np.int64)
    for j, ((op, valid), nul, val) in enumerate(zip(keys, nuls, vals)):
        out[j] = (KINDS[op.kind], _ptr(op.data) if lanes else 0, _ptr(valid) if lanes else 0, _ptr(nul), _ptr(val))
    return out


def _i32(buf: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """int32 [n] at int64 word `off` of a workspace."""
    return buf[off:off + (n + 1) // 2].view(torch.int32)[:n]


def _sweep(dev, npos: int, width: int, mcount, perm, crow, words, key_bytes: int, ktab: int, nk: int, orand: int,
           notand: bool, seg, first, ends) -> np.ndarray:
    """The sweep over npos sorted positions (csrc sweep_kernel; `ktab` the
    key table's address, `orand` its operands' OR / AND words') and the
    host read of `ends` (int64 [G]): → the groups up to each task's end."""
    w = [npos, width, _ptr(mcount), perm.data_ptr(), _ptr(crow), _ptr(words), key_bytes, ktab, nk, orand,
         int(notand), seg.data_ptr(), _ptr(first), ends.data_ptr()]
    with stream_scratch("sort_groups", dev, _lib().tt_sg_sweep_scratch(npos)) as ws:
        _call("tt_sg_sweep", w + [ws.data_ptr()], dev)
    return compact.fetch(ends)


def _finish(fn: str, dev, cap: int, ng: int, ktab: int, nk: int, first, seg, mode: list):
    """kval / kvalid over [0, cap), seg = cap at the masked rows: csrc
    solo_finish_kernel (fn tt_sg_finish_solo, `mode` = [tail, ntail, crow,
    nclamp]) or task_finish_kernel (tt_sg_finish_tasks, [perm, mcount,
    width, npos]) → (kval, kvalid)."""
    kk = torch.empty((2, nk, cap), dtype=torch.int64, device=dev)
    _call(fn, [cap, ng, ktab, nk, _ptr(first), kk.data_ptr(), kk.data_ptr() + 8 * nk * cap, seg.data_ptr()] + mode,
          dev)
    return kk[0], kk[1]


def sort_groups(mask: torch.Tensor, keys, cap_of) -> Groups:
    """Sorted dense group ids (module doc): two host reads, M then
    n_groups."""
    dev = mask.device
    if dev.type == "cpu":
        return sort_groups_ref(mask, keys, cap_of)
    if dev.type != "cuda":
        raise ValueError(f"sort_groups: unsupported device {dev}")
    n, keys = _keys_in(mask, keys)
    if not 0 < n < 1 << 31:
        raise ValueError(f"sort_groups: {n} rows outside 1..2^31-1")
    nk = len(keys)
    for t in [mask] + [x for op, valid in keys for x in (op.data, valid) if x is not None]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"sort_groups: inputs must be contiguous tensors on {dev}")
    nv = [valid is not None for _, valid in keys]
    tw = len(KEY_FIELDS) * nk
    buf, offs = compact.workspace(dev, [8 * n] * nk + [4 * n] * sum(nv) + [4 * n, 8 * tw, 8 * (1 + 4 * nk), 8])
    val_off, it = offs[:nk], iter(offs[nk:])
    nul_off = [next(it) if v else None for v in nv]
    o_first, o_ktab, o_res, o_ends = it
    adr = lambda o: 0 if o is None else buf.data_ptr() + 8 * o  # noqa: E731 — arrays by address: few tensors
    nul_at, val_at = [adr(o) for o in nul_off], [adr(o) for o in val_off]
    first, ktab, res, ends = adr(o_first), adr(o_ktab), buf[o_res:o_res + 1 + 4 * nk], buf[o_ends:o_ends + 1]
    rows = torch.empty(2 * n, dtype=torch.int32, device=dev)  # the kept rows' ids (crow), then the masked rows'
    crow, tail = rows.data_ptr(), rows.data_ptr() + 4 * n
    table = [ktab, nk] + _key_rows(keys, nul_at, val_at).reshape(-1).tolist()  # written to ktab by the entry point
    lib = _lib()
    with stream_scratch("sort_groups", dev, lib.tt_sg_compact_scratch(n, nk)) as ws:
        _call("tt_sg_compact", [n, mask.data_ptr()] + table + [crow, tail, res.data_ptr(), ws.data_ptr()], dev)
    count(sort_groups)
    seg = torch.empty(n, dtype=torch.int32, device=dev)
    m, orand = compact.read(res)  # the first host read: M and every operand's OR/AND
    perm_m = None
    ng = 0
    if m:
        ops, oa = [], []
        for j in range(nk):
            if nv[j]:
                ops.append(SortOp(_i32(buf, nul_off[j], m), "i32"))
                oa += list(orand[4 * j:4 * j + 2])
            ops.append(SortOp(buf[val_off[j]:val_off[j] + m], "i64"))
            oa += list(orand[4 * j + 2:4 * j + 4])
        perm_m, words, kb = compact.sort_kept_ops(ops, m, np.array(oa, dtype=np.uint64))
        ng = int(_sweep(dev, m, m, None, perm_m, crow, words, kb, ktab, nk, res.data_ptr() + 8, False, seg, first,
                        ends)[0])  # the second read
    cap = int(cap_of(ng))
    kval, kvalid = _finish("tt_sg_finish_solo", dev, cap, ng, ktab, nk, first, seg,
                           [tail, n - m, crow, m if cap < ng else 0])
    made_on = torch.cuda.current_stream(dev)

    def perm():  # holds rows and perm_m (not the workspace) until the permutation is built
        on = torch.cuda.current_stream(dev)
        if on != made_on:  # after the call's kernels; rows and perm_m stay allocated until this stream's read
            on.wait_stream(made_on)
            for t in (rows, perm_m):
                if t is not None:
                    t.record_stream(on)
        ntail, pt = n - m, None
        if ntail:  # the masked rows, sorted by their own operands
            tb, toffs = compact.workspace(dev, [8 * tw] + [8 * ntail] * nk + [4 * ntail] * sum(nv))
            tvals = [tb[o:o + ntail] for o in toffs[1:nk + 1]]
            tit = iter(toffs[nk + 1:])
            tnuls = [_i32(tb, next(tit), ntail) if v else None for v in nv]
            table = [tb.data_ptr(), nk] + _key_rows(keys, tnuls, tvals).reshape(-1).tolist()
            _call("tt_sg_tail_ops", [ntail, tail] + table, dev)
            tops = [SortOp(x, kind) for nul, val in zip(tnuls, tvals)
                    for x, kind in ((nul, "i32"), (val, "i64")) if x is not None]
            pt = k8.launch(tops, ntail, 0, k8.lex_sort_perm)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        _call("tt_sg_perm", [n, m, crow, _ptr(perm_m), tail, _ptr(pt), out.data_ptr()], dev)
        return out

    return Groups(perm, ng, cap, seg, kval, kvalid)


sort_groups.launches = 0


# --- K10's task-grid mode (kernels/grouped.py sort_groups_tasks) -----------------


def ops_prepare(masks: list, keys: list, width: int, dev: torch.device):
    """The ops kernel of G tasks up to its launch: (K8's operands over the
    [G * width] outputs, (each task's masked-in count int32 [G], every
    operand's OR / NOT-AND int64 [2 * len(operands)] as the kernel writes
    them, the key table on the card), `go()`, which enqueues the kernel).
    `masks[g]` is task g's mask, `keys[g]` its checked [(SortOp, valid)]
    (the same kinds in every task); each is read to `width` rows."""
    G, nk = len(masks), len(keys[0])
    n = G * width
    buf, offs = compact.workspace(dev, [4 * n] + [4 * n, 8 * n] * nk + [4 * G, 8 * (2 + 4 * nk)])
    flag = _i32(buf, offs[0], n)
    ops = [SortOp(flag, "i32")]
    tasks = lane_table(masks, keys, width, dev_index(dev), "sort_groups")
    nuls, vals = [], []
    for j in range(nk):
        nuls.append(_i32(buf, offs[1 + 2 * j], n))
        vals.append(buf[offs[2 + 2 * j]:offs[2 + 2 * j] + n])
        ops += [SortOp(nuls[j], "i32"), SortOp(vals[j], "i64")]
    mcount, orand = _i32(buf, offs[-2], G), buf[offs[-1]:offs[-1] + 2 + 4 * nk]
    tab = to_card(np.concatenate([tasks.reshape(-1), _key_rows(keys[0], nuls, vals, lanes=False).reshape(-1)]), dev)
    ktab = tab[tasks.size:]
    n_sms = sm_count(dev)

    def go(keys=keys):  # the key lanes (sort_op may have made them) live until the launch is enqueued
        rc = _lib().tt_sg_ops(tab.data_ptr(), G, width, ktab.data_ptr(), nk, flag.data_ptr(), mcount.data_ptr(),
                              orand.data_ptr(), n_sms, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sort_groups: ops launch failed (cudaError {rc})")

    return ops, (mcount, orand, ktab), go


def read_orand(orand: torch.Tensor) -> np.ndarray:
    """uint64 [OR, AND, ...] of the ops kernel's OR / NOT-AND words: the
    task mode's first host read, which K8 takes in place of its own."""
    w = compact.fetch(orand).view(np.uint64)
    w[1::2] = ~w[1::2]
    return w


def group_tasks(mcount: torch.Tensor, orand: torch.Tensor, ktab: torch.Tensor, perm: torch.Tensor, words,
                key_bytes: int, G: int, width: int, cap_of):
    """Number the groups of K8's task-leading sort (`words`: its sorted
    word, or None; `mcount`, `orand` and `ktab` as ops_prepare gives them):
    → (n_groups per task, capacity, seg, kval, kvalid). One host read of
    every task's count; `cap_of(total)` chooses the capacity."""
    dev, n, nk = perm.device, G * width, ktab.numel() // len(KEY_FIELDS)
    buf, (o_first, o_ends) = compact.workspace(dev, [4 * n, 8 * G])
    first, ends = _i32(buf, o_first, n), buf[o_ends:o_ends + G]
    seg = torch.empty(n, dtype=torch.int32, device=dev)
    ends_h = _sweep(dev, n, width, mcount, perm, None, words, key_bytes, ktab.data_ptr(), nk, orand.data_ptr() + 16,
                    True, seg, first, ends)  # the keys' words follow the flag's two
    per_task = np.diff(np.concatenate([[0], ends_h])).tolist()
    total = int(ends_h[-1])
    cap = int(cap_of(total))
    kval, kvalid = _finish("tt_sg_finish_tasks", dev, cap, total, ktab.data_ptr(), nk, first, seg,
                           [perm.data_ptr(), mcount.data_ptr(), width, n])
    return per_task, cap, seg, kval, kvalid
