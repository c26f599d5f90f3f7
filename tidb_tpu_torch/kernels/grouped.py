"""K10: the grouped program — the task-grid modes of K1, the expression
kernel, K4, K6, K7 and K9, and K8's task-leading key.

Replaces tidb_tpu/copr/tpu_engine.py:1096-1134 `_vmapped_program` (with
:1065-1094 `_narrow_args`): the reference stacks the (lanes, row_valid)
of a launch group's tasks on a new leading axis, narrows every task to
`width` flattened rows and vmaps the per-task program over it, all in one
jitted dispatch. The port's per-task programs are K1 → the expression
kernel → K4 (a filter, a direct-address aggregation), → K9 (K8) → K4 (a
sort GROUP BY), → K6 (a single-key TopN; K8 orders its rows only for k
above topk.ORDER_CAP) or → K7 (a multi-key TopN; K8 orders its rows only
for k above topn_multi.order_cap), so K10 is a
task-grid mode of each of those kernels: one launch covers the G tasks
of a group, the grid's y axis being the task, each
task addressed through a table in device memory (K7's in the launch
parameters when it fits; csrc/expr_eval.cu, csrc/seg_agg.cu,
csrc/topk.cu, csrc/topn_multi.cu, csrc/sort_groups.cu say how). K1's mode is its one kernel (csrc/decode_lane.cu) over one
entry a task and coded lane, passed by value: every coded lane of every
task in one launch. Nothing is stacked: a task's lanes stay
where its batch uploaded them and its table entry points at them. The
sorts are one radix sort over the group: K8 puts the row's task in the
top bits of its key, so each task's sorted rows stay in its own slice.

Narrowing is a bound on every row loop: each task's first `width`
flattened rows are read (the group's narrowed width, or its padded one).
It is exact, as the reference's is: every kernel masks with row_valid, so
the rows past a task's real rows contribute nothing.

  decode_lanes_tasks(lanes, row_valids, width)
      every lane of every task (`lanes[k]`: lane k of each task, one codec
      across them: the program key carries the codec signature) → per
      lane, per task a flat lane of >= width rows: the task's own dense
      lane or row_valid (the all-valid alias) without a launch, else row g
      of the lane's [G, width] decode; the coded lanes in one launch
  decode_lane_tasks(encs, row_valids, width)
      one lane of every task: decode_lanes_tasks of one lane
  expr_eval_tasks(prog, ins, width)
      the same program over every task's input lanes → one [G, width]
      tensor per output slot
  seg_agg_tasks(masks, keys, lanes, nseg, width, segs=None, counts=None)
      every task's K4 reduction → (int64 [G, k_i, nseg], float64
      [G, k_f, nseg]); with K9's task-grid ids (`segs`, `counts`) every
      task's groups in ONE (int64 [k_i, nseg], float64 [k_f, nseg]) pair
  lex_sort_perm_tasks(ops, width)
      K8 over [G * width] operands by (task, operands) → int32 [G * width];
      task g's sorted rows are its slice g
  topk_tasks(datas, valids, masks, desc, k, width)
      each task's K6 TopN → (int32 [G, k] task-local rows, bool [G, k])
  topn_multi_tasks(masks, keys, k, width)
      each task's K7 TopN → (int64 [G, min(k, width)] task-local rows,
      bool [G, min(k, width)])
  sort_groups_tasks(masks, keys, width)
      each task's K9 groups → TaskGroups(perm, counts (one host read),
      seg [G, width] numbered on across the tasks, kval / kvalid [k, Σ])

Each plain version is the solo plain version applied task by task to the
task's narrowed inputs, then stacked; a wrapper takes it only for tensors
on the CPU, and on CUDA tensors launches its kernel or raises.
`<wrapper>.launches` counts the launches.

A wrapper on the card is `<wrapper>_prepare` (outputs, task table built
a column at a time by `expr_tables` here,
`seg_agg.seg_desc`, `topk.topk_table` or `tables.lane_table` and copied
up, and a `go()` that enqueues the kernel) followed by one `go()`; K8's
mode has no table (its operands are the group's own [G, width] lanes),
K1's `decode_lanes_tasks_prepare` returns the kernel's words, which
`decode_lane.launch` takes. K4's, K6's, K7's and K9's solo wrappers
launch the same kernels as a grid of one task.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..expr.xp_torch import U64
from .build import count, library
from .decode_lane import codec, decode_lane_ref, entry, launch, out_dtype
from .expr_eval import _Params, expr_eval_ref, launch_shape
from .lex_sort import SortOp, check_on, lex_sort_perm_ref, sort_op
from .lex_sort import launch as sort_launch
from .seg_agg import SegKey, SegLane, _check, seg_agg_ref, upload_desc
from .seg_agg import launch as seg_launch
from .seg_agg import plan as seg_plan
from .sort_groups import group_tasks as sort_groups_finish
from .sort_groups import ops_prepare as sort_groups_prepare
from .sort_groups import read_orand as sort_groups_orand
from .sort_groups import sort_groups_ref
from .tables import ptrs, rows, sm_count, to_card
from .topk import orders_in_kernel, topk_ref
from .topk import select_prepare as topk_tasks_prepare  # K6's task mode up to its launch
from .topn_multi import ordered as topn_multi_ordered
from .topn_multi import select_prepare as topn_multi_prepare
from .topn_multi import topn_multi_ref

_C, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_bound: set = set()


def _lib(stem: str):
    lib = library(stem)
    if stem not in _bound:
        lib.tt_expr_eval_tasks.argtypes = [ctypes.POINTER(_Params), _I, _C]
        lib.tt_expr_eval_tasks.restype = _I
        _bound.add(stem)
    return lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# --- K1's task mode ----------------------------------------------------------


def narrow_enc(enc, width: int):
    """`_narrow_args` for one lane: positional payloads (a dense lane,
    pack and dict codes) keep their first `width` flattened rows; an rle
    payload and the all-valid alias pass untouched."""
    if isinstance(enc, torch.Tensor):
        return enc.reshape(-1)[:width]
    if "p" in enc:
        return {**enc, "p": enc["p"].reshape(-1)[:width]}
    if "c" in enc:
        return {**enc, "c": enc["c"].reshape(-1)[:width]}
    return enc


def decode_lane_tasks_ref(encs: list, row_valids: list, width: int) -> list:
    """Plain version: K1's plain version on each task's narrowed lane and
    row_valid, stacked; → the rows of the [G, width] result."""
    out = torch.stack([decode_lane_ref(narrow_enc(e, width), rv.reshape(-1)[:width])
                       for e, rv in zip(encs, row_valids)])
    return list(out)


def decode_lanes_tasks_ref(lanes: list, row_valids: list, width: int) -> list:
    """Plain version of decode_lanes_tasks: decode_lane_tasks_ref lane by lane."""
    return [decode_lane_tasks_ref(encs, row_valids, width) for encs in lanes]


def _kind(encs: list) -> str:
    kinds = {codec(e) for e in encs}
    if len(kinds) != 1:
        raise ValueError(f"decode_lane_tasks: the tasks' lanes differ in codec: {sorted(kinds)}")
    return kinds.pop()


def decode_lanes_tasks_prepare(lanes: list, row_valids: list, width: int, dev: torch.device):
    """K1's task mode up to its launch: → (per lane the G tasks' flat lanes,
    the kernel's words, entries). A dense lane is each task's own, the
    all-valid alias each task's row_valid; a coded lane gets a [G, width]
    output, one entry a task (its first `width` rows into row g)."""
    outs, words, ne, flat_rvs = [], [], 0, None
    for encs in lanes:
        kind = _kind(encs)
        if kind == "dense":  # the task's own lane, read to `width` by its consumer
            outs.append([e.reshape(-1) for e in encs])
            continue
        if kind == "alias":  # the mask IS the task's row_valid, no launch
            flat_rvs = flat_rvs or [rv.reshape(-1) for rv in row_valids]
            outs.append(flat_rvs)
            continue
        dtype = out_dtype(encs[0])
        out = torch.empty((len(encs), width), dtype=dtype, device=dev)
        if width:
            size = out.element_size()
            at, step = out.data_ptr(), width * size  # row g's address: no view made for it here
            for g, e in enumerate(encs):
                if out_dtype(e) != dtype:
                    raise TypeError(f"decode_lane_tasks: task {g} decodes to {out_dtype(e)}, task 0 to {dtype}")
                words += entry(e, at + g * step, size, width, dev)
            ne += len(encs)
        outs.append(list(out))
    return outs, words, ne


def decode_lanes_tasks(lanes: list, row_valids: list, width: int) -> list:
    """Every lane of a launch group's tasks decoded (`lanes[k]`: lane k of
    each task, one codec across the tasks: the program key carries the
    codec signature) → per lane, per task a flat lane of >= width rows: the
    task's own dense lane or row_valid (the all-valid alias) without a
    launch, else row g of the lane's [G, width] decode — every coded lane
    of every task in ONE launch."""
    dev = row_valids[0].device
    if dev.type == "cpu":
        for encs in lanes:
            _kind(encs)
        return decode_lanes_tasks_ref(lanes, row_valids, width)
    if dev.type != "cuda":
        raise ValueError(f"decode_lane_tasks: unsupported device {dev}")
    outs, words, ne = decode_lanes_tasks_prepare(lanes, row_valids, width, dev)
    if ne:
        launch(words, ne, dev)
        count(decode_lane_tasks)
    return outs


def decode_lane_tasks(encs: list, row_valids: list, width: int) -> list:
    """One lane of each task of a group, decoded: decode_lanes_tasks of one
    lane (module doc)."""
    return decode_lanes_tasks([encs], row_valids, width)[0]


decode_lane_tasks.launches = 0


# --- the expression kernel's task mode ---------------------------------------


def expr_eval_tasks_ref(prog, ins: list, width: int) -> list:
    """Plain version: the solo plain version on each task's narrowed input
    lanes, stacked per output slot."""
    per_task = [expr_eval_ref(prog, [t.reshape(-1)[:width] for t in task], width) for task in ins]
    if not per_task:
        return []
    return [torch.stack([outs[j] for outs in per_task]) for j in range(len(prog.outputs))]


def expr_eval_tasks(prog, ins: list, width: int) -> list:
    """One [G, width] tensor per output slot of `prog` over the G tasks'
    input lanes (`ins[g]`: one flat lane of >= width rows per input slot,
    in slot order)."""
    G = len(ins)
    if G == 0:
        raise ValueError("expr_eval_tasks: no tasks")
    dev = ins[0][0].device if ins[0] else torch.device("cpu")
    if dev.type == "cpu":
        return expr_eval_tasks_ref(prog, ins, width)
    if dev.type != "cuda":
        raise ValueError(f"expr_eval_tasks: unsupported device {dev}")
    outs, go = expr_eval_tasks_prepare(prog, ins, width, dev)
    if width == 0:
        return outs
    go()
    count(expr_eval_tasks)
    return outs


def expr_eval_tasks_prepare(prog, ins: list, width: int, dev: torch.device):
    """The expression kernel's task mode up to its launch: the [G, width]
    outputs, the pointer tables on the card, and `go()`, which enqueues
    the kernel over them (None when width is 0: nothing to launch)."""
    G = len(ins)
    outs = [torch.empty((G, width), dtype=torch.int64 if w == 8 else torch.bool, device=dev) for w in prog.outputs]
    if width == 0:
        return outs, None
    tin, tout = expr_tables(prog, ins, outs, width)
    ops, consts = prog.tables(dev)
    n_sms = sm_count(dev)
    threads, blocks, smem, in_smem = launch_shape(prog, width, n_sms)
    solo = launch_shape(prog, 1 << 62, n_sms)[1]  # the grid that fills the card
    blocks = max(1, min(blocks, -(-solo // G)))  # the solo grid, shared out over the tasks
    t_in, t_out = to_card(tin, dev), to_card(tout, dev)
    p = _Params(ops=ops.data_ptr(), consts=consts.data_ptr(), ext_in=t_in.data_ptr(), ext_out=t_out.data_ptr(),
                n=width, nops=len(prog.ops), nk=len(prog.consts), nregs=prog.nregs, n_in=len(prog.inputs),
                n_out=len(prog.outputs), threads=threads, blocks=blocks, ops_in_smem=int(in_smem),
                nld=prog.loads, ext_ops=int(prog.ext), smem=smem)

    def go(keep=(t_in, t_out, ops, consts)):
        rc = _lib("expr_eval").tt_expr_eval_tasks(ctypes.byref(p), G, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"expr_eval_tasks: kernel launch failed (cudaError {rc})")

    return outs, go


def expr_tables(prog, ins: list, outs: list, width: int) -> tuple:
    """The expression kernel's [G, n_in] input and [G, n_out] output
    pointer tables: task g's input lanes in slot order, and row g of each
    output. Every task's slot j is checked against task 0's dtype."""
    G, n_in, n_out = len(ins), len(prog.inputs), len(prog.outputs)
    if any(len(task) != n_in for task in ins):
        raise ValueError(f"expr_eval_tasks: every task needs {n_in} input lanes")
    dev = outs[0].get_device() if outs else ins[0][0].get_device()
    tin = np.zeros((G, max(n_in, 1)), dtype=np.int64)
    for j in range(n_in):
        dtype = ins[0][j].dtype
        if ins[0][j].element_size() not in (1, 4, 8):
            raise TypeError(f"expr_eval_tasks: input slot {j} dtype {dtype}")
        tin[:, j] = ptrs([task[j] for task in ins], width, dev, dtype, f"expr_eval_tasks: input slot {j}")
    tout = np.zeros((G, max(n_out, 1)), dtype=np.int64)
    for j, o in enumerate(outs):
        tout[:, j] = rows(o, G)
    return tin, tout


expr_eval_tasks.launches = 0


# --- K4's task mode -----------------------------------------------------------


def _narrow_key(k: SegKey, width: int) -> SegKey:
    return SegKey(k.data.reshape(-1)[:width], None if k.valid is None else k.valid.reshape(-1)[:width], k.lo, k.dom)


def _narrow_lane(lane: SegLane, width: int) -> SegLane:
    cut = lambda t: None if t is None else t.reshape(-1)[:width]  # noqa: E731
    return SegLane(lane.op, cut(lane.data), cut(lane.valid), lane.fill)


def seg_agg_tasks_ref(masks: list, keys: list, lanes: list, nseg: int, width: int, segs=None, counts=None):
    """Plain version: K4's plain version on each task's narrowed lanes,
    stacked; with `segs`, on each task's ids less its offset (its groups
    are [off, off + counts[g])), concatenated along the segment axis."""
    if segs is not None:
        offs = np.concatenate([[0], np.cumsum(counts)]).tolist()
        n_i = sum(1 for lane in lanes[0] if not lane.is_float)
        dev = masks[0].device  # a task with no group adds empty columns on the tasks' device
        empty = (torch.empty((n_i, 0), dtype=torch.int64, device=dev),
                 torch.empty((len(lanes[0]) - n_i, 0), dtype=torch.float64, device=dev))
        per = [seg_agg_ref(m.reshape(-1)[:width], [], [_narrow_lane(l, width) for l in ls], c,
                           seg=sg.reshape(-1)[:width] - off) if c else empty
               for m, ls, sg, c, off in zip(masks, lanes, segs, counts, offs)]
        return torch.cat([i for i, _ in per], 1), torch.cat([f for _, f in per], 1)
    per = [seg_agg_ref(m.reshape(-1)[:width], [_narrow_key(k, width) for k in ks],
                       [_narrow_lane(l, width) for l in ls], nseg)
           for m, ks, ls in zip(masks, keys, lanes)]
    return torch.stack([i for i, _ in per]), torch.stack([f for _, f in per])


def _seg_check(keys: list, nseg: int, segs, counts) -> None:
    if segs is None:
        return
    if any(keys) or counts is None or len(segs) != len(keys) or len(counts) != len(keys) or sum(counts) != nseg:
        raise ValueError("seg_agg_tasks: a segment lane per task, no keys, and counts summing to nseg")


def seg_agg_tasks(masks: list, keys: list, lanes: list, nseg: int, width: int, segs=None, counts=None):
    """Every task's packed partials, stacked on the task axis (module doc).
    `keys[g]` / `lanes[g]` are task g's SegKey / SegLane lists: the same
    ops, fills, key bounds and dtypes in every task. With `segs` (int32
    lanes, K9's task-grid ids: task g's groups are the `counts[g]` ids
    after the earlier tasks', nseg their sum) and empty key lists, every
    task folds into ONE (int64 [k_i, nseg], float64 [k_f, nseg]) pair."""
    G = len(masks)
    if G == 0 or len(keys) != G or len(lanes) != G:
        raise ValueError("seg_agg_tasks: one mask, key list and lane list per task")
    _seg_check(keys, nseg, segs, counts)
    dev = masks[0].device
    if dev.type == "cpu":
        return seg_agg_tasks_ref(masks, keys, lanes, nseg, width, segs, counts)
    if dev.type != "cuda":
        raise ValueError(f"seg_agg_tasks: unsupported device {dev}")
    (iout, fout), go = seg_agg_tasks_prepare(masks, keys, lanes, nseg, width, dev, segs)
    go()
    count(seg_agg_tasks)
    return iout, fout


def seg_agg_tasks_prepare(masks: list, keys: list, lanes: list, nseg: int, width: int, dev: torch.device,
                          segs=None):
    """K4's task mode up to its launch: the [G, k_i, nseg] / [G, k_f,
    nseg] outputs (with `segs`: the one shared [k_i, nseg] / [k_f, nseg]
    pair), the descriptor table on the card (one pinned copy), and `go()`,
    which enqueues the kernel over them by `seg_agg.plan` (each call writes
    every output anew)."""
    _check(keys[0], lanes[0], nseg)
    if not lanes[0]:
        raise ValueError("seg_agg_tasks: no value lanes")
    G, nk, nl = len(masks), len(keys[0]), len(lanes[0])
    n_i = sum(1 for lane in lanes[0] if not lane.is_float)
    lead = () if segs is not None else (G,)
    iout = torch.empty(lead + (n_i, nseg), dtype=torch.int64, device=dev)
    fout = torch.empty(lead + (nl - n_i, nseg), dtype=torch.float64, device=dev)
    desc = upload_desc(masks, keys, lanes, width, iout, fout, segs)
    p = seg_plan(width, G, nk, nl, nseg, sm_count(dev), shared_out=segs is not None)

    def go():
        seg_launch(desc, G, width, nk, nl, nseg, segs is not None, p, "seg_agg_tasks")

    return (iout, fout), go


seg_agg_tasks.launches = 0


# --- K8's task-leading mode ----------------------------------------------------


def lex_sort_perm_tasks_ref(ops, width: int) -> torch.Tensor:
    """Plain version: K8's plain version on each task's slice of the
    operands, its permutation offset to the task's rows, concatenated."""
    ops = [sort_op(o) for o in ops]
    n = _tasks_of(ops[0].data.shape[0], width, "lex_sort_perm_tasks")
    parts = [lex_sort_perm_ref([SortOp(o.data[g * width:(g + 1) * width], o.kind) for o in ops]) + g * width
             for g in range(n)]
    return torch.cat(parts) if parts else torch.empty(0, dtype=torch.int32, device=ops[0].data.device)


def lex_sort_perm_tasks(ops, width: int) -> torch.Tensor:
    """int32 [G * width]: G tasks' rows (the operands laid out [G, width])
    sorted by (task, operands), stably — task g's sorted rows are
    perm[g * width:(g + 1) * width]. One radix sort and one OR/AND sync
    for the whole group (csrc/lex_sort.cu, task-leading mode); it has no
    task table (the operands are the group's own [G, width] lanes)."""
    ops = [sort_op(o) for o in ops]
    dev = ops[0].data.device
    if dev.type == "cpu":
        return lex_sort_perm_tasks_ref(ops, width)
    if dev.type != "cuda":
        raise ValueError(f"lex_sort_perm_tasks: unsupported device {dev}")
    n = check_on(ops, "lex_sort_perm_tasks")
    _tasks_of(n, width, "lex_sort_perm_tasks")
    return sort_launch(ops, n, width, lex_sort_perm_tasks)


def _tasks_of(n: int, width: int, what: str) -> int:
    if width <= 0 or n % width:
        raise ValueError(f"{what}: {n} rows are not whole tasks of {width}")
    return n // width


lex_sort_perm_tasks.launches = 0


def _cut(x, width: int):
    """A task's lane (a tensor, an xp_torch.U64 or None) narrowed to its
    first `width` flattened rows."""
    if x is None:
        return None
    if isinstance(x, U64):
        return U64(x.bits.reshape(-1)[:width])
    return x.reshape(-1)[:width]


# --- K6's task mode -------------------------------------------------------------


def _topk_in(datas: list, valids: list, masks: list, k: int, width: int) -> int:
    G = len(datas)
    if G == 0 or len(valids) != G or len(masks) != G:
        raise ValueError("topk_tasks: one key, valid lane and mask per task")
    if datas[0].dtype not in (torch.int64, torch.float64):
        raise TypeError(f"topk_tasks: the key is int64/float64, got {datas[0].dtype}")
    if not 0 <= k <= width:
        raise ValueError(f"topk_tasks: k={k} outside 0..{width}")
    return G


def topk_tasks_ref(datas: list, valids: list, masks: list, desc: bool, k: int, width: int):
    """Plain version: K6's plain version on each task's narrowed lanes,
    stacked."""
    _topk_in(datas, valids, masks, k, width)
    per = [topk_ref(_cut(d, width), _cut(v, width), _cut(m, width), desc, k) for d, v, m in zip(datas, valids, masks)]
    return torch.stack([i for i, _ in per]), torch.stack([o for _, o in per])


def topk_tasks(datas: list, valids: list, masks: list, desc: bool, k: int, width: int):
    """(int32 [G, k] task-local row ids, bool [G, k] their mask bits): each
    task's k best rows of its first `width`, in lax.top_k's order (K6's
    module doc) — one radix select per task over the task grid, which
    orders each task's rows itself for k up to topk.ORDER_CAP (no host
    read); above it one K8 task-leading sort of all G * k rows by (task,
    key desc, row)."""
    G = _topk_in(datas, valids, masks, k, width)
    dev = datas[0].device
    if dev.type == "cpu":
        return topk_tasks_ref(datas, valids, masks, desc, k, width)
    if dev.type != "cuda":
        raise ValueError(f"topk_tasks: unsupported device {dev}")
    if k == 0:
        return torch.empty((G, 0), dtype=torch.int32, device=dev), torch.empty((G, 0), dtype=torch.bool, device=dev)
    (cand, candu, okc), go = topk_tasks_prepare(datas, valids, masks, desc, k, width, dev)
    go()
    count(topk_tasks)
    if orders_in_kernel(k):
        return cand, okc
    # (task, u desc, row asc): ~u ascends as u descends; the row breaks ties
    perm = lex_sort_perm_tasks([SortOp(~candu.reshape(-1), "u64"), SortOp(cand.reshape(-1), "i32")], k).long()
    return cand.reshape(-1)[perm].reshape(G, k), okc.reshape(-1)[perm].reshape(G, k)


topk_tasks.launches = 0


# --- K7's task mode -------------------------------------------------------------


def _multi_in(masks: list, keys: list, k: int, width: int) -> int:
    G = len(masks)
    if G == 0 or len(keys) != G:
        raise ValueError("topn_multi_tasks: one mask and key list per task")
    if k < 0 or width < 0:
        raise ValueError(f"topn_multi_tasks: k={k}, width={width}")
    return G


def topn_multi_tasks_ref(masks: list, keys: list, k: int, width: int):
    """Plain version: K7's plain version on each task's narrowed lanes,
    stacked."""
    _multi_in(masks, keys, k, width)
    per = [topn_multi_ref(_cut(m, width), [(_cut(d, width), _cut(v, width), desc) for d, v, desc in ks], k)
           for m, ks in zip(masks, keys)]
    return torch.stack([i for i, _ in per]), torch.stack([o for _, o in per])


def topn_multi_tasks(masks: list, keys: list, k: int, width: int):
    """(int64 [G, min(k, width)] task-local row ids, bool [G, min(k,
    width)] their mask bits): each task's first rows of its first `width`
    in the multi-key order (K7's module doc; `keys[g]` is task g's [(data,
    valid, desc)], the same kinds and orders in every task) — one radix
    select per task over the task grid, which orders each task's rows
    itself for k up to topn_multi.order_cap (no host read); above it one
    K8 task-leading sort of all G * k rows by (task, their words)."""
    G = _multi_in(masks, keys, k, width)
    dev = masks[0].device
    if dev.type == "cpu":
        return topn_multi_tasks_ref(masks, keys, k, width)
    if dev.type != "cuda":
        raise ValueError(f"topn_multi_tasks: unsupported device {dev}")
    k = min(k, width)
    if k == 0:
        return torch.empty((G, 0), dtype=torch.int64, device=dev), torch.empty((G, 0), dtype=torch.bool, device=dev)
    idx, ok, words = topn_multi_tasks_prepare(masks, keys, k, width, dev)()
    count(topn_multi_tasks)
    return topn_multi_ordered(idx, ok, words, lambda ops: lex_sort_perm_tasks(ops, k))


def topn_multi_tasks_prepare(masks: list, keys: list, k: int, width: int, dev: torch.device):
    """K7's task mode up to its launch: `go()` (topn_multi.select_prepare;
    the task table is built a column at a time)."""
    return topn_multi_prepare(masks, [[(sort_op(d), v, bool(desc)) for d, v, desc in ks] for ks in keys], k, width,
                              dev)


topn_multi_tasks.launches = 0


# --- K9's task mode -------------------------------------------------------------


@dataclass
class TaskGroups:
    perm: torch.Tensor  # int32 [G * width]: K8's task-leading permutation
    counts: list  # n_groups of each task (host ints, one read)
    seg: torch.Tensor  # int32 [G, width], row order: the row's group id,
    #                    numbered on across the tasks; masked rows get the total
    kval: torch.Tensor  # int64 [nkeys, total]: each group's key bits
    kvalid: torch.Tensor  # int64 [nkeys, total]: 1 non-NULL, 0 NULL


def sort_groups_tasks_ref(masks: list, keys: list, width: int) -> TaskGroups:
    """Plain version: K9's plain version on each task's narrowed lanes at
    capacity n_groups, its ids offset by the earlier tasks' counts."""
    per = [sort_groups_ref(_cut(m, width), [(_cut(d, width), _cut(v, width)) for d, v in ks], lambda ng: ng)
           for m, ks in zip(masks, keys)]
    counts = [g.n_groups for g in per]
    total, offs = sum(counts), np.concatenate([[0], np.cumsum(counts)]).tolist()
    seg = [torch.where(g.seg < g.n_groups, g.seg + off, total).to(torch.int32) for g, off in zip(per, offs)]
    return TaskGroups(torch.cat([g.perm + i * width for i, g in enumerate(per)]), counts, torch.stack(seg),
                      torch.cat([g.kval for g in per], 1), torch.cat([g.kvalid for g in per], 1))


def sort_groups_tasks(masks: list, keys: list, width: int) -> TaskGroups:
    """Dense group ids of G tasks' sort GROUP BY (K9's module doc; `keys[g]`
    is task g's [(data, valid)]): the ops kernel over the task grid (with
    each task's masked-in count and the operands' OR / AND, read in one
    sync), one K8 task-leading sort with that OR / AND (its sorted word
    handed back where it is one word), K9's sweep, the group counts of
    every task read in ONE more sync, and the finish kernel: the group ids
    numbered on across the tasks, uncapped."""
    if not masks or len(keys) != len(masks) or not keys[0]:
        raise ValueError("sort_groups_tasks: one mask and a non-empty key list per task")
    dev = masks[0].device
    if dev.type == "cpu":
        return sort_groups_tasks_ref(masks, keys, width)
    if dev.type != "cuda":
        raise ValueError(f"sort_groups_tasks: unsupported device {dev}")
    if not 0 < len(masks) * width < 1 << 31:
        raise ValueError(f"sort_groups_tasks: {len(masks)} x {width} rows outside 1..2^31-1")
    ops, (mcount, orand, ktab), go = sort_groups_tasks_prepare(masks, keys, width, dev)
    go()
    count(sort_groups_tasks)
    G = len(masks)
    perm, words, key_bytes = sort_launch(ops, G * width, width, lex_sort_perm_tasks, orand=sort_groups_orand(orand),
                                         keys=True)
    counts, _, seg, kval, kvalid = sort_groups_finish(mcount, orand, ktab, perm, words, key_bytes, G, width,
                                                      lambda total: total)
    return TaskGroups(perm, counts, seg.reshape(G, width), kval, kvalid)


def sort_groups_tasks_prepare(masks: list, keys: list, width: int, dev: torch.device):
    """K9's task mode up to its ops launch: (K8's operands, (each task's
    masked-in count, the operands' OR / NOT-AND, the key table), `go()`);
    the task table is built a column at a time (sort_groups.ops_prepare)."""
    return sort_groups_prepare(masks, [[(sort_op(d), v) for d, v in ks] for ks in keys], width, dev)


sort_groups_tasks.launches = 0
