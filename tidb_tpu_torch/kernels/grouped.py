"""K10: the grouped program — task-grid modes of K1, the expression kernel
and K4.

Replaces tidb_tpu/copr/tpu_engine.py:1096-1134 `_vmapped_program` (with
:1065-1094 `_narrow_args`): the reference stacks the (lanes, row_valid)
of a launch group's tasks on a new leading axis, narrows every task to
`width` flattened rows and vmaps the per-task program over it, all in one
jitted dispatch. The per-task program of a filter or a direct-address
aggregation is K1 → the expression kernel → K4 in the port, so K10 is a
task-grid mode of each of those three kernels: one launch covers the G
tasks of a group, the grid's y axis being the task, each task addressed
through a table in device memory (csrc/decode_lane.cu, csrc/expr_eval.cu,
csrc/seg_agg.cu say how). Nothing is stacked: a task's lanes stay where
its batch uploaded them and its table entry points at them.

Narrowing is a bound on every row loop: each task's first `width`
flattened rows are read (the group's narrowed width, or its padded one).
It is exact, as the reference's is: every kernel masks with row_valid, so
the rows past a task's real rows contribute nothing.

  decode_lane_tasks(encs, row_valids, width)
      one lane of every task (the same codec: the program key carries the
      codec signature) → per task a flat lane of >= width rows: the
      task's own dense lane or row_valid (the all-valid alias) without a
      launch, else row g of one [G, width] decode
  expr_eval_tasks(prog, ins, width)
      the same program over every task's input lanes → one [G, width]
      tensor per output slot
  seg_agg_tasks(masks, keys, lanes, nseg, width)
      every task's K4 reduction → (int64 [G, k_i, nseg], float64
      [G, k_f, nseg])

Each plain version is the solo plain version applied task by task to the
task's narrowed inputs, then stacked; a wrapper takes it only for tensors
on the CPU, and on CUDA tensors launches its kernel or raises.
`<wrapper>.launches` counts the launches.

A wrapper on the card is `<wrapper>_prepare` (outputs, task table built
a column at a time by `decode_table` / `expr_tables` / `seg_desc` and
copied up, and a `go()` that enqueues the kernel) followed by one `go()`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import count, library
from .decode_lane import decode_lane_ref
from .expr_eval import _Params, expr_eval_ref, launch_shape
from .seg_agg import OPS, SegKey, SegLane, _check, _fill_bits, seg_agg_ref

_C, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_bound: set = set()


def _lib(stem: str):
    lib = library(stem)
    if stem not in _bound:
        if stem == "decode_lane":
            lib.tt_decode_pack_tasks.argtypes = [_C, _I, _I, _I, _L, _C]
            lib.tt_decode_dict_tasks.argtypes = [_C, _I, _I, _I, _L, _C]
            lib.tt_decode_rle_tasks.argtypes = [_C, _I, _I, _L, _C]
            for f in (lib.tt_decode_pack_tasks, lib.tt_decode_dict_tasks, lib.tt_decode_rle_tasks):
                f.restype = _I
        elif stem == "expr_eval":
            lib.tt_expr_eval_tasks.argtypes = [ctypes.POINTER(_Params), _I, _C]
            lib.tt_expr_eval_tasks.restype = _I
        else:
            lib.tt_seg_agg_tasks.argtypes = [_C, _I, _L, _I, _I, _L, _I, _C]
            lib.tt_seg_agg_tasks.restype = _I
        _bound.add(stem)
    return lib


def _table(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host-built int64 table on the card, copied from pinned memory
    without a host synchronization (the copy is ordered before the launch
    on the current stream). The caller keeps the result alive until the
    launch is enqueued."""
    return torch.from_numpy(np.ascontiguousarray(host, dtype=np.int64)).pin_memory().to(dev, non_blocking=True)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _rows(out: torch.Tensor, G: int) -> np.ndarray:
    """Addresses of the G rows of a contiguous [G, ...] tensor (0 when it
    is empty: no kernel reads a row of it)."""
    if out.numel() == 0:
        return np.zeros(G, dtype=np.int64)
    return out.data_ptr() + np.arange(G, dtype=np.int64) * (out.stride(0) * out.element_size())


def _ptrs(ts: list, width: int, dev: int, dtype, what: str) -> np.ndarray:
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


def _codec(enc) -> str:
    if isinstance(enc, torch.Tensor):
        return "dense"
    if not enc:
        return "alias"
    return "pack" if "p" in enc else "dict" if "c" in enc else "rle"


def decode_lane_tasks(encs: list, row_valids: list, width: int) -> list:
    """One lane of each task of a group, decoded (module doc)."""
    kinds = {_codec(e) for e in encs}
    if len(kinds) != 1:
        raise ValueError(f"decode_lane_tasks: the tasks' lanes differ in codec: {sorted(kinds)}")
    kind = kinds.pop()
    if kind == "dense":  # the task's own lane, read to `width` by its consumer
        return [e.reshape(-1) for e in encs]
    if kind == "alias":  # the mask IS the task's row_valid, no launch
        return [rv.reshape(-1) for rv in row_valids]
    dev = row_valids[0].device
    if dev.type == "cpu":
        return decode_lane_tasks_ref(encs, row_valids, width)
    if dev.type != "cuda":
        raise ValueError(f"decode_lane_tasks: unsupported device {dev}")
    out, go = decode_lane_tasks_prepare(kind, encs, width, dev)
    go()
    count(decode_lane_tasks)
    return list(out)


def decode_lane_tasks_prepare(kind: str, encs: list, width: int, dev: torch.device):
    """K1's task mode up to its launch: the [G, width] output and its task
    table on the card, and `go()`, which enqueues the kernel over them
    (and may be called again: the table stays alive with it)."""
    if kind == "pack":
        dtype = encs[0]["b"].dtype
        if dtype not in (torch.int32, torch.int64):
            raise TypeError("decode_lane_tasks: pack bases are int32 or int64")
    else:
        dtype = (encs[0]["v"] if kind == "dict" else encs[0]["rv"]).dtype
    out = torch.empty((len(encs), width), dtype=dtype, device=dev)
    # rle: inclusive run ends of every task at once (glue, as the solo mode's)
    ends = torch.cumsum(torch.stack([e["rl"] for e in encs]).to(torch.int64), 1) if kind == "rle" else None
    tab = _table(decode_table(kind, encs, width, out, ends), dev)
    lib, G = _lib("decode_lane"), len(encs)
    if kind == "pack":
        args = (lib.tt_decode_pack_tasks, tab.data_ptr(), G, encs[0]["p"].element_size(), out.element_size(), width)
    elif kind == "dict":
        args = (lib.tt_decode_dict_tasks, tab.data_ptr(), G, encs[0]["c"].element_size(), out.element_size(), width)
    else:
        args = (lib.tt_decode_rle_tasks, tab.data_ptr(), G, out.element_size(), width)

    def go(tab=tab, ends=ends):
        rc = args[0](*args[1:], _stream(dev))
        if rc != 0:
            raise RuntimeError(f"decode_lane_tasks: kernel launch failed (cudaError {rc})")

    return out, go


def decode_table(kind: str, encs: list, width: int, out: torch.Tensor, ends=None) -> np.ndarray:
    """K1's [G, 5] task table (TaskLane of csrc/decode_lane.cu): pack
    (codes, 0, 0, base, out row), dict (codes, vocab, vocab size, 0, out
    row), rle (values, run ends row, runs, 0, out row). Every task's lane
    is checked against task 0's: one code width, one base / vocab / value
    dtype and shape."""
    G, dev = len(encs), out.get_device()
    tab = np.zeros((G, 5), dtype=np.int64)
    tab[:, 4] = _rows(out, G)
    if kind == "pack":
        codes = [e["p"] for e in encs]
        if len({c.element_size() for c in codes}) != 1 or len({e["b"].dtype for e in encs}) != 1:
            raise ValueError("decode_lane_tasks: pack code widths or base dtypes differ")
        tab[:, 0] = _ptrs(codes, width, dev, codes[0].dtype, "decode_lane_tasks: pack codes")
        tab[:, 3] = [int(e["b"]) for e in encs]
    elif kind == "dict":
        codes, vocabs = [e["c"] for e in encs], [e["v"] for e in encs]
        if len({(v.dtype, v.shape) for v in vocabs}) != 1 or len({c.element_size() for c in codes}) != 1:
            raise ValueError("decode_lane_tasks: dict vocab shapes or code widths differ")
        tab[:, 0] = _ptrs(codes, width, dev, codes[0].dtype, "decode_lane_tasks: dict codes")
        tab[:, 1] = _ptrs(vocabs, 1, dev, vocabs[0].dtype, "decode_lane_tasks: dict vocab")
        tab[:, 2] = vocabs[0].shape[0]
    else:
        vals = [e["rv"] for e in encs]
        if len({(v.dtype, v.shape) for v in vals}) != 1:
            raise ValueError("decode_lane_tasks: rle run arrays differ in shape")
        tab[:, 0] = _ptrs(vals, 1, dev, vals[0].dtype, "decode_lane_tasks: rle values")
        tab[:, 1] = _rows(ends, G)
        tab[:, 2] = vals[0].shape[0]
    return tab


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
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads, blocks, smem, in_smem = launch_shape(prog, width, n_sms)
    blocks = max(1, min(blocks, -(-n_sms * (2048 // threads) // G)))  # the solo grid, shared out
    t_in, t_out = _table(tin, dev), _table(tout, dev)
    p = _Params(ops=ops.data_ptr(), consts=consts.data_ptr(), ext_in=t_in.data_ptr(), ext_out=t_out.data_ptr(),
                n=width, nops=len(prog.ops), nk=len(prog.consts), nregs=prog.nregs, n_in=len(prog.inputs),
                n_out=len(prog.outputs), threads=threads, blocks=blocks, ops_in_smem=int(in_smem), smem=smem)

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
        tin[:, j] = _ptrs([task[j] for task in ins], width, dev, dtype, f"expr_eval_tasks: input slot {j}")
    tout = np.zeros((G, max(n_out, 1)), dtype=np.int64)
    for j, o in enumerate(outs):
        tout[:, j] = _rows(o, G)
    return tin, tout


expr_eval_tasks.launches = 0


# --- K4's task mode -----------------------------------------------------------


def _narrow_key(k: SegKey, width: int) -> SegKey:
    return SegKey(k.data.reshape(-1)[:width], None if k.valid is None else k.valid.reshape(-1)[:width], k.lo, k.dom)


def _narrow_lane(lane: SegLane, width: int) -> SegLane:
    cut = lambda t: None if t is None else t.reshape(-1)[:width]  # noqa: E731
    return SegLane(lane.op, cut(lane.data), cut(lane.valid), lane.fill)


def seg_agg_tasks_ref(masks: list, keys: list, lanes: list, nseg: int, width: int):
    """Plain version: K4's plain version on each task's narrowed lanes,
    stacked."""
    per = [seg_agg_ref(m.reshape(-1)[:width], [_narrow_key(k, width) for k in ks],
                       [_narrow_lane(l, width) for l in ls], nseg)
           for m, ks, ls in zip(masks, keys, lanes)]
    return torch.stack([i for i, _ in per]), torch.stack([f for _, f in per])


def seg_agg_tasks(masks: list, keys: list, lanes: list, nseg: int, width: int):
    """Every task's packed partials, stacked on the task axis (module doc).
    `keys[g]` / `lanes[g]` are task g's SegKey / SegLane lists: the same
    ops, fills, key bounds and dtypes in every task."""
    G = len(masks)
    if G == 0 or len(keys) != G or len(lanes) != G:
        raise ValueError("seg_agg_tasks: one mask, key list and lane list per task")
    dev = masks[0].device
    if dev.type == "cpu":
        return seg_agg_tasks_ref(masks, keys, lanes, nseg, width)
    if dev.type != "cuda":
        raise ValueError(f"seg_agg_tasks: unsupported device {dev}")
    (iout, fout), go = seg_agg_tasks_prepare(masks, keys, lanes, nseg, width, dev)
    go()
    count(seg_agg_tasks)
    return iout, fout


def seg_agg_tasks_prepare(masks: list, keys: list, lanes: list, nseg: int, width: int, dev: torch.device):
    """K4's task mode up to its launch: the [G, k_i, nseg] / [G, k_f,
    nseg] outputs, the descriptor table on the card, and `go()`, which
    enqueues the kernels over them (each call starts the outputs anew from
    the fills)."""
    _check(keys[0], lanes[0], nseg)
    if not lanes[0]:
        raise ValueError("seg_agg_tasks: no value lanes")
    G, nk, nl = len(masks), len(keys[0]), len(lanes[0])
    n_i = sum(1 for lane in lanes[0] if not lane.is_float)
    iout = torch.empty((G, n_i, nseg), dtype=torch.int64, device=dev)
    fout = torch.empty((G, nl - n_i, nseg), dtype=torch.float64, device=dev)
    desc = torch.empty(G * (6 + 5 * nk + 4 * nl), dtype=torch.int64, device=dev)
    desc.copy_(torch.from_numpy(seg_desc(masks, keys, lanes, width, desc.data_ptr(), iout, fout)).pin_memory(),
               non_blocking=True)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def go():
        rc = _lib("seg_agg").tt_seg_agg_tasks(desc.data_ptr(), G, width, nk, nl, nseg, n_sms, _stream(dev))
        if rc != 0:
            raise RuntimeError(f"seg_agg_tasks: kernel launch failed (cudaError {rc})")

    return (iout, fout), go


def seg_agg_tasks_check(keys: list, lanes: list) -> None:
    """Every task's key and lane shapes against task 0's: the same count,
    ops, fills and key bounds (dtypes are checked with the pointers)."""
    k0 = [(k.lo, k.dom) for k in keys[0]]
    l0 = [(l.op, l.fill) for l in lanes[0]]
    for g in range(1, len(keys)):
        if [(k.lo, k.dom) for k in keys[g]] != k0 or [(l.op, l.fill) for l in lanes[g]] != l0:
            raise ValueError(f"seg_agg_tasks: task {g}'s lanes differ from task 0's")


def seg_desc(masks: list, keys: list, lanes: list, width: int, base: int, iout: torch.Tensor,
             fout: torch.Tensor) -> np.ndarray:
    """K4's descriptor table, to be copied to the int64 tensor at `base`
    (laid out as the structs of csrc/seg_agg.cu): G TaskAgg entries, then
    every task's KeyDesc rows, then every task's LaneDesc rows. Built a
    column at a time over the tasks."""
    seg_agg_tasks_check(keys, lanes)
    G, nk, nl = len(masks), len(keys[0]), len(lanes[0])
    dev = iout.get_device()
    k0, l0 = G * 6, G * (6 + 5 * nk)
    host = np.zeros(G * (6 + 5 * nk + 4 * nl), dtype=np.int64)
    task, keyd, laned = host[:k0].reshape(G, 6), host[k0:l0].reshape(G, nk, 5), host[l0:].reshape(G, nl, 4)
    g = np.arange(G, dtype=np.int64)
    task[:, 0] = _ptrs(masks, width, dev, torch.bool, "seg_agg_tasks: mask")
    task[:, 2] = base + 8 * (k0 + g * 5 * nk)
    task[:, 3] = base + 8 * (l0 + g * 4 * nl)
    task[:, 4], task[:, 5] = _rows(iout, G), _rows(fout, G)
    for j, k in enumerate(keys[0]):
        col = [ks[j] for ks in keys]
        keyd[:, j, 0] = _ptrs([c.data for c in col], width, dev, k.data.dtype, "seg_agg_tasks: key data")
        keyd[:, j, 1] = _ptrs([c.valid for c in col], width, dev, None, "seg_agg_tasks: key valid")
        keyd[:, j, 2:] = (k.lo, k.dom, k.data.element_size())
    n_i = n_f = 0
    for j, lane in enumerate(lanes[0]):
        col = [ls[j] for ls in lanes]
        what = f"seg_agg_tasks: {lane.op}"
        laned[:, j, 0] = _ptrs([c.data for c in col], width, dev, None if lane.data is None else lane.data.dtype,
                               what + " data")
        laned[:, j, 1] = _ptrs([c.valid for c in col], width, dev, None, what + " valid")
        laned[:, j, 2] = _fill_bits(lane)
        laned[:, j, 3] = OPS[lane.op] | ((n_f if lane.is_float else n_i) << 32)  # its output row
        n_f, n_i = (n_f + 1, n_i) if lane.is_float else (n_f, n_i + 1)
    return host


seg_agg_tasks.launches = 0
