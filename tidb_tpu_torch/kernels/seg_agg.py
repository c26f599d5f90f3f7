"""K4: masked direct-address GROUP BY partials into the packed matrices.

Replaces the aggregation kernel of tidb_tpu/copr/tpu_engine.py:1287-1304
with _seg_sum/_seg_min/_seg_max (:175-193) and _agg_partials_device
(:1527-1617). The CUDA kernel is csrc/seg_agg.cu (its note gives the ops
and what bounds it); `seg_agg_ref` is the plain PyTorch version beside it.

`seg_agg(mask, keys, lanes, nseg, seg=None)`:

  * mask  — bool [N], the filter mask (row_valid included)
  * keys  — SegKey lanes forming the mixed-radix group code; masked rows
            go to the overflow slot nseg and are dropped
  * seg   — or, with no keys, a precomputed int32 [N] segment lane (K9's
            group ids, kernels/sort_groups.py): a row at or beyond nseg is
            dropped like a masked row
  * lanes — SegLane value lanes, each with an op from OPS; rows whose
            lane `valid` is False are skipped (the reference's `ok`),
            except by first_row, which folds the index N for them.
            and_i64 / or_i64 / xor_i64 reduce bit_and / bit_or / bit_xor
            (K5's bitwise part: the reference's 64 per-bit segment
            min / max / sum % 2, recombined by shifts, :1596-1617); their
            fills are their identities -1, 0 and 0, which is what the
            reference's per-bit identities give an empty segment
  → (int64 [k_i, nseg], float64 [k_f, nseg]): lane j's result is the next
    row of the matrix its op writes, in lane order — the layout the
    reference's `_packed_program` stacks.

Where trouble lies, and what pins it (tests/test_torch_kernels.py):
  * int64 wrap: SUM_I64 wraps mod 2^64 like XLA's segment sums (Q1's
    charge sum reaches ~1.8e18 at 16M rows); a forced overflow is tested.
  * uint64 min/max: lanes carry uint64 bit patterns in int64; MIN_U64 /
    MAX_U64 order them unsigned, with sentinels in the lane's own dtype.
  * float order: SUM_F64 sums in another order than XLA's dense reduce;
    floats are held to rtol 1e-9 / atol 1e-6, everything else exactly.

`seg_agg` takes the plain version only for tensors on the CPU. On a CUDA
device it launches the kernel or raises; `seg_agg.launches` counts the
launches. There the solo call is the kernel's task grid as a grid of one
task (K10's mode, kernels/grouped.py, is the same kernel over G tasks):
`plan` picks the mode (registers, warp pre-aggregation into per-warp
slots, or global atomics), the block and the blocks per task;
`seg_desc` lays out the task table, which goes up in one pinned copy
(`upload_desc`; `solo_desc` and `launch_at` serve a caller that uploads
the table with its own, P6); `launch` enqueues it with the stream's tickets and
partials (tables.stream_scratch) when blocks merge; `seg_agg_prepare`
stops short of the launch (tests/test_torch_launch_plans.py checks the
plans, the table and a numpy model of the warp pre-aggregation).
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass

import numpy as np
import torch

from .build import count, library
from .tables import ptrs, rows, sm_count, stream_scratch

OPS = {
    "count": 0, "sum_i64": 1, "sum_f64": 2,
    "min_i64": 3, "max_i64": 4, "min_u64": 5, "max_u64": 6,
    "min_f64": 7, "max_f64": 8, "first_row": 9,
    "and_i64": 10, "or_i64": 11, "xor_i64": 12,
}
BIT_OPS = {"and_i64": -1, "or_i64": 0, "xor_i64": 0}  # op → its identity, the only fill it takes
FLOAT_OPS = ("sum_f64", "min_f64", "max_f64")
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


@dataclass
class SegKey:
    data: torch.Tensor  # int32 or int64 [N]
    valid: torch.Tensor | None  # bool [N]; None = all valid
    lo: int
    dom: int
    # P8's dense code: int32(d) - lo + 1 and the code in int32 wrap (lo an
    # int32); the kernel's form for a whole launch (launch_at's wrap32)
    wrap32: bool = False


@dataclass
class SegLane:
    op: str
    data: torch.Tensor | None = None  # int64 / float64 [N]; None for count, first_row
    valid: torch.Tensor | None = None  # bool [N]; None = every masked-in row
    fill: int | float = 0  # value of an empty segment (the op's identity)

    @property
    def is_float(self) -> bool:
        return self.op in FLOAT_OPS


def _fill_bits(lane: SegLane) -> int:
    if lane.is_float:
        return struct.unpack("<q", struct.pack("<d", float(lane.fill)))[0]
    f = int(lane.fill)
    return f - (1 << 64) if f > _I64_MAX else f


def _check(keys, lanes, nseg, seg=None) -> None:
    if nseg <= 0:
        raise ValueError("seg_agg: nseg must be positive")
    if seg is not None and (keys or seg.dtype != torch.int32 or seg.ndim != 1):
        raise ValueError("seg_agg: a segment lane is int32 [N] and replaces the key lanes")
    for lane in lanes:
        if lane.op not in OPS:
            raise ValueError(f"seg_agg: unknown op {lane.op!r}")
        want = torch.float64 if lane.is_float else torch.int64
        if lane.op not in ("count", "first_row") and (lane.data is None or lane.data.dtype != want):
            raise TypeError(f"seg_agg: {lane.op} needs a {want} data lane")
        if lane.op in BIT_OPS and int(lane.fill) != BIT_OPS[lane.op]:
            raise ValueError(f"seg_agg: {lane.op} fills with its identity {BIT_OPS[lane.op]}")
    for k in keys:
        if k.data.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"seg_agg: key lanes are int32/int64, got {k.data.dtype}")


def group_code(mask: torch.Tensor, keys: list[SegKey], nseg: int, seg=None) -> torch.Tensor:
    """Per-row segment: the mixed-radix key code (or the precomputed id),
    nseg for masked rows and ids beyond the last segment."""
    if seg is not None:
        return torch.where(mask & (seg < nseg), seg.to(torch.int64), nseg)
    code = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    for k in keys:
        kd = (k.data.to(torch.int32).to(torch.int64) if k.wrap32 else k.data.to(torch.int64)) - k.lo + 1
        if k.valid is not None:
            kd = torch.where(k.valid, kd, 0)
        code = code * (k.dom + 1) + kd
        if k.wrap32:
            code = code.to(torch.int32).to(torch.int64)
    code = torch.where(mask, code, nseg)
    return torch.where((code >= 0) & (code < nseg), code, nseg)


def seg_agg_ref(mask, keys, lanes, nseg, seg=None):
    """Plain PyTorch version of the kernel (index_add_ / scatter_reduce_)."""
    _check(keys, lanes, nseg, seg)
    dev = mask.device
    n = mask.shape[0]
    seg = group_code(mask, keys, nseg, seg)
    ints, flts = [], []
    for lane in lanes:
        s = seg if lane.valid is None or lane.op == "first_row" else torch.where(lane.valid, seg, nseg)
        if lane.op in ("count", "sum_i64", "sum_f64"):
            dt = torch.float64 if lane.is_float else torch.int64
            vals = torch.ones(n, dtype=torch.int64, device=dev) if lane.op == "count" else lane.data
            out = torch.zeros(nseg + 1, dtype=dt, device=dev).index_add_(0, s, vals)
        elif lane.op in BIT_OPS:
            out = _bitwise_ref(lane, s, nseg)
        elif lane.op == "first_row":
            rows = torch.arange(n, dtype=torch.int64, device=dev)
            if lane.valid is not None:  # a NULL row folds n, as the reference's where(ok, i, n)
                rows = torch.where(lane.valid, rows, n)
            out = torch.full((nseg + 1,), int(lane.fill), dtype=torch.int64, device=dev)
            out.scatter_reduce_(0, s, rows, "amin")
        else:
            red = "amin" if lane.op.startswith("min") else "amax"
            if lane.op.endswith("u64"):  # unsigned order: flip the sign bit
                out = torch.full((nseg + 1,), _fill_bits(lane) ^ _I64_MIN, dtype=torch.int64, device=dev)
                out.scatter_reduce_(0, s, lane.data ^ _I64_MIN, red)
                out = out ^ _I64_MIN
            else:
                dt = torch.float64 if lane.is_float else torch.int64
                out = torch.full((nseg + 1,), lane.fill, dtype=dt, device=dev)
                out.scatter_reduce_(0, s, lane.data, red)
        (flts if lane.is_float else ints).append(out[:nseg])
    return _stack(ints, torch.int64, nseg, dev), _stack(flts, torch.float64, nseg, dev)


def _bitwise_ref(lane: SegLane, seg: torch.Tensor, nseg: int) -> torch.Tensor:
    """AND / OR / XOR per segment bit by bit, from each bit's count of
    ones and the segment's row count (index_add_), over the fill."""
    dev = seg.device
    rows = torch.zeros(nseg + 1, dtype=torch.int64, device=dev).index_add_(0, seg, torch.ones_like(lane.data))
    out = torch.zeros(nseg + 1, dtype=torch.int64, device=dev)
    for b in range(64):
        ones = torch.zeros(nseg + 1, dtype=torch.int64, device=dev).index_add_(0, seg, (lane.data >> b) & 1)
        bit = {"and_i64": ones == rows, "or_i64": ones > 0, "xor_i64": ones % 2 == 1}[lane.op]
        out |= bit.to(torch.int64) << b
    fill = int(lane.fill)
    return {"and_i64": out & fill, "or_i64": out | fill, "xor_i64": out ^ fill}[lane.op]


def _stack(rows, dt, nseg, dev):
    return torch.stack(rows) if rows else torch.zeros((0, nseg), dtype=dt, device=dev)


# --- the kernel ------------------------------------------------------------

ROWS = 4  # rows a thread takes at a time (csrc/seg_agg.cu U)
REG_LANES = 4  # MODE_REG's lane limit: nseg 1 with at most this many lanes
MAX_THREADS = 512  # a block's threads at most (the kernel's launch bounds: two blocks an SM)
WARP_SLOTS_BYTES = 96 * 1024  # the warps' private slots of one block at most
SM_SMEM = 228 * 1024  # shared memory of an SM (bytes)
MERGE_BYTES = 1 << 20  # partials the last block folds, at most, past one block an SM
MODES = {"reg": 0, "warp": 1, "global": 2}
LANE_DESC, KEY_DESC, TASK_DESC = 4, 5, 6  # int64 words of LaneDesc, KeyDesc and TaskAgg


@dataclass(frozen=True)
class Plan:
    """One launch of csrc/seg_agg.cu: its mode, block size, blocks per task
    (the grid's x extent; y is the task), shared bytes, and `parts`, the
    words of the partials [G * blocks, nlanes * nseg] its blocks merge
    through (0 when nothing merges)."""

    mode: str
    threads: int
    blocks: int
    smem: int
    parts: int


def desc_bytes(nkeys: int, nlanes: int) -> int:
    """Shared bytes of the descriptors a block copies (csrc desc_bytes):
    lane and key descriptors, the active-lane and source-lane ints and
    their count, rounded up to 16."""
    return (nlanes * 8 * LANE_DESC + nkeys * 8 * KEY_DESC + 8 * nlanes + 4 + 15) // 16 * 16


def plan(width: int, G: int, nkeys: int, nlanes: int, nseg: int, n_sms: int, shared_out: bool = False) -> Plan:
    """The launch of G tasks of `width` rows (csrc/seg_agg.cu's note gives
    the modes): registers for nseg 1 and at most REG_LANES lanes; the warp
    mode while 4 or more warps' slots (nlanes * nseg each) fit
    WARP_SLOTS_BYTES, with up to 16 warps a block; else global atomics.
    Blocks per task follow the task's width, up to what the card holds at
    once shared out over the tasks (so a group of G tasks fills the card as
    one solo launch does) and, past one block an SM, to MERGE_BYTES of
    partials for the last block to fold."""
    S = nlanes * nseg
    if nseg == 1 and nlanes <= REG_LANES:
        mode, threads = "reg", MAX_THREADS
    elif WARP_SLOTS_BYTES // (8 * S) >= 4:
        mode, threads = "warp", 32 * min(MAX_THREADS // 32, WARP_SLOTS_BYTES // (8 * S))
    else:
        mode, threads = "global", 256
    smem = desc_bytes(nkeys, nlanes)
    if mode != "global":
        smem += 8 * max(threads // 32 * S, threads)
    per_sm = max(1, min(2 * MAX_THREADS // threads, SM_SMEM // (smem + 1024)))
    need = max(1, -(-width // (threads * ROWS)))
    blocks = min(need, max(1, -(-n_sms * per_sm // G)))
    if mode == "global":
        blocks = min(blocks, 65535)
    else:
        merged = G if shared_out else 1  # tasks whose partials one last block folds
        blocks = min(blocks, max(-(-n_sms // G), MERGE_BYTES // (8 * S * merged), 1))
    merges = mode != "global" and (blocks > 1 or (shared_out and G > 1))
    return Plan(mode, threads, blocks, smem, G * blocks * S if merges else 0)


def seg_agg_tasks_check(keys: list, lanes: list) -> None:
    """Every task's key and lane shapes against task 0's: the same count,
    ops, fills and key bounds (dtypes are checked with the pointers)."""
    k0 = [(k.lo, k.dom) for k in keys[0]]
    l0 = [(l.op, l.fill) for l in lanes[0]]
    for g in range(1, len(keys)):
        if [(k.lo, k.dom) for k in keys[g]] != k0 or [(l.op, l.fill) for l in lanes[g]] != l0:
            raise ValueError(f"seg_agg_tasks: task {g}'s lanes differ from task 0's")


def seg_desc(masks: list, keys: list, lanes: list, width: int, base: int, iout: torch.Tensor,
             fout: torch.Tensor, segs=None) -> np.ndarray:
    """K4's descriptor table, to be copied to the int64 tensor at `base`
    (laid out as the structs of csrc/seg_agg.cu): G TaskAgg entries, then
    every task's KeyDesc rows, then every task's LaneDesc rows. Built a
    column at a time over the tasks. Without `segs`, `iout` / `fout` are
    [G, k, nseg] and task g writes row g; with `segs`, each task's segment
    lane and the one shared output pair."""
    seg_agg_tasks_check(keys, lanes)
    G, nk, nl = len(masks), len(keys[0]), len(lanes[0])
    dev = iout.get_device()
    k0, l0 = G * TASK_DESC, G * (TASK_DESC + KEY_DESC * nk)
    host = np.zeros(G * (TASK_DESC + KEY_DESC * nk + LANE_DESC * nl), dtype=np.int64)
    task = host[:k0].reshape(G, TASK_DESC)
    keyd, laned = host[k0:l0].reshape(G, nk, KEY_DESC), host[l0:].reshape(G, nl, LANE_DESC)
    g = np.arange(G, dtype=np.int64)
    task[:, 0] = ptrs(masks, width, dev, torch.bool, "seg_agg_tasks: mask")
    task[:, 2] = base + 8 * (k0 + g * KEY_DESC * nk)
    task[:, 3] = base + 8 * (l0 + g * LANE_DESC * nl)
    if segs is None:
        task[:, 4], task[:, 5] = rows(iout, G), rows(fout, G)
    else:
        task[:, 1] = ptrs(segs, width, dev, torch.int32, "seg_agg_tasks: segment lane")
        task[:, 4], task[:, 5] = (t.data_ptr() if t.numel() else 0 for t in (iout, fout))
    for j, k in enumerate(keys[0]):
        col = [ks[j] for ks in keys]
        keyd[:, j, 0] = ptrs([c.data for c in col], width, dev, k.data.dtype, "seg_agg_tasks: key data")
        keyd[:, j, 1] = ptrs([c.valid for c in col], width, dev, None, "seg_agg_tasks: key valid")
        keyd[:, j, 2:] = (k.lo, k.dom, k.data.element_size())
    n_i = n_f = 0
    for j, lane in enumerate(lanes[0]):
        col = [ls[j] for ls in lanes]
        what = f"seg_agg_tasks: {lane.op}"
        laned[:, j, 0] = ptrs([c.data for c in col], width, dev, None if lane.data is None else lane.data.dtype,
                              what + " data")
        laned[:, j, 1] = ptrs([c.valid for c in col], width, dev, None, what + " valid")
        laned[:, j, 2] = _fill_bits(lane)
        laned[:, j, 3] = OPS[lane.op] | ((n_f if lane.is_float else n_i) << 32)  # its output row
        n_f, n_i = (n_f + 1, n_i) if lane.is_float else (n_f, n_i + 1)
    return host


_bound: set = set()


def _lib():
    lib = library("seg_agg")
    if "seg_agg" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_seg_agg_tasks.argtypes = [C, I, L, I, I, L, L, I, I, I, I, I, L, C, C, C]
        lib.tt_seg_agg_tasks.restype = I
        _bound.add("seg_agg")
    return lib


def solo_desc(mask, keys, lanes, base: int, iout: torch.Tensor, fout: torch.Tensor, seg=None) -> np.ndarray:
    """seg_desc of one task from Python ints, for the solo wrapper, which
    has checked every lane already: a solo call's host time is most of a
    small call's, and seg_desc at G 1 takes about six times as long
    (k4_profile.py's host phase times both, and the calls with each)."""
    ptr = lambda t: 0 if t is None or t.numel() == 0 else t.data_ptr()  # noqa: E731
    return np.array(solo_words(mask.data_ptr(), keys, lanes, base, ptr(iout), ptr(fout), ptr(seg)), dtype=np.int64)


def solo_words(mask: int, keys, lanes, base: int, iout: int, fout: int, seg: int = 0, packed: bool = False) -> list:
    """solo_desc's words from addresses (0: absent), for a caller that lays
    out K4's outputs in its own workspace (P6, kernels/rowpos_agg.py).
    `packed`: lane j writes row j of one matrix at iout == fout, float
    lanes as their bits (P8, kernels/dense_agg.py)."""
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    k0 = TASK_DESC
    l0 = k0 + KEY_DESC * len(keys)
    words = [mask, seg, base + 8 * k0, base + 8 * l0, iout, fout]
    for k in keys:
        words += [k.data.data_ptr(), ptr(k.valid), k.lo, k.dom, k.data.element_size()]
    rows = [0, 0]
    for j, lane in enumerate(lanes):
        words += [ptr(lane.data), ptr(lane.valid), _fill_bits(lane),
                  OPS[lane.op] | (j if packed else rows[lane.is_float]) << 32]
        rows[lane.is_float] += 1
    return words


def upload_desc(masks, keys, lanes, width, iout, fout, segs=None, solo: bool = False) -> torch.Tensor:
    """The descriptor table on the card, in one pinned copy (ordered before
    the launch on the current stream; the caller keeps the result alive
    until the launch is enqueued). `solo`: one task whose lanes the caller
    has checked (`solo_desc`)."""
    nk, nl = len(keys[0]), len(lanes[0])
    if any(k.wrap32 for ks in keys for k in ks):
        raise ValueError("seg_agg: int32-wrap keys are P8's form (dense_agg launches them)")
    desc = torch.empty(len(masks) * (TASK_DESC + KEY_DESC * nk + LANE_DESC * nl), dtype=torch.int64,
                       device=iout.device)
    if solo:
        host = solo_desc(masks[0], keys[0], lanes[0], desc.data_ptr(), iout, fout, None if segs is None else segs[0])
    else:
        host = seg_desc(masks, keys, lanes, width, desc.data_ptr(), iout, fout, segs)
    desc.copy_(torch.from_numpy(host).pin_memory(), non_blocking=True)
    return desc


TICKETS = 1 << 16  # ticket words at the head of the scratch: one a task, G < 65536


def launch(desc: torch.Tensor, G: int, width: int, nkeys: int, nlanes: int, nseg: int, shared_out: bool,
           p: Plan, what: str) -> None:
    """Enqueue csrc/seg_agg.cu over the table `desc` by plan `p` on the
    current stream, with the stream's scratch when the plan merges: its
    first TICKETS words are the tickets (zero, and left at zero), the
    partials follow, so no call's partials reach another's tickets."""
    launch_at(desc.data_ptr(), desc.device, G, width, nkeys, nlanes, nseg, shared_out, p, what)


def launch_at(addr: int, dev: torch.device, G: int, width: int, nkeys: int, nlanes: int, nseg: int,
              shared_out: bool, p: Plan, what: str, stream: int | None = None, ostride: int = 0,
              wrap32: bool = False) -> None:
    """`launch` over a table at device address `addr` on card `dev`: for a
    caller that uploads K4's table with its own in one copy (P6,
    kernels/rowpos_agg.py; P8, kernels/dense_agg.py; `stream`: the current
    stream's handle, where the caller has it; `ostride`: the elements
    between output rows, nseg when 0; `wrap32`: every key in the int32-wrap
    form, P8's)."""
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    ostride = ostride or nseg
    if not p.parts:
        rc = _lib().tt_seg_agg_tasks(addr, G, width, nkeys, nlanes, nseg, ostride, int(wrap32), int(shared_out),
                                     MODES[p.mode], p.threads, p.blocks, p.smem, 0, 0, stream)
    else:
        with stream_scratch("seg_agg", dev, TICKETS + p.parts) as buf:
            base = buf.data_ptr()
            rc = _lib().tt_seg_agg_tasks(addr, G, width, nkeys, nlanes, nseg, ostride, int(wrap32),
                                         int(shared_out), MODES[p.mode], p.threads, p.blocks, p.smem, base,
                                         base + 8 * TICKETS, stream)
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed (cudaError {rc})")


def _ptr(t: torch.Tensor | None, dev, n: int, what: str) -> None:
    if t is not None and (t.device != dev or not t.is_contiguous() or t.shape != (n,)):
        raise ValueError(f"seg_agg: {what} must be a contiguous [{n}] tensor on {dev}")


def seg_agg(mask: torch.Tensor, keys: list[SegKey], lanes: list[SegLane], nseg: int,
            seg: torch.Tensor | None = None):
    """Packed (int64 [k_i, nseg], float64 [k_f, nseg]) partials (module doc):
    on the card, csrc/seg_agg.cu's task grid launched as a grid of one task."""
    dev = mask.device
    if dev.type == "cpu":
        return seg_agg_ref(mask, keys, lanes, nseg, seg)
    if dev.type != "cuda":
        raise ValueError(f"seg_agg: unsupported device {dev}")
    outs, go = seg_agg_prepare(mask, keys, lanes, nseg, seg)
    go()
    count(seg_agg)
    if any(lane.op in BIT_OPS for lane in lanes):
        count(seg_agg, "bit_launches")
    return outs


def seg_agg_prepare(mask: torch.Tensor, keys: list[SegKey], lanes: list[SegLane], nseg: int,
                    seg: torch.Tensor | None = None):
    """The solo call on the card up to its launch: the outputs, the one-task
    table on the card (one pinned copy), and `go()`, which enqueues the
    kernel by `plan` (each call writes every output anew)."""
    dev = mask.device
    _check(keys, lanes, nseg, seg)
    if not lanes:
        raise ValueError("seg_agg: no value lanes")
    n = mask.shape[0]
    if mask.dtype != torch.bool:
        raise TypeError("seg_agg: mask must be bool")
    for what, t in [("mask", mask), ("segment lane", seg)] + [(w, t) for k in keys for w, t in
                                                             (("key data", k.data), ("key valid", k.valid))] \
            + [(f"{l.op} {w}", t) for l in lanes for w, t in (("data", l.data), ("valid", l.valid))]:
        _ptr(t, dev, n, what)
    n_f = sum(1 for lane in lanes if lane.is_float)
    iout = torch.empty((len(lanes) - n_f, nseg), dtype=torch.int64, device=dev)
    fout = torch.empty((n_f, nseg), dtype=torch.float64, device=dev)
    desc = upload_desc([mask], [keys], [lanes], n, iout, fout, None if seg is None else [seg], solo=True)
    p = plan(n, 1, len(keys), len(lanes), nseg, sm_count(dev))

    def go():
        launch(desc, 1, n, len(keys), len(lanes), nseg, False, p, "seg_agg")

    return (iout, fout), go


seg_agg.launches = 0
seg_agg.bit_launches = 0  # the launches that reduced a bitwise aggregate
