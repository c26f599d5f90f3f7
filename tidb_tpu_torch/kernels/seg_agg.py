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
launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .build import count, library

OPS = {
    "count": 0, "sum_i64": 1, "sum_f64": 2,
    "min_i64": 3, "max_i64": 4, "min_u64": 5, "max_u64": 6,
    "min_f64": 7, "max_f64": 8, "first_row": 9,
    "and_i64": 10, "or_i64": 11, "xor_i64": 12,
}
BIT_OPS = {"and_i64": -1, "or_i64": 0, "xor_i64": 0}  # op → its identity, the only fill it takes
FLOAT_OPS = ("sum_f64", "min_f64", "max_f64")
_I64_MIN = -(1 << 63)


@dataclass
class SegKey:
    data: torch.Tensor  # int32 or int64 [N]
    valid: torch.Tensor | None  # bool [N]; None = all valid
    lo: int
    dom: int


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
        return int(np.array(lane.fill, dtype=np.float64).view(np.int64))
    f = int(lane.fill)
    return f - (1 << 64) if f > np.iinfo(np.int64).max else f


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
        kd = k.data.to(torch.int64) - k.lo + 1
        if k.valid is not None:
            kd = torch.where(k.valid, kd, 0)
        code = code * (k.dom + 1) + kd
    return torch.where(mask, code, nseg)


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


_bound: set = set()


def _lib():
    lib = library("seg_agg")
    if "seg_agg" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.tt_seg_agg.argtypes = [C, L, C, C, I, C, I, L, C, C, I, C]
        lib.tt_seg_agg.restype = I
        _bound.add("seg_agg")
    return lib


def _ptr(t: torch.Tensor | None, dev, n: int, what: str) -> int:
    if t is None:
        return 0
    if t.device != dev or not t.is_contiguous() or t.shape != (n,):
        raise ValueError(f"seg_agg: {what} must be a contiguous [{n}] tensor on {dev}")
    return t.data_ptr()


def seg_agg(mask: torch.Tensor, keys: list[SegKey], lanes: list[SegLane], nseg: int,
            seg: torch.Tensor | None = None):
    """Packed (int64 [k_i, nseg], float64 [k_f, nseg]) partials (module doc)."""
    dev = mask.device
    if dev.type == "cpu":
        return seg_agg_ref(mask, keys, lanes, nseg, seg)
    if dev.type != "cuda":
        raise ValueError(f"seg_agg: unsupported device {dev}")
    _check(keys, lanes, nseg, seg)
    if not lanes:
        raise ValueError("seg_agg: no value lanes")
    n = mask.shape[0]
    if mask.dtype != torch.bool:
        raise TypeError("seg_agg: mask must be bool")
    # descriptor tables, laid out as KeyDesc / LaneDesc in csrc/seg_agg.cu
    kd = np.zeros((max(len(keys), 1), 5), dtype=np.int64)
    for j, k in enumerate(keys):
        kd[j] = (_ptr(k.data, dev, n, "key data"), _ptr(k.valid, dev, n, "key valid"),
                 k.lo, k.dom, k.data.element_size())
    ld = np.zeros((len(lanes), 4), dtype=np.int64)
    n_i = n_f = 0
    for j, lane in enumerate(lanes):
        if lane.is_float:
            out_row, n_f = n_f, n_f + 1
        else:
            out_row, n_i = n_i, n_i + 1
        ld[j] = (_ptr(lane.data, dev, n, f"{lane.op} data"), _ptr(lane.valid, dev, n, f"{lane.op} valid"),
                 _fill_bits(lane), OPS[lane.op] | (out_row << 32))
    kdesc = torch.from_numpy(kd).to(dev)
    ldesc = torch.from_numpy(ld).to(dev)
    iout = torch.empty((n_i, nseg), dtype=torch.int64, device=dev)
    fout = torch.empty((n_f, nseg), dtype=torch.float64, device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rc = _lib().tt_seg_agg(
        _ptr(mask, dev, n, "mask"), n, _ptr(seg, dev, n, "segment lane"),
        kdesc.data_ptr(), len(keys), ldesc.data_ptr(), len(lanes),
        nseg, iout.data_ptr(), fout.data_ptr(), n_sms,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"seg_agg: kernel launch failed (cudaError {rc})")
    count(seg_agg)
    if any(lane.op in BIT_OPS for lane in lanes):
        count(seg_agg, "bit_launches")
    return iout, fout


seg_agg.launches = 0
seg_agg.bit_launches = 0  # the launches that reduced a bitwise aggregate
