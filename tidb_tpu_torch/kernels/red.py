"""Reduction lanes shared by P5 (seg_reduce), P6 (rowpos_agg) and P8
(dense_agg): the per-aggregate partial lanes of tidb_tpu/parallel/mpp.py
`_agg_partials` (:2048-2080) and of `sorted_agg_stage` (:1676-1698).

A `RedLane(op, data, valid)` is one partial lane over the rows:

  * op    — "count", "sum_i64", "sum_u64", "sum_f64", "min_i64",
            "max_i64", "min_u64", "max_u64", "min_f64", "max_f64"
  * data  — int64 [N] (uint64 lanes as their int64 bits) or float64 [N];
            None for "count"
  * valid — bool [N] or None: a row's value counts where mask & valid
            (the reference's `ok`)

A row with mask set and valid unset folds the reference's sentinel: 0 for
a sum and a count, and for min / max `where(ok, d, big)`'s big — +inf /
-inf for floats, INT64_MAX / INT64_MIN for int64 and, because jnp.where
casts the Python int into the lane's uint64 dtype, 2^63 - 1 / 2^63 for
uint64 (in unsigned order both take part in the min / max). An empty
segment holds the op's identity: 0, INT64_MAX / INT64_MIN, uint64 max / 0,
+inf / -inf.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..torchenv import _KIND_F64, _KIND_I64, _KIND_U64
from .seg_agg import SegLane

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
OPS = {"count": 0, "sum_i64": 1, "sum_u64": 2, "sum_f64": 3, "min_i64": 4, "max_i64": 5, "min_u64": 6,
       "max_u64": 7, "min_f64": 8, "max_f64": 9}
_INF_BITS = int(np.array(np.inf).view(np.int64))
_NINF_BITS = int(np.array(-np.inf).view(np.int64))


class RedLane(NamedTuple):
    op: str
    data: torch.Tensor | None = None
    valid: torch.Tensor | None = None

    @property
    def is_float(self) -> bool:
        return self.op.endswith("f64")

    @property
    def is_sum(self) -> bool:
        return self.op == "count" or self.op.startswith("sum")


def kind(op: str) -> int:
    """The packed-row kind of an op's result (torchenv.unpack_rows)."""
    if op.endswith("f64"):
        return _KIND_F64
    if op.endswith("u64"):
        return _KIND_U64
    return _KIND_I64


def null_bits(op: str) -> int:
    """The value (as int64 bits) a row folds where mask & ~valid."""
    if op.startswith("min"):
        return _INF_BITS if op.endswith("f64") else I64_MAX
    if op.startswith("max"):
        return _NINF_BITS if op.endswith("f64") else I64_MIN
    return 0


def identity_bits(op: str) -> int:
    """An empty segment's value (as int64 bits)."""
    if op == "min_u64":
        return -1
    if op == "max_u64":
        return 0
    return null_bits(op)


def check_lanes(lanes, n: int, what: str) -> None:
    for ln in lanes:
        if ln.op not in OPS:
            raise ValueError(f"{what}: unknown op {ln.op!r}")
        if ln.op != "count":
            want = torch.float64 if ln.is_float else torch.int64
            if ln.data is None or ln.data.dtype != want or ln.data.shape != (n,):
                raise TypeError(f"{what}: a {ln.op} lane needs {want} [{n}] data")
        if ln.valid is not None and (ln.valid.dtype != torch.bool or ln.valid.shape != (n,)):
            raise TypeError(f"{what}: a lane's valid is bool [{n}]")


def seg_lane(ln: RedLane) -> SegLane:
    """K4's lane (kernels/seg_agg.py) of the same partials: K4 skips a NULL
    row, whose sentinel is the op's identity, except for a uint64 min / max,
    whose sentinel takes part in the unsigned order and is folded into the
    data here; a uint64 sum adds modulo 2^64 like an int64 one."""
    fill = identity_bits(ln.op)
    if ln.op in ("min_u64", "max_u64"):
        data = ln.data
        if ln.valid is not None:
            data = torch.where(ln.valid, data, torch.full((), null_bits(ln.op), dtype=torch.int64,
                                                          device=data.device))
        return SegLane(ln.op, data, None, fill % (1 << 64))
    if ln.is_float:
        fill = float(np.array(fill, dtype=np.int64).view(np.float64))
    return SegLane("sum_i64" if ln.op == "sum_u64" else ln.op, ln.data, ln.valid, fill)


def values_ref(lane: RedLane, mask: torch.Tensor) -> torch.Tensor:
    """The lane's per-row value where(ok, d, sentinel) in its own dtype
    (uint64 as int64 bits); a count lane's ok as int64."""
    ok = mask if lane.valid is None else (mask & lane.valid)
    if lane.op == "count":
        return ok.to(torch.int64)
    fill = torch.full((), null_bits(lane.op), dtype=torch.int64, device=mask.device)
    if lane.is_float:
        fill = fill.view(torch.float64)
    return torch.where(ok, lane.data, fill)


def ordered(x: torch.Tensor, op: str) -> torch.Tensor:
    """uint64 bits → int64 whose signed order is the unsigned order (an
    involution); other lanes as they are."""
    return x ^ I64_MIN if op.endswith("u64") else x


def scatter_ref(vals: torch.Tensor, seg: torch.Tensor, nseg: int, op: str) -> torch.Tensor:
    """segment_sum / segment_min / segment_max of `vals` over `seg` (int64,
    nseg = dropped), [nseg] — jax.ops.segment_* at num_segments nseg + 1,
    sliced to nseg."""
    dev = vals.device
    if op == "count" or op.startswith("sum"):
        out = torch.zeros(nseg + 1, dtype=vals.dtype, device=dev).index_add_(0, seg, vals)
        return out[:nseg]
    red = "amin" if op.startswith("min") else "amax"
    ident = torch.full((), identity_bits(op), dtype=torch.int64, device=dev)
    if op.endswith("f64"):
        out = torch.full((nseg + 1,), float(ident.view(torch.float64)), dtype=torch.float64, device=dev)
        return out.scatter_reduce_(0, seg, vals, red)[:nseg]
    out = torch.full((nseg + 1,), int(ordered(ident, op)), dtype=torch.int64, device=dev)
    return ordered(out.scatter_reduce_(0, seg, ordered(vals, op), red), op)[:nseg]


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64) if x.dtype == torch.float64 else x.to(torch.int64)


def topk_score_ordered(val: torch.Tensor, valid: torch.Tensor, desc: bool, unsigned: bool) -> torch.Tensor:
    """`_topk_score` (ref: :1984) for a top-k over int64 or float64: a
    uint64 lane scores in its own dtype in the reference, so its score is
    mapped to the int64 of the same (unsigned) order."""
    if val.dtype == torch.float64:
        floor = torch.full((), float("-inf"), dtype=torch.float64, device=val.device)
    else:
        floor = torch.full((), -I64_MAX, dtype=torch.int64, device=val.device)
    s = torch.where(valid, val if desc else -val, floor)
    return s ^ I64_MIN if unsigned else s


def fold(op: str, parts: torch.Tensor) -> torch.Tensor:
    """The devices' partials of one lane, [n_dev, ...], combined in device
    order: the reference's psum / pmin / pmax of the lane (`red`, :1972;
    psum_scatter and pmin / pmax before a slice, :1798-1846). Sums and
    counts add (int64 modulo 2^64, float64 left to right), min / max take
    the unsigned order for a uint64 lane (its int64 bits) and propagate NaN
    as jnp.minimum / jnp.maximum do; `parts` is float64 for an f64 op, int64
    otherwise."""
    if op == "count" or op.startswith("sum"):
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc
    pick = torch.minimum if op.startswith("min") else torch.maximum
    acc = ordered(parts[0], op)
    for p in parts[1:]:
        acc = pick(acc, ordered(p, op))
    return ordered(acc, op)
