"""P8: the dense MPP aggregation — direct-address partials of a narrow
group-key domain, straight into the rows of the packed result.

Replaces the dense branch of `kernel` in tidb_tpu/parallel/mpp.py:1960-1973
(MPPEngine._build_program) with `_agg_partials` (:2048-2080), at n_dev 1
(psum / pmin / pmax are the identity there). The CUDA kernel is K4's
(csrc/seg_agg.cu, kernels/seg_agg.py) over a one-task table that this
module writes: the dense keys as K4 key descriptors in their int32-wrap
form (K4's kernel launched with `wrap32` computes the reference's code
in registers), and
every lane's output as its row of the packed result (`packed` lane rows,
the rows' stride as K4's output stride). `dense_agg_ref` is the plain
PyTorch version beside it, the reference's jnp code step by step.

`dense_agg(mask, keys, nseg, lanes, rows=None)`:

  * mask  — bool [N], the chain's row mask
  * keys  — [DenseKey(data int64 [N], valid bool [N], lo, dom)]: the
            reference's int32 mixed-radix code, kd = (int32(d) - lo + 1)
            * v (int32 wrap: a narrow domain of keys above 2^31 codes as
            in int64), code = code * (dom + 1) + kd; masked rows and codes
            outside [0, nseg) are dropped (jax's scatter drops them). No
            key (an aggregate without GROUP BY) codes every row 0, nseg 1
  * lanes — red.RedLane partial lanes: the count over the mask first,
            then per aggregate (sum, cnt), (min | max, cnt) or cnt
  * rows  — optional int64 [len(lanes), W >= nseg] rows of the packed
            result to write into (float lanes as their bits; columns past
            nseg are left as they are)
  → [nseg] per lane (float lanes as float64 views of their rows): sums
    and counts, min / max with the reference's sentinel folded for NULL
    rows and the op's identity in empty segments.

Integer lanes are bit-exact with the reference; float sums differ by
summation order (K4 adds in another order than XLA).

On the card a call is one pinned upload of K4's table (from a staging
buffer kept from call to call, `tables.staging`) and one launch of K4's
kernel (two in K4's global mode, past 3,072 slots: its fill kernel
first); no segment lane, no copy of the partials, no host read. A uint64
min / max lane with NULLs gets its sentinel folded into its data first
(`red.seg_lane`, one PyTorch op), as K4's other callers do. `table`
returns the words the call uploads (tests/test_torch_dense_q1_plans.py
checks them against a numpy model of the code).

`dense_agg` takes the plain version only for tensors on the CPU. On a
CUDA device it launches the kernel or raises; `dense_agg.launches`
counts its calls that launched (K4's launches count under seg_agg too).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import red
from .build import count
from .seg_agg import KEY_DESC, LANE_DESC, TASK_DESC, SegKey, launch_at, plan, seg_agg, solo_words
from .tables import sm_count, staging

MAX_KEYS, MAX_LANES = 8, 32


class DenseKey(NamedTuple):
    data: torch.Tensor
    valid: torch.Tensor
    lo: int
    dom: int


def _i32(x: int) -> int:
    """A Python int as the int32 jnp's weak typing casts it to (wrapped)."""
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def dense_code_ref(mask, keys, nseg: int) -> torch.Tensor:
    """int64 [N] segment of each row: the int32 code, nseg where masked or
    out of range (ref: :1962-1967)."""
    code = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    for k in keys:
        kd = (k.data.to(torch.int32) - _i32(k.lo) + 1) * k.valid
        code = code * (k.dom + 1) + kd
    seg = torch.where(mask, code.to(torch.int64), nseg)
    return torch.where((seg >= 0) & (seg <= nseg), seg, nseg)


def dense_agg_ref(mask, keys, nseg: int, lanes, rows=None) -> list:
    """Plain PyTorch version: the reference's partials, step by step."""
    seg = dense_code_ref(mask, keys, nseg)
    outs = [red.scatter_ref(red.values_ref(ln, mask), seg, nseg, ln.op) for ln in lanes]
    if rows is None:
        return outs
    for j, o in enumerate(outs):
        rows[j, :nseg] = red.bits(o)
    return _views(rows, lanes, nseg)


def _views(rows, lanes, nseg):
    return [r.view(torch.float64) if ln.is_float else r for r, ln in zip(rows[:, :nseg].unbind(0), lanes)]


def _check(mask, keys, nseg, lanes, rows):
    n = mask.shape[0]
    if mask.dtype != torch.bool or not 1 <= nseg < 1 << 31:
        raise TypeError("dense_agg: mask is bool [N], 1 <= nseg < 2^31")
    if not 0 <= len(keys) <= MAX_KEYS or not 1 <= len(lanes) <= MAX_LANES:
        raise ValueError(f"dense_agg: 0..{MAX_KEYS} keys and 1..{MAX_LANES} lanes")
    for k in keys:
        if k.data.dtype != torch.int64 or k.data.shape != (n,) or k.valid.dtype != torch.bool \
                or k.valid.shape != (n,) or k.dom < 1:
            raise TypeError(f"dense_agg: a key is (int64 [{n}], bool [{n}]) with dom >= 1")
    red.check_lanes(lanes, n, "dense_agg")
    if rows is not None and (rows.dtype != torch.int64 or rows.dim() != 2 or rows.shape[0] != len(lanes)
                             or rows.shape[1] < nseg or rows.stride(1) != 1):
        raise TypeError(f"dense_agg: the result rows are int64 [{len(lanes)}, >= {nseg}], rows contiguous")
    return n


def seg_keys(keys) -> list:
    """The dense keys as K4's int32-wrap key lanes (lo wrapped as jnp casts it)."""
    return [SegKey(k.data, k.valid, _i32(k.lo), k.dom, wrap32=True) for k in keys]


def table_words(nkeys: int, nlanes: int) -> int:
    """Words of the one-task K4 table a call uploads."""
    return TASK_DESC + KEY_DESC * nkeys + LANE_DESC * nlanes


def table(mask, keys, lanes, base: int, rows: torch.Tensor) -> list:
    """The words of K4's one-task table for a call at device address
    `base`: the mask, the dense keys in their int32-wrap form, the lanes
    (red.seg_lane) each writing its row of `rows`."""
    return solo_words(mask.data_ptr(), seg_keys(keys), lanes, base, rows.data_ptr(), rows.data_ptr(), packed=True)


def dense_agg(mask, keys, nseg: int, lanes, rows=None) -> list:
    """The dense partial lanes (module doc)."""
    dev = mask.device
    n = _check(mask, keys, nseg, lanes, rows)
    if dev.type == "cpu":
        return dense_agg_ref(mask, keys, nseg, lanes, rows)
    if dev.type != "cuda":
        raise ValueError(f"dense_agg: unsupported device {dev}")
    ins = [mask] + [t for k in keys for t in (k.data, k.valid)] + \
        [t for ln in lanes for t in (ln.data, ln.valid) if t is not None]
    if any(t.device != dev or not t.is_contiguous() for t in ins) or (rows is not None and rows.device != dev):
        raise ValueError(f"dense_agg: inputs must be contiguous tensors on {dev}")
    if rows is None:
        rows = torch.empty((len(lanes), nseg), dtype=torch.int64, device=dev)
    # K4 reads these lanes by address: a lane seg_lane makes (a uint64 min / max with NULLs) lives through the call
    k4_lanes = [red.seg_lane(ln) for ln in lanes]
    words = table_words(len(keys), len(lanes))
    desc = torch.empty(words, dtype=torch.int64, device=dev)
    with staging("dense_agg", dev, words) as st:  # the call's one upload
        st.host[:words] = table(mask, keys, k4_lanes, desc.data_ptr(), rows)
        st.upload(desc, words)
    launch_at(desc.data_ptr(), dev, 1, n, len(keys), len(lanes), nseg, False,
              plan(n, 1, len(keys), len(lanes), nseg, sm_count(dev)), "dense_agg", ostride=rows.stride(0),
              wrap32=True)
    count(seg_agg)
    count(dense_agg)
    return _views(rows, lanes, nseg)


dense_agg.launches = 0
