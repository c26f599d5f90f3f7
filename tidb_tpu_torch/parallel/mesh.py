"""Mesh-parallel cop execution on torch.distributed (ref:
tidb_tpu/parallel/mesh.py).

The reference maps region-parallel cop fan-out onto a JAX mesh: rows
sharded over the "dp" axis, each device running the fused Q1 program on
its shard, partials merged by an exact int64 `psum`, and the MPP hash
exchange as an `all_to_all` after bucketing rows by owner. Here the
"mesh" is a torch.distributed process group with one rank per shard:

  * M1 `q1_local_kernel` — kernels/q1_local (csrc/q1_local.cu): one
    shard's filter, group code and six exact int64 segment sums;
  * M2 `distributed_q1_step` — M1 on this rank's shard, then an
    `all_reduce` (SUM, int64: the counterpart of XLA's `psum`); with one
    rank the collective is the identity and is not called;
  * M3 `hash_repartition` — kernels/hash_repartition
    (csrc/hash_repartition.cu) writes the per-owner send buffers, then
    `all_to_all_single` exchanges them and an `all_reduce` sums the
    dropped counts (the identity with one rank).

On cards the group is NCCL's, on the CPU gloo's (entry.dryrun_multichip
runs n gloo processes); a rank's tensors live on its own device. Nothing
here needs the reference: `build_q1_arrays` is a copy over the port's own
generator (models/tpch.gen_lineitem), which gives the reference's rows
for a seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.hash_repartition import hash_repartition as _repartition
from ..kernels.q1_local import q1_local


@dataclass(frozen=True)
class Q1Spec:
    """Static spec of the fused Q1 cop program (the flagship kernel)."""

    nseg: int = 8  # |returnflag dict| x |linestatus dict| padded (3*2 → 8)
    cutoff: int = 0  # packed shipdate cutoff


def _world(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def q1_local_kernel(spec: Q1Spec, qty, price, disc, tax, rf, ls, ship, row_valid):
    """One shard's fused Q1: filter → group codes → partial segment sums
    (M1). All decimal lanes are scaled int64 (scale 2); products carry
    scale 4 / 6. → tuple of six [nseg] int64 partials (count, sum_qty,
    sum_base_price, sum_disc_price, sum_charge, sum_disc)."""
    return tuple(q1_local(spec.nseg, spec.cutoff, qty, price, disc, tax, rf, ls, ship, row_valid))


def distributed_q1_step(spec: Q1Spec, group=None):
    """The distributed step (M2): M1 over this rank's shard, then an exact
    int64 all_reduce of the partials over `group`. → fn(qty, price, disc,
    tax, rf, ls, ship, row_valid) of the local shard → six [nseg]
    partials, equal on every rank."""

    def step(*shard):
        parts = q1_local(spec.nseg, spec.cutoff, *shard)
        if _world(group) > 1:
            import torch.distributed as dist

            dist.all_reduce(parts, op=dist.ReduceOp.SUM, group=group)
        return tuple(parts)

    return step


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    src = t.view(torch.uint8) if t.dtype == torch.bool else t  # gloo moves bytes, not bools
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def hash_repartition(n_dev: int, cap: int | None = None, group=None):
    """The MPP exchange primitive (M3): rows with equal key land on the
    same rank, owner = key mod n_dev (floored). `cap` is the per-peer
    send-buffer size: None = the local row count, which never drops.
    → fn(keys, payload, valid) of the local shard → (keys [n_dev*cap],
    payload [n_dev*cap], valid [n_dev*cap], dropped): the rows this rank
    received, peer by peer, and the dropped count summed over the ranks
    (an int64 tensor [1])."""
    if n_dev > 1 and _world(group) != n_dev:
        raise ValueError(f"hash_repartition: {n_dev} devices need a process group of {n_dev} ranks")

    def step(keys, payload, valid):
        c = cap if cap is not None else keys.shape[0]
        bk, bp, bv, dropped = _repartition(keys, payload, valid, n_dev, c)
        if n_dev > 1:
            import torch.distributed as dist

            bk, bp, bv = (_all_to_all(t, group) for t in (bk, bp, bv))
            dist.all_reduce(dropped, op=dist.ReduceOp.SUM, group=group)
        return bk.reshape(-1), bp.reshape(-1), bv.reshape(-1), dropped

    return step


def q1_arrays(cols: dict, n_shards: int = 1, cutoff: str = "1998-09-02"):
    """Q1's eight lanes from lineitem columns ({name: numpy lane}, as
    models/tpch.gen_lineitem gives them), padded to a multiple of
    `n_shards` rows with invalid rows → (Q1Spec, numpy lanes)."""
    from ..mysqltypes.coretime import parse_datetime

    n_rows = len(cols["l_quantity"])
    per = -(-n_rows // n_shards)
    total = per * n_shards

    def pad(a, dtype):
        out = np.zeros(total, dtype=dtype)
        out[:n_rows] = a
        return out

    rf_codes = np.searchsorted(np.array(["A", "N", "R"]), cols["l_returnflag"].astype("U"))
    ls_codes = np.searchsorted(np.array(["F", "O"]), cols["l_linestatus"].astype("U"))
    rv = np.zeros(total, dtype=bool)
    rv[:n_rows] = True
    args = (
        pad(cols["l_quantity"], np.int64),
        pad(cols["l_extendedprice"], np.int64),
        pad(cols["l_discount"], np.int64),
        pad(cols["l_tax"], np.int64),
        pad(rf_codes, np.int64),
        pad(ls_codes, np.int64),
        pad(cols["l_shipdate"], np.int64),
        rv,
    )
    return Q1Spec(nseg=6, cutoff=int(parse_datetime(cutoff))), args


def build_q1_arrays(n_rows: int, n_shards: int = 1, seed: int = 7):
    """Tiny-shape Q1 inputs: [n_shards * rows_per_shard] padded lanes
    (copy of the reference's build_q1_arrays)."""
    from ..models.tpch import gen_lineitem

    return q1_arrays(gen_lineitem(n_rows, seed), n_shards)


def q1_exact(spec: Q1Spec, args) -> np.ndarray:
    """The six partials recomputed in plain numpy (int64 wrap) from the
    numpy lanes: the single-device recompute the mesh is held to."""
    qty, price, disc, tax, rf, ls, ship, rv = (np.asarray(a) for a in args)
    mask = rv & (ship <= spec.cutoff)
    code = rf * 2 + ls
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    out = np.zeros((6, spec.nseg), dtype=np.int64)
    for g in range(spec.nseg):
        m = mask & (code == g)
        out[:, g] = [m.sum(), qty[m].sum(), price[m].sum(), disc_price[m].sum(), charge[m].sum(), disc[m].sum()]
    return out
