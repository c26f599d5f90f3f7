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

The MPP engine's mesh (ref: `make_mesh`, :42) is one controller over n
ranks in this process: `make_mesh(n, device)` gives a `Mesh` whose
`run(fn)` calls fn(rank) on n threads, and whose collectives — named
after the reference's `all_to_all`, `psum`, `pmin` / `pmax`,
`psum_scatter` and `axis_index` — go through one torch.distributed
process group per rank, all built here over one HashStore: gloo where
the ranks share the CPU or one card (gloo takes the CUDA tensors and
moves them through pinned host memory itself), NCCL where every rank has
its own card. At n = 1 every collective is the identity and `run` calls
fn(0) on the caller's thread.
"""

from __future__ import annotations

import atexit
import itertools
import threading
import time
import weakref
from contextlib import nullcontext
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch

from ..kernels import red
from ..kernels.hash_repartition import hash_repartition as _repartition
from ..kernels.q1_local import q1_local
from ..torchenv import resolve_device

POLL_S = 50e-6  # a rank waiting in a collective looks for a failed peer this often
TIMEOUT_S = 120.0  # a collective that no peer joins fails after this long


class MeshAborted(RuntimeError):
    """A rank left a collective because another rank of the run failed."""


class Mesh:
    """n ranks of one SPMD program and their collectives (module doc).
    `collective_s[rank]` / `collectives[rank]` hold the host-clock seconds
    spent in collectives and their count during the last `run`."""

    def __init__(self, devices: list, groups: list | None, backend: str | None):
        self.n_dev = len(devices)
        self.backend = backend
        self._devices = devices
        self._groups = groups
        self._failed = threading.Event()
        self._broken = False
        self.collective_s = [0.0] * self.n_dev
        self.collectives = [0] * self.n_dev
        if groups is not None:
            _MESHES.add(self)

    def device(self, rank: int) -> torch.device:
        return self._devices[rank]

    def group(self, rank: int):
        """Rank's process group (None at n = 1), for M2 / M3's `group=`."""
        return None if self._groups is None else self._groups[rank]

    def axis_index(self, rank: int) -> int:
        return rank

    def run(self, fn) -> list:
        """[fn(rank) for every rank], the ranks on n threads (each with its
        card current); every thread is joined, then the first error
        raised is re-raised."""
        if self._broken:
            raise RuntimeError("mesh: closed, or an earlier run left a collective pending; make a new mesh")
        self.collective_s = [0.0] * self.n_dev
        self.collectives = [0] * self.n_dev
        if self.n_dev == 1:
            return [fn(0)]
        results: list = [None] * self.n_dev
        errors: list = []
        self._failed.clear()

        def worker(rank):
            dev = self._devices[rank]
            try:
                with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
                    results[rank] = fn(rank)
            except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
                errors.append(e)
                self._failed.set()

        threads = [threading.Thread(target=worker, args=(r,), name=f"mesh-rank-{r}") for r in range(self.n_dev)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            self._broken = any(isinstance(e, MeshAborted) for e in errors)
            raise next((e for e in errors if not isinstance(e, MeshAborted)), errors[0])
        return results

    def close(self) -> None:
        """Release the process groups (a collective that a failed run left
        pending holds this up to the mesh's timeout)."""
        self._groups = None
        self._broken = True

    # ------------------------------------------------------- collectives

    def _wait(self, rank: int, work) -> None:
        while not work.is_completed():
            if self._failed.is_set():
                raise MeshAborted(f"mesh rank {rank}: a peer failed")
            time.sleep(POLL_S)
        work.wait()

    @staticmethod
    def _wire(t: torch.Tensor) -> torch.Tensor:
        """t as the group moves it: contiguous, bools as bytes."""
        t = t.contiguous()
        return t.view(torch.uint8) if t.dtype == torch.bool else t

    @staticmethod
    def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.view(torch.bool) if like.dtype == torch.bool else t

    def _collect(self, rank: int, start) -> None:
        """Wait out the collective start() begins on rank's group, timed."""
        t0 = time.perf_counter()
        self._wait(rank, start(self._groups[rank]))
        self.collective_s[rank] += time.perf_counter() - t0
        self.collectives[rank] += 1

    def all_to_all(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        """The reference's all_to_all(t, axis, 0, 0, tiled=True): row block
        r of t [n_dev, ...] goes to rank r; row block s of the result came
        from rank s."""
        if self.n_dev == 1:
            return t
        if t.shape[0] != self.n_dev:
            raise ValueError(f"mesh.all_to_all: dim 0 is {t.shape[0]}, not n_dev {self.n_dev}")
        src = self._wire(t)
        out = torch.empty_like(src)
        self._collect(rank, lambda g: g.alltoall_base(out, src, [], []))
        return self._unwire(out, t)

    def all_gather(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        """[n_dev, *t.shape]: every rank's t, in rank order."""
        if self.n_dev == 1:
            return t.unsqueeze(0)
        src = self._wire(t)
        outs = [torch.empty_like(src) for _ in range(self.n_dev)]
        self._collect(rank, lambda g: g.allgather([outs], [src]))
        return self._unwire(torch.stack(outs), t)

    def psum(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks (int64 modulo 2^64, floats added in rank
        order): reduce_lanes of one lane."""
        return self.reduce_lanes(rank, [t], ["sum_f64" if t.is_floating_point() else "sum_i64"])[0]

    def pmin(self, rank: int, t: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
        """The minimum over the ranks (unsigned order for uint64 bits; NaN
        wins, as XLA's): reduce_lanes of one lane."""
        return self.reduce_lanes(rank, [t], [_minmax_op("min", t, unsigned)])[0]

    def pmax(self, rank: int, t: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
        return self.reduce_lanes(rank, [t], [_minmax_op("max", t, unsigned)])[0]

    def psum_scatter(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        """The reference's psum_scatter(t, scatter_dimension=0, tiled=True):
        rank r's block of the sum, dim 0 cut into n_dev equal blocks."""
        return self.reduce_lanes(rank, [t], ["sum_f64" if t.is_floating_point() else "sum_i64"], scatter=True)[0]

    def reduce_lanes(self, rank: int, lanes: list, ops: list, scatter: bool = False) -> list:
        """Many lanes of partials in one collective, each combined by its
        red op in rank order (red.fold): whole (the reference's psum / pmin
        / pmax, one all_gather) or, with `scatter`, rank's block of each
        (psum_scatter for sums, pmin / pmax then a slice for min / max: one
        all_to_all of the blocks). Lanes are int64 or float64 [L]; L
        divisible by n_dev with `scatter`. Every collective of the MPP
        engine is this one: gloo's and NCCL's MIN / MAX know neither the
        unsigned order of a uint64 lane nor XLA's NaN rule."""
        if self.n_dev == 1:
            return list(lanes)
        L = lanes[0].shape[0]
        bits = torch.stack([red.bits(x) for x in lanes])
        if scatter:
            if L % self.n_dev:
                raise ValueError(f"mesh.psum_scatter: {L} rows do not cut into {self.n_dev} blocks")
            blk = L // self.n_dev
            parts = self.all_to_all(rank, bits.view(len(lanes), self.n_dev, blk).transpose(0, 1))
        else:
            parts = self.all_gather(rank, bits)
        out = []
        for j, (x, op) in enumerate(zip(lanes, ops)):
            p = parts[:, j]
            out.append(red.fold(op, p.view(torch.float64) if x.dtype == torch.float64 else p))
        return out


def _minmax_op(op: str, t: torch.Tensor, unsigned: bool) -> str:
    return f"{op}_{'f64' if t.is_floating_point() else 'u64' if unsigned else 'i64'}"


_MESHES: weakref.WeakSet = weakref.WeakSet()
_ids = itertools.count()


@atexit.register
def _close_meshes() -> None:
    # a process group left to the interpreter's teardown aborts the process
    for m in list(_MESHES):
        m.close()


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """n ranks (ref: make_mesh, :42): None means one rank per visible card
    (1 on the CPU). With an unindexed "cuda" and as many cards as ranks,
    rank r runs on card r over NCCL; otherwise the ranks share `device`
    (one card, or the CPU) over gloo."""
    import torch.distributed as dist

    asked = torch.device(device)
    base = resolve_device(device)
    count = torch.cuda.device_count() if base.type == "cuda" else 1
    n = count if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_mesh: {n} devices")
    if n == 1:
        return Mesh([base], None, None)
    own_cards = base.type == "cuda" and asked.index is None and n <= count
    devices = [torch.device("cuda", r) for r in range(n)] if own_cards else [base] * n
    backend = "nccl" if own_cards else "gloo"
    store = dist.HashStore()
    prefix = f"mpp-mesh-{next(_ids)}"
    groups: list = [None] * n
    errors: list = []

    def build(rank):
        try:
            pstore = dist.PrefixStore(prefix, store)
            if backend == "nccl":
                groups[rank] = dist.ProcessGroupNCCL(pstore, rank, n)
            else:
                opts = dist.ProcessGroupGloo._Options()
                opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
                opts._timeout = timedelta(seconds=TIMEOUT_S)
                groups[rank] = dist.ProcessGroupGloo(pstore, rank, n, opts)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return Mesh(devices, groups, backend)


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
