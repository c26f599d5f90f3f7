"""The port's mesh (parallel/mesh.py: M1 q1_local, M2 the all-reduced Q1
step, M3 hash_repartition) and its entry points (entry.entry,
entry.dryrun_multichip), held to tidb_tpu.parallel.mesh and
__graft_entry__ on the CPU.

* M1 and M3's plain versions per shard, with the collectives done here in
  one process (the all_reduce a sum over the shards, the all_to_all a
  transpose of the send buffers), against the reference's jitted step on
  `make_mesh(n)` for n = 1, 2 and 4 (the 8-device virtual CPU mesh of
  tests/conftest.py): negative keys, invalid rows, a cap below the
  largest bucket (drops > 0, and the reference's last-writer slot).
* `entry()`'s step on its example lanes against the reference's.
* `dryrun_multichip(2, device="cpu")`: two gloo processes, then stage 3's
  two-rank mesh on the CPU, under a timeout.
Integers compare exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tidb_tpu.jaxenv import jnp
from tidb_tpu.parallel import mesh as ref_mesh

from tidb_tpu_torch.entry import dryrun_multichip, entry
from tidb_tpu_torch.kernels.hash_repartition import hash_repartition_ref
from tidb_tpu_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_build_q1_arrays_is_the_reference_generator():
    spec, args = mesh.build_q1_arrays(1000, n_shards=3)
    rspec, rargs = ref_mesh.build_q1_arrays(1000, n_shards=3)
    assert (spec.nseg, spec.cutoff) == (rspec.nseg, rspec.cutoff)
    for a, b in zip(args, rargs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_distributed_q1_matches_the_reference_mesh(n):
    """M1 per shard, summed (M2's all_reduce), against the reference's
    shard_map + psum step on make_mesh(n); an overflowing lane wraps the
    same way."""
    spec, args = mesh.build_q1_arrays(n * 300, n_shards=n)
    args = list(args)
    args[1] = args[1].copy()
    args[1][::7] = np.iinfo(np.int64).max // 3  # price: disc_price and charge wrap
    want = ref_mesh.distributed_q1_step(ref_mesh.make_mesh(n), spec)(*[jnp.asarray(a) for a in args])
    per = len(args[0]) // n
    got = sum(torch.stack(mesh.q1_local_kernel(spec, *[_t(a[r * per:(r + 1) * per]) for a in args]))
              for r in range(n))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got.numpy(), mesh.q1_exact(spec, args))


def test_q1_local_drops_codes_outside_the_segments():
    """A code past nseg, or negative, is dropped as jax's segment_sum
    drops it."""
    spec = mesh.Q1Spec(nseg=4, cutoff=100)
    rng = np.random.default_rng(2)
    n = 500
    args = [rng.integers(0, 1000, n) for _ in range(4)] + [rng.integers(-2, 4, n), rng.integers(0, 2, n),
                                                           rng.integers(0, 200, n), rng.random(n) < 0.9]
    want = ref_mesh.q1_local_kernel(spec, *[jnp.asarray(a) for a in args])
    got = mesh.q1_local_kernel(spec, *[_t(a) for a in args])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _exchange(keys, payload, valid, n, cap):
    """M3's plain version per shard, then the all_to_all done here: rank
    r receives block r of every rank's send buffers, rank by rank."""
    per = len(keys) // n
    sends = [hash_repartition_ref(*(_t(a[r * per:(r + 1) * per]) for a in (keys, payload, valid)), n, cap)
             for r in range(n)]
    out = []
    for j in range(3):
        out.append(np.concatenate([np.concatenate([sends[r][j][dst].numpy() for r in range(n)])
                                   for dst in range(n)]))
    return out + [sum(int(s[3][0]) for s in sends)]


MESH_CASES = [(1, None), (1, 5), (2, None), (2, 3), (4, None), (4, 2), (4, 1)]


@pytest.mark.parametrize("n,cap", MESH_CASES, ids=[f"n{n}_cap{c}" for n, c in MESH_CASES])
def test_hash_repartition_matches_the_reference_mesh(n, cap):
    rng = np.random.default_rng(n * 10 + (cap or 0))
    rows = n * 24
    keys = rng.integers(-50, 50, rows)
    payload = rng.integers(-(1 << 40), 1 << 40, rows)
    valid = rng.random(rows) < 0.8
    if cap == 5:  # the last owner full to its cap, with invalid rows after it
        valid[:] = False
        valid[:5] = True
    fn = ref_mesh.hash_repartition(ref_mesh.make_mesh(n), cap=cap)
    want = fn(jnp.asarray(keys), jnp.asarray(payload), jnp.asarray(valid))
    got = _exchange(keys, payload, valid, n, cap if cap is not None else rows // n)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, np.asarray(w))
    assert got[3] == int(want[3])
    if cap is not None and cap < 3:
        assert got[3] > 0
    if cap == 5:  # the reference's last writer emptied slot cap - 1, not counted as dropped
        assert got[2].tolist() == [True] * 4 + [False] and got[3] == 0


def test_entry_matches_the_reference_entry():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as g

    rstep, rex = g.entry()
    step, ex = entry("cpu")
    assert len(ex) == len(rex) == 8
    for a, b in zip(ex, rex):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for got, want in zip(step(*ex), rstep(*rex)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_dryrun_multichip_two_gloo_ranks():
    code = "from tidb_tpu_torch.entry import dryrun_multichip; dryrun_multichip(2, device='cpu', timeout=120)"
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert "gloo processes on the CPU" in lines[0]
    assert any(line.startswith("dryrun_multichip(2): ok") for line in lines)
    assert any(line.startswith("dryrun_multichip(2): TPC-H Q3 over a 2-rank mesh ok") for line in lines)


def test_dryrun_multichip_one_rank_on_the_cpu():
    res = dryrun_multichip(1, device="cpu")
    assert res["dropped"] == 0 and sum(res["counts"]) > 0
