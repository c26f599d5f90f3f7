"""The port's MPP path over a mesh of n ranks held to the reference's
program over `make_mesh(n)` (the conftest's 8 virtual CPU devices), in one
process.

* The engine: the plans of test_torch_mpp_modes.ENGINE_CASES (dense,
  sorted, rowpos with both clustered demotions, rows, no GROUP BY) and the
  clustered Q3 of test_torch_mpp.py, fused ON and OFF, at the default
  broadcast threshold (the builds of 20,000 lineitem rows are BROADCAST:
  replicated) and at `tidb_broadcast_join_threshold_count` 0 (every
  sort-probe level HASH: P2 at both sides), through the reference's
  MPPEngine on make_mesh(n) and the port's MPPEngine("cpu") on
  make_mesh(n, "cpu"): the same chunk in order (the ranks' results
  concatenated as the reference's out_specs concatenate them), the same
  mode, fusion outcome and reasons, fallback accounting and compile count.
  n = 2 for every case, n = 8 where it exercises something n = 2 does not
  (eight-way buckets, a duplicate-key level's per-device share, the rows
  and picks of eight ranks).
* Overflow: 1,024 stream rows on one owner over eight ranks overflow their
  exchange buckets; both engines count capacity_overflow with the same
  dropped-row count.
* P2's plain version (kernels/exchange.exchange_ref) against a numpy
  restatement of mpp.py:1483-1510 with the owner key of pack_keys (:1451):
  n_dev 2, 3 and 8, negative keys, int32 keys, masked rows, a probe side's
  invalid keys, an owner past its bucket.
* The mesh (parallel/mesh.py): one rank is the identity; the collectives
  of four CPU ranks against numpy (all_to_all, all_gather, psum with int64
  wrap and float order, pmin / pmax over uint64 and NaN, psum_scatter,
  reduce_lanes); a rank's error surfaces from Mesh.run, and a rank left in
  a collective by a failed peer leaves it too.
* chip_smoke.py's replay of every rank's P5 and P6 call of a mesh run
  (the check it makes on the card) on two CPU ranks.
* entry.dryrun_multichip(4) on the CPU: stages 1 and 2 in four gloo
  processes, stage 3 (TPC-H Q3 through run_mpp over make_mesh(4, "cpu"))
  equal to the one-device answer.

Decimals, keys, row ids and order compare exactly; floats within rtol
1e-9 / atol 1e-6.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch
from test_torch_engine import _assert_same_chunk
from test_torch_mpp import REF, PORT, ref_scans
from test_torch_mpp_modes import ENGINE_CASES, _mode, _same_outcome, plan_nodes

from tidb_tpu.models import tpch as ref_tpch
from tidb_tpu.parallel.mesh import make_mesh as ref_make_mesh
from tidb_tpu.parallel.mpp import MPPEngine as RefEngine
from tidb_tpu.session import Session

from tidb_tpu_torch.entry import dryrun_multichip
from tidb_tpu_torch.executor import mpp_gather
from tidb_tpu_torch.kernels.exchange import OwnerKey, bucket_cap, exchange, exchange_ref, unpack
from tidb_tpu_torch.models import tpch
from tidb_tpu_torch.parallel import mesh as mesh_mod
from tidb_tpu_torch.parallel.mesh import Mesh, make_mesh
from tidb_tpu_torch.parallel.mpp import MPPEngine
from tidb_tpu_torch.planner.fragment import HASH

N = 20_000
HASH_ALL = {"tidb_broadcast_join_threshold_count": 0}


@pytest.fixture(scope="module")
def session():
    s = Session()
    ref_tpch.setup_tpch(s, N)
    s.vars["tidb_enable_cop_result_cache"] = "OFF"
    return s


@pytest.fixture(scope="module")
def tables():
    li, orders, cust = tpch.generated_columns(N, 42)
    return {"lineitem": li, "orders": orders, "customer": cust}


@pytest.fixture(scope="module")
def meshes():
    made = {n: make_mesh(n, "cpu") for n in (2, 8)}
    yield made
    for m in made.values():
        m.close()


CASES = dict(ENGINE_CASES)
CASES["q3_clustered"] = (ref_tpch.Q3, tpch.q3_mpp_plan, {}, None, "clustered", None, "fused", {})
# n = 8 where eight ranks exercise something two do not
EIGHT = {("q3_fused_off", True), ("q18_dense", True), ("q10_fused_off", True), ("q3_top100", False),
         ("q3_clustered", False), ("seg_revenue", False)}
PARAMS = [(case, 2, hash_all) for case in sorted(CASES) for hash_all in (False, True)]
PARAMS += [(case, 8, hash_all) for case, hash_all in sorted(EIGHT)]


@pytest.mark.parametrize("case,n,hash_all", PARAMS)
def test_mesh_engine_matches_the_reference_mesh(session, tables, meshes, case, n, hash_all):
    sql, builder, variables, transform, mode, creason, outcome, reasons = CASES[case]
    variables = dict(variables, **HASH_ALL) if hash_all else variables
    t = transform(tables) if transform else tables
    rplan, _ = plan_nodes(session, sql)
    pplan = builder()
    ref, port = RefEngine(), MPPEngine("cpu")
    want = ref.execute(rplan, ref_scans(rplan, t, ref), ref_make_mesh(n), variables)
    got = port.execute(pplan, mpp_gather.scan_datas(pplan, t, port), variables, mesh=meshes[n])
    assert want is not None and got is not None
    assert got[1] == want[1] == (mode != "rows")
    assert got[0].num_rows > 0
    _assert_same_chunk(want[0], got[0])
    assert _mode(port) == (mode, creason)
    assert port.last_fuse_outcome == outcome and port.last_fuse_reasons == reasons
    levels = next(iter(port._programs.values())).levels.values()
    sort_levels = [lv.frag.exchange for lv in levels if not lv.use_lut]
    if hash_all:
        assert sort_levels and set(sort_levels) == {HASH} or outcome == "fused"
    _same_outcome(ref, port)


def test_skewed_keys_overflow_the_exchange_buckets_as_the_reference_counts_them():
    """1,024 stream rows with one join key over eight ranks: each rank's
    128 rows go to one owner, whose bucket holds bcap = 96 of them."""
    n, nd = 1024, 100
    tables = {"f": {"fid": np.arange(n), "k": np.full(n, 7)}, "d": {"id": np.arange(nd), "w": np.arange(nd) * 3}}
    spec = {"tables": {"f": [("fid", "bigint"), ("k", "bigint")], "d": [("id", "bigint"), ("w", "bigint")]},
            "scans": ["f", "d"], "joins": [(["f.k"], ["d.id"])]}
    assert bucket_cap(n // 8, 8) == 96
    variables = dict(HASH_ALL, tidb_tpu_mpp_fused="OFF")  # a sort-probe level, not a LUT
    rplan, pplan = REF.plan(spec), PORT.plan(spec)
    ref, port = RefEngine(), MPPEngine("cpu")
    mesh = make_mesh(8, "cpu")
    try:
        want = ref.execute(rplan, ref_scans(rplan, tables, ref), ref_make_mesh(8), variables)
        got = port.execute(pplan, mpp_gather.scan_datas(pplan, tables, port), variables, mesh=mesh)
    finally:
        mesh.close()
    assert want is None and got is None
    assert port.fallback_counts == ref.fallback_counts == {"capacity_overflow": 1}
    assert port.last_fallback_reason == ref.last_fallback_reason == "exchange bucket overflow (256 rows)"


# --- P2's plain version ----------------------------------------------------


def _numpy_exchange(n_dev, bcap, mask, keys, key_i32, probe, lanes):
    """mpp.py:1451-1463 (pack_keys) and :1483-1510 (exchange_all up to its
    all_to_all) in numpy: per lane its [n_dev, bcap] buffer, and the drops."""
    rows = len(mask)
    acc, kv = None, None
    for d, v, lo, st in keys:
        term = (d.astype(np.int64) - lo) * st
        acc = term if acc is None else acc + term
        if v is not None:
            kv = v if kv is None else kv & v
    if key_i32:
        acc = acc.astype(np.int32)
    okey = np.where(kv, acc, np.arange(rows)) if probe and kv is not None else acc
    owner = (okey % n_dev).astype(np.int32)
    own = np.where(mask, owner, n_dev)
    order = np.argsort(own, kind="stable")
    own_s = own[order]
    counts = np.bincount(own_s, minlength=n_dev + 1)[:n_dev]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    dropped = int(np.sum(counts - np.minimum(counts, bcap)))
    src = np.clip(starts[:, None] + np.arange(bcap)[None, :], 0, rows - 1)
    okg = np.arange(bcap)[None, :] < np.minimum(counts, bcap)[:, None]
    return [np.where(okg, lane[order][src], np.zeros((), lane.dtype)) for lane in lanes], dropped


EXCHANGE_CASES = {
    "two_keys": (2, 5000, False, False, 0.0),
    "three_owners_negative": (3, 4097, False, False, 0.1),
    "eight_i32_probe": (8, 3000, True, True, 0.2),
    "two_i32_build": (2, 3000, True, False, 0.1),
    "eight_masked": (8, 1000, False, True, 0.6),
    "one_owner_overflows": (8, 2000, False, False, -1.0),
}


@pytest.mark.parametrize("case", sorted(EXCHANGE_CASES))
def test_exchange_plain_version_is_the_reference_bucketing(case):
    n_dev, n, key_i32, probe, masked = EXCHANGE_CASES[case]
    rng = np.random.default_rng(len(case))
    if masked < 0:  # every key on owner 3, past its bucket
        k1 = np.full(n, 3) + n_dev * rng.integers(-50, 50, n)
        k2 = np.zeros(n, np.int64)
        mask = np.ones(n, bool)
    else:
        k1 = rng.integers(-(1 << 40), 1 << 40, n)
        k2 = rng.integers(-700, 700, n)
        mask = rng.random(n) >= masked
    v1, v2 = rng.random(n) > 0.1, rng.random(n) > 0.1
    lo, st = (-5, 3) if key_i32 else (-(1 << 20), 1 << 21)
    if key_i32:  # a domain-checked int32 key: the valid rows' packed keys fit
        k1 = np.where(v1, rng.integers(-5, 1000, n), k1)
        k2 = np.where(v2, rng.integers(-700, 700, n), k2)
    lanes = [rng.integers(-(1 << 62), 1 << 62, n), rng.standard_normal(n), rng.random(n) > 0.5,
             rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32), np.arange(n, dtype=np.int64)]
    bcap = bucket_cap(n, n_dev) if masked >= 0 else 100
    nkeys = [(k1, v1, lo, st), (k2, v2, 0, 1)]
    want, want_drop = _numpy_exchange(n_dev, bcap, mask, nkeys, key_i32, probe, lanes)
    keys = [OwnerKey(torch.from_numpy(d), torch.from_numpy(v), lo_, st_) for d, v, lo_, st_ in nkeys]
    tl = [torch.from_numpy(a) for a in lanes]
    send, dropped = exchange(n_dev, bcap, torch.from_numpy(mask), keys, key_i32, probe, tl)
    ref_send, ref_dropped = exchange_ref(n_dev, bcap, torch.from_numpy(mask), keys, key_i32, probe, tl)
    assert torch.equal(send, ref_send)  # the CPU tensor takes the plain version
    assert int(dropped) == want_drop and (want_drop > 0) == (masked < 0)
    for got, w in zip(unpack(send, tl, n_dev, bcap), want):
        np.testing.assert_array_equal(got.numpy(), w.reshape(-1))


def test_chip_smokes_replay_holds_every_ranks_p5_and_p6_call(tables, meshes):
    """chip_smoke.MeshModeSpy and hold_mesh_modes, which hold P5's local and
    final reduce and P6's block picks to their plain versions at
    main.mpp_mesh's inputs on the card, here on two CPU ranks: the unfused
    Q3 (every level HASH) and Q3 LIMIT 100 give each rank's call with its
    collectives' outputs, the replays agree, and the spied run's answers
    equal unspied ones."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    runs = ((tpch.q3_mpp_plan(), dict(HASH_ALL, tidb_tpu_mpp_fused="OFF"), "sorted"),
            (tpch.q3_mpp_plan(100), {}, "rowpos"))

    def answers():
        out = []
        for plan, variables, mode in runs:
            port = MPPEngine("cpu")
            out.append(port.execute(plan, mpp_gather.scan_datas(plan, tables, port), variables, mesh=meshes[2])[0])
            assert _mode(port)[0] == mode
        return out

    with chip_smoke.MeshModeSpy() as spy:
        spied = answers()
    for want, got in zip(answers(), spied):
        _assert_same_chunk(want, got)
    calls = spy.calls
    assert len(calls["seg_reduce"]) == len(calls["rowpos_agg"]) == 2 and calls["exchange"]
    assert all(c[1]["n_dev"] == 2 and c[2] is not None for name in ("seg_reduce", "rowpos_agg") for c in calls[name])
    assert chip_smoke.hold_mesh_modes(calls) == {"seg_reduce": 0.0, "rowpos_agg": 0.0}


# --- the mesh ----------------------------------------------------------------


def test_a_one_rank_mesh_is_the_identity():
    mesh = make_mesh(1, "cpu")
    assert mesh.n_dev == 1 and mesh.group(0) is None and mesh.axis_index(0) == 0
    t = torch.arange(6, dtype=torch.int64)
    assert torch.equal(mesh.all_to_all(0, t.view(1, 6)), t.view(1, 6)) and torch.equal(mesh.psum(0, t), t)
    assert mesh.pmin(0, t) is t and mesh.pmax(0, t, unsigned=True) is t
    assert torch.equal(mesh.psum_scatter(0, t), t) and torch.equal(mesh.all_gather(0, t), t.unsqueeze(0))
    assert mesh.run(lambda r: threading.current_thread()) == [threading.current_thread()]
    assert make_mesh(None, "cpu").n_dev == 1


def test_four_ranks_collectives_match_numpy():
    rng = np.random.default_rng(11)
    n = 4
    ints = rng.integers(-(1 << 62), 1 << 62, (n, 8))
    ints[:, 0] = np.iinfo(np.int64).max  # the sum wraps
    u64 = rng.integers(-(1 << 63), 1 << 63, (n, 8), dtype=np.int64)
    flt = rng.standard_normal((n, 8))
    flt[2, 3] = np.nan
    a2a = rng.integers(0, 1000, (n, n, 3))
    mesh = make_mesh(n, "cpu")
    try:
        def rank(r):
            i, u, f = (torch.from_numpy(x[r].copy()) for x in (ints, u64, flt))
            return (mesh.all_to_all(r, torch.from_numpy(a2a[r].copy())), mesh.all_gather(r, i),
                    mesh.psum(r, i), mesh.psum(r, f), mesh.pmin(r, u, unsigned=True), mesh.pmax(r, u),
                    mesh.pmin(r, f), mesh.psum_scatter(r, i), mesh.all_to_all(r, torch.from_numpy(a2a[r] > 500)),
                    mesh.reduce_lanes(r, [i, f, u], ["sum_i64", "max_f64", "max_u64"], scatter=True))
        outs = mesh.run(rank)
        assert mesh.collectives[0] == 10
    finally:
        mesh.close()
    with np.errstate(over="ignore"):
        isum = ints.sum(0)
    fsum = ((flt[0] + flt[1]) + flt[2]) + flt[3]
    umin = u64.view(np.uint64).min(0).view(np.int64)
    for r, (a, g, si, sf, mn, mx, fmin, ss, ab, lanes) in enumerate(outs):
        np.testing.assert_array_equal(a.numpy(), a2a[:, r])
        np.testing.assert_array_equal(g.numpy(), ints)
        np.testing.assert_array_equal(si.numpy(), isum)
        np.testing.assert_array_equal(sf.numpy(), fsum)
        np.testing.assert_array_equal(mn.numpy(), umin)
        np.testing.assert_array_equal(mx.numpy(), u64.max(0))
        np.testing.assert_array_equal(fmin.numpy(), np.minimum.reduce(flt))  # NaN propagates
        np.testing.assert_array_equal(ss.numpy(), isum[2 * r:2 * r + 2])
        assert ab.dtype == torch.bool and np.array_equal(ab.numpy(), a2a[:, r] > 500)
        np.testing.assert_array_equal(lanes[0].numpy(), isum[2 * r:2 * r + 2])
        np.testing.assert_array_equal(lanes[1].numpy(), np.maximum.reduce(flt)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(lanes[2].numpy(), u64.view(np.uint64).max(0).view(np.int64)[2 * r:2 * r + 2])


def test_a_rank_error_surfaces_from_mesh_run(monkeypatch):
    monkeypatch.setattr(mesh_mod, "TIMEOUT_S", 1.0)
    mesh = make_mesh(2, "cpu")

    def before_any_collective(r):
        if r == 1:
            raise ValueError("rank 1 failed")
        return r

    with pytest.raises(ValueError, match="rank 1 failed"):
        mesh.run(before_any_collective)
    assert mesh.run(lambda r: int(mesh.psum(r, torch.ones(1, dtype=torch.int64)))) == [2, 2]

    def in_a_collective(r):
        if r == 1:
            raise ValueError("rank 1 failed mid-program")
        return mesh.psum(r, torch.ones(1, dtype=torch.int64))

    with pytest.raises(ValueError, match="mid-program"):
        mesh.run(in_a_collective)
    with pytest.raises(RuntimeError, match="pending"):
        mesh.run(lambda r: r)
    mesh.close()
    assert isinstance(mesh, Mesh)


def test_dryrun_multichip_four_ranks_on_the_cpu(capfd):
    dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip(4): ok" in out
    assert "dryrun_multichip(4): TPC-H Q3 over a 4-rank mesh ok" in out
