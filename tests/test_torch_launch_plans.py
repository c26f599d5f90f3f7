"""Host-side plans of K4 (csrc/seg_agg.cu) and the expression kernel
(csrc/expr_eval.cu) as redesigned for the H100: the constants the host and
the sources share, K4's mode / block / scratch plan and its descriptor
table for a solo call, its warp pre-aggregation (the peers' shuffle tree)
modelled in numpy, the expression kernel's launch shape for programs from
one register to REG_BUDGET, the programs that emit their loads first, and
the host side of k4_profile.py (its ptxas reading, its source variants).
The kernels themselves run only on the card (chip_smoke.py)."""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tidb_tpu_torch.expr import program as P
from tidb_tpu_torch.kernels.expr_eval import (MAX_THREADS, SM_SMEM, SM_THREADS, expr_eval_ref, launch_shape,
                                              register_bytes)

SA = importlib.import_module("tidb_tpu_torch.kernels.seg_agg")
COMPILE = P.compile_program
CSRC = Path(P.__file__).resolve().parent.parent / "csrc"
N_SMS = 132


def _constant(src: str, name: str) -> int:
    m = re.search(rf"constexpr (?:int|unsigned) {name} = (\d+);", (CSRC / src).read_text())
    assert m, f"{src}: no constant {name}"
    return int(m.group(1))


def test_sources_and_host_share_their_constants():
    assert _constant("expr_eval.cu", "U") == P.ROWS == 4
    assert _constant("seg_agg.cu", "U") == SA.ROWS
    assert _constant("seg_agg.cu", "REG_LANES") == SA.REG_LANES
    assert _constant("seg_agg.cu", "MAX_THREADS") == SA.MAX_THREADS
    assert f"__launch_bounds__({MAX_THREADS}, {SM_THREADS // MAX_THREADS})" in (CSRC / "expr_eval.cu").read_text()
    assert f"__launch_bounds__(MAX_THREADS, 2)" in (CSRC / "seg_agg.cu").read_text()
    enum = re.search(r"enum Mode : int \{([^}]*)\}", (CSRC / "seg_agg.cu").read_text()).group(1)
    assert {k.strip().split(" = ")[0]: int(k.split(" = ")[1]) for k in enum.split(",")} == {
        f"MODE_{m.upper()}": v for m, v in SA.MODES.items()}
    # the budget: REG_BUDGET registers of a 32-thread block beside 64 KB of tables
    assert P.REG_BUDGET * 32 * (8 * P.ROWS + 1) <= P.SMEM_MAX - 64 * 1024 < (P.REG_BUDGET + 1) * 32 * (8 * P.ROWS + 1)


# --- the expression kernel's launch shape ---------------------------------------


def _program(nregs: int, nk: int = 4, n_in: int = 9, n_out: int = 5, nops: int = 25) -> P.Program:
    return P.Program(np.zeros((nops, 5), np.int32), np.zeros(nk, np.int64), nregs, [("d", j) for j in range(n_in)],
                     [8] * n_out, None, [], False)


def _resident(prog: P.Program, threads: int):
    """(shared bytes, ops in shared memory, blocks an SM) of a block of
    `threads`, recomputed here; None when its register file does not fit."""
    tables = 8 * (len(prog.consts) + len(prog.inputs) + len(prog.outputs))
    regs = 8 * P.ROWS * prog.nregs * threads + -(-prog.nregs * threads // 16) * 16
    if tables + regs > P.SMEM_MAX:
        return None
    in_smem = tables + regs + 20 * len(prog.ops) <= P.SMEM_MAX
    smem = tables + regs + 20 * len(prog.ops) * in_smem
    return smem, in_smem, max(1, min(SM_THREADS // threads, SM_SMEM // (smem + 1024)))


@pytest.mark.parametrize("n", [1, 3, 4095, 16_000_000])
@pytest.mark.parametrize("nregs", [1, 2, 6, 7, 33, 64, 100, P.REG_BUDGET])
def test_launch_shape_sizes_the_block_from_the_registers(nregs, n):
    prog = _program(nregs)
    threads, blocks, smem, in_smem = launch_shape(prog, n, N_SMS)
    assert 32 <= threads <= MAX_THREADS and threads % 32 == 0
    # nregs * (8 * ROWS + 1) bytes a thread: ROWS data words and a byte of valid bits a register
    assert register_bytes(nregs, threads) == 8 * P.ROWS * nregs * threads + -(-nregs * threads // 16) * 16
    assert (smem, in_smem) == _resident(prog, threads)[:2] and smem <= P.SMEM_MAX
    # the block that keeps the most threads on an SM
    fits = {t: _resident(prog, t) for t in range(32, MAX_THREADS + 1, 32) if _resident(prog, t) is not None}
    most = max(t * r[2] for t, r in fits.items())
    assert threads * fits[threads][2] == most and threads == max(t for t, r in fits.items() if t * r[2] == most)
    per_sm = fits[threads][2]
    groups = -(-n // P.ROWS)
    assert blocks == max(1, min(-(-groups // threads), N_SMS * per_sm))
    # every row is covered, by one pass or by a grid that fills the card
    assert blocks * threads * P.ROWS >= n or blocks == N_SMS * per_sm
    if nregs <= 7:  # TPC-H Q1's, Q6's and CHECKSUM's programs: most of an SM's threads
        assert most >= 0.9 * SM_THREADS


def test_launch_shape_takes_the_op_table_out_of_shared_memory_when_it_does_not_fit():
    prog = _program(P.REG_BUDGET, nops=4000)
    threads, _, smem, in_smem = launch_shape(prog, 1000, N_SMS)
    assert threads == 32 and not in_smem and smem <= P.SMEM_MAX


# --- programs emit their loads first ----------------------------------------------


def _loads_first(prog: P.Program) -> bool:
    names = [P.OP[n] for n in P.LOADS]
    return prog.loads == int(np.isin(prog.ops[:, 0], names).sum())


def _captured_programs(monkeypatch):
    """The port's programs of TPC-H Q1, Q6 and CHECKSUM (the engine on the
    CPU) and of Q3's MPP scan selections and aggregate arguments, with the
    trees they were compiled from and their input lanes."""
    from tidb_tpu_torch.entry import batch_from_numpy, run_mpp, run_query
    from tidb_tpu_torch.models import tpch

    compiled, ran = [], []
    real_compile, real_kernel = P.compile_program, P.kernel()
    monkeypatch.setattr(P, "compile_program", lambda *a, **kw: compiled.append((a, kw)) or real_compile(*a, **kw))
    monkeypatch.setattr(P, "kernel", lambda: lambda prog, ins, n: ran.append((prog, ins, n)) or real_kernel(prog, ins, n))
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(3000, seed=5))
    for q in ("q1_dag", "q6_dag", "checksum_dag"):
        run_query(getattr(tpch, q)(), batch, device="cpu")
    li, orders, cust = tpch.generated_columns(4000, seed=5)
    run_mpp(tpch.q3_mpp_plan(), {"lineitem": li, "orders": orders, "customer": cust}, device="cpu")
    return compiled, ran


def test_main_path_programs_load_first_and_match_the_unreordered_program(monkeypatch):
    compiled, ran = _captured_programs(monkeypatch)
    assert len(ran) >= 5
    by_id = {}
    for (conds, values, kinds), kw in compiled:
        prog = COMPILE(conds, values, kinds, **kw)
        plain = P._compile(list(conds), list(values), dict(kinds), kw.get("mask", True), reload=False)
        by_id[prog.ops.tobytes()] = plain
    for prog, ins, n in ran:
        assert _loads_first(prog) and not prog.reload
        plain = by_id[prog.ops.tobytes()]
        assert plain.inputs == prog.inputs and plain.outputs == prog.outputs
        for got, want in zip(expr_eval_ref(prog, ins, n), expr_eval_ref(plain, ins, n)):
            assert torch.equal(got, want)


def test_a_program_past_the_budget_with_its_loads_first_keeps_them_at_their_uses():
    from tidb_tpu_torch.expr.expression import Column, make_func
    from tidb_tpu_torch.mysqltypes import field_type as F

    cols = [Column(j, F.ft_longlong(), f"c{j}") for j in range(12)]
    t = cols[0]
    for c in cols[1:]:
        t = make_func("plus", t, c)
    kinds = {j: "i64" for j in range(12)}
    first = P.compile_program([], [P.ValueSpec(t)], kinds, mask=False)
    assert _loads_first(first) and first.loads == 12 and first.nregs == 12
    tight = P.compile_program([], [P.ValueSpec(t)], kinds, mask=False, max_regs=4)
    assert not tight.reload and tight.loads == 2 and tight.nregs <= 4
    rng = np.random.default_rng(3)
    ins = []
    for _ in range(12):
        ins += [torch.from_numpy(rng.integers(-1 << 62, 1 << 62, 50)), torch.from_numpy(rng.random(50) < 0.8)]
    order = {k: j for j, k in enumerate([("d", j) for j in range(12)] + [("v", j) for j in range(12)])}
    lanes = lambda prog: [ins[2 * k[1] + (k[0] == "v")] for k in prog.inputs]  # noqa: E731
    assert all(k in order for k in first.inputs)
    for a, b in zip(expr_eval_ref(first, lanes(first), 50), expr_eval_ref(tight, lanes(tight), 50)):
        assert torch.equal(a, b)


# --- K4's plan -------------------------------------------------------------------

# (width, G, nkeys, nlanes, nseg, shared_out) → (mode, threads, blocks): TPC-H Q1 (16 lanes, nseg
# 12), Q6 (3 lanes, one slot), CHECKSUM (5 lanes, nseg 4), Q18's subquery (K9's ids, ~3.9M groups),
# Q1's 7 regions of 2,097,152 rows in one group, the burst's 64 point aggregations, a sort group's
# shared outputs, an empty call, and slots past the warps' budget
PLAN_CASES = {
    "q1": ((16_000_000, 1, 2, 16, 12, False), ("warp", 512, 264)),
    "q6": ((16_000_000, 1, 0, 3, 1, False), ("reg", 512, 264)),
    "checksum": ((16_000_000, 1, 1, 5, 4, False), ("warp", 512, 264)),
    "q18_inner": ((16_000_000, 1, 0, 3, 4_194_304, False), ("global", 256, 528)),
    "q1_regions": ((2_097_152, 7, 2, 16, 12, False), ("warp", 512, 38)),
    "burst": ((4096, 64, 0, 3, 1, False), ("reg", 512, 2)),
    "sort_group": ((4096, 7, 0, 3, 900, True), ("warp", 128, 8)),
    "empty": ((0, 1, 0, 2, 1, False), ("reg", 512, 1)),
    "five_lanes_one_slot": ((100_000, 1, 0, 5, 1, False), ("warp", 512, 49)),
    "wide_slots": ((100_000, 1, 1, 11, 200, False), ("warp", 160, 132)),
    "past_the_warps": ((100_000, 1, 1, 11, 5000, False), ("global", 256, 98)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_seg_agg_plan(case):
    (width, G, nk, nl, nseg, shared), (mode, threads, blocks) = PLAN_CASES[case]
    p = SA.plan(width, G, nk, nl, nseg, N_SMS, shared_out=shared)
    assert (p.mode, p.threads, p.blocks) == (mode, threads, blocks)
    S = nl * nseg
    desc = nl * 32 + nk * 40 + 8 * nl + 4
    assert SA.desc_bytes(nk, nl) == -(-desc // 16) * 16
    if mode == "global":
        assert p.smem == SA.desc_bytes(nk, nl) and p.parts == 0
        return
    W = threads // 32
    assert 4 <= W <= 16 and W * S * 8 <= SA.WARP_SLOTS_BYTES
    assert p.smem == SA.desc_bytes(nk, nl) + 8 * max(W * S, threads) <= 227 * 1024
    # the scratch: a partial a block and slot — when a merge happens
    merges = blocks > 1 or (shared and G > 1)
    assert p.parts == (G * blocks * S if merges else 0)
    # the blocks a last block folds stay within MERGE_BYTES past one block an SM
    assert blocks * S * 8 * (G if shared else 1) <= max(SA.MERGE_BYTES, 8 * S * N_SMS * (G if shared else 1))


def test_seg_agg_plan_spreads_a_group_like_one_solo_launch():
    solo = SA.plan(7 * 2_097_152, 1, 2, 16, 12, N_SMS)
    group = SA.plan(2_097_152, 7, 2, 16, 12, N_SMS)
    assert abs(group.blocks * 7 - solo.blocks) < 7 and group.threads == solo.threads


def test_solo_descriptor_table_holds_the_call():
    """The one pinned table of a solo call: a TaskAgg, then the KeyDescs,
    then the LaneDescs, field by field as csrc/seg_agg.cu reads them."""
    from tidb_tpu_torch.kernels import SegKey, SegLane

    n = 100
    rng = np.random.default_rng(1)
    mask = torch.from_numpy(rng.random(n) < 0.7)
    keys = [SegKey(torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)), torch.from_numpy(rng.random(n) < 0.9),
                   0, 3), SegKey(torch.from_numpy(rng.integers(5, 7, n)), None, 5, 2)]
    x = torch.from_numpy(rng.integers(-9, 9, n))
    f = torch.from_numpy(rng.random(n))
    lanes = [SegLane("count"), SegLane("sum_i64", x, mask), SegLane("min_f64", f, None, float("inf")),
             SegLane("first_row", None, mask, n), SegLane("xor_i64", x)]
    iout, fout = torch.empty((4, 12)), torch.empty((1, 12))
    base = 1 << 36
    host = SA.seg_desc([mask], [keys], [lanes], n, base, iout[None], fout[None])
    assert host.shape == (SA.TASK_DESC + 2 * SA.KEY_DESC + 5 * SA.LANE_DESC,)
    k0, l0 = SA.TASK_DESC, SA.TASK_DESC + 2 * SA.KEY_DESC
    assert list(host[:k0]) == [mask.data_ptr(), 0, base + 8 * k0, base + 8 * l0, iout.data_ptr(), fout.data_ptr()]
    assert list(host[k0:k0 + 5]) == [keys[0].data.data_ptr(), keys[0].valid.data_ptr(), 0, 3, 4]
    assert list(host[k0 + 5:l0]) == [keys[1].data.data_ptr(), 0, 5, 2, 8]
    inf_bits = int(np.array(np.inf).view(np.int64))
    want = [(0, 0, 0, 0), (x.data_ptr(), mask.data_ptr(), 0, 1 | 1 << 32), (f.data_ptr(), 0, inf_bits, 7),
            (0, mask.data_ptr(), n, 9 | 2 << 32), (x.data_ptr(), 0, 0, 12 | 3 << 32)]
    assert [tuple(int(v) for v in host[l0 + 4 * j:l0 + 4 * j + 4]) for j in range(5)] == want
    seg = torch.from_numpy(rng.integers(0, 12, n).astype(np.int32))
    shared = SA.seg_desc([mask], [[]], [lanes], n, base, iout, fout, [seg])
    assert list(shared[:SA.TASK_DESC]) == [mask.data_ptr(), seg.data_ptr(), base + 8 * SA.TASK_DESC,
                                          base + 8 * SA.TASK_DESC, iout.data_ptr(), fout.data_ptr()]
    # the solo wrapper's quick table lays out the same words
    assert np.array_equal(SA.solo_desc(mask, keys, lanes, base, iout, fout), host)
    assert np.array_equal(SA.solo_desc(mask, [], lanes, base, iout, fout, seg), shared)
    empty = torch.empty((0, 12))
    assert np.array_equal(SA.solo_desc(mask, keys, lanes[:2], base, iout, empty),
                          SA.seg_desc([mask], [keys], [lanes[:2]], n, base, iout[None], empty[None]))


# --- the warp pre-aggregation, modelled -----------------------------------------

_M64 = (1 << 64) - 1


def _ffs(x: int) -> int:
    return (x & -x).bit_length()


def _peer_tree(s: list):
    """find_peers of csrc/seg_agg.cu over one row of a warp: each lane's
    peers, its 6-bit-a-round shuffle schedule, the rounds, the leaders."""
    peers = [sum(1 << j for j in range(32) if s[j] == s[i]) for i in range(32)]
    hi = [peers[i] & (0xFFFFFFFE << i) & 0xFFFFFFFF for i in range(32)]
    rank = [bin(peers[i] & ((1 << i) - 1)).count("1") for i in range(32)]
    sched, rounds = [0] * 32, 0
    while any(hi):
        for i in range(32):
            sched[i] |= _ffs(hi[i]) << (6 * rounds)
        ballot = sum(1 << i for i in range(32) if not rank[i] & 1)
        hi = [h & ballot for h in hi]
        rank = [r >> 1 for r in rank]
        rounds += 1
    lead = [s[i] >= 0 and _ffs(peers[i]) - 1 == i for i in range(32)]
    return peers, sched, rounds, lead


def _shuffle_tree(vals: list, sched: list, rounds: int, comb) -> list:
    v = list(vals)
    for r in range(rounds):
        nx = [(sched[i] >> (6 * r)) & 63 for i in range(32)]
        got = [v[nx[i] - 1] if nx[i] else v[i] for i in range(32)]  # every lane shuffles at once
        v = [comb(v[i], got[i]) if nx[i] else v[i] for i in range(32)]
    return v


def _fmin(a: float, b: float) -> float:
    return a if a != a else (b if b != b else (b if b < a else a))


_COMBS = {"sum_i64": lambda a, b: (a + b) & _M64, "max_u64": max, "xor_i64": lambda a, b: a ^ b, "min_f64": _fmin}


@pytest.mark.parametrize("pattern", ["one_segment", "distinct", "q1_like", "masked_half", "two_runs", "random"])
def test_warp_peer_tree_folds_each_segment_into_its_lowest_lane(pattern):
    rng = np.random.default_rng(hash(pattern) % 1000)
    for _ in range(20):
        s = {"one_segment": [0] * 32, "distinct": list(range(32)),
             "q1_like": [int(c) for c in rng.choice([4, 5, 7, 10], 32)],
             "masked_half": [int(c) if rng.random() < 0.5 else -1 for c in rng.integers(0, 3, 32)],
             "two_runs": [0] * 16 + [1] * 16, "random": [int(c) for c in rng.integers(-1, 12, 32)]}[pattern]
        peers, sched, rounds, lead = _peer_tree(s)
        assert rounds <= 5 and all(sched[i] < 1 << 30 for i in range(32))
        assert sum(lead) == len({x for x in s if x >= 0})
        ints = [int(v) & _M64 for v in rng.integers(-(1 << 63), (1 << 63) - 1, 32, dtype=np.int64)]
        floats = [float(v) for v in rng.choice([np.nan, -np.inf, np.inf, -0.0, 1.5, -2.5, 3.0], 32)]
        for op, comb in _COMBS.items():
            vals = floats if op == "min_f64" else ints
            out = _shuffle_tree(vals, sched, rounds, comb)
            for i in range(32):
                if lead[i]:
                    group = [vals[j] for j in range(32) if s[j] == s[i]]
                    want = group[0]
                    for g in group[1:]:
                        want = comb(want, g)
                    assert (out[i] != out[i] and want != want) or out[i] == want, (op, pattern, s)
        # FIRST_ROW from a ballot: rows ascend with the lane (U rows a lane)
        ok = [bool(b) for b in rng.random(32) < 0.6]
        for i in range(32):
            if lead[i]:
                hits = sum(1 << j for j in range(32) if ok[j]) & peers[i]
                rows = [j * 4 + 2 for j in range(32) if s[j] == s[i] and ok[j]]
                assert (hits and (_ffs(hits) - 1) * 4 + 2 == min(rows)) or (not hits and not rows)


# --- the card's edge batteries, run here through the plain versions ---------------


@pytest.mark.parametrize("battery", ["seg_edge_cases", "expr_edge_cases"])
def test_edge_batteries_hold_through_the_plain_versions(battery):
    """chip_smoke.py's batteries for the redesigned kernels, on the CPU
    (the wrappers' plain versions): every case builds and holds."""
    import chip_smoke

    cases = getattr(chip_smoke, battery)("cpu", np.random.default_rng(2))
    assert len(cases) >= 20
    for _name, fn in cases:
        fn()


def test_edge_programs_hold_every_opcode():
    import chip_smoke

    rng = np.random.default_rng(4)
    cols = chip_smoke.expr_lanes(rng, 64)
    progs = chip_smoke._opcode_programs(rng, cols, chip_smoke.expr_kinds(cols))
    assert chip_smoke.expr_opcodes(progs) == set(P.OP) - {"NOP"}


def test_shared_output_plain_version_keeps_a_groupless_task_on_the_tasks_device():
    """A sort group's task with no group adds empty columns on the tasks'
    device (they were made on the CPU, which broke the plain version on
    the card); "meta" tensors stand in for a card's here."""
    from tidb_tpu_torch.kernels import SegLane
    from tidb_tpu_torch.kernels.grouped import seg_agg_tasks_ref

    dev, w = torch.device("meta"), 8
    masks = [torch.ones(w, dtype=torch.bool, device=dev) for _ in range(3)]
    lanes = [[SegLane("count"), SegLane("sum_f64", torch.zeros(w, dtype=torch.float64, device=dev))]
             for _ in range(3)]
    segs = [torch.zeros(w, dtype=torch.int32, device=dev) + c for c in (0, 3, 3)]
    ints, floats = seg_agg_tasks_ref(masks, [[]] * 3, lanes, 5, w, segs=segs, counts=[3, 0, 2])
    assert ints.device == floats.device == dev and ints.shape == floats.shape == (1, 5)


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114seg_agg_kernelILi1EEEvPKNS_7TaskAggExiixiPxPy' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114seg_agg_kernelILi1EEEvPKNS_7TaskAggExiixiPxPy
    40 bytes stack frame, 56 bytes spill stores, 68 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 40 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111init_kernelEPKNS_7TaskAggEix' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111init_kernelEPKNS_7TaskAggEix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114seg_agg_kernelILi0EEEvPKNS_7TaskAggExiixiPxPy' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114seg_agg_kernelILi0EEEvPKNS_7TaskAggExiixiPxPy
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers
"""


def test_k4_profile_reads_each_modes_registers_and_spills():
    import k4_profile

    assert k4_profile.ptxas_report(_PTXAS) == {
        "warp": {"spill_stores": 56, "spill_loads": 68, "registers": 64},
        "reg": {"spill_stores": 0, "spill_loads": 0, "registers": 128}}


def test_k4_profile_bounds_variants_edit_the_source_once():
    import k4_profile

    src = (CSRC / "seg_agg.cu").read_text()
    assert src.count(k4_profile.BOUNDS) == 1 and k4_profile.VARIANTS["512x2"][0] == k4_profile.BOUNDS
    for bounds, max_threads, _ in k4_profile.VARIANTS.values():
        assert src.replace(k4_profile.BOUNDS, bounds).count("__launch_bounds__(") == 1
        assert max_threads <= SA.MAX_THREADS


def test_k4_profile_without_a_card_exits_non_zero():
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: k4_profile.py would run for real")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, str(root / "k4_profile.py")], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
