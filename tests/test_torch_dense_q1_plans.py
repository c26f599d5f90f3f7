"""Host-side plans of P8 (the dense MPP aggregation, kernels/dense_agg.py
over K4's kernel, csrc/seg_agg.cu) and M1 (csrc/q1_local.cu) as redesigned
for the H100, modelled in numpy and held to the reference:

  * P8's one upload: K4's one-task table, word by word (the mask, the
    dense keys in their int32-wrap form, every lane into its row of the
    packed result), and a numpy model of what K4 computes from those words
    (the int32 mixed-radix code, the drops, the folds, the rows at their
    stride) against the reference's code (tidb_tpu/parallel/mpp.py:
    1962-1967, its jnp expression as written) and dense_agg_ref — keys
    above 2^31, negative codes and codes at or past nseg, no key, NULL
    keys, masked rows, rows wider than nseg, float and uint64 lanes;
  * K4's plain version over those int32-wrap keys (seg_agg.group_code);
  * M1's staged schedule: every row read once, by one block's tiles in
    stage order, each stream's bulk copy a 16-byte-aligned window inside
    the stream's own 16-byte chunks and the stage's room, for n of 0, 1, a
    tile less one, a tile, a tile and one and several sweeps, at every
    start offset 0-15 modulo 16;
  * the constants the sources and the wrappers share.

The kernels run only on the card (chip_smoke.py holds them to the plain
versions there); these tests need no card.
"""

from __future__ import annotations

import importlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import dense_battery, p8_args, q1_battery, q1_edge_shapes
from tidb_tpu.jaxenv import jnp  # the reference's JAX, int64 on
from tidb_tpu_torch.kernels import red

P8, SA, M1 = (importlib.import_module(f"tidb_tpu_torch.kernels.{m}") for m in ("dense_agg", "seg_agg", "q1_local"))
CSRC = Path(SA.__file__).resolve().parent.parent / "csrc"
ROOT = CSRC.parents[1]
N_SMS = 132


def _constant(src: str, name: str) -> int:
    m = re.search(rf"constexpr (?:int|int64_t) {name} = ([^;]+);", (CSRC / src).read_text())
    assert m, (src, name)
    expr = m.group(1)
    for other in set(re.findall(r"\b[A-Z][A-Z_]+\b", expr)):
        expr = re.sub(rf"\b{other}\b", str(_constant(src, other)), expr)
    return int(eval(expr))  # noqa: S307 — an integer expression of the source's own constants


# --- P8: the one-task K4 table ---------------------------------------------------

def _i32(x):
    return ((np.asarray(x, dtype=np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int64)


def _battery(case: str, n: int = 3000) -> dict:
    """dense_battery's cases, and: one NULL-able key whose codes reach
    nseg and below 0 ('edges'); every row masked ('masked')."""
    rng = np.random.default_rng(sum(map(ord, case)) + n)
    if case in ("mixed", "big_keys", "global", "no_keys", "codes", "wrap"):
        return dense_battery(rng, n, case)
    b = dense_battery(rng, n, "mixed")
    if case == "masked":
        b["mask"][:] = False
    elif case == "edges":
        lo, dom = 10, 7
        d = lo + rng.integers(-3, dom + 4, n)  # below lo: negative codes; past the domain: at or past nseg
        v = rng.random(n) > 0.3
        b["keys"], b["nseg"] = [(np.where(v, d, 0).astype(np.int64), v, lo, dom)], dom + 1
    return b


CASES = ("mixed", "big_keys", "global", "no_keys", "codes", "wrap", "masked", "edges")


def _ref_code(b: dict) -> np.ndarray:
    """The reference's int32 code (mpp.py:1962-1967), its jnp expression as
    written; nseg where masked."""
    n = len(b["mask"])
    code = jnp.zeros(n, dtype=jnp.int32)
    for d, v, lo, dom in b["keys"]:
        code = code * (dom + 1) + (jnp.asarray(d).astype(jnp.int32) - lo + 1) * jnp.asarray(v)
    return np.asarray(jnp.where(jnp.asarray(b["mask"]), code, b["nseg"])).astype(np.int64)


def _call(b: dict, pad: int):
    """A call's CPU tensors, K4's lanes and the packed rows it writes into
    (`pad` columns past nseg, as the engine's packed width)."""
    mask, keys, nseg, lanes = p8_args(b, "cpu")
    rows = torch.full((len(lanes) + 2, nseg + pad), -5, dtype=torch.int64)[1:1 + len(lanes)]
    return mask, keys, nseg, lanes, [red.seg_lane(ln) for ln in lanes], rows


def _model(words: np.ndarray, base: int, tensors: dict, n: int, nseg: int, ostride: int, out: torch.Tensor) -> None:
    """What csrc/seg_agg.cu computes from a one-task table at `base`: the
    rows' code from the key descriptors (the launch's int32-wrap form:
    int32(d) - lo + 1 and the code wrapped to int32 after each key), masked rows and codes
    outside [0, nseg) dropped, each lane folded by its op into row `out`
    of the matrix at iout, `ostride` words apart (float lanes as bits),
    empty slots at the lane's fill."""
    task = words[:SA.TASK_DESC]
    nk = (int(task[3]) - int(task[2])) // (8 * SA.KEY_DESC)
    assert task[2] == base + 8 * SA.TASK_DESC and task[4] == task[5] and task[1] == 0
    mask = tensors[int(task[0])].numpy()
    code = np.zeros(n, dtype=np.int64)
    keyw = words[SA.TASK_DESC:SA.TASK_DESC + SA.KEY_DESC * nk].reshape(nk, SA.KEY_DESC)
    for data, valid, lo, dom, eb in keyw:
        assert eb == 8 and -(1 << 31) <= lo < 1 << 31
        d = tensors[int(data)].numpy()
        v = tensors[int(valid)].numpy()
        kd = np.where(v, _i32(d) - lo + 1, 0)
        code = _i32(code * (dom + 1) + kd)
    live = mask & (code >= 0) & (code < nseg)
    lanew = words[SA.TASK_DESC + SA.KEY_DESC * nk:].reshape(-1, SA.LANE_DESC)
    flat = out.reshape(-1)
    ops = {v: k for k, v in SA.OPS.items()}
    for data, valid, fill, opw in lanew:
        op, row = ops[int(opw) & 0xFFFFFFFF], int(opw) >> 32
        ok = live.copy() if valid == 0 else live & tensors[int(valid)].numpy()
        seg = code[ok]
        x = None if data == 0 else tensors[int(data)].numpy()[ok]
        slot = np.full(nseg, fill, dtype=np.int64)
        if op == "count":
            slot = np.bincount(seg, minlength=nseg).astype(np.int64)
        elif op == "sum_i64":
            slot = np.zeros(nseg, dtype=np.uint64)
            np.add.at(slot, seg, x.view(np.uint64))
            slot = slot.view(np.int64)
        elif op == "sum_f64":
            acc = np.zeros(nseg)
            np.add.at(acc, seg, x)
            slot = acc.view(np.int64)
        elif op in ("min_i64", "max_i64"):
            (np.minimum if op == "min_i64" else np.maximum).at(slot, seg, x)
        elif op in ("min_u64", "max_u64"):
            u = slot.view(np.uint64)
            (np.minimum if op == "min_u64" else np.maximum).at(u, seg, x.view(np.uint64))
            slot = u.view(np.int64)
        elif op in ("min_f64", "max_f64"):  # NaN wins, as XLA's min / max
            f = slot.view(np.float64).copy()
            with np.errstate(invalid="ignore"):
                (np.minimum if op == "min_f64" else np.maximum).at(f, seg, x)
            slot = f.view(np.int64)
        else:
            raise AssertionError(op)
        flat[row * ostride:row * ostride + nseg] = torch.from_numpy(slot)


@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("case", CASES)
def test_dense_table_holds_the_call_word_by_word(case, pad):
    b = _battery(case)
    mask, keys, nseg, lanes, k4_lanes, rows = _call(b, pad)
    base = 1 << 36
    words = np.array(P8.table(mask, keys, k4_lanes, base, rows), dtype=np.int64)
    nk, nl = len(keys), len(lanes)
    assert words.shape == (P8.table_words(nk, nl),) == (SA.TASK_DESC + SA.KEY_DESC * nk + SA.LANE_DESC * nl,)
    k0, l0 = SA.TASK_DESC, SA.TASK_DESC + SA.KEY_DESC * nk
    # the task: the mask, no segment lane, its key and lane rows, the packed rows for both matrices
    assert list(words[:k0]) == [mask.data_ptr(), 0, base + 8 * k0, base + 8 * l0, rows.data_ptr(), rows.data_ptr()]
    for j, (k, (d, v, lo, dom)) in enumerate(zip(keys, b["keys"])):
        assert list(words[k0 + SA.KEY_DESC * j:k0 + SA.KEY_DESC * (j + 1)]) == [
            k.data.data_ptr(), k.valid.data_ptr(), int(_i32(lo)), dom, 8]
    for j, (ln, kl) in enumerate(zip(lanes, k4_lanes)):
        w = [int(x) for x in words[l0 + SA.LANE_DESC * j:l0 + SA.LANE_DESC * (j + 1)]]
        fill = red.identity_bits(ln.op)
        assert w[2] == (fill - (1 << 64) if fill > (1 << 63) - 1 else fill)
        assert w[3] == SA.OPS[kl.op] | j << 32  # lane j's row of the packed result
        assert w[0] == (0 if kl.data is None else kl.data.data_ptr())
        assert w[1] == (0 if kl.valid is None else kl.valid.data_ptr())
        if ln.op in ("min_u64", "max_u64"):  # the sentinel folded into the data (red.seg_lane)
            assert kl.valid is None and w[0] != ln.data.data_ptr()


@pytest.mark.parametrize("pad", [0, 3])
@pytest.mark.parametrize("case", CASES)
def test_dense_table_model_is_the_reference_partials(case, pad):
    b = _battery(case)
    mask, keys, nseg, lanes, k4_lanes, rows = _call(b, pad)
    words = np.array(P8.table(mask, keys, k4_lanes, 1 << 36, rows), dtype=np.int64)
    tensors = {t.data_ptr(): t for t in [mask] + [x for k in keys for x in (k.data, k.valid)]
               + [x for ln in k4_lanes for x in (ln.data, ln.valid) if x is not None]}
    n = mask.shape[0]
    # the model of the fused code against the reference's jnp code
    code = np.zeros(n, dtype=np.int64)
    for data, valid, lo, dom, _ in words[SA.TASK_DESC:SA.TASK_DESC + SA.KEY_DESC * len(keys)].reshape(-1, 5):
        d, v = tensors[int(data)].numpy(), tensors[int(valid)].numpy()
        code = _i32(code * (dom + 1) + np.where(v, _i32(d) - lo + 1, 0))
    ref = _ref_code(b)
    assert np.array_equal(np.where(b["mask"], code, nseg), ref)
    assert np.array_equal(P8.dense_code_ref(mask, keys, nseg).numpy(), np.where((ref >= 0) & (ref <= nseg), ref, nseg))
    # the folds into the packed rows at their stride, against dense_agg_ref
    flat = torch.full((rows.shape[0] * rows.stride(0),), -5, dtype=torch.int64)
    _model(words, 1 << 36, tensors, n, nseg, rows.stride(0), flat)
    got = flat.view(rows.shape[0], rows.stride(0))[:, :rows.shape[1]]
    want = torch.full_like(rows, -5)
    P8.dense_agg_ref(mask, keys, nseg, lanes, rows=want)
    assert torch.equal(got[:, nseg:], want[:, nseg:])  # nothing written past nseg
    for j, ln in enumerate(lanes):
        g, w = got[j, :nseg], want[j, :nseg]
        if ln.is_float:  # summation order: the reference's tolerance
            assert torch.allclose(g.view(torch.float64), w.view(torch.float64), rtol=1e-9, atol=1e-6, equal_nan=True)
        else:
            assert torch.equal(g, w), (case, j, ln.op)


@pytest.mark.parametrize("case", CASES)
def test_k4_group_code_of_int32_wrap_keys_is_the_dense_code(case):
    b = _battery(case)
    mask, keys, nseg, *_ = _call(b, 0)
    assert torch.equal(SA.group_code(mask, P8.seg_keys(keys), nseg), P8.dense_code_ref(mask, keys, nseg))


def test_dense_agg_on_the_cpu_takes_its_plain_version_into_wide_rows():
    b = _battery("codes")
    mask, keys, nseg, lanes, _, rows = _call(b, 4)
    launches = P8.dense_agg.launches
    got = P8.dense_agg(mask, keys, nseg, lanes, rows=rows)
    want = P8.dense_agg_ref(mask, keys, nseg, lanes)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, equal_nan=True) if g.is_floating_point() else torch.equal(g, w)
    assert (rows[:, nseg:] == -5).all() and P8.dense_agg.launches == launches


def test_chip_smokes_replay_holds_every_ranks_p8_call():
    """chip_smoke.MeshModeSpy and hold_mesh_modes on SEG_REVENUE over two
    CPU ranks (what main.mpp_mesh does on the card): every rank's P8 call is
    caught with the packed rows it writes into, each replays equal to its
    plain version, and the spied run's answer equals an unspied one."""
    import chip_smoke
    from tidb_tpu_torch.executor import mpp_gather
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.parallel.mesh import make_mesh
    from tidb_tpu_torch.parallel.mpp import MPPEngine

    li, orders, cust = tpch.generated_columns(20_000, 42)
    tables = {"lineitem": li, "orders": orders, "customer": cust}
    mesh = make_mesh(2, "cpu")
    try:
        def answer():
            plan, port = tpch.seg_revenue_mpp_plan(), MPPEngine("cpu")
            return port.execute(plan, mpp_gather.scan_datas(plan, tables, port), {}, mesh=mesh)[0]

        with chip_smoke.MeshModeSpy() as spy:
            got = answer()
        want = answer()
    finally:
        mesh.close()
    assert chip_smoke.chunks_equal(got, want) is None and want.num_rows > 0
    calls = spy.calls["dense_agg"]
    assert len(calls) == 2 and not spy.calls["seg_reduce"] and not spy.calls["rowpos_agg"]
    for (mask, keys, nseg, lanes), kw, out in calls:
        assert out is None and kw["rows"].shape == (len(lanes), kw["rows"].shape[1]) and kw["rows"].shape[1] >= nseg
    assert chip_smoke.hold_mesh_modes(spy.calls) == {"seg_reduce": 0.0, "rowpos_agg": 0.0, "dense_agg": 0.0}


def test_sources_and_host_share_the_key_flag():
    """The int32-wrap key form is a launch's (a template argument of K4's
    kernel, so its other callers' kernels compile without it), not a word
    of the table; P8 asks for it."""
    src = (CSRC / "seg_agg.cu").read_text()
    assert "template <int MODE, bool WRAP32>" in src and "if constexpr (WRAP32)" in src and "KEY_WRAP32" not in src
    assert "int64_t ostride, int wrap32, int shared_out" in src and "ostride < nseg" in src
    params = re.search(r'extern "C" int tt_seg_agg_tasks\(([^)]*)\)', src).group(1).split(",")
    argtypes = re.search(r"tt_seg_agg_tasks\.argtypes = \[([^]]*)\]", Path(SA.__file__).read_text()).group(1)
    assert len(argtypes.split(",")) == len(params)
    assert "wrap32=True" in Path(P8.__file__).read_text()
    assert not (CSRC / "dense_agg.cu").exists()  # P8 launches K4's kernel: no code or emit kernel of its own


def test_k4_tables_of_other_callers_refuse_int32_wrap_keys():
    n = 8
    key = SA.SegKey(torch.zeros(n, dtype=torch.int64), None, 0, 4, wrap32=True)
    lane = SA.SegLane("count")
    out = torch.empty((1, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="int32-wrap"):
        SA.upload_desc([torch.ones(n, dtype=torch.bool)], [[key]], [[lane]], n, out, out)


# --- M1: the staged schedule ---------------------------------------------------------

LANE_BYTES = _constant("q1_local.cu", "LANE_BYTES")  # a stage's room for one int64 lane's window
RV_BYTES = _constant("q1_local.cu", "RV_BYTES")  # and for the valid bytes' window


def test_q1_constants_match_the_source():
    for name in ("NS", "TILE", "STAGES", "PARTS_AT"):
        assert _constant("q1_local.cu", name) == getattr(M1, name), name
    assert M1.NS == 8 and M1.TILE % 16 == 0 and LANE_BYTES % 16 == 0
    assert LANE_BYTES >= M1.TILE * 8 + 16 and RV_BYTES >= M1.TILE + 16  # a tile's rows and one chunk more
    stage = 7 * LANE_BYTES + RV_BYTES
    assert _constant("q1_local.cu", "STAGE_BYTES") == stage and stage % 16 == 0
    smem = _constant("q1_local.cu", "SMEM_BYTES")
    assert M1.STAGES * stage < smem <= 227 * 1024  # one block an SM, its stages most of it
    assert "lib.tt_q1_grid(n, n_sms)" in Path(M1.__file__).read_text()  # the scratch sized by the source's grid
    # the bytes a block keeps in flight beside the one it folds: past Little's law at 3.35 TB/s over 132 SMs
    assert (M1.STAGES - 1) * stage > 3.35e12 / 132 * 0.8e-6


def _grid(n: int, n_sms: int) -> int:
    """csrc/q1_local.cu's tt_q1_grid (the wrapper sizes the scratch with
    it): one block an SM, at most one a tile, at least one."""
    return max(1, min(-(-n // M1.TILE), n_sms))


def _block_tiles(b: int, n: int, n_sms: int) -> list:
    """csrc/q1_local.cu's block b: its tiles in the order it reads them,
    each (stage, parity of the stage's use, first row, end row)."""
    g, tiles = _grid(n, n_sms), -(-n // M1.TILE)
    return [(k % M1.STAGES, (k // M1.STAGES) & 1, t * M1.TILE, min(t * M1.TILE + M1.TILE, n))
            for k, t in enumerate(range(b, tiles, g))]


def _window(addr: int, elem: int, r0: int, r1: int) -> tuple[int, int, int]:
    """csrc/q1_local.cu's bulk copy of rows [r0, r1) of a stream at byte
    address `addr` with `elem`-byte rows (window_start / window_bytes):
    (source address, bytes, where row r0 lands past the copy's start)."""
    lo, hi = addr + r0 * elem, addr + r1 * elem
    a0 = lo & ~15
    return a0, ((hi + 15) & ~15) - a0, lo - a0


def _addresses(start: int) -> tuple[list, int]:
    """Seven int64 lanes viewed from row (start + k) % 16 of 512-byte
    aligned tensors, and the valid bytes from byte `start`."""
    return [(1 << 32) + (k << 24) + 8 * ((start + k) % 16) for k in range(7)], (1 << 40) + start


@pytest.mark.parametrize("start", range(16))
@pytest.mark.parametrize("n_sms,n", [(N_SMS, 0), (N_SMS, 1), (N_SMS, M1.TILE - 1), (N_SMS, M1.TILE),
                                     (N_SMS, M1.TILE + 1), (N_SMS, (N_SMS + 1) * M1.TILE),
                                     (3, 3 * M1.TILE * (M1.STAGES + 2) + 5), (5, 7 * M1.TILE + 1)])
def test_q1_schedule_reads_every_row_once_from_its_own_chunks(n_sms, n, start):
    lanes, rv = _addresses(start)
    g = _grid(n, n_sms)
    assert 1 <= g <= n_sms and (g - 1) * M1.TILE < max(n, 1)  # no block without a tile
    seen = np.zeros(n, dtype=np.int64)
    for b in range(g):
        tiles = _block_tiles(b, n, n_sms)
        for k, (stage, parity, r0, r1) in enumerate(tiles):
            assert (stage, parity) == (k % M1.STAGES, (k // M1.STAGES) & 1)
            assert r0 == (b + k * g) * M1.TILE and 0 < r1 - r0 <= M1.TILE
            seen[r0:r1] += 1
            for addr, elem, room in [(a, 8, LANE_BYTES) for a in lanes] + [(rv, 1, RV_BYTES)]:
                a0, size, off = _window(addr, elem, r0, r1)
                assert a0 % 16 == 0 and size % 16 == 0 and 0 < size <= room
                assert off == addr % 16 and off + (r1 - r0) * elem <= size  # every row inside the copy
                # inside the 16-byte chunks that hold the stream's own rows
                assert a0 >= (addr & ~15) and a0 + size <= ((addr + n * elem + 15) & ~15)
                assert a0 + size - 16 < addr + r1 * elem and a0 + 16 > addr + r0 * elem
    assert (seen == 1).all()


def test_q1_edge_shapes_reach_every_template_offset_and_sweep():
    shapes = q1_edge_shapes(N_SMS)
    assert {s for n, nseg, s in shapes if n > M1.TILE} == set(range(16))
    assert {nseg for _, nseg, _ in shapes} == set(range(1, M1.NS + 2))
    ns = {n for n, _, _ in shapes}
    sweep = N_SMS * M1.TILE
    assert {0, 1, M1.TILE - 1, M1.TILE, M1.TILE + 1} <= ns
    assert any(n > sweep for n in ns) and any(n > M1.STAGES * sweep for n in ns)


@pytest.mark.parametrize("start", [0, 3, 8, 15])
def test_q1_local_plain_version_on_shard_views(start):
    """The plain version on row views at any offset (what the card's cases
    hold the kernel to) against a numpy recompute."""
    n = 2 * M1.TILE + 3
    lanes, cutoff = q1_battery(np.random.default_rng(start), n + 16, 8, "overflow")
    views = [torch.from_numpy(a)[(start + k) % 16:][:n] for k, a in enumerate(lanes[:7])]
    views.append(torch.from_numpy(lanes[7])[start:][:n])
    got = M1.q1_local(8, cutoff, *views)
    qty, price, disc, tax, rf, ls, ship, rv = (v.numpy() for v in views)
    mask = rv & (ship <= cutoff)
    code = rf * 2 + ls
    want = np.zeros((6, 8), dtype=np.uint64)
    with np.errstate(over="ignore"):
        dp = price.astype(np.uint64) * (100 - disc).astype(np.uint64)
        vals = [np.ones(n, np.uint64), qty.astype(np.uint64), price.astype(np.uint64), dp,
                dp * (100 + tax).astype(np.uint64), disc.astype(np.uint64)]
        for j, x in enumerate(vals):
            np.add.at(want[j], code[mask & (code >= 0) & (code < 8)], x[mask & (code >= 0) & (code < 8)])
    assert np.array_equal(got.numpy(), want.view(np.int64)) and M1.q1_local.launches == 0


# --- the wrappers and the scripts ---------------------------------------------------

@pytest.mark.parametrize("module", ["dense_agg", "q1_local", "topn_multi", "pack_flat", "lut_join"])
def test_wrappers_take_the_cached_sm_count(module):
    src = (CSRC.parent / "kernels" / f"{module}.py").read_text()
    assert "get_device_properties" not in src and "sm_count(" in src


@pytest.mark.parametrize("script,args", [("mpp_profile.py", ["--only", "p8"]), ("mpp_profile.py", ["--only", "m1"]),
                                         ("mesh_stress.py", ["--query", "seg_revenue", "--iters", "1"]),
                                         ("sort_profile.py", ["--only", "k7"]),
                                         ("sort_profile.py", ["--only", "k68", "--turns", "3", "--reads", "3"])])
def test_profile_modes_without_a_card_exit_non_zero(script, args):
    out = subprocess.run([sys.executable, str(ROOT / script), *args], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
