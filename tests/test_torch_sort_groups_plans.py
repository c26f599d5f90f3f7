"""Host-side plans of K9 (csrc/sort_groups.cu) and P6 (csrc/rowpos_agg.cu)
as redesigned for the H100, modelled in numpy and held to the reference:

  * K9's permutation in its split form — the masked-in rows sorted by
    their operands, then the masked rows sorted by theirs — is the
    reference's lex_sort_perm over (masked flag, NULL flag, value) (M = 0,
    M = N, one row, NULL keys, uint64 keys, float keys with NaN, ±0.0 and
    subnormals);
  * the solo call's plan — the compaction's kept operands and OR/AND,
    K8's plan over only those rows (one word: its sorted keys compared;
    more: each varying operand compared), the sweep tile by tile with the
    look-back's count of group starts, and the finish after the n_groups
    read — against the reference's kernel steps (tpu_engine.py:1351-1400,
    run under jax.jit at a given capacity, a cap below n_groups included);
  * the task mode's sweep over K8's task-leading order with each task's
    masked-in count, against sort_groups_tasks_ref;
  * P6's parameter block, K4's and K6's tables in the one upload, and the
    lanes the score and emit passes read through their strides;
  * the constants and entry points the sources and the wrappers share.

The kernels run only on the card (chip_smoke.py holds them to the plain
versions there); these tests need no card.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tidb_tpu.copr import tpu_engine as ref_engine
from tidb_tpu.jaxenv import jax, jnp  # the reference's JAX, int64 on
from tidb_tpu_torch.expr.xp_torch import U64
from tidb_tpu_torch.kernels import SortOp, lex_sort_perm_ref, red
from tidb_tpu_torch.kernels.grouped import sort_groups_tasks_ref
from tidb_tpu_torch.kernels.lex_sort import plan_words

# the modules (the package re-exports their wrappers under the same names)
K9, P6, SA = (importlib.import_module(f"tidb_tpu_torch.kernels.{m}") for m in ("sort_groups", "rowpos_agg", "seg_agg"))

CSRC = Path(K9.__file__).resolve().parent.parent / "csrc"
I64_MIN = -(1 << 63)
DBL_MIN = np.finfo(np.float64).tiny


def _constant(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", (CSRC / src).read_text())
    assert m, (src, name)
    expr = m.group(1)
    for other in re.findall(r"[A-Z_]+", expr):
        expr = expr.replace(other, str(_constant(src, other)))
    return int(eval(expr))  # noqa: S307 — an integer expression of the source's own constants


TILE = _constant("compact.cuh", "BLOCK") * _constant("compact.cuh", "ITEMS")  # the sweep's positions a tile


def test_sources_and_wrappers_share_their_constants():
    for src, name, want in (("sort_groups.cu", "KeyRow", K9.KEY_FIELDS), ("rowpos_agg.cu", "RpBlock", P6.BLOCK_FIELDS)):
        struct = re.search(rf"struct {name} \{{(.*?)\}};", (CSRC / src).read_text(), re.S).group(1)
        fields = [f for line in struct.splitlines() for f in re.findall(r"\**(\w+)(?=[,;])", line.split("//")[0])]
        assert tuple(fields) == want, name
    for mod, src, pat in ((K9, "sort_groups.cu", r'"(tt_sg_\w+)"'), (P6, "rowpos_agg.cu", r'"(tt_rp_\w+)"')):
        text = (CSRC / src).read_text()
        names = set(re.findall(pat, Path(mod.__file__).read_text())) | set(re.findall(r"lib\.(tt_\w+)\b",
                                                                                      Path(mod.__file__).read_text()))
        assert names
        for fn in names:
            assert f"int {fn}(" in text or f"int64_t {fn}(" in text, fn


# --------------------------------------------------------------- inputs


CASES = ("m0", "mN", "one_row", "one_kept", "nulls", "uint64", "floats", "multi", "wide", "constant", "many_keys")


def _spec(case: str, rng, n: int):
    """(mask, [(numpy data, valid)]) of a K9 case."""
    mask = rng.random(n) < 0.7
    v = rng.random(n) < 0.85
    if case == "m0":
        return np.zeros(n, bool), [(rng.integers(-5, 5, n), v)]
    if case == "mN":
        return np.ones(n, bool), [(np.sort(rng.integers(1, n // 3 + 2, n)), np.ones(n, bool))]
    if case == "one_row":
        return np.ones(1, bool), [(np.array([7]), np.array([False]))]
    if case == "one_kept":
        m = np.zeros(n, bool)
        m[rng.integers(0, n)] = True
        return m, [(rng.integers(-5, 5, n), v), (rng.standard_normal(n), v)]
    if case == "nulls":
        return mask, [(rng.integers(-20, 20, n), rng.random(n) < 0.5)]
    if case == "uint64":
        return mask, [(rng.integers(0, 5, n).astype(np.uint64) << np.uint64(61), np.ones(n, bool))]
    if case == "floats":
        specials = np.array([-0.0, 0.0, 1.5, -2.5, np.nan, -np.nan, np.inf, 5e-324, -1e-310, DBL_MIN])
        return mask, [(rng.choice(specials, n), v)]
    if case == "multi":
        return mask, [(rng.integers(0, 6, n).astype(np.int32), v), (rng.integers(-3, 3, n), rng.random(n) < 0.9)]
    if case == "wide":  # more than one K8 word: the sweep compares operands
        return mask, [(rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64) >> rng.integers(0, 62, n), v),
                      (rng.integers(0, 3, n), None)]
    if case == "constant":  # no operand varies over the kept rows: K8 has no word
        return mask, [(np.full(n, 9), None)]
    if case == "many_keys":  # 34 keys of every kind, a few NULL-able, few distinct tuples
        base = rng.integers(0, 8, n)
        keys = []
        for j in range(34):
            d = (base * (j + 1)) % (j + 2)
            d = d.astype(np.int32) if j % 3 == 0 else d - 0.5 if j % 3 == 1 else d
            keys.append((d, v if j in (5, 20) else None))
        return mask, keys
    raise KeyError(case)


def _port_keys(keys):
    out = []
    for d, v in keys:
        x = U64(torch.from_numpy(d.view(np.int64))) if d.dtype == np.uint64 else torch.from_numpy(d)
        out.append((x, None if v is None else torch.from_numpy(v)))
    return out


def _ref_kernel(mask: np.ndarray, keys, gcap: int):
    """The reference's kernel steps (tpu_engine.py:1357-1397) under jax.jit,
    up to the segment reductions: (perm, n_groups, seg, kval [nk, gcap],
    kvalid [nk, gcap])."""
    nk = len(keys)

    def kernel(mask, *lanes):
        n = mask.shape[0]
        ops = [(~mask).astype(jnp.int32)]
        for j in range(nk):
            d, vf = lanes[2 * j], lanes[2 * j + 1]
            ops.append((~vf).astype(jnp.int32))
            dr = d
            if jnp.issubdtype(dr.dtype, jnp.floating):
                dr = jnp.where(dr == 0.0, 0.0, dr.astype(jnp.float64))
                dr = jax.lax.bitcast_convert_type(dr, jnp.int64)
            elif dr.dtype == jnp.uint64:
                dr = jax.lax.bitcast_convert_type(dr, jnp.int64)
            else:
                dr = dr.astype(jnp.int64)
            ops.append(jnp.where(vf, dr, 0))
        perm = ref_engine.lex_sort_perm(ops)
        res = [o[perm] for o in ops]
        s_mask = res[0] == 0
        s_keys = res[1:]
        diff = jnp.zeros(n, dtype=bool).at[0].set(True)
        one = jnp.ones(1, dtype=bool)
        for k in s_keys:
            diff = diff | jnp.concatenate([one, k[1:] != k[:-1]])
        new = diff & s_mask
        seg0 = jnp.cumsum(new.astype(jnp.int32)) - 1
        n_groups = jnp.maximum(seg0[-1] + 1, 0)
        seg = jnp.where(s_mask, jnp.minimum(seg0, gcap), gcap)
        kv, kd = [], []
        for j in range(nk):
            kv.append(ref_engine._seg_max(jnp.where(s_mask, s_keys[2 * j + 1], I64_MIN), seg, gcap, I64_MIN))
            kd.append(ref_engine._seg_max(jnp.where(s_mask, 1 - s_keys[2 * j].astype(jnp.int64), -1), seg, gcap, -1))
        # seg in row order, as K9 hands it to K4
        return perm, n_groups, jnp.zeros(n, jnp.int32).at[perm].set(seg.astype(jnp.int32)), kv, kd

    lanes = []
    for d, v in keys:
        lanes += [jnp.asarray(d), jnp.asarray(np.ones(len(d), bool) if v is None else v)]
    perm, ng, seg, kv, kd = jax.jit(kernel)(jnp.asarray(mask), *lanes)
    return np.asarray(perm), int(ng), np.asarray(seg), np.stack([np.asarray(x) for x in kv]), \
        np.stack([np.asarray(x) for x in kd])


# --------------------------------------------------------------- the split permutation


@pytest.mark.parametrize("case", CASES)
def test_split_permutation_is_the_reference_sort(case):
    """kept rows sorted, then masked rows sorted: the reference's one sort
    by (flag, keys)."""
    mask, keys = _spec(case, np.random.default_rng(len(case)), 3000)
    ops = K9.group_ops_ref(torch.from_numpy(mask), _port_keys(keys))
    got = K9.split_perm_ref(ops).numpy()
    assert got.tolist() == lex_sort_perm_ref(ops).numpy().tolist()
    perm, *_ = _ref_kernel(mask, keys, 8)
    assert got.tolist() == perm.tolist()


# --------------------------------------------------------------- the solo call's plan


def _k8_key(x: np.ndarray, kind: str) -> np.ndarray:
    """K8's order-preserving unsigned key of an int32 / int64 operand."""
    if kind == "i32":
        return (x.astype(np.int64) ^ -(1 << 31)).view(np.uint64) & np.uint64(0xFFFFFFFF)
    return (x.astype(np.int64) ^ I64_MIN).view(np.uint64)


def _orand(u: np.ndarray):
    o = np.bitwise_or.reduce(u) if len(u) else np.uint64(0)
    a = np.bitwise_and.reduce(u) if len(u) else ~np.uint64(0)
    return int(o), int(a)


def _pack_word(ops, words):
    """The one word's keys (kernels/lex_sort.field_table's fields)."""
    (fields, _), = words
    key = np.zeros(len(ops[0][0]), dtype=np.uint64)
    for k, src, width, dst in fields:
        u = _k8_key(*ops[k]) >> np.uint64(src)
        if width < 64:
            u &= np.uint64((1 << width) - 1)
        key |= u << np.uint64(dst)
    return key


def model_sweep(npos, width, mcount, same_as_prev, first_of):
    """csrc sweep_kernel tile by tile: positions in tiles of TILE; a
    masked-in position starts a group at its task's first position or
    where it differs from the one before (`same_as_prev(p)`), the tile's
    starts placed after the count the look-back hands on → (id per
    position or -1, first[id] = first_of(p), ends[task])."""
    ids = np.full(npos, -1, dtype=np.int64)
    first, ends = [], np.zeros(max(npos // width, 1), dtype=np.int64)
    carry = 0  # the look-back's exclusive count of starts before the tile
    for t0 in range(0, npos, TILE):
        pos = np.arange(t0, min(t0 + TILE, npos))
        task, lpos = pos // width, pos % width
        inn = lpos < np.asarray(mcount)[task]
        start = inn & ((lpos == 0) | ~np.array([same_as_prev(p) if i and lp else True
                                                 for p, i, lp in zip(pos, inn, lpos)], dtype=bool))
        before = carry + np.concatenate([[0], np.cumsum(start)[:-1]])
        ids[pos[inn]] = np.where(start, before, before - 1)[inn]
        for p in pos[start]:
            first.append(first_of(p))
        last = lpos == width - 1
        ends[task[last]] = (before + start)[last]
        carry += int(start.sum())
    return ids, np.array(first, dtype=np.int64), ends


def model_solo(mask: np.ndarray, keys, cap_of):
    """K9's solo call in numpy: → (perm, n_groups, cap, seg, kval, kvalid)."""
    n = len(mask)
    crow, tail = np.nonzero(mask)[0], np.nonzero(~mask)[0]
    m = len(crow)
    ops, kinds = [], []
    for d, v in keys:
        vv = np.ones(n, bool) if v is None else v
        if d.dtype == np.float64:
            bits = np.where(np.abs(d) < DBL_MIN, 0.0, d).view(np.int64)
        else:
            bits = d.view(np.int64) if d.dtype == np.uint64 else d.astype(np.int64)
        val = np.where(vv, bits, 0)
        if v is not None:
            ops.append(((~vv).astype(np.int32), "i32"))
        ops.append((val, "i64"))
        kinds.append((None if v is None else (~vv).astype(np.int64), val))
    kept = [(x[crow], kind) for x, kind in ops]
    orand = np.array([w for x, kind in kept for w in _orand(_k8_key(x, kind))], dtype=np.uint64)
    perm_m = np.arange(0)
    ng = 0
    seg = np.full(n, -7, dtype=np.int64)
    first = np.zeros(0, dtype=np.int64)
    if m:
        tops = [SortOp(torch.from_numpy(x), kind) for x, kind in kept]
        perm_m = lex_sort_perm_ref(tops).numpy().astype(np.int64)  # K8 over the kept rows alone
        words = plan_words(orand)
        if len(words) == 1:  # K8 hands back its sorted word: neighbours compared
            sw = _pack_word(kept, words)[perm_m]
            same = lambda p: sw[p] == sw[p - 1]  # noqa: E731
        else:  # each varying operand gathered at both positions
            vary = [x for (x, _), o, a in zip(kept, orand[0::2], orand[1::2]) if o != a]
            same = lambda p: all(x[perm_m[p]] == x[perm_m[p - 1]] for x in vary)  # noqa: E731
        ids, first, ends = model_sweep(m, m, [m], same, lambda p: perm_m[p])
        seg[crow[perm_m]] = ids
        ng = int(ends[0])
    cap = int(cap_of(ng))
    live = min(ng, cap)
    kval = np.full((len(keys), cap), I64_MIN, dtype=np.int64)
    kvalid = np.full((len(keys), cap), -1, dtype=np.int64)
    for j, (nul, val) in enumerate(kinds):
        o = crow[first[:live]]
        kval[j, :live] = val[o]
        kvalid[j, :live] = 1 if nul is None else 1 - nul[o]
    seg[tail] = cap
    seg = np.minimum(seg, cap)
    tail_ops = [SortOp(torch.from_numpy(x[tail]), kind) for x, kind in ops]
    perm_t = lex_sort_perm_ref(tail_ops).numpy() if len(tail) else np.arange(0)
    return np.concatenate([crow[perm_m], tail[perm_t]]), ng, cap, seg, kval, kvalid, len(plan_words(orand)) if m else 0


@pytest.mark.parametrize("cap", [None, 3], ids=["fits", "cap_below"])
@pytest.mark.parametrize("n", [1, 2047, 5000])
@pytest.mark.parametrize("case", CASES)
def test_solo_plan_equals_the_reference_kernel(case, n, cap):
    """compaction → K8 over M rows → sweep → finish, against the
    reference's kernel at the capacity the call chose (a cap below
    n_groups: the reference's gcap, which the escalation raises)."""
    rng = np.random.default_rng(n + len(case))
    mask, keys = _spec(case, rng, n)
    n = len(mask)
    seen = []
    cap_of = lambda ng: seen.append(ng) or (cap if cap is not None else max(ng, 1))  # noqa: E731
    perm, ng, gcap, seg, kval, kvalid, _ = model_solo(mask, keys, cap_of)
    rperm, rng_, rseg, rkval, rkvalid = _ref_kernel(mask, keys, gcap)
    assert seen == [ng] and ng == rng_
    assert perm.tolist() == rperm.tolist()
    assert seg.tolist() == rseg.tolist()
    assert kval.tolist() == rkval.tolist() and kvalid.tolist() == rkvalid.tolist()
    g = K9.sort_groups_ref(torch.from_numpy(mask), _port_keys(keys), lambda x: gcap)
    assert g.n_groups == ng and g.seg.numpy().tolist() == seg.tolist()
    assert g.kval.numpy().tolist() == kval.tolist() and g.kvalid.numpy().tolist() == kvalid.tolist()


def test_the_plans_cover_one_word_and_several():
    """The cases reach both sweep forms: K8's one word compared, and each
    varying operand compared where the plan has several words."""
    rng = np.random.default_rng(3)
    words = {case: model_solo(*_spec(case, rng, 5000), lambda ng: ng)[-1] for case in CASES if case != "one_row"}
    assert words["mN"] == 1 and words["uint64"] == 1 and words["nulls"] >= 2 and words["wide"] >= 2
    assert words["constant"] == 0  # a signed key crossing zero varies in all 64 bits: two words with its null
    assert words["m0"] == 0  # no kept row: K8 is not called


def test_key_table_rows_follow_the_source_layout():
    """Every K9 kernel reads its keys through KeyRow rows: the solo call's
    carry the key lanes, the task mode's leave them to its task table."""
    mask, keys = _spec("multi", np.random.default_rng(5), 64)
    _, checked = K9._keys_in(torch.from_numpy(mask), _port_keys(keys))
    nuls = [torch.zeros(64, dtype=torch.int32) for _ in checked]
    vals = [torch.zeros(64, dtype=torch.int64) for _ in checked]
    for lanes in (True, False):
        rows = K9._key_rows(checked, nuls, vals, lanes=lanes)
        assert rows.shape == (2, len(K9.KEY_FIELDS))
        for (op, valid), nul, val, row in zip(checked, nuls, vals, rows):
            got = dict(zip(K9.KEY_FIELDS, row.tolist()))
            assert got["kind"] == K9.KINDS[op.kind] and got["nul"] == nul.data_ptr() and got["val"] == val.data_ptr()
            assert (got["data"], got["valid"]) == ((op.data.data_ptr(), valid.data_ptr()) if lanes else (0, 0))


def test_groups_build_perm_on_first_read():
    calls = []
    g = K9.Groups(lambda: calls.append(1) or torch.arange(3), 1, 1, None, None, None)
    assert not calls
    assert g.perm.tolist() == [0, 1, 2] and g.perm.tolist() == [0, 1, 2] and calls == [1]


# --------------------------------------------------------------- the task mode's plan


@pytest.mark.parametrize("G,w", [(1, 1), (1, 3000), (3, 2047), (4, 2049), (7, 700)])
def test_task_sweep_equals_the_solo_plain_versions(G, w):
    """The task mode's sweep over K8's task-leading order, each task's
    masked-in count from the ops pass, ids on across the tasks, the
    masked positions found through the permutation — against
    sort_groups_tasks_ref; the last task (G > 1) all masked."""
    rng = np.random.default_rng(G * w)
    masks = [rng.random(w) < 0.8 for _ in range(G)]
    if G > 1:
        masks[-1][:] = False
    keys = [[(np.sort(rng.integers(0, w // 4 + 2, w)) * (g + 1), None), (rng.integers(-2, 2, w), rng.random(w) < 0.9)]
            for g in range(G)]
    tm = [torch.from_numpy(m) for m in masks]
    tk = [_port_keys(ks) for ks in keys]
    want = sort_groups_tasks_ref(tm, tk, w)
    # the ops pass: [G, width] operands, K8's task-leading sort of (task, flag, keys)
    per = [K9.group_ops_ref(m, ks) for m, ks in zip(tm, tk)]
    ops = [SortOp(torch.cat([p[q].data for p in per]), o.kind) for q, o in enumerate(per[0])]
    perm = np.concatenate([lex_sort_perm_ref([SortOp(o.data[g * w:(g + 1) * w], o.kind) for o in ops]).numpy()
                           + g * w for g in range(G)])
    assert perm.tolist() == want.perm.numpy().tolist()
    mcount = [int(m.sum()) for m in masks]
    data = [o.data.numpy().astype(np.int64) for o in ops[1:]]
    vary = [x for x in data if (x != x[0]).any()]  # the sweep skips an operand whose OR equals its AND
    ids, first, ends = model_sweep(G * w, w, mcount, lambda p: all(x[perm[p]] == x[perm[p - 1]] for x in vary),
                                   lambda p: perm[p])
    counts = np.diff(np.concatenate([[0], ends])).tolist()
    assert counts == want.counts
    total = int(ends[-1])
    seg = np.full(G * w, total, dtype=np.int64)
    seg[perm[ids >= 0]] = ids[ids >= 0]
    assert seg.reshape(G, w).tolist() == want.seg.numpy().tolist()
    for j in range(len(keys[0])):
        assert data[2 * j + 1][first].tolist() == want.kval[j].numpy().tolist()
        assert (1 - data[2 * j][first]).tolist() == want.kvalid[j].numpy().tolist()


# --------------------------------------------------------------- P6's one upload


def test_rowpos_upload_holds_the_block_and_both_tables():
    """The parameter block, K4's one-task table and K6's task table sit in
    the workspace's head in the order the kernels read them; the arrays
    follow at the offsets compact.workspace gives."""
    n, nl, n_f, space, blk, kk = 1000, 4, 1, 256, 64, 10
    lay = P6.layout(n, nl, n_f, space, blk, kk, 300, 200)
    assert lay.k4_at == len(P6.BLOCK_FIELDS)
    assert lay.k6_at - lay.k4_at == SA.TASK_DESC + SA.LANE_DESC * nl
    assert lay.table_words == lay.k6_at + 3 and lay.sizes[0] == 8 * lay.table_words
    offs, at = [], 0
    for b in lay.sizes:
        offs.append(at)
        at += -(-b // 16) * 2
    base = 1 << 40
    rows = torch.zeros((2 + nl - 1, 16), dtype=torch.int64)
    words = dict(zip(P6.BLOCK_FIELDS, P6.block_words(base, offs, n, 250, 12345, blk, True, False, kk, rows)))
    assert words["seg"] == base + 8 * offs[1] and words["valid"] == base + 8 * offs[4]
    assert words["score"] == base + 8 * offs[5] and words["idx"] == base + 8 * offs[7]
    assert words["gidx"] == base + 8 * offs[9] and words["rows"] == rows.data_ptr() and words["row_stride"] == 16
    assert (words["n"], words["nseg"], words["rid"], words["blk"], words["kk"]) == (n, 250, 12345, blk, kk)
    assert (words["desc"], words["is_float"]) == (1, 0)
    assert lay.sizes[1:] == [4 * n, 8 * (nl - n_f) * space, 8 * n_f * space, blk, 8 * blk, 8 * 300, 4 * 200, kk,
                             8 * kk]


def test_rowpos_lanes_travel_with_their_strides():
    """A mesh block (a column of a stacked matrix here) is read in place:
    its address and stride, no copy."""
    m = torch.arange(40, dtype=torch.int64).reshape(10, 4)
    full = [m[:, 0], m[:, 1], torch.arange(10), m[:, 3]]
    w = P6.lane_words(96, full, 0, 1, full[2:])
    assert w.tolist() == [96, full[0].data_ptr(), 4, full[1].data_ptr(), 4, 2, full[2].data_ptr(), 1,
                          full[3].data_ptr(), 4]


def test_topk_buffers_share_the_select_layout():
    """The select's buffers as topk.select_prepare lays them out, for the
    one-task table P6 uploads (csrc/topk.cu tt_topk_state_len /
    tt_topk_buf_cap: state words, and width / 8 candidates)."""
    src = (CSRC / "topk.cu").read_text()
    assert "extern \"C\" int64_t tt_topk_buf_cap(int64_t width) { return (width + 7) / 8; }" in src
    assert re.search(r"int tt_topk_select_tasks\(const void\* tasks, int G, int is_float", src)


def test_rowpos_plain_version_takes_a_strided_block():
    """The plain version over a collect whose blocks are strided views
    equals it over contiguous copies (the card reads them in place)."""
    from chip_smoke import p6_args, rowpos_battery

    b = rowpos_battery(np.random.default_rng(5), 5000, 4096, "presence")
    args = p6_args(b, "cpu")
    blk = 4096 // 4

    def strided(full, ops):
        mat = torch.stack([red.bits(f) for f in full], 1)[2 * blk:3 * blk]  # rows: each lane a strided column
        return [mat[:, j].view(torch.float64) if f.dtype == torch.float64 else mat[:, j]
                for j, f in enumerate(full)], 2 * blk

    def contiguous(full, ops):
        return [f[2 * blk:3 * blk].contiguous() for f in full], 2 * blk

    got = P6.rowpos_agg_ref(*args, n_dev=4, collect=strided)
    want = P6.rowpos_agg_ref(*args, n_dev=4, collect=contiguous)
    assert torch.equal(got.idx, want.idx) and torch.equal(got.gidx, want.gidx)
    assert torch.equal(got.valid, want.valid)
