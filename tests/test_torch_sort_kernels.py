"""The port's sort-path kernels (K6-K9, K4's segment-lane mode), held to
the reference and to numpy oracles on the CPU.

Inputs are made from a seed with numpy and handed to both sides. The
reference side is the JAX package's own function where it has one
(`lex_sort_perm`, `lax.top_k`, `_seg_sum`/`_seg_min`/`_seg_max`) or its
kernel's formulas written out in jnp; the oracle side is numpy
(`np.lexsort`, a stable argsort, `np.unique`). Permutations, row ids,
group ids and integer partials must be identical; float sums agree within
rtol 1e-9 / atol 1e-6 (summation order differs).

On the CPU each wrapper takes its plain version; chip_smoke.py holds the
CUDA kernels to these plain versions on the card.
"""

import jax
import numpy as np
import pytest
import torch

from tidb_tpu.copr import tpu_engine as ref_engine
from tidb_tpu.jaxenv import jnp

from tidb_tpu_torch.expr.xp_torch import U64
from tidb_tpu_torch.kernels import (SegLane, SortOp, lex_sort_perm, seg_agg, seg_agg_ref, sort_groups,
                                    topk, topn_multi, topn_multi_ops_ref)
from tidb_tpu_torch.kernels.lex_sort import ordered_key, plan_words

RTOL, ATOL = 1e-9, 1e-6
I64 = np.iinfo(np.int64)
SPECIALS = np.array([-np.inf, -1.5, -0.0, 0.0, 1.5, np.inf, np.nan, -np.nan, 5e-324])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(case: str, n: int, rng):
    """(numpy arrays, kinds), most significant first."""
    if case == "flags_and_ints":
        return [(rng.random(n) < 0.3).astype(np.int32), rng.integers(-3, 3, n), rng.integers(0, 4, n)], \
            ["i32", "i64", "i64"]
    if case == "float_specials":
        return [rng.integers(0, 2, n).astype(np.int32), rng.choice(SPECIALS, n)], ["i32", "f64"]
    if case == "uint64":
        u = rng.integers(0, 4, n).astype(np.uint64) << np.uint64(62) | rng.integers(0, 3, n).astype(np.uint64)
        return [u, rng.integers(-2, 2, n).astype(np.int32)], ["u64", "i32"]
    if case == "int64_limits":
        return [rng.choice(np.array([I64.min, I64.min + 1, -1, 0, 1, I64.max - 1, I64.max]), n)], ["i64"]
    if case == "wider_than_a_word":
        full = lambda: rng.integers(I64.min, I64.max, n, dtype=np.int64)  # noqa: E731
        return [rng.integers(0, 3, n), full(), full()], ["i64", "i64", "i64"]
    if case == "all_equal":
        return [np.full(n, 5, np.int64), np.zeros(n, np.int32)], ["i64", "i32"]
    raise KeyError(case)


def _sort_ops(arrays, kinds):
    ops = []
    for a, k in zip(arrays, kinds):
        ops.append(SortOp(_t(a.view(np.int64) if k == "u64" else a), k))
    return ops


def _np_order_key(a: np.ndarray, kind: str) -> np.ndarray:
    """numpy stand-in of lax.sort's order (floats: -0.0 == +0.0, every NaN
    equal and after +inf), as a float or int lane np.lexsort orders."""
    if kind == "f64":  # subnormals compare equal to zero there (flushed)
        a = np.where(np.abs(a) < np.finfo(np.float64).tiny, 0.0, a)
        return np.where(np.isnan(a), np.inf, a), np.isnan(a)
    return a, None


SORT_CASES = ["flags_and_ints", "float_specials", "uint64", "int64_limits", "wider_than_a_word", "all_equal"]


@pytest.mark.parametrize("n", [1, 7, 3000])
@pytest.mark.parametrize("case", SORT_CASES)
def test_lex_sort_matches_the_reference_and_np_lexsort(case, n):
    rng = np.random.default_rng(SORT_CASES.index(case) * 100 + n)
    arrays, kinds = _operands(case, n, rng)
    got = lex_sort_perm(_sort_ops(arrays, kinds))
    assert got.dtype == torch.int32
    ref = np.asarray(ref_engine.lex_sort_perm([jnp.asarray(a) for a in arrays]))
    assert got.numpy().tolist() == ref.tolist()
    lanes = []
    for a, k in zip(arrays, kinds):
        key, nan = _np_order_key(a, k)
        lanes.append(key)
        if nan is not None:
            lanes.append(nan)  # NaN after +inf: the flag is the more significant lane
    assert got.numpy().tolist() == np.lexsort(lanes[::-1]).tolist()


def _emulate_lsd(ops, words) -> np.ndarray:
    """numpy model of the kernels' radix plan: per word, least significant
    first, the composite key of its fields sorted stably."""
    u = [(ordered_key(op).numpy().view(np.uint64) ^ np.uint64(1 << 63)) for op in ops]
    perm = np.arange(len(u[0]))
    for fields, bits in words:
        key = np.zeros(len(perm), dtype=np.uint64)
        for k, src, width, dst in fields:
            f = (u[k][perm] >> np.uint64(src)) & np.uint64((1 << width) - 1 if width < 64 else (1 << 64) - 1)
            key |= f << np.uint64(dst)
        perm = perm[np.argsort(key, kind="stable")]
    return perm


@pytest.mark.parametrize("case", SORT_CASES)
def test_radix_plan_packs_varying_bits_into_words(case):
    rng = np.random.default_rng(5)
    arrays, kinds = _operands(case, 2000, rng)
    ops = _sort_ops(arrays, kinds)
    us = [ordered_key(op).numpy().view(np.uint64) ^ np.uint64(1 << 63) for op in ops]
    orand = np.array([x for u in us for x in (np.bitwise_or.reduce(u), np.bitwise_and.reduce(u))], dtype=np.uint64)
    words = plan_words(orand)
    for fields, bits in words:
        assert 0 < bits <= 64 and bits == sum(w for _, _, w, _ in fields)
    assert sum(bits for _, bits in words) == sum(
        (int(o) ^ int(a)).bit_length() - ((int(o) ^ int(a)) & -(int(o) ^ int(a))).bit_length() + 1
        for o, a in zip(orand[::2], orand[1::2]) if int(o) != int(a))
    assert _emulate_lsd(ops, words).tolist() == lex_sort_perm(ops).numpy().tolist()


def test_radix_plan_skips_constant_operands_and_packs_flags():
    # a constant operand, a 1-bit flag and a 3-bit value share one word
    orand = np.array([0b1, 0b0, 5, 5, 0b1110, 0b0010], dtype=np.uint64)
    assert plan_words(orand) == [([(2, 2, 2, 0), (0, 0, 1, 2)], 3)]
    assert plan_words(orand)[0].key_bytes == 4 and plan_words(orand)[0].passes == 1
    assert plan_words(np.array([7, 7], dtype=np.uint64)) == []


def _orand(ops) -> np.ndarray:
    us = [ordered_key(op).numpy().view(np.uint64) ^ np.uint64(1 << 63) for op in ops]
    return np.array([x for u in us for x in (np.bitwise_or.reduce(u), np.bitwise_and.reduce(u))], dtype=np.uint64)


def _emulate_passes(ops, words, width: int) -> np.ndarray:
    """numpy model of csrc/lex_sort.cu's passes: per word, the keys built
    through the permutation so far (4-byte when the word fits 32 bits; the
    task field is row // width), then one stable 8-bit pass per digit, least
    significant first."""
    u = [(ordered_key(op).numpy().view(np.uint64) ^ np.uint64(1 << 63)) for op in ops]
    perm = np.arange(len(u[0]))
    for word in words:
        key = np.zeros(len(perm), dtype=np.uint64)
        for k, src, w, dst in word.fields:
            f = (perm // width).astype(np.uint64) if k < 0 else u[k][perm] >> np.uint64(src)
            key |= (f & np.uint64((1 << w) - 1 if w < 64 else (1 << 64) - 1)) << np.uint64(dst)
        if word.key_bytes == 4:
            assert (key >> np.uint64(32)).max() == 0, "a 4-byte word holds bits past 32"
            key = key.astype(np.uint32)
        for p in range(word.passes):
            order = np.argsort((key >> key.dtype.type(8 * p)) & 0xFF, kind="stable")
            perm, key = perm[order], key[order]
    return perm


def _np_lexsort(arrays, kinds) -> np.ndarray:
    lanes = []
    for a, k in zip(arrays, kinds):
        key, nan = _np_order_key(a, k)
        lanes.append(key)
        if nan is not None:
            lanes.append(nan)
    return np.lexsort(lanes[::-1])


WORD_CASES = {  # (numpy arrays, kinds), most significant first: a 4-byte word, an 8-byte one, two words
    "word32": lambda n, rng: ([rng.integers(0, 1 << 10, n).astype(np.int32), rng.integers(0, 1 << 16, n)],
                              ["i32", "i64"]),
    "word64": lambda n, rng: ([rng.integers(0, 1 << 30, n), rng.integers(-(1 << 17), 1 << 17, n)], ["i64", "i64"]),
    "ties": lambda n, rng: ([rng.integers(0, 4, n)], ["i64"]),
}


@pytest.mark.parametrize("G", [1, 7, 64])
@pytest.mark.parametrize("case", SORT_CASES + list(WORD_CASES))
def test_pass_plan_with_task_field_matches_np_lexsort_per_task(case, G):
    """The plan K8's task-leading mode runs (the task in the top bits of the
    last word, 4-byte keys for a word of at most 32 bits), emulated pass by
    pass, sorts each task's rows as np.lexsort does."""
    rng = np.random.default_rng(G * 31 + len(case))
    w = 97
    parts = [WORD_CASES[case](w, rng) if case in WORD_CASES else _operands(case, w, rng) for _ in range(G)]
    kinds = parts[0][1]
    arrays = [np.concatenate([p[0][j] for p in parts]) for j in range(len(kinds))]
    ops = _sort_ops(arrays, kinds)
    words = plan_words(_orand(ops), (G - 1).bit_length())
    if not words:  # every operand constant: row order is the sorted order
        assert case == "all_equal"
        return
    task = [f for wd in words for f in wd.fields if f[0] < 0]
    assert len(task) == (1 if G > 1 else 0)
    if task:  # the most significant field of the last word, at its used top
        assert task[0] == words[-1].fields[-1] and task[0][3] + task[0][2] == words[-1].bits
    for wd in words:
        assert wd.key_bytes == (4 if wd.bits <= 32 else 8) and wd.passes == (wd.bits + 7) // 8
    got = _emulate_passes(ops, words, w)
    for g in range(G):
        want = _np_lexsort([a[g * w:(g + 1) * w] for a in arrays], kinds) + g * w
        assert got[g * w:(g + 1) * w].tolist() == want.tolist(), g


def test_word_widths_follow_the_varying_bits():
    """32 varying bits → one 4-byte word; 33 → one 8-byte word; the task
    field counts toward the width."""
    def orand(*widths):
        return np.array([x for wd in widths for x in ((1 << wd) - 1, 0)], dtype=np.uint64)
    assert [(w.bits, w.key_bytes) for w in plan_words(orand(20, 12))] == [(32, 4)]
    assert [(w.bits, w.key_bytes) for w in plan_words(orand(20, 13))] == [(33, 8)]
    assert [(w.bits, w.key_bytes) for w in plan_words(orand(26), 6)] == [(32, 4)]
    assert [(w.bits, w.key_bytes) for w in plan_words(orand(26), 7)] == [(33, 8)]
    assert [(w.bits, w.key_bytes) for w in plan_words(orand(40, 30))] == [(30, 4), (40, 8)]


def test_field_table_is_one_upload_of_every_words_fields():
    """csrc/lex_sort.cu's FieldDesc rows (address or 0 for the task field,
    kind | src << 32, width | dst << 32) of every word, in plan order, with
    each word's first row: one table, one pinned copy."""
    from tidb_tpu_torch.kernels.lex_sort import KINDS, TASK_KIND, Word, field_table, op_table

    rng = np.random.default_rng(2)
    arrays, kinds = _operands("wider_than_a_word", 50, rng)
    ops = _sort_ops(arrays, kinds)
    words = plan_words(_orand(ops), 3)
    assert len(words) >= 2 and all(isinstance(w, Word) for w in words)
    table, offs = field_table(ops, words)
    assert table.dtype == np.int64 and table.shape == (sum(len(w.fields) for w in words), 3)
    assert offs == np.cumsum([0] + [len(w.fields) for w in words[:-1]]).tolist()
    for w, off in zip(words, offs):
        for j, (k, src, width, dst) in enumerate(w.fields):
            row = table[off + j]
            if k < 0:
                assert row.tolist() == [0, TASK_KIND, width | (dst << 32)]
            else:
                assert row.tolist() == [ops[k].data.data_ptr(), KINDS[ops[k].kind] | (src << 32), width | (dst << 32)]
    assert op_table(ops).tolist() == [[op.data.data_ptr(), KINDS[op.kind]] for op in ops]


def test_sort_profile_instruments_every_phase_of_the_pass():
    """sort_profile.py's clock copy of csrc/lex_sort.cu: every phase mark
    lands once in pass_kernel, in order, and the read-out entry exists."""
    import os
    import re
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import sort_profile

    from tidb_tpu_torch.kernels.build import CSRC

    src = (CSRC / "lex_sort.cu").read_text()
    out = sort_profile.instrumented(src)
    body = out[out.index("pass_kernel(const KeyT*"):out.index("int grid_for(")]
    marks = [int(m) for m in re.findall(r"long long clk(\d) = clock64\(\);", body)]
    assert marks == list(range(7)) and len(sort_profile.PHASES) == 6
    assert 'extern "C" int tt_clk(' in out and src.count("clock64") == 0


# --- K6 topk ---------------------------------------------------------------


def _ref_topk(d, v, m, desc, k):
    """The reference kernel's key (tpu_engine.py:1766-1778) and lax.top_k."""
    d, v, m = jnp.asarray(d), jnp.asarray(v), jnp.asarray(m)
    if jnp.issubdtype(d.dtype, jnp.floating):
        lo, hi = -jnp.inf, jnp.inf
    else:
        d = d.astype(jnp.int64)
        lo, hi = I64.min, I64.max - 1
    key = jnp.where(m & v, d, lo) if desc else jnp.where(m, jnp.where(v, -d, hi), lo)
    _, idx = jax.lax.top_k(key, k)
    return np.asarray(idx), np.asarray(m[idx])


def _topk_data(case: str, n: int, rng):
    if case == "price":
        return rng.integers(90000, 10500000, n)
    if case == "duplicates":
        return rng.integers(0, 3, n)
    if case == "int64_limits":
        return rng.choice(np.array([I64.min, I64.min + 1, -1, 0, 1, I64.max - 1, I64.max]), n)
    if case == "float_specials":
        return rng.choice(SPECIALS, n)
    if case == "uint64_bits":  # BIGINT UNSIGNED: the reference's astype(int64) keeps the bits
        return (rng.integers(0, 1 << 63, n).astype(np.uint64) << np.uint64(1)).view(np.int64)
    raise KeyError(case)


@pytest.mark.parametrize("k", [1, 37, 400])
@pytest.mark.parametrize("desc", [True, False], ids=["desc", "asc"])
@pytest.mark.parametrize("case", ["price", "duplicates", "int64_limits", "float_specials", "uint64_bits"])
def test_topk_matches_lax_top_k(case, desc, k):
    rng = np.random.default_rng(k + 7 * desc)
    n = 400
    d = _topk_data(case, n, rng)
    v = rng.random(n) < 0.8
    m = rng.random(n) < 0.7
    got_idx, got_ok = topk(_t(d), _t(v), _t(m), desc, k)
    want_idx, want_ok = _ref_topk(d, v, m, desc, k)
    assert got_idx.numpy().tolist() == want_idx.tolist()
    assert got_ok.numpy().tolist() == want_ok.tolist()


def test_topk_tie_order_and_signed_zeros_pin_lax_top_k():
    """lax.top_k on the CPU: equal keys keep the lower index first, +0.0
    ranks above -0.0, +NaN above +inf and -NaN below -inf."""
    d = np.array([1, 3, 3, -0.0, 0.0, np.nan, 3, -np.nan, -np.inf])
    ones = np.ones(len(d), bool)
    got, _ = topk(_t(d), None, _t(ones), True, len(d))
    assert got.numpy().tolist() == [5, 1, 2, 6, 0, 4, 3, 8, 7]
    assert got.numpy().tolist() == _ref_topk(d, ones, ones, True, len(d))[0].tolist()
    ties = np.full(9, 4, np.int64)
    assert topk(_t(ties), None, _t(ones), False, 5)[0].numpy().tolist() == [0, 1, 2, 3, 4]


def test_topk_equals_a_stable_numpy_argsort():
    rng = np.random.default_rng(3)
    d = rng.integers(-5, 5, 1000)
    m = rng.random(1000) < 0.5
    idx, ok = topk(_t(d), None, _t(m), True, 1000)
    key = np.where(m, d, I64.min)
    assert idx.numpy().tolist() == np.argsort(-key.astype(np.float64), kind="stable").tolist()
    assert ok.numpy().tolist() == m[idx.numpy()].tolist()


def test_topk_rejects_what_it_does_not_take():
    d, m = _t(np.arange(5)), _t(np.ones(5, bool))
    with pytest.raises(ValueError):
        topk(d, None, m, True, 6)
    idx, ok = topk(d, None, m, True, 0)  # LIMIT 0: lax.top_k gives nothing too
    assert idx.numel() == ok.numel() == 0
    with pytest.raises(TypeError):
        topk(d.to(torch.int32), None, m, True, 2)


def test_topk_orders_its_rows_itself_up_to_the_kernels_cap():
    """The route choice: K6 orders k <= ORDER_CAP rows in the kernel (no K8,
    no host read), above it K8 orders them; the cap is csrc/topk.cu's."""
    import importlib
    import re
    from pathlib import Path

    topk_module = importlib.import_module("tidb_tpu_torch.kernels.topk")  # the package re-exports the wrapper's name

    cap = topk_module.ORDER_CAP
    src = (Path(topk_module.__file__).parent.parent / "csrc" / "topk.cu").read_text()
    assert re.search(r"constexpr int kOrderCap = (\d+);", src).group(1) == str(cap) and cap >= 2048
    assert topk_module.orders_in_kernel(1) and topk_module.orders_in_kernel(cap)
    assert not topk_module.orders_in_kernel(cap + 1)


def _emulate_select(u: np.ndarray, k: int) -> list:
    """numpy model of csrc/topk.cu's select over one task: digits of the
    96-bit key (u, ~row) from the top, constant digits of u skipped, the
    candidates read from every row until they fit a buffer of width / 8,
    those above the threshold output a pass later, the rest at the end,
    then ordered by (u desc, row asc) → row ids."""
    width = len(u)
    dig_of = lambda x, r, d: (x >> (8 * (d - 4))) & 0xFF if d >= 4 else (r >> (8 * d)) & 0xFF  # noqa: E731
    vary = int(np.bitwise_or.reduce(u)) ^ int(np.bitwise_and.reduce(u))
    pre, known, pend, rem, ncand = [0, 0], [0, 0], -1, k, width
    done, bcap, src, out = k == width, (width + 7) // 8, None, []

    def classify(x, row):
        r = ~row & 0xFFFFFFFF
        if (x & known[0]) != (pre[0] & known[0]) or (r & known[1]) != (pre[1] & known[1]):
            return -1
        if pend < 0:
            return 0
        d, c = dig_of(x, r, pend), dig_of(pre[0], pre[1], pend)
        return 1 if d > c else (0 if d == c else -1)

    rdig = (max(width - 1, 0).bit_length() + 7) // 8
    for dig in [d for d in range(11, -1, -1) if d >= 4 or d < rdig]:
        if done or (dig >= 4 and (vary >> (8 * (dig - 4))) & 0xFF == 0):
            continue
        cands = src if src is not None else [(int(x), i) for i, x in enumerate(u)]
        write = src is not None or ncand <= bcap
        hist, kept = [0] * 256, []
        for x, row in cands:
            c = classify(x, row)
            out += [(x, row)] if c == 1 else []
            if c == 0:
                hist[dig_of(x, ~row & 0xFFFFFFFF, dig)] += 1
                kept.append((x, row))
        assert sum(hist) == ncand
        incl = 0
        for dd in range(255, -1, -1):
            excl, incl = incl, incl + hist[dd]
            if excl < rem <= incl:
                break
        pre[dig < 4] |= dd << (8 * (dig - 4 if dig >= 4 else dig))
        if pend >= 0:
            known[pend < 4] |= 0xFF << (8 * (pend - 4 if pend >= 4 else pend))
        pend, rem, ncand = dig, rem - excl, hist[dd]
        done = ncand == rem
        if write:
            assert len(kept) <= bcap
            src = kept
    assert done
    out += [(x, row) for x, row in (src if src is not None else [(int(x), i) for i, x in enumerate(u)])
            if classify(x, row) >= 0]
    assert len(out) == k
    return [row for _, row in sorted(out, key=lambda p: (-p[0], p[1]))]


@pytest.mark.parametrize("k", [1, 10, 100, 257, 1000])
@pytest.mark.parametrize("case", ["price", "duplicates", "int64_limits", "float_specials", "uint64_bits", "tied"])
def test_select_plan_matches_lax_top_k(case, k):
    """csrc/topk.cu's select, emulated in numpy over the kernel's own u
    (the key's order-preserving form), keeps exactly lax.top_k's rows in
    its order: ties past the buffer, every row tied, k = width."""
    from tidb_tpu_torch.kernels.topk import _total_order, sort_key

    rng = np.random.default_rng(k * 13 + len(case))
    n = 1000
    d = np.full(n, 4, np.int64) if case == "tied" else _topk_data(case, n, rng)
    v = rng.random(n) < 0.8
    m = rng.random(n) < 0.7
    for desc in (True, False):
        u = _total_order(sort_key(_t(d), _t(v), _t(m), desc)).numpy().view(np.uint64) ^ np.uint64(1 << 63)
        want_idx, _ = _ref_topk(d, v, m, desc, k)
        assert _emulate_select(u, k) == want_idx.tolist()


# --- K7 topn_multi ---------------------------------------------------------


def _ref_multi_ops(m, keys):
    """The reference kernel's operands (tpu_engine.py:1816-1826)."""
    ops = [(~jnp.asarray(m)).astype(jnp.int32)]
    for d, v, desc in keys:
        d, v = jnp.asarray(d), jnp.asarray(v)
        nullkey = jnp.where(v, 0, 1) if desc else jnp.where(v, 1, 0)
        dd = jnp.where(v, d, jnp.zeros((), d.dtype))
        if desc:
            dd = -dd if jnp.issubdtype(d.dtype, jnp.floating) else ~dd
        ops += [nullkey.astype(jnp.int32), dd]
    return ops


def _ref_topn_multi(m, keys, k):
    """The reference's _lower_topn_multi program body (tpu_engine.py:
    1812-1830): its operands, lex_sort_perm, the first min(k, rows) row ids
    and their mask bits."""
    ops = _ref_multi_ops(m, keys)
    perm = ref_engine.lex_sort_perm(ops)
    rows = min(k, len(m))
    return np.asarray(perm[:rows]), np.asarray(ops[0][perm][:rows] == 0)


def _port_multi_keys(spec):
    return [(U64(_t(d.view(np.int64))) if d.dtype == np.uint64 else _t(d), _t(v), desc) for d, v, desc in spec]


def _np_topn_multi(m, spec, k):
    """numpy oracle: np.lexsort over (masked, per key its NULL flag and its
    value — NaN after +inf, -0.0 == +0.0, subnormals 0 — as lax.sort
    orders them) → the first min(k, n) row ids."""
    cols = [(~m).astype(np.int64)]
    for d, v, desc in spec:
        cols.append(np.where(v, 0, 1) if desc else np.where(v, 1, 0))
        x = np.where(v, d, np.zeros((), d.dtype))
        if desc:
            x = -x if d.dtype.kind == "f" else ~x
        key, nan = _np_order_key(x, "f64" if d.dtype.kind == "f" else "int")
        if nan is not None:
            cols.append(nan.astype(np.int64))
        cols.append(key)
    return np.lexsort(list(reversed(cols)))[:min(k, len(m))]


def _multi_spec(case: str, n: int, rng):
    """(mask, [(data, valid, desc)]): every key kind — int32, int64,
    uint64 with the top bit set, float64 with ±0.0, NaN, ±inf and
    subnormals — with NULLs in every key, in both orders."""
    v = lambda p=0.85: rng.random(n) < p  # noqa: E731
    m = rng.random(n) < 0.8
    u64 = (rng.integers(0, 4, n).astype(np.uint64) << np.uint64(62)) | rng.integers(0, 3, n).astype(np.uint64)
    if case == "every_kind_desc_first":
        spec = [(rng.choice(SPECIALS, n), v(), True), (rng.integers(-3, 3, n).astype(np.int32), v(), False),
                (u64, v(), True), (rng.integers(-2, 2, n), v(), False)]
    elif case == "every_kind_asc_first":
        spec = [(u64, v(), False), (rng.choice(SPECIALS, n), v(), False),
                (rng.choice(np.array([I64.min, -1, 0, 1, I64.max]), n), v(), True),
                (rng.integers(-2, 2, n).astype(np.int32), v(), True)]
    elif case == "price_orderkey_linenumber":  # MULTIKEY_TOPN's keys over a padded tail
        m = np.ones(n, bool)
        m[-n // 10:] = False
        spec = [(rng.integers(90000, 10500000, n), np.ones(n, bool), True),
                (np.sort(rng.integers(1, max(n // 4, 2), n)), np.ones(n, bool), False),
                (rng.integers(1, 8, n), np.ones(n, bool), False)]
    elif case == "all_masked":
        m = np.zeros(n, bool)
        spec = [(rng.integers(0, 5, n), v(), True), (rng.choice(SPECIALS, n), v(), False)]
    elif case == "few_masked_in":
        m = rng.random(n) < 3 / n
        spec = [(rng.integers(0, 5, n), v(0.5), False), (u64, v(), True)]
    elif case == "all_equal":  # every key ties: the row id decides
        m = np.ones(n, bool)
        spec = [(np.full(n, 3, np.int64), np.ones(n, bool), True), (np.full(n, -0.0), np.ones(n, bool), False)]
    elif case == "null_keys":
        spec = [(rng.integers(0, 3, n), v(0.3), False), (rng.choice(SPECIALS, n), v(0.3), True)]
    else:
        raise KeyError(case)
    return m, spec


MULTI_CASES = ["every_kind_desc_first", "every_kind_asc_first", "price_orderkey_linenumber", "all_masked",
               "few_masked_in", "all_equal", "null_keys"]


@pytest.mark.parametrize("k", [1, 7, 50, 600, 605])
@pytest.mark.parametrize("case", MULTI_CASES)
def test_topn_multi_matches_the_reference_and_np_lexsort(case, k):
    """K7 (its plain version here) returns the reference program's first
    rows and mask bits bit for bit — every key kind, NULLs in every key,
    both orders, all rows masked, fewer masked in than k, every key tied,
    k past the rows — and the numpy oracle's rows."""
    rng = np.random.default_rng(MULTI_CASES.index(case) * 31 + k)
    n = 600
    m, spec = _multi_spec(case, n, rng)
    idx, ok = topn_multi(_t(m), _port_multi_keys(spec), k)
    want_idx, want_ok = _ref_topn_multi(m, spec, k)
    assert idx.dtype == torch.int64 and idx.numpy().tolist() == want_idx.tolist()
    assert ok.numpy().tolist() == want_ok.tolist()
    assert idx.numpy().tolist() == _np_topn_multi(m, spec, k).tolist()


def test_topn_multi_operands_and_order_match_the_reference():
    rng = np.random.default_rng(11)
    n = 3000
    m = rng.random(n) < 0.8
    price = rng.integers(0, 50, n)
    codes = rng.integers(0, 4, n).astype(np.int32)
    fl = rng.choice(SPECIALS, n)
    u = rng.integers(0, 4, n).astype(np.uint64) << np.uint64(62)
    vs = [np.ones(n, bool), rng.random(n) < 0.9, rng.random(n) < 0.9, rng.random(n) < 0.9]
    spec = [(price, vs[0], True), (codes, vs[1], False), (fl, vs[2], True), (u, vs[3], False)]
    ref_ops = _ref_multi_ops(m, spec)
    ops = topn_multi_ops_ref(_t(m), _port_multi_keys(spec))
    for got, want in zip(ops, ref_ops):
        w = np.asarray(want)
        g = got.data.numpy()
        assert g.view(np.uint8).tobytes() == (w.view(np.int64) if w.dtype == np.uint64 else w).view(np.uint8).tobytes()
    perm = lex_sort_perm(ops).numpy()
    assert perm.tolist() == np.asarray(ref_engine.lex_sort_perm(ref_ops)).tolist()
    idx, ok = topn_multi(_t(m), _port_multi_keys(spec), n)
    assert idx.numpy().tolist() == perm.tolist() and ok.numpy().tolist() == m[perm].tolist()


def _np_multi_words(m, spec) -> list:
    """The composite words csrc/topn_multi.cu selects over (its note), in
    numpy: word 0 (masked, null_0), then per key its value's K8 key and
    the next key's NULL flag, the row id last — uint64 each."""
    def ordered(x, kind):
        if kind == "f":
            x = np.where(np.abs(x) < np.finfo(np.float64).tiny, 0.0, x)
            b = np.where(np.isnan(x), np.nan, x).view(np.uint64)
            return np.where(b >> np.uint64(63), ~b, b | np.uint64(1 << 63))
        if kind == "u":
            return x.astype(np.uint64)
        if x.dtype == np.int32:
            return (x.view(np.uint32) ^ np.uint32(1 << 31)).astype(np.uint64)
        return x.view(np.uint64) ^ np.uint64(1 << 63)

    words = []
    for j, (d, v, desc) in enumerate(spec):
        null = (~v if desc else v).astype(np.uint64)
        words.append(((~m).astype(np.uint64) << np.uint64(1)) | null if j == 0 else null)
        x = np.where(v, d, np.zeros((), d.dtype))
        if desc:
            x = -x if d.dtype.kind == "f" else ~x
        words.append(ordered(x, d.dtype.kind))
    words.append(np.arange(len(m), dtype=np.uint64))
    return words


def _emulate_multi_select(words: list, k: int, etrig: int, reads: list | None = None) -> tuple[list, int]:
    """numpy model of csrc/topn_multi.cu's select over one task: class
    passes at the flag words (per class count and OR / AND of the next
    word), digit passes of up to 8 bits from each word's top varying bit
    down, the candidates read from every row (checked against every known
    bit) until they fit a buffer of width / 8 — or until a pass over every
    row that speculated (buffering each candidate at the smallest digit
    seen so far) picked the smallest digit —, the collect once the rows
    below the threshold and the candidates number at most `etrig` (0: when
    every candidate is needed), then the composite order → (row ids,
    passes); `reads` gets each pass's candidate count read."""
    W = [[int(x) for x in w] for w in words]
    nw, width = len(W), len(W[0])
    rem, ncand = min(k, width), width
    pw, pmask, pval = -1, 0, 0
    T, K = [0] * nw, [0] * nw
    cw, ctop, vary, src, bcap = 0, -1, 0, None, (width + 7) // 8
    collect = ncand == rem or (etrig and width <= etrig)
    out, passes = [], 0

    def next_word(w):
        if w + 1 == nw - 1 and width > 1:
            v = (1 << (width - 1).bit_length()) - 1
            return w + 1, v, v.bit_length() - 1
        return w + 1, 0, -1

    while True:
        passes += 1
        rows = range(width) if src is None else src
        if reads is not None:
            reads.append(len(rows))

        def classify(r):
            for w in range(nw):
                if K[w] and (W[w][r] ^ T[w]) & K[w]:
                    assert src is None, "a buffered row off the known bits"
                    return -1
            if pw < 0:
                return 0
            x = W[pw][r] & pmask
            return 1 if x < pval else (0 if x == pval else -1)

        if collect:
            out += [r for r in rows if classify(r) >= 0]
            break
        stay, write = [], src is not None or ncand <= bcap
        cls = cw % 2 == 0 and cw < nw - 1
        spec_on, spec, smin = not cls and src is None and not write, [], 256
        nb = (4 if cw == 0 else 2) if cls else 256
        cnt, orv, andv = [0] * nb, [0] * nb, [(1 << 64) - 1] * nb
        dlo = 0 if cls else max(ctop - 7, (vary & -vary).bit_length() - 1)
        dm = 0 if cls else (2 << (ctop - dlo)) - 1
        for r in rows:
            c = classify(r)
            if c == 1:
                out.append(r)
            elif c == 0:
                b = W[cw][r] if cls else (W[cw][r] >> dlo) & dm
                cnt[b] += 1
                if cls:
                    orv[b] |= W[cw + 1][r]
                    andv[b] &= W[cw + 1][r]
                if spec_on and b <= smin:
                    spec.append(r)
                    smin = b
                stay.append(r)
        assert sum(cnt) == ncand
        incl = 0
        for b in range(nb):
            excl, incl = incl, incl + cnt[b]
            if excl < rem <= incl:
                break
        if pw >= 0:
            K[pw] |= pmask
        if cls:
            T[cw], pw, pmask, pval = b, cw, nb - 1, b
            vary = orv[b] ^ andv[b]
            if vary:
                cw, ctop = cw + 1, vary.bit_length() - 1
            else:
                cw, vary, ctop = next_word(cw + 1)
        else:
            T[cw] |= b << dlo
            pw, pmask, pval = cw, dm << dlo, b << dlo
            rest = vary & ((1 << dlo) - 1)
            if rest:
                ctop = rest.bit_length() - 1
            else:
                cw, vary, ctop = next_word(cw)
        held = spec_on and b == min(x for x in range(nb) if cnt[x]) and len(spec) <= bcap
        rem, ncand = rem - excl, cnt[b]
        if write:
            assert len(stay) <= bcap
            src = stay
        elif held:
            src = spec
        collect = ncand == rem or (etrig and (min(k, width) - rem) + ncand <= etrig)
    kk = min(k, width)
    assert len(out) >= kk and (etrig or len(out) == kk)
    return sorted(out, key=lambda r: tuple(W[w][r] for w in range(nw)))[:kk], passes


@pytest.mark.parametrize("k", [1, 50, 300, 2000])
@pytest.mark.parametrize("case", MULTI_CASES)
def test_select_plan_matches_the_reference(case, k):
    """csrc/topn_multi.cu's select, emulated in numpy over its composite
    words with the endgame size the kernel takes (and with none, as above
    the ordering cap), keeps exactly the reference's first rows in order."""
    rng = np.random.default_rng(MULTI_CASES.index(case) * 7 + k)
    n = 2000
    m, spec = _multi_spec(case, n, rng)
    want, _ = _ref_topn_multi(m, spec, k)
    words = _np_multi_words(m, spec)
    for etrig in (_kernel_endgame(k, len(spec), True)[0], 0):
        got, _ = _emulate_multi_select(words, k, etrig)
        assert got == want.tolist()


@pytest.mark.parametrize("k", [1, 50, 600])
@pytest.mark.parametrize("case", MULTI_CASES)
def test_k7_bound_reads_a_later_key_only_where_rows_tie(case, k):
    """chip_smoke.k7_need_bytes, K7's bytes bound: the mask and the first
    key's lanes at every row, key j's lanes only at the rows whose
    composite words before it equal the k-th row's and at the k rows
    returned, and 9 bytes a row returned — against the numpy words."""
    import chip_smoke

    rng = np.random.default_rng(MULTI_CASES.index(case) * 13 + k)
    n = 600
    m, spec = _multi_spec(case, n, rng)
    order = _np_topn_multi(m, spec, n)
    words = _np_multi_words(m, spec)
    picked = np.zeros(n, bool)
    picked[order[:k]] = True
    want = n + 9 * k + n * (spec[0][0].itemsize + 1)
    for j in range(1, len(spec)):
        tied = np.logical_and.reduce([w == w[order[k - 1]] for w in words[:2 * j]])
        want += int((tied | picked).sum()) * (spec[j][0].itemsize + 1)
    assert chip_smoke.k7_need_bytes(_t(m), _port_multi_keys(spec), k) == want
    if k == n:  # every row returned: every key at every row
        assert want == n + 9 * n + n * sum(d.itemsize + 1 for d, _, _ in spec)


def test_select_plan_reads_every_row_twice_on_multikey_topn():
    """On MULTIKEY_TOPN's keys (a 24-bit price DESC over a padded tail) the
    select is a class pass and one speculating digit pass over every row,
    then the buffer: no later key is read at every row."""
    rng = np.random.default_rng(5)
    n = 1 << 17
    m, spec = _multi_spec("price_orderkey_linenumber", n, rng)
    words = _np_multi_words(m, spec)
    got, passes = _emulate_multi_select(words, 50, 1024)
    assert got == _np_topn_multi(m, spec, 50).tolist()
    assert passes <= 4
    reads = []
    _emulate_multi_select(words, 50, 1024, reads)
    assert reads[:3] == [n, n, reads[2]] and all(r < n // 8 for r in reads[2:])


def _kernel_consts() -> dict:
    """csrc/topn_multi.cu's ordering constants, read from the source."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "tidb_tpu_torch" / "csrc" / "topn_multi.cu").read_text()
    assert "return 8 * nk + 10;" in src  # order_bytes: 8 bytes a key, flag bits, row id, index
    return {name: int(eval(re.search(rf"constexpr int {name} = ([0-9 *]+);", src).group(1)))
            for name in ("kOrderCap", "kOrderSmem", "kEndgame")}


def _kernel_order_cap(nk: int) -> int:
    """A model of csrc/topn_multi.cu's order_cap over its constants."""
    c = _kernel_consts()
    if not 1 <= nk <= 31:
        return 0
    cap = c["kOrderCap"]
    while cap and cap * (8 * nk + 10) > c["kOrderSmem"]:
        cap >>= 1
    return cap


def _kernel_endgame(k: int, nk: int, ordered: bool) -> tuple[int, int]:
    """A model of csrc/topn_multi.cu's endgame(): (etrig, oc)."""
    if not ordered:
        return 0, k
    etrig = k if k > _kernel_consts()["kEndgame"] else min(_kernel_consts()["kEndgame"], _kernel_order_cap(nk))
    return etrig, max(k, etrig)


def test_topn_multi_ordering_cap_is_the_kernels(monkeypatch):
    """The route choice: K7 orders k <= order_cap(nkeys) rows itself (no K8,
    no host read), above it K8 orders them. The rule lives in
    csrc/topn_multi.cu alone: its caps and output slots are as planned, and
    the wrapper takes both from the library."""
    import importlib

    tm = importlib.import_module("tidb_tpu_torch.kernels.topn_multi")
    assert [_kernel_order_cap(nk) for nk in (1, 3, 5, 6, 31, 32)] == [4096, 4096, 4096, 2048, 512, 0]
    assert [_kernel_endgame(k, 3, k <= 4096)[1] for k in (50, 3000, 5000)] == [1024, 3000, 5000]
    for name in ("ORDER_CAP", "ORDER_SMEM", "ENDGAME"):
        assert not hasattr(tm, name)

    class Lib:
        def tt_topn_multi_order_cap(self, nk):
            return _kernel_order_cap(nk)

        def tt_topn_multi_out_cap(self, k, nk, ordered):
            return _kernel_endgame(k, nk, bool(ordered))[1]

    monkeypatch.setattr(tm, "_lib", Lib)
    monkeypatch.setattr(tm, "_sizes", {})
    assert tm.orders_in_kernel(4096, 3) and not tm.orders_in_kernel(4097, 3)
    assert tm.orders_in_kernel(2048, 6) and not tm.orders_in_kernel(2049, 6)
    assert tm.out_cap(50, 3) == 1024 and tm.out_cap(3000, 3) == 3000 and tm.out_cap(5000, 3) == 5000


def test_topn_multi_rejects_what_it_does_not_take():
    m = _t(np.ones(5, bool))
    with pytest.raises(ValueError):
        topn_multi(m, [], 2)
    with pytest.raises(ValueError):
        topn_multi(m, [(_t(np.arange(4)), None, True)], 2)
    with pytest.raises(TypeError):
        topn_multi(m, [(_t(np.arange(5)), _t(np.arange(5)), True)], 2)
    idx, ok = topn_multi(m, [(_t(np.arange(5)), None, True)], 0)  # LIMIT 0: nothing
    assert idx.numel() == ok.numel() == 0


# --- K9 sort_groups --------------------------------------------------------


def _np_groups(m, keys):
    """numpy oracle: distinct (NULL flag, key bits) tuples of the masked
    rows in sorted order, and each masked row's group index."""
    cols = []
    for d, v in keys:
        if d.dtype == np.float64:
            d = np.where(np.abs(d) < np.finfo(np.float64).tiny, 0.0, d).view(np.int64)
        cols += [(~v).astype(np.int64), np.where(v, d.astype(np.int64), 0)]
    sel = np.nonzero(m)[0]
    stacked = np.stack([c[sel] for c in cols]) if len(sel) else np.zeros((len(cols), 0), np.int64)
    uniq, inv = np.unique(stacked, axis=1, return_inverse=True)
    return uniq, sel, inv.reshape(-1)


def _group_spec(case, n, rng):
    v = rng.random(n) < 0.85
    if case == "nullable_int":
        return [(rng.integers(-20, 20, n), v)]
    if case == "float_signed_zero_nan":
        return [(rng.choice(np.array([-0.0, 0.0, 1.5, -2.5, np.nan, np.inf, 5e-324, -1e-310]), n), v)]
    if case == "uint64":
        return [(rng.integers(0, 5, n).astype(np.uint64) << np.uint64(61), np.ones(n, bool))]
    if case == "multi_column":
        return [(rng.integers(0, 6, n).astype(np.int32), v), (rng.integers(-3, 3, n), rng.random(n) < 0.9)]
    raise KeyError(case)


def _port_keys(spec):
    return [(U64(_t(d.view(np.int64))) if d.dtype == np.uint64 else _t(d), _t(v)) for d, v in spec]


@pytest.mark.parametrize("cap", [None, 3], ids=["fits", "capped"])
@pytest.mark.parametrize("case", ["nullable_int", "float_signed_zero_nan", "uint64", "multi_column"])
def test_sort_groups_matches_a_numpy_oracle(case, cap):
    rng = np.random.default_rng(len(case))
    n = 2500
    m = rng.random(n) < 0.75
    spec = _group_spec(case, n, rng)
    seen = []
    g = sort_groups(_t(m), _port_keys(spec), lambda ng: seen.append(ng) or (cap or max(ng, 1)))
    uniq, sel, inv = _np_groups(m, spec)
    ng = uniq.shape[1]
    assert seen == [ng] and g.n_groups == ng
    c = g.cap
    seg = g.seg.numpy()
    assert (seg[~m] == c).all()
    assert seg[sel].tolist() == np.minimum(inv, c).tolist()
    kept = min(ng, c)
    for j in range(len(spec)):
        assert g.kvalid.numpy()[j, :kept].tolist() == (1 - uniq[2 * j, :kept]).tolist()
        assert g.kval.numpy()[j, :kept].tolist() == uniq[2 * j + 1, :kept].tolist()
        assert (g.kval.numpy()[j, kept:] == I64.min).all() and (g.kvalid.numpy()[j, kept:] == -1).all()


def test_sort_groups_all_masked_has_no_groups():
    n = 100
    g = sort_groups(_t(np.zeros(n, bool)), [(_t(np.arange(n)), None)], lambda ng: 64)
    assert g.n_groups == 0 and (g.seg.numpy() == 64).all()


# --- K4 segment-lane mode ----------------------------------------------------


@pytest.mark.parametrize("nseg", [5, 64, 300])
def test_seg_agg_segment_lane_matches_the_reference_reductions(nseg):
    """K4 over precomputed ids against _seg_sum/_seg_min/_seg_max, with rows
    at and beyond nseg dropped like masked rows."""
    rng = np.random.default_rng(nseg)
    n = 3000
    m = rng.random(n) < 0.8
    seg = rng.integers(0, nseg + 4, n).astype(np.int32)
    x = rng.integers(-10**12, 10**12, n)
    f = rng.standard_normal(n)
    ok = rng.random(n) < 0.9
    lanes = [SegLane("count", valid=_t(ok)), SegLane("sum_i64", _t(x), _t(ok)), SegLane("sum_f64", _t(f), _t(ok)),
             SegLane("min_i64", _t(x), _t(ok), int(I64.max)), SegLane("max_f64", _t(f), None, float("-inf")),
             SegLane("first_row", None, _t(ok), n if nseg <= 64 else int(I64.max))]
    gi, gf = seg_agg(_t(m), [], lanes, nseg, seg=_t(seg))
    jseg = jnp.asarray(np.where(m & (seg < nseg), seg, nseg))
    keep = jnp.asarray(m & ok)
    want_i = [ref_engine._seg_sum(keep.astype(jnp.int64), jseg, nseg),
              ref_engine._seg_sum(jnp.where(keep, jnp.asarray(x), 0), jseg, nseg),
              ref_engine._seg_min(jnp.where(keep, jnp.asarray(x), I64.max), jseg, nseg, I64.max),
              ref_engine._seg_min(jnp.where(keep, jnp.arange(n), n), jseg, nseg, jnp.asarray(n))]
    for j, w in enumerate(want_i):
        assert gi.numpy()[j].tolist() == np.asarray(w).tolist(), j
    want_f = [ref_engine._seg_sum(jnp.where(keep, jnp.asarray(f), 0.0), jseg, nseg),
              ref_engine._seg_max(jnp.where(jnp.asarray(m), jnp.asarray(f), -jnp.inf), jseg, nseg, -jnp.inf)]
    for j, w in enumerate(want_f):
        assert np.allclose(gf.numpy()[j], np.asarray(w), rtol=RTOL, atol=ATOL), j
    assert seg_agg_ref(_t(m), [], lanes, nseg, seg=_t(seg))[0].numpy().tolist() == gi.numpy().tolist()


def test_seg_agg_segment_lane_replaces_the_keys():
    from tidb_tpu_torch.kernels import SegKey

    m = _t(np.ones(4, bool))
    with pytest.raises(ValueError, match="segment lane"):
        seg_agg(m, [SegKey(_t(np.arange(4)), None, 0, 4)], [SegLane("count")], 5, seg=_t(np.zeros(4, np.int32)))
    with pytest.raises(ValueError, match="segment lane"):
        seg_agg(m, [], [SegLane("count")], 5, seg=_t(np.zeros(4, np.int64)))
