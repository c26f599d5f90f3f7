"""Host-side plans of M3 (csrc/hash_repartition.cu, the local half of the
hash exchange) and P7 (csrc/run_agg.cu, the clustered run totals) as
redesigned for the H100, modelled in numpy and held to the reference:

  * M3's one sweep: tiles in ticket order, each warp's rows ranked by
    owner in row order, the tile's rows staged grouped by owner, each
    owner's prefix over the tiles before by a look-back that folds
    aggregates up to the nearest inclusive descriptor, each owner's run
    written to consecutive slots, then the fill (the slots no row reached,
    the reference's emptied slot (o, cap - 1), `dropped`) — over buffers
    that arrive holding garbage, every slot written once (the emptied slot
    at most twice). Against hash_repartition_ref and, at n_dev 1, 2 and 4,
    the reference's jitted hash_repartition (tidb_tpu/parallel/mesh.py);
  * P7's reverse sweep: tiles taken from the last to the first, each
    lane's in-tile reverse segmented scan, the tile's aggregate (a run end
    in the tile, the sum up to its first run end), the carry from the rows
    after the tile up to the next run end when that lies within AHEAD rows
    (else by look-back over the tiles after it, which yields the same),
    the rows after the tile's last run end completed by the carry, and the
    float poison rule (NaN past a float lane's first non-finite row, fixed
    up by the launch's last block).
    Integer lanes bit for bit against run_agg_ref and the reference's own
    expression (cumsum and run-end gathers, tidb_tpu/parallel/mpp.py:
    1863-1873, through jnp); floats at run starts within rtol 1e-9 /
    atol 1e-6;
  * the constants the sources, the wrappers and chip_smoke.py share, and
    what the wrappers no longer do (zero the buffers, build a numpy word
    array, size their own scratch);
  * the wrappers on the CPU (their plain versions, no launch) and the
    profile modes without a card.

The kernels run only on the card (chip_smoke.py holds them to the plain
versions there); these tests need no card.
"""

from __future__ import annotations

import importlib
import inspect
import math
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import p7_args, repartition_battery, run_battery
from tidb_tpu.jaxenv import jnp  # the reference's JAX, int64 on
from tidb_tpu.parallel import mesh as ref_mesh

M3, P7 = (importlib.import_module(f"tidb_tpu_torch.kernels.{m}") for m in ("hash_repartition", "run_agg"))

CSRC = Path(M3.__file__).resolve().parent.parent / "csrc"
ROOT = CSRC.parents[1]
RTOL, ATOL = 1e-9, 1e-6


def _constant(src: str, name: str) -> int:
    text = (CSRC / src).read_text()
    m = re.search(rf"constexpr (?:int|int64_t|ll) {name} = ([^;]+);", text)
    assert m, (src, name)
    expr = m.group(1)
    for other in set(re.findall(r"\bcompact::([A-Z][A-Z_]+)\b", expr)):
        expr = expr.replace(f"compact::{other}", str(_constant("compact.cuh", other)))
    for other in set(re.findall(r"\b[A-Z][A-Z_]+\b", expr)):
        expr = re.sub(rf"\b{other}\b", str(_constant(src, other)), expr)
    return int(eval(expr))  # noqa: S307 — an integer expression of the source's own constants


# --- M3: the sweep and the fill ------------------------------------------------------

M3_BLOCK = _constant("hash_repartition.cu", "BLOCK")
M3_ITEMS = _constant("hash_repartition.cu", "ITEMS")
M3_TILE = _constant("hash_repartition.cu", "TILE")
M3_WARPS = M3_BLOCK // 32
GARBAGE = -0x5A5A5A5A5A5A5A5A  # what torch.empty may hold: the kernels write every slot


def _owner(keys, valid, n_dev: int) -> np.ndarray:
    """The kernel's owner of each row: a power-of-two n_dev masks the key,
    any other takes C's remainder and adds n_dev to a negative one; both
    are the floored key mod n_dev. Invalid rows own bin n_dev."""
    k = np.asarray(keys, dtype=np.int64)
    if n_dev & (n_dev - 1) == 0:
        own = k & (n_dev - 1)
    else:
        r = np.fmod(k, n_dev)
        own = np.where(r < 0, r + n_dev, r)
    assert np.array_equal(own, np.remainder(k, n_dev))
    return np.where(valid, own, n_dev)


def _look_back(aggs: list, tile: int, add, ident, visible) -> object:
    """compact.cuh's look_back as the tiles after it see tile `tile`'s
    predecessors: fold the aggregates of tiles tile-1, tile-2, ... (the
    nearer one last) up to the nearest whose inclusive value is visible
    (`visible(u)`; tile 0's always is). aggs[u] = (aggregate, inclusive)."""
    acc = ident
    for u in range(tile - 1, -1, -1):
        agg, incl = aggs[u]
        if u == 0 or visible(u):
            return add(incl, acc)
        acc = add(agg, acc)
    return acc


def model_m3(keys, payload, valid, n_dev: int, cap: int, visible=lambda u: u % 3 != 1):
    """The two launches of csrc/hash_repartition.cu over numpy lanes →
    (buf_k, buf_p, buf_v, dropped, writes): writes counts the stores into
    each slot."""
    n = len(keys)
    own_all = _owner(keys, valid, n_dev)
    bk = np.full((n_dev, cap), GARBAGE, dtype=np.int64)
    bp = np.full((n_dev, cap), GARBAGE, dtype=np.int64)
    bv = np.full((n_dev, cap), 7, dtype=np.uint8)
    writes = np.zeros((n_dev, cap), dtype=np.int64)
    ntiles = -(-n // M3_TILE)
    aggs: list = []  # per tile: (its per-owner counts, the counts of it and every tile before)
    tot = np.zeros(n_dev, dtype=np.int64)
    for tile in range(ntiles):  # the ticket order
        rows = np.arange(tile * M3_TILE, min((tile + 1) * M3_TILE, n))
        own = own_all[rows]
        if n_dev == 1:
            # compact.cuh's place_tile: row_of(tile, j) = tile * TILE + j * BLOCK
            # + threadIdx.x; a (round j, warp w) part's kept rows by one ballot,
            # the parts' exclusive offsets, then the lanes before in the ballot
            local = rows - tile * M3_TILE
            part = (local // M3_BLOCK) * M3_WARPS + (local % M3_BLOCK) // 32
            keep = own == 0
            counts = np.bincount(part[keep], minlength=M3_ITEMS * M3_WARPS)
            off = np.cumsum(counts) - counts
            place = np.array([off[part[q]] + np.sum(keep[:q] & (part[:q] == part[q])) for q in range(len(rows))])
            staged = np.full(int(keep.sum()), -1, dtype=np.int64)
            staged[place[keep]] = rows[keep]
            assert np.array_equal(staged, rows[keep])  # the kept rows in row order
            tcount = np.array([len(staged)])
            lstart = np.zeros(1, dtype=np.int64)
        else:
            # warp w: rows [w * 32 * ITEMS, (w + 1) * 32 * ITEMS) of the tile, 32 a round
            warp = (rows - tile * M3_TILE) // (32 * M3_ITEMS)
            cnt = np.zeros((M3_WARPS, n_dev), dtype=np.int64)
            rk = np.zeros(len(rows), dtype=np.int64)
            for r in range(M3_ITEMS):  # the rounds, each lane's rank among its round's peers after the running count
                for w in range(M3_WARPS):
                    at = np.nonzero((warp == w) & ((rows - tile * M3_TILE) % (32 * M3_ITEMS) // 32 == r))[0]
                    for q in at:
                        o = own[q]
                        if o < n_dev:
                            rk[q] = cnt[w, o]
                            cnt[w, o] += 1
            first_slot = np.cumsum(cnt, axis=0) - cnt  # each warp's first slot in the owner's run
            tcount = cnt.sum(axis=0)
            lstart = np.cumsum(tcount) - tcount
            staged = np.full(int(tcount.sum()), -1, dtype=np.int64)
            for q in np.nonzero(own < n_dev)[0]:
                o = own[q]
                slot = lstart[o] + first_slot[warp[q], o] + rk[q]
                assert staged[slot] == -1
                staged[slot] = rows[q]
            # grouped by owner, row order within an owner: a stable sort of the valid rows by owner
            v = rows[own < n_dev]
            assert np.array_equal(staged, v[np.argsort(own_all[v], kind="stable")])
        before = _look_back(aggs, tile, lambda a, b: a + b, np.zeros(n_dev, dtype=np.int64), visible)
        assert np.array_equal(before, np.array([np.sum(own_all[:tile * M3_TILE] == o) for o in range(n_dev)]))
        aggs.append((tcount, before + tcount))
        pos_prev = {}
        for j, r in enumerate(staged):  # each owner's run to consecutive slots
            o = own_all[r]
            pos = before[o] + j - lstart[o]
            if o in pos_prev:
                assert pos == pos_prev[o] + 1
            pos_prev[o] = pos
            if pos < cap:
                bk[o, pos], bp[o, pos], bv[o, pos] = keys[r], payload[r], 1
                writes[o, pos] += 1
        if tile == ntiles - 1:
            tot = before + tcount
    # the fill: flat position f over every owner's zero range [min(total, cap), cap),
    # its owner the last whose range starts at or before f
    z = cap - np.minimum(tot, cap)
    pre = np.concatenate([np.cumsum(z) - z, [z.sum()]])
    f = np.arange(int(z.sum()))
    o = np.searchsorted(pre[:n_dev], f, side="right") - 1
    pos = cap - (pre[o + 1] - f)
    assert np.all((pos >= np.minimum(tot, cap)[o]) & (pos < cap))
    bk[o, pos], bp[o, pos], bv[o, pos] = 0, 0, 0
    np.add.at(writes, (o, pos), 1)
    invalid = n - int(tot.sum())
    for o in range(n_dev):
        if tot[o] > cap or (o == n_dev - 1 and tot[o] == cap and invalid > 0):
            bk[o, cap - 1], bp[o, cap - 1], bv[o, cap - 1] = 0, 0, 0
            writes[o, cap - 1] += 1
    dropped = int(np.maximum(tot - cap, 0).sum())
    return bk, bp, bv, dropped, writes


def _m3_case(n: int, n_dev: int, case: str):
    rng = np.random.default_rng(n * 7 + n_dev + len(case))
    keys, payload, valid, cap = repartition_battery(rng, n, n_dev, case)
    if case == "negative":
        keys = -np.abs(keys) - 1
    return np.asarray(keys, dtype=np.int64), np.asarray(payload, dtype=np.int64), valid, max(cap, 1)


M3_CASES = [(1, 1, "mixed"), (0, 1, "mixed"), (M3_TILE - 1, 1, "mixed"), (M3_TILE, 1, "mixed"),
            (M3_TILE + 1, 1, "mixed"), (3 * M3_TILE + 5, 1, "small_cap"), (3 * M3_TILE + 5, 1, "invalid"),
            (3 * M3_TILE + 5, 1, "full_last"), (M3_TILE - 1, 2, "mixed"), (M3_TILE + 1, 2, "negative"),
            (2 * M3_TILE + 3, 2, "full_last"), (M3_TILE, 4, "mixed"), (3 * M3_TILE + 5, 4, "small_cap"),
            (3 * M3_TILE + 5, 4, "invalid"), (2 * M3_TILE + 3, 4, "full_last"), (M3_TILE + 1, 31, "mixed"),
            (2 * M3_TILE + 3, 31, "full_last"), (3 * M3_TILE + 5, 31, "small_cap"), (M3_TILE + 1, 1024, "mixed"),
            (2 * M3_TILE + 3, 1024, "small_cap"), (3, 1024, "negative")]


@pytest.mark.parametrize("n,n_dev,case", M3_CASES, ids=[f"n{n}_d{d}_{c}" for n, d, c in M3_CASES])
def test_m3_sweep_and_fill_model_is_the_plain_version(n, n_dev, case):
    keys, payload, valid, cap = _m3_case(n, n_dev, case)
    bk, bp, bv, dropped, writes = model_m3(keys, payload, valid, n_dev, cap)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    wk, wp, wv, wd = M3.hash_repartition_ref(t(keys), t(payload), t(valid), n_dev, cap)
    assert np.array_equal(bk, wk.numpy()) and np.array_equal(bp, wp.numpy())
    assert np.array_equal(bv.astype(bool), wv.numpy()) and set(np.unique(bv)) <= {0, 1}
    assert dropped == int(wd[0])
    assert writes.min() == 1 and writes.max() <= 2  # every slot written; twice only at an emptied slot
    if case == "invalid":
        assert not bv.any() and dropped == 0


@pytest.mark.parametrize("n,n_dev,case", [(M3_TILE + 1, 1, "mixed"), (3 * M3_TILE + 5, 1, "small_cap"),
                                          (2 * M3_TILE + 3, 1, "full_last"), (2 * M3_TILE + 6, 2, "negative"),
                                          (3 * M3_TILE + 4, 4, "small_cap"), (2 * M3_TILE + 4, 4, "full_last")])
def test_m3_model_is_the_reference_mesh(n, n_dev, case):
    """The model's send buffers, shard by shard, then the all_to_all done
    here (rank r receives block r of every rank's buffers), against the
    reference's jitted step on make_mesh(n_dev)."""
    keys, payload, valid, cap = _m3_case(n, n_dev, case)
    per = n // n_dev
    sends = [model_m3(keys[r * per:(r + 1) * per], payload[r * per:(r + 1) * per], valid[r * per:(r + 1) * per],
                      n_dev, cap) for r in range(n_dev)]
    got = [np.concatenate([np.concatenate([s[j][dst] for s in sends]) for dst in range(n_dev)]) for j in range(3)]
    fn = ref_mesh.hash_repartition(ref_mesh.make_mesh(n_dev), cap=cap)
    want = fn(jnp.asarray(keys[:per * n_dev]), jnp.asarray(payload[:per * n_dev]), jnp.asarray(valid[:per * n_dev]))
    assert np.array_equal(got[0], np.asarray(want[0])) and np.array_equal(got[1], np.asarray(want[1]))
    assert np.array_equal(got[2].astype(bool), np.asarray(want[2]))
    assert sum(s[3] for s in sends) == int(want[3])


def test_m3_look_back_at_any_visibility_gives_the_prefix():
    """Whichever predecessors have published their inclusive counts when a
    tile looks back, the fold of aggregates up to the nearest inclusive
    one is the owner's rows in every tile before."""
    keys, payload, valid, cap = _m3_case(6 * M3_TILE + 7, 4, "mixed")
    want = model_m3(keys, payload, valid, 4, cap)
    for visible in (lambda u: False, lambda u: True, lambda u: u % 2 == 0):
        got = model_m3(keys, payload, valid, 4, cap, visible=visible)
        assert all(np.array_equal(g, w) for g, w in zip(got[:3], want[:3])) and got[3] == want[3]


# --- P7: the reverse sweep ------------------------------------------------------------

P7_BLOCK = _constant("run_agg.cu", "BLOCK")
P7_ITEMS = _constant("run_agg.cu", "ITEMS")
P7_TILE = _constant("run_agg.cu", "TILE")
P7_AHEAD = _constant("run_agg.cu", "AHEAD")  # rows after a tile its last warp reads for the carry
MASK64 = (1 << 64) - 1


def _as_u64(x) -> int:
    return int(x) & MASK64


def _lane_values(mask, d, v):
    """A lane's row values as the kernel reads them: Python ints modulo
    2^64 for count and integer lanes, floats (-0.0 as +0.0) for a float
    lane."""
    ok = mask if v is None else mask & v
    if d is None:
        return [int(b) for b in ok], False
    if d.dtype.kind == "f":
        return [float(x) + 0.0 if o else 0.0 for x, o in zip(d, ok)], True
    return [_as_u64(x) if o else 0 for x, o in zip(d, ok)], False


def model_run_agg(kd, mask, lanes, cnt_lane, rid_lane, score_lane, desc, visible=lambda u: u % 4 != 1):
    """The one launch of csrc/run_agg.cu over numpy lanes → (totals,
    gpos, valid, score) as numpy arrays (integer lanes int64, float lanes
    float64)."""
    L = len(kd)
    first = np.concatenate([[True], kd[1:] != kd[:-1]])
    last = np.concatenate([kd[1:] != kd[:-1], [True]])
    vals = [_lane_values(mask, d, v) for d, v in lanes]
    nl = len(lanes)
    add = [(lambda a, b: a + b) if f else (lambda a, b: (a + b) & MASK64) for _, f in vals]
    outs = [[None] * L for _ in range(nl)]
    poison = [0] * nl  # L - the first non-finite row, 0: none
    ntiles = -(-L // P7_TILE)
    slots: list = []  # per ticket, per lane: ((f, v) aggregate, (f, v) inclusive)
    for v in range(ntiles):  # ticket v: tile ntiles - 1 - v
        t0 = (ntiles - 1 - v) * P7_TILE
        t1 = min(t0 + P7_TILE, L)
        ends = [i for i in range(t0, t1) if last[i]]
        lend = ends[-1] if ends else -1
        aggs = []
        for l, (xs, isf) in enumerate(vals):
            for i in range(t0, t1):
                if isf and not math.isfinite(xs[i]):
                    poison[l] = max(poison[l], L - i)
            acc = 0.0 if isf else 0
            for i in range(t1 - 1, t0 - 1, -1):  # in-tile reverse segmented scan
                acc = xs[i] if last[i] else add[l](acc, xs[i])
                outs[l][i] = acc
            aggs.append((bool(ends), outs[l][t0]))

        def seg(l, x, y):  # x later in the stream than y
            return (x[0] or y[0], y[1] if y[0] else add[l](x[1], y[1]))
        # the last warp's look-ahead: the rows after the tile up to the next run end, within AHEAD
        ahead = 0 if t1 >= L else next((q + 1 for q in range(P7_AHEAD) if t1 + q < L and last[t1 + q]), -1)
        carries, row = [], []
        for l in range(nl):
            c = (False, 0.0 if vals[l][1] else 0)
            for u in range(v - 1, -1, -1):  # the look-back over the tiles after this one
                agg, incl = slots[u][l]
                if u == 0 or incl is not None and visible(u):
                    c = seg(l, incl, c)
                    break
                c = seg(l, agg, c)
            if ahead >= 0:  # known from the rows after the tile: the look-back is not run
                direct = (ahead > 0, sum(vals[l][0][t1:t1 + ahead], 0.0) if vals[l][1] else
                          sum(vals[l][0][t1:t1 + ahead]) & MASK64)
                assert c[1] == direct[1] or vals[l][1] and math.isclose(c[1], direct[1], rel_tol=RTOL, abs_tol=ATOL)
                c = direct
            carries.append(c)
            # published inclusive at once when the tile holds a run end or its carry is known
            row.append((aggs[l], seg(l, c, aggs[l]) if aggs[l][0] or ahead >= 0 or visible(v) else None))
        slots.append(row)
        for l in range(nl):  # a tile that waited on the look-back publishes its inclusive value after it
            if row[l][1] is None:
                row[l] = (aggs[l], seg(l, carries[l], aggs[l]))
        for l in range(nl):
            for i in range(max(lend + 1, t0), t1):  # their run goes on past the tile
                outs[l][i] = add[l](carries[l][1], outs[l][i])
    for l, (_, isf) in enumerate(vals):  # the last block's fix-up
        if isf and poison[l]:
            for i in range(L - poison[l] + 1, L):
                outs[l][i] = math.nan
    totals = []
    for l, (_, isf) in enumerate(vals):
        a = np.array(outs[l], dtype=np.float64 if isf else np.uint64)
        totals.append(a if isf else a.view(np.int64))
    cnt, rid = totals[cnt_lane], totals[rid_lane]
    gpos = np.array([r // c if c > 0 else -1 for r, c in zip(rid.tolist(), cnt.tolist())], dtype=np.int64)
    valid = first & (cnt > 0)
    s = totals[score_lane]
    if s.dtype == np.float64:
        score = np.where(valid, s if desc else -s, -np.inf)
    else:
        with np.errstate(over="ignore"):
            score = np.where(valid, s if desc else (np.uint64(0) - s.view(np.uint64)).view(np.int64), -(2 ** 63 - 1))
    return totals, gpos, valid, score


def _reference_run_sums(kd, mask, lanes):
    """The reference's run_sum as written (mpp.py:1863-1873), through jnp:
    one cumsum and the run-end gathers per lane."""
    kdj, nloc = jnp.asarray(kd), len(kd)
    idx = jnp.arange(nloc, dtype=jnp.int32)
    brk = kdj[1:] != kdj[:-1]
    last = jnp.concatenate([brk, jnp.ones(1, bool)])
    rend = -jax.lax.cummax(jnp.where(last, -idx, -(nloc - 1))[::-1])[::-1]
    out = []
    for d, v in lanes:
        ok = jnp.asarray(mask if v is None else mask & v)
        vals = ok.astype(jnp.int64) if d is None else jnp.where(ok, jnp.asarray(d), jnp.zeros((), d.dtype))
        c = jnp.cumsum(vals)
        prev = jnp.concatenate([jnp.zeros(1, c.dtype), c[:-1]])
        out.append(np.asarray(c[rend] - prev))
    return out


P7_CASES = [(1, "runs"), (P7_TILE - 1, "runs"), (P7_TILE, "tile_end"), (P7_TILE + 1, "singles"),
            (3 * P7_TILE, "tile_end"), (3 * P7_TILE + 7, "giant_run"), (3 * P7_TILE + 7, "one_run"),
            (4 * P7_TILE, "pad_tail"), (2 * P7_TILE + 5, "asc"), (2 * P7_TILE + 5, "negzero"),
            (2 * P7_TILE + 5, "big_prefix"), (2 * P7_TILE + 5, "nan"), (2 * P7_TILE + 5, "nan_first"),
            (2 * P7_TILE + 5, "nan_last"), (P7_TILE + 3, "lanes16")]


def _p7_case(L: int, case: str) -> dict:
    return run_battery(np.random.default_rng(L * 3 + len(case)), L, case)


@pytest.mark.parametrize("L,case", P7_CASES, ids=[f"L{L}_{c}" for L, c in P7_CASES])
def test_p7_reverse_sweep_model_is_the_plain_version(L, case):
    b = _p7_case(L, case)
    kd, mask = b["kd"], b["mask"]
    args = (b["cnt_lane"], b["rid_lane"], b["score_lane"], b["desc"])
    totals, gpos, valid, score = model_run_agg(kd, mask, b["lanes"], *args)
    want = P7.run_agg_ref(*p7_args(b, "cpu"))
    first = np.concatenate([[True], kd[1:] != kd[:-1]])
    for j, (g, w) in enumerate(zip(totals, want[0])):
        w = w.numpy()
        if g.dtype == np.float64:
            assert np.allclose(g[first], w[first], rtol=RTOL, atol=ATOL, equal_nan=True), j
            assert np.array_equal(np.isnan(g[first]), np.isnan(w[first]))
            assert not np.signbit(g[first][g[first] == 0]).any()  # a -0.0 run totals +0.0
        else:
            assert np.array_equal(g, w), j
    assert np.array_equal(gpos, want[1].numpy()) and np.array_equal(valid, want[2].numpy())
    ws = want[3].numpy()
    if ws.dtype == np.float64:
        assert np.allclose(score[first], ws[first], rtol=RTOL, atol=ATOL, equal_nan=True)
        num = first & ~np.isnan(ws)
        assert np.array_equal(np.signbit(score[num]), np.signbit(ws[num]))  # -0.0 ascending, as top_k orders it
    else:
        assert np.array_equal(score, ws)


@pytest.mark.parametrize("L,case", [(P7_TILE + 1, "singles"), (3 * P7_TILE, "tile_end"), (3 * P7_TILE + 7, "one_run"),
                                    (4 * P7_TILE, "pad_tail"), (2 * P7_TILE + 5, "runs")])
def test_p7_model_integer_lanes_are_the_reference_expression(L, case):
    """Count and integer lanes bit for bit against the reference's own
    cumsum and run-end gathers, wrapped prefixes and all."""
    b = _p7_case(L, case)
    kd, mask, lanes = b["kd"], b["mask"], b["lanes"]
    totals = model_run_agg(kd, mask, lanes, b["cnt_lane"], b["rid_lane"], b["score_lane"], b["desc"])[0]
    for j, (g, w) in enumerate(zip(totals, _reference_run_sums(kd, mask, lanes))):
        if g.dtype != np.float64:
            assert np.array_equal(g, w), j


def test_p7_look_back_at_any_visibility_gives_the_carry():
    """Whichever tiles after it have published their inclusive carries
    when a tile looks back, the fold of aggregates up to the nearest
    inclusive one is the rest of the tile's last run. A tile that holds a
    run end publishes its aggregate as inclusive with no look-back (the
    segmented combine drops what lies beyond its first run end), so the
    look-back stops there."""
    b = _p7_case(5 * P7_TILE + 3, "giant_run")
    args = (b["kd"], b["mask"], b["lanes"], b["cnt_lane"], b["rid_lane"], b["score_lane"], b["desc"])
    want = model_run_agg(*args)
    for visible in (lambda u: False, lambda u: True, lambda u: u % 2 == 1):
        got = model_run_agg(*args, visible=visible)
        for g, w in zip(got[0], want[0]):  # integers bit for bit; floats as folded in another order
            assert np.allclose(g, w, rtol=RTOL, atol=ATOL) if g.dtype == np.float64 else np.array_equal(g, w)
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[3], want[3])


def test_p7_tile_end_case_ends_a_run_on_every_tile_edge():
    """chip_smoke.py's tile_end battery: row t * TILE - 1 ends a run for
    every tile t, so no tile has rows after its last run end (the carry
    reaches no row), and the model still equals the plain version there."""
    b = _p7_case(3 * P7_TILE, "tile_end")
    kd = b["kd"]
    assert all(kd[t * P7_TILE - 1] != kd[t * P7_TILE] for t in range(1, 3))
    got = model_run_agg(kd, b["mask"], b["lanes"], b["cnt_lane"], b["rid_lane"], b["score_lane"], b["desc"])
    assert np.array_equal(got[1], P7.run_agg_ref(*p7_args(b, "cpu"))[1].numpy())


# --- the constants, the wrappers and the scripts -------------------------------------

def test_constants_match_the_sources():
    assert M3_TILE == M3_BLOCK * M3_ITEMS == chip_smoke.REPARTITION_TILE
    assert _constant("hash_repartition.cu", "MAX_DEV") == M3.MAX_DEV
    assert _constant("hash_repartition.cu", "PER") * M3_BLOCK >= M3.MAX_DEV
    assert P7_TILE == P7_BLOCK * P7_ITEMS == chip_smoke.RUN_TILE
    assert _constant("run_agg.cu", "MAX_LANES") == P7.MAX_LANES == _constant("run_agg.cu", "POISON")
    text = (CSRC / "run_agg.cu").read_text()
    assert "return POISON + compact::scratch_words(tiles(L) * nl);" in text
    assert "return MAX_DEV + compact::scratch_words(compact::tiles(n) * n_dev);" in (
        CSRC / "hash_repartition.cu").read_text()
    assert "inline ll scratch_words(ll descs) { return HEAD + 2 * descs; }" in (CSRC / "compact.cuh").read_text()


def test_seg_scan_keeps_only_what_p5_and_p7_call():
    """seg_scan.cuh holds the lane ops P5 and P7 share; every function and
    constant it defines is used by one of them, and nothing of the old
    four-launch scan is left."""
    head = (CSRC / "seg_scan.cuh").read_text()
    users = (CSRC / "seg_reduce.cu").read_text() + (CSRC / "run_agg.cu").read_text()
    names = re.findall(r"__forceinline__ \w+ (\w+)\(", head) + re.findall(r"constexpr \w+ (\w+) =", head)
    assert names
    for name in names:  # its definition, and a use here or in a caller
        assert len(re.findall(rf"\b{name}\b", head + users)) > 1, name
    for gone in ("poison_kernel", "heads_kernel", "carry_kernel", "run_suffix", "tile_suffix", "CarryPrefix",
                 "prepare", "layout", "scratch_words"):
        assert gone not in head, gone


def test_wrappers_allocate_once_and_zero_nothing():
    m3 = inspect.getsource(M3.hash_repartition)
    assert "torch.zeros" not in m3 and m3.count("torch.empty") == 1 and "stream_scratch(" in m3 and "sm_count(" in m3
    p7 = inspect.getsource(P7.run_agg) + inspect.getsource(P7.outputs)
    assert "np." not in p7 and "stream_scratch(" in p7 and p7.count("torch.empty") == 1
    for src in ("hash_repartition.cu", "run_agg.cu"):
        assert "cudaMemset" not in (CSRC / src).read_text()


def test_run_agg_outputs_are_views_of_one_allocation():
    totals, gpos, valid, score = P7.outputs(5, [False, True, False], 1, torch.device("cpu"))
    base = gpos.untyped_storage().data_ptr()
    for t in totals + [gpos, valid, score]:
        assert t.untyped_storage().data_ptr() == base and t.shape == (5,)
    assert totals[1].dtype == score.dtype == torch.float64 and valid.dtype == torch.bool


def test_cpu_wrappers_take_their_plain_versions():
    b = _p7_case(P7_TILE + 1, "runs")
    args = p7_args(b, "cpu")
    got, want = P7.run_agg(*args), P7.run_agg_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0])) and torch.equal(got[3], want[3])
    keys, payload, valid, cap = _m3_case(M3_TILE + 1, 4, "small_cap")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    g, w = M3.hash_repartition(t(keys), t(payload), t(valid), 4, cap), M3.hash_repartition_ref(t(keys), t(payload),
                                                                                                t(valid), 4, cap)
    assert all(torch.equal(a, c) for a, c in zip(g, w))
    assert P7.run_agg.launches == 0 and M3.hash_repartition.launches == 0


@pytest.mark.parametrize("script,args", [("mpp_profile.py", ["--only", "p7"]), ("mpp_profile.py", ["--only", "m3"]),
                                         ("mesh_stress.py", ["--query", "q3_mpp", "--iters", "1"])])
def test_profile_modes_without_a_card_exit_non_zero(script, args):
    out = subprocess.run([sys.executable, str(ROOT / script), *args], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
