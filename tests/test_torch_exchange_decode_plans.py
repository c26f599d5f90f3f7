"""Host-side plans of P2 (csrc/exchange.cu, the MPP hash exchange's device
half) and K1 (csrc/decode_lane.cu, every coded lane of a call in one
launch) as redesigned for the H100, modelled in numpy and held to the
plain versions and the reference:

  * P2's sweep: tiles in ticket order, each row's owner from its mask and
    keys (int64 wrap, the int32 truncation, the probe rule, the floored
    mod), each warp's rows ranked by owner in row order, the per-owner
    look-back at any visibility, each owner's run staged with its staged
    index and slot agreeing mod ALIGN, and written in 16-byte units (a
    whole unit at once, the run's partial end units element by element);
    then the fill (every lane's slots past min(total, bcap) up to the
    lane's aligned end, the row's end, `dropped`) — over a send buffer that
    starts as garbage, every byte written exactly once. Against
    exchange_ref at n_dev 2, 3, 4, 8 and 64 for mixed, probe, i32, masked
    and skew inputs, 46 lanes (15 of them 1-byte);
  * K1's work split: each entry's head (rows before its first 16-byte-
    aligned output row), its (entry, chunk) work items, RPT rows a thread
    in steps of 16 / VB consecutive rows (a warp's step 512 contiguous
    bytes of stores; one vector load of the codes where they line up, else
    scalar), the ragged ends, the rle first-row search and forward walk,
    the vocab in shared memory or not — over outputs that start as
    garbage, every row written once. Against decode_lane_ref and the reference's
    TPUEngine._decode_lane, for several entries of mixed codecs at once;
  * the many-lane wrappers (decode_lanes, decode_lanes_tasks) on the CPU,
    equal lane by lane to their plain versions, and chip_smoke.py's
    many-lane batteries there;
  * the constants the sources, the wrappers and chip_smoke.py share, and
    what the P2 wrapper no longer does (zero the send buffer, build a
    numpy word array a call, allocate scratch of its own).

The kernels run only on the card (chip_smoke.py holds them to the plain
versions there); these tests need no card.
"""

from __future__ import annotations

import importlib
import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import exchange_battery
from tidb_tpu.copr import tpu_engine as ref_engine
from tidb_tpu.jaxenv import jnp  # the reference's JAX, int64 on

from tidb_tpu_torch.kernels import decode_lane_ref, decode_lanes
from tidb_tpu_torch.kernels.exchange import OwnerKey, exchange, exchange_ref, layout
from tidb_tpu_torch.kernels.grouped import decode_lanes_tasks, decode_lanes_tasks_ref

P2 = importlib.import_module("tidb_tpu_torch.kernels.exchange")
K1 = importlib.import_module("tidb_tpu_torch.kernels.decode_lane")
GK = importlib.import_module("tidb_tpu_torch.kernels.grouped")

CSRC = Path(P2.__file__).resolve().parent.parent / "csrc"
ROOT = CSRC.parents[1]


def _constant(src: str, name: str) -> int:
    text = (CSRC / src).read_text()
    m = re.search(rf"constexpr (?:int|int64_t|ll) {name} = ([^;]+);", text)
    assert m, (src, name)
    expr = m.group(1)
    for other in set(re.findall(r"\bcompact::([A-Z][A-Z_]+)\b", expr)):
        expr = expr.replace(f"compact::{other}", str(_constant("compact.cuh", other)))
    for other in set(re.findall(r"\b[A-Z][A-Z_0-9]+\b", expr)):
        expr = re.sub(rf"\b{other}\b", str(_constant(src, other)), expr)
    return int(eval(expr))  # noqa: S307 — an integer expression of the source's own constants


# --- P2: the sweep and the fill --------------------------------------------------------

P2_BLOCK = _constant("exchange.cu", "BLOCK")
P2_ITEMS = _constant("exchange.cu", "ITEMS")
P2_TILE = _constant("exchange.cu", "TILE")
P2_ALIGN = _constant("exchange.cu", "ALIGN")
P2_WARPS = P2_BLOCK // 32
P2_UCAPS = [_constant("exchange.cu", f"UCAP{c}") for c in range(3)]
GARBAGE = 0x5A  # what torch.empty may hold: the kernels write every byte


def _owners(n_dev, mask, keys, key_i32, probe) -> np.ndarray:
    """owner_of for every row: the bin n_dev outside the mask."""
    n = len(mask)
    acc = np.zeros(n, dtype=np.uint64)
    kv = np.ones(n, dtype=bool)
    for d, v, lo, st in keys:
        acc += (np.asarray(d).astype(np.uint64) - np.uint64(lo % (1 << 64))) * np.uint64(st % (1 << 64))
        if v is not None:
            kv &= np.asarray(v)
    key = acc.view(np.int64)
    if key_i32:
        key = (acc & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32).astype(np.int64)
    if probe:
        key = np.where(kv, key, np.arange(n, dtype=np.int64))
    r = np.fmod(key, n_dev)
    own = np.where(r < 0, r + n_dev, r)
    return np.where(mask, own, n_dev)


def _look_back(aggs: list, tile: int, visible) -> np.ndarray:
    """compact.cuh's look_back, one slot an owner: fold the aggregates of
    tiles tile-1, tile-2, ... up to the nearest whose inclusive prefix is
    visible (tile 0's always is). aggs[u] = (aggregate, inclusive)."""
    acc = 0
    for u in range(tile - 1, -1, -1):
        agg, incl = aggs[u]
        if u == 0 or visible(u):
            return incl + acc
        acc = agg + acc
    return acc


def _lane_bytes(bcap: int, sz: int) -> int:
    return -(-bcap * sz // 16) * 16


def model_exchange(n_dev, bcap, mask, keys, key_i32, probe, lanes, visible=lambda u: u % 3 != 1):
    """The two launches of csrc/exchange.cu over numpy lanes → (send as
    int64 [n_dev, W], dropped, writes: the stores into each byte)."""
    n = len(mask)
    sizes = [a.dtype.itemsize for a in lanes]
    offs, words = layout([torch.from_numpy(np.ascontiguousarray(a[:1])) for a in lanes], bcap)
    row_bytes = words * 8
    at = max([o + _lane_bytes(bcap, s) for o, s in zip(offs, sizes)], default=0)
    send = np.full((n_dev, row_bytes), GARBAGE, dtype=np.uint8)
    writes = np.zeros((n_dev, row_bytes), dtype=np.int64)
    lbytes = [np.ascontiguousarray(a).view(np.uint8).reshape(n, s) for a, s in zip(lanes, sizes)]
    own_all = _owners(n_dev, mask, keys, key_i32, probe)
    ntiles = -(-n // P2_TILE)
    aggs: list = []
    tot = np.zeros(n_dev, dtype=np.int64)
    for tile in range(ntiles):  # the ticket order
        rows = np.arange(tile * P2_TILE, min((tile + 1) * P2_TILE, n))
        local = rows - tile * P2_TILE
        own = own_all[rows]
        warp, rnd = local // (32 * P2_ITEMS), local % (32 * P2_ITEMS) // 32
        # rank_rows: a round's rows of one owner after the warp's running count of it
        cnt = np.zeros((P2_WARPS, n_dev + 1), dtype=np.int64)
        rk = np.zeros(len(rows), dtype=np.int64)
        for w in range(P2_WARPS):
            for r in range(P2_ITEMS):
                at_r = np.nonzero((warp == w) & (rnd == r))[0]  # lanes in order
                o = own[at_r]
                first = np.zeros(len(at_r), dtype=np.int64)
                for q in range(len(at_r)):
                    first[q] = np.sum(o[:q] == o[q])
                rk[at_r] = cnt[w, o] + first
                np.add.at(cnt[w], o, 1)
        cnt = cnt[:, :n_dev]
        first_slot = np.cumsum(cnt, axis=0) - cnt  # warp_offsets
        tcount = cnt.sum(axis=0)
        gbase = _look_back(aggs, tile, visible) if tile else np.zeros(n_dev, dtype=np.int64)
        assert np.array_equal(gbase, [np.sum(own_all[:tile * P2_TILE] == o) for o in range(n_dev)])
        aggs.append((tcount, gbase + tcount))
        # staged starts: a room of ALIGN slots an owner, the run shifted to agree with its slots mod ALIGN
        room = tcount + P2_ALIGN
        p = np.cumsum(room) - room
        sstart = p + ((gbase - p) & (P2_ALIGN - 1))
        assert np.all(sstart + tcount <= p + room) and p[-1] + room[-1] <= P2_TILE + P2_ALIGN * n_dev
        real = own < n_dev
        pos = np.full(len(rows), -1, dtype=np.int64)
        pos[real] = sstart[own[real]] + first_slot[warp[real], own[real]] + rk[real]
        assert len(np.unique(pos[real])) == int(real.sum())  # one staged slot a row
        g0 = gbase
        g1 = np.minimum(gbase + tcount, bcap)
        for j, (lb, sz, off) in enumerate(zip(lbytes, sizes, offs)):
            V = 16 // sz
            staged = np.full((P2_TILE + P2_ALIGN * n_dev, sz), 0xEE, dtype=np.uint8)
            staged[pos[real]] = lb[rows[real]]
            units = 0
            for o in range(n_dev):
                if g1[o] <= g0[o]:
                    continue
                us = np.arange(g0[o] // V, -(-g1[o] // V))
                units += len(us)
                for u in us:
                    p0 = u * V
                    s0 = p0 - g0[o] + sstart[o]
                    assert (s0 - p0) % P2_ALIGN == 0 and (off + p0 * sz) % 16 == 0
                    slots = np.arange(p0, p0 + V)
                    keep = (slots >= g0[o]) & (slots < g1[o])
                    if keep.all():  # one 16-byte store
                        assert s0 >= 0
                    for k in np.nonzero(keep)[0]:
                        b = off + (p0 + k) * sz
                        send[o, b:b + sz] = staged[s0 + k]
                        writes[o, b:b + sz] += 1
            assert units <= P2_UCAPS[0 if sz == 8 else 1 if sz == 4 else 2]
        if tile == ntiles - 1:
            tot = gbase + tcount
    # the fill: every lane's 16-byte units from min(total, bcap)'s on, the first one past its rows only
    for sz, off in zip(sizes, offs):
        for o in range(n_dev):
            b0 = int(min(tot[o], bcap)) * sz
            end = _lane_bytes(bcap, sz)
            for u in range(b0 // 16, end // 16):
                lo = max(u * 16, b0)
                send[o, off + lo:off + (u + 1) * 16] = 0
                writes[o, off + lo:off + (u + 1) * 16] += 1
    send[:, at:] = 0
    writes[:, at:] += 1
    dropped = int(np.maximum(tot - bcap, 0).sum())
    return send.view(np.int64), dropped, writes


P2_CASES = [(2, "mixed", 3 * 2048 + 5), (3, "probe", 2 * 2048 + 1), (4, "i32", 5000), (8, "masked", 4097),
            (8, "skew", 3000), (64, "mixed", 4097), (64, "skew", 2049), (5, "wide", 2100), (4, "mixed", 700),
            (2, "mixed", 1)]


def _p2_args(n_dev, case, n):
    rng = np.random.default_rng(n_dev * 31 + n + len(case))
    return exchange_battery(rng, n, n_dev, case)


@pytest.mark.parametrize("n_dev,case,n", P2_CASES, ids=[f"d{d}_{c}_n{n}" for d, c, n in P2_CASES])
def test_p2_sweep_and_fill_model_is_the_plain_version(n_dev, case, n):
    n_dev, bcap, mask, keys, key_i32, probe, lanes = _p2_args(n_dev, case, n)
    send, dropped, writes = model_exchange(n_dev, bcap, mask, keys, key_i32, probe, lanes)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ws, wd = exchange_ref(n_dev, bcap, t(mask), [OwnerKey(t(d), t(v), lo, st) for d, v, lo, st in keys], key_i32,
                          probe, [t(x) for x in lanes])
    assert np.array_equal(send, ws.numpy()) and dropped == int(wd[0])
    assert writes.min() == 1 and writes.max() == 1  # every byte of the send buffer written exactly once
    assert (dropped > 0) == (case == "skew")
    if case == "wide":
        assert len(lanes) > 40 and sum(a.dtype.itemsize == 1 for a in lanes) % 2 == 1


def test_p2_look_back_at_any_visibility_gives_the_prefix():
    args = _p2_args(4, "mixed", 6 * 2048 + 7)
    want = model_exchange(*args)
    for visible in (lambda u: False, lambda u: True, lambda u: u % 2 == 0):
        got = model_exchange(*args, visible=visible)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_p2_owner_rule_is_the_plain_versions():
    """owner_of's int64 wrap, int32 truncation and probe rule, as the
    plain version's owner_key_ref computes them."""
    for case in ("mixed", "probe", "i32", "skew"):
        n_dev, bcap, mask, keys, key_i32, probe, lanes = _p2_args(5, case, 3000)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        okey = P2.owner_key_ref([OwnerKey(t(d), t(v), lo, st) for d, v, lo, st in keys], key_i32, probe, 3000)
        want = np.where(mask, np.remainder(okey.numpy(), n_dev), n_dev)
        assert np.array_equal(_owners(n_dev, mask, keys, key_i32, probe), want)


def test_p2_layout_aligns_every_lane():
    lanes = [torch.zeros(3, dtype=d) for d in (torch.bool, torch.float64, torch.int32, torch.bool, torch.int64)]
    for bcap in (1, 5, 17, 100):
        offs, words = layout(lanes, bcap)
        assert all(o % P2_ALIGN == 0 for o in offs) and words * 8 % P2_ALIGN == 0
        ends = sorted((o, o + _lane_bytes(bcap, t.element_size())) for o, t in zip(offs, lanes))
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:])) and ends[-1][1] <= words * 8
    assert layout([], 5) == ([], P2_ALIGN // 8)


# --- K1: the work split ------------------------------------------------------------------

K1_BLOCK = _constant("decode_lane.cu", "BLOCK")
K1_RPT = _constant("decode_lane.cu", "RPT")
K1_CH = _constant("decode_lane.cu", "CH")
K1_VOCAB = _constant("decode_lane.cu", "VOCAB_SMEM")


def _plan(words: list, ne: int) -> list:
    """csrc/decode_lane.cu's plan(): per entry (codec, code bytes, value
    bytes, src, aux, naux, base, out, rows, head, codes aligned, vocab in
    shared memory, first item), and the items in all."""
    ents, items = [], 0
    for i in range(ne):
        x = words[i * K1.WORDS:(i + 1) * K1.WORDS]
        codec, cb, vb = x[0] & 0xFF, (x[0] >> 8) & 0xFF, (x[0] >> 16) & 0xFF
        mis = x[5] & 15
        head = min(0 if mis == 0 else (16 - mis) // vb, x[6])
        aligned = codec != K1.RLE and (x[1] + head * cb) % 16 == 0
        smem = codec == K1.DICT and x[3] * vb <= K1_VOCAB and x[2] % 16 == 0
        ents.append(dict(codec=codec, cb=cb, vb=vb, src=x[1], aux=x[2], naux=x[3], base=x[4], out=x[5], rows=x[6],
                         head=head, aligned=aligned, smem=smem, item0=items))
        items += 0 if x[6] == 0 else 1 if x[6] <= head else -(-(x[6] - head) // K1_CH)
    return ents, items


def model_decode(encs: list, outs: list, rows: int, words: list, ne: int, grid: int = 7):
    """The one launch of csrc/decode_lane.cu over the entries `words`
    (built by the wrappers for `encs` into `outs`), each item's threads
    run in numpy: → each output's values and writes a row."""
    ents, items = _plan(words, ne)
    coded = [(e, o) for e, o in zip(encs, outs) if isinstance(e, dict) and e]
    assert len(coded) == ne
    vals = [np.full(rows, -1, dtype=np.int64) for _ in coded]  # value bits; -1: garbage
    writes = [np.zeros(rows, dtype=np.int64) for _ in coded]
    for ent, (enc, out) in zip(ents, coded):
        assert ent["out"] == out.data_ptr() and ent["rows"] == rows
    for b in range(grid):  # the blocks walk the items by a grid stride; the entry index only grows
        e = 0
        for item in range(b, items, grid):
            while e + 1 < ne and ents[e + 1]["item0"] <= item:
                e += 1
            ent, enc = ents[e], coded[e][0]
            c = item - ent["item0"]
            r0, r1 = ent["head"] + c * K1_CH, min(ent["head"] + (c + 1) * K1_CH, ent["rows"])
            V = 16 // ent["vb"]  # rows a 16-byte store
            for t in range(K1_BLOCK):
                if c == 0 and t < ent["head"]:  # a head row, one a thread
                    _decode_rows(ent, enc, [t], vals[e], writes[e])
                rows_t = []
                for step in range(K1_RPT * ent["vb"] // 16):  # a warp's step: 32 * V consecutive rows, 512 bytes of stores
                    r = r0 + step * K1_BLOCK * V + t * V
                    if r >= r1:
                        break
                    if r + V <= r1:  # one 16-byte store, one vector load of the codes
                        assert (ent["out"] + r * ent["vb"]) % 16 == 0
                        if ent["aligned"]:
                            assert (ent["src"] + r * ent["cb"]) % (V * ent["cb"]) == 0
                    rows_t += list(range(r, min(r + V, r1)))
                if rows_t:
                    _decode_rows(ent, enc, rows_t, vals[e], writes[e])
    return vals, writes


def _decode_rows(ent, enc, rows_t, vals, writes):
    """The kernel's values of rows `rows_t` (bits as int64): pack adds the
    base mod 2^W, dict gathers clamped, rle walks from its first row's run."""
    r = np.asarray(rows_t, dtype=np.int64)
    vb = ent["vb"]
    mask_w = np.uint64((1 << (8 * vb)) - 1)
    unsigned = lambda a: np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}" if a.dtype.itemsize > 1  # noqa: E731
                                                      else np.uint8).astype(np.uint64)
    if ent["codec"] == K1.RLE:
        ends = np.cumsum(enc["rl"].numpy().astype(np.int64))
        rv = enc["rv"].numpy()
        n = len(ends)
        j = int(np.searchsorted(ends, r[0], side="right"))  # the first row's run, by search
        out = []
        for q in r:  # then only forward (the kernel's steps doubling: the same run)
            assert np.all(np.diff(r) > 0)
            j += int(np.searchsorted(ends[j:], q, side="right"))
            out.append(min(j, n - 1))
        bits = unsigned(rv[np.array(out)])
    else:
        key = "p" if ent["codec"] == K1.PACK else "c"
        codes = enc[key].reshape(-1).numpy().view(f"u{ent['cb']}").astype(np.int64)[r]
        if ent["codec"] == K1.PACK:  # the add mod 2^W
            bits = (codes.astype(np.uint64) + np.uint64(ent["base"] % (1 << 64))) & mask_w
        else:  # the gather, a code past the vocab clamped
            bits = unsigned(enc["v"].numpy()[np.minimum(codes, ent["naux"] - 1)])
    vals[r] = (bits & mask_w).astype(np.int64)
    np.add.at(writes, r, 1)


def _bits_of(t: torch.Tensor) -> np.ndarray:
    a = t.reshape(-1).numpy()
    return a.view(f"u{a.dtype.itemsize}" if a.dtype.itemsize > 1 else np.uint8).astype(np.int64)


K1_SHAPES = [(1, 1000, 0), (3, 777, 3), (2, 4099, 1), (1, 5, 2)]


@pytest.mark.parametrize("t,r,shift", K1_SHAPES, ids=[f"{t}x{r}_s{s}" for t, r, s in K1_SHAPES])
def test_k1_work_split_model_is_the_plain_version(t, r, shift):
    """Several entries of mixed codecs in one launch (the solo mode's
    entries, as decode_lanes builds them), every row written once and equal
    to decode_lane_ref's bits."""
    rng = np.random.default_rng(t * 13 + r + shift)
    encs = chip_smoke._mixed_lanes("cpu", rng, t, r, shift)
    rv = torch.ones((t, r), dtype=torch.bool)
    outs = [torch.empty(rv.shape, dtype=K1.out_dtype(e)) if isinstance(e, dict) and e else None for e in encs]
    words, ne = [], 0
    for e, o in zip(encs, outs):
        if o is not None:
            words += K1.entry(e, o.data_ptr(), o.element_size(), t * r, torch.device("cpu"))
            ne += 1
    vals, writes = model_decode(encs, [o for o in outs if o is not None], t * r, words, ne)
    k = 0
    for e, o in zip(encs, outs):
        if o is None:
            continue
        assert writes[k].min() == 1 and writes[k].max() == 1
        assert np.array_equal(vals[k], _bits_of(decode_lane_ref(e, rv))), K1.codec(e)
        k += 1


def test_k1_task_entries_at_unaligned_rows_are_the_plain_version():
    """The task mode's entries: each task's row of a [G, width] output at
    an odd width (rows at any address: heads of 0-15 rows), codes at odd
    offsets, rle narrowed by its rows only."""
    rng = np.random.default_rng(5)
    G, t, w = 3, 2, 2 * 256 + 7
    rvs = [chip_smoke._task_row_valid("cpu", rng, t, 300, w) for _ in range(G)]
    per_task = [chip_smoke._mixed_lanes("cpu", rng, t, 300, 1) for _ in range(G)]
    lanes = [[task[k] for task in per_task] for k in range(len(per_task[0]))]
    outs, words, ne = GK.decode_lanes_tasks_prepare(lanes, rvs, w, torch.device("cpu"))
    ents, _ = _plan(words, ne)
    assert {e["head"] for e in ents} > {0} and not all(e["aligned"] for e in ents if e["codec"] != K1.RLE)
    at = 0
    for encs, out in zip(lanes, outs):
        if K1.codec(encs[0]) in ("dense", "alias"):
            continue
        for g, (e, o) in enumerate(zip(encs, out)):
            vals, writes = model_decode([GK.narrow_enc(e, w)], [o], w, words[at * K1.WORDS:(at + 1) * K1.WORDS], 1,
                                        grid=2)
            want = decode_lane_ref(GK.narrow_enc(e, w), rvs[g].reshape(-1)[:w])
            assert writes[0].min() == 1 and writes[0].max() == 1
            assert np.array_equal(vals[0], _bits_of(want)), (K1.codec(e), g)
            at += 1
    assert at == ne


def test_k1_model_is_the_reference_decode():
    """The model over payloads of the reference's own encoder (pack, dict,
    rle, an rle valid lane) in one launch, against the reference's jitted
    TPUEngine._decode_lane, bit for bit."""
    from tidb_tpu.copr.tilecache import encode_data_lane, encode_valid_lane
    from tidb_tpu_torch.copr.gpu_engine import _upload_payload

    rng = np.random.default_rng(3)
    shape, n = (1, 8192), 8000
    lanes = [rng.integers(1000, 1200, n), rng.choice(np.array([-10**15, 3, 7, 10**15]), n),
             np.repeat(rng.integers(-10**14, 10**14, 4), n // 4 + 1)[:n], rng.integers(0, 3_000_000_000, n) - 10**11]
    pays = [encode_data_lane(d, np.ones(n, dtype=bool), shape)[0] for d in lanes]
    pays.append(encode_valid_lane(np.repeat([True, False, True], [2000, 1000, 5000]), shape)[0])
    assert all(p for p in pays)
    rv = np.zeros(shape, dtype=bool)
    rv[0, :n] = True
    encs = [_upload_payload(p, torch.device("cpu")) for p in pays]
    outs = [torch.empty(shape, dtype=K1.out_dtype(e)) for e in encs]
    words = [x for e, o in zip(encs, outs) for x in K1.entry(e, o.data_ptr(), o.element_size(), shape[1],
                                                             torch.device("cpu"))]
    vals, writes = model_decode(encs, outs, shape[1], words, len(encs))
    for p, v, wr in zip(pays, vals, writes):
        want = np.asarray(jnp.asarray(ref_engine.TPUEngine._decode_lane({k: jnp.asarray(x) for k, x in p.items()},
                                                                        jnp.asarray(rv)))).reshape(-1)
        assert wr.min() == 1 and wr.max() == 1
        assert np.array_equal(v[:n], want.view(f"u{want.dtype.itemsize}" if want.dtype.itemsize > 1 else np.uint8)
                              .astype(np.int64)[:n])


# --- the wrappers on the CPU, the batteries, the constants --------------------------------


def test_many_lane_wrappers_equal_their_plain_versions_lane_by_lane():
    rng = np.random.default_rng(9)
    rv = torch.ones((2, 700), dtype=torch.bool)
    encs = chip_smoke._mixed_lanes("cpu", rng, 2, 700, 3)
    got = decode_lanes(encs, rv)
    for g, e in zip(got, encs):
        assert torch.equal(g, decode_lane_ref(e, rv))
    rvs = [chip_smoke._task_row_valid("cpu", rng, 1, 1024, 1001) for _ in range(3)]
    per_task = [chip_smoke._mixed_lanes("cpu", rng, 1, 1024) for _ in range(3)]
    lanes = [[task[k] for task in per_task] for k in range(len(per_task[0]))]
    got, want = decode_lanes_tasks(lanes, rvs, 1001), decode_lanes_tasks_ref(lanes, rvs, 1001)
    for gl, wl in zip(got, want):
        for g, w in zip(gl, wl):
            assert torch.equal(g.reshape(-1)[:1001], w.reshape(-1)[:1001])
    assert K1.decode_lane.launches == 0 and GK.decode_lane_tasks.launches == 0


def test_chip_smokes_many_lane_batteries_hold_on_the_cpu():
    cases = chip_smoke.decode_many_cases("cpu", np.random.default_rng(1))
    assert {name.split()[0] for name, _ in cases} == {"decode_lane", "decode_lane_tasks"}
    for name, fn in cases:
        fn()
    assert any("many 594 lanes" in name for name, _ in cases)  # past the by-value tiers


def test_engine_decodes_every_lane_of_a_call_at_once(monkeypatch):
    """_decode and _decode_tasks hand all their lanes to one many-lane call."""
    from tidb_tpu_torch.copr import gpu_engine
    from tidb_tpu_torch.entry import batch_from_numpy, run_many, run_query
    from tidb_tpu_torch.models import tpch

    seen = {"solo": [], "tasks": []}
    real_solo, real_tasks = gpu_engine.decode_lanes, gpu_engine.decode_lanes_tasks
    monkeypatch.setattr(gpu_engine, "decode_lanes", lambda e, rv: seen["solo"].append(len(e)) or real_solo(e, rv))
    monkeypatch.setattr(gpu_engine, "decode_lanes_tasks",
                        lambda l, r, w: seen["tasks"].append(len(l)) or real_tasks(l, r, w))
    li = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(5000, 3))
    run_query(tpch.q1_dag(), li, device="cpu")
    run_many([(tpch.q1_dag(), r) for r in tpch.region_batches(li, 1536)], "cpu")
    assert seen["solo"] and all(k >= 14 for k in seen["solo"])  # Q1's seven columns, data and valid, in one call
    assert seen["tasks"] and all(k >= 14 for k in seen["tasks"])


def test_constants_match_the_sources():
    assert P2_TILE == P2_BLOCK * P2_ITEMS == _constant("compact.cuh", "TILE")
    assert _constant("exchange.cu", "MAX_DEV") == P2.MAX_DEV and _constant("exchange.cu", "MAXK") == P2.MAX_KEYS
    assert P2_ALIGN == P2.ALIGN
    assert P2_UCAPS == [P2_TILE // v + 2 * P2.MAX_DEV for v in (2, 4, 16)]
    assert "return MAX_DEV + compact::scratch_words(compact::tiles(n) * n_dev);" in (CSRC / "exchange.cu").read_text()
    assert K1_CH == K1_BLOCK * K1_RPT and K1_RPT == chip_smoke.DECODE_RPT
    assert K1_VOCAB == chip_smoke.DECODE_VOCAB_SMEM
    assert _constant("decode_lane.cu", "WORDS") == K1.WORDS
    text = (CSRC / "decode_lane.cu").read_text()
    assert re.search(r"enum \{ PACK = (\d), DICT = (\d), RLE = (\d) \};", text).groups() == tuple(
        str(x) for x in (K1.PACK, K1.DICT, K1.RLE))
    # the big-vocab battery case is past shared memory
    big = [e for name, e, _ in chip_smoke.decode_cases("cpu", np.random.default_rng(0), 1, 64) if name.endswith("big")]
    assert big and big[0]["v"].numel() * big[0]["v"].element_size() > K1_VOCAB
    # partition.cuh is M3's and P2's one copy of the ranking and the per-owner look-back
    for src in ("exchange.cu", "hash_repartition.cu"):
        body = (CSRC / src).read_text()
        assert '#include "partition.cuh"' in body and "part::rank_rows(" in body and "part::look_back_owners(" in body
        assert "__ballot_sync(FULL, (o[r] >> b) & 1)" not in body


def test_the_p2_wrapper_zeroes_nothing_and_builds_no_array():
    src = inspect.getsource(P2.exchange)
    assert "torch.zeros" not in src and src.count("torch.empty") == 1 and "stream_scratch(" in src
    assert "np.array" not in src and "sm_count(" in src
    assert "cudaMemset" not in (CSRC / "exchange.cu").read_text()
    assert "cudaMemset" not in (CSRC / "decode_lane.cu").read_text()


def test_cpu_wrappers_take_their_plain_versions():
    n_dev, bcap, mask, keys, key_i32, probe, lanes = _p2_args(3, "probe", 3000)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = (n_dev, bcap, t(mask), [OwnerKey(t(d), t(v), lo, st) for d, v, lo, st in keys], key_i32, probe,
            [t(x) for x in lanes])
    (gs, gd), (ws, wd) = exchange(*args), exchange_ref(*args)
    assert torch.equal(gs, ws) and torch.equal(gd, wd) and P2.exchange.launches == 0


@pytest.mark.parametrize("script,args", [("mpp_profile.py", ["--only", "p2"]), ("mpp_profile.py", ["--only", "k1"]),
                                         ("mesh_stress.py", ["--query", "q3_unfused", "--iters", "1"])])
def test_profile_modes_without_a_card_exit_non_zero(script, args):
    out = subprocess.run([sys.executable, str(ROOT / script), *args], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
