"""W1's sorted-order design (csrc/window.cu) as a numpy model, held to the
plain version and to the reference on the CPU.

The model runs the plan `kernels/window.plan` makes for the kernels — the
same gathered lanes, scans, sparse-table levels, function table and record
slots — with numpy standing in for each launch:

* the sweep: the sort words gathered through perm once, each row compared
  with the row before, the (partition start, peer start) counts scanned
  tile by tile with a carry from the tiles before (the look-back's sum),
  each start's row recorded at ppos[pid] / opos[peer id], P after the
  last; the inverse permutation; every argument lane and the RANGE key's
  search lane gathered into sorted order once;
* one scan a lane: (count, sum) pairs, counts, segmented min / max prefix
  or suffix;
* the functions over the sorted rows from the boundaries, into records;
* one pass in input order through inv, writing every output lane.

Its lanes must equal `window_ref`'s (ints and valids bit for bit, floats
within rtol 1e-9 / atol 1e-6, NaN in the same rows) on chip_smoke.py's
batteries — the random battery ASC and DESC, and the sorted-order edges
(`window_edge_battery`: one partition of all rows, single-row partitions,
partitions and peer groups crossing tile edges, LAG / LEAD offsets past a
tile, ROWS frames wider than a direct pass and wider than a tile, P below a
tile) — and, put in W1's place under the port's run_device_window, answer
as the reference's window program does.
"""

import importlib

import numpy as np
import pytest
import torch
from chip_smoke import _same_outs, win_lanes, window_battery, window_edge_battery
from test_torch_window import same_results

from tidb_tpu.executor import window_device as ref_wd

from tidb_tpu_torch.executor import window_device as wd
from tidb_tpu_torch.expr.xp_torch import U64
from tidb_tpu_torch.kernels import window_ref
from tidb_tpu_torch.kernels.lex_sort import lex_sort_perm_ref

W = importlib.import_module("tidb_tpu_torch.kernels.window")  # the package re-exports the wrapper's name

TILE = 2048
LL_MAX = (1 << 63) - 1
LL_MIN = -(1 << 63)
UP, PRE, CUR, FOL, UF = range(5)


def _np(t):
    return (t.bits if isinstance(t, U64) else t).numpy()


def _typed(bits: np.ndarray, mm: int) -> np.ndarray:
    return bits.view([np.int64, np.uint64, np.float64][mm])


def _fill(mm: int, is_max: int):
    if mm == W._MM_F64:
        return -np.inf if is_max else np.inf
    if mm == W._MM_U64:
        return np.uint64(0) if is_max else np.uint64((1 << 64) - 1)
    return np.int64(LL_MIN if is_max else LL_MAX)


def _pick(a, b, is_max: int):
    """jnp.maximum / jnp.minimum: NaN propagates."""
    out = np.maximum(a, b) if is_max else np.minimum(a, b)
    if a.dtype == np.float64:
        out = np.where(np.isnan(a), a, np.where(np.isnan(b), b, out))
    return out


def _masked(gd, gv, mm, is_max):
    return np.where(gv, _typed(gd, mm), _fill(mm, is_max))


def model_window(words, fargs, spec, range_key, perm: np.ndarray) -> list:
    """W1 by csrc/window.cu's plan, each launch in numpy (module doc)."""
    npw = spec[0]
    P = words[0].shape[0]
    pl = W.plan(fargs, spec, range_key, P, torch.device("cpu"))
    # the sweep: boundaries by one scan with a tile carry
    pflag, oflag = np.zeros(P, bool), np.zeros(P, bool)
    for q, w in enumerate(words):
        s = w.numpy().astype(np.int64)[perm]
        d = np.concatenate([[True], s[1:] != s[:-1]])
        oflag |= d
        if q < npw:
            pflag |= d
    pcs, ocs, carry = np.empty(P, np.int64), np.empty(P, np.int64), (0, 0)
    for t0 in range(0, P, TILE):
        pcs[t0:t0 + TILE] = carry[0] + np.cumsum(pflag[t0:t0 + TILE])
        ocs[t0:t0 + TILE] = carry[1] + np.cumsum(oflag[t0:t0 + TILE])
        carry = (pcs[min(t0 + TILE, P) - 1], ocs[min(t0 + TILE, P) - 1])
    pid, oid = pcs - 1, ocs - 1
    ppos, opos = np.empty(P + 1, np.int64), np.empty(P + 1, np.int64)
    ppos[pid[pflag]], opos[oid[oflag]] = np.flatnonzero(pflag), np.flatnonzero(oflag)
    ppos[pid[-1] + 1], opos[oid[-1] + 1] = P, P
    inv = np.empty(P, np.int64)
    inv[perm] = np.arange(P)
    with np.errstate(over="ignore"):
        for mode, d, v, gd, gv, gmin, gmax, desc in pl.gathers:
            vs = v.numpy()[perm]
            if mode == 0:
                _np(gd)[:] = _np(d).view(np.int64)[perm]
            if mode != 2:
                gv.numpy()[:] = vs
            else:
                k = d.numpy()[perm]
                gd.numpy()[:] = np.where(vs, (gmax - k) if desc else (k - gmin), LL_MAX if desc else -1)
        # one scan a lane
        for kind, gd, gv, cnt, out in pl.scans:
            g = gv.numpy()
            if cnt is not None:
                cnt.numpy()[:] = np.cumsum(g)
            if kind == W._S_PAIR_I64:
                out.numpy()[:] = np.cumsum(np.where(g, gd.numpy(), 0))
            elif kind == W._S_PAIR_F64:
                out.numpy().view(np.float64)[:] = np.cumsum(np.where(g, gd.numpy().view(np.float64), 0.0))
            elif kind >= W._S_SEG:
                m = kind - W._S_SEG
                mm, is_max, rev = m >> 2, (m >> 1) & 1, m & 1
                x = _masked(gd.numpy(), g, mm, is_max)
                acc = np.empty_like(x)
                op = np.maximum if is_max else np.minimum
                for p in range(pid[-1] + 1):
                    a, b = ppos[p], ppos[p + 1]
                    part = x[a:b][::-1] if rev else x[a:b]
                    r = op.accumulate(part)
                    acc[a:b] = r[::-1] if rev else r
                out.numpy()[:] = acc.view(np.int64)
        for mm, is_max, gd, gv, L, lvs in pl.tables:
            prev = _masked(gd.numpy(), gv.numpy(), mm, is_max)
            for k in range(1, L):
                h = 1 << (k - 1)
                nxt = _pick(prev, np.concatenate([prev[h:], np.full(min(h, P), _fill(mm, is_max), prev.dtype)])[:P],
                            is_max)
                lvs[k - 1].numpy()[:] = nxt.view(np.int64)
                prev = nxt
        rec = np.zeros((P, pl.stride), np.int64)
        recb = rec.view(np.uint8).reshape(P, 8 * pl.stride)
        i = np.arange(P)
        pf, pend, qf, ql = ppos[pid], ppos[pid + 1] - 1, opos[oid], opos[oid + 1] - 1
        rk = None if pl.rk is None else pl.rk.numpy()
        for row in pl.funcs:
            x, y, ok = _model_func(row, pl, i, pid, oid, pf, pend, qf, ql, rk, P)
            rec[:, row["a_slot"]] = x
            if row["b_kind"] == W._B_BYTE:
                recb[:, row["b_slot"]] = ok
            elif row["b_kind"] == W._B_WORD:
                rec[:, row["b_slot"]] = y
    # one pass in input order through inv
    for o, kind, slot in pl.out_rows:
        dst = _np(o)
        if kind == W._OUT_WORD:
            dst.view(np.int64)[:] = rec[inv, slot]
        elif kind == W._OUT_BYTE:
            dst[:] = recb[inv, slot].astype(bool)
        else:
            dst[:] = True
    return pl.outs


def _frame(row, i, pf, pend, qf, ql, rk):
    if not row["has_frame"]:
        return pf, ql, np.ones(len(i), bool)
    rows = row["rows"]

    def bound(kind, off, cur):
        if kind == UP:
            return pf.copy()
        if kind == UF:
            return pend.copy()
        if kind == CUR or not rows:
            return cur.copy()
        return i - off if kind == PRE else i + off

    fs = bound(row["sk"], row["so"], i if rows else qf)
    fe = bound(row["ek"], row["eo"], i if rows else ql)
    if row["use_range"]:
        desc = row["desc"]
        for a in np.unique(pf):  # each partition's rows: a binary search of its own keys
            b = pend[a] + 1
            keys = rk[a:b]
            vf, vl = (a, a + np.searchsorted(keys, LL_MAX) - 1) if desc else (a + np.searchsorted(keys, 0), b - 1)
            sub = rk[vf:vl + 1]
            for r in range(a, b):
                key = rk[r]
                if (key == LL_MAX) if desc else (key < 0):
                    continue  # NULL-key rows keep their peer block
                if row["sk"] in (PRE, FOL):
                    fs[r] = vf + np.searchsorted(sub, key + row["so"] if row["sk"] == FOL else key - row["so"], "left")
                if row["ek"] in (PRE, FOL):
                    fe[r] = vf + np.searchsorted(sub, key + row["eo"] if row["ek"] == FOL else key - row["eo"],
                                                 "right") - 1
    ne = (fs <= fe) & (fs <= pend) & (fe >= pf)
    return np.minimum(np.maximum(fs, pf), pend), np.minimum(np.maximum(fe, pf), pend), ne


def _count(cnt, s, e, ne):
    if cnt is None:
        return np.where(ne, e - s + 1, 0)
    c = cnt.numpy().astype(np.int64)
    return np.where(ne, c[e] - np.where(s > 0, c[np.maximum(s - 1, 0)], 0), 0)


def _model_func(row, pl, i, pid, oid, pf, pend, qf, ql, rk, P):
    code, sub = row["code"], row["sub"]
    zeros = np.zeros(P, np.int64)
    gd = None if row["gd"] is None else row["gd"].numpy()
    gv = None if row["gv"] is None else row["gv"].numpy()
    if code == W._F_RANK:
        psize, rn = pend - pf + 1, i - pf
        if sub == 3:
            k = row["k"]
            big, rem = psize // k, psize % k
            cut = rem * (big + 1)
            x = np.where(big > 0, np.where(rn < cut, rn // (big + 1), rem + (rn - cut) // np.maximum(big, 1)), rn) + 1
            return x, zeros, None
        return ({0: rn + 1, 1: qf - pf + 1, 2: oid - oid[pf] + 1, 4: ql - pf + 1, 5: qf - pf}[sub],
                {4: psize, 5: psize - 1}.get(sub, zeros), None)
    if code == W._F_SHIFT:
        tg = i + row["k"]
        tc = np.clip(tg, 0, P - 1)
        hit = (tg >= 0) & (tg < P) & (pid[tc] == pid)
        dd = zeros if row["dd"] is None else row["dd"].numpy()
        dv = np.zeros(P, bool) if row["dv"] is None else row["dv"].numpy()
        return np.where(hit, gd[tc], dd), zeros, np.where(hit, gv[tc], dv)
    s, e, ne = _frame(row, i, pf, pend, qf, ql, rk)
    if code == W._F_VALUE:
        if sub == 2:
            pos = s + row["k"] - 1
            ok = ne & (pos <= e)
            pos = np.clip(pos, 0, P - 1)
        else:
            pos, ok = (s if sub == 0 else e), ne
        return gd[pos], zeros, gv[pos] & ok
    if code == W._F_COUNT:
        return _count(row["cnt"], s, e, ne), zeros, None
    if code == W._F_SUM:
        c = _count(row["cnt"], s, e, ne)
        cs = row["sum"].numpy()
        if sub & 1:
            f = cs.view(np.float64)
            x = (f[e] - np.where(s > 0, f[np.maximum(s - 1, 0)], 0.0)).view(np.int64)
        else:
            x = cs[e] - np.where(s > 0, cs[np.maximum(s - 1, 0)], 0)
        return np.where(ne, x, 0), c, c > 0
    mm, is_max, mode = row["mm_type"], row["is_max"], row["mm_mode"]
    if mode in (W._MODE_PREFIX, W._MODE_SUFFIX):
        acc = row["acc"].numpy()
        return acc[e if mode == W._MODE_PREFIX else s], zeros, _count(row["cnt"], s, e, ne) > 0
    x = _masked(gd, gv, mm, is_max)
    if mode == W._MODE_LOOP:
        r, c = x[s].copy(), gv[s].astype(np.int64)
        for d in range(1, W.LOOP_WIDTH + 1):
            y = s + d
            on = y <= e
            yc = np.minimum(y, P - 1)
            r = np.where(on, _pick(r, x[yc], is_max), r)
            c += on & gv[yc]
        back = e < s
        r = np.where(back, _pick(x[s], x[e], is_max), r)
        return r.view(np.int64), zeros, ne & (c > 0)
    levels = [x] + [_typed(t.numpy(), mm) for t in pl.levels[row["lv0"]:row["lv0"] + row["L"] - 1]]
    w = np.maximum(e - s + 1, 1)
    lk = np.minimum(np.floor(np.log2(w)).astype(np.int64), row["L"] - 1)
    e2 = np.maximum(e - (1 << lk) + 1, 0)
    stk = np.stack(levels)
    r = _pick(stk[lk, s], stk[lk, e2], is_max)
    return r.view(np.int64), zeros, _count(row["cnt"], s, e, ne) > 0


def _inputs(part, order, fspecs, n, range_lane):
    words, fargs, npw, now, rdev = wd.prepare(part, order, fspecs, n, torch.device("cpu"), range_lane)
    spec = (npw, now, tuple(f["static"] for f in fspecs), tuple(f.get("frame") for f in fspecs))
    return list(words), fargs, spec, rdev


def _model_and_plain(words, fargs, spec, rk):
    perm = lex_sort_perm_ref(W._words_ops(words)).numpy().astype(np.int64)
    return model_window(words, fargs, spec, rk, perm), window_ref(words, fargs, spec, rk)


EDGES = window_edge_battery(np.random.default_rng(11))


@pytest.mark.parametrize("case", range(len(EDGES)), ids=[c[0] for c in EDGES])
def test_model_equals_the_plain_version_at_the_edges(case):
    name, part, order, fspecs, n, rl = EDGES[case]
    words, fargs, spec, rk = _inputs(part, order, fspecs, n, rl)
    got, want = _model_and_plain(words, fargs, spec, rk)
    _same_outs(got, want, f"model {name}")
    assert W.window.launches == 0


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
def test_model_equals_the_plain_version_on_the_random_battery(desc):
    n = 5000
    part, order, fspecs, rl = window_battery(win_lanes(np.random.default_rng(21 + desc), n), desc)
    words, fargs, spec, rk = _inputs(part, order, fspecs, n, rl)
    got, want = _model_and_plain(words, fargs, spec, rk)
    _same_outs(got, want, "model battery")


@pytest.mark.parametrize("case", range(len(EDGES)), ids=[c[0] for c in EDGES])
def test_model_in_w1s_place_answers_as_the_reference(case, monkeypatch):
    name, part, order, fspecs, n, rl = EDGES[case]

    def model(words, fargs, spec, range_key=None, phase=None):
        perm = lex_sort_perm_ref(W._words_ops(words)).numpy().astype(np.int64)
        return model_window(words, fargs, spec, range_key, perm)

    monkeypatch.setattr(wd, "window", model)
    got = wd.run_device_window(part, order, fspecs, n, device="cpu", range_lane=rl)
    want = ref_wd.run_device_window(part, order, fspecs, n, range_lane=rl)
    same_results(got, want, f"model {name}")


def test_the_plan_gathers_each_lane_once_and_packs_the_records():
    """The main path's rank_frames spec: three argument lanes and the RANGE
    key gathered once each; one (count, sum) scan; the ROWS max read
    directly; records of 6 words (5 values, 3 valid bytes)."""
    n = 3000
    L = win_lanes(np.random.default_rng(5), n)
    o = L["o"]
    pres = o[0][o[1]]
    f = [{"name": "row_number", "static": ("row_number",), "args": [], "post": None, "frame": None},
         {"name": "rank", "static": ("rank",), "args": [], "post": None, "frame": None},
         {"name": "lag", "static": ("lag", 1, False), "args": [L["i"]], "post": None, "frame": None},
         {"name": "max", "static": ("max",), "args": [L["i"]], "post": None, "frame": ("rows", "pre", 3, "fol", 3)},
         {"name": "sum", "static": ("sum", True), "args": [L["f"]], "post": None,
          "frame": ("range", "pre", 1000, "cur", 0, False)}]
    words, fargs, spec, rk = _inputs([L["g"]], [(o, False)], f, n, (o[0], o[1], int(pres.min()), int(pres.max())))
    pl = W.plan(fargs, spec, rk, words[0].shape[0], torch.device("cpu"))
    assert [g[0] for g in pl.gathers] == [2, 0, 0]  # the RANGE key, lane i for LAG and MAX, lane f
    assert [s[0] for s in pl.scans] == [W._S_PAIR_F64]
    assert pl.funcs[3]["mm_mode"] == W._MODE_LOOP and not pl.tables
    assert pl.stride == 6
    kinds = [k for _, k, _ in pl.out_rows]
    assert kinds == [W._OUT_WORD, W._OUT_ONE] * 2 + [W._OUT_WORD, W._OUT_BYTE] * 3
