"""W1: every window function of one (PARTITION BY, ORDER BY) spec.

Replaces tidb_tpu/executor/window_device.py:154-442 (_build_kernel's
kernel). For P rows (a power of two, at least 1024) it takes

  * words    — the packed int32/int64 sort words, partition words first
               (executor/window_device._pack_words; pad rows carry a
               sentinel above every real code, so they sort last and form
               their own partition);
  * fargs    — per function its (data, valid) argument lanes: int64,
               float64 or xp_torch.U64 (uint64 as int64 bit patterns) data,
               bool valid;
  * spec     — (n_pwords, n_owords, funcspecs, framespecs), the
               reference's static kernel key;
  * range_key — (data, valid, gmin, gmax) of the single ORDER BY key when
               a RANGE offset frame is present (gmin/gmax Python ints).

and returns, per function, its one or two output lanes in INPUT row order,
in the order pack_flat takes them (the reference's :436-440):

  row_number, rank, dense_rank, ntile, count   (int64, bool all-true)
  cume_dist                                    (frame rows, partition size)
  percent_rank                                 (rank - 1, partition size - 1)
  lead, lag, first/last/nth_value, min, max    (argument kind, bool)
  sum                                          (argument kind, bool)
  avg                                          (sum of the argument kind, int64 count)

The CUDA kernels are csrc/window.cu; `window` drives them:

  1. K8 (kernels/lex_sort) over the words → perm (int32)       "sort"
  2. `plan` lays out the call: every argument lane (and the RANGE key's
     search lane) to gather once, the prefix scans over them, the sparse
     tables, each function's row of the kernel's table, the record of a
     sorted row and the output lanes                          "window"
  3. gather passes through perm (the sort words; the lanes' data; their
     valid bytes; the inverse permutation), each with a footprint L2
     serves; one look-back sweep of the sorted words gives pid and peer
     id, and each partition's and peer group's first row
  4. one look-back sweep for each prefix scan: (count, sum) — int64 sums
     wrap in two's complement, as the reference's — a count, or the
     segmented min / max of a growing or shrinking frame
  5. every function over the sorted rows into one record a row: frames
     clipped to the partition, RANGE offsets searched in the row's own
     partition, min / max of a ROWS frame of at most LOOP_WIDTH rows read
     directly, wider ones from a sparse table; NaN propagates as
     jnp.minimum / maximum propagate it
  6. one pass in input order: row j reads its record at inv[j] and writes
     every output lane, coalesced

`window_sorted` is steps 2-6 alone, given perm: W1's time apart from K8.

`window_ref` is the plain PyTorch version beside it, the reference's own
recipe step for step (torch.cummax/cummin/cumsum, torch.searchsorted over
the partition-composite key, a gather per function); it sorts with K8's
plain version. `window` takes the plain version only for tensors on the
CPU. On a CUDA device it launches the kernels or raises;
`window.launches` counts its calls that launched.
"""

from __future__ import annotations

import ctypes
from contextlib import nullcontext
from typing import NamedTuple

import numpy as np
import torch

from ..expr.xp_torch import U64
from .build import count, library
from .lex_sort import SortOp, lex_sort_perm, lex_sort_perm_ref
from .tables import stream_scratch

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
MAX_WORDS = 64  # sort words the bounds kernel takes (csrc/window.cu MAXW)


def frame_width(frkey) -> int:
    """Static max width of a both-bounded ROWS frame key; <=0 == always
    empty (the sparse table of a min/max has bit_length of it levels)."""
    shift = {"pre": -1, "cur": 0, "fol": 1}
    _, sk, so, ek, eo = frkey[:5]
    return (shift[ek] * eo if ek in shift else 0) - (shift[sk] * so if sk in shift else 0) + 1


def _words_ops(words) -> list[SortOp]:
    ops = []
    for w in words:
        if w.dtype == torch.int32:
            ops.append(SortOp(w, "i32"))
        elif w.dtype == torch.int64:
            ops.append(SortOp(w, "i64"))
        else:
            raise TypeError(f"window: sort words are int32/int64, got {w.dtype}")
    return ops


def _check(words, fargs, spec, range_key) -> int:
    npw, now, funcspecs, framespecs = spec
    if not words or len(words) != npw + now or npw < 1:
        raise ValueError(f"window: {len(words)} sort words for {npw} partition + {now} order words")
    P = words[0].shape[0]
    if P < 1 or P & (P - 1):
        raise ValueError(f"window: P = {P} is not a power of two")
    if len(funcspecs) != len(framespecs) or len(fargs) != len(funcspecs):
        raise ValueError("window: funcspecs, framespecs and fargs differ in length")
    for fs in funcspecs:
        if fs[0] == "ntile" and fs[1] < 1:
            raise ValueError(f"window: NTILE bucket count {fs[1]} < 1")
    for fa in fargs:
        for d, v in fa:
            t = d.bits if isinstance(d, U64) else d
            if t.dtype not in (torch.int64, torch.float64) or t.shape != (P,):
                raise TypeError(f"window: argument data must be int64/float64/U64 [{P}], "
                                f"got {t.dtype} {tuple(t.shape)}")
            if v.dtype != torch.bool or v.shape != (P,):
                raise TypeError(f"window: argument valid must be bool [{P}]")
    for fr in framespecs:
        if fr is not None and fr[0] == "range" and len(fr) > 5 and range_key is None:
            raise ValueError("window: a RANGE offset frame needs the range key lane")
    return P


# --- the plain version -------------------------------------------------------


def _minmax_kind(d):
    """(ordered int64/float64 lane, kind) where kind is 'f', 'i' or 'u':
    uint64 bits are xor 2^63 so signed order is their unsigned order."""
    if isinstance(d, U64):
        return d.bits ^ _I64_MIN, "u"
    return d, "f" if d.dtype == torch.float64 else "i"


def _seg_scan(flags, vals, op):
    """Inclusive segmented scan of `op` (flags start a segment): the
    reference's associative_scan over (flag, value) pairs, as log2(P)
    doubling steps."""
    f, v = flags.clone(), vals.clone()
    P, d = v.shape[0], 1
    while d < P:
        nv, nf = v.clone(), f.clone()
        nv[d:] = torch.where(f[d:], v[d:], op(v[:-d], v[d:]))
        nf[d:] = f[d:] | f[:-d]
        v, f = nv, nf
        d <<= 1
    return v


def window_ref(words, fargs, spec, range_key=None, phase=None) -> list:
    """Plain PyTorch version of W1 (module doc)."""
    phase = phase or (lambda name: nullcontext())
    P = _check(words, fargs, spec, range_key)
    npw, now, funcspecs, framespecs = spec
    dev = words[0].device
    i64 = torch.int64
    iota = torch.arange(P, dtype=i64, device=dev)
    with phase("sort"):
        perm = lex_sort_perm_ref(_words_ops(words)).to(i64)
    with phase("window"):
        return _ref_body(words, fargs, funcspecs, framespecs, range_key, perm, iota, npw, now, P)


def _ref_body(words, fargs, funcspecs, framespecs, range_key, perm, iota, npw, now, P):
    dev, i64 = iota.device, torch.int64
    s_ops = [w[perm] for w in words]

    def chg(idxs):
        c = torch.zeros(P, dtype=torch.bool, device=dev)
        for i in idxs:
            c[1:] |= s_ops[i][1:] != s_ops[i][:-1]
        c[0] = True
        return c

    pstart = chg(range(npw))
    ostart = chg(range(npw + now))
    zero = torch.zeros((), dtype=i64, device=dev)
    pfirst = torch.cummax(torch.where(pstart, iota, zero), 0).values
    peer_first = torch.cummax(torch.where(ostart, iota, zero), 0).values

    def seg_last(starts):
        nxt = torch.cat([torch.where(starts, iota, torch.full((), P, dtype=i64, device=dev))[1:],
                         torch.full((1,), P, dtype=i64, device=dev)])
        return torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0]) - 1

    plast = seg_last(pstart)
    peer_last = seg_last(ostart)
    fe_default = peer_last
    pid = torch.cumsum(pstart.to(i64), 0) - 1
    psize = plast - pfirst + 1
    rn = iota - pfirst
    ones = torch.ones(P, dtype=torch.bool, device=dev)

    def scat(x):
        if isinstance(x, U64):
            return U64(scat(x.bits))
        out = torch.empty_like(x)
        out[perm] = x
        return out

    def gather(x, idx):
        return U64(x.bits[idx]) if isinstance(x, U64) else x[idx]

    def where(c, a, b):
        if isinstance(a, U64):
            return U64(torch.where(c, a.bits, b.bits))
        return torch.where(c, a, b)

    def range_offset_bounds(sk, so, ek, eo, desc):
        kd, kv, gmin, gmax = range_key
        S = (gmax - gmin) + 2 * max(abs(so), abs(eo), 1) + 4
        ks, kvs = kd[perm].to(i64), kv[perm]
        kk = (gmax - ks) if desc else (ks - gmin)
        sent = (S - 1) if desc else -1
        comp = pid * S + torch.where(kvs, kk, torch.full((), sent, dtype=i64, device=dev))
        cinv = torch.cumsum((~kvs).to(i64), 0)
        before = torch.where(pfirst > 0, cinv[torch.clamp(pfirst - 1, min=0)], zero)
        ninv = cinv[plast] - before
        vfirst = pfirst + (ninv if not desc else 0)
        vlast = plast - (ninv if desc else 0)

        def search(off, kind, side):
            tgt = comp + (off if kind == "fol" else -off)
            return torch.searchsorted(comp, tgt, side=side).to(i64)

        def clip(x, lo, hi):  # jnp.clip
            return torch.minimum(torch.maximum(x, lo), hi)

        fs_r = clip(search(so, sk, "left"), vfirst, vlast + 1) if sk in ("pre", "fol") else None
        fe_r = clip(search(eo, ek, "right") - 1, vfirst - 1, vlast) if ek in ("pre", "fol") else None
        return fs_r, fe_r, kvs

    def frame_of(frkey):
        if frkey is None:
            return pfirst, fe_default, ones
        unit, sk, so, ek, eo = frkey[:5]
        cur_s = iota if unit == "rows" else peer_first
        cur_e = iota if unit == "rows" else peer_last

        def pos(kind, off, cur):
            if kind == "up":
                return pfirst
            if kind == "uf":
                return plast
            if kind == "cur" or unit == "range":
                return cur
            return iota - off if kind == "pre" else iota + off

        fs_raw = pos(sk, so, cur_s)
        fe_raw = pos(ek, eo, cur_e)
        if unit == "range" and len(frkey) > 5 and (sk in ("pre", "fol") or ek in ("pre", "fol")):
            fs_r, fe_r, kvs = range_offset_bounds(sk, so, ek, eo, frkey[5])
            if fs_r is not None:
                fs_raw = torch.where(kvs, fs_r, fs_raw)
            if fe_r is not None:
                fe_raw = torch.where(kvs, fe_r, fe_raw)
        ne = (fs_raw <= fe_raw) & (fs_raw <= plast) & (fe_raw >= pfirst)
        return torch.minimum(torch.maximum(fs_raw, pfirst), plast), \
            torch.minimum(torch.maximum(fe_raw, pfirst), plast), ne

    def frame_cnt_of(sv, fb):
        fs_, fe_, ne_ = fb
        cs = torch.cumsum(sv.to(i64), 0)
        before = torch.where(fs_ > 0, cs[torch.clamp(fs_ - 1, min=0)], zero)
        return torch.where(ne_, cs[fe_] - before, zero)

    def frame_sum_of(sd, sv, fb):
        fs_, fe_, ne_ = fb
        t = sd.bits if isinstance(sd, U64) else sd
        z = torch.zeros((), dtype=t.dtype, device=dev)
        cs = torch.cumsum(torch.where(sv, t, z), 0)
        before = torch.where(fs_ > 0, cs[torch.clamp(fs_ - 1, min=0)], z)
        out = torch.where(ne_, cs[fe_] - before, z)
        return U64(out) if isinstance(sd, U64) else out

    outs = []
    for f, (fs, frkey) in enumerate(zip(funcspecs, framespecs)):
        name = fs[0]
        args = [(gather(d, perm), v[perm]) for d, v in fargs[f]]
        fb = frame_of(frkey)
        if name == "row_number":
            sd, sv = rn + 1, ones
        elif name == "rank":
            sd, sv = peer_first - pfirst + 1, ones
        elif name == "dense_rank":
            dcs = torch.cumsum(ostart.to(i64), 0)
            sd, sv = dcs - dcs[pfirst] + 1, ones
        elif name == "ntile":
            k = fs[1]
            big, rem = psize // k, psize % k
            cut = rem * (big + 1)
            sd = torch.where(
                big > 0,
                torch.where(rn < cut, rn // torch.clamp(big + 1, min=1),
                            rem + (rn - cut) // torch.clamp(big, min=1)),
                rn) + 1
            sv = ones
        elif name == "cume_dist":
            outs += [scat(peer_last - pfirst + 1), scat(psize)]
            continue
        elif name == "percent_rank":
            outs += [scat(peer_first - pfirst), scat(psize - 1)]
            continue
        elif name in ("lead", "lag"):
            off, has_default = fs[1], fs[2]
            sd0, sv0 = args[0]
            tgt = iota + (off if name == "lead" else -off)
            tgt_c = torch.clamp(tgt, 0, P - 1)
            ok = (tgt >= 0) & (tgt < P) & (pid[tgt_c] == pid)
            if has_default:
                dd, dv = args[1]
            else:
                t0 = sd0.bits if isinstance(sd0, U64) else sd0
                dd = torch.zeros_like(t0)
                dd = U64(dd) if isinstance(sd0, U64) else dd
                dv = torch.zeros(P, dtype=torch.bool, device=dev)
            sd = where(ok, gather(sd0, tgt_c), dd)
            sv = torch.where(ok, sv0[tgt_c], dv)
        elif name in ("first_value", "last_value", "nth_value"):
            sd0, sv0 = args[0]
            fs_, fe_, ne_ = fb
            if name == "first_value":
                pos, ok = fs_, ne_
            elif name == "last_value":
                pos, ok = fe_, ne_
            else:
                pos = fs_ + fs[1] - 1
                ok = ne_ & (pos <= fe_)
                pos = torch.clamp(pos, 0, P - 1)
            sd, sv = gather(sd0, pos), sv0[pos] & ok
        elif name == "count":
            sv0 = args[0][1] if fs[1] else ones
            sd, sv = frame_cnt_of(sv0, fb), ones
        elif name in ("sum", "avg"):
            sd0, sv0 = args[0]
            fcnt = frame_cnt_of(sv0, fb)
            fsum = frame_sum_of(sd0, sv0, fb)
            if name == "avg":
                outs += [scat(fsum), scat(fcnt)]
                continue
            sd, sv = fsum, fcnt > 0
        elif name in ("min", "max"):
            sd0, sv0 = args[0]
            x, kind = _minmax_kind(sd0)
            is_max = name == "max"
            if kind == "f":
                fill = float("-inf") if is_max else float("inf")
            else:
                fill = _I64_MIN if is_max else _I64_MAX
            op = torch.maximum if is_max else torch.minimum
            masked = torch.where(sv0, x, torch.full((), fill, dtype=x.dtype, device=dev))
            fs_, fe_, ne_ = fb
            if frkey is None or frkey[1] == "up":
                res = _seg_scan(pstart, masked, op)[fe_]
            elif frkey[3] == "uf":
                rev = _seg_scan(torch.flip(iota == plast, [0]), torch.flip(masked, [0]), op)
                res = torch.flip(rev, [0])[fs_]
            else:
                L = max(1, frame_width(frkey).bit_length())
                levels = [masked]
                for k in range(1, L):
                    h = 1 << (k - 1)
                    prev = levels[-1]
                    shifted = torch.cat([prev[h:], torch.full((h,), fill, dtype=prev.dtype, device=dev)])
                    levels.append(op(prev, shifted))
                stk = torch.stack(levels)
                w = torch.clamp(fe_ - fs_ + 1, min=1)
                lk = torch.zeros(P, dtype=i64, device=dev)
                for j in range(1, L):
                    lk = lk + (w >= (1 << j)).to(i64)
                half = torch.ones((), dtype=i64, device=dev) << lk
                res = op(stk[lk, fs_], stk[lk, torch.clamp(fe_ - half + 1, min=0)])
            sd = U64(res ^ _I64_MIN) if kind == "u" else res
            sv = frame_cnt_of(sv0, fb) > 0
        else:  # pragma: no cover — guarded by SUPPORTED
            raise AssertionError(name)
        outs += [scat(sd), scat(sv)]
    return outs


# --- the CUDA route ------------------------------------------------------------

_KIND_CODE = {"up": 0, "pre": 1, "cur": 2, "fol": 3, "uf": 4}
_RANK_CODE = {"row_number": 0, "rank": 1, "dense_rank": 2, "ntile": 3, "cume_dist": 4, "percent_rank": 5}
_VALUE_CODE = {"first_value": 0, "last_value": 1, "nth_value": 2}
# function codes of funcs_kernel; scan kinds of tt_win_scan; min / max value
# types and modes
_F_RANK, _F_SHIFT, _F_VALUE, _F_COUNT, _F_SUM, _F_MINMAX = range(6)
_S_PAIR_I64, _S_PAIR_F64, _S_COUNT, _S_SEG = range(4)
_MM_I64, _MM_U64, _MM_F64 = range(3)
_MODE_PREFIX, _MODE_SUFFIX, _MODE_LOOP, _MODE_TABLE = range(4)
_B_NONE, _B_BYTE, _B_WORD = range(3)  # a function's second output in its record
_OUT_WORD, _OUT_BYTE, _OUT_ONE = range(3)

_bound: set = set()


def _lib():
    lib = library("window")
    if "window" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        sigs = {
            "tt_win_loop_width": ([], L),
            "tt_win_max_funcs": ([], L),
            "tt_win_scratch_words": ([L], L),
            "tt_win_gather": ([L, C, I, C, I, C, I, C, C], I),
            "tt_win_bounds": ([L, I, I, C, C, C, C, C, C, C], I),
            "tt_win_scan": ([I, L, C, C, C, C, C, C, C], I),
            "tt_win_levels": ([I, I, L, C, C, I, C, C], I),
            "tt_win_funcs": ([L, C, C, C, C, C, C, I, I, I, C, I, C, C], I),
            "tt_win_out": ([L, C, C, I, I, C, C], I),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _bound.add("window")
    return lib


def _ptr(t) -> int:
    return 0 if t is None else (t.bits if isinstance(t, U64) else t).data_ptr()


def _table(rows) -> np.ndarray:
    return np.array(rows, dtype=np.int64).reshape(len(rows), -1) if rows else np.zeros((0, 1), dtype=np.int64)


def _window_cuda(words, fargs, spec, range_key, phase) -> list:
    P = _check_cuda(words, fargs, spec, range_key)
    with phase("sort"):
        perm = lex_sort_perm(_words_ops(words))
    with phase("window"):
        outs = _cuda_body(words, fargs, spec, range_key, perm, P)
    count(window)
    return outs


def _check_cuda(words, fargs, spec, range_key) -> int:
    P = _check(words, fargs, spec, range_key)
    dev = words[0].device
    tensors = list(words) + [t for fa in fargs for d, v in fa for t in (d.bits if isinstance(d, U64) else d, v)]
    if range_key is not None:
        tensors += [range_key[0], range_key[1]]
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"window: inputs must be contiguous tensors on {dev}")
    if P >= 1 << 31:
        raise ValueError(f"window: {P} rows exceed the int32 row ids")
    if len(words) > MAX_WORDS:
        raise ValueError(f"window: {len(words)} sort words; the bounds kernel takes at most {MAX_WORDS}")
    return P


class Plan(NamedTuple):
    """W1's launches for one call, as tensors (kernels/window.py builds it;
    `_launch` hands its addresses to csrc/window.cu):

      gathers  [(mode, data, valid, gd, gv, gmin, gmax, desc)]: each lane
               gathered into sorted order once (mode 0 data and valid, 1
               valid alone into gv, 2 the RANGE key's search lane into gd)
      scans    [(kind, gd, gv, cnt, out)]: the prefix scans over them
      tables   [(mm_type, is_max, gd, gv, L, levels 1 .. L - 1)]
      funcs    per function its row of funcs_kernel's table (a dict; the
               lanes as tensors, `lv0` its first level in `levels`)
      levels   every sparse table's levels, in order
      outs     the output lanes, as `window` returns them
      out_rows [(output, kind, record slot)] (kind: a word, a byte, the
               constant 1; a byte's slot counts bytes)
      n8       the record's value words; then a word of valid bytes for
               each MAX_FUNCS functions (function f's at byte f %
               MAX_FUNCS), then a padding word to whole 16-byte records
      stride   the record's int64 words
      rk       the RANGE key's gathered search lane, or None"""
    gathers: list
    scans: list
    tables: list
    funcs: list
    levels: list
    outs: list
    out_rows: list
    n8: int
    stride: int
    rk: object


_FUNC_KEYS = ("code", "sub", "has_frame", "rows", "sk", "so", "ek", "eo", "use_range", "desc", "k", "gd", "gv", "dd",
              "dv", "cnt", "sum", "acc", "mm_type", "is_max", "mm_mode", "L", "lv0", "a_slot", "b_kind", "b_slot")
_FUNC_LANES = ("gd", "gv", "dd", "dv", "cnt", "sum", "acc")
LOOP_WIDTH = 64  # a ROWS min / max this wide or narrower is read directly (csrc/window.cu LOOP_W)
MAX_FUNCS = 8  # functions a funcs launch takes, whose valid bytes fill one record word (csrc/window.cu MAXF)


def plan(fargs, spec, range_key, P: int, dev) -> Plan:
    """The lanes, scans and records of one W1 call over P rows on `dev`
    (allocated, not yet written)."""
    _, _, funcspecs, framespecs = spec
    i32, i64, b8 = torch.int32, torch.int64, torch.bool

    def lane(dtype=i64):
        return torch.empty(P, dtype=dtype, device=dev)

    gathers: dict = {}

    def gathered(d, v):
        t = None if d is None else (d.bits if isinstance(d, U64) else d)
        key = (0 if t is None else t.data_ptr(), v.data_ptr())
        if t is None:  # a valid lane alone: any gather of it serves
            key = next((k for k in gathers if len(k) == 2 and k[1] == key[1]), key)
        if key not in gathers:
            gd = None if t is None else lane()
            gathers[key] = (0 if t is not None else 1, t, v, gd, lane(b8), 0, 0, 0)
        return gathers[key][3], gathers[key][4]

    rk = None
    if range_key is not None and any(fr is not None and len(fr) > 5 for fr in framespecs):
        desc = next(fr[5] for fr in framespecs if fr is not None and len(fr) > 5)
        kd, kv, gmin, gmax = range_key
        rk = lane()
        gathers[("rk",)] = (2, kd, kv, rk, None, int(gmin), int(gmax), int(bool(desc)))

    scans: dict = {}

    def pair(gd, gv, is_f):
        key = ("pair", gd.data_ptr(), gv.data_ptr())
        if key not in scans:
            scans[key] = (_S_PAIR_F64 if is_f else _S_PAIR_I64, gd, gv, lane(i32), lane())
        return scans[key][3], scans[key][4]

    def counts(gv):
        key = next((k for k in scans if k[0] == "pair" and k[2] == gv.data_ptr()), ("count", gv.data_ptr()))
        if key not in scans:
            scans[key] = (_S_COUNT, None, gv, lane(i32), None)
        return scans[key][3]

    def seg(mm, is_max, rev, gd, gv):
        key = ("seg", mm, is_max, rev, gd.data_ptr(), gv.data_ptr())
        if key not in scans:
            scans[key] = (_S_SEG + mm * 4 + is_max * 2 + rev, gd, gv, None, lane())
        return scans[key][4]

    def like(d):
        t = torch.empty(P, dtype=(d.bits if isinstance(d, U64) else d).dtype, device=dev)
        return U64(t) if isinstance(d, U64) else t

    tables, levels, funcs, outs, out_rows, n8 = [], [], [], [], [], 0
    for f, (fs, frkey) in enumerate(zip(funcspecs, framespecs)):
        name = fs[0]
        args = fargs[f]
        row = dict.fromkeys(_FUNC_KEYS, 0)
        row.update(dict.fromkeys(_FUNC_LANES), k=1)
        if frkey is not None and name not in _RANK_CODE and name not in ("lead", "lag"):
            unit, sk, so, ek, eo = frkey[:5]
            use_range = unit == "range" and len(frkey) > 5 and (sk in ("pre", "fol") or ek in ("pre", "fol"))
            row.update(has_frame=1, rows=int(unit == "rows"), sk=_KIND_CODE[sk], so=int(so), ek=_KIND_CODE[ek],
                       eo=int(eo), use_range=int(use_range), desc=int(bool(frkey[5])) if use_range else 0)
        if name in _RANK_CODE:
            two = name in ("cume_dist", "percent_rank")
            row.update(code=_F_RANK, sub=_RANK_CODE[name], k=int(fs[1]) if name == "ntile" else 1)
            a, b, bk = lane(), (lane() if two else lane(b8)), (_B_WORD if two else _B_NONE)
        elif name in ("lead", "lag"):
            off, has_default = fs[1], fs[2]
            d, v = args[0]
            gd, gv = gathered(d, v)
            row.update(code=_F_SHIFT, k=int(off if name == "lead" else -off), gd=gd, gv=gv)
            if has_default:
                dd, dv = gathered(*args[1])
                row.update(dd=dd, dv=dv)
            a, b, bk = like(d), lane(b8), _B_BYTE
        elif name in _VALUE_CODE:
            d, v = args[0]
            gd, gv = gathered(d, v)
            row.update(code=_F_VALUE, sub=_VALUE_CODE[name], k=int(fs[1]) if name == "nth_value" else 1, gd=gd,
                       gv=gv)
            a, b, bk = like(d), lane(b8), _B_BYTE
        elif name == "count":
            if fs[1]:
                row.update(cnt=counts(gathered(None, args[0][1])[1]))
            row.update(code=_F_COUNT)
            a, b, bk = lane(), lane(b8), _B_NONE
        elif name in ("sum", "avg"):
            d, v = args[0]
            is_f = not isinstance(d, U64) and d.dtype == torch.float64
            gd, gv = gathered(d, v)
            cnt, sums = pair(gd, gv, is_f)
            row.update(code=_F_SUM, sub=(0 if name == "sum" else 2) + int(is_f), cnt=cnt, sum=sums)
            a = like(d)
            b, bk = (lane(b8), _B_BYTE) if name == "sum" else (lane(), _B_WORD)
        elif name in ("min", "max"):
            d, v = args[0]
            mm = _MM_U64 if isinstance(d, U64) else (_MM_F64 if d.dtype == torch.float64 else _MM_I64)
            is_max = int(name == "max")
            gd, gv = gathered(d, v)
            row.update(code=_F_MINMAX, mm_type=mm, is_max=is_max, gd=gd, gv=gv)
            if frkey is None or frkey[1] == "up" or frkey[3] == "uf":
                rev = int(not (frkey is None or frkey[1] == "up"))
                row.update(mm_mode=_MODE_SUFFIX if rev else _MODE_PREFIX, acc=seg(mm, is_max, rev, gd, gv),
                           cnt=counts(gv))
            elif frkey[0] == "rows" and frame_width(frkey) <= LOOP_WIDTH:
                row.update(mm_mode=_MODE_LOOP)
            else:
                L = max(1, frame_width(frkey).bit_length())
                lvs = [lane() for _ in range(L - 1)]
                tables.append((mm, is_max, gd, gv, L, lvs))
                row.update(mm_mode=_MODE_TABLE, L=L, lv0=len(levels), cnt=counts(gv))
                levels += lvs
            a, b, bk = like(d), lane(b8), _B_BYTE
        else:  # pragma: no cover — guarded by SUPPORTED
            raise AssertionError(name)
        row.update(a_slot=n8, b_kind=bk)
        n8 += 1
        if bk == _B_WORD:
            row["b_slot"] = n8
            n8 += 1
        funcs.append(row)
        outs += [a, b]
    for f, (row, a, b) in enumerate(zip(funcs, outs[::2], outs[1::2])):
        if row["b_kind"] == _B_BYTE:  # byte f % MAX_FUNCS of the byte word after the value words
            row["b_slot"] = 8 * (n8 + f // MAX_FUNCS) + f % MAX_FUNCS
        out_rows += [(a, _OUT_WORD, row["a_slot"]),
                     (b, {_B_WORD: _OUT_WORD, _B_BYTE: _OUT_BYTE, _B_NONE: _OUT_ONE}[row["b_kind"]], row["b_slot"])]
    stride = n8 + -(-len(funcs) // MAX_FUNCS)
    stride += stride & 1  # records of whole 16-byte units
    return Plan(list(gathers.values()), list(scans.values()), tables, funcs, levels, outs, out_rows, n8, stride, rk)


def _gather_parts(mode: int, parts: int) -> int:
    """What a gather pass with `parts` (1 data, 2 valid bytes) moves of a
    lane of `mode` (csrc/window.cu lane_parts)."""
    if mode == 2:
        return 3 if parts & 1 else 0
    return (2 if mode == 1 else 3) & parts


def _launch(pl: Plan, words, npw: int, perm, P: int, dev) -> list:
    """Every kernel of csrc/window.cu for the plan, on the current stream."""
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    i32 = torch.int32

    def call(name, *args):
        rc = getattr(lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"window: {name} launch failed (cudaError {rc})")

    sorted_words = [torch.empty(P, dtype=w.dtype, device=dev) for w in words]
    kinds = [0 if w.dtype == torch.int32 else 1 for w in words]
    wtab = _table([[w.data_ptr(), k, sw.data_ptr()] for w, k, sw in zip(words, kinds, sorted_words)])
    stab = _table([[sw.data_ptr(), k] for sw, k in zip(sorted_words, kinds)])
    gtab = _table([[_ptr(d), _ptr(v), _ptr(gd), _ptr(gv), gmin, gmax, mode, desc]
                   for mode, d, v, gd, gv, gmin, gmax, desc in pl.gathers])
    ftab = _table([[_ptr(row[k]) if k in _FUNC_LANES else row[k] for k in _FUNC_KEYS] for row in pl.funcs])
    ltab = _table([[t.data_ptr()] for t in pl.levels])
    otab = _table([[_ptr(o), kind, slot] for o, kind, slot in pl.out_rows])
    inv, pid, oid = (torch.empty(P, dtype=i32, device=dev) for _ in range(3))
    ppos, opos = (torch.empty(P + 1, dtype=i32, device=dev) for _ in range(2))
    rec = torch.empty(P * pl.stride, dtype=torch.int64, device=dev)
    # four gather passes, each with a footprint L2 serves: the sort words;
    # the lanes' data words; their valid bytes (8 MB lanes, which L2 keeps
    # when no 64 MB lane streams beside them); the inverse permutation
    # (random 4-byte stores, whole in L2 before they reach memory)
    for nw, ng, parts, inv_ptr in ((len(words), 0, 0, 0), (0, len(pl.gathers), 1, 0), (0, len(pl.gathers), 2, 0),
                                   (0, 0, 0, inv.data_ptr())):
        if nw or inv_ptr or any(_gather_parts(g[0], parts) for g in pl.gathers[:ng]):
            call("tt_win_gather", P, perm.data_ptr(), nw, wtab.ctypes.data, ng, gtab.ctypes.data, parts, inv_ptr,
                 stream)
    with stream_scratch("window", dev, lib.tt_win_scratch_words(P)) as ws:
        call("tt_win_bounds", P, len(words), npw, stab.ctypes.data, pid.data_ptr(), oid.data_ptr(),
             ppos.data_ptr(), opos.data_ptr(), ws.data_ptr(), stream)
        for kind, gd, gv, cnt, out in pl.scans:
            call("tt_win_scan", kind, P, _ptr(gd), gv.data_ptr(), pid.data_ptr(), _ptr(cnt), _ptr(out),
                 ws.data_ptr(), stream)
    for mm, is_max, gd, gv, L, lvs in pl.tables:
        lv = _table([[t.data_ptr()] for t in lvs])
        call("tt_win_levels", mm, is_max, P, gd.data_ptr(), gv.data_ptr(), L, lv.ctypes.data, stream)
    call("tt_win_funcs", P, pid.data_ptr(), oid.data_ptr(), ppos.data_ptr(), opos.data_ptr(), _ptr(pl.rk),
         rec.data_ptr(), pl.stride, pl.n8, len(ftab), ftab.ctypes.data, len(pl.levels), ltab.ctypes.data, stream)
    call("tt_win_out", P, inv.data_ptr(), rec.data_ptr(), pl.stride, len(otab), otab.ctypes.data, stream)
    return pl.outs


def _cuda_body(words, fargs, spec, range_key, perm, P):
    """The kernels of csrc/window.cu after the sort (module doc)."""
    dev = words[0].device
    lib = _lib()
    if (lib.tt_win_loop_width(), lib.tt_win_max_funcs()) != (LOOP_WIDTH, MAX_FUNCS):
        raise RuntimeError("window: csrc/window.cu's LOOP_W / MAXF differ from kernels/window.py's")
    return _launch(plan(fargs, spec, range_key, P, dev), words, spec[0], perm, P, dev)


def window_sorted_ref(words, fargs, spec, range_key, perm) -> list:
    """Plain PyTorch version of `window_sorted` (window_ref after its sort)."""
    P = _check(words, fargs, spec, range_key)
    npw, now, funcspecs, framespecs = spec
    iota = torch.arange(P, dtype=torch.int64, device=words[0].device)
    return _ref_body(words, fargs, funcspecs, framespecs, range_key, perm.to(torch.int64), iota, npw, now, P)


def window_sorted(words, fargs, spec, range_key, perm) -> list:
    """W1 after the sort: every function of the spec, in input row order,
    given `perm`, the sorted order of `words` (as lex_sort_perm gives it).
    `window` is K8, then this; timing it alone keeps K8 out of W1's time.
    The plain version for CPU tensors; on a CUDA device the kernels."""
    dev = words[0].device
    if dev.type == "cpu":
        return window_sorted_ref(words, fargs, spec, range_key, perm)
    P = _check(words, fargs, spec, range_key)
    if dev.type != "cuda":
        raise ValueError(f"window: unsupported device {dev}")
    _check_cuda(words, fargs, spec, range_key)
    if perm.dtype != torch.int32 or perm.shape != (P,) or perm.device != dev or not perm.is_contiguous():
        raise ValueError(f"window: perm must be int32 [{P}] on {dev}")
    return _cuda_body(words, fargs, spec, range_key, perm, P)


def window(words, fargs, spec, range_key=None, phase=None) -> list:
    """Every function of one window spec, in input row order (module doc)."""
    if not words:
        raise ValueError("window: no sort words")
    dev = words[0].device
    phase = phase or (lambda name: nullcontext())
    if dev.type == "cpu":
        return window_ref(words, fargs, spec, range_key, phase)
    if dev.type != "cuda":
        raise ValueError(f"window: unsupported device {dev}")
    return _window_cuda(words, fargs, spec, range_key, phase)


window.launches = 0
