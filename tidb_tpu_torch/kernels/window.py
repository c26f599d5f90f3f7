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
  2. partition and peer start flags; a hand-written device-wide scan of
     each gives pid and peer_id; each start's row is scattered to
     start_pos[id], so first = start_pos[id], last = start_pos[id+1] - 1
  3. per function its frame (fs, fe, nonempty) clipped to the partition;
     RANGE offsets binary-search the row's own partition
  4. count/sum/avg from inclusive prefix sums (int64 wraps in two's
     complement, as the reference's); rankings and offsets from the
     bounds; min/max from a segmented prefix (growing frames) or suffix
     (shrinking frames) scan, or a sparse table for both-bounded ROWS
     frames; NaN propagates as jnp.minimum/maximum propagate it
  5. every output written at perm[i] (the scatter back)      "window"

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

import torch

from ..expr.xp_torch import U64
from .build import count, library
from .lex_sort import SortOp, lex_sort_perm, lex_sort_perm_ref

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


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
# scan modes of tt_win_scan: a u8 flag lane; valid[perm] counts; int64 /
# float64 sums of where(valid, data, 0)[perm]
_SCAN_FLAG, _SCAN_COUNT, _SCAN_SUM_I64, _SCAN_SUM_F64 = 0, 1, 2, 3
# value types of the min/max kernels
_MM_I64, _MM_U64, _MM_F64 = 0, 1, 2

_bound: set = set()


def _lib():
    lib = library("window")
    if "window" not in _bound:
        C, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        sigs = {
            "tt_win_tile": ([], L),
            "tt_win_flags": ([C, I, I, L, C, C, C, I, C], I),
            "tt_win_scan": ([I, L, C, C, C, C, C, C], I),
            "tt_win_bounds": ([L, C, C, C, C, C, C], I),
            "tt_win_range_key": ([L, C, C, C, L, L, I, C, C], I),
            "tt_win_frame": ([L, I, I, L, I, L, I, I, C, C, C, C, C, C, C, C, C], I),
            "tt_win_rank": ([I, L, C, C, C, C, C, C, L, C, C, C, C], I),
            "tt_win_shift": ([L, C, C, L, C, C, C, C, C, C, C], I),
            "tt_win_value": ([I, L, C, C, C, C, L, C, C, C, C, C], I),
            "tt_win_agg": ([I, L, C, C, C, C, C, C, C, C, C], I),
            "tt_win_mm_masked": ([I, I, L, C, C, C, C, C], I),
            "tt_win_mm_scan": ([I, I, I, L, C, C, C, C, C], I),
            "tt_win_mm_level": ([I, I, L, C, L, C, C], I),
            "tt_win_mm_out": ([I, I, I, L, C, C, C, C, C, C, I, C, C, C, C], I),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _bound.add("window")
    return lib


def _ptr(t) -> int:
    return 0 if t is None else (t.bits if isinstance(t, U64) else t).data_ptr()


class _Launcher:
    """Launch helpers bound to one device, stream and library."""

    def __init__(self, dev: torch.device, P: int):
        self.lib = _lib()
        self.dev, self.P = dev, P
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tile = self.lib.tt_win_tile()
        self.nb = (P + tile - 1) // tile
        # three-phase scan partials: one (flag, 8-byte value) pair per tile
        self.partials = torch.empty(2 * self.nb, dtype=torch.int64, device=dev)

    def call(self, name: str, *args) -> None:
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"window: {name} launch failed (cudaError {rc})")

    def empty(self, dtype=torch.int64):
        return torch.empty(self.P, dtype=dtype, device=self.dev)

    def scan(self, mode: int, perm, data=None, valid=None, dtype=torch.int64):
        out = self.empty(dtype)
        self.call("tt_win_scan", mode, self.P, _ptr(perm), _ptr(data), _ptr(valid), out.data_ptr(),
                  self.partials.data_ptr(), self.stream)
        return out


def _window_cuda(words, fargs, spec, range_key, phase) -> list:
    P = _check(words, fargs, spec, range_key)
    npw, now, funcspecs, framespecs = spec
    dev = words[0].device
    tensors = list(words) + [t for fa in fargs for d, v in fa for t in (d.bits if isinstance(d, U64) else d, v)]
    if range_key is not None:
        tensors += [range_key[0], range_key[1]]
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"window: inputs must be contiguous tensors on {dev}")
    if P >= 1 << 31:
        raise ValueError(f"window: {P} rows exceed the int32 row ids")
    with phase("sort"):
        perm = lex_sort_perm(_words_ops(words))
    with phase("window"):
        outs = _cuda_body(words, fargs, funcspecs, framespecs, range_key, perm, npw, P, dev)
    count(window)
    return outs


def _cuda_body(words, fargs, funcspecs, framespecs, range_key, perm, npw, P, dev):
    K = _Launcher(dev, P)
    u8, i64 = torch.uint8, torch.int64
    wdesc = torch.tensor([[w.data_ptr(), 0 if w.dtype == torch.int32 else 1] for w in words],
                         dtype=torch.int64).to(dev)
    pstart, ostart = K.empty(torch.bool), K.empty(torch.bool)
    K.call("tt_win_flags", wdesc.data_ptr(), len(words), npw, P, perm.data_ptr(), pstart.data_ptr(),
           ostart.data_ptr(), K.n_sms, K.stream)
    pcs = K.scan(_SCAN_FLAG, None, pstart)  # pid + 1
    ocs = K.scan(_SCAN_FLAG, None, ostart)  # peer_id + 1 (dense_rank's dcs)
    pstart_pos = torch.empty(P + 1, dtype=i64, device=dev)
    ostart_pos = torch.empty(P + 1, dtype=i64, device=dev)
    pfirst, plast, peer_first, peer_last = K.empty(), K.empty(), K.empty(), K.empty()
    K.call("tt_win_bounds", P, pstart.data_ptr(), pcs.data_ptr(), pstart_pos.data_ptr(),
           pfirst.data_ptr(), plast.data_ptr(), K.stream)
    K.call("tt_win_bounds", P, ostart.data_ptr(), ocs.data_ptr(), ostart_pos.data_ptr(),
           peer_first.data_ptr(), peer_last.data_ptr(), K.stream)
    del pstart_pos, ostart_pos
    rk = None
    if range_key is not None and any(fr is not None and len(fr) > 5 for fr in framespecs):
        desc = next(fr[5] for fr in framespecs if fr is not None and len(fr) > 5)
        kd, kv, gmin, gmax = range_key
        rk = K.empty()
        K.call("tt_win_range_key", P, perm.data_ptr(), kd.data_ptr(), kv.data_ptr(), int(gmin), int(gmax),
               int(bool(desc)), rk.data_ptr(), K.stream)

    frames: dict = {}

    def frame_of(frkey):
        """(fs, fe, ne) with ne None for the default frame (all true)."""
        if frkey is None:
            return pfirst, peer_last, None
        if frkey not in frames:
            unit, sk, so, ek, eo = frkey[:5]
            use_range = unit == "range" and len(frkey) > 5 and (sk in ("pre", "fol") or ek in ("pre", "fol"))
            fs, fe, ne = K.empty(), K.empty(), K.empty(torch.bool)
            K.call("tt_win_frame", P, int(unit == "rows"), _KIND_CODE[sk], int(so), _KIND_CODE[ek], int(eo),
                   int(use_range), int(bool(frkey[5])) if use_range else 0,
                   pfirst.data_ptr(), plast.data_ptr(), peer_first.data_ptr(), peer_last.data_ptr(),
                   _ptr(rk if use_range else None), fs.data_ptr(), fe.data_ptr(), ne.data_ptr(), K.stream)
            frames[frkey] = (fs, fe, ne)
        return frames[frkey]

    def like(d):
        t = torch.empty(P, dtype=(d.bits if isinstance(d, U64) else d).dtype, device=dev)
        return U64(t) if isinstance(d, U64) else t

    outs = []
    for f, (fs, frkey) in enumerate(zip(funcspecs, framespecs)):
        name = fs[0]
        args = fargs[f]
        if name in _RANK_CODE:
            a = K.empty()
            pair = name in ("cume_dist", "percent_rank")
            b = K.empty() if pair else K.empty(torch.bool)
            K.call("tt_win_rank", _RANK_CODE[name], P, perm.data_ptr(), pfirst.data_ptr(), plast.data_ptr(),
                   peer_first.data_ptr(), peer_last.data_ptr(), ocs.data_ptr(),
                   int(fs[1]) if name == "ntile" else 1, a.data_ptr(),
                   b.data_ptr() if pair else 0, 0 if pair else b.data_ptr(), K.stream)
            outs += [a, b]
        elif name in ("lead", "lag"):
            off, has_default = fs[1], fs[2]
            (d, v) = args[0]
            dd, dv = args[1] if has_default else (None, None)
            od, ov = like(d), K.empty(torch.bool)
            K.call("tt_win_shift", P, perm.data_ptr(), pcs.data_ptr(), int(off if name == "lead" else -off),
                   _ptr(d), v.data_ptr(), _ptr(dd), _ptr(dv), _ptr(od), ov.data_ptr(), K.stream)
            outs += [od, ov]
        elif name in _VALUE_CODE:
            (d, v) = args[0]
            fsb, feb, ne = frame_of(frkey)
            od, ov = like(d), K.empty(torch.bool)
            K.call("tt_win_value", _VALUE_CODE[name], P, perm.data_ptr(), fsb.data_ptr(), feb.data_ptr(),
                   _ptr(ne), int(fs[1]) if name == "nth_value" else 1, _ptr(d), v.data_ptr(), _ptr(od),
                   ov.data_ptr(), K.stream)
            outs += [od, ov]
        elif name in ("count", "sum", "avg"):
            fsb, feb, ne = frame_of(frkey)
            if name == "count":
                cnt_cs = K.scan(_SCAN_COUNT, perm, None, args[0][1]) if fs[1] else None
                a, b = K.empty(), K.empty(torch.bool)
                K.call("tt_win_agg", 0, P, perm.data_ptr(), fsb.data_ptr(), feb.data_ptr(), _ptr(ne),
                       _ptr(cnt_cs), 0, a.data_ptr(), b.data_ptr(), K.stream)
                outs += [a, b]
                continue
            (d, v) = args[0]
            is_f = not isinstance(d, U64) and d.dtype == torch.float64
            cnt_cs = K.scan(_SCAN_COUNT, perm, None, v)
            sum_cs = K.scan(_SCAN_SUM_F64 if is_f else _SCAN_SUM_I64, perm, d, v,
                            torch.float64 if is_f else torch.int64)
            a = like(d)
            b = K.empty(torch.bool) if name == "sum" else K.empty()
            kind = (1 if name == "sum" else 3) + int(is_f)
            K.call("tt_win_agg", kind, P, perm.data_ptr(), fsb.data_ptr(), feb.data_ptr(), _ptr(ne),
                   cnt_cs.data_ptr(), sum_cs.data_ptr(), _ptr(a), b.data_ptr(), K.stream)
            outs += [a, b]
        elif name in ("min", "max"):
            (d, v) = args[0]
            mm = _MM_U64 if isinstance(d, U64) else (_MM_F64 if d.dtype == torch.float64 else _MM_I64)
            is_max = int(name == "max")
            fsb, feb, ne = frame_of(frkey)
            cnt_cs = K.scan(_SCAN_COUNT, perm, None, v)
            masked = K.empty()
            K.call("tt_win_mm_masked", mm, is_max, P, perm.data_ptr(), _ptr(d), v.data_ptr(),
                   masked.data_ptr(), K.stream)
            if frkey is None or frkey[1] == "up" or frkey[3] == "uf":
                mode = 0 if (frkey is None or frkey[1] == "up") else 1
                acc = K.empty()
                K.call("tt_win_mm_scan", mm, is_max, mode, P, masked.data_ptr(), pstart.data_ptr(),
                       acc.data_ptr(), K.partials.data_ptr(), K.stream)
                levels, table = [acc], None
            else:
                mode = 2
                L = max(1, frame_width(frkey).bit_length())
                levels = [masked]
                for k in range(1, L):
                    nxt = K.empty()
                    K.call("tt_win_mm_level", mm, is_max, P, levels[-1].data_ptr(), 1 << (k - 1),
                           nxt.data_ptr(), K.stream)
                    levels.append(nxt)
                table = torch.tensor([t.data_ptr() for t in levels], dtype=torch.int64).to(dev)
            od, ov = like(d), K.empty(torch.bool)
            K.call("tt_win_mm_out", mm, is_max, mode, P, perm.data_ptr(), fsb.data_ptr(), feb.data_ptr(),
                   _ptr(ne), cnt_cs.data_ptr(), levels[0].data_ptr(), len(levels), _ptr(table),
                   _ptr(od), ov.data_ptr(), K.stream)
            del levels, table, masked  # the sparse table's levels go back to the allocator
            outs += [od, ov]
        else:  # pragma: no cover — guarded by SUPPORTED
            raise AssertionError(name)
    return outs


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
