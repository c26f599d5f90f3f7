"""Window functions for one (PARTITION BY, ORDER BY) spec (copy of the
reference's WindowExec, tidb_tpu/executor/executors.py:663-1453).

The port has no executor tree yet: this WindowExec takes its child's
Chunk (the scan's rows) in place of a child executor, and `next()`
returns that chunk plus one column per window function.

Engines, as the reference's `tidb_cop_engine`:

  * 'tpu'  — the device route (executor/window_device.py: W1 + W2 on the
             card) whenever every function has a device form; the value
             stays the device selector, as in the reference. A device
             error RAISES: the breaker/Backoffer degrade of the reference
             (`_device_guard_ctx`, the retry in `_device_window_call`) is
             not ported yet, and nothing falls back quietly.
  * 'auto' — the device route from `tidb_window_device_min_rows` rows up
             (MIN_DEVICE_ROWS by default), else the host route;
  * 'host' — the host route: one lexicographic sort, every function
             vectorized over the sorted lanes (min/max accumulation and
             decimal AVG walk partitions in Python), scattered back.

When a function has no device form, `fallback_reason` says why, word for
word as the reference does, and the host route answers.
"""

from __future__ import annotations

import numpy as np

from ..chunk.chunk import Chunk, Column
from ..errors import TiDBError
from ..expr.expression import Constant, collation_key_lane
from ..mysqltypes.mydecimal import Dec


class _NotOnDevice(Exception):
    """Window func/lane without a device form — reason for EXPLAIN ANALYZE."""


def _broadcast_lane(d, v, n: int):
    """Expand scalar/0-d eval results to n-row lanes."""
    if np.isscalar(d) or getattr(d, "ndim", 1) == 0:
        d = np.full(n, d)
        v = np.full(n, v)
    return d, v


class WindowExec:
    """Window functions for one (PARTITION BY, ORDER BY) spec over the rows
    of `chunk` (ref: executor/window.go:31, pipelined_window.go:37).

    `engine` is 'tpu', 'auto' or 'host'; `device` the torch device of the
    device route; `provenance` a stable identity of the chunk's rows and
    of this spec (the entry point's (table id, batch version, batch uid,
    spec digest)), or None — it keys the device-input cache; `vars` may
    hold `tidb_window_device_min_rows`; `phase` is an optional
    PhaseTimer.phase hook for the device route's spans."""

    _AGG_FUNCS = ("count", "sum", "avg", "min", "max")

    def __init__(self, chunk: Chunk, part_by, order_by, funcs, out_fts, engine: str = "auto",
                 device="cuda", provenance=None, vars=None, phase=None):
        if engine not in ("tpu", "auto", "host"):
            raise ValueError(f"WindowExec: engine {engine!r} is not 'tpu', 'auto' or 'host'")
        self.chunk = chunk
        self.part_by = part_by
        self.order_by = order_by
        self.funcs = funcs
        self.out_fts = out_fts
        self.engine = engine
        self.device = device
        self.provenance = provenance
        self.vars = vars or {}
        self.phase = phase
        self._done = False
        self.last_engine = "host"  # surfaced by EXPLAIN ANALYZE
        self.fallback_reason = ""

    @staticmethod
    def _lane(e, c, n):
        return _broadcast_lane(*e.eval(c), n)

    def _whole_partition_fast_path(self, c: Chunk, n: int):
        """SUM()/COUNT()/... OVER (PARTITION BY k) with no ORDER BY: factorize
        the partition keys and segment-reduce, skipping the sort."""
        if self.order_by or not self.part_by:
            return None
        if any(f.name not in self._AGG_FUNCS or f.frame is not None for f in self.funcs):
            return None
        part_lanes = []
        for e in self.part_by:
            d, v = self._lane(e, c, n)
            part_lanes.append((collation_key_lane(d, e.ret_type), v))
        arg_lanes = []
        for f in self.funcs:
            if f.args:
                d, v = self._lane(f.args[0], c, n)
                if d.dtype == object and f.name in ("sum", "avg", "min", "max"):
                    return None  # string aggregates keep the generic path
                arg_lanes.append((d, v))
            else:
                arg_lanes.append((np.ones(n, dtype=np.int64), np.ones(n, dtype=bool)))
        from ..copr.host_engine import _group_codes_masked

        inv_sel, _, G = _group_codes_masked(part_lanes, np.ones(n, dtype=bool))
        pid = inv_sel  # mask is all-true: selected order == row order
        cols = list(c.columns)
        for i, (f, (d, v)) in enumerate(zip(self.funcs, arg_lanes)):
            ft = self.out_fts[len(c.columns) + i]
            cnt = np.bincount(pid, weights=v.astype(np.float64), minlength=G)
            if f.name == "count":
                data, valid = cnt[pid].astype(np.int64), np.ones(n, dtype=bool)
            elif f.name in ("sum", "avg"):
                if d.dtype == np.float64:
                    s = np.bincount(pid, weights=np.where(v, d, 0.0), minlength=G)
                else:
                    s = np.zeros(G, dtype=np.int64)
                    np.add.at(s, pid, np.where(v, d.astype(np.int64), 0))
                if f.name == "sum":
                    data = s[pid] if ft.is_float() else s[pid].astype(np.int64)
                    valid = cnt[pid] > 0
                else:
                    data, valid = self._avg_from_sums(f, ft, s, cnt, pid)
            else:  # min / max
                if d.dtype == np.float64:
                    init = np.inf if f.name == "min" else -np.inf
                    acc_dt = np.float64
                else:  # keep the lane's own int dtype (uint64 lanes wrap in int64)
                    acc_dt = d.dtype
                    init = np.iinfo(acc_dt).max if f.name == "min" else np.iinfo(acc_dt).min
                acc = np.full(G, init, dtype=acc_dt)
                fn = np.minimum if f.name == "min" else np.maximum
                fn.at(acc, pid, np.where(v, d, init))
                data, valid = acc[pid], cnt[pid] > 0
            cols.append(Column(ft, data, valid))
        return Chunk(cols)

    def _avg_from_sums(self, f, ft, s, cnt, pid):
        if ft.is_float():
            with np.errstate(divide="ignore", invalid="ignore"):
                g = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
            return g[pid], cnt[pid] > 0
        arg_scale = max(f.args[0].ret_type.decimal, 0) if f.args[0].ret_type.is_decimal() else 0
        out_scale = max(ft.decimal, 0)
        G = len(s)
        qs = np.zeros(G, dtype=np.int64)
        qv = np.zeros(G, dtype=bool)
        for g in range(G):
            c_ = int(cnt[g])
            if c_ > 0:
                q = Dec(int(s[g]), arg_scale).div(Dec(c_, 0))
                if q is not None:
                    qs[g] = q.rescale(out_scale).value
                    qv[g] = True
        return qs[pid], qv[pid]

    # -- the device route ----------------------------------------------------------

    def _try_device(self, c: Chunk, n: int):
        """Route the window onto the card when the engine allows and every
        func/lane has a device form. Returns the output Chunk or None."""
        from .window_device import MIN_DEVICE_ROWS

        eng = self.engine
        min_rows = int(self.vars.get("tidb_window_device_min_rows", MIN_DEVICE_ROWS))
        if eng == "host" or (eng != "tpu" and n < min_rows):
            return None
        from .window_device import run_cached_window, run_device_window

        return self._try_device_admitted(c, n, run_cached_window, run_device_window)

    def _output(self, c: Chunk, results) -> Chunk:
        self.last_engine = "tpu"
        cols = list(c.columns)
        nbase = len(cols)
        for i, (data, valid) in enumerate(results):
            cols.append(Column(self.out_fts[nbase + i], data, valid))
        return Chunk(cols)

    def _try_device_admitted(self, c: Chunk, n: int, run_cached_window, run_device_window):
        from .window_device import encode_obj

        prov = self.provenance
        if prov is not None:
            results = run_cached_window(prov, n, self.device, phase=self.phase)
            if results is not None:
                return self._output(c, results)
        range_lane, range_stats = (None, None)
        if any(
            f.frame is not None and f.frame.unit == "range"
            and (f.frame.start_kind in ("pre", "fol") or f.frame.end_kind in ("pre", "fol"))
            for f in self.funcs
        ):
            range_lane, range_stats = self._range_lane_stats(c, n)
        try:
            fspecs = self._device_fspecs(c, n, range_stats)
        except _NotOnDevice as e:
            self.fallback_reason = str(e)
            return None

        def key_lane(e):
            d, v = self._lane(e, c, n)
            if d.dtype == object:
                # ci keys sort/group by WEIGHT; key codes never decode back
                d = encode_obj(collation_key_lane(d, e.ret_type), v)[0]
            return d, v

        part = [key_lane(e) for e in self.part_by]
        order = [(key_lane(e), desc) for e, desc in self.order_by]
        if not any(f.get("frame") is not None and len(f["frame"]) > 5 for f in fspecs):
            range_lane = None  # computed above only when a frame uses it
        rng_arg = (range_lane + range_stats) if range_lane is not None else None
        results = run_device_window(part, order, fspecs, n, device=self.device, provenance=prov,
                                    range_lane=rng_arg, phase=self.phase)
        return self._output(c, results)

    def _range_offset_ok(self, fr, range_stats, n: int):
        """Device-eligibility of a RANGE-offset frame: ONE integer-typed
        ORDER BY key, int offsets, and a composite band (n partitions
        worst case) that fits int64 — everything else stays on the host."""
        if range_stats is None:
            return False
        off_s = fr.start_off if fr.start_kind in ("pre", "fol") else 0
        off_e = fr.end_off if fr.end_kind in ("pre", "fol") else 0
        if not isinstance(off_s, int) or not isinstance(off_e, int):
            return False
        gmin, gmax = range_stats
        S = (gmax - gmin) + 2 * max(abs(off_s), abs(off_e)) + 4
        return n * S < 1 << 61

    def _range_lane_stats(self, c: Chunk, n: int):
        """((d, v), (gmin, gmax)) for the single ORDER BY key — computed
        ONCE per chunk and shared by eligibility gating, the kernel's
        runtime scalars, and the shipped search lane."""
        if len(self.order_by) != 1:
            return None, None
        d, v = self._lane(self.order_by[0][0], c, n)
        if getattr(d, "dtype", None) is None or d.dtype == object or d.dtype.kind != "i":
            return None, None
        pres = d[:n][v[:n]]
        if len(pres) == 0:
            return None, None  # all-NULL key: peer bounds; host is fine
        return (d, v), (int(pres.min()), int(pres.max()))

    def _device_fspecs(self, c: Chunk, n: int, range_stats=None):
        """Build window_device fspecs; raises _NotOnDevice when some func
        has no device form."""
        from ..mysqltypes import collate as _coll
        from .window_device import MAX_DEVICE_FRAME_W, SUPPORTED, encode_obj, frame_width

        fspecs = []
        for f in self.funcs:
            if f.name not in SUPPORTED:
                raise _NotOnDevice(f"window func {f.name} has no device kernel")
            frame = None
            if f.frame is not None and f.name in (
                "first_value", "last_value", "nth_value", "count", "sum", "avg", "min", "max",
            ):
                fr = f.frame
                frame = fr.key()
                if fr.unit == "range" and (
                    fr.start_kind in ("pre", "fol") or fr.end_kind in ("pre", "fol")
                ):
                    if not self._range_offset_ok(fr, range_stats, n):
                        raise _NotOnDevice(
                            "RANGE offset frame not device-eligible (non-int key/offset or composite overflow)"
                        )
                    # only `desc` is static; gmin/gmax ship as runtime scalars
                    frame = frame + (bool(self.order_by[0][1]),)
                if f.name in ("min", "max") and fr.start_kind != "up" and fr.end_kind != "uf":
                    # both-bounded: the device needs a static sparse table
                    if fr.unit != "rows":
                        raise _NotOnDevice("peer-bounded MIN/MAX frame has no device kernel")
                    if frame_width(frame) > MAX_DEVICE_FRAME_W:
                        raise _NotOnDevice("ROWS frame too wide for the device sparse table")

            def const_int(e, what):
                if not isinstance(e, Constant):
                    raise _NotOnDevice(f"non-constant {what} for {f.name}")
                return e.value.to_int()

            name = f.name
            spec = {"name": name, "args": [], "post": None, "frame": frame}
            if name == "ntile":
                spec["static"] = ("ntile", const_int(f.args[0], "bucket count"))
            elif name in ("row_number", "rank", "dense_rank", "cume_dist", "percent_rank"):
                spec["static"] = (name,)
                if name in ("cume_dist", "percent_rank"):
                    # device returns int num/den; host does the f64 division
                    spec["post"] = (name,)
            elif name in ("lead", "lag"):
                off = const_int(f.args[1], "offset") if len(f.args) > 1 else 1
                has_default = len(f.args) > 2
                d, v = self._lane(f.args[0], c, n)
                if has_default:
                    dd, dv = self._lane(f.args[2], c, n)
                    if (d.dtype == object) != (dd.dtype == object):
                        raise _NotOnDevice("lead/lag default type mismatch")
                    if d.dtype == object:
                        # one vocab covers arg + default so codes compare
                        d, vocab, dd = encode_obj(d, v, extra=np.where(dv, dd, ""))
                        spec["post"] = ("decode", vocab)
                    elif d.dtype != dd.dtype:
                        d = d.astype(np.float64)
                        dd = dd.astype(np.float64)
                    spec["args"] = [(d, v), (dd, dv)]
                else:
                    if d.dtype == object:
                        codes, vocab, _ = encode_obj(d, v)
                        d = codes
                        spec["post"] = ("decode", vocab)
                    spec["args"] = [(d, v)]
                spec["static"] = (name, off, has_default)
            elif name in ("first_value", "last_value", "nth_value", "min", "max"):
                if name in ("min", "max") and _coll.is_ci(
                    getattr(f.args[0].ret_type, "collate", None)
                ):
                    # window encode_obj codes are binary-ordered; ci
                    # MIN/MAX needs weight order → host path
                    raise _NotOnDevice(f"window {name} over ci-collated strings")
                d, v = self._lane(f.args[0], c, n)
                if d.dtype == object:
                    codes, vocab, _ = encode_obj(d, v)
                    d = codes
                    spec["post"] = ("decode", vocab)
                spec["args"] = [(d, v)]
                if name == "nth_value":
                    spec["static"] = (name, const_int(f.args[1], "n"))
                else:
                    spec["static"] = (name,)
            elif name == "count":
                if f.args:
                    d, v = self._lane(f.args[0], c, n)
                    if d.dtype == object:
                        d = np.zeros(n, dtype=np.int64)  # only validity matters
                    spec["args"] = [(d, v)]
                    spec["static"] = ("count", True)
                else:
                    spec["static"] = ("count", False)
            elif name in ("sum", "avg"):
                d, v = self._lane(f.args[0], c, n)
                if d.dtype == object:
                    raise _NotOnDevice(f"window {name} over string operands")
                spec["args"] = [(d, v)]
                if name == "sum":
                    spec["static"] = ("sum", True)
                elif d.dtype == np.float64 or f.ret_type.is_float():
                    spec["static"] = ("avg", True, "f")
                    spec["post"] = ("avg_f",)
                else:
                    arg_scale = (
                        max(f.args[0].ret_type.decimal, 0)
                        if f.args[0].ret_type.is_decimal()
                        else 0
                    )
                    out_scale = max(f.ret_type.decimal, 0)
                    spec["static"] = ("avg", True, "dec")
                    spec["post"] = ("avg_dec", arg_scale, out_scale)
            fspecs.append(spec)
        return fspecs

    # -- the executor ---------------------------------------------------------------

    def next(self):
        if self._done:
            return None
        self._done = True
        c = self.chunk
        n = c.num_rows
        if n == 0:
            return Chunk.empty(self.out_fts, 0)
        eng = self.engine
        if eng == "tpu":
            # forced device: only fall to host when no device form exists
            dev = self._try_device(c, n)
            if dev is not None:
                return dev
        fast = self._whole_partition_fast_path(c, n)
        if fast is not None:
            return fast
        if eng != "tpu":
            dev = self._try_device(c, n)
            if dev is not None:
                return dev
        from ..copr.host_engine import _lex_argsort

        def cmp_lane(e):
            d, v = self._lane(e, c, n)
            return collation_key_lane(d, e.ret_type), v

        part_lanes = [cmp_lane(e) for e in self.part_by]
        order_lanes = [(cmp_lane(e), desc) for e, desc in self.order_by]
        keys = [(d, v, False) for d, v in part_lanes]
        keys += [(d, v, desc) for (d, v), desc in order_lanes]
        order = _lex_argsort(keys, n) if keys else np.arange(n)

        def changed(lanes) -> np.ndarray:
            ch = np.zeros(n, dtype=bool)
            for d, v in lanes:
                sd, sv = d[order], v[order]
                if n > 1:
                    null_flip = sv[1:] != sv[:-1]
                    both = sv[1:] & sv[:-1]
                    ch[1:] |= null_flip | (both & (sd[1:] != sd[:-1]))
            return ch

        pstart = np.zeros(n, dtype=bool)
        pstart[0] = True
        pstart |= changed(part_lanes)
        pid = np.cumsum(pstart) - 1
        pidx = np.nonzero(pstart)[0]
        pend = np.append(pidx[1:], n) - 1
        pfirst_row = pidx[pid]
        plast_row = pend[pid]
        psize = (pend - pidx + 1)[pid]
        rn = np.arange(n) - pfirst_row

        ostart = pstart | (changed([l for l, _ in order_lanes]) if order_lanes else False)
        peer_id = np.cumsum(ostart) - 1
        oidx = np.nonzero(ostart)[0]
        oend_arr = np.append(oidx[1:], n) - 1
        peer_last = oend_arr[peer_id]
        frame_end = peer_last if self.order_by else plast_row

        env = dict(
            n=n, order=order, pid=pid, pidx=pidx, pend=pend,
            pfirst=pfirst_row, plast=plast_row, psize=psize, rn=rn,
            peer_id=peer_id, oidx=oidx, oend=oend_arr, peer_last=peer_last,
            frame_end=frame_end, order_lanes=order_lanes,
        )
        cols = list(c.columns)
        nbase = len(cols)
        for i, f in enumerate(self.funcs):
            ft = self.out_fts[nbase + i]
            sd, sv = self._compute(f, c, env)
            data = np.empty_like(sd)
            valid = np.empty(n, dtype=bool)
            data[order] = sd
            valid[order] = sv
            cols.append(Column(ft, data, valid))
        return Chunk(cols)

    # -- frame bounds over the sorted domain ------------------------------------

    def _frame_bounds(self, f, env):
        """Per-row frame [fs, fe] (sorted-row indices, clipped to the
        partition) + non-empty mask for window func `f`. `None` frame keeps
        MySQL default semantics."""
        n = env["n"]
        ones = np.ones(n, dtype=bool)
        fr = f.frame
        if fr is None:
            return env["pfirst"], env["frame_end"], ones
        pfirst, plast = env["pfirst"], env["plast"]
        if fr.unit == "rows":
            iota = np.arange(n)

            def pos(kind, off, cur):
                if kind == "up":
                    return pfirst
                if kind == "uf":
                    return plast
                if kind == "cur":
                    return cur
                return iota - off if kind == "pre" else iota + off

            fs_raw = pos(fr.start_kind, fr.start_off, iota)
            fe_raw = pos(fr.end_kind, fr.end_off, iota)
        else:
            fs_raw, fe_raw = self._range_bounds(fr, env)
        ne = (fs_raw <= fe_raw) & (fs_raw <= plast) & (fe_raw >= pfirst)
        return np.clip(fs_raw, pfirst, plast), np.clip(fe_raw, pfirst, plast), ne

    def _range_bounds(self, fr, env):
        """RANGE frame edges: UNBOUNDED/CURRENT resolve to partition/peer
        ends; offset bounds binary-search the single numeric ORDER BY key
        per partition. NULL-key rows frame their peer (NULL) block on
        offset sides."""
        peer_first = env["oidx"][env["peer_id"]]
        peer_last = env["peer_last"]
        pfirst, plast = env["pfirst"], env["plast"]
        simple = {"up": pfirst, "uf": plast}
        need_search = fr.start_kind in ("pre", "fol") or fr.end_kind in ("pre", "fol")
        fs = simple.get(fr.start_kind, peer_first)
        fe = simple.get(fr.end_kind, peer_last)
        if not need_search:
            return fs, fe
        n = env["n"]
        (d, v), desc = env["order_lanes"][0]
        order = env["order"]
        sd, sv = d[order], v[order]
        kk = sd
        off_s, off_e = fr.start_off, fr.end_off
        if kk.dtype == np.uint64 or isinstance(off_s, float) or isinstance(off_e, float):
            kk = kk.astype(np.float64)
        if desc:
            kk = -kk  # descending keys → ascending space; offsets flip with it
        fs = np.array(np.broadcast_to(fs, n), dtype=np.int64)
        fe = np.array(np.broadcast_to(fe, n), dtype=np.int64)
        for p0, p1 in zip(env["pidx"], env["pend"]):
            sl = slice(p0, p1 + 1)
            kv, vv = kk[sl], sv[sl]
            vpos = np.nonzero(vv)[0]
            if len(vpos) == 0:
                continue  # all-NULL partition: peers already in place
            vlo, vhi = vpos[0], vpos[-1]
            vkeys = kv[vlo: vhi + 1]
            rows = vpos  # only valid-key rows get value-based bounds
            if fr.start_kind in ("pre", "fol"):
                tgt = kv[rows] - off_s if fr.start_kind == "pre" else kv[rows] + off_s
                fs[p0 + rows] = p0 + vlo + np.searchsorted(vkeys, tgt, side="left")
            if fr.end_kind in ("pre", "fol"):
                tgt = kv[rows] - off_e if fr.end_kind == "pre" else kv[rows] + off_e
                fe[p0 + rows] = p0 + vlo + np.searchsorted(vkeys, tgt, side="right") - 1
        return fs, fe

    # -- per-function kernels over the sorted domain ----------------------------

    def _compute(self, f, c, env):
        n, order = env["n"], env["order"]
        name = f.name
        ones = np.ones(n, dtype=bool)
        if name == "row_number":
            return env["rn"] + 1, ones
        if name == "rank":
            return env["oidx"][env["peer_id"]] - env["pfirst"] + 1, ones
        if name == "dense_rank":
            return env["peer_id"] - env["peer_id"][env["pfirst"]] + 1, ones
        if name == "ntile":
            k = f.args[0].value.to_int()
            s, rn = env["psize"], env["rn"]
            big, rem = s // k, s % k
            cut = rem * (big + 1)
            tile = np.where(
                big > 0,
                np.where(rn < cut, rn // np.maximum(big + 1, 1), rem + (rn - cut) // np.maximum(big, 1)),
                rn,
            )
            return tile + 1, ones
        if name == "cume_dist":
            return (env["peer_last"] - env["pfirst"] + 1) / env["psize"], ones
        if name == "percent_rank":
            rank = env["oidx"][env["peer_id"]] - env["pfirst"] + 1
            return np.where(env["psize"] > 1, (rank - 1) / np.maximum(env["psize"] - 1, 1), 0.0), ones
        if name in ("lead", "lag"):
            d, v = self._lane(f.args[0], c, n)
            sd, sv = d[order], v[order]
            off = f.args[1].value.to_int() if len(f.args) > 1 else 1
            tgt = np.arange(n) + (off if name == "lead" else -off)
            ok = (tgt >= 0) & (tgt < n)
            tgt_c = np.clip(tgt, 0, n - 1)
            ok &= env["pid"][tgt_c] == env["pid"]
            if len(f.args) > 2:
                dd, dv = self._lane(f.args[2], c, n)
                dd, dv = dd[order], dv[order]
            else:
                dd, dv = np.zeros_like(sd), np.zeros(n, dtype=bool)
            data = np.where(ok, sd[tgt_c], dd)
            valid = np.where(ok, sv[tgt_c], dv)
            return data, valid
        if name in ("first_value", "last_value", "nth_value"):
            d, v = self._lane(f.args[0], c, n)
            sd, sv = d[order], v[order]
            fs_, fe_, ne_ = self._frame_bounds(f, env)
            if name == "first_value":
                pos, ok = fs_, ne_
            elif name == "last_value":
                pos, ok = fe_, ne_
            else:
                k = f.args[1].value.to_int()
                pos = fs_ + k - 1
                ok = ne_ & (pos <= fe_)
                pos = np.minimum(pos, n - 1)
            return sd[pos], sv[pos] & ok
        if name in ("count", "sum", "avg", "min", "max"):
            return self._compute_agg(f, c, env)
        raise TiDBError(f"unsupported window function {name}")

    def _compute_agg(self, f, c, env):
        n, order = env["n"], env["order"]
        name = f.name
        fs_, fe_, ne_ = self._frame_bounds(f, env)
        if f.args:
            d, v = self._lane(f.args[0], c, n)
            sd, sv = d[order], v[order]
        else:
            sd, sv = np.ones(n, dtype=np.int64), np.ones(n, dtype=bool)
        if sd.dtype == object and name in ("sum", "avg"):
            raise TiDBError(f"window {name} over string operands is not supported")
        cnt_cs = np.cumsum(sv.astype(np.int64))
        before = np.where(fs_ > 0, cnt_cs[np.maximum(fs_ - 1, 0)], 0)
        frame_cnt = np.where(ne_, cnt_cs[fe_] - before, 0)
        if name == "count":
            return frame_cnt, np.ones(n, dtype=bool)
        if name in ("sum", "avg"):
            is_f = sd.dtype == np.float64
            vals = np.where(sv, sd, 0.0 if is_f else 0)
            val_cs = np.cumsum(vals)
            vbefore = np.where(fs_ > 0, val_cs[np.maximum(fs_ - 1, 0)], 0)
            frame_sum = np.where(ne_, val_cs[fe_] - vbefore, 0)
            if name == "sum":
                return frame_sum, frame_cnt > 0
            if is_f or f.ret_type.is_float():
                with np.errstate(divide="ignore", invalid="ignore"):
                    return np.where(frame_cnt > 0, frame_sum / np.maximum(frame_cnt, 1), 0.0), frame_cnt > 0
            # decimal AVG: exact Dec division at peer granularity for the
            # default frame; explicit frames vary per row
            arg_scale = max(f.args[0].ret_type.decimal, 0) if f.args[0].ret_type.is_decimal() else 0
            out_scale = max(f.ret_type.decimal, 0)
            rows = env["oidx"] if f.frame is None else np.arange(n)
            qs = np.zeros(len(rows), dtype=np.int64)
            qv = np.zeros(len(rows), dtype=bool)
            for g, p in enumerate(rows):
                s_, c_ = int(frame_sum[p]), int(frame_cnt[p])
                if c_ > 0:
                    q = Dec(s_, arg_scale).div(Dec(c_, 0))
                    if q is not None:
                        qs[g] = q.rescale(out_scale).value
                        qv[g] = True
            if f.frame is None:
                return qs[env["peer_id"]], qv[env["peer_id"]]
            return qs, qv
        return self._compute_minmax(f, env, sd, sv, fs_, fe_, ne_, frame_cnt)

    def _compute_minmax(self, f, env, sd, sv, fs_, fe_, ne_, frame_cnt):
        n = env["n"]
        name = f.name
        valid = (frame_cnt > 0) & ne_
        is_obj = sd.dtype == object
        if is_obj:
            ks = collation_key_lane(sd, f.args[0].ret_type if f.args else None)

            def better(j, cur_k, cur_raw):
                # weight orders; equal weights keep the first value
                if ks[j] == cur_k:
                    return False
                return (ks[j] < cur_k) if name == "min" else (ks[j] > cur_k)

            if f.frame is None:
                return self._minmax_obj_default(env, sd, sv, fe_, ks, better)
            # explicit frame over a string lane: per-row scan (host-only path)
            out = np.empty(n, dtype=object)
            outv = np.zeros(n, dtype=bool)
            for i in range(n):
                if not ne_[i]:
                    continue
                cur, curk, curv = None, None, False
                for j in range(fs_[i], fe_[i] + 1):
                    if sv[j] and (not curv or better(j, curk, cur)):
                        cur, curk, curv = sd[j], ks[j], True
                out[i], outv[i] = cur, curv
            return out, outv
        ufunc = np.minimum if name == "min" else np.maximum
        fill = (np.inf if name == "min" else -np.inf) if sd.dtype == np.float64 else (
            np.iinfo(sd.dtype).max if name == "min" else np.iinfo(sd.dtype).min
        )
        masked = np.where(sv, sd, fill)
        fr = f.frame
        starts_at_pfirst = fr is None or (fr.start_kind == "up")
        if starts_at_pfirst:
            # growing frame: running accumulate per partition, read at fe
            acc = np.empty_like(masked)
            for p0, p1 in zip(env["pidx"], env["pend"]):
                acc[p0: p1 + 1] = ufunc.accumulate(masked[p0: p1 + 1])
            return acc[fe_], valid
        # sliding frame: sparse table (range-min-query) over the masked
        # lane — queries never cross a partition (fs/fe are clipped)
        w = np.maximum(fe_ - fs_ + 1, 1)
        L = max(1, int(np.max(w)).bit_length())
        levels = [masked]
        for k in range(1, L):
            h = 1 << (k - 1)
            prev = levels[-1]
            shifted = np.concatenate([prev[h:], np.full(h, fill, dtype=prev.dtype)])
            levels.append(ufunc(prev, shifted))
        stk = np.stack(levels)
        k = (np.frexp(w.astype(np.float64))[1] - 1).astype(np.int64)  # floor(log2 w), exact
        half = np.left_shift(np.int64(1), k)
        res = ufunc(stk[k, fs_], stk[k, np.maximum(fe_ - half + 1, 0)])
        return res, valid

    def _minmax_obj_default(self, env, sd, sv, fe_, ks, better):
        n = env["n"]
        acc = np.empty(n, dtype=object)
        accv = np.zeros(n, dtype=bool)
        for p0, p1 in zip(env["pidx"], env["pend"]):
            cur, curk, curv = None, None, False
            for i in range(p0, p1 + 1):
                if sv[i] and (not curv or better(i, curk, cur)):
                    cur, curk, curv = sd[i], ks[i], True
                acc[i], accv[i] = cur, curv
        return acc[fe_], accv[fe_]
