"""The device program of a fused MPP chain on one card (ref:
tidb_tpu/parallel/mpp.py:1402-1981 `MPPEngine._build_program` at n_dev 1,
where every exchange and collective is the identity).

    scan stage  (P1, torch glue)   each scan's row ids, row validity and
                                   lanes; a build scan's pushed conditions
                                   through the port's `_eval_device`
    lut_join    (P3, per level)    kernels/lut_join: probe the level's LUT,
                                   gather the build lanes used downstream
    run_agg     (P7)               kernels/run_agg over the aggregate
                                   arguments (torch glue, as K2)
    topk        (P9)               kernels/block_topk

The result is the reference's packed (n+1, L) int64 matrix (jaxenv.pack_rows
layout): the host writes the tag row and the zero drop-count row, the last
kernel writes the output rows straight into their views — in clustered
mode P9 writes [group row, valid, agg lanes...] for its k picks, in rows
mode the last P3 launch writes [mask, row id per scan...]. One
device-to-host copy then fetches it.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from ..expr.xp_torch import U64
from ..kernels.block_topk import Emit, block_topk
from ..kernels.lut_join import lut_join
from ..kernels.run_agg import run_agg
from ..planner.fragment import ScanFrag
from ..torchenv import _KIND_BOOL, _KIND_F64, _KIND_I64


def _bits(d):
    return d.bits if isinstance(d, U64) else d


def _full(x, n: int):
    """A lane of n rows from an evaluated (possibly 0-d) result."""
    x = _bits(x)
    return torch.broadcast_to(x, (n,)) if x.dim() == 0 else x


def _cond_mask(eval_dev, conds, lanes, mask):
    for c in conds:
        d, v = eval_dev(c, lanes)
        mask = mask & _full(v, mask.shape[0]) & (_full(d, mask.shape[0]) != 0)
    return mask


class MPPProgram:
    """One fragment plan's device program (the reference's jitted program
    for one program key)."""

    def __init__(self, engine, mplan, meta, scan_arg_meta):
        self.engine = engine
        self.mplan = mplan
        self.soj = meta["scan_of_joined"]
        self.r_pushed = meta["r_pushed"]
        self.levels = meta["levels"]
        self.agg_meta = meta["agg"]
        self.eval_dev = engine._dev_eng._eval_device
        self.arg_plan = {}
        pos = 0
        for fid, offs, _sharded, pref, unsigned in scan_arg_meta:
            self.arg_plan[fid] = (pos, offs, pref, unsigned)
            pos += 2 + 2 * len(offs)
        self.sd_by_fid = {id(sd.frag): sd for sd, _ in self.soj.values()}
        # joined columns read after their level: later probe keys, ON
        # conditions, aggregate arguments; a level gathers only those
        used: set[int] = set()
        for lvl in self.levels.values():
            used.update(lvl.frag.probe_keys)
            for c in lvl.r_post:
                c.collect_columns(used)
        if self.agg_meta is not None:
            for ra in self.agg_meta["r_args"]:
                for x in ra:
                    x.collect_columns(used)
        self.used = used

    def _phase(self, name):
        t = self.engine.timer
        return t.phase(name) if t is not None else nullcontext()

    def scan_stage(self, fid, flat):
        """(joined lanes, mask, {fid: rowid}) of one scan (ref: :1431)."""
        base, offs, pref, unsigned = self.arg_plan[fid]
        rowid, rv = flat[base], flat[base + 1]
        lanes = {}
        for k, off in enumerate(offs):
            d = flat[base + 2 + 2 * k]
            lanes[off] = (U64(d) if off in unsigned else d, flat[base + 3 + 2 * k])
        sd = self.sd_by_fid[fid]
        # a prefiltered scan's lanes hold only its surviving rows
        mask = rv if pref else _cond_mask(self.eval_dev, self.r_pushed[id(sd)], lanes, rv)
        joined = {sd.frag.side_offset + off: lv for off, lv in lanes.items()}
        return joined, mask, {fid: rowid}

    def __call__(self, flat, luts) -> torch.Tensor:
        mplan = self.mplan
        with self._phase("scan"):
            stages = {id(s): self.scan_stage(id(s), flat) for s in mplan.scans}
        rows_mode = self.agg_meta is None
        packed = None
        if rows_mode:
            L = stages[id(self.engine._stream_source(mplan.root))][1].shape[0]
            kinds = [_KIND_BOOL] + [_KIND_I64] * len(mplan.scans)
            packed = self._packed(kinds, L, L)
        with self._phase("lut_join"):
            lanemap, mask, rowids = self.join(mplan.root, stages, luts, packed)
        if rows_mode:
            return packed
        return self.clustered(lanemap, mask, rowids)

    def _packed(self, kinds, L, k):
        """The (n+1, W) matrix with its tag row and zero drop row written;
        W >= n + 1 so the tags fit (columns past k stay zero)."""
        kinds = kinds + [_KIND_I64]  # the dropped-row count
        n = len(kinds)
        W = max(L, n + 1)
        dev = self.engine.device
        packed = (torch.zeros if W > k else torch.empty)((n + 1, W), dtype=torch.int64, device=dev)
        tag = torch.zeros(W, dtype=torch.int64)
        tag[:n] = torch.tensor(kinds, dtype=torch.int64)
        tag[-1] = n
        packed[0].copy_(tag)
        packed[n].zero_()
        return packed

    def join(self, frag, stages, luts, packed):
        """(lanemap, mask, rowids) of a (sub)chain (ref: :1546-1561); the
        root level of a rows-mode program writes the packed rows."""
        if isinstance(frag, ScanFrag):
            return stages[id(frag)]
        pmap, pmask, prow = self.join(frag.probe, stages, luts, packed)
        bmap, bmask, brow = stages[id(frag.build)]
        lvl = self.levels[id(frag)]
        keys = [(_bits(pmap[j][0]), pmap[j][1]) for j in frag.probe_keys]
        gather_idx = sorted(j for j in bmap if j in self.used)
        gathers = [(_bits(bmap[j][0]), bmap[j][1]) for j in gather_idx]
        out = {}
        if packed is not None and frag is self.mplan.root and not lvl.r_post:
            L = pmask.shape[0]
            row = {id(s): 2 + i for i, s in enumerate(self.mplan.scans)}
            out = dict(match_out=packed[1, :L], rowid_out=packed[row[id(frag.build)], :L],
                       copies=[(r, packed[row[fid], :L]) for fid, r in prow.items()])
        match, rowid, got = lut_join(keys, lvl.lut_lo, lvl.lut_size, lvl.lut_stride, pmask, luts[id(frag)],
                                     bmask, brow[id(frag.build)], gathers, **out)
        merged = dict(pmap)
        for j, (d, v) in zip(gather_idx, got):
            merged[j] = (U64(d) if isinstance(bmap[j][0], U64) else d, v)
        rowids = dict(prow)
        rowids[id(frag.build)] = rowid
        mask = match if match.dtype == torch.bool else match != 0
        if lvl.r_post:
            mask = _cond_mask(self.eval_dev, lvl.r_post, merged, mask)
            if packed is not None and frag is self.mplan.root:
                L = mask.shape[0]
                packed[1, :L].copy_(mask)
                for i, s in enumerate(self.mplan.scans):
                    packed[2 + i, :L].copy_(rowids[id(s)])
        return merged, mask, rowids

    def clustered(self, lanemap, mask, rowids):
        """Clustered aggregation (ref: :1850-1929): P7 run totals, then P9
        picks the k best groups and writes the result rows."""
        am = self.agg_meta
        agg = self.mplan.agg
        n = mask.shape[0]
        with self._phase("run_agg"):
            kd = _bits(lanemap[am["rp_ck"]][0])
            lanes = []
            for a, ra in zip(agg.aggs, am["r_args"]):
                if ra:
                    d, v = self.eval_dev(ra[0], lanemap)
                    d, v = _full(d, n), _full(v, n)
                    if d.dtype != torch.float64:
                        # widen BEFORE the sum: narrow lanes add as int64
                        d = d.to(torch.float64) if d.dtype == torch.float32 else d.to(torch.int64)
                    d, v = d.contiguous(), v.contiguous()
                else:
                    d, v = None, None
                if a.name == "count":
                    lanes.append((None, v))
                else:  # sum / avg: the clustered guard excluded min/max
                    lanes += [(d, v), (None, v)]
            pres = am["rp_presence"]
            base = 0
            if pres is None:
                lanes.insert(0, (None, None))
                base = 1
            n_agg = len(lanes)
            lanes.append((rowids[am["rp_fid"]], None))
            agg_idx, desc, k = am["topn"]
            score_lane = self.engine._topn_lane_pos(agg.aggs, agg_idx, base)
            totals, gpos, valid, score = run_agg(kd, mask, lanes, 0 if base == 1 else pres, n_agg, score_lane,
                                                 desc)
        with self._phase("topk"):
            kk = min(max(k, n_agg - base + 6), n)
            outs = totals[base:n_agg]
            kinds = [_KIND_I64, _KIND_BOOL] + [_KIND_F64 if t.dtype == torch.float64 else _KIND_I64 for t in outs]
            packed = self._packed(kinds, kk, kk)
            block_topk(score, kk, Emit(packed[1:3 + len(outs)], valid, gpos, outs))
        return packed
