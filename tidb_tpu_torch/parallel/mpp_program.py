"""The device program of an MPP fragment plan (ref:
tidb_tpu/parallel/mpp.py:1402-1981 `MPPEngine._build_program`): one rank's
share of the reference's SPMD program over a mesh of n_dev ranks
(parallel/mesh.Mesh), every exchange and collective the identity at
n_dev 1.

    scan stage  (P1, expr_eval)    each scan's row ids, row validity and
                                   lanes (the rank's block of a sharded
                                   scan); a scan's pushed conditions (unless
                                   prefiltered on the host) in one
                                   kernels/expr_eval launch
    join level, per JoinFrag:
      lut_join  (P3)               kernels/lut_join: probe the level's LUT
                                   (replicated: no exchange)
      exchange  (P2)               a HASH sort-probe level over n_dev > 1
                                   ranks: kernels/exchange buckets both
                                   sides by owner, one all_to_all each
      sort_join (P4)               kernels/sort_join: sort the build keys,
                                   probe; a duplicate-key level expands into
                                   its compact slots (a per-device share of
                                   the join's size over n_dev ranks)
    aggregation, by the mode the host chose:
      rows      —                  the root level writes [mask, row id per
                                   scan]; the host aggregates the rows
      clustered (P7 + P9)          kernels/run_agg, kernels/block_topk on the
                                   rank's run-aligned shard
      rowpos    (P6)               kernels/rowpos_agg (K4 scatter, K6 picks;
                                   over n_dev ranks psum_scatter / pmin /
                                   pmax between them, the picks per block)
      sorted    (P5)               kernels/seg_reduce (K8 sort, K6 picks;
                                   over n_dev ranks a local reduce, P2's
                                   exchange of whole groups, a final reduce)
      dense     (P8)               kernels/dense_agg, then psum / pmin /
                                   pmax of its rows over n_dev ranks
    post-join conditions and every aggregate argument: one expr_eval launch
    each (expr/program.py compiles the trees)

The result is the reference's packed (n+1, W) int64 matrix (jaxenv.pack_rows
layout) per rank: the host writes the tag row, the last kernel writes the
output rows straight into their views, and the drop-count row holds the
sum over the ranks of every exchange's and duplicate-key level's dropped
rows. The engine concatenates the ranks' matrices (dense: rank 0's), and
one device-to-host copy fetches it.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from ..expr.program import ValueSpec, evaluate
from ..expr.xp_torch import U64
from ..kernels.block_topk import Emit, block_topk
from ..kernels.dense_agg import DenseKey, dense_agg
from ..kernels.exchange import OwnerKey, bucket_cap, exchange, unpack
from ..kernels.lut_join import lut_join
from ..kernels.red import RedLane, kind
from ..kernels.rowpos_agg import picks, rowpos_agg
from ..kernels.run_agg import run_agg
from ..kernels.seg_reduce import GroupKey, seg_reduce
from ..kernels.sort_join import capacity, sort_join
from ..planner.fragment import HASH, ScanFrag
from ..torchenv import _KIND_BOOL, _KIND_F64, _KIND_I64


def _bits(d):
    return d.bits if isinstance(d, U64) else d


def _full(x, n: int):
    """A lane of n rows from an evaluated (possibly 0-d) result."""
    x = _bits(x)
    return torch.broadcast_to(x, (n,)) if x.dim() == 0 else x


def _cond_mask(cache, conds, lanes, mask):
    """mask & v & (d != 0) over `conds` (ref: :1431 / :1557 / :1649): one
    expr_eval launch, none without a condition."""
    if not conds:
        return mask
    return evaluate(cache, conds, [], lanes, mask, mask.shape[0])[0]


class _Rank:
    """One rank's run of the program: its mesh, device, phase timer (rank
    0's only: PhaseTimer is not thread-safe) and the local dropped-row
    counts of its exchanges and duplicate-key levels."""

    def __init__(self, mesh, rank: int, timer=None):
        self.mesh = mesh
        self.rank = rank
        self.n_dev = mesh.n_dev
        self.device = mesh.device(rank)
        self.timer = timer
        self.drops: list = []

    def phase(self, name: str):
        return self.timer.phase(name) if self.timer is not None else nullcontext()


def _exchange_lanes(rk, mask, keys, key_i32: bool, probe: bool, lanes: list):
    """P2 and its all_to_all over rk's mesh: (moved mask, moved lanes),
    n_dev * bcap rows each, peer by peer (ref: :1465-1514)."""
    n_dev = rk.n_dev
    bcap = bucket_cap(mask.shape[0], n_dev)
    lanes = [mask] + [t.contiguous() for t in lanes]
    send, dropped = exchange(n_dev, bcap, mask, keys, key_i32, probe, lanes)
    rk.drops.append(dropped)
    outs = unpack(rk.mesh.all_to_all(rk.rank, send), lanes, n_dev, bcap)
    return outs[0], outs[1:]


def exchange_all(rk, lanemap, mask, rowids, keys, key_i32: bool, probe: bool, keep):
    """P2's hash exchange of a join side (ref: :1465-1514): every lane of
    `lanemap` in `keep` (the columns read later), the mask and the row ids to the
    rank owning each row's key (kernels/exchange: the owner key from
    `keys`, a probe side's invalid key by row index). At n_dev 1 every
    row already lives on its owner, and the reference returns before any
    device work."""
    if rk.n_dev == 1:
        return lanemap, mask, rowids
    cols = [j for j in lanemap if j in keep]
    fids = list(rowids)
    lanes = [t for j in cols for t in (_bits(lanemap[j][0]), lanemap[j][1])] + [rowids[f] for f in fids]
    moved_mask, moved = _exchange_lanes(rk, mask, keys, key_i32, probe, lanes)
    it = iter(moved)
    new_map = {}
    for j in cols:
        d, v = next(it), next(it)
        new_map[j] = (U64(d) if isinstance(lanemap[j][0], U64) else d, v)
    return new_map, moved_mask, {f: next(it) for f in fids}


def _as_bool(m):
    return m if m.dtype == torch.bool else m != 0


class _Rows:
    """Rows mode's packed result, allocated by the root level once its
    output length is known."""

    def __init__(self, prog, rk):
        self.prog = prog
        self.rk = rk
        self.packed = None
        self.row = {id(s): 2 + i for i, s in enumerate(prog.mplan.scans)}

    def alloc(self, L: int):
        kinds = [_KIND_BOOL] + [_KIND_I64] * len(self.prog.mplan.scans)
        self.packed = self.prog._packed(self.rk, kinds, L, L)
        return self.packed


class MPPProgram:
    """One fragment plan's device program (the reference's jitted program
    for one program key); n ranks may run one program at once, each with
    its own _Rank."""

    def __init__(self, engine, mplan, meta, scan_arg_meta, n_dev: int = 1):
        self.engine = engine
        self.mplan = mplan
        self.n_dev = n_dev
        self.soj = meta["scan_of_joined"]
        self.r_pushed = meta["r_pushed"]
        self.levels = meta["levels"]
        self.agg_meta = meta["agg"]
        self.programs = engine._dev_eng.programs
        self.arg_plan = {}
        pos = 0
        for fid, offs, _sharded, pref, unsigned in scan_arg_meta:
            self.arg_plan[fid] = (pos, offs, pref, unsigned)
            pos += 2 + 2 * len(offs)
        self.sd_by_fid = {id(sd.frag): sd for sd, _ in self.soj.values()}
        # joined columns read after their level: later probe keys, ON
        # conditions, aggregate arguments and (dense / sorted) group keys;
        # a level gathers (and an exchange moves) only those
        used: set[int] = set()
        for lvl in self.levels.values():
            used.update(lvl.frag.probe_keys)
            for c in lvl.r_post:
                c.collect_columns(used)
        if self.agg_meta is not None:
            for ra in self.agg_meta["r_args"]:
                for x in ra:
                    x.collect_columns(used)
            if self.agg_meta["mode"] in ("dense", "sorted"):
                for g in mplan.agg.group_by:
                    g.collect_columns(used)
        self.used = used

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
        mask = rv if pref else _cond_mask(self.programs, self.r_pushed[id(sd)], lanes, rv)
        joined = {sd.frag.side_offset + off: lv for off, lv in lanes.items()}
        return joined, mask, {fid: rowid}

    def __call__(self, flat, luts, mesh, rank: int = 0, timer=None) -> torch.Tensor:
        """Rank `rank`'s packed result over its `flat` scan lanes and `luts`
        (the reference's kernel under shard_map)."""
        rk = _Rank(mesh, rank, timer)
        mplan = self.mplan
        with rk.phase("scan"):
            stages = {id(s): self.scan_stage(id(s), flat) for s in mplan.scans}
        rows = _Rows(self, rk) if self.agg_meta is None else None
        lanemap, mask, rowids = self.join(rk, mplan.root, stages, luts, rows)
        mode = None if self.agg_meta is None else self.agg_meta["mode"]
        if mode is None:
            packed = rows.packed
        elif mode == "clustered":
            packed = self.clustered(rk, lanemap, mask, rowids)
        elif mode == "rowpos":
            packed = self.rowpos(rk, lanemap, mask, rowids)
        elif mode == "sorted":
            packed = self.sorted_agg(rk, lanemap, mask)
        else:
            packed = self.dense(rk, lanemap, mask)
        if rk.drops or rk.n_dev > 1:
            d = torch.stack(rk.drops).sum(0) if rk.drops else torch.zeros(1, dtype=torch.int64, device=rk.device)
            packed[-1].copy_(rk.mesh.psum(rank, d).expand(packed.shape[1]))
        return packed

    def _packed(self, rk, kinds, L, k):
        """The (n+1, W) matrix with its tag row and zero drop row written;
        W >= n + 1 so the tags fit (columns past k stay zero)."""
        kinds = kinds + [_KIND_I64]  # the dropped-row count
        n = len(kinds)
        W = max(L, n + 1)
        packed = (torch.zeros if W > k else torch.empty)((n + 1, W), dtype=torch.int64, device=rk.device)
        tag = torch.zeros(W, dtype=torch.int64)
        tag[:n] = torch.tensor(kinds, dtype=torch.int64)
        tag[-1] = n
        packed[0].copy_(tag)
        packed[n].zero_()
        return packed

    # ------------------------------------------------------------- joins

    def join(self, rk, frag, stages, luts, rows):
        """(lanemap, mask, rowids) of a (sub)chain (ref: :1546-1653); the
        root level of a rows-mode program writes the packed rows."""
        if isinstance(frag, ScanFrag):
            return stages[id(frag)]
        pmap, pmask, prow = self.join(rk, frag.probe, stages, luts, rows)
        bmap, bmask, brow = stages[id(frag.build)]
        lvl = self.levels[id(frag)]
        root = rows if rows is not None and frag is self.mplan.root else None
        direct = root if not lvl.r_post else None
        if lvl.use_lut:
            with rk.phase("lut_join"):
                merged, mask, rowids = self.lut_level(frag, lvl, pmap, pmask, prow, bmap, bmask, brow,
                                                      luts[id(frag)], direct)
        else:
            if frag.exchange == HASH and rk.n_dev > 1:
                with rk.phase("exchange"):
                    (pmap, pmask, prow), (bmap, bmask, brow) = self.exchange_level(rk, frag, lvl, pmap, pmask,
                                                                                   prow, bmap, bmask, brow)
            with rk.phase("sort_join"):
                merged, mask, rowids = self.sort_level(rk, frag, lvl, pmap, pmask, prow, bmap, bmask, brow,
                                                       direct)
        if lvl.r_post:
            mask = _cond_mask(self.programs, lvl.r_post, merged, mask)
            if root is not None:
                L = mask.shape[0]
                packed = root.alloc(L)
                packed[1, :L].copy_(mask)
                for s in self.mplan.scans:
                    packed[root.row[id(s)], :L].copy_(rowids[id(s)])
        return merged, mask, rowids

    def _gathers(self, bmap):
        idx = sorted(j for j in bmap if j in self.used)
        return idx, [(_bits(bmap[j][0]), bmap[j][1]) for j in idx]

    @staticmethod
    def _merge(into, idx, got, like):
        for j, (d, v) in zip(idx, got):
            into[j] = (U64(d) if isinstance(like[j][0], U64) else d, v)

    def lut_level(self, frag, lvl, pmap, pmask, prow, bmap, bmask, brow, lut, rows):
        """P3 (ref: :1516-1544)."""
        keys = [(_bits(pmap[j][0]), pmap[j][1]) for j in frag.probe_keys]
        gather_idx, gathers = self._gathers(bmap)
        out = {}
        if rows is not None:
            L = pmask.shape[0]
            packed = rows.alloc(L)
            out = dict(match_out=packed[1, :L], rowid_out=packed[rows.row[id(frag.build)], :L],
                       copies=[(r, packed[rows.row[fid], :L]) for fid, r in prow.items()])
        match, rowid, got = lut_join(keys, lvl.lut_lo, lvl.lut_size, lvl.lut_stride, pmask, lut,
                                     bmask, brow[id(frag.build)], gathers, **out)
        merged = dict(pmap)
        self._merge(merged, gather_idx, got, bmap)
        rowids = dict(prow)
        rowids[id(frag.build)] = rowid
        return merged, _as_bool(match), rowids

    def exchange_level(self, rk, frag, lvl, pmap, pmask, prow, bmap, bmask, brow):
        """P2 at both sides of a HASH level (ref: :1564-1569): the probe
        rows by where(pkv, pkey, arange(rows)), the build rows by bkey; a
        side moves its keys and the lanes read later."""
        def keys(lanemap, idx):
            return [OwnerKey(_bits(lanemap[j][0]).contiguous(), lanemap[j][1].contiguous(), lo, st)
                    for j, lo, st in zip(idx, lvl.key_lo, lvl.key_stride)]

        probe = exchange_all(rk, pmap, pmask, prow, keys(pmap, frag.probe_keys), lvl.key_i32, True,
                             self.used | set(frag.probe_keys))
        build = exchange_all(rk, bmap, bmask, brow, keys(bmap, frag.build_keys), lvl.key_i32, False,
                             self.used | set(frag.build_keys))
        return probe, build

    def sort_level(self, rk, frag, lvl, pmap, pmask, prow, bmap, bmask, brow, rows):
        """P4 (ref: :1570-1653), after P2's exchange where the level has one."""
        pkeys = [(_bits(pmap[j][0]), pmap[j][1]) for j in frag.probe_keys]
        bkeys = [(_bits(bmap[j][0]), bmap[j][1]) for j in frag.build_keys]
        gather_idx, gathers = self._gathers(bmap)
        n, B = pmask.shape[0], bmask.shape[0]
        left = frag.kind != "inner"
        M = lvl.mult
        probe_idx = sorted(j for j in pmap if j in self.used) if M > 1 else []
        plane = [(_bits(pmap[j][0]), pmap[j][1]) for j in probe_idx]
        C = capacity(n, B, lvl.expected_out, left, rk.n_dev) if M > 1 else 0
        fids = list(prow)
        out = None
        if rows is not None:
            L = n if M == 1 else C
            packed = rows.alloc(L)
            out = {"mask": packed[1, :L], "rowid": packed[rows.row[id(frag.build)], :L],
                   "prows": [packed[rows.row[fid], :L] for fid in fids]}
        res = sort_join(pkeys, bkeys, lvl.key_lo, lvl.key_stride, lvl.key_i32, pmask, bmask,
                        brow[id(frag.build)], M, left, C, gathers, plane, [prow[f] for f in fids], out=out)
        if M == 1:
            merged, rowids = dict(pmap), dict(prow)
        else:
            merged = {}
            self._merge(merged, probe_idx, res.probe_lanes, pmap)
            rowids = dict(zip(fids, res.prows))
            rk.drops.append(res.dropped)
        self._merge(merged, gather_idx, res.gathered, bmap)
        rowids[id(frag.build)] = res.rowid
        return merged, _as_bool(res.mask), rowids

    # ------------------------------------------------------ aggregations

    def _args(self, lanemap, n):
        """(data, valid, unsigned) of every aggregate's argument ((None,
        None, False) for COUNT(*)), from one expr_eval launch (ref: :1678,
        :1879, :2050); integer lanes as int64 (narrow lanes add as int64)."""
        ras = self.agg_meta["r_args"]
        _, vals = evaluate(self.programs, [], [ValueSpec(ra[0]) for ra in ras if ra], lanemap, None, n, mask=False)
        it = iter(vals)
        out = []
        for ra in ras:
            if not ra:
                out.append((None, None, False))
                continue
            (d,), v, kind = next(it)
            d = d if kind == "f64" else d.to(torch.int64)
            out.append((d.contiguous(), _full(v, n).contiguous(), kind == "u64"))
        return out

    def partial_lanes(self, lanemap, n, dev, sorted_mode: bool = False):
        """The partial lanes per aggregate: `_agg_partials` (ref: :2048), or
        sorted_agg_stage's (:1676-1698), which keeps a uint64 sum in its
        dtype where `_agg_partials` casts it to int64."""
        lanes = []
        for a, (d, v, unsigned) in zip(self.mplan.agg.aggs, self._args(lanemap, n)):
            if a.name == "count":
                lanes.append(RedLane("count", None, v))
                continue
            if d is None:  # an argument-free sum / min / max sees the constant 1
                d = torch.ones(n, dtype=torch.int64, device=dev)
            if a.name in ("sum", "avg"):
                op = "sum_f64" if d.dtype == torch.float64 else ("sum_u64" if unsigned and sorted_mode else "sum_i64")
            elif a.name in ("min", "max"):
                op = a.name + ("_f64" if d.dtype == torch.float64 else "_u64" if unsigned else "_i64")
            else:
                raise NotImplementedError(a.name)
            lanes += [RedLane(op, d, v), RedLane("count", None, v)]
        return lanes

    def dense(self, rk, lanemap, mask):
        """Dense partials (ref: :1960-1976): P8 writes the count lane and
        every partial lane into the packed rows; over n_dev ranks each row
        is then the psum / pmin / pmax of the ranks' rows (one collective),
        the same on every rank."""
        am = self.agg_meta
        agg = self.mplan.agg
        n, nseg = mask.shape[0], am["nseg"]
        with rk.phase("dense_agg"):
            keys = []
            for g, dom, km in zip(agg.group_by, am["domains"], am["key_meta"]):
                d, v = lanemap[g.idx]
                keys.append(DenseKey(_bits(d).contiguous(), v.contiguous(), km[1] if km[0] == "int" else 0, dom))
            lanes = [RedLane("count", None, None)] + self.partial_lanes(lanemap, n, rk.device)
            packed = self._packed(rk, [kind(ln.op) for ln in lanes], nseg, nseg)
            rows = packed[1:1 + len(lanes)]
            dense_agg(mask, keys, nseg, lanes, rows=rows)
        if rk.n_dev > 1:
            with rk.phase("collectives"):
                rows = rows[:, :nseg]
                parts = [r.view(torch.float64) if ln.is_float else r for r, ln in zip(rows, lanes)]
                for r, tot in zip(rows, rk.mesh.reduce_lanes(rk.rank, parts, [ln.op for ln in lanes])):
                    r.copy_(tot.view(torch.int64) if tot.dtype == torch.float64 else tot)
        return packed

    def sorted_agg(self, rk, lanemap, mask):
        """Sorted aggregation with its fused top-k (ref: :1655-1786): P5
        writes [group code, valid, lanes...] at the picks; over n_dev ranks
        its local reduce's groups travel to their owners through P2 between
        the local and the final reduce."""
        am = self.agg_meta
        agg = self.mplan.agg
        n = mask.shape[0]
        with rk.phase("seg_reduce"):
            keys = []
            for g, km, st in zip(agg.group_by, am["key_meta"], am["strides"]):
                d, v = lanemap[g.idx]
                is_int = km[0] == "int"
                keys.append(GroupKey(_bits(d).contiguous(), v.contiguous(), km[1] if is_int else 0,
                                     km[2] if is_int else 1, st, is_int))
            lanes = self.partial_lanes(lanemap, n, rk.device, sorted_mode=True)
            agg_idx, desc, k = am["topn"]
            ex = None
            n_out = n
            if rk.n_dev > 1:
                n_out = rk.n_dev * bucket_cap(n, rk.n_dev)

                def ex(ukey, uvals, uvalid):
                    """Whole groups to the owner of their code (ref: :1771-1779)."""
                    moved_mask, moved = _exchange_lanes(rk, uvalid, [OwnerKey(ukey, None, 0, 1)], False, False,
                                                        [ukey] + list(uvals))
                    return moved[0], moved[1:], moved_mask
            kk = min(k, n_out)
            packed = self._packed(rk, [_KIND_I64, _KIND_BOOL] + [kind(ln.op) for ln in lanes], kk, kk)
            seg_reduce(keys, mask, lanes, self.engine._topn_lane_pos(agg.aggs, agg_idx), desc, k,
                       rows=packed[1:3 + len(lanes)], exchange=ex, n_dev=rk.n_dev)
        return packed

    def rowpos(self, rk, lanemap, mask, rowids):
        """Aggregation by build row position (ref: :1788-1848): P6 writes
        [group row, valid, lanes...] at the picks; over n_dev ranks the
        ranks' partials meet by psum_scatter (sums) and pmin / pmax then a
        slice (min / max), one collective, and each rank picks from its
        block of build rows."""
        am = self.agg_meta
        agg = self.mplan.agg
        n, B = mask.shape[0], am["rp_rows"]
        with rk.phase("rowpos_agg"):
            lanes = self.partial_lanes(lanemap, n, rk.device)
            pres, base = am["rp_presence"], 0
            if pres is None:
                # no aggregate lane provably equals the presence count: a
                # dedicated one, not shipped
                lanes.insert(0, RedLane("count", None, None))
                pres, base = 0, 1
            agg_idx, desc, k = am["topn"]
            blk = -(-B // rk.n_dev)
            collect = None
            if rk.n_dev > 1:
                def collect(full, ops):
                    return rk.mesh.reduce_lanes(rk.rank, full, ops, scatter=True), rk.mesh.axis_index(rk.rank) * blk
            kk = picks(k, len(lanes), blk)
            shipped = lanes[base:]
            packed = self._packed(rk, [_KIND_I64, _KIND_BOOL] + [kind(ln.op) for ln in shipped], kk, kk)
            rowpos_agg(mask, rowids[am["rp_fid"]].contiguous(), B, lanes, pres,
                       self.engine._topn_lane_pos(agg.aggs, agg_idx, base), desc, k, base,
                       rows=packed[1:3 + len(shipped)], n_dev=rk.n_dev, collect=collect)
        return packed

    def clustered(self, rk, lanemap, mask, rowids):
        """Clustered aggregation (ref: :1850-1929): P7 run totals, then P9
        picks the k best groups and writes the result rows — on the rank's
        run-aligned shard, with no collective."""
        am = self.agg_meta
        agg = self.mplan.agg
        n = mask.shape[0]
        with rk.phase("run_agg"):
            kd = _bits(lanemap[am["rp_ck"]][0])
            lanes = []
            for a, (d, v, _) in zip(agg.aggs, self._args(lanemap, n)):
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
        with rk.phase("topk"):
            kk = min(max(k, n_agg - base + 6), n)
            outs = totals[base:n_agg]
            kinds = [_KIND_I64, _KIND_BOOL] + [_KIND_F64 if t.dtype == torch.float64 else _KIND_I64 for t in outs]
            packed = self._packed(rk, kinds, kk, kk)
            block_topk(score, kk, Emit(packed[1:3 + len(outs)], valid, gpos, outs))
        return packed
