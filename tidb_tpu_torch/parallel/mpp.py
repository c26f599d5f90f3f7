"""MPP engine, host half (ref: tidb_tpu/parallel/mpp.py MPPEngine).

The reference compiles a fragment plan (planner/fragment.py) into one SPMD
program over a device mesh. The port keeps its single controller: one
engine runs the host half once, lays out every scan per rank of a
parallel/mesh.Mesh (a sharded scan's block to each rank, a replicated
scan and every LUT whole), runs one MPPProgram per rank on the mesh's
threads, and assembles the ranks' packed results as the reference's
out_specs do (dense: rank 0's, replicated by its psum; every other mode
concatenated along dim 1 in rank order, `P(None, axis)`). Without a mesh
it runs on one rank, where every exchange and collective is the identity
(mpp.py:1478-1481, :1810-1812). This module is the host half, copied:

* `ScanData` and `_Level`; `prepare` with `_restream_largest`, the
  string → dict-code rewrite of pushed conditions, the per-level key
  analyses and LUT eligibility, `_prepare_agg*` (dense / sorted / rowpos /
  clustered) and the clustered dispatch guards;
* the stat caches, `_pushed_selection` (the stream's pushed conditions
  resolved on the host; the device sees only the survivors),
  `_clustered_splits`, `_shard_pad`, `_build_lut`, `_pack_host`;
* `execute`: the lane layout (padded to a multiple of n_dev rows, or cut
  at `_clustered_splits`) and uploads, through a device-tensor cache
  (`_dev_put`; ranks sharing a device take views of one upload) and a LUT
  cache keyed like the reference's BuildSideCache sig, so a warm run
  uploads nothing; then the device program on every rank and the
  finalizers `_finalize_agg` / `_finalize_topk` / `_finalize_rowpos` /
  `_finalize_rows` / `_partial_agg_cols`;
* `fallbacks`, `fallback_counts`, `last_fallback_reason`, `_decline_key`,
  `last_fuse_outcome`, `last_fuse_reasons` and `compile_count`, under the
  reference's names and reasons.

The device program (parallel/mpp_program.py) runs every join level of
the reference — LUT (P3) and sort-probe (P4) with unique or duplicate
build keys, inner and left — and every aggregation mode: dense (P8),
sorted (P5), rowpos (P6, also where the clustered guards demote),
clustered (P7 + P9) and rows (the joined mask and row ids; the host
finishes the aggregation), with `tidb_tpu_mpp_fused` ON or OFF, and P2's
hash exchange at the HASH levels over more than one rank. Where the
reference's `prepare` declines (returns None), or an exchange bucket or a
duplicate-key level overflows its capacity, `execute` counts the same
typed reason and
returns None (the reference then takes its host join, which the port has
not: executor/mpp_gather raises).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from ..chunk.chunk import Chunk, Column, col_numpy_dtype, VARLEN
from ..copr.gpu_engine import TorchEngine, _dict_encode_lane, _upload
from ..expr.expression import Column as ExprCol, Constant, Expression, ScalarFunc
from ..expr.program import evaluate
from ..expr.xp_torch import U64
from ..planner.fragment import BROADCAST, HASH, LOCAL, JoinFrag, MPPPlan, ScanFrag
from ..torchenv import resolve_device, unpack_rows
from .mesh import make_mesh
from .mpp_program import MPPProgram

I64_MAX = np.iinfo(np.int64).max
DIRECT_GROUP_MAX = 1 << 16


class ScanData:
    """Host-side lanes for one scan: full numpy columns (for output
    gather) plus dict-encoded device lanes for the columns the program
    reads (ref: mpp.py:62-104)."""

    def __init__(self, frag: ScanFrag, data: list[np.ndarray], valid: list[np.ndarray],
                 version: int = -1, shared=None, orig_offs: list[int] | None = None):
        self.frag = frag
        self.data = data  # per ds.out_cols position
        self.valid = valid
        self.n_rows = len(data[0]) if data else 0
        self.vocabs: dict[int, list] = {}
        self._dev: dict[int, np.ndarray] = {}
        # (table_id, data_version) identity for the engine's caches; -1
        # disables caching (unknown provenance)
        self.version = version
        self.shared = shared  # MPPEngine, for cross-dispatch stat caches
        self.orig_offs = orig_offs  # table-level offsets per local position

    def lane(self, off: int) -> tuple[np.ndarray, np.ndarray]:
        """Device-shaped lane for a scan-local column offset (dict-encodes
        object lanes on first use; encodings cache per table version)."""
        if off not in self._dev:
            d, v = self.data[off], self.valid[off]
            if d.dtype == object:
                def enc(_d=d, _v=v):
                    codes, vocab = _dict_encode_lane(_d, _v)
                    return codes.astype(np.int64), vocab

                if self.shared is not None and self.version >= 0 and self.orig_offs:
                    d, vocab = self.shared._cached_stat(self, ("enc", self.orig_offs[off]), enc)
                else:
                    d, vocab = enc()
                self.vocabs[off] = vocab
            elif d.dtype == bool:
                d = d.astype(np.int64)
            self._dev[off] = d
        return self._dev[off], self.valid[off]


def _pad(a: np.ndarray, total: int):
    out = np.zeros(total, dtype=a.dtype)
    out[: len(a)] = a
    return out


class _Level:
    """Static per-join-level metadata resolved on host (ref: mpp.py:113).
    A LUT level probes a direct-address table (packed build key → build
    row position) packed with BUILD-local lo/stride, so its content
    depends on the build table alone."""

    def __init__(self, frag: JoinFrag, key_lo: list[int], key_stride: list[int]):
        self.frag = frag
        self.key_lo = key_lo
        self.key_stride = key_stride
        self.r_post: list[Expression] = []
        self.mult = 1  # 1 = unique build keys, 2 = compact dup path
        self.expected_out: int | None = None  # exact pre-filter join card
        self.key_i32 = False  # packed key domain fits int32 sort lanes
        self.use_lut = False
        self.lut_lo: list[int] = []
        self.lut_size: list[int] = []
        self.lut_stride: list[int] = []
        self.lut_dom = 0
        self.fuse_reason = ""


class MPPEngine:
    """The port's MPP engine (ref: MPPEngine): `device` is where it runs
    without a mesh; it defaults to "cuda" and is never swapped for the CPU
    on the engine's own initiative."""

    DEV_CACHE_BYTES = 4 << 30  # device-tensor cache budget
    STAT_CACHE_BYTES = 1 << 30

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._programs: dict = {}
        self.compile_count = 0
        self.fallback_counts: dict[str, int] = {}
        self.last_fallback_reason = ""
        self._decline_key = "not_supported"
        # device tensors keyed by (table_id, version, tag, total, sharded):
        # a re-dispatch of the same plan uploads no unchanged lane
        self._dev_cache: dict = {}
        self._dev_cache_nbytes = 0
        # host analyses (min/max, multiplicity, dict encodings, pushed
        # selections, splits) keyed by (table, version, tag)
        self._stat_cache: dict = {}
        self._stat_cache_nbytes = 0
        # device LUTs keyed by (table_id, sig): the reference's
        # BuildSideCache key for a full-table span
        self._lut_cache: dict = {}
        self.last_fuse_outcome = ""
        self.last_fuse_reasons: dict[int, str] = {}
        # expression glue: string rewrites and the host-side evaluation of
        # pushed selections on the CPU, the scan stage on the device
        self._host_eng = TorchEngine("cpu")
        self._dev_eng = TorchEngine(self.device)
        # optional torchenv.PhaseTimer for the spans (scan, lut_join,
        # run_agg, topk, d2h, finalize, host_agg); host-clock seconds of
        # the last call's host analysis and uploads in `last_host_s`
        self.timer = None
        self.last_host_s: dict[str, float] = {}
        self.last_h2d_bytes = 0  # bytes the last execute uploaded
        # table id → (column arrays, version, valid lanes) of the caller's
        # numpy tables (executor/mpp_gather.scan_datas)
        self.table_versions: dict = {}

    # --- typed fallback accounting ---------------------------------------

    @property
    def fallbacks(self) -> int:
        return sum(self.fallback_counts.values())

    def _decline(self, key: str, detail: str) -> None:
        self._decline_key = key
        self.last_fallback_reason = detail

    def _fallback(self, key: str, detail: str | None = None) -> None:
        self.fallback_counts[key] = self.fallback_counts.get(key, 0) + 1
        self._decline_key = key
        if detail is not None:
            self.last_fallback_reason = detail

    @staticmethod
    def _entry_nbytes(ent) -> int:
        n = 0
        for x in ent if isinstance(ent, (tuple, list)) else (ent,):
            nb = getattr(x, "nbytes", None)
            if nb is not None:
                n += nb
            elif isinstance(x, (list, str, bytes)):
                n += 64 * len(x)
            else:
                n += 64
        return n

    def _stat_key(self, sd, tag):
        if sd.version < 0:
            return None
        return (sd.frag.ds.table.id, sd.version, tag)

    def _cached_stat(self, sd, tag, compute):
        key = self._stat_key(sd, tag)
        if key is None:
            return compute()
        ent = self._stat_cache.get(key)
        if ent is not None:
            self._stat_cache[key] = self._stat_cache.pop(key)  # LRU touch
        if ent is None:  # 1-tuples so a None RESULT still caches
            ent = (compute(),)
            for k in [k for k in self._stat_cache
                      if k[0] == key[0] and k[2] == key[2] and k[1] != key[1]]:
                self._stat_cache_nbytes -= self._entry_nbytes(self._stat_cache.pop(k))
            self._stat_cache[key] = ent
            self._stat_cache_nbytes += self._entry_nbytes(ent)
            while self._stat_cache_nbytes > self.STAT_CACHE_BYTES and self._stat_cache:
                k = next(iter(self._stat_cache))
                self._stat_cache_nbytes -= self._entry_nbytes(self._stat_cache.pop(k))
        return ent[0]

    def _lane_minmax(self, sd, off):
        def compute():
            d, v = sd.lane(off)
            if d.dtype.kind == "f":
                return "float"
            if not v.any():
                return None
            return (int(d[v].min()), int(d[v].max()))

        return self._cached_stat(sd, ("minmax", off), compute)

    def _lane_sorted(self, sd, off):
        """True iff the raw lane is non-decreasing (equal group keys are
        then contiguous runs of the stream)."""
        def compute():
            d, _ = sd.lane(off)
            if d.dtype == object or d.dtype.kind == "f":
                return False
            return bool(np.all(d[1:] >= d[:-1]))

        return self._cached_stat(sd, ("sorted", off), compute)

    def _clustered_splits(self, sd, koff, sel_tag, n_dev, sel):
        """Run-aligned shard boundaries of the (prefiltered) stream, the
        pow2 padded shard length L and the longest shard (ref: :303)."""
        def compute():
            k = sd.lane(koff)[0]
            if sel is not None:
                k = k[sel]
            n = len(k)
            splits = [0]
            for i in range(1, n_dev):
                b = round(i * n / n_dev)
                if n:
                    b = int(np.searchsorted(k, k[min(b, n - 1)], side="left"))
                splits.append(max(b, splits[-1]))
            splits.append(n)
            rawmax = max(splits[i + 1] - splits[i] for i in range(n_dev))
            L = max(8, 1 << (rawmax - 1).bit_length()) if rawmax else 8
            return (tuple(splits), L, rawmax)

        return self._cached_stat(sd, ("casplit", koff, sel_tag, n_dev), compute)

    @staticmethod
    def _shard_pad(a: np.ndarray, splits, L: int, fill=0) -> np.ndarray:
        n_dev = len(splits) - 1
        out = np.full((n_dev, L), fill, a.dtype)
        for i in range(n_dev):
            seg = a[splits[i]:splits[i + 1]]
            out[i, : len(seg)] = seg
        return out.reshape(-1)

    def _pushed_selection(self, sd, rc):
        """Surviving row indices (int64) of a scan's pushed conditions,
        evaluated once per (table, version, condition set) on the host by
        the expression program's plain version over CPU tensors (ref:
        :346)."""
        def compute():
            if not rc:
                return None
            used: set[int] = set()
            for c in rc:
                c.collect_columns(used)
            lanes = {off: _host_lane(*sd.lane(off)) for off in used}
            mask, _ = evaluate(self._host_eng.programs, rc, [], lanes, torch.ones(sd.n_rows, dtype=torch.bool),
                               sd.n_rows)
            return np.nonzero(mask.numpy())[0].astype(np.int64)

        return self._cached_stat(sd, ("pushsel", repr(rc)), compute)

    def _dev_put(self, key, build, device=None):
        """Device tensor for `key`, uploading build() to `device` (the
        engine's by default) on a miss; stale versions of the same (table,
        tag) are evicted, the rest LRU under DEV_CACHE_BYTES (ref: :371)."""
        device = self.device if device is None else device
        if key is None:
            arr = _upload(build(), device)
            self.last_h2d_bytes += _nbytes(arr)
            return arr
        hit = self._dev_cache.get(key)
        if hit is not None:
            self._dev_cache[key] = self._dev_cache.pop(key)  # LRU touch
            return hit
        tid, ver, tag = key[0], key[1], key[2]
        for k in [k for k in self._dev_cache if k[0] == tid and k[2] == tag and k[1] != ver]:
            self._dev_cache_nbytes -= _nbytes(self._dev_cache.pop(k))
        arr = _upload(build(), device)
        self.last_h2d_bytes += _nbytes(arr)
        self._dev_cache[key] = arr
        self._dev_cache_nbytes += _nbytes(arr)
        while self._dev_cache_nbytes > self.DEV_CACHE_BYTES and self._dev_cache:
            k = next(iter(self._dev_cache))
            self._dev_cache_nbytes -= _nbytes(self._dev_cache.pop(k))
        return arr

    # ------------------------------------------------------------ planning

    @staticmethod
    def _restream_largest(mplan: MPPPlan, by_frag: dict) -> None:
        """Rotate an all-inner left-deep chain so the LARGEST scan is the
        probe stream (ref: :402); the joined schema is unchanged."""
        levels = []
        f = mplan.root
        while isinstance(f, JoinFrag):
            if f.kind != "inner":
                return
            levels.append(f)
            f = f.probe
        if not isinstance(f, ScanFrag) or len(levels) < 2:
            return
        chain_scans = [f] + [lv.build for lv in reversed(levels)]

        def owner(j):
            for s in chain_scans:
                if s.side_offset <= j < s.side_offset + s.n_cols:
                    return s
            return None

        pairs = []
        for lv in levels:
            for pk, bk in zip(lv.probe_keys, lv.build_keys):
                if owner(pk) is None or owner(bk) is None:
                    return
                pairs.append((pk, bk))
        all_post = [c for lv in levels for c in lv.post_conds]
        stream = max(chain_scans, key=lambda s: by_frag[id(s)].n_rows)
        if stream is f:
            return
        remaining_pairs = list(pairs)
        used = {id(stream)}
        node = stream
        remaining = [s for s in chain_scans if s is not stream]
        pending_post = list(all_post)

        def attachable(cond):
            refs: set = set()
            cond.collect_columns(refs)
            return all(id(owner(j)) in used for j in refs if owner(j) is not None)

        while remaining:
            attached = None
            for s in remaining:
                link = []
                for a, b in remaining_pairs:
                    oa, ob = owner(a), owner(b)
                    if oa is s and id(ob) in used:
                        link.append((b, a))  # (probe side, build side)
                    elif ob is s and id(oa) in used:
                        link.append((a, b))
                if link:
                    attached = s
                    for pkk, bkk in link:
                        for p in list(remaining_pairs):
                            if p in ((pkk, bkk), (bkk, pkk)):
                                remaining_pairs.remove(p)
                                break
                    node = JoinFrag(node, s, "inner", [p for p, _ in link], [b for _, b in link])
                    used.add(id(s))
                    remaining.remove(s)
                    here = [c for c in pending_post if attachable(c)]
                    if here:
                        node.post_conds = here
                        pending_post = [c for c in pending_post if c not in here]
                    break
            if attached is None:
                return
        if remaining_pairs or pending_post:
            return
        mplan.root = node

    # a LUT is 4 bytes per packed-key slot; rowpos segments one per build row
    LUT_DOM_MAX = 1 << 24
    ROWPOS_MAX = 1 << 22
    # clustered-mode dispatch guards (ref: :497-498)
    CLUSTERED_TOPN_MAX = 64
    CLUSTERED_SKEW_MIN = 4096

    def prepare(self, mplan: MPPPlan, scans: list[ScanData], variables: dict, fused: bool = False):
        """Resolve all data-dependent static choices; None → decline
        (ref: :500-786)."""
        by_frag = {id(s.frag): s for s in scans}
        self._restream_largest(mplan, by_frag)
        scan_of_joined = {}  # joined idx -> (ScanData, local off)
        for s in scans:
            for off in range(len(s.frag.ds.out_cols)):
                scan_of_joined[s.frag.side_offset + off] = (s, off)

        # rewrite pushed conds per scan (string → dict-code space)
        r_pushed: dict[int, list] = {}
        eng = self._host_eng
        for s in scans:
            conds = s.frag.ds.pushed_conds
            used: set[int] = set()
            for c in conds:
                c.collect_columns(used)
            vocabs = {}
            for off in used:
                s.lane(off)
                if off in s.vocabs:
                    vocabs[off] = s.vocabs[off]
            rc = [eng._rewrite(c, vocabs) for c in conds]
            if any(c is None for c in rc):
                self._decline("non_lowerable_cond", "non-lowerable pushed condition")
                return None
            r_pushed[id(s)] = rc

        threshold = int(variables.get("tidb_broadcast_join_threshold_count", 10240))
        size_threshold = int(variables.get("tidb_broadcast_join_threshold_size", 100 * 1024 * 1024))
        levels: list[_Level] = []

        def visit(frag):
            if isinstance(frag, ScanFrag):
                return True
            if not visit(frag.probe):
                return False
            bscan = by_frag[id(frag.build)]
            los, sizes = [], []
            for pk, bk in zip(frag.probe_keys, frag.build_keys):
                ps, poff = scan_of_joined[pk]
                bs, boff = scan_of_joined[bk]
                if poff in ps.vocabs or boff in bs.vocabs:
                    self._decline("string_join_key", "string join key")
                    return False
                vals = []
                for sd, off in ((ps, poff), (bs, boff)):
                    mm = self._lane_minmax(sd, off)
                    if mm == "float":
                        self._decline("float_join_key", "float join key")
                        return False
                    if mm is not None:
                        vals.append(mm)
                if not vals:
                    los.append(0)
                    sizes.append(1)
                    continue
                lo = min(a for a, _ in vals)
                hi = max(b for _, b in vals)
                los.append(lo)
                sizes.append(hi - lo + 1)
            strides = [1] * len(sizes)
            acc = 1
            for i in range(len(sizes) - 1, -1, -1):
                strides[i] = acc
                acc *= sizes[i]
                if acc > 1 << 62:
                    self._decline("domain_overflow", "join key domain overflow")
                    return False
            lvl = _Level(frag, los, strides)
            lvl.key_i32 = acc < (1 << 31) - 2

            def key_mult(sd, key_idxs):
                """Max multiplicity (1 or 2) of a key tuple on scan `sd`."""
                offs2 = tuple(scan_of_joined[k][1] for k in key_idxs)

                def compute():
                    los2, sizes2 = [], []
                    for k in key_idxs:
                        mm = self._lane_minmax(*scan_of_joined[k])
                        if mm == "float" or mm is None:
                            if mm is None:
                                los2.append(0)
                                sizes2.append(1)
                                continue
                            return None
                        los2.append(mm[0])
                        sizes2.append(mm[1] - mm[0] + 1)
                    strides2 = [1] * len(sizes2)
                    acc = 1
                    for i in range(len(sizes2) - 1, -1, -1):
                        strides2[i] = acc
                        acc *= sizes2[i] + 1
                        if acc > 1 << 62:
                            return None
                    packed = self._pack_host(key_idxs, scan_of_joined, los2, strides2)
                    if packed is None:
                        return None
                    kv2, km2 = packed
                    present = kv2[km2]
                    if len(present):
                        _, counts = np.unique(present, return_counts=True)
                        return 1 if int(counts.max()) <= 1 else 2
                    return 1

                return self._cached_stat(sd, ("uniq", offs2), compute)

            mult = key_mult(bscan, frag.build_keys)
            if mult is None:
                self._decline("unpackable_build_keys", "unpackable build keys")
                return False
            lvl.mult = mult
            if fused:
                if frag.kind != "inner":
                    lvl.fuse_reason = "outer_join"
                elif mult != 1:
                    lvl.fuse_reason = "dup_build_keys"
                else:
                    blos, bsizes = [], []
                    for bk in frag.build_keys:
                        mm = self._lane_minmax(*scan_of_joined[bk])
                        if mm is None or mm == "float":
                            blos.append(0)
                            bsizes.append(1)
                        else:
                            blos.append(mm[0])
                            bsizes.append(mm[1] - mm[0] + 1)
                    bstrides = [1] * len(bsizes)
                    bacc = 1
                    for i in range(len(bsizes) - 1, -1, -1):
                        bstrides[i] = bacc
                        bacc *= bsizes[i]
                    if bacc > self.LUT_DOM_MAX:
                        lvl.fuse_reason = "lut_domain_overflow"
                    else:
                        lvl.use_lut = True
                        lvl.lut_lo = blos
                        lvl.lut_size = bsizes
                        lvl.lut_stride = bstrides
                        lvl.lut_dom = int(bacc)

            psds = {id(scan_of_joined[pk][0]) for pk in frag.probe_keys}

            def rows_preserved(f, sd):
                if isinstance(f, ScanFrag):
                    return by_frag[id(f)] is sd
                lv = next((x for x in levels if x.frag is f), None)
                if lv is None:
                    return False
                if by_frag[id(f.build)] is sd:
                    pks = {id(scan_of_joined[pk][0]) for pk in f.probe_keys}
                    if len(pks) != 1:
                        return False
                    ps2 = scan_of_joined[f.probe_keys[0]][0]
                    return rows_preserved(f.probe, ps2) and key_mult(ps2, f.probe_keys) == 1
                return lv.mult == 1 and rows_preserved(f.probe, sd)

            expected = None
            if len(psds) == 1 and mult > 1 and rows_preserved(frag.probe, scan_of_joined[frag.probe_keys[0]][0]):
                psd = scan_of_joined[frag.probe_keys[0]][0]
                poffs = tuple(scan_of_joined[pk][1] for pk in frag.probe_keys)

                def jcard():
                    pk = self._pack_host(frag.probe_keys, scan_of_joined, los, strides)
                    bk = self._pack_host(frag.build_keys, scan_of_joined, los, strides)
                    if pk is None or bk is None:
                        return None
                    pu, pc = np.unique(pk[0][pk[1]], return_counts=True)
                    bu, bc = np.unique(bk[0][bk[1]], return_counts=True)
                    ii = np.searchsorted(pu, bu)
                    iic = np.clip(ii, 0, max(len(pu) - 1, 0))
                    m = (ii < len(pu)) & (pu[iic] == bu) if len(pu) else np.zeros(len(bu), bool)
                    return int(np.sum(pc[iic[m]] * bc[m])) if len(bu) else 0

                boffs2 = tuple(scan_of_joined[bk][1] for bk in frag.build_keys)
                tag = ("jcard", boffs2, poffs, psd.frag.ds.table.id, psd.version)
                expected = self._cached_stat(bscan, tag, jcard)
            lvl.expected_out = expected
            build_bytes = bscan.n_rows * 8 * max(1, len(bscan.frag.ds.out_cols))
            frag.exchange = (BROADCAST if bscan.n_rows <= threshold and build_bytes <= size_threshold
                             else HASH)
            if lvl.use_lut:
                frag.exchange = LOCAL
            if frag.post_conds:
                if frag.kind != "inner":
                    self._decline("outer_join_residual", "outer join with residual ON conditions")
                    return False
                vocabs = {}
                used = set()
                for c in frag.post_conds:
                    c.collect_columns(used)
                for j in used:
                    sd, off = scan_of_joined[j]
                    sd.lane(off)
                    if off in sd.vocabs:
                        vocabs[j] = sd.vocabs[off]
                lvl.r_post = [eng._rewrite(c, vocabs) for c in frag.post_conds]
                if any(c is None for c in lvl.r_post):
                    self._decline("non_lowerable_cond", "non-lowerable ON condition")
                    return False
            levels.append(lvl)
            return True

        if not visit(mplan.root):
            return None

        agg_meta = None
        if mplan.agg is not None:
            agg_meta = self._prepare_agg(mplan, scans, scan_of_joined, levels=levels,
                                         by_frag=by_frag, fused=fused)
            if agg_meta is None:
                # the JOIN still rides the device; the aggregation finishes
                # on the host over the joined rows
                self.last_fallback_reason = "agg on host: group-key domain too wide"
        return {
            "scan_of_joined": scan_of_joined,
            "r_pushed": r_pushed,
            "levels": {id(l.frag): l for l in levels},
            "agg": agg_meta,
        }

    @staticmethod
    def _pack_host(key_idxs, scan_of_joined, los, strides):
        acc = None
        mask = None
        for j, lo, st in zip(key_idxs, los, strides):
            sd, off = scan_of_joined[j]
            d, v = sd.lane(off)
            term = (d.astype(np.int64) - lo) * st
            acc = term if acc is None else acc + term
            mask = v if mask is None else (mask & v)
        if acc is None:
            return None
        return acc, mask

    def _lower_agg_args(self, agg, scan_of_joined):
        r_args = []
        for a in agg.aggs:
            ra = []
            for x in a.args:
                if isinstance(x, ExprCol):
                    sd, off = scan_of_joined[x.idx]
                    sd.lane(off)
                    if off in sd.vocabs:
                        if a.name in ("min", "max"):
                            ra.append(x)  # code order == collation order
                            continue
                        return None
                    ra.append(x)
                    continue
                used = set()
                x.collect_columns(used)
                if any(scan_of_joined[j][1] in scan_of_joined[j][0].vocabs for j in used):
                    return None
                ra.append(x)
            r_args.append(ra)
        return r_args

    # arithmetic that cannot manufacture NULL from non-NULL inputs
    _NULL_PRESERVING = frozenset({"plus", "minus", "mul", "unaryminus"})

    @classmethod
    def _never_null(cls, x) -> bool:
        if isinstance(x, Constant):
            return not x.value.is_null
        if isinstance(x, ExprCol):
            return x.ret_type.not_null
        if isinstance(x, ScalarFunc) and x.sig.name in cls._NULL_PRESERVING:
            return all(cls._never_null(a) for a in x.args)
        return False

    def _prepare_agg_rowpos(self, mplan, scan_of_joined, levels, by_frag):
        """Build-row-position aggregation and its clustered upgrade (ref:
        :847-947)."""
        agg = mplan.agg
        if mplan.topn is None or not levels:
            return None
        agg_idx, _desc, _k = mplan.topn
        if agg.aggs[agg_idx].name not in ("sum", "count"):
            return None
        gsd = None
        goffs = set()
        for g in agg.group_by:
            if not isinstance(g, ExprCol):
                return None
            sd, _off = scan_of_joined[g.idx]
            if gsd is not None and sd is not gsd:
                return None
            gsd = sd
            goffs.add(g.idx)
        if gsd is None:
            return None
        lvl = next((l for l in levels if by_frag[id(l.frag.build)] is gsd), None)
        if lvl is None or lvl.frag.kind != "inner" or lvl.mult != 1:
            return None
        if not set(lvl.frag.build_keys) <= goffs:
            return None
        if not (4096 <= gsd.n_rows <= self.ROWPOS_MAX):
            return None
        r_args = self._lower_agg_args(agg, scan_of_joined)
        if r_args is None:
            return None
        presence = None
        lp = 0
        for a, ra in zip(agg.aggs, r_args):
            if a.name == "count":
                if not ra or self._never_null(ra[0]):
                    presence = lp
                    break
                lp += 1
            else:
                if ra and self._never_null(ra[0]):
                    presence = lp + 1  # the count lane follows the value
                    break
                lp += 2
        mode, ck_idx, creason = "rowpos", None, None
        if not (levels and all(l.use_lut for l in levels)):
            creason = "chain_not_fully_fused"
        elif not all(a.name in ("sum", "count", "avg") for a in agg.aggs):
            creason = "agg_needs_minmax"
        elif len(lvl.frag.probe_keys) != 1:
            creason = "multi_column_stream_key"
        else:
            pk = lvl.frag.probe_keys[0]
            psd, poff = scan_of_joined[pk]
            if psd.frag is not self._stream_source(mplan.root):
                creason = "group_key_not_on_stream"
            elif not self._lane_sorted(psd, poff):
                creason = "stream_not_clustered"
            else:
                mode, ck_idx = "clustered", pk
        return {
            "mode": mode,
            "r_args": r_args,
            "topn": mplan.topn,
            "rp_fid": id(lvl.frag.build),
            "rp_rows": gsd.n_rows,
            "rp_presence": presence,
            "rp_ck": ck_idx,
            "clustered_reason": creason,
            "rp_scan_idx": next(i for i, s in enumerate(mplan.scans) if s is lvl.frag.build),
        }

    def _prepare_agg(self, mplan: MPPPlan, scans, scan_of_joined, levels=None, by_frag=None,
                     fused: bool = False):
        """dense → (fused) rowpos/clustered → sorted (ref: :949-971)."""
        meta = self._prepare_agg_keyed(mplan, scan_of_joined)
        if meta is not None and meta["mode"] == "dense":
            return meta
        if fused:
            rp = self._prepare_agg_rowpos(mplan, scan_of_joined, levels, by_frag)
            if rp is not None:
                return rp
        return meta

    def _prepare_agg_keyed(self, mplan: MPPPlan, scan_of_joined):
        """The dense/sorted packed-group-key modes (ref: :973-1044)."""
        agg = mplan.agg
        domains, key_meta = [], []
        sorted_domains = []
        for g in agg.group_by:
            if not isinstance(g, ExprCol):
                return None
            sd, off = scan_of_joined[g.idx]
            d, v = sd.lane(off)
            if off in sd.vocabs:
                dom = max(len(sd.vocabs[off]), 1)
                domains.append(dom)
                sorted_domains.append(dom)
                key_meta.append(("dict", sd.vocabs[off], 1))
            else:
                if d.dtype.kind == "f" or not len(d):
                    return None

                def key_stats(_sd=sd, _off=off):
                    dd, vv = _sd.lane(_off)
                    pres = dd[vv]
                    if not len(pres):
                        return (0, 0, 1)
                    lo_, hi_ = int(pres.min()), int(pres.max())
                    st = int(np.gcd.reduce((pres - lo_).astype(np.int64))) or 1
                    return (lo_, hi_, st)

                lo, hi, step = self._cached_stat(sd, ("keystats", off), key_stats)
                domains.append(hi - lo + 1)
                sorted_domains.append((hi - lo) // step + 1)
                key_meta.append(("int", lo, step))
        nseg = 1
        dense_ok = True
        for s in domains:
            nseg *= s + 1
            if nseg > DIRECT_GROUP_MAX:
                dense_ok = False
                break
        mode = "dense"
        if not dense_ok:
            if mplan.topn is None:
                return None
            wide = 1
            for s in sorted_domains:
                wide *= s + 1
                if wide > 1 << 62:
                    return None
            agg_idx = mplan.topn[0]
            if agg.aggs[agg_idx].name not in ("sum", "count"):
                return None
            mode = "sorted"
        r_args = self._lower_agg_args(agg, scan_of_joined)
        if r_args is None:
            return None
        meta = {"domains": domains, "key_meta": key_meta, "nseg": nseg, "r_args": r_args, "mode": mode}
        if mode == "sorted":
            radixes = [d + 1 for d in sorted_domains]
            strides = [1] * len(radixes)
            acc = 1
            for i in range(len(radixes) - 1, -1, -1):
                strides[i] = acc
                acc *= radixes[i]
            meta["strides"] = strides
            meta["radixes"] = radixes
            meta["topn"] = mplan.topn
        return meta

    # ------------------------------------------------------------- dispatch

    def execute(self, mplan: MPPPlan, scans: list[ScanData], variables: dict, fused: bool | None = None,
                mesh=None):
        """Run the fragment plan over `mesh` (None: one rank on the
        engine's device) → (Chunk, agg_done): the partial-agg chunk
        (agg_done True) or the joined rows (rows mode; agg_done False when
        an aggregation is left to the host), or None when the plan
        declines (the typed reason is counted)."""
        self.last_fallback_reason = ""
        self._decline_key = "not_supported"
        self.last_host_s = {}
        self.last_h2d_bytes = 0
        t0 = time.perf_counter()
        if fused is None:
            fused = variables.get("tidb_tpu_mpp_fused", "ON") == "ON"
        meta = self.prepare(mplan, scans, variables, fused=fused)
        if meta is None:
            self._fallback(self._decline_key)
            return None
        lvls = list(meta["levels"].values())
        self.last_fuse_reasons = {i: l.fuse_reason for i, l in enumerate(lvls) if l.fuse_reason}
        if not fused:
            outcome = "off"
        elif lvls and all(l.use_lut for l in lvls):
            outcome = "fused"
        elif any(l.use_lut for l in lvls):
            outcome = "partial"
        else:
            outcome = "unfused"
        self.last_fuse_outcome = outcome
        if mesh is None:
            mesh = make_mesh(1, self.device)
        n_dev = mesh.n_dev
        devs = [mesh.device(r) for r in range(n_dev)]
        one_device = all(d == devs[0] for d in devs)

        def put(key, build, per=None):
            """One tensor per rank: the rank's block of `per` rows of a
            sharded lane, a replicated one whole; ranks sharing a device
            take views of one upload, a rank on its own card its own."""
            def block(t, r):
                return t if per is None else t[r * per:(r + 1) * per]

            if one_device:
                t = self._dev_put(key, build, devs[0])
                return [block(t, r) for r in range(n_dev)]
            host = []

            def built():
                if not host:
                    host.append(build())
                return host[0]

            return [self._dev_put(None if key is None else key + (str(d),),
                                  lambda r=r: block(built(), r), d) for r, d in enumerate(devs)]

        soj = meta["scan_of_joined"]
        stream = self._stream_source(mplan.root)
        # which scans are sharded: the stream source + hash-side builds
        sharded = {id(stream)} | {id(l.frag.build) for l in lvls if l.frag.exchange == HASH}
        # the host prefilters a sharded scan only inside a fully fused chain
        all_lut = bool(lvls) and all(l.use_lut for l in lvls)
        agm = meta["agg"]
        if agm is not None and agm["mode"] == "clustered":
            # the clustered dispatch guards (ref: :1169-1193)
            demote = None
            if agm["topn"][2] > self.CLUSTERED_TOPN_MAX:
                demote = "topn_too_wide"
            else:
                ss = next(s for s in scans if s.frag is stream)
                src = meta["r_pushed"][id(ss)]
                ssel = None
                if fused and all_lut and id(ss.frag) in sharded and ss.version >= 0 and src:
                    ssel = self._pushed_selection(ss, src)
                sh = hashlib.sha256(repr(src).encode()).hexdigest()[:12] if ssel is not None else ""
                _, _, rawmax = self._clustered_splits(ss, soj[agm["rp_ck"]][1], sh, n_dev, ssel)
                sn = len(ssel) if ssel is not None else ss.n_rows
                if rawmax > max(2 * -(-sn // n_dev), self.CLUSTERED_SKEW_MIN):
                    demote = "stream_skewed"
            if demote is not None:
                agm["mode"], agm["rp_ck"] = "rowpos", None
                agm["clustered_reason"] = demote

        # device lanes per scan: the levels' keys (a LUT level's build keys
        # live in its LUT) and ON conditions, the aggregate arguments, the
        # group keys of the dense and sorted modes, and (unless prefiltered)
        # the columns of the pushed conditions
        need: dict[int, set] = {id(s): set() for s in scans}
        need_cond: dict[int, set] = {id(s): set() for s in scans}
        used: set[int] = set()
        for lvl in lvls:
            used.update(lvl.frag.probe_keys if lvl.use_lut else lvl.frag.probe_keys + lvl.frag.build_keys)
            for c in lvl.r_post:
                c.collect_columns(used)
        if agm is not None:
            if agm["mode"] not in ("rowpos", "clustered"):
                for g in mplan.agg.group_by:
                    g.collect_columns(used)
            for ra in agm["r_args"]:
                for x in ra:
                    x.collect_columns(used)
        for j in used:
            sd, off = soj[j]
            need[id(sd)].add(off)
        for s in scans:
            for c in meta["r_pushed"][id(s)]:
                c.collect_columns(need_cond[id(s)])

        # flatten args per scan (mplan.scans order): rowid, row_valid, then
        # (data, valid) per needed offset, a list per rank; a prefiltered
        # stream uploads only the survivors of its pushed conditions
        args: list[list] = [[] for _ in range(n_dev)]
        scan_arg_meta, shapes = [], []
        t_prep = time.perf_counter() - t0
        t_h2d = 0.0
        for s in scans:
            t1 = time.perf_counter()
            is_sharded = id(s.frag) in sharded
            rc = meta["r_pushed"][id(s)]
            sel = None
            if fused and all_lut and is_sharded and s.version >= 0 and rc:
                sel = self._pushed_selection(s, rc)
            pref = sel is not None
            offs = sorted(need[id(s)] if pref else need[id(s)] | need_cond[id(s)])
            n = len(sel) if pref else s.n_rows
            tid = s.frag.ds.table.id
            ver = s.version
            h = hashlib.sha256(repr(rc).encode()).hexdigest()[:12] if pref else ""
            if agm is not None and agm["mode"] == "clustered" and s.frag is stream:
                # the stream laid out shard by shard at run-aligned splits:
                # no group straddles two ranks
                koff = soj[agm["rp_ck"]][1]
                splits, L, _ = self._clustered_splits(s, koff, h, n_dev, sel)
                total = n_dev * L

                def lay(a, _sp=splits, _L=L):
                    return self._shard_pad(a, _sp, _L)

                def tg(tag):
                    return ("c", n_dev, tag)

                def _rv(_lay=lay, _n=n):
                    return _lay(np.ones(_n, dtype=bool))
            else:
                total = max(-(-n // n_dev), 1) * n_dev if is_sharded else max(n, 1)

                def lay(a, _t=total):
                    return _pad(a, _t)

                def tg(tag):
                    return tag

                def _rv(_t=total, _n=n):
                    rv = np.zeros(_t, dtype=bool)
                    rv[:_n] = True
                    return rv

            def ck(tag, _tid=tid, _ver=ver, _tot=total, _sh=is_sharded):
                return None if _ver < 0 else (_tid, _ver, tag, _tot, _sh)

            per = total // n_dev if is_sharded else None
            t_prep += time.perf_counter() - t1
            t1 = time.perf_counter()
            lanes = []
            if pref:
                lanes.append(put(ck(tg(("frowid", h))), lambda: lay(sel), per))
            else:
                lanes.append(put(ck(tg("rowid")), lambda: lay(np.arange(n, dtype=np.int64)), per))
            lanes.append(put(ck(tg(("frv", h) if pref else "rv")), _rv, per))
            for off in offs:
                if pref:
                    lanes.append(put(ck(tg(("fd", off, h))), lambda _o=off: lay(s.lane(_o)[0][sel]), per))
                    lanes.append(put(ck(tg(("fv", off, h))), lambda _o=off: lay(s.lane(_o)[1][sel]), per))
                else:
                    lanes.append(put(ck(tg(("d", off))), lambda _o=off: lay(s.lane(_o)[0]), per))
                    lanes.append(put(ck(tg(("v", off))), lambda _o=off: lay(s.lane(_o)[1]), per))
            for r in range(n_dev):
                args[r] += [lane[r] for lane in lanes]
            t_h2d += time.perf_counter() - t1
            unsigned = {off for off in offs if s.lane(off)[0].dtype == np.uint64}
            scan_arg_meta.append((id(s.frag), offs, is_sharded, pref, unsigned))
            shapes.append((total, is_sharded, offs, pref))

        # LUT levels: the device-resident build structure, replicated, after
        # every scan's lanes, cached under the reference's BuildSideCache sig
        by_frag = {id(s.frag): s for s in scans}
        lut_args: list[dict] = [{} for _ in range(n_dev)]
        for lvl in (l for l in lvls if l.use_lut):
            bsd = by_frag[id(lvl.frag.build)]
            boffs = tuple(soj[bk][1] for bk in lvl.frag.build_keys)
            sig = ("lut", bsd.version, boffs, tuple(lvl.lut_lo), tuple(lvl.lut_stride), lvl.lut_dom)
            key = (bsd.frag.ds.table.id, sig) if bsd.version >= 0 else None
            per_dev = {}
            for d in dict.fromkeys(devs):
                dkey = None if key is None else key + (str(d),)
                lut = self._lut_cache.get(dkey) if dkey is not None else None
                if lut is None:
                    t1 = time.perf_counter()
                    host = self._build_lut(lvl, soj)
                    t_prep += time.perf_counter() - t1
                    t1 = time.perf_counter()
                    lut = _upload(host, d)
                    self.last_h2d_bytes += _nbytes(lut)
                    t_h2d += time.perf_counter() - t1
                    if dkey is not None:
                        # an older version of the same structure goes
                        for k in [k for k in self._lut_cache
                                  if k[0] == dkey[0] and k[1][2:] == sig[2:] and k[2] == dkey[2]]:
                            del self._lut_cache[k]
                        self._lut_cache[dkey] = lut
                per_dev[d] = lut
            for r, d in enumerate(devs):
                lut_args[r][id(lvl.frag)] = per_dev[d]
        for d in sorted({d for d in devs if d.type == "cuda"}, key=str):
            t1 = time.perf_counter()
            torch.cuda.synchronize(d)
            t_h2d += time.perf_counter() - t1
        self.last_host_s = {"prep": t_prep, "h2d": t_h2d}

        key = self._program_key(mplan, meta, scans, shapes, n_dev)
        prog = self._programs.get(key)
        if prog is None:
            prog = MPPProgram(self, mplan, meta, scan_arg_meta, n_dev)
            self._programs[key] = prog
            self.compile_count += 1
        timer = self.timer
        packs = mesh.run(lambda r: prog(args[r], lut_args[r], mesh, r, timer if r == 0 else None))
        if n_dev == 1 or (agm is not None and agm["mode"] == "dense"):
            packed = packs[0]  # psum'd: every rank holds the same rows
        else:  # P(None, axis): the ranks' matrices side by side
            packed = torch.cat([p.to(packs[0].device) for p in packs], dim=1)
        with self._phase("d2h"):
            packed = packed.cpu().numpy()
        with self._phase("finalize"):
            outs = unpack_rows(packed)
            dropped = int(outs[-1][0])
            outs = outs[:-1]
            if dropped:
                self._fallback("capacity_overflow", f"exchange bucket overflow ({dropped} rows)")
                return None
            if agm is not None:
                if agm["mode"] == "sorted":
                    return self._finalize_topk(mplan, meta, outs), True
                if agm["mode"] in ("rowpos", "clustered"):
                    return self._finalize_rowpos(mplan, meta, scans, outs), True
                return self._finalize_agg(mplan, meta, outs), True
            return self._finalize_rows(mplan, meta, scans, outs), False

    def _phase(self, name: str):
        from contextlib import nullcontext

        return self.timer.phase(name) if self.timer is not None else nullcontext()

    @staticmethod
    def _build_lut(lvl, scan_of_joined) -> np.ndarray:
        """int32 [lut_dom]: packed build key → build row position, -1 =
        absent; packed with the level's build-local lo/stride over the
        unfiltered lanes (ref: :1341)."""
        lut = np.full(max(lvl.lut_dom, 1), -1, dtype=np.int32)
        packed = MPPEngine._pack_host(lvl.frag.build_keys, scan_of_joined, lvl.lut_lo, lvl.lut_stride)
        if packed is not None:
            kv, km = packed
            lut[kv[km]] = np.nonzero(km)[0].astype(np.int32)
        return lut

    @staticmethod
    def _stream_source(frag):
        while isinstance(frag, JoinFrag):
            frag = frag.probe
        return frag

    def _program_key(self, mplan, meta, scans, shapes, n_dev):
        parts = [repr(shapes), str(n_dev)]
        for s, sh in zip(scans, shapes):
            parts.append("prefiltered" if sh[3] else repr(meta["r_pushed"][id(s)]))
        for fid, lvl in meta["levels"].items():
            parts += [
                lvl.frag.kind, lvl.frag.exchange,
                repr(lvl.frag.probe_keys), repr(lvl.frag.build_keys),
                repr(lvl.key_lo), repr(lvl.key_stride), repr(lvl.r_post),
                str(lvl.mult), str(lvl.expected_out), str(lvl.key_i32),
                str(lvl.use_lut), repr(lvl.lut_lo), repr(lvl.lut_size),
                repr(lvl.lut_stride), str(lvl.lut_dom),
            ]
        if meta["agg"]:
            a = meta["agg"]
            parts += [repr(a.get("domains")),
                      repr([(m[0], m[1], m[2]) if m[0] == "int" else (m[0],) for m in a.get("key_meta", ())]),
                      repr(a["r_args"]), repr([x.name for x in mplan.agg.aggs]),
                      repr(mplan.agg.group_by),
                      a["mode"], repr(a.get("strides")), repr(a.get("topn")),
                      repr(a.get("rp_scan_idx")), repr(a.get("rp_rows")),
                      repr(a.get("rp_presence")), repr(a.get("rp_ck"))]
        return hashlib.sha256("|".join(parts).encode()).hexdigest()

    @staticmethod
    def _topn_lane_pos(aggs, agg_idx, base=0):
        """Flat partial-lane index of the TopN aggregate: count ships one
        lane, every other agg a (value, count) pair (ref: :1997)."""
        lane_pos = base
        for i, a in enumerate(aggs):
            if i == agg_idx:
                break
            lane_pos += 1 if a.name == "count" else 2
        return lane_pos

    # ------------------------------------------------------------ finalize

    @staticmethod
    def _partial_agg_cols(agg, soj, outs, pos, sel, out_fts, oi) -> list[Column]:
        """Per-agg partial-state columns from the device output rows (ref:
        :2082-2126)."""
        G = len(sel)
        cols: list[Column] = []
        for a in agg.aggs:
            if a.name == "count":
                cnt = np.asarray(outs[pos])[sel]
                cols.append(Column(out_fts[oi], cnt.astype(np.int64), np.ones(G, bool)))
                pos += 1
                oi += 1
                continue
            s = np.asarray(outs[pos])[sel]
            cnt = np.asarray(outs[pos + 1])[sel]
            has = cnt > 0
            pos += 2
            if a.name in ("sum", "avg"):
                sd = s if out_fts[oi].is_float() else s.astype(np.int64)
                cols.append(Column(out_fts[oi], sd, has))
                oi += 1
                if a.name == "avg":
                    cols.append(Column(out_fts[oi], cnt.astype(np.int64), np.ones(G, bool)))
                    oi += 1
            elif a.name in ("min", "max"):
                ft = out_fts[oi]
                arg = a.args[0] if a.args else None
                vocab = None
                if isinstance(arg, ExprCol):
                    sd2, off = soj[arg.idx]
                    vocab = sd2.vocabs.get(off)
                if vocab is not None:
                    data = np.empty(G, dtype=object)
                    for j in range(G):
                        data[j] = vocab[int(s[j])] if has[j] and 0 <= int(s[j]) < len(vocab) else None
                    cols.append(Column(ft, data, has))
                else:
                    data = s if ft.is_float() else np.where(has, s.astype(np.int64), 0)
                    cols.append(Column(ft, data, has))
                oi += 1
        return cols

    def _finalize_rowpos(self, mplan, meta, scans, outs) -> Chunk:
        """Rowpos / clustered output → partial-layout chunk: one row per exact
        group (one build-side row); group key values gathered from the
        build scan's original numpy lanes (ref: :2128)."""
        agg = mplan.agg
        agg_meta = meta["agg"]
        soj = meta["scan_of_joined"]
        B = agg_meta["rp_rows"]
        gidx = np.asarray(outs[0]).astype(np.int64)
        valid = np.asarray(outs[1]).astype(bool)
        keep = np.nonzero(valid & (gidx >= 0) & (gidx < B))[0]
        rows = gidx[keep]
        out_fts = [g.ret_type for g in agg.group_by]
        for a in agg.aggs:
            out_fts.extend(ft for _, ft in a.partial_final_types())
        cols: list[Column] = []
        oi = 0
        for g in agg.group_by:
            sd, off = soj[g.idx]
            data = sd.data[off][rows]
            gvalid = sd.valid[off][rows]
            if data.dtype == object:
                data = data.copy()
                data[~gvalid] = None
            cols.append(Column(out_fts[oi], data, gvalid))
            oi += 1
        cols.extend(self._partial_agg_cols(agg, soj, outs, 2, keep, out_fts, oi))
        return Chunk(cols)

    def _finalize_agg(self, mplan, meta, outs) -> Chunk:
        """Dense partial rows → partial-layout chunk (group keys, then per-agg
        partial states) for the final aggregate (ref: :2158)."""
        agg = mplan.agg
        agg_meta = meta["agg"]
        soj = meta["scan_of_joined"]
        group_count = np.asarray(outs[0])
        present = np.nonzero(group_count > 0)[0]
        G = len(present)
        out_fts = [g.ret_type for g in agg.group_by]
        for a in agg.aggs:
            out_fts.extend(ft for _, ft in a.partial_final_types())
        cols: list[Column] = []
        radix = [d + 1 for d in agg_meta["domains"]]
        codes = present.copy()
        key_vals = []
        for r in reversed(radix):
            key_vals.append(codes % r)
            codes = codes // r
        key_vals.reverse()
        oi = 0
        for km, kv in zip(agg_meta["key_meta"], key_vals):
            ft = out_fts[oi]
            valid = kv > 0
            if km[0] == "dict":
                vocab = km[1]
                data = np.empty(G, dtype=object)
                for j, c in enumerate(kv):
                    data[j] = vocab[c - 1] if c > 0 else None
            else:
                data = (kv.astype(np.int64) - 1) + km[1]
                data[~valid] = 0
            cols.append(Column(ft, data, valid))
            oi += 1
        cols.extend(self._partial_agg_cols(agg, soj, outs, 1, present, out_fts, oi))
        return Chunk(cols)

    def _finalize_topk(self, mplan, meta, outs) -> Chunk:
        """Sorted mode's k picks → partial-layout chunk (ref: :2196)."""
        agg = mplan.agg
        agg_meta = meta["agg"]
        soj = meta["scan_of_joined"]
        codes = np.asarray(outs[0])
        valid = np.asarray(outs[1])
        keep = np.nonzero(valid & (codes != np.iinfo(np.int64).max))[0]
        G = len(keep)
        codes = codes[keep]
        out_fts = [g.ret_type for g in agg.group_by]
        for a in agg.aggs:
            out_fts.extend(ft for _, ft in a.partial_final_types())
        cols: list[Column] = []
        oi = 0
        for km, st, radix in zip(agg_meta["key_meta"], agg_meta["strides"], agg_meta["radixes"]):
            comp = (codes // st) % radix
            kvalid = comp > 0
            ft = out_fts[oi]
            if km[0] == "dict":
                vocab = km[1]
                data = np.empty(G, dtype=object)
                for j, c in enumerate(comp):
                    data[j] = vocab[c - 1] if c > 0 else None
            else:
                data = np.where(kvalid, (comp - 1) * km[2] + km[1], 0).astype(np.int64)
            cols.append(Column(ft, data, kvalid))
            oi += 1
        cols.extend(self._partial_agg_cols(agg, soj, outs, 2, keep, out_fts, oi))
        return Chunk(cols)

    def _finalize_rows(self, mplan, meta, scans, outs) -> Chunk:
        """(mask, per-scan rowids) → joined-schema chunk gathered from the
        original numpy lanes (ref: :2229)."""
        mask = np.asarray(outs[0])
        rowids = [np.asarray(o) for o in outs[1:]]
        sel = np.nonzero(mask)[0]
        by_frag = {id(s.frag): (s, i) for i, s in enumerate(scans)}
        cols: list[Column] = []
        for j, pc in enumerate(mplan.out_cols):
            sd, off = meta["scan_of_joined"][j]
            _, si = by_frag[id(sd.frag)]
            rid = rowids[si][sel]
            ok = rid >= 0
            safe = np.clip(rid, 0, max(sd.n_rows - 1, 0))
            src = sd.data[off]
            srcv = sd.valid[off]
            if sd.n_rows == 0:
                dt = col_numpy_dtype(pc.ft)
                data = np.empty(len(sel), dtype=object) if dt is VARLEN else np.zeros(len(sel), dtype=dt)
                valid = np.zeros(len(sel), bool)
            else:
                data = src[safe]
                valid = srcv[safe] & ok
                if data.dtype == object:
                    data = data.copy()
                    data[~valid] = None
            cols.append(Column(pc.ft, data, valid))
        return Chunk(cols)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host_lane(d: np.ndarray, v: np.ndarray):
    """numpy lane → CPU tensors for the expression program (uint64 lanes as
    U64 over their int64 bits)."""
    if d.dtype == np.uint64:
        return U64(torch.from_numpy(np.ascontiguousarray(d).view(np.int64))), torch.from_numpy(v)
    return torch.from_numpy(np.ascontiguousarray(d)), torch.from_numpy(np.ascontiguousarray(v))

