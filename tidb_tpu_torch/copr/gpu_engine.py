"""GPU coprocessor engine — pushed-down DAGs over torch tensors with the
port's hand-written kernels (ref: tidb_tpu/copr/tpu_engine.py TPUEngine).

The reference traces one fused XLA program per DAG. Here the same steps
run eagerly on the card:

    column lanes ──► K1 decode_lane ──► K2/K3 expr_eval ──► one of
    (codec payloads    (kernels/)         one launch: the mask and every
     uploaded once)                       argument / key lane of the DAG
                                          (expr/program.py compiles it)

      direct GROUP BY   K4 seg_agg over the mixed-radix key code
      sort GROUP BY     K9 sort_groups (K8 lex_sort inside) → capped dense
                        group ids → K4 seg_agg in its segment-lane mode
      single-key TopN   K6 topk (radix select; K8 orders the k rows)
      multi-key TopN    K7 topn_multi_ops → K8 lex_sort_perm → first n

then the results come back to the host, which rebuilds the partial chunk
exactly as the reference does (_agg_outputs_to_chunk,
_agg_sorted_to_chunk, the TopN take).

What is ported: DeviceBatch (encode on the host, upload once per batch
and device), `_lower`, `_rewrite`/`_code_cmp` with Vocab and
_dict_encode_lane, `_eval_device`/`_mask` (as one expression program),
the filter-only path, the direct-address and sort-based aggregation
paths (with the reference's
group-capacity escalation, remembered per DAG shape), both TopN paths and
`execute`. It declines — and counts in `fallbacks`, answering through
host_engine.execute_dag_host — exactly the DAGs TPUEngine._lower
declines. Grouped launches (`execute_many`) raise NotPortedError. Lanes,
breakers, placement, tracing and metrics are not ported yet.
"""

from __future__ import annotations

import bisect
from contextlib import nullcontext
from threading import Lock

import numpy as np
import torch

from ..chunk.chunk import Chunk, Column
from ..errors import NotPortedError
from ..expr.expression import Column as ExprCol, Constant, Expression, ScalarFunc
from ..expr.program import ProgramCache, ValueSpec, evaluate
from ..expr.xp_torch import U64
from ..kernels import SegKey, SegLane, decode_lane, lex_sort_perm, seg_agg, sort_groups, topk, topn_multi_ops
from ..mysqltypes.datum import Datum, K_STR, K_BYTES
from ..mysqltypes.field_type import ft_longlong
from ..mysqltypes.mydecimal import pow10
from ..torchenv import resolve_device
from .dag import DAGRequest
from .host_engine import exact_sum64, exact_sumsq64, execute_dag_host
from .tilecache import ColumnBatch, _pad2d, encode_data_lane, encode_valid_lane, pow2_rows

TILE_ROWS = 1 << 16
DIRECT_GROUP_MAX = 1 << 16
# the reference reduces up to this many segments densely (where an empty
# segment keeps the caller's fill) and above it with jax.ops.segment_*
# (where it gets the dtype's identity); only FIRST_ROW's fill tells them
# apart, and the port mirrors both so the raw partials stay bit-identical
SEG_DENSE_MAX = 64
_I64 = np.iinfo(np.int64)

_CMP_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
_VAR = ("stddev_pop", "stddev_samp", "var_pop", "var_samp")
# bitwise aggregates: K4's op and the fill of an empty segment (the
# reference's per-bit segment_min / max / sum % 2 identities, recombined)
_BIT = {"bit_and": ("and_i64", -1), "bit_or": ("or_i64", 0), "bit_xor": ("xor_i64", 0)}


class Vocab(list):
    """Sorted dict-encode vocabulary: ORIGINAL values in code order, plus
    the lookup keys codes were assigned by (weight strings under a ci
    collation, the values themselves under binary)."""

    def __init__(self, originals, keys=None, coll="utf8mb4_bin"):
        super().__init__(originals)
        self.keys = list(self) if keys is None else keys
        self.coll = coll

    def lookup(self, s: str):
        """(insertion position, exact-present) for a constant under this
        vocab's collation — the bisect behind code-space compare/IN."""
        from ..mysqltypes import collate as _c

        k = _c.weight(s, self.coll) if _c.is_ci(self.coll) else s
        i = bisect.bisect_left(self.keys, k)
        return i, i < len(self.keys) and self.keys[i] == k


def _dict_encode_lane(d: np.ndarray, v: np.ndarray, coll: str = "utf8mb4_bin"):
    """Vectorized sorted-dict encoding of an object lane → (int32 codes,
    Vocab) (copy of tpu_engine._dict_encode_lane). Under a ci collation
    codes follow WEIGHT order — equal-weight values share one code whose
    vocab entry is the first occurrence in row order."""
    from ..mysqltypes import collate as _coll

    if not v.any():
        return np.zeros(len(d), np.int32), Vocab([], coll=coll)
    present = d[v]
    kinds = {type(x) for x in present.tolist()}
    if _coll.is_ci(coll) and kinds <= {str}:
        raw = np.where(v, d, "")
        wa = _coll.weight_lane(raw, coll).astype("U")
        sel = np.nonzero(v)[0]
        uniqw, first = np.unique(wa[sel], return_index=True)
        reps = [d[i] for i in sel[first]]
        codes = np.searchsorted(uniqw, wa).astype(np.int32)
        codes[~v] = 0
        return codes, Vocab(reps, keys=uniqw.tolist(), coll=coll)
    if kinds <= {str}:
        vals = np.where(v, d, "").astype("U")
        vocab_arr = np.unique(vals[v])
        codes = np.searchsorted(vocab_arr, vals).astype(np.int32)
        codes[~v] = 0
        return codes, Vocab(vocab_arr.tolist())
    if kinds <= {bytes}:
        as_str = np.array([x.decode("latin-1") for x in present.tolist()], dtype="U")
        vocab_arr = np.unique(as_str)
        codes = np.zeros(len(d), np.int32)
        codes[v] = np.searchsorted(vocab_arr, as_str).astype(np.int32)
        orig = [s.encode("latin-1") for s in vocab_arr.tolist()]
        return codes, Vocab(orig, keys=vocab_arr.tolist())
    vocab = sorted({x if isinstance(x, str) else x.decode("latin-1") for x in present.tolist()})
    code_of = {s: i for i, s in enumerate(vocab)}
    codes = np.zeros(len(d), np.int32)
    for i in np.nonzero(v)[0]:
        x = d[i]
        codes[i] = code_of[x if isinstance(x, str) else x.decode("latin-1")]
    return codes, Vocab(vocab)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy → tensor on `device`. uint16/uint32/uint64 go as signed bit
    views of the same width: the kernels read codes unsigned, and uint64
    values are carried as int64 bit patterns (xp_torch.U64)."""
    a = np.ascontiguousarray(a)
    view = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
            np.dtype(np.uint64): np.int64}.get(a.dtype)
    if view is not None:
        a = a.view(view)
    return torch.from_numpy(a).to(device)


def _upload_payload(pay: dict, device: torch.device) -> dict:
    out = {}
    for k, a in pay.items():
        if k == "b":  # pack base: a launch parameter, kept on the host
            a = np.asarray(a)
            out[k] = torch.tensor(int(a.view(np.int64)) if a.dtype == np.uint64 else a.item(),
                                  dtype=torch.int64 if a.dtype.itemsize == 8 else torch.int32)
        else:
            out[k] = _upload(a, device)
    return out


class DeviceBatch:
    """Device-resident mirror of a ColumnBatch: per used column the
    encoded (data, valid) lanes, uploaded once (ref: tpu_engine.py:283).

    With `compress` (the reference's tidb_tpu_tile_compression default)
    batches up to TILE_ROWS pad to a power-of-two row bucket and every
    lane ships in the cheapest of dense/pack/dict/rle form, decoded on the
    card by K1; `compress=False` keeps the legacy layout: 64Ki-row tiles,
    dense lanes."""

    def __init__(self, batch: ColumnBatch, device: torch.device, compress: bool = True):
        self.batch = batch
        self.device = device
        self.compress = compress
        n = batch.n_rows
        if compress and n <= TILE_ROWS:
            self.t, self.r = 1, pow2_rows(n)
        else:
            self.t, self.r = max((n + TILE_ROWS - 1) // TILE_ROWS, 1), TILE_ROWS
        self.padded = self.t * self.r
        self.vocabs: dict[int, Vocab] = {}
        self._data: dict[int, object] = {}
        self._valid: dict[int, object] = {}
        rv = np.zeros(self.padded, dtype=bool)
        rv[:n] = True
        self.row_valid = _upload(rv.reshape(self.t, self.r), device)

    def lanes(self, off: int, phase=None):
        """(data, valid) device lanes for a table column offset — each a
        dense [T, R] tensor or a codec payload K1 decodes. Object lanes
        dict-encode to sorted-vocab int32 codes first. `phase(name)` (an
        engine's PhaseTimer hook) brackets the host encode and the h2d
        upload of a first touch."""
        if off not in self._data:
            phase = phase or (lambda name: nullcontext())
            with phase("encode"):
                d = self.batch.data[off]
                v = self.batch.valid[off]
                if d.dtype == object:
                    coll = getattr(self.batch.table.columns[off].ft, "collate", "utf8mb4_bin")
                    codes, vocab = _dict_encode_lane(d, v, coll)
                    self.vocabs[off] = vocab
                    d = codes
                if self.compress:
                    pay_d, _ = encode_data_lane(d, v, (self.t, self.r))
                    pay_v, _ = encode_valid_lane(v, (self.t, self.r))
                else:
                    pay_d = pay_v = None
            with phase("h2d"):
                self._data[off] = (_upload(_pad2d(d, (self.t, self.r)), self.device) if pay_d is None
                                   else _upload_payload(pay_d, self.device))
                self._valid[off] = (_upload(_pad2d(v, (self.t, self.r)), self.device) if pay_v is None
                                    else _upload_payload(pay_v, self.device))
        return self._data[off], self._valid[off]


class TorchEngine:
    """The port's device cop engine (ref: TPUEngine). `device` defaults to
    "cuda" and is never swapped for the CPU on the engine's own initiative:
    without a card, construction raises unless the caller passes "cpu"."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._lock = Lock()
        self.fallbacks = 0
        # bucketed/compressed device tiles (the reference's SET GLOBAL
        # tidb_tpu_tile_compression, default ON); OFF = dense 64Ki tiles
        self.tile_compression = True
        # optional torchenv.PhaseTimer: encode / h2d (first touch of a
        # lane) and decode / mask / sort (K6-K9) / agg_args / seg_agg /
        # d2h / finalize spans of each execute
        self.timer = None
        # the kernels' entry points; a caller may wrap one per instance to
        # observe its inputs (chip_smoke.py times each kernel on the main
        # path's own tensors)
        self.seg_agg = seg_agg
        self.topk = topk
        self.topn_multi_ops = topn_multi_ops
        self.lex_sort_perm = lex_sort_perm
        self.sort_groups = sort_groups
        # sort-based GROUP BY group capacity: start at gcap0, escalate x4
        # past an overflow and remember it per DAG shape (the reference's
        # TPUEngine.gcap0 / _gcap)
        self.gcap0 = 1 << 16
        self._gcap: dict = {}
        self.programs = ProgramCache()  # compiled expression programs (K2/K3)

    def phase(self, name: str):
        """The timer's span for `name`, or a no-op without a timer."""
        return self.timer.phase(name) if self.timer is not None else nullcontext()

    # --- public ------------------------------------------------------------

    def execute(self, dag: DAGRequest, batch: ColumnBatch) -> Chunk:
        """Run one cop DAG over one region batch → the partial chunk the
        reference's TPUEngine.execute returns for the same inputs."""
        mirrors = getattr(batch, "_gpu_mirrors", None)
        if mirrors is None:
            mirrors = batch._gpu_mirrors = {}
        mkey = (str(self.device), self.tile_compression)
        dev = mirrors.get(mkey)
        if dev is None:
            dev = mirrors[mkey] = DeviceBatch(batch, self.device, compress=self.tile_compression)
        plan = self._lower(dag, dev)
        if plan is None:
            with self._lock:
                self.fallbacks += 1
            return execute_dag_host(dag, batch)
        return plan()

    def execute_many(self, items):
        raise NotPortedError("tpu_engine.execute_many", "grouped launches (K10)")

    # --- lowering ----------------------------------------------------------

    def _lower(self, dag: DAGRequest, dev: DeviceBatch):
        """→ zero-arg callable producing the result Chunk, or None if this
        DAG can't run on device (host fallback, as the reference)."""
        scan_offs = dag.scan.col_offsets
        used: set[int] = set()
        conds = dag.selection.conds if dag.selection else []
        for c in conds:
            c.collect_columns(used)
        if dag.agg:
            for g in dag.agg.group_by:
                g.collect_columns(used)
            for a in dag.agg.aggs:
                for e in a.args:
                    e.collect_columns(used)
        elif dag.topn:
            for e, _ in dag.topn.by:
                e.collect_columns(used)
            used |= set(range(len(scan_offs)))
        else:
            used |= set(range(len(scan_offs)))

        lanes = {}
        vocabs = {}
        for i in sorted(used):
            off = scan_offs[i]
            lanes[i] = dev.lanes(off, self.phase)
            if off in dev.vocabs:
                vocabs[i] = dev.vocabs[off]

        r_conds = [self._rewrite(c, vocabs) for c in conds]
        if any(c is None for c in r_conds):
            return None
        # lanes of BIGINT UNSIGNED columns decode to U64 (xp_torch)
        unsigned = {i for i in used
                    if i not in vocabs and dev.batch.data[scan_offs[i]].dtype == np.uint64}

        if dag.agg is not None:
            return self._lower_agg(dag, dev, lanes, vocabs, r_conds, unsigned)
        if dag.topn is not None:
            return self._lower_topn(dag, dev, lanes, vocabs, r_conds, unsigned)
        return self._lower_filter(dag, dev, lanes, r_conds, unsigned)

    # --- string/dict rewriting --------------------------------------------

    def _rewrite(self, e: Expression, vocabs: dict[int, list]):
        """Rewrite an expression into device (code-space) form; None if not
        lowerable. String columns become int32 code lanes; comparisons with
        string constants map through the sorted vocab so code order ==
        collation order."""
        if isinstance(e, ExprCol):
            return e
        if isinstance(e, Constant):
            if e.value.kind in (K_STR, K_BYTES):
                return None
            return e
        if not isinstance(e, ScalarFunc):
            return None
        name = e.sig.name
        if name in _CMP_SWAP and len(e.args) == 2:
            a, b = e.args
            if isinstance(b, ExprCol) and isinstance(a, Constant):
                a, b = b, a
                name = _CMP_SWAP[name]
            if isinstance(a, ExprCol) and a.idx in vocabs and isinstance(b, Constant):
                if b.value.kind not in (K_STR, K_BYTES):
                    return None
                return self._code_cmp(name, a, b, vocabs[a.idx])
            if isinstance(a, ExprCol) and a.idx in vocabs:
                return None
        if name == "in" and isinstance(e.args[0], ExprCol) and e.args[0].idx in vocabs:
            vocab = vocabs[e.args[0].idx]
            codes = []
            for c in e.args[1:]:
                if not isinstance(c, Constant) or c.value.kind not in (K_STR, K_BYTES):
                    return None
                i, present = vocab.lookup(c.value.to_str())
                codes.append(i if present else -1)
            col = ExprCol(e.args[0].idx, ft_longlong(), e.args[0].name)
            from ..expr.expression import make_func

            return make_func("in", col, *[Constant(Datum.i(c), ft_longlong()) for c in codes])
        for a in e.args:
            if isinstance(a, ExprCol) and a.idx in vocabs:
                return None
        new_args = [self._rewrite(a, vocabs) for a in e.args]
        if any(a is None for a in new_args):
            return None
        return ScalarFunc(e.sig, new_args, e.ret_type)

    def _code_cmp(self, op: str, col: ExprCol, const: Constant, vocab: Vocab):
        """col <op> 'str' → code-space comparison via sorted-vocab bisect."""
        from ..expr.expression import make_func

        pos, present = vocab.lookup(const.value.to_str())
        icol = ExprCol(col.idx, ft_longlong(), col.name)

        def c(v):
            return Constant(Datum.i(v), ft_longlong())

        if op == "eq":
            return make_func("eq", icol, c(pos if present else -1))
        if op == "ne":
            return make_func("ne", icol, c(pos if present else -1))
        if op == "lt":
            return make_func("lt", icol, c(pos))
        if op == "ge":
            return make_func("ge", icol, c(pos))
        if op == "le":
            return make_func("lt" if not present else "le", icol, c(pos))
        if op == "gt":
            return make_func("ge" if not present else "gt", icol, c(pos))
        return None

    # --- device evaluation (K2/K3: the expression kernel) -----------------

    def _evaluate(self, r_conds, specs, lanes, dev: DeviceBatch, force: bool = False):
        """One expression program over the decoded lanes (ref: :1021
        _eval_device, :1044 _mask): → (flat mask, [(data lanes, valid,
        kind)] per ValueSpec). The mask is row_valid itself when there is
        no condition, unless `force` (the filter program) launches it."""
        mask, vals = evaluate(self.programs, r_conds, specs, lanes, dev.row_valid, dev.padded, force=force)
        return mask.reshape(-1), vals

    def _decode(self, dev: DeviceBatch, lanes: dict, unsigned: set):
        """K1 over every used lane (the reference's _unflatten)."""
        out = {}
        for i, (d, v) in lanes.items():
            dd = decode_lane(d, dev.row_valid)
            if i in unsigned:
                dd = U64(dd)
            out[i] = (dd, decode_lane(v, dev.row_valid))
        return out

    # --- filter-only --------------------------------------------------------

    def _lower_filter(self, dag: DAGRequest, dev: DeviceBatch, lanes, r_conds, unsigned):
        def run():
            with self.phase("decode"):
                l = self._decode(dev, lanes, unsigned)
            with self.phase("expr_eval"):
                mask, _ = self._evaluate(r_conds, [], l, dev, force=True)
            with self.phase("d2h"):
                mask = mask.cpu().numpy()[: dev.batch.n_rows]
            with self.phase("finalize"):
                chunk = dev.batch.to_chunk(dag.scan.col_offsets).filter(mask)
                if dag.limit is not None:
                    chunk = chunk.slice(0, min(dag.limit.n, chunk.num_rows))
            return chunk

        return run

    # --- aggregation --------------------------------------------------------

    def _lower_agg(self, dag: DAGRequest, dev: DeviceBatch, lanes, vocabs, r_conds, unsigned):
        agg = dag.agg
        gb = agg.group_by
        wide_keys = False
        for g in gb:
            if not isinstance(g, ExprCol):
                return None
            if g.idx not in vocabs:
                d = dev.batch.data[dag.scan.col_offsets[g.idx]]
                if d.dtype == np.float64 or d.dtype == np.uint64:
                    wide_keys = True
        from ..mysqltypes import collate as _coll

        dev_args = []
        for a in agg.aggs:
            if a.name not in (
                "count", "sum", "avg", "min", "max", "first_row",
                "stddev_pop", "stddev_samp", "var_pop", "var_samp",
                "bit_and", "bit_or", "bit_xor",
            ):
                return None
            if (
                a.name in ("min", "max")
                and a.args
                and a.args[0].ret_type.is_string()
                and _coll.is_ci(getattr(a.args[0].ret_type, "collate", None))
            ):
                # dict codes collapse a ci weight class to ONE vocab
                # representative chosen batch-wide (pre-filter): host path
                return None
            r_args = [
                self._rewrite(x, vocabs) if not (isinstance(x, ExprCol) and x.idx in vocabs)
                else (x if a.name in ("min", "max", "first_row", "count") else None)
                for x in a.args
            ]
            if any(x is None for x in r_args):
                return None
            dev_args.append(r_args)

        # direct addressing needs NULL-free keys with small finite domains
        domains = []
        key_cols = []
        direct = not wide_keys
        for g in gb:
            if not direct:
                break
            if g.idx in vocabs:
                domains.append(max(len(vocabs[g.idx]), 1))
            else:
                d = dev.batch.data[dag.scan.col_offsets[g.idx]]
                v = dev.batch.valid[dag.scan.col_offsets[g.idx]]
                if not v.all() or len(d) == 0:
                    direct = False
                    break
                lo, hi = int(d.min()), int(d.max())
                if hi - lo + 1 > DIRECT_GROUP_MAX:
                    direct = False
                    break
                domains.append(hi - lo + 1)
                key_cols.append((g.idx, lo))
                continue
            key_cols.append((g.idx, 0))
        nseg = 1
        for s in domains:
            nseg *= s + 1  # +1 slot for NULL keys
        if not direct or nseg > DIRECT_GROUP_MAX:
            return self._lower_agg_sorted(dag, dev, lanes, vocabs, r_conds, unsigned, dev_args)

        specs = [self._agg_spec(a, r_args) for a, r_args in zip(agg.aggs, dev_args)]

        def run():
            with self.phase("decode"):
                l = self._decode(dev, lanes, unsigned)
            with self.phase("expr_eval"):
                flat_mask, vals = self._evaluate(r_conds, [s for s in specs if s is not None], l, dev)
            with self.phase("agg_args"):
                keys = [
                    SegKey(l[idx][0].reshape(-1), self._valid_arg(l[idx][1], dev), lo, dom)
                    for (idx, lo), dom in zip(key_cols, domains)
                ]
                seg_lanes = [SegLane("count")]  # group_count: masked-in rows per slot
                seg_lanes += self._agg_lanes(agg.aggs, specs, vals, dev, nseg)
            with self.phase("seg_agg"):
                i_mat, f_mat = self.seg_agg(flat_mask, keys, seg_lanes, nseg)
                layout = self._layout(seg_lanes)
            with self.phase("d2h"):
                i_host, f_host = i_mat.cpu().numpy(), f_mat.cpu().numpy()
            with self.phase("finalize"):
                res = [i_host[k] if t == "i" else f_host[k] for t, k in layout]
                chunk = self._agg_outputs_to_chunk(dag, dev, res, domains, key_cols, vocabs, nseg)
            return chunk

        return run

    # --- sort-based aggregation (high-cardinality GROUP BY) -----------------

    def _lower_agg_sorted(self, dag: DAGRequest, dev: DeviceBatch, lanes, vocabs, r_conds, unsigned,
                          dev_args):
        """GROUP BY over NULL-able, float, uint64 or wide key domains (ref:
        tpu_engine.py:1324 _lower_agg_sorted): K9 sorts the masked rows by
        (NULL flag, key bits) per key (through K8) and gives each row a
        dense group id; K4 reduces the value lanes over those ids.

        The group capacity starts at gcap0 and, when n_groups overflows
        it, escalates x4 until it fits and is remembered for this DAG
        shape — the reference's escalation, with the same capacities. The
        reference learns n_groups after a full launch and reruns at the
        new capacity; here K9 counts the groups before K4 runs, so the
        first launch already uses the capacity the rerun would."""
        agg = dag.agg
        key_idx = [g.idx for g in agg.group_by]
        if not key_idx:
            return None
        shape_key = ("aggsort", repr(r_conds),
                     repr([(a.name, repr(x)) for a, x in zip(agg.aggs, dev_args)]),
                     repr(key_idx), dev.t, dev.r)

        def cap_of(ng: int) -> int:
            with self._lock:
                cap = self._gcap.get(shape_key, self.gcap0)
                if ng > cap:
                    while cap < ng:
                        cap <<= 2
                    self._gcap[shape_key] = cap
            return cap

        specs = [self._agg_spec(a, r_args) for a, r_args in zip(agg.aggs, dev_args)]

        def run():
            with self.phase("decode"):
                l = self._decode(dev, lanes, unsigned)
            with self.phase("expr_eval"):
                flat_mask, vals = self._evaluate(r_conds, [s for s in specs if s is not None], l, dev)
            with self.phase("sort"):
                keys = [(self._flat(l[ki][0], dev.padded), self._valid_arg(l[ki][1], dev))
                        for ki in key_idx]
                g = self.sort_groups(flat_mask, keys, cap_of)
            with self.phase("agg_args"):
                seg_lanes = self._agg_lanes(agg.aggs, specs, vals, dev, g.cap)
            with self.phase("seg_agg"):
                layout = []
                if seg_lanes:
                    i_mat, f_mat = self.seg_agg(flat_mask, [], seg_lanes, g.cap, seg=g.seg)
                    layout = self._layout(seg_lanes)
            with self.phase("d2h"):
                ng = g.n_groups  # only [:n_groups] reaches the chunk
                kval, kvalid = g.kval[:, :ng].cpu().numpy(), g.kvalid[:, :ng].cpu().numpy()
                if layout:
                    i_host, f_host = i_mat[:, :ng].cpu().numpy(), f_mat[:, :ng].cpu().numpy()
            with self.phase("finalize"):
                res = [row for j in range(len(key_idx)) for row in (kval[j], kvalid[j])]
                res += [i_host[k] if t == "i" else f_host[k] for t, k in layout]
                return self._agg_sorted_to_chunk(dag, dev, res, key_idx, vocabs, ng)

        return run

    def _agg_sorted_to_chunk(self, dag, dev, outs, key_idx, vocabs, ng):
        """Sorted partials → chunk (copy of TPUEngine._agg_sorted_to_chunk)."""
        out_fts = dag.output_types()
        present = np.arange(ng)
        cols: list[Column] = []
        pos = 0
        oi = 0
        for ki in key_idx:
            kval = np.asarray(outs[pos])[:ng]
            valid = np.asarray(outs[pos + 1])[:ng] == 1
            ft = out_fts[oi]
            if ki in vocabs:
                vocab = vocabs[ki]
                data = np.empty(ng, dtype=object)
                for j in range(ng):
                    c = int(kval[j])
                    data[j] = vocab[c] if valid[j] and 0 <= c < len(vocab) else None
            else:
                # undo the kernel's bit-pattern canonicalization
                src_dt = dev.batch.data[dag.scan.col_offsets[ki]].dtype
                data = kval.astype(np.int64)
                if src_dt == np.float64:
                    data = data.view(np.float64).copy()
                    data[~valid] = 0.0
                elif src_dt == np.uint64:
                    data = data.view(np.uint64).copy()
                    data[~valid] = 0
                else:
                    data[~valid] = 0
            cols.append(Column(ft, data, valid))
            pos += 2
            oi += 1
        cols.extend(self._agg_value_cols(dag, dev, outs, pos, oi, present, vocabs))
        return Chunk(cols)

    @staticmethod
    def _device_lanes(lanes: dict, exprs) -> dict:
        """The lanes the device reads for `exprs`. A TopN uploads every
        scan column (its rows come back from the batch) but computes on the
        filter and key columns only; the reference's fused program drops
        the other decodes as dead code, and so does the port."""
        used: set[int] = set()
        for e in exprs:
            e.collect_columns(used)
        return {i: lanes[i] for i in sorted(used)}

    @staticmethod
    def _flat(x, n: int):
        """A device value as a flat contiguous [n] lane (a 0-d constant is
        broadcast); U64 stays U64."""
        if isinstance(x, U64):
            return U64(TorchEngine._flat(x.bits, n))
        return x.reshape(-1) if x.ndim else x.expand(n).contiguous()

    @staticmethod
    def _valid_arg(v, dev: DeviceBatch):
        """A valid lane for the kernel: None when it is row_valid itself
        (every masked-in row is valid), else the flat bool lane."""
        if v is dev.row_valid:
            return None
        return TorchEngine._flat(v, dev.padded)

    @staticmethod
    def _layout(seg_lanes):
        """Each SegLane's row in K4's packed matrices (K5: the int lanes
        in order, then the float lanes), in output order."""
        layout, ki, kf = [], 0, 0
        for lane in seg_lanes:
            if lane.is_float:
                layout.append(("f", kf))
                kf += 1
            else:
                layout.append(("i", ki))
                ki += 1
        return layout

    @staticmethod
    def _agg_spec(a, r_args):
        """The expression program's output an aggregate reads (ref: the
        argument evaluation of :1527 _agg_partials_device); None for an
        argument-free COUNT(*)."""
        if not r_args:
            return None
        x = r_args[0]
        if a.name in ("count", "first_row"):
            return ValueSpec(x, "valid")
        ft = a.args[0].ret_type
        if a.name in _VAR:
            return ValueSpec(x, "var_dec" if ft.is_decimal() else "var_f")
        if a.name in _BIT:
            return ValueSpec(x, "bit", max(ft.decimal, 0) if ft.is_decimal() else -1)
        return ValueSpec(x)

    def _agg_lanes(self, aggs, specs, vals, dev: DeviceBatch, nseg: int) -> list:
        """SegLanes of every aggregate's partials, in the reference's
        output order (ref: :1527 _agg_partials_device), from the program's
        outputs."""
        it = iter(vals)
        lanes = []
        for a, spec in zip(aggs, specs):
            lanes += self._agg_partials_device(a, None if spec is None else next(it), dev, nseg)
        return lanes

    def _agg_partials_device(self, a, out, dev: DeviceBatch, nseg: int) -> list:
        name = a.name
        n = dev.padded
        datas, vv, kind = ([], None, "i64") if out is None else (out[0], self._valid_arg(out[1], dev), out[2])

        def cnt():
            return SegLane("count", valid=vv)

        if name == "count":
            return [cnt()]
        if name in ("sum", "avg"):
            d = datas[0]
            s = SegLane("sum_f64", d, vv) if kind == "f64" else SegLane("sum_i64", d.to(torch.int64), vv)
            return [s, cnt()]
        if name in ("min", "max"):
            if kind == "f64":
                op, big, small = "f64", float("inf"), float("-inf")
            else:
                # sentinels in the lane's OWN dtype (uint64 / int32 codes)
                info = np.iinfo({"u64": np.uint64, "i32": np.int32}.get(kind, np.int64))
                op, big, small = ("u64" if kind == "u64" else "i64"), int(info.max), int(info.min)
            x = datas[0] if kind == "f64" else datas[0].to(torch.int64)
            return [SegLane(f"{name}_{op}", x, vv, big if name == "min" else small), cnt()]
        if name == "first_row":
            return [SegLane("first_row", valid=vv, fill=n if nseg <= SEG_DENSE_MAX else int(_I64.max))]
        if name in _VAR:
            # (cnt, sum, sumsq) partials; decimals ship (int64 wrap-sum,
            # float estimate) pairs of the SCALED ints and their 32-bit
            # limbs, rebuilt exactly on the host (host_engine.exact_sum64)
            ops = ["sum_i64", "sum_f64"] * 4 if len(datas) == 8 else ["sum_f64", "sum_f64"]
            return [cnt()] + [SegLane(op, d, vv) for op, d in zip(ops, datas)]
        if name in _BIT:
            op, fill = _BIT[name]
            return [SegLane(op, datas[0], vv, fill)]
        raise NotImplementedError(name)

    def _agg_outputs_to_chunk(self, dag, dev, outs, domains, key_cols, vocabs, nseg):
        out_fts = dag.output_types()
        group_count = np.asarray(outs[0])
        present = np.nonzero(group_count > 0)[0]
        G = len(present)
        cols: list[Column] = []
        radix = [d + 1 for d in domains]
        codes = present.copy()
        key_vals = []
        for r in reversed(radix):
            key_vals.append(codes % r)
            codes = codes // r
        key_vals.reverse()
        oi = 0
        for (idx, lo), kv in zip(key_cols, key_vals):
            ft = out_fts[oi]
            valid = kv > 0
            if idx in vocabs:
                vocab = vocabs[idx]
                data = np.empty(G, dtype=object)
                for j, code in enumerate(kv):
                    data[j] = vocab[code - 1] if code > 0 else None
            else:
                data = (kv.astype(np.int64) - 1) + lo
                data[~valid] = 0
            cols.append(Column(ft, data, valid))
            oi += 1
        cols.extend(self._agg_value_cols(dag, dev, outs, 1, oi, present, vocabs))
        return Chunk(cols)

    def _agg_value_cols(self, dag, dev, outs, pos, oi, present, vocabs):
        """Partial-state → Column decode (copy of TPUEngine._agg_value_cols)."""
        agg = dag.agg
        out_fts = dag.output_types()
        G = len(present)
        cols: list[Column] = []
        for a in agg.aggs:
            if a.name == "count":
                cnt = np.asarray(outs[pos])[present]
                cols.append(Column(out_fts[oi], cnt.astype(np.int64), np.ones(G, dtype=bool)))
                pos += 1
                oi += 1
            elif a.name in ("sum", "avg"):
                s = np.asarray(outs[pos])[present]
                cnt = np.asarray(outs[pos + 1])[present]
                has = cnt > 0
                sd = s if out_fts[oi].is_float() else s.astype(np.int64)
                cols.append(Column(out_fts[oi], sd, has))
                oi += 1
                if a.name == "avg":
                    cols.append(Column(out_fts[oi], cnt.astype(np.int64), np.ones(G, dtype=bool)))
                    oi += 1
                pos += 2
            elif a.name in ("min", "max"):
                s = np.asarray(outs[pos])[present]
                cnt = np.asarray(outs[pos + 1])[present]
                has = cnt > 0
                ft = out_fts[oi]
                arg = a.args[0]
                if isinstance(arg, ExprCol) and arg.idx in vocabs:
                    vocab = vocabs[arg.idx]
                    data = np.empty(G, dtype=object)
                    for j in range(G):
                        data[j] = vocab[int(s[j])] if has[j] and 0 <= int(s[j]) < len(vocab) else None
                elif ft.is_float():
                    data = s
                elif ft.is_int() and ft.is_unsigned:
                    data = s.astype(np.int64).view(np.uint64).copy()
                    data[~has] = 0
                else:
                    data = np.where(has, s.astype(np.int64), 0)
                cols.append(Column(ft, data, has))
                pos += 2
                oi += 1
            elif a.name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
                ones = np.ones(G, dtype=bool)
                cnt = np.asarray(outs[pos])[present].astype(np.int64)
                arg_ft = a.args[0].ret_type
                if arg_ft.is_decimal():
                    o = [np.asarray(outs[pos + j])[present] for j in range(1, 9)]
                    scale = float(pow10(max(arg_ft.decimal, 0)))
                    s = exact_sum64(o[0], o[1]) / scale
                    sq = exact_sumsq64(o[2], o[3], o[4], o[5], o[6], o[7]) / (scale * scale)
                    pos += 9
                else:
                    s = np.asarray(outs[pos + 1])[present]
                    sq = np.asarray(outs[pos + 2])[present]
                    pos += 3
                cols.append(Column(out_fts[oi], cnt, ones))
                cols.append(Column(out_fts[oi + 1], s, ones))
                cols.append(Column(out_fts[oi + 2], sq, ones))
                oi += 3
            elif a.name in ("bit_and", "bit_or", "bit_xor"):
                val = np.asarray(outs[pos])[present].astype(np.int64)
                cols.append(Column(out_fts[oi], val, np.ones(G, dtype=bool)))
                pos += 1
                oi += 1
            elif a.name == "first_row":
                firsts = np.asarray(outs[pos])[present]
                ft = out_fts[oi]
                n = dev.batch.n_rows
                src_off = dag.scan.col_offsets[a.args[0].idx] if isinstance(a.args[0], ExprCol) else None
                from ..chunk.chunk import col_numpy_dtype, VARLEN

                dt = col_numpy_dtype(ft)
                data = np.empty(G, dtype=object) if dt is VARLEN else np.zeros(G, dtype=dt)
                valid = np.zeros(G, dtype=bool)
                for j, fi in enumerate(firsts):
                    fi = int(fi)
                    if fi < n and src_off is not None:
                        data[j] = dev.batch.data[src_off][fi]
                        valid[j] = dev.batch.valid[src_off][fi]
                cols.append(Column(ft, data, valid))
                pos += 1
                oi += 1
        return cols

    # --- topn ----------------------------------------------------------------

    def _lower_topn(self, dag: DAGRequest, dev: DeviceBatch, lanes, vocabs, r_conds, unsigned):
        """Single-key TopN (ref: tpu_engine.py:1747 _lower_topn): K6 picks
        the k best rows in lax.top_k's order; the host keeps those the
        mask lets through, up to n."""
        by = dag.topn.by
        if len(by) != 1:
            return self._lower_topn_multi(dag, dev, lanes, vocabs, r_conds, unsigned)
        e, desc = by[0]
        r_e = self._rewrite(e, vocabs)
        if r_e is None:
            return None
        n = dag.topn.n
        dlanes = self._device_lanes(lanes, r_conds + [r_e])

        def run():
            with self.phase("decode"):
                l = self._decode(dev, dlanes, unsigned)
            with self.phase("expr_eval"):
                mask, ((datas, v, kind),) = self._evaluate(r_conds, [ValueSpec(r_e)], l, dev)
            with self.phase("sort"):
                # integer keys stay integer (exact for packed datetimes and
                # decimals); a uint64 key keeps its bits, as astype(int64)
                d = datas[0] if kind == "f64" else datas[0].to(torch.int64)
                idx, ok = self.topk(d.contiguous(), self._valid_arg(v, dev), mask, desc, min(n, dev.padded))
            with self.phase("d2h"):
                idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
            with self.phase("finalize"):
                idx = idx[ok]  # drop indices pointing at masked rows
                return dev.batch.to_chunk(dag.scan.col_offsets).take(idx[:n])

        return run

    def _lower_topn_multi(self, dag: DAGRequest, dev: DeviceBatch, lanes, vocabs, r_conds, unsigned):
        """Multi-key TopN (ref: tpu_engine.py:1796 _lower_topn_multi): K7
        writes the sort operands, K8 sorts every row by them, the first n
        row ids come back with their mask bits."""
        r_by = []
        for e, desc in dag.topn.by:
            r_e = self._rewrite(e, vocabs)
            if r_e is None:
                return None
            r_by.append((r_e, desc))
        n = dag.topn.n
        dlanes = self._device_lanes(lanes, r_conds + [r_e for r_e, _ in r_by])

        def run():
            with self.phase("decode"):
                l = self._decode(dev, dlanes, unsigned)
            with self.phase("expr_eval"):
                mask, vals = self._evaluate(r_conds, [ValueSpec(r_e) for r_e, _ in r_by], l, dev)
            with self.phase("sort"):
                keys = [(U64(datas[0]) if kind == "u64" else datas[0], self._valid_arg(v, dev), desc)
                        for (datas, v, kind), (_, desc) in zip(vals, r_by)]
                ops = self.topn_multi_ops(mask, keys)
                perm = self.lex_sort_perm(ops)
                idx = perm[: min(n, dev.padded)].long()
                ok = ops[0].data[idx] == 0
            with self.phase("d2h"):
                idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
            with self.phase("finalize"):
                return dev.batch.to_chunk(dag.scan.col_offsets).take(idx[ok][:n])

        return run
