"""Host (numpy-vectorized) coprocessor engine (copy of
tidb_tpu/copr/host_engine.py; ref behavior: unistore
cophandler/closure_exec.go's fused scan→sel→agg/topN/limit single pass).

Two roles in the port: the path for exactly the DAGs the reference's
device engine declines (TorchEngine counts them in `fallbacks`), and the
oracle chip_smoke.py holds the GPU path against. approx_count_distinct
builds its per-group FM sketches through the port's statistics package.
"""

from __future__ import annotations

import numpy as np

from ..chunk.chunk import Chunk, Column, col_numpy_dtype, VARLEN
from ..expr.aggregation import AggDesc
from ..expr.expression import NP, Expression
from ..mysqltypes.mydecimal import pow10
from .dag import DAGRequest
from .tilecache import ColumnBatch


_2_64 = 18446744073709551616
_2_32 = 4294967296


def _exact_sum64_ints(wrap: np.ndarray, est: np.ndarray) -> list:
    """Exact Python-int sums of int64 terms, from the order-independent
    int64 wrap-sum (exact mod 2^64) plus any float64 estimate with
    |error| < 2^63. Estimate error is ~n·(running sum)·2^-53, so the
    precondition holds for any per-task segment under ~10^7 rows."""
    out = []
    for i in range(len(wrap)):
        w = int(wrap[i])
        k = round((float(est[i]) - float(w)) / _2_64)
        out.append(w + k * _2_64)
    return out


def exact_sum64(wrap: np.ndarray, est: np.ndarray) -> np.ndarray:
    """float64 of _exact_sum64_ints, with a vectorized fast path for the
    common case (no wrap, |sum| < 2^53). Makes decimal variance partials
    identical across cop engines regardless of summation order."""
    wf = wrap.astype(np.float64)
    if len(wrap) and not np.rint((est - wf) / _2_64).any() and np.all(np.abs(wf) < 2**53):
        return wf
    return np.array([float(v) for v in _exact_sum64_ints(wrap, est)], dtype=np.float64)


def exact_sumsq64(wA, eA, wB, eB, wC, eC) -> np.ndarray:
    """Exact Σx² from 32-bit limb sums: with x = a·2^32 + b (arithmetic
    shift; b in [0,2^32)), Σx² = ΣA·2^64 + 2·ΣB·2^32 + ΣC for A=a², B=a·b,
    C=b². Each limb product fits the wrap+estimate reconstruction envelope
    (per-term float error ≤ 2^10), so the result is exact — and therefore
    engine-order-independent — far beyond where float64(x²) loses 2^63."""
    A = _exact_sum64_ints(wA, eA)
    B = _exact_sum64_ints(wB, eB)
    C = _exact_sum64_ints(wC, eC)
    return np.array(
        [float(a * _2_64 + 2 * b * _2_32 + c) for a, b, c in zip(A, B, C)],
        dtype=np.float64,
    )


def _eval_mask(conds: list[Expression], chunk: Chunk) -> np.ndarray:
    mask = np.ones(chunk.num_rows, dtype=bool)
    for c in conds:
        d, v = c.eval(chunk)
        mask &= v & (d != 0)
    return mask


def _lane_codes(d: np.ndarray, v: np.ndarray) -> np.ndarray:
    """One key lane → small-range non-negative int64 codes (NULL = extra
    code 0; valid codes start at 1)."""
    if d.dtype == object:
        filled = np.where(v, d, "")
        try:
            s = filled.astype("S")  # ascii fast path
        except UnicodeEncodeError:
            s = filled.astype("U")  # non-ascii: factorize unicode directly
        w = s.dtype.itemsize
        if s.dtype.kind == "S" and 0 < w <= 8:
            # ≤8-byte strings: big-endian byte code preserves ordering and
            # identity — factorize with ONE 1-D sort instead of string sorts
            mat = np.zeros((len(s), 8), dtype=np.uint8)
            mat[:, :w] = s.view(np.uint8).reshape(len(s), w)
            raw = mat.view(">u8").reshape(len(s))
        else:
            raw = s
        _, inv = np.unique(raw, return_inverse=True)
        codes = inv.astype(np.int64) + 1
    elif d.dtype == np.float64:
        _, inv = np.unique(np.where(v, d, 0.0), return_inverse=True)
        codes = inv.astype(np.int64) + 1
    else:
        x = np.where(v, d.astype(np.int64), 0)
        lo = int(x.min()) if len(x) else 0
        hi = int(x.max()) if len(x) else 0
        if hi - lo >= (1 << 62):  # huge span: factorize instead of shifting
            _, inv = np.unique(x, return_inverse=True)
            codes = inv.astype(np.int64) + 1
        else:
            codes = (x - lo) + 1
    return np.where(v, codes, 0)


def _group_codes_masked(keys: list[tuple[np.ndarray, np.ndarray]], mask: np.ndarray):
    """Selected rows → dense group ids.

    → (inv: group id per selected row, first_row: absolute row index of
    each group's first occurrence, G). Lanes factorize to small ranges,
    pack into one int64 (single final sort); falls back to a stacked
    column unique if the range product overflows.
    """
    sel_idx = np.nonzero(mask)[0]
    if len(sel_idx) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), 0
    lanes = [_lane_codes(d[sel_idx], v[sel_idx]) for d, v in keys]
    packed = None
    total = 1
    for lane in lanes:
        rng = int(lane.max()) + 1
        if total > (1 << 62) // max(rng, 1):
            packed = None
            break
        packed = lane if packed is None else packed * rng + lane
        total *= rng
    if packed is None:  # overflow — stacked lexicographic unique
        stacked = np.stack(lanes, axis=0)
        _, first_sel, inv = np.unique(stacked, axis=1, return_index=True, return_inverse=True)
    else:
        _, first_sel, inv = np.unique(packed, return_index=True, return_inverse=True)
    return inv.astype(np.int64), sel_idx[first_sel], len(first_sel)


def execute_dag_host(dag: DAGRequest, batch: ColumnBatch) -> Chunk:
    chunk = batch.to_chunk(dag.scan.col_offsets)
    mask = None
    if dag.selection is not None:
        mask = _eval_mask(dag.selection.conds, chunk)
        if dag.agg is None:
            chunk = chunk.filter(mask)
            mask = None

    if dag.agg is not None:
        return _exec_agg(dag, chunk, mask)

    if dag.topn is not None:
        from ..expr.expression import collation_key_lane

        keys = []
        for e, desc in dag.topn.by:
            d, v = e.eval(chunk)
            keys.append((collation_key_lane(d, e.ret_type), v, desc))
        order = _lex_argsort(keys, chunk.num_rows)
        order = order[: dag.topn.n]
        chunk = chunk.take(order)
    if dag.limit is not None:
        chunk = chunk.slice(0, min(dag.limit.n, chunk.num_rows))
    return chunk


def _lex_argsort(keys, n: int) -> np.ndarray:
    """Stable lexicographic argsort; NULLs first asc / last desc (MySQL).

    DESC keys sort by NEGATED rank under a stable sort — reversing an
    ascending stable sort would also reverse the tie order established by
    later (less significant) keys."""
    order = np.arange(n)
    for d, v, desc in reversed(keys):
        if d.dtype == object:
            strs = np.where(v, d, "").astype("U")
            x = np.unique(strs, return_inverse=True)[1].astype(np.int64)
        else:
            x = d
        # DESC int lanes flip via ~x (monotone decreasing, exact for the
        # full int64 range — a float64 negate would lose >2^53 keys)
        if desc:
            x = -x if x.dtype == np.float64 else ~x
        idx = np.argsort(x[order], kind="stable")
        order = order[idx]
        # NULLs first asc / last desc (boolean selection is stable)
        nulls = ~v[order]
        if desc:
            order = np.concatenate([order[~nulls], order[nulls]])
        else:
            order = np.concatenate([order[nulls], order[~nulls]])
    return order


def _exec_agg(dag: DAGRequest, chunk: Chunk, mask: np.ndarray | None) -> Chunk:
    n = chunk.num_rows
    if mask is None:
        mask = np.ones(n, dtype=bool)
    out_fts = dag.output_types()
    gb = dag.agg.group_by
    if gb:
        from ..expr.expression import collation_key_lane

        keyvals = []
        for e in gb:
            d, v = e.eval(chunk)
            keyvals.append((collation_key_lane(d, e.ret_type), v))
        inv, first_row, G = _group_codes_masked(keyvals, mask)
    else:
        G = 1
        inv = np.zeros(int(mask.sum()), dtype=np.int64)
        first_row = np.zeros(1, dtype=np.int64)

    cols: list[Column] = []
    oi = 0
    for e in gb:
        d, v = e.eval(chunk)
        cols.append(Column(out_fts[oi], d[first_row], v[first_row]))
        oi += 1
    for a in dag.agg.aggs:
        for col in _agg_partial_columns(a, chunk, mask, inv, G, out_fts, oi):
            cols.append(col)
            oi += 1
    return Chunk(cols)


def _agg_partial_columns(a: AggDesc, chunk: Chunk, mask: np.ndarray, inv: np.ndarray, G: int, out_fts, oi: int):
    """Partial-state columns for one aggregate over grouped rows."""
    name = a.name
    sel = np.nonzero(mask)[0]
    if a.args:
        d, v = a.args[0].eval(chunk)
        dv, vv = d[sel], v[sel]
    else:
        dv = np.ones(len(sel), dtype=np.int64)
        vv = np.ones(len(sel), dtype=bool)

    def seg_sum(vals):
        return np.bincount(inv, weights=vals, minlength=G)

    if name == "count":
        cnt = seg_sum(vv.astype(np.float64)).astype(np.int64)
        yield Column(out_fts[oi], cnt, np.ones(G, dtype=bool))
        return
    if name in ("sum", "avg"):
        ft = out_fts[oi]
        if ft.is_float():
            vals = np.where(vv, dv.astype(np.float64), 0.0)
            s = seg_sum(vals)
        else:
            # exact: integer bincount may lose precision in float64 weights
            # beyond 2^53 — use object-accumulate only when needed
            vals = np.where(vv, dv.astype(np.int64), 0)
            s = np.zeros(G, dtype=np.int64)
            np.add.at(s, inv, vals)
        cnt = seg_sum(vv.astype(np.float64)).astype(np.int64)
        has = cnt > 0
        yield Column(ft, s if not ft.is_float() else s, has)
        if name == "avg":
            yield Column(out_fts[oi + 1], cnt, np.ones(G, dtype=bool))
        return
    if name in ("min", "max"):
        ft = out_fts[oi]
        out_valid = np.zeros(G, dtype=bool)
        if dv.dtype == object:
            from ..expr.expression import collation_key_lane

            kv = collation_key_lane(dv, a.args[0].ret_type if a.args else None)
            out = np.empty(G, dtype=object)
            outk = np.empty(G, dtype=object)
            for i, g in enumerate(inv):
                if not vv[i]:
                    continue
                # ci collation orders by WEIGHT; equal-weight ties keep
                # the FIRST-encountered value, the same representative the
                # device dict-code path decodes to
                w = kv[i]
                if not out_valid[g]:
                    better = True
                elif w == outk[g]:
                    better = False
                else:
                    better = (w < outk[g]) if name == "min" else (w > outk[g])
                if better:
                    out[g] = dv[i]
                    outk[g] = w
                    out_valid[g] = True
        else:
            if dv.dtype == np.float64:
                init = np.inf if name == "min" else -np.inf
            else:  # the lane's own int dtype (uint64 must not wrap)
                init = np.iinfo(dv.dtype).max if name == "min" else np.iinfo(dv.dtype).min
            out = np.full(G, init, dtype=dv.dtype)
            fn = np.minimum if name == "min" else np.maximum
            fn.at(out, inv, np.where(vv, dv, init))
            np.bitwise_or.at(out_valid, inv, vv)
        yield Column(ft, out, out_valid)
        return
    if name == "group_concat":
        from ..chunk.chunk import Column as _C

        argc = _C(a.args[0].ret_type, dv, vv)
        parts: list[list[str]] = [[] for _ in range(G)]
        for i, g in enumerate(inv):
            if vv[i]:
                parts[g].append(argc.get_datum(i).render(a.args[0].ret_type))
        out = np.empty(G, dtype=object)
        out_valid = np.zeros(G, dtype=bool)
        for g in range(G):
            if parts[g]:
                out[g] = a.sep.join(parts[g])[: a.max_len]
                out_valid[g] = True
        yield Column(out_fts[oi], out, out_valid)
        return
    if name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
        from ..expr.expression import lane_as_float

        cnt = seg_sum(vv.astype(np.float64)).astype(np.int64)
        arg_ft = a.args[0].ret_type
        if arg_ft.is_decimal():
            # exact sums of the SCALED ints, reconstructed from order-
            # independent int64 wrap-sums + float estimates (sumsq via
            # 32-bit limbs) — both cop engines land on the identical exact
            # integer whatever their summation order
            # (gpu_engine._agg_partials_device is the device twin)
            xi = np.where(vv, dv.astype(np.int64), 0)
            ai = xi >> 32
            bi = xi - (ai << 32)
            af, bf = ai.astype(np.float64), bi.astype(np.float64)

            def wrap_at(vals):
                w = np.zeros(G, dtype=np.int64)
                np.add.at(w, inv, vals)
                return w

            scale = float(pow10(max(arg_ft.decimal, 0)))
            s = exact_sum64(wrap_at(xi), seg_sum(xi.astype(np.float64))) / scale
            sq = exact_sumsq64(
                wrap_at(ai * ai), seg_sum(af * af),
                wrap_at(ai * bi), seg_sum(af * bf),
                wrap_at(bi * bi), seg_sum(bf * bf),
            ) / (scale * scale)
        else:
            x = np.where(vv, lane_as_float(NP, dv, arg_ft), 0.0)
            s = seg_sum(x)
            sq = seg_sum(x * x)
        ones = np.ones(G, dtype=bool)
        yield Column(out_fts[oi], cnt, ones)
        yield Column(out_fts[oi + 1], s, ones)
        yield Column(out_fts[oi + 2], sq, ones)
        return
    if name == "approx_count_distinct":
        # per-group FM sketch, shipped serialized; the root final unions
        # them (ref: aggfuncs approxCountDistinctPartial1, fmsketch.go)
        from ..statistics.cmsketch import hash_values
        from ..statistics.fmsketch import FMSketch

        hashes = hash_values(dv)
        out = np.empty(G, dtype=object)
        for g in range(G):
            sel_g = (inv == g) & vv
            sk = FMSketch()
            sk.insert_hashes(np.asarray(hashes[sel_g], dtype=np.uint64))
            out[g] = sk.serialize()
        yield Column(out_fts[oi], out, np.ones(G, dtype=bool))
        return
    if name in ("bit_and", "bit_or", "bit_xor"):
        if dv.dtype == object:
            from ..errors import TiDBError

            raise TiDBError(f"{name.upper()} over string operands is not supported")
        from ..expr.expression import lane_as_float

        # MySQL rounds non-integers to the nearest integer before bit ops
        ints = np.rint(lane_as_float(NP, dv, a.args[0].ret_type)).astype(np.int64)
        init = -1 if name == "bit_and" else 0  # all-ones / zero identities
        out = np.full(G, init, dtype=np.int64)
        fn = {"bit_and": np.bitwise_and, "bit_or": np.bitwise_or, "bit_xor": np.bitwise_xor}[name]
        fn.at(out, inv, np.where(vv, ints, init if name == "bit_and" else 0))
        # MySQL: bit aggregates over no rows return the identity, not NULL
        yield Column(out_fts[oi], out, np.ones(G, dtype=bool))
        return
    if name == "first_row":
        ft = out_fts[oi]
        out_valid = np.zeros(G, dtype=bool)
        dt = col_numpy_dtype(ft)
        out = np.empty(G, dtype=object) if dt is VARLEN else np.zeros(G, dtype=dt)
        seen = np.zeros(G, dtype=bool)
        for i, g in enumerate(inv):
            if not seen[g]:
                seen[g] = True
                out[g] = dv[i]
                out_valid[g] = vv[i]
        yield Column(ft, out, out_valid)
        return
    raise NotImplementedError(f"aggregate {name} in cop")
