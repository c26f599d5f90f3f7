"""The root's final step over cop partial chunks.

* `merge_partials` + `order_by_keys`: the root half of a pushed-down
  aggregation (ref: tidb_tpu/executor/executors.py:1901 FinalHashAggExec,
  its vectorized merge `_merge_vectorized` :1989 and `_final_value`), then
  ORDER BY the group keys. Ported for the aggregates the port pushes:
  count, sum, avg, min, max, first_row.
* `top_n`: the root half of a pushed-down TopN (ref: executors.py:1603
  TopNExec, its `_sort_in_mem`): order the partial rows by the TopN keys,
  keep n.

Exactness: integer and decimal sums are exact. While the float64 sum of
the magnitudes stays below 2^62 no int64 partial sum can overflow, and
numpy adds in int64; past that guard they accumulate as Python ints, so
partial sums near the int64 limit (TPC-H Q1's charge sum reaches ~1.8e18
at 16M rows) merge exactly, and a total that does not fit the int64 lane
raises instead of wrapping. Decimal AVG is Dec.div + rescale, the
reference's own rounding (_avg_dec_finish replicates the same in int64).
"""

from __future__ import annotations

import numpy as np

from ..chunk.chunk import Chunk, Column, col_numpy_dtype, VARLEN
from ..copr.host_engine import _group_codes_masked, _lex_argsort
from ..errors import NotPortedError
from ..expr.aggregation import AggDesc
from ..expr.expression import Expression, collation_key_lane
from ..mysqltypes.field_type import FieldType
from ..mysqltypes.mydecimal import Dec

MERGEABLE = ("count", "sum", "avg", "min", "max", "first_row", "bit_and", "bit_or", "bit_xor")
_I64 = np.iinfo(np.int64)


# the float64 magnitude sum that still guarantees int64 partial sums:
# its rounding error (a relative n * 2^-53) stays far inside the 2x margin
# to 2^63
_SHADOW_MAX = float(1 << 62)


def _to_i64(vals, what: str) -> np.ndarray:
    if isinstance(vals, np.ndarray):  # _exact_sum's int64 path: fits by its guard
        return vals
    for v in vals:
        if not _I64.min <= v <= _I64.max:
            raise OverflowError(f"{what}: exact result {v} does not fit the int64 lane")
    return np.array(vals, dtype=np.int64)


def _exact_sum_loop(inv, G, data, valid) -> list[int]:
    acc = [0] * G
    for g, x, ok in zip(inv.tolist(), data.tolist(), valid.tolist()):
        if ok:
            acc[g] += int(x)
    return acc


def _exact_sum(inv, G, data, valid):
    """Exact per-group sums of an integer lane: an int64 array when the
    float64 shadow sum of |x| per group stays below 2^62 (then no int64
    partial sum can overflow), else Python ints from the loop."""
    x = np.where(valid, data, np.zeros((), data.dtype))
    shadow = np.zeros(G, dtype=np.float64)
    np.add.at(shadow, inv, np.abs(x.astype(np.float64)))
    if G and not shadow.max() < _SHADOW_MAX:
        return _exact_sum_loop(inv, G, data, valid)
    acc = np.zeros(G, dtype=np.int64)
    np.add.at(acc, inv, x.astype(np.int64))
    return acc


def _minmax(name, inv, G, col: Column, arg_ft: FieldType | None):
    sd, sv = col.data, col.valid
    has = np.zeros(G, dtype=bool)
    np.logical_or.at(has, inv, sv)
    if sd.dtype == object:
        # collation order, equal-weight ties keep the first value
        keys = collation_key_lane(sd, arg_ft)
        out = np.empty(G, dtype=object)
        best = [None] * G
        for i, g in enumerate(inv.tolist()):
            if not sv[i]:
                continue
            k = keys[i]
            if best[g] is None or (k < best[g] if name == "min" else k > best[g]):
                best[g], out[g] = k, sd[i]
        return out, has
    if sd.dtype.kind == "f":
        neutral = np.inf if name == "min" else -np.inf
    else:
        info = np.iinfo(sd.dtype)
        neutral = info.max if name == "min" else info.min
    acc = np.full(G, neutral, dtype=sd.dtype)
    (np.minimum if name == "min" else np.maximum).at(acc, inv, np.where(sv, sd, neutral))
    return np.where(has, acc, np.zeros((), sd.dtype)), has


def merge_partials(partials: list[Chunk], group_by: list[Expression], aggs: list[AggDesc],
                   out_fts: list[FieldType]) -> Chunk:
    """Partial chunks (group keys, then each agg's partial columns) → one
    final row per group: the group keys, then each aggregate's value."""
    for a in aggs:
        if a.name not in MERGEABLE:
            raise NotPortedError("executors.FinalHashAggExec._merge_state", a.name)
    ngroup = len(group_by)
    all_ = Chunk.concat_all(partials)
    n = all_.num_rows
    if n == 0:
        if ngroup:
            return Chunk.empty(out_fts, 0)
        # global aggregate over empty input: COUNT 0, everything else NULL
        out = Chunk.empty(out_fts, 1)
        for i, a in enumerate(aggs):
            if a.name == "count":
                out.columns[i].valid[0] = True
        return out
    if ngroup:
        keyvals = [(collation_key_lane(all_.columns[i].data, g.ret_type), all_.columns[i].valid)
                   for i, g in enumerate(group_by)]
        inv, first_row, G = _group_codes_masked(keyvals, np.ones(n, dtype=bool))
    else:
        inv = np.zeros(n, dtype=np.int64)
        first_row = np.zeros(1, dtype=np.int64)
        G = 1
    cols = [Column(out_fts[i], all_.columns[i].data[first_row], all_.columns[i].valid[first_row])
            for i in range(ngroup)]
    pos, oi = ngroup, ngroup
    for a in aggs:
        ft = out_fts[oi]
        col = all_.columns[pos]
        if a.name == "count":
            cols.append(Column(ft, _to_i64(_exact_sum(inv, G, col.data, col.valid), "COUNT"),
                               np.ones(G, dtype=bool)))
            pos += 1
        elif a.name in ("sum", "avg"):
            has = np.zeros(G, dtype=bool)
            np.logical_or.at(has, inv, col.valid)
            if col.data.dtype.kind == "f":
                acc = np.zeros(G, dtype=np.float64)
                np.add.at(acc, inv, np.where(col.valid, col.data, 0.0))
            else:
                acc = _exact_sum(inv, G, col.data, col.valid)
            if a.name == "sum":
                data = acc if col.data.dtype.kind == "f" else _to_i64(acc, "SUM")
                cols.append(Column(ft, data, has))
                pos += 1
            else:
                cc = all_.columns[pos + 1]
                cnt = _exact_sum(inv, G, cc.data, cc.valid)
                ok = has & (np.array(cnt) > 0)
                if ft.is_float():
                    data = np.where(ok, np.asarray(acc, dtype=np.float64) / np.maximum(cnt, 1), 0.0)
                    cols.append(Column(ft, data, ok))
                else:
                    sum_scale = max(col.ft.decimal, 0)
                    out_scale = max(ft.decimal, 0)
                    q = [Dec(int(s), sum_scale).div(Dec(int(c), 0)).rescale(out_scale).value if k else 0
                         for s, c, k in zip(acc, cnt, ok.tolist())]
                    cols.append(Column(ft, _to_i64(q, "AVG"), ok))
                pos += 2
        elif a.name in ("min", "max"):
            data, has = _minmax(a.name, inv, G, col, a.args[0].ret_type if a.args else None)
            cols.append(Column(ft, data, has))
            pos += 1
        elif a.name in ("bit_and", "bit_or", "bit_xor"):
            # ref: FinalHashAggExec._merge_state — fold the partials from the
            # identity (a NULL partial is the identity); never NULL, unsigned
            ident = -1 if a.name == "bit_and" else 0
            fn = {"bit_and": np.bitwise_and, "bit_or": np.bitwise_or, "bit_xor": np.bitwise_xor}[a.name]
            acc = np.full(G, ident, dtype=np.int64)
            fn.at(acc, inv, np.where(col.valid, col.data.astype(np.int64), ident))
            cols.append(Column(ft, acc.view(np.uint64), np.ones(G, dtype=bool)))
            pos += 1
        else:  # first_row: the first partial row of the group wins, NULL or not
            firsts = np.full(G, n, dtype=np.int64)
            np.minimum.at(firsts, inv, np.arange(n))
            dt = col_numpy_dtype(ft)
            data = col.data[firsts] if dt is not VARLEN else col.data[firsts].astype(object)
            cols.append(Column(ft, data, col.valid[firsts]))
            pos += 1
        oi += 1
    return Chunk(cols)


def order_by_keys(chunk: Chunk, group_by: list[Expression]) -> Chunk:
    """ORDER BY the group keys ascending (NULLs first, collation order)."""
    if not group_by or chunk.num_rows == 0:
        return chunk
    keys = [(collation_key_lane(chunk.columns[i].data, g.ret_type), chunk.columns[i].valid, False)
            for i, g in enumerate(group_by)]
    return chunk.take(_lex_argsort(keys, chunk.num_rows))


def top_n(chunk: Chunk, by: list[tuple[Expression, bool]], n: int) -> Chunk:
    """ORDER BY the TopN keys (collation order; NULLs first ASC, last
    DESC; stable), first n rows."""
    if chunk.num_rows == 0:
        return chunk
    keys = []
    for e, desc in by:
        d, v = e.eval(chunk)
        d = np.broadcast_to(d, (chunk.num_rows,)) if np.ndim(d) == 0 else d
        v = np.broadcast_to(v, (chunk.num_rows,)) if np.ndim(v) == 0 else v
        keys.append((collation_key_lane(d, e.ret_type), v, desc))
    return chunk.take(_lex_argsort(keys, chunk.num_rows)[:n])
