"""Condition → key-range derivation (copy of tidb_tpu/planner/ranger.py; ref: util/ranger — detacher.go:736
DetachCondAndBuildRangeForIndex, ranger.go:328 BuildTableRange; fresh
compact implementation).

Given the pushed-down conjuncts of a DataSource and an index's column
offsets, detach the prefix of conditions that can be turned into
memcomparable key ranges:

  * an equality / IN chain on a prefix of the index columns, then
  * at most one range column with </<=/>/>= bounds.

Everything not consumed stays as a filter. Constants are converted to the
column's value domain only when the conversion is exact — lossy matches
(e.g. `int_col = 1.5`) are left as filters so semantics never change.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..codec.key import encode_datum_key
from ..codec import tablecodec
from ..expr.expression import Column as ECol, Constant, Expression, ScalarFunc
from ..mysqltypes.coretime import parse_datetime
from ..mysqltypes.datum import Datum, K_INT, K_UINT, K_FLOAT, K_DEC, K_STR, K_BYTES, K_TIME, K_DUR
from ..mysqltypes.field_type import FieldType

# cap on the cartesian product of IN-list point ranges (ref: ranger's
# range-building memory cap idea)
MAX_POINT_RANGES = 128

_REVERSE = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


@dataclass
class ColAccess:
    """Simple conditions on one column, keyed for range building."""

    eq: list[Datum] = field(default_factory=list)  # values from = / IN
    eq_seen: bool = False  # an eq/IN cond was collected (empty eq ≠ unset)
    lo: tuple[Datum, bool] | None = None  # (bound, inclusive)
    hi: tuple[Datum, bool] | None = None
    conds: list[Expression] = field(default_factory=list)  # consumed conds

    def finalize(self) -> None:
        """Intersect eq points with any range bounds so the point ranges
        enforce EVERY consumed condition (mixed `a = 1 AND a > 5` must
        yield the empty set, not silently drop the bound)."""
        if not self.eq_seen:
            return
        pts = self.eq
        if self.lo is not None:
            v, incl = self.lo
            pts = [d for d in pts if (_cmp_datum(d, v) > 0 or (incl and _cmp_datum(d, v) == 0))]
        if self.hi is not None:
            v, incl = self.hi
            pts = [d for d in pts if (_cmp_datum(d, v) < 0 or (incl and _cmp_datum(d, v) == 0))]
        self.eq = pts
        self.lo = self.hi = None


def const_to_col_datum(d: Datum, ft: FieldType) -> Datum | None:
    """Convert a constant datum into the column's stored-key domain,
    returning None unless the conversion is exact (order-preserving and
    roundtrippable) — the gate that keeps range pruning semantics-safe."""
    if d.is_null:
        return None  # NULL never matches =/</> — handled by caller
    k = d.kind
    try:
        if ft.is_time():
            if k == K_TIME:
                return d
            if k in (K_STR, K_BYTES):
                s = d.val if isinstance(d.val, str) else d.val.decode("utf8", "replace")
                p = parse_datetime(s)
                return Datum.t(p) if p is not None else None
            return None
        if ft.is_int():
            # unsigned columns store 0x04 UINT-flag keys (encode_uint);
            # emitting a signed 0x03 datum here would build a key range
            # that can never match a stored entry
            def _fit(v: int) -> Datum | None:
                if ft.is_unsigned:
                    return Datum.u(v) if 0 <= v < (1 << 64) else None
                return Datum.i(v) if -(1 << 63) <= v < (1 << 63) else None

            if k in (K_INT, K_UINT):
                return _fit(int(d.val))
            if k == K_FLOAT:
                return _fit(int(d.val)) if float(d.val).is_integer() else None
            if k == K_DEC:
                dec = d.to_dec()
                if dec.scale == 0:
                    return _fit(dec.value)
                p = 10 ** dec.scale
                return _fit(dec.value // p) if dec.value % p == 0 else None
            return None
        if ft.is_decimal():
            if k in (K_INT, K_UINT, K_DEC):
                return Datum.d(d.to_dec())
            return None
        if ft.is_float():
            if k in (K_INT, K_UINT, K_FLOAT):
                return Datum.f(d.to_float())
            if k == K_DEC:
                return Datum.f(d.to_float())
            return None
        if ft.is_string():
            from ..mysqltypes import collate as _coll

            if _coll.is_ci(getattr(ft, "collate", None)):
                # index keys are stored in BINARY order; a ci predicate
                # must run through the weight-aware filter path, not a
                # binary key range (a range would drop case variants)
                return None
            if k in (K_STR, K_BYTES):
                return d
            return None
    except (ValueError, OverflowError):
        return None
    return None


def _simple_cond(c: Expression):
    """Recognize `col op const` / `const op col` / `col IN (consts)`.
    Returns (col_idx, op, [Datum...]) or None."""
    if not isinstance(c, ScalarFunc):
        return None
    name = c.sig.name
    if name in ("eq", "lt", "le", "gt", "ge"):
        a, b = c.args
        if isinstance(a, ECol) and isinstance(b, Constant):
            return a.idx, name, [b.value]
        if isinstance(a, Constant) and isinstance(b, ECol):
            return b.idx, _REVERSE[name], [a.value]
        return None
    if name == "in":
        a = c.args[0]
        if isinstance(a, ECol) and all(isinstance(x, Constant) for x in c.args[1:]):
            return a.idx, "in", [x.value for x in c.args[1:]]
    return None


def collect_col_access(conds: list[Expression], fts_by_off: dict[int, FieldType]) -> dict[int, ColAccess]:
    """Bucket usable simple conditions per column offset."""
    acc: dict[int, ColAccess] = {}
    for c in conds:
        s = _simple_cond(c)
        if s is None:
            continue
        off, op, vals = s
        ft = fts_by_off.get(off)
        if ft is None:
            continue
        conv = [const_to_col_datum(v, ft) for v in vals]
        if any(v is None for v in conv):
            continue  # not exactly representable — stays a filter
        a = acc.setdefault(off, ColAccess())
        if op in ("eq", "in"):
            if len(conv) > MAX_POINT_RANGES:
                continue
            if not a.eq_seen:
                a.eq = conv
                a.eq_seen = True
            else:
                keep = {_enc(d) for d in conv}
                a.eq = [d for d in a.eq if _enc(d) in keep]
            a.conds.append(c)
        elif op in ("gt", "ge"):
            b = (conv[0], op == "ge")
            if a.lo is None or _tighter_lo(b, a.lo):
                a.lo = b
            a.conds.append(c)
        elif op in ("lt", "le"):
            b = (conv[0], op == "le")
            if a.hi is None or _tighter_hi(b, a.hi):
                a.hi = b
            a.conds.append(c)
    for a in acc.values():
        a.finalize()
    return acc


def _cmp_datum(a: Datum, b: Datum) -> int:
    from ..mysqltypes.datum import compare_datum

    return compare_datum(a, b)


def _tighter_lo(new, old) -> bool:
    c = _cmp_datum(new[0], old[0])
    return c > 0 or (c == 0 and not new[1] and old[1])


def _tighter_hi(new, old) -> bool:
    c = _cmp_datum(new[0], old[0])
    return c < 0 or (c == 0 and not new[1] and old[1])


def prefix_next(b: bytes) -> bytes:
    """Smallest key greater than every key having prefix b (kv.Key.PrefixNext)."""
    ba = bytearray(b)
    for i in range(len(ba) - 1, -1, -1):
        if ba[i] != 0xFF:
            ba[i] += 1
            return bytes(ba[: i + 1])
        ba[i] = 0
    return b + b"\xff"


def _enc(d: Datum) -> bytes:
    buf = bytearray()
    encode_datum_key(buf, d)
    return bytes(buf)


@dataclass
class IndexAccess:
    """Result of detaching access conditions for one index."""

    ranges: list[tuple[bytes, bytes]]  # final key ranges (with index prefix)
    access_conds: list[Expression]  # consumed (enforced by the ranges)
    eq_count: int  # length of the equality prefix
    has_range: bool  # a range column bound was used


def detach_index_conditions(
    conds: list[Expression],
    table_id: int,
    index_id: int,
    col_offsets: list[int],
    col_fts: list[FieldType],
) -> IndexAccess | None:
    """Build key ranges for an index from pushed conjuncts. None if no
    usable access condition exists (ref: DetachCondAndBuildRangeForIndex)."""
    fts_by_off = {off: ft for off, ft in zip(col_offsets, col_fts)}
    acc = collect_col_access(conds, fts_by_off)

    idx_prefix = tablecodec.index_prefix(table_id, index_id)
    eq_values: list[list[Datum]] = []  # per eq column: candidate values
    i = 0
    for off in col_offsets:
        a = acc.get(off)
        if a is None or not a.eq:
            if a is not None and a.eq_seen and not a.eq:
                # eq/bound conds intersected to the empty set → impossible
                return IndexAccess([], a.conds, i + 1, False)
            break
        # dedup by encoded form (Datum is not hashable), keep key order
        uniq = {}
        for d in a.eq:
            uniq.setdefault(_enc(d), d)
        eq_values.append([uniq[k] for k in sorted(uniq)])
        i += 1
    eq_count = i

    range_bounds = None
    if i < len(col_offsets):
        a = acc.get(col_offsets[i])
        if a is not None and (a.lo or a.hi) and not a.eq:
            range_bounds = (a.lo, a.hi)

    if eq_count == 0 and range_bounds is None:
        return None

    # cartesian product of eq prefixes (capped; on overflow drop trailing
    # eq columns — their conds revert to filters, coarser range stays safe)
    prefixes = [b""]
    used_eq = 0
    consumed = []
    for k, vals in enumerate(eq_values):
        nxt = [p + _enc(v) for p in prefixes for v in vals]
        if len(nxt) > MAX_POINT_RANGES:
            range_bounds = None  # range col no longer adjacent to eq prefix
            break
        prefixes = nxt
        used_eq = k + 1
        a = acc.get(col_offsets[k])
        consumed.extend(a.conds)
    if used_eq == eq_count and range_bounds is not None:
        a = acc.get(col_offsets[eq_count])
        consumed.extend(a.conds)
    eq_count = used_eq
    if eq_count == 0 and range_bounds is None:
        return None

    ranges: list[tuple[bytes, bytes]] = []
    for p in prefixes:
        base = idx_prefix + p
        if range_bounds is None:
            ranges.append((base, prefix_next(base)))
            continue
        lo, hi = range_bounds
        if lo is not None:
            lo_key = base + _enc(lo[0])
            low = lo_key if lo[1] else prefix_next(lo_key)
        else:
            low = base + b"\x01"  # skip NULLs (NIL flag 0x00)
        if hi is not None:
            hi_key = base + _enc(hi[0])
            high = prefix_next(hi_key) if hi[1] else hi_key
        else:
            high = prefix_next(base)
        if low < high:
            ranges.append((low, high))
    return IndexAccess(ranges, consumed, eq_count, range_bounds is not None)


@dataclass
class HandleAccess:
    point_handles: list[int] | None  # exact handles (PointGet/BatchPointGet)
    ranges: list[tuple[bytes, bytes]] | None  # record-key ranges
    access_conds: list[Expression]


def detach_pk_handle_access(table, conds: list[Expression]) -> HandleAccess | None:
    """Clustered-int-pk access detection for a table whose expressions
    were built over its VISIBLE columns in order (the DataSource scope
    and the DML WHERE scope are both exactly that): map the handle
    column to its visible index and detach the handle conditions. The
    ONE definition both the SELECT point path (optimizer
    `_choose_for_ds`) and the DML point path (`_scan_matching_rows`)
    use — a change to handle detection lands in both or neither."""
    if not getattr(table, "pk_is_handle", False) or not conds:
        return None
    hc = table.handle_col()
    if hc is None:
        return None
    pk_vis = next(
        (i for i, c in enumerate(table.visible_columns()) if c.offset == hc.offset),
        None,
    )
    if pk_vis is None:
        return None
    return detach_handle_conditions(conds, table.id, pk_vis)


def _or_point_values(cond: Expression, pk_offset: int, ft) -> list[Datum] | None:
    """Flatten `pk=c1 OR pk IN (c2, c3) OR ...` into the point list the
    IN form would produce (ref: ranger's extractOrRanges). Every leaf of
    the OR chain must be an eq/IN on the SAME pk column with exactly-
    representable constants; anything else keeps the full-scan filter."""
    if not isinstance(cond, ScalarFunc):
        return None
    if cond.sig.name == "or":
        out: list[Datum] = []
        for arg in cond.args:
            sub = _or_point_values(arg, pk_offset, ft)
            if sub is None:
                return None
            out.extend(sub)
        return out if len(out) <= MAX_POINT_RANGES else None
    s = _simple_cond(cond)
    if s is None:
        return None
    off, op, vals = s
    if off != pk_offset or op not in ("eq", "in"):
        return None
    conv = [const_to_col_datum(v, ft) for v in vals]
    if any(v is None for v in conv):
        return None
    return conv


def detach_handle_conditions(
    conds: list[Expression], table_id: int, pk_offset: int
) -> HandleAccess | None:
    """Ranges over the integer handle (clustered pk) — ref: BuildTableRange."""
    from ..mysqltypes.field_type import ft_longlong

    acc = collect_col_access(conds, {pk_offset: ft_longlong()})
    a = acc.get(pk_offset)
    if a is None:
        # `pk=a OR pk=b [OR pk IN (...)]` — the disjunctive spelling of
        # an IN list: one OR-chain condition over only the pk
        # detaches to the same multi-point access
        for c in conds:
            pts = _or_point_values(c, pk_offset, ft_longlong())
            if pts is not None and pts:
                handles = sorted({d.to_int() for d in pts})
                return HandleAccess(handles, None, [c])
        return None
    if a.eq_seen:
        handles = sorted({d.to_int() for d in a.eq})
        return HandleAccess(handles, None, a.conds)
    if a.lo is None and a.hi is None:
        return None
    lo_h = -(1 << 63)
    hi_h = (1 << 63) - 1
    if a.lo is not None:
        lo_h = a.lo[0].to_int() + (0 if a.lo[1] else 1)
    if a.hi is not None:
        hi_h = a.hi[0].to_int() - (0 if a.hi[1] else 1)
    if lo_h > hi_h:
        return HandleAccess(None, [], a.conds)  # empty range
    start = tablecodec.record_key(table_id, lo_h)
    end = prefix_next(tablecodec.record_key(table_id, hi_h))
    return HandleAccess(None, [(start, end)], a.conds)
