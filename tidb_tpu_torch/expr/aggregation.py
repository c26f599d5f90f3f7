"""Aggregate function descriptors (copy of tidb_tpu/expr/aggregation.py;
ref: expression/aggregation/descriptor.go).

The partial/final mode split is the heart of distributed aggregation
(SURVEY §2.13.3): cop/TPU side computes partials per shard, root side
merges. On device, partials are exact integer/float segment reductions
and the cross-device merge is a `psum` — which is why SUM over decimals
uses scaled int64 lanes.

    func   | partial state         | final merge
    -------|-----------------------|---------------------
    count  | count:int64           | sum of counts
    sum    | sum (+has flag)       | sum of sums
    avg    | (sum, count)          | sum/ count  (exact decimal div)
    min    | min (+has flag)       | min of mins
    max    | max                   | max of maxs
    first_row | first value        | first of firsts
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..mysqltypes.field_type import FieldType, ft_longlong, ft_double, ft_decimal
from ..mysqltypes.mydecimal import MAX_SCALE, DIV_FRAC_INCR
from .expression import Expression

MODE_COMPLETE = "complete"
MODE_PARTIAL = "partial"
MODE_FINAL = "final"

PUSHABLE_AGGS = (
    "count", "sum", "avg", "min", "max", "first_row",
    # (cnt, sum, sumsq) / bitwise partials merge exactly at the root final
    "stddev_pop", "stddev_samp", "var_pop", "var_samp",
    "bit_and", "bit_or", "bit_xor",
    # FM-sketch partials union exactly at the root final (ref:
    # aggfuncs approxCountDistinctPartial1/Final, statistics/fmsketch.go)
    "approx_count_distinct",
)
AGG_FUNCS = PUSHABLE_AGGS + (
    "group_concat",
    "stddev_pop", "stddev_samp", "std", "stddev",
    "var_pop", "var_samp", "variance",
    "bit_and", "bit_or", "bit_xor",
    # complete-mode only (ref: aggfuncs.go:45-53 percentileOriginal*,
    # jsonArrayagg/jsonObjectagg)
    "approx_percentile", "json_arrayagg", "json_objectagg",
)
# aliases normalize at construction (ref: MySQL STD/STDDEV/VARIANCE)
_AGG_ALIAS = {"std": "stddev_pop", "stddev": "stddev_pop", "variance": "var_pop"}
# aggs that take other than exactly one argument
_AGG_ARITY = {"approx_percentile": 2, "json_objectagg": 2, "count": (0, 1)}
# aggs that keep NULL argument rows (JSON aggregation includes nulls)
NULL_KEEPING_AGGS = ("json_arrayagg", "json_objectagg")
GROUP_CONCAT_MAX_LEN = 1024  # MySQL group_concat_max_len default


def _scale(ft: FieldType) -> int:
    return max(ft.decimal, 0) if ft.is_decimal() else 0


def agg_ret_type(name: str, arg_ft: FieldType | None) -> FieldType:
    if name == "count":
        return ft_longlong()
    if name == "group_concat":
        from ..mysqltypes.field_type import ft_varchar

        return ft_varchar(GROUP_CONCAT_MAX_LEN)
    if name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
        return ft_double()
    if name in ("bit_and", "bit_or", "bit_xor"):
        ft = ft_longlong()
        from ..mysqltypes.field_type import UNSIGNED_FLAG

        ft.flag |= UNSIGNED_FLAG
        return ft
    if name == "approx_count_distinct":
        return ft_longlong()
    if name in ("json_arrayagg", "json_objectagg"):
        from ..mysqltypes.field_type import TypeCode

        return FieldType(TypeCode.JSON, flen=-1)
    if name == "approx_percentile":
        return arg_ft.clone()
    if name == "sum":
        if arg_ft.is_float() or arg_ft.is_string():
            return ft_double()
        # SUM of int/decimal is decimal in MySQL
        return ft_decimal(38, _scale(arg_ft))
    if name == "avg":
        if arg_ft.is_float() or arg_ft.is_string():
            return ft_double()
        return ft_decimal(38, min(_scale(arg_ft) + DIV_FRAC_INCR, MAX_SCALE))
    # min/max/first_row keep the arg type
    return arg_ft.clone()


@dataclass
class AggDesc:
    name: str
    args: list[Expression]
    distinct: bool = False
    mode: str = MODE_COMPLETE
    ret_type: FieldType = field(default_factory=ft_longlong)

    sep: str = ","  # GROUP_CONCAT separator
    max_len: int = GROUP_CONCAT_MAX_LEN  # group_concat_max_len sysvar

    @staticmethod
    def make(name: str, args: list[Expression], distinct: bool = False) -> "AggDesc":
        from ..errors import TiDBError

        name = _AGG_ALIAS.get(name.lower(), name.lower())
        if name not in AGG_FUNCS:
            raise ValueError(f"unknown aggregate {name}")
        want = _AGG_ARITY.get(name, 1)
        lo, hi = want if isinstance(want, tuple) else (want, want)
        if not (lo <= len(args) <= hi):
            raise TiDBError(f"aggregate {name.upper()} takes {want} argument(s)")
        if name == "approx_percentile":
            from .expression import Constant

            p = args[1]
            ok = isinstance(p, Constant) and not p.value.is_null
            try:
                f = p.value.to_float()
                ok = ok and f == int(f) and 1 <= int(f) <= 100
            except Exception:
                ok = False
            if not ok:
                raise TiDBError("Percentage value must be a constant integer in [1, 100]")
        arg_ft = args[0].ret_type if args else None
        return AggDesc(name, args, distinct, MODE_COMPLETE, agg_ret_type(name, arg_ft))

    def pushable(self) -> bool:
        """May this aggregate run as a cop/TPU partial? (ref: agg_to_pb.go)"""
        return (
            not self.distinct
            and self.name in PUSHABLE_AGGS
            and all(a.pushable() for a in self.args)
        )

    def partial_final_types(self) -> list[tuple[str, FieldType]]:
        """The partial-state columns this agg ships back from the cop side."""
        if self.name == "count":
            return [("count", ft_longlong())]
        if self.name == "sum":
            return [("sum", self.ret_type)]
        if self.name == "avg":
            arg = self.args[0].ret_type
            return [("sum", agg_ret_type("sum", arg)), ("count", ft_longlong())]
        if self.name == "group_concat":
            return [("concat", self.ret_type)]
        if self.name in ("stddev_pop", "stddev_samp", "var_pop", "var_samp"):
            return [("count", ft_longlong()), ("sum", ft_double()), ("sumsq", ft_double())]
        if self.name == "approx_count_distinct":
            from ..mysqltypes.field_type import ft_varchar

            return [("sketch", ft_varchar(-1))]  # serialized FMSketch bytes
        return [(self.name, self.ret_type)]

    def __repr__(self):
        d = "distinct " if self.distinct else ""
        s = f" sep={self.sep!r}" if self.name == "group_concat" and self.sep != "," else ""
        if self.name == "group_concat" and self.max_len != GROUP_CONCAT_MAX_LEN:
            s += f" maxlen={self.max_len}"  # digest/plan-cache key material
        return f"{self.name}({d}{', '.join(map(repr, self.args))}{s})"


# window-only functions (ref: executor/aggfuncs window functions; the agg
# functions above are also valid window functions via OVER)
WINDOW_FUNCS = (
    "row_number",
    "rank",
    "dense_rank",
    "ntile",
    "lead",
    "lag",
    "first_value",
    "last_value",
    "nth_value",
    "cume_dist",
    "percent_rank",
)


@dataclass(frozen=True)
class Frame:
    """Normalized window frame (ref: planner/core WindowFrame). Bound
    kinds: 'up'|'pre'|'cur'|'fol'|'uf'; offsets are validated non-negative
    numbers (ROWS: ints; RANGE: numbers in the ORDER BY key's own space —
    decimal keys carry the offset pre-scaled to the key's scaled-int
    form). `None` frame == MySQL default (RANGE UNBOUNDED PRECEDING ..
    CURRENT ROW with ORDER BY, whole partition without)."""

    unit: str  # 'rows' | 'range'
    start_kind: str
    start_off: object = 0  # int | float
    end_kind: str = "cur"
    end_off: object = 0

    def key(self):
        return (self.unit, self.start_kind, self.start_off, self.end_kind, self.end_off)


@dataclass
class WinDesc:
    """One window function over a (PARTITION BY, ORDER BY) spec
    (ref: planner/core WindowFuncDesc + ast WindowSpec)."""

    name: str
    args: list[Expression]
    part_by: list[Expression]
    order_by: list  # [(Expression, desc: bool)]
    ret_type: FieldType = field(default_factory=ft_longlong)
    frame: Frame | None = None  # None == default frame semantics

    def spec_key(self) -> str:
        return f"part={self.part_by!r}|order={[(repr(e), d) for e, d in self.order_by]!r}"

    def __repr__(self):
        fr = f" frame={self.frame.key()}" if self.frame is not None else ""
        return f"{self.name}({', '.join(map(repr, self.args))}) over({self.spec_key()}{fr})"
