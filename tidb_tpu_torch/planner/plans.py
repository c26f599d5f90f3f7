"""Logical plan nodes (copy of tidb_tpu/planner/plans.py; ref: planner/core logical ops — compact redesign).

Every node carries an output schema: a list of PlanCol. Expressions inside
nodes reference child output by offset (expr.Column.idx), with join
children concatenated left-then-right.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..catalog.schema import TableInfo
from ..expr.expression import Expression
from ..expr.aggregation import AggDesc
from ..mysqltypes.field_type import FieldType


@dataclass
class PlanCol:
    name: str
    ft: FieldType
    table_alias: str = ""
    orig_offset: int = -1  # offset in the base table (DataSource only)


class LogicalPlan:
    children: list
    out_cols: list[PlanCol]

    def __init__(self, children, out_cols):
        self.children = children
        self.out_cols = out_cols

    def pretty(self, indent=0) -> str:
        pad = "  " * indent
        s = pad + self.describe()
        for c in self.children:
            s += "\n" + c.pretty(indent + 1)
        return s

    def describe(self) -> str:
        return type(self).__name__


class DataSource(LogicalPlan):
    def __init__(self, table: TableInfo, alias: str, cols: list[PlanCol]):
        super().__init__([], cols)
        self.table = table
        self.alias = alias
        self.pushed_conds: list[Expression] = []

    def describe(self):
        s = f"DataSource({self.alias or self.table.name})"
        path = getattr(self, "path", "table")
        if path == "point":
            s += f" point:{self.point_handles!r}"
        elif path in ("index", "index_lookup"):
            kind = "IndexReader" if path == "index" else "IndexLookUp"
            s += f" {kind}({self.index.name}, {len(self.key_ranges)} ranges)"
        elif path == "index_merge":
            names = [b[1].name if b[0] == "index" else "pk" for b in self.merge_branches]
            s += f" IndexMerge({', '.join(names)})"
        elif getattr(self, "key_ranges", None) is not None:
            s += f" handle_ranges:{len(self.key_ranges)}"
        if self.pushed_conds:
            s += f" pushed:{self.pushed_conds!r}"
        return s


class Selection(LogicalPlan):
    def __init__(self, child, conds: list[Expression]):
        super().__init__([child], child.out_cols)
        self.conds = conds

    def describe(self):
        return f"Selection{self.conds!r}"


class Projection(LogicalPlan):
    def __init__(self, child, exprs: list[Expression], cols: list[PlanCol]):
        super().__init__([child], cols)
        self.exprs = exprs

    def describe(self):
        return f"Projection{self.exprs!r}"


class Aggregation(LogicalPlan):
    def __init__(self, child, group_by: list[Expression], aggs: list[AggDesc], cols: list[PlanCol]):
        super().__init__([child], cols)
        self.group_by = group_by
        self.aggs = aggs

    def describe(self):
        return f"Aggregation(group={self.group_by!r}, aggs={self.aggs!r})"


class Join(LogicalPlan):
    def __init__(self, left, right, kind: str, eq_conds, other_conds, cols):
        super().__init__([left, right], cols)
        self.kind = kind  # inner | left | right | cross | semi | anti
        self.eq_conds = eq_conds  # [(left_expr, right_expr)] over the concatenated schema
        self.other_conds = other_conds  # over concatenated schema
        # null-aware NOT IN key pair (lhs over left schema, rhs over
        # concatenated schema); only set on anti joins built from NOT IN
        self.na_key = None

    def describe(self):
        return f"Join({self.kind}, eq={self.eq_conds!r}, other={self.other_conds!r})"


class Window(LogicalPlan):
    """Window functions over one PARTITION BY / ORDER BY spec (ref:
    planner/core PhysicalWindow; executor/window.go:31). Output = child
    columns followed by one column per window function; several specs in
    one query stack several Window nodes."""

    def __init__(self, child, part_by: list[Expression], order_by, funcs, cols):
        super().__init__([child], cols)
        self.part_by = part_by
        self.order_by = order_by  # [(Expression, desc)]
        self.funcs = funcs  # list[WinDesc]

    def describe(self):
        return (
            f"Window(partition={self.part_by!r}, order={[(repr(e), d) for e, d in self.order_by]!r}, "
            f"funcs={[f.name for f in self.funcs]!r})"
        )


class Sort(LogicalPlan):
    def __init__(self, child, by: list[tuple[Expression, bool]]):
        super().__init__([child], child.out_cols)
        self.by = by

    def describe(self):
        return f"Sort{[(repr(e), d) for e, d in self.by]!r}"


class Limit(LogicalPlan):
    def __init__(self, child, count: int, offset: int = 0):
        super().__init__([child], child.out_cols)
        self.count = count
        self.offset = offset

    def describe(self):
        return f"Limit({self.count}, offset={self.offset})"


class Dual(LogicalPlan):
    """One-row no-table source (SELECT 1)."""

    def __init__(self):
        super().__init__([], [])


class Memtable(LogicalPlan):
    """Virtual table materialized from in-memory state at read time
    (ref: infoschema memtable framework, tables.go)."""

    def __init__(self, name: str, provider, cols):
        super().__init__([], cols)
        self.name = name
        self.provider = provider  # callable() -> list[list[Datum]]

    def describe(self):
        return f"Memtable({self.name})"


class CTEStorage:
    """Shared buffer between a RecursiveCTE producer and its CTERef readers
    (ref: util/cteutil storage)."""

    def __init__(self):
        self.chunk = None  # current iteration's working chunk


class CTERef(LogicalPlan):
    """Reads the recursive CTE's working table inside the recursive branch
    (ref: executor/cte_table_reader.go CTETableReaderExec)."""

    def __init__(self, name: str, storage: CTEStorage, cols):
        super().__init__([], cols)
        self.name = name
        self.storage = storage

    def describe(self):
        return f"CTERef({self.name})"


class RecursiveCTE(LogicalPlan):
    """WITH RECURSIVE: seed plan UNION [ALL] recursive plan iterated to a
    fixpoint (ref: executor/cte.go:60 CTEExec)."""

    def __init__(self, name: str, seed, recursive, storage: CTEStorage, distinct: bool, cols):
        super().__init__([seed, recursive], cols)
        self.name = name
        self.storage = storage
        self.distinct = distinct  # UNION vs UNION ALL between iterations

    def describe(self):
        return f"RecursiveCTE({self.name}, {'union' if self.distinct else 'union_all'})"


class SetOp(LogicalPlan):
    def __init__(self, children, ops: list[str], cols):
        super().__init__(children, cols)
        self.ops = ops  # 'union' | 'union_all' | 'except' | 'intersect'

    def describe(self):
        return f"SetOp({self.ops})"
