"""The pushdown IR (copy of tidb_tpu/copr/dag.py) — tipb-DAGRequest analog (ref: pingcap/tipb DAGRequest,
planner/core/plan_to_pb.go producer, unistore cophandler consumer).

A DAGRequest is a linear pipeline rooted at a scan:

    ScanNode → [SelectionNode] → [AggNode | TopNNode] → [LimitNode]

Expressions inside nodes are `expr.Expression` trees whose Column indices
refer to the scan's output column order. The digest (stable structural
hash) keyed the reference TPU engine's jit-program cache — the analog of the cop
cache keyed on request bytes (store/copr/coprocessor_cache.go), except
what's cached here is a compiled XLA program, not a result.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..expr.expression import Expression
from ..expr.aggregation import AggDesc
from ..mysqltypes.field_type import FieldType


@dataclass
class ScanNode:
    table_id: int
    col_offsets: list[int]  # offsets into the table's full column list
    col_fts: list[FieldType]
    col_ids: list[int]
    desc: bool = False


@dataclass
class SelectionNode:
    conds: list[Expression]


@dataclass
class AggNode:
    group_by: list[Expression]
    aggs: list[AggDesc]


@dataclass
class TopNNode:
    by: list[tuple[Expression, bool]]  # (expr, desc)
    n: int


@dataclass
class LimitNode:
    n: int


@dataclass
class DAGRequest:
    scan: ScanNode
    selection: SelectionNode | None = None
    agg: AggNode | None = None
    topn: TopNNode | None = None
    limit: LimitNode | None = None

    def output_types(self) -> list[FieldType]:
        """Field types of the chunks this DAG produces (partial-agg layout:
        group-by columns first, then per-agg partial states)."""
        if self.agg is not None:
            fts = [g.ret_type for g in self.agg.group_by]
            for a in self.agg.aggs:
                fts.extend(ft for _, ft in a.partial_final_types())
            return fts
        return list(self.scan.col_fts)

    def digest(self) -> str:
        """Stable structural key for program caching."""
        parts = [
            "scan", str(self.scan.table_id), repr(self.scan.col_offsets),
            repr([int(ft.tp) for ft in self.scan.col_fts]),
            repr([(ft.flag, ft.decimal) for ft in self.scan.col_fts]),
        ]
        if self.selection:
            parts += ["sel"] + [repr(c) for c in self.selection.conds]
        if self.agg:
            parts += ["agg"] + [repr(g) for g in self.agg.group_by] + [repr(a) for a in self.agg.aggs]
        if self.topn:
            parts += ["topn", str(self.topn.n)] + [f"{e!r}:{d}" for e, d in self.topn.by]
        if self.limit:
            parts += ["limit", str(self.limit.n)]
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]
