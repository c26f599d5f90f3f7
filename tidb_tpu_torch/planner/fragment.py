"""MPP fragment plans (ref: tidb_tpu/planner/fragment.py:31-105).

An MPPPlan is a left-deep tree of JoinFrags over ScanFrags, with an
optional fused partial aggregation and an optional fused ORDER BY <agg>
LIMIT k (`topn`). The port has no planner yet, so `slice_plan` (which
cuts these plans out of an optimized logical plan) waits for the front
door; `models/tpch.py` builds the plans the reference's `slice_plan`
emits by hand.

`DataSource` and `PlanCol` are minimal stand-ins for the reference's
planner nodes (tidb_tpu/planner/plans.py): only what the MPP engine reads
(the table, the alias EXPLAIN prints, the output columns with their
field types and table offsets, the pushed-down conditions).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..catalog.schema import TableInfo
from ..expr.aggregation import AggDesc
from ..expr.expression import Expression
from ..mysqltypes.field_type import FieldType

# exchange modes (ref: tipb ExchangeType); LOCAL marks a LUT-specialized
# join level, whose build structure is replicated and needs no exchange
HASH = "hash"
BROADCAST = "broadcast"
PASSTHROUGH = "passthrough"
LOCAL = "local"


@dataclass
class PlanCol:
    name: str
    ft: FieldType
    table_alias: str = ""
    orig_offset: int = -1  # offset in the base table


@dataclass
class DataSource:
    table: TableInfo
    alias: str
    out_cols: list[PlanCol]
    pushed_conds: list[Expression] = field(default_factory=list)


@dataclass
class Aggregation:
    """The fused aggregation of an MPPPlan: group keys and aggregates over
    the joined schema, and the output columns of the final aggregate."""

    group_by: list[Expression]
    aggs: list[AggDesc]
    out_cols: list[PlanCol]


@dataclass
class ScanFrag:
    """A leaf fragment: one table scan with pushed-down conditions."""

    ds: DataSource
    side_offset: int  # where this scan's columns start in the joined schema

    @property
    def n_cols(self) -> int:
        return len(self.ds.out_cols)


@dataclass
class JoinFrag:
    """probe child (the stream) ⋈ build child (a scan)."""

    probe: "JoinFrag | ScanFrag"
    build: ScanFrag
    kind: str  # inner | left
    probe_keys: list[int]  # joined-schema column indices
    build_keys: list[int]
    post_conds: list[Expression] = field(default_factory=list)
    exchange: str = BROADCAST


@dataclass
class MPPPlan:
    root: JoinFrag
    scans: list[ScanFrag]
    agg: Aggregation | None
    out_cols: list  # joined schema (probe cols then build cols, leftmost first)
    # fused ORDER BY <agg output> LIMIT k: (agg_idx, desc, k)
    topn: tuple | None = None
    # the host steps above the gather (executor/mpp_gather.RootStep), where
    # the reference's executor tree puts them; None: the gather's output
    root_step: object = None

    def explain(self, indent: int = 0) -> str:
        """Fragment-tree rendering for EXPLAIN (ref: fragment.py:85)."""
        lines: list[str] = []
        if self.agg is not None:
            lines.append("PartialAggregation(psum)")

        def walk(f, depth):
            pad = "  " * depth
            if isinstance(f, ScanFrag):
                lines.append(f"{pad}ExchangeSender({PASSTHROUGH})")
                lines.append(f"{pad}  TableScan({f.ds.alias or f.ds.table.name})")
                return
            lines.append(f"{pad}HashJoin({f.kind})")
            walk(f.probe, depth + 1)
            lines.append(f"{pad}  ExchangeReceiver")
            lines.append(f"{pad}    ExchangeSender({f.exchange})")
            lines.append(f"{pad}      TableScan({f.build.ds.alias or f.build.ds.table.name})")

        walk(self.root, 1 if self.agg else 0)
        return "\n".join(lines)
