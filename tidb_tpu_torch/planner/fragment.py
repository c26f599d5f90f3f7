"""MPP fragment slicing (copy of tidb_tpu/planner/fragment.py; ref:
planner/core/fragment.go:64 GenerateRootMPPTasks, :202 buildFragments;
exchange types in plan_to_pb.go:229).

The reference slices a physical plan into fragments at ExchangeSender/
ExchangeReceiver boundaries and dispatches each fragment to TiFlash
stores, with hash/broadcast chunk exchange over gRPC tunnels
(cophandler/mpp_exec.go:109). This module keeps the same *logical*
slicing — it produces the fragment tree — and the fragments do not
become separate processes: the port's MPP engine (parallel/mpp.py) runs
the whole tree as one program of CUDA kernels on each rank, where an
ExchangeSender(hash) is an all_to_all over the mesh's ranks and
ExchangeSender(broadcast) a replicated operand.

An MPPPlan also carries the host steps above the gather
(executor/mpp_gather.RootStep: the final aggregate's HAVING, projection
and TopN), which the reference's executor tree runs; `entry.mpp_plan`
derives them from the plan above the cut.

Eligibility here mirrors `CanExprsPushDown` + mppTask checks
(planner/core/task.go:2088): inner/left equi-joins on integer-typed keys,
scans without index paths, device-lowerable conditions.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

from ..expr.expression import Column as ExprCol, Expression
from ..mysqltypes.field_type import FieldType
from .plans import Aggregation, DataSource, Join, LogicalPlan, Projection, Selection

# exchange modes (ref: tipb ExchangeType)
HASH = "hash"
BROADCAST = "broadcast"
PASSTHROUGH = "passthrough"
# Fused chains: a LUT-specialized join level needs NO exchange at
# all — the device-resident build structure (and the build lanes behind
# it) is replicated to every device, the sharded stream probes in place.
# Distinct from BROADCAST so EXPLAIN/tests can tell "replicated because
# small" from "replicated because the resident structure lives there".
LOCAL = "local"


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
    """A join fragment: probe child (sharded stream) ⋈ build child (scan).

    `exchange` is decided at compile time from build-side cardinality:
    BROADCAST replicates the build lanes to every device (all_gather
    analog); HASH repartitions both sides by join key (all_to_all)."""

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
    agg: Aggregation | None  # fused partial aggregation, if any
    out_cols: list  # joined schema (probe cols then build cols, leftmost first)
    join_node: Join = None  # original plan node (host fallback path)
    # fused ORDER BY <agg output> LIMIT k (ref: pushed TopN over the MPP
    # gather, planner/core/task.go attach2Task TopN pushdown): set by the
    # Limit(Sort(...)) builder when the sort key is a single sum/count
    # aggregate. Enables the sorted (wide-key) device agg mode, whose
    # output is k groups per device instead of the joined rows.
    topn: tuple | None = None  # (agg_idx, desc: bool, k: int)
    # the host steps above the gather (executor/mpp_gather.RootStep), where
    # the reference's executor tree puts them; None: the gather's output
    root_step: object = None

    def explain(self, indent: int = 0) -> str:
        """Fragment-tree rendering for EXPLAIN (sender/receiver parity)."""
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


def _int_key(ft: FieldType) -> bool:
    """Join keys must be integer-shaped on device: ints, dates/times
    (packed int64), decimals (scaled int64). Floats (inexact) and strings
    (per-table dict codes are not comparable across tables) fall back."""
    return not ft.is_float() and not ft.is_string()


def _plain_scan(ds: DataSource) -> bool:
    """Mesh gathers read whole-table lanes: a scan whose access path
    consumed conditions into key_ranges (PK handle ranges, index paths)
    must stay on the host readers or rows filtered by ranges would leak
    back in."""
    if ds.table.partition is not None:
        return False  # partitioned rows live in per-partition keyspaces
    return getattr(ds, "path", "table") == "table" and getattr(ds, "key_ranges", None) is None


def _fold_selection(node: LogicalPlan):
    """Selection(DataSource) → DataSource with conds folded into pushed.

    Works on a shallow COPY of the DataSource: slicing is an eligibility
    probe that may be declined (or run twice when try_build_mpp fires at
    nested nodes), so the shared plan tree must stay untouched."""
    if isinstance(node, Selection) and isinstance(node.children[0], DataSource):
        ds = copy.copy(node.children[0])
        ds.pushed_conds = list(ds.pushed_conds) + list(node.conds)
        return ds
    return node


def _peel_identity_projection(node: LogicalPlan) -> LogicalPlan:
    """The optimizer roots every SELECT with a Projection; when it is the
    identity over its child's schema it is a no-op for slicing, so peel it
    (mirrors eliminatePhysicalProjection, ref planner/core/optimizer.go:196)."""
    while isinstance(node, Projection):
        exprs = node.exprs
        child = node.children[0]
        if len(exprs) != len(child.out_cols):
            break
        if not all(isinstance(e, ExprCol) and e.idx == i for i, e in enumerate(exprs)):
            break
        node = child
    return node


def _note_reason(reason, key: str, detail: str, node=None) -> None:
    """Record the FIRST slice-decline reason (typed key + human detail +
    the Join node whose keys failed) for the enforce_mpp warning /
    fallback accounting — later, inner declines of the same slicing
    attempt don't overwrite it. The failing NODE lets the caller count
    one decline per statement even when an outer Join's slice fails on an
    inner Join's keys and the host build then retries that inner Join."""
    if reason is not None and not reason:
        reason.append((key, detail, node))


def _slice_join(node: Join, offset: int, scans: list[ScanFrag], reason=None):
    """Left-deep join tree → JoinFrag tree; None if ineligible."""
    if node.kind not in ("inner", "left"):
        return None, offset
    left, right = (_fold_selection(c) for c in node.children)
    # probe side: nested join or scan; build side: scan only (left-deep)
    if isinstance(left, Join):
        probe, offset = _slice_join(left, offset, scans, reason)
        if probe is None:
            return None, offset
    elif isinstance(left, DataSource):
        if not _plain_scan(left):
            return None, offset
        probe = ScanFrag(left, offset)
        scans.append(probe)
        offset += probe.n_cols
    else:
        return None, offset
    if not (isinstance(right, DataSource) and _plain_scan(right)):
        return None, offset
    build = ScanFrag(right, offset)
    scans.append(build)
    offset += build.n_cols

    if not node.eq_conds:
        return None, offset  # cross join: no MPP
    pk, bk = [], []
    for le, re in node.eq_conds:
        if not (isinstance(le, ExprCol) and isinstance(re, ExprCol)):
            _note_reason(reason, "non_column_join_key", "non-column join key", node)
            return None, offset
        if not (_int_key(le.ret_type) and _int_key(re.ret_type)):
            if le.ret_type.is_string() or re.ret_type.is_string():
                _note_reason(reason, "string_join_key", "string join key", node)
            elif le.ret_type.is_float() or re.ret_type.is_float():
                _note_reason(reason, "float_join_key", "float join key", node)
            else:
                _note_reason(reason, "non_int_join_key", "non-integer join key", node)
            return None, offset
        # eq_conds are over the concatenated schema; build side is the
        # right child, i.e. indices >= build.side_offset
        a, b = (le, re) if le.idx < build.side_offset else (re, le)
        if a.idx >= build.side_offset or b.idx < build.side_offset:
            return None, offset
        pk.append(a.idx)
        bk.append(b.idx)
    return JoinFrag(probe, build, node.kind, pk, bk, list(node.other_conds)), offset


def slice_plan(plan: LogicalPlan, reason: list | None = None) -> MPPPlan | None:
    """Try to slice an optimized plan (sub)tree into an MPP fragment plan.

    Accepted roots: Aggregation(JoinTree) — fully fused partial-agg
    program; JoinTree — joined-rows program (host operators continue on
    top). Returns None when the shape/types don't qualify; caller falls
    back to the root HashJoin path. `reason` (optional list) receives one
    `(typed_key, detail)` pair describing the FIRST decline — the
    enforce_mpp warning / tidb_tpu_fallback_total surface."""
    agg = None
    node = _peel_identity_projection(plan)
    if isinstance(node, Aggregation) and isinstance(node.children[0], (Join, Selection)):
        inner = _fold_selection(node.children[0])
        if isinstance(inner, Join):
            agg = node
            node = inner
    if not isinstance(node, Join):
        return None
    scans: list[ScanFrag] = []
    root, _ = _slice_join(node, 0, scans, reason)
    if root is None:
        return None
    if agg is not None:
        for a in agg.aggs:
            if a.name not in ("count", "sum", "avg", "min", "max") or a.distinct:
                return None
    return MPPPlan(root, scans, agg, list(node.out_cols), node)
