"""Root-side executor helpers (copy of tidb_tpu/executor/executors.py:316-345
`_mpp_topn_spec`; ref: executor/builder.go). The rest of the module — the
executor tree, `build_executor`, FinalHashAggExec, HashJoinExec — comes
with the executors and the cop client (ROADMAP Queue 1, item 4.3);
`entry.mpp_plan` attaches the fused TopN through this function as the
reference's `_build_limit` does.
"""

from __future__ import annotations

from ..planner.plans import Aggregation, Projection, Sort


def _mpp_topn_spec(sort_plan: Sort, inner) -> tuple | None:
    """ORDER BY <single sum/count aggregate> over Projection?(Aggregation)
    → (agg_idx, desc) resolved into the Aggregation's agg list, else None.
    The device then returns only the top-k groups per device (exact: after
    the hash exchange every group is complete on one device)."""
    from ..expr.expression import Column as _EC

    if len(sort_plan.by) != 1:
        return None
    e, desc = sort_plan.by[0]
    if not isinstance(e, _EC):
        return None
    idx = e.idx
    while isinstance(inner, Projection):
        pe = inner.exprs[idx]
        if not isinstance(pe, _EC):
            return None
        idx = pe.idx
        inner = inner.children[0]
    if not isinstance(inner, Aggregation):
        return None
    ng = len(inner.group_by)
    if idx < ng:
        return None  # ordering by a group key: host TopN handles it
    a = inner.aggs[idx - ng]
    if a.name not in ("sum", "count") or a.distinct:
        return None
    # carry the Aggregation node so the attach step can verify the gather
    # it found actually fused THIS aggregation (nested aggs would
    # otherwise receive the outer agg's topn)
    return (idx - ng, bool(desc), inner)
