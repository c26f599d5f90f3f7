"""MPP gather (ref: tidb_tpu/executor/mpp_gather.py): the scans' numpy
lanes in, the fragment plan through the port's MPPEngine, the host steps
above the gather out.

* `scan_datas`: one ScanData per scan fragment, its lanes projected to the
  scan's output columns by table offset (mpp_gather.py:297-366, with the
  caller's numpy columns in place of tile-cache batches). The (table,
  version) identity the engine caches under is held per engine: the same
  column arrays keep their version, new arrays get the next one.
* `gather`: the engine's partial chunk over a mesh of ranks (one rank by
  default); where the reference's mesh joined
  the rows but could not aggregate them, the partial aggregation over the
  joined rows (`_host_finish_agg`, mpp_gather.py:368-379, through the
  port's host_engine._exec_agg).
* `RootStep` / `finish`: the steps above the gather that the reference's
  executor tree runs for the query: FinalHashAggExec (the port's
  final_agg.merge_partials), the HAVING Selection over its output, the
  projection, the TopN (final_agg.top_n).
* `try_build_mpp` / `root_step_above`: slice_plan over an Aggregation or
  Join as the reference's executor builder tries it (mpp_gather.py:34-80,
  with its typed slice decline counted by the engine), and the RootStep
  that the Selection, Projection, Sort and Limit above the cut make
  (`entry.mpp_plan` puts the two together).

The reference degrades a declined plan to its host hash join; the port
has no host join, so a decline raises NotPortedError with the engine's
typed reason (the decline itself is counted by the engine as in the
reference).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..chunk.chunk import Chunk
from ..copr.dag import AggNode, DAGRequest, ScanNode
from ..copr.host_engine import _eval_mask, _exec_agg
from ..errors import NotPortedError
from ..expr.expression import Column as ECol, Expression
from ..planner.fragment import MPPPlan, slice_plan
from ..planner.plans import Join, Limit, LogicalPlan, Projection, Selection, Sort
from .final_agg import merge_partials, top_n


@dataclass
class RootStep:
    """Above the gather: the rows of the final aggregate that pass
    `having` (conditions over its output columns), its columns taken in
    `proj` order, then ORDER BY `by` (over the projected columns) LIMIT n
    where `by` is given."""

    proj: list[int]
    by: list[tuple[Expression, bool]] = field(default_factory=list)
    n: int | None = None
    having: list[Expression] = field(default_factory=list)


def _table_lanes(engine, table_id: int, data: tuple, masks: tuple):
    """(version, valid lanes) of a table's column arrays for the engine's
    caches: the version stays while the caller passes the same array
    objects (the registry holds them, so their ids stay unique), and the
    all-true masks of columns without one are built once per version."""
    reg = engine.table_versions
    key = data + masks
    old = reg.get(table_id)
    if old is not None and len(old[0]) == len(key) and all(a is b for a, b in zip(old[0], key)):
        return old[1], old[2]
    valid = [np.ones(len(d), dtype=bool) if m is None else np.asarray(m, dtype=bool) for d, m in zip(data, masks)]
    ver = 0 if old is None else old[1] + 1
    reg[table_id] = (key, ver, valid)
    return ver, valid


def scan_datas(mplan: MPPPlan, tables: dict, engine, valid: dict | None = None) -> list:
    """ScanData per scan of `mplan` from `tables[name][column]` numpy lanes
    (`valid[name][column]`: optional NOT-NULL masks)."""
    from ..parallel.mpp import ScanData

    out = []
    for sf in mplan.scans:
        table = sf.ds.table
        cols = tables[table.name]
        given = (valid or {}).get(table.name, {})
        names = [table.columns[pc.orig_offset].name for pc in sf.ds.out_cols]
        data = tuple(np.asarray(cols[name]) for name in names)
        ver, val = _table_lanes(engine, table.id, data, tuple(given.get(name) for name in names))
        offs = [pc.orig_offset for pc in sf.ds.out_cols]
        out.append(ScanData(sf, list(data), list(val), version=ver, shared=engine, orig_offs=offs))
    return out


def gather(mplan: MPPPlan, scans: list, engine, variables: dict | None = None, mesh=None) -> Chunk:
    """The fragment plan's result over `mesh` (parallel/mesh.Mesh; None:
    one rank on the engine's device): the partial-agg chunk (group keys,
    then each aggregate's partial columns) when `mplan.agg` is set, else
    the joined rows."""
    res = engine.execute(mplan, scans, variables or {}, mesh=mesh)
    if res is None:
        raise NotPortedError("mpp_gather.MPPGatherExec host join fallback",
                             f"{engine._decline_key}: {engine.last_fallback_reason}")
    chunk, agg_done = res
    if mplan.agg is not None and not agg_done:
        with engine._phase("host_agg"):
            return _host_finish_agg(mplan, chunk)
    return chunk


def _host_finish_agg(mplan: MPPPlan, chunk: Chunk) -> Chunk:
    """The device joined the rows; the partial aggregation runs here."""
    pseudo = DAGRequest(ScanNode(0, list(range(chunk.num_cols)), chunk.field_types(), []))
    pseudo.agg = AggNode(mplan.agg.group_by, mplan.agg.aggs)
    return _exec_agg(pseudo, chunk, None)


def finish(mplan: MPPPlan, root: RootStep | None, partial: Chunk) -> Chunk:
    """FinalHashAggExec over the partial chunk (the joined rows as they
    are without an aggregation), then the root step."""
    if mplan.agg is None:
        final = partial
    else:
        agg = mplan.agg
        final = merge_partials([partial], agg.group_by, agg.aggs, [c.ft for c in agg.out_cols])
    if root is None:
        return final
    if root.having:
        final = final.filter(_eval_mask(root.having, final))
    out = Chunk([final.columns[i] for i in root.proj])
    return top_n(out, root.by, root.n) if root.by else out


# --- the cut (ref: mpp_gather.py:34-80, executors.py:109-118) ---------------


def _has_join(plan: LogicalPlan) -> bool:
    if isinstance(plan, Join):
        return True
    return any(_has_join(c) for c in plan.children)


def try_build_mpp(plan: LogicalPlan, variables: dict | None = None, engine=None) -> MPPPlan | None:
    """slice_plan over an Aggregation or Join subtree as the reference's
    executor builder tries it: None where it builds the host operators
    instead (MPP disallowed, no join, a slice decline). A decline at a
    Join with a typed reason is counted by `engine` (parallel/mpp.MPPEngine)
    when one is given, as the reference counts it on its store's engine."""
    if (variables or {}).get("tidb_allow_mpp", "ON") != "ON":
        return None
    if not _has_join(plan):
        return None
    reason: list = []
    mplan = slice_plan(plan, reason)
    if mplan is None and isinstance(plan, Join) and reason and engine is not None:
        key, detail, _ = reason[0]
        engine._fallback(key, detail)
    return mplan


def root_step_above(above: list[LogicalPlan], width: int) -> RootStep | None:
    """The RootStep of the host operators `above` the cut (top first) over
    the cut's `width` output columns: Selection → having (over the
    aggregate's output), column Projection → proj, Sort → by, Limit → n.
    Any other shape needs the host executors, which come with the
    executor tree (ROADMAP Queue 1, item 4.3)."""
    if not above:
        return None
    from ..planner.optimizer import _remap_expr

    def later(what):
        return NotPortedError("executor/executors.py build_executor", f"{what} above an MPP gather (item 4.3)")

    proj, having, by, n = None, [], None, None
    for node in reversed(above):
        if isinstance(node, Selection):
            if by is not None or n is not None:
                raise later("a Selection over a Sort or Limit")
            mapping = {i: j for i, j in enumerate(proj)} if proj is not None else {i: i for i in range(width)}
            having += [_remap_expr(c, mapping) for c in node.conds]
        elif isinstance(node, Projection):
            if by is not None or n is not None:
                raise later("a Projection over a Sort or Limit")
            if not all(isinstance(e, ECol) for e in node.exprs):
                raise later("a computed Projection")
            cur = proj if proj is not None else list(range(width))
            proj = [cur[e.idx] for e in node.exprs]
        elif isinstance(node, Sort):
            if by is not None or n is not None:
                raise later("a second Sort")
            by = list(node.by)
        elif isinstance(node, Limit):
            if n is not None or by is None or node.offset:
                raise later("a Limit without a Sort below it, or with an offset")
            n = node.count
        else:
            raise later(type(node).__name__)
    return RootStep(proj=proj if proj is not None else list(range(width)), by=by or [], n=n, having=having)
