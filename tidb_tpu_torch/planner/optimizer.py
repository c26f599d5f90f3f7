"""Logical optimization rules (copy of tidb_tpu/planner/optimizer.py; ref: planner/core/optimizer.go:67 rule list;
this implements the subset that drives the pushdown story: predicate
pushdown (rule_predicate_push_down.go) and column pruning
(rule_column_pruning.go). Agg/TopN/Limit pushdown decisions happen at
executor build where cop DAGs are assembled, mirroring how the reference
decides cop vs root in the task model).
"""

from __future__ import annotations

from ..expr.expression import Column as ECol, Constant, Expression, ScalarFunc, make_func
from .plans import Aggregation, DataSource, Dual, Join, Limit, LogicalPlan, Projection, Selection, SetOp, Sort, Window


def optimize(plan: LogicalPlan, stats=None, variables=None) -> LogicalPlan:
    # Column pruning is implicit in this architecture: the tile cache holds
    # whole-table columnar batches decoded once per version, host chunks
    # reference those arrays zero-copy, and the device engine ships only
    # lanes referenced by DAG expressions. The usage analysis below serves
    # index-covering decisions.
    plan = push_down_predicates(plan)
    plan = reorder_joins(plan, stats, variables)
    choose_access_paths(plan, stats, variables)
    return plan


# ------------------------------------------------------------- join reorder


def _remap_expr(e: Expression, mapping: dict) -> Expression:
    if isinstance(e, ECol):
        return ECol(mapping[e.idx], e.ret_type, e.name)
    if isinstance(e, ScalarFunc):
        return ScalarFunc(e.sig, [_remap_expr(a, mapping) for a in e.args], e.ret_type)
    return e


def _reorderable(n) -> bool:
    return (
        isinstance(n, Join)
        and n.kind in ("inner", "cross")
        and n.na_key is None
        and not getattr(n, "straight", False)  # STRAIGHT_JOIN pins order
        and all(isinstance(c, (DataSource, Join)) for c in n.children)
    )


def reorder_joins(root: LogicalPlan, stats=None, variables=None) -> LogicalPlan:
    """Greedy join reorder for inner-join groups over base tables (ref:
    planner/core/rule_join_reorder.go joinReorderGreedySolver): start
    from the smallest estimated leaf, repeatedly join the connected leaf
    with the smallest estimate (cartesian members last). The rebuilt tree
    is wrapped in a Projection restoring the original column order, so
    parents are unaffected."""

    def walk(n: LogicalPlan) -> LogicalPlan:
        # top-down: the MAXIMAL inner-join group must be flattened as one
        # unit — a bottom-up walk would rewrite the inner trio first and
        # hide the outer tables behind the restoring Projection
        if _reorderable(n) and any(_reorderable(c) for c in n.children):
            out = _reorder_group(n, stats, variables)
            if out is not None:
                # the group's leaves were not visited yet; a second pass
                # over the rebuilt tree is a no-op for the group itself
                # (greedy is deterministic) and descends into the leaves
                out.children = [walk(c) for c in out.children]
                return out
        n.children = [walk(c) for c in n.children]
        return n

    return walk(root)


def _leaf_estimate(ds, stats) -> float:
    if not isinstance(ds, DataSource):
        return 1000.0
    tstats = stats.get(ds.table.id) if stats is not None else None
    if tstats is None or tstats.row_count <= 0:
        return 1000.0
    from ..statistics.selectivity import estimate_conds

    total = float(tstats.row_count)
    if not ds.pushed_conds:
        return total
    return max(estimate_conds(tstats, ds.pushed_conds, ds.table.visible_columns()) * total, 1.0)


REORDER_STATS = {"dp": 0, "greedy": 0}  # observable algorithm choice


def _dp_order(leaves, est, edges):
    """Left-deep exhaustive order via subset DP minimizing the summed
    intermediate cardinality (ref: rule_join_reorder_dp.go); eq-join
    connectivity earns a flat reduction factor — the same signal the
    greedy solver ranks by, applied optimally."""
    n = len(leaves)
    conn = [[False] * n for _ in range(n)]
    for a, b in edges:
        conn[a][b] = conn[b][a] = True
    best: dict = {}
    for i in range(n):
        best[1 << i] = (0.0, float(est[i]), (i,))
    for mask in range(1, 1 << n):
        cur = best.get(mask)
        if cur is None:
            continue
        cost, rows, order = cur
        for j in range(n):
            if mask & (1 << j):
                continue
            joined = rows * float(est[j])
            if any(conn[i][j] for i in order):
                joined *= 0.1  # eq-join selectivity proxy
            nm = mask | (1 << j)
            nc = cost + joined
            if nm not in best or nc < best[nm][0]:
                best[nm] = (nc, joined, order + (j,))
    return list(best[(1 << n) - 1][2])


def _reorder_group(root: Join, stats, variables=None):
    # 1. flatten the maximal inner-join subtree into leaves + global conds
    leaves: list = []  # (node, old_offset, width)
    eq_conds: list = []  # (l_expr, r_expr) in OLD global coordinates
    other_conds: list = []

    def flatten(n, offset) -> int:
        if _reorderable(n):
            wl = flatten(n.children[0], offset)
            wr = flatten(n.children[1], offset + wl)
            for l, r in n.eq_conds:
                # l is over the left child schema (== global already for a
                # left-edge subtree at `offset`), r over the concat schema
                eq_conds.append((_shift_expr(l, offset), _shift_expr(r, offset)))
            for c in n.other_conds:
                other_conds.append(_shift_expr(c, offset))
            return wl + wr
        leaves.append((n, offset, len(n.out_cols)))
        return len(n.out_cols)

    total = flatten(root, 0)
    if len(leaves) < 3:
        return None

    # 2. leaf connectivity via eq conds + estimates
    def owner(idx: int) -> int:
        for i, (_, off, w) in enumerate(leaves):
            if off <= idx < off + w:
                return i
        return -1

    est = [_leaf_estimate(n, stats) for n, _, _ in leaves]
    edges: list = []  # (leaf_a, leaf_b) per eq cond
    for l, r in eq_conds:
        ls = {owner(i) for i in _cols_of(l)}
        rs = {owner(i) for i in _cols_of(r)}
        if len(ls) == 1 and len(rs) == 1 and ls != rs:
            edges.append((next(iter(ls)), next(iter(rs))))

    # 3. join order: small groups run the exhaustive subset-DP solver,
    # larger ones the greedy solver (ref: rule_join_reorder.go — DP when
    # n <= tidb_opt_join_reorder_threshold, default 0 = always greedy)
    threshold = int((variables or {}).get("tidb_opt_join_reorder_threshold", "0") or 0)
    if 0 < len(leaves) <= min(threshold, 12):
        order = _dp_order(leaves, est, edges)
        REORDER_STATS["dp"] += 1
    else:
        order = [min(range(len(leaves)), key=lambda i: est[i])]
        chosen = set(order)
        while len(order) < len(leaves):
            connected = [
                i for i in range(len(leaves)) if i not in chosen
                and any((a in chosen) != (b in chosen) and i in (a, b) for a, b in edges)
            ]
            pool = connected or [i for i in range(len(leaves)) if i not in chosen]
            nxt = min(pool, key=lambda i: est[i])
            order.append(nxt)
            chosen.add(nxt)
        REORDER_STATS["greedy"] += 1
    if order == list(range(len(leaves))):
        return None  # already optimal order: keep the original tree

    # 4. old→new global index mapping
    new_off = {}
    pos = 0
    for i in order:
        new_off[i] = pos
        pos += leaves[i][2]
    mapping = {}
    for i, (n, old, w) in enumerate(leaves):
        for k in range(w):
            mapping[old + k] = new_off[i] + k

    # 5. rebuild left-deep in the new order, attaching conds at the first
    # node where all their columns are bound
    pending_eq = [(_remap_expr(l, mapping), _remap_expr(r, mapping)) for l, r in eq_conds]
    pending_other = [_remap_expr(c, mapping) for c in other_conds]
    acc = leaves[order[0]][0]
    width = leaves[order[0]][2]
    for i in order[1:]:
        leaf, _, w = leaves[i]
        width += w
        take_eq, take_other = [], []
        rest_eq = []
        for l, r in pending_eq:
            lc, rc = _cols_of(l), _cols_of(r)
            # column-less sides (ON 1=1) bind immediately
            if max(lc | rc, default=-1) < width:
                lw = width - w
                if lc and rc and max(lc) < lw and min(rc) >= lw:
                    take_eq.append((l, r))
                elif lc and rc and max(rc) < lw and min(lc) >= lw:
                    take_eq.append((r, l))
                else:  # both sides inside one child / constant → filter
                    take_other.append(make_func("eq", l, r))
            else:
                rest_eq.append((l, r))
        pending_eq = rest_eq
        rest_other = []
        for c in pending_other:
            if max(_cols_of(c), default=-1) < width:
                take_other.append(c)
            else:
                rest_other.append(c)
        pending_other = rest_other
        cols = list(acc.out_cols) + list(leaf.out_cols)
        acc = Join(acc, leaf, "inner" if take_eq or take_other else "cross", take_eq, take_other, cols)

    # 6. restore the original column order for the parent
    exprs = [
        ECol(mapping[i], root.out_cols[i].ft, root.out_cols[i].name) for i in range(total)
    ]
    return Projection(acc, exprs, list(root.out_cols))


# --------------------------------------------------------------- predicates


def _shift_expr(e: Expression, delta: int) -> Expression:
    if isinstance(e, ECol):
        return ECol(e.idx + delta, e.ret_type, e.name)
    if isinstance(e, ScalarFunc):
        return ScalarFunc(e.sig, [_shift_expr(a, delta) for a in e.args], e.ret_type)
    return e


def _cols_of(e: Expression) -> set:
    s: set = set()
    e.collect_columns(s)
    return s


def _subst_proj(e: Expression, proj_exprs) -> Expression | None:
    """Rewrite an expr over a Projection's output into one over its input
    (substitute projected expressions). None if not substitutable."""
    if isinstance(e, ECol):
        return proj_exprs[e.idx]
    if isinstance(e, ScalarFunc):
        args = [_subst_proj(a, proj_exprs) for a in e.args]
        if any(a is None for a in args):
            return None
        return ScalarFunc(e.sig, args, e.ret_type)
    if isinstance(e, Constant):
        return e
    return None


def push_down_predicates(plan: LogicalPlan, conds: list[Expression] | None = None) -> LogicalPlan:
    conds = conds or []
    if isinstance(plan, Selection):
        child = push_down_predicates(plan.children[0], conds + plan.conds)
        return child  # all conds either pushed or re-materialized below

    if isinstance(plan, DataSource):
        pushable = [c for c in conds if c.pushable()]
        rest = [c for c in conds if not c.pushable()]
        plan.pushed_conds.extend(pushable)
        if rest:
            return Selection(plan, rest)
        return plan

    if isinstance(plan, Projection):
        down, keep = [], []
        for c in conds:
            s = _subst_proj(c, plan.exprs)
            if s is not None:
                down.append(s)
            else:
                keep.append(c)
        plan.children[0] = push_down_predicates(plan.children[0], down)
        if keep:
            return Selection(plan, keep)
        return plan

    if isinstance(plan, Join):
        nl = len(plan.children[0].out_cols)
        left_conds, right_conds, keep = [], [], []
        for c in conds:
            cols = _cols_of(c)
            if cols and max(cols) < nl and plan.kind in ("inner", "left", "semi", "anti"):
                left_conds.append(c)
            elif cols and min(cols) >= nl and plan.kind in ("inner", "right"):
                right_conds.append(_shift_expr(c, -nl))
            else:
                keep.append(c)
        # inner joins: other_conds referencing one side sink too
        if plan.kind == "inner":
            still_other = []
            for c in plan.other_conds:
                cols = _cols_of(c)
                if cols and max(cols) < nl:
                    left_conds.append(c)
                elif cols and min(cols) >= nl:
                    right_conds.append(_shift_expr(c, -nl))
                else:
                    still_other.append(c)
            plan.other_conds = still_other
        plan.children[0] = push_down_predicates(plan.children[0], left_conds)
        plan.children[1] = push_down_predicates(plan.children[1], right_conds)
        if keep:
            return Selection(plan, keep)
        return plan

    if isinstance(plan, (Aggregation, Sort, Limit, SetOp, Dual)):
        # conditions do not push through these (agg: having semantics differ;
        # limit/sort: row-count changing) — recurse children without conds
        plan.children = [push_down_predicates(c) for c in plan.children]
        if conds:
            return Selection(plan, conds)
        return plan

    plan.children = [push_down_predicates(c) for c in plan.children]
    if conds:
        return Selection(plan, conds)
    return plan


# ------------------------------------------------------- access path choice


def _analyze_usage(node: LogicalPlan, uses: dict):
    """Map each node's output columns back to (DataSource, visible-pos) and
    record which DataSource columns any expression reads. Returns the
    colmap for `node`'s output schema (None for derived columns)."""
    from ..expr.expression import Column as EC

    if isinstance(node, DataSource):
        u = uses.setdefault(id(node), set())
        for c in node.pushed_conds:
            u |= _cols_of(c)
        return [(node, i) for i in range(len(node.out_cols))]
    if isinstance(node, Dual):
        return [None] * len(node.out_cols)

    maps = [_analyze_usage(c, uses) for c in node.children]

    def mark(e: Expression, colmap):
        for i in _cols_of(e):
            m = colmap[i] if 0 <= i < len(colmap) else None
            if m is not None:
                uses[id(m[0])].add(m[1])

    if isinstance(node, Selection):
        for c in node.conds:
            mark(c, maps[0])
        return maps[0]
    if isinstance(node, Projection):
        for e in node.exprs:
            mark(e, maps[0])
        return [
            maps[0][e.idx] if isinstance(e, EC) and 0 <= e.idx < len(maps[0]) else None
            for e in node.exprs
        ]
    if isinstance(node, Aggregation):
        for e in node.group_by:
            mark(e, maps[0])
        for a in node.aggs:
            for arg in a.args:
                mark(arg, maps[0])
        out = [
            maps[0][e.idx] if isinstance(e, EC) and 0 <= e.idx < len(maps[0]) else None
            for e in node.group_by
        ]
        out += [None] * (len(node.out_cols) - len(out))
        return out
    if isinstance(node, Join):
        # eq_conds exprs reference the CONCATENATED schema (the executor
        # shifts right keys child-local at build time) — mark against cm
        cm = maps[0] + maps[1]
        for le, re_ in node.eq_conds:
            mark(le, cm)
            mark(re_, cm)
        for c in node.other_conds:
            mark(c, cm)
        if getattr(node, "na_key", None) is not None:
            mark(node.na_key[0], maps[0])
            mark(node.na_key[1], cm)
        if node.kind in ("semi", "anti"):
            return maps[0]  # output schema is the left side only
        return cm
    if isinstance(node, Window):
        for e in node.part_by:
            mark(e, maps[0])
        for e, _ in node.order_by:
            mark(e, maps[0])
        for f in node.funcs:
            for a in f.args:
                mark(a, maps[0])
        return maps[0] + [None] * len(node.funcs)
    if isinstance(node, Sort):
        for e, _ in node.by:
            mark(e, maps[0])
        return maps[0]
    if isinstance(node, Limit):
        return maps[0]
    if isinstance(node, SetOp):
        # outputs are merged across children: conservatively mark all
        for m in maps:
            for entry in m:
                if entry is not None:
                    uses[id(entry[0])].add(entry[1])
        return [None] * len(node.out_cols)
    # unknown node: conservative — everything below counts as used
    for m in maps:
        for entry in m:
            if entry is not None:
                uses[id(entry[0])].add(entry[1])
    return [None] * len(node.out_cols)


def choose_access_paths(root: LogicalPlan, stats=None, variables=None) -> None:
    """Pick per-DataSource access paths: PointGet / table handle ranges /
    covering IndexReader / IndexLookUp double read (ref: planner/core
    find_best_task.go skyline+cost pruning; here a deterministic heuristic
    until the statistics CBO lands)."""
    uses: dict = {}
    root_map = _analyze_usage(root, uses)
    for entry in root_map:
        if entry is not None:
            uses[id(entry[0])].add(entry[1])

    def walk(n: LogicalPlan):
        if isinstance(n, DataSource):
            _choose_for_ds(n, uses.get(id(n), set()), stats, variables)
        for c in n.children:
            walk(c)

    walk(root)


def _prune_partitions(table, conds, vis_by_off):
    """Partitions that can match the pushed conds' constraint on the
    partition column, or None = all (ref: partition_prune.go, simplified
    to eq/IN + one interval)."""
    from . import ranger

    part = table.partition
    pcol = table.col_by_name(part.col)
    pvis = vis_by_off.get(pcol.offset)
    if pvis is None or not conds:
        return None
    acc = ranger.collect_col_access(conds, {pvis: pcol.ft}).get(pvis)
    if acc is None:
        return None
    if acc.eq_seen:
        return part.prune(eq_values=[None if d.is_null else d.to_int() for d in acc.eq])
    lo = hi = None
    if acc.lo is not None:
        lo = acc.lo[0].to_int() + (0 if acc.lo[1] else 1)
    if acc.hi is not None:
        hi = acc.hi[0].to_int() - (0 if acc.hi[1] else 1)
    if lo is None and hi is None:
        return None
    return part.prune(lo=lo, hi=hi)


def _choose_for_ds(ds: DataSource, used: set, stats=None, variables=None) -> None:
    from . import ranger

    table = ds.table
    visible = table.visible_columns()
    vis_by_off = {c.offset: i for i, c in enumerate(visible)}
    ds.path = "table"
    ds.index = None
    ds.key_ranges = None
    ds.point_handles = None
    conds = ds.pushed_conds
    # prepared-plan-cache rebind info: the pre-drop conjunct list
    # (which references the parameter-slot Constants) and the conds the
    # chosen path consumed — rebind_cached_ranges re-derives the
    # value-dependent access info from these after a slot rebind
    ds._rebind_conds = list(conds)
    ds._rebind_consumed = []
    tstats = stats.get(table.id) if stats is not None else None

    if table.partition is not None:
        # Partitioned table: table-scan path over (pruned) partitions.
        # Index/point paths stay off in v1 — indexes are partition-local
        # and handles don't identify a partition. Conds are NOT dropped:
        # pruning bounds which partitions are read, the filter still runs.
        ds.pruned_parts = _prune_partitions(table, conds, vis_by_off)
        return

    # 1. clustered pk → point handles / record ranges
    pk_vis = None
    if table.pk_is_handle:
        hc = table.handle_col()
        if hc is not None and hc.offset in vis_by_off:
            pk_vis = vis_by_off[hc.offset]
    # detection shared with the DML point path (session._scan_matching_rows)
    ha = ranger.detach_pk_handle_access(table, conds)
    if ha is not None and ha.point_handles is not None:
        ds.path = "point"
        ds.point_handles = ha.point_handles
        ds._rebind_consumed = list(ha.access_conds)
        _drop_conds(ds, ha.access_conds)
        return

    # 2. secondary indexes — gather candidates (USE_INDEX restricts,
    # IGNORE_INDEX excludes — ref: planner/core hint handling)
    use_hint = getattr(ds, "hint_use_index", None)
    ignore_hint = getattr(ds, "hint_ignore_index", None) or ()
    candidates = []  # (idx, ia, col_vis, covering)
    for idx in table.indexes:
        if idx.state != "public" or (table.pk_is_handle and idx.primary):
            continue
        lname = idx.name.lower()
        if use_hint is not None and lname not in use_hint:
            continue
        if lname in ignore_hint:
            continue
        col_vis, col_fts = [], []
        ok = True
        for off in idx.col_offsets:
            if off not in vis_by_off:
                ok = False
                break
            col_vis.append(vis_by_off[off])
            col_fts.append(table.columns[off].ft)
        if not ok:
            continue
        ia = ranger.detach_index_conditions(conds, table.id, idx.id, col_vis, col_fts)
        if ia is None:
            continue
        covered = set(col_vis)
        if pk_vis is not None:
            covered.add(pk_vis)
        remaining = [c for c in conds if not any(c is a for a in ia.access_conds)]
        need = set(used)
        for c in remaining:
            need |= _cols_of(c)
        candidates.append((idx, ia, col_vis, need <= covered))

    chosen = None
    if tstats is not None and tstats.row_count > 0 and candidates:
        # cost-based: est rows through the access conds vs full scan;
        # a double read pays a per-row lookup penalty (ref: find_best_task
        # cost model, coefficients simplified)
        from ..statistics.selectivity import estimate_conds

        total = float(tstats.row_count)
        best_cost = total  # full table scan
        for idx, ia, col_vis, covering in candidates:
            est = estimate_conds(tstats, ia.access_conds, visible) * total
            if not ia.ranges:
                est = 0.0
            cost = est * (1.1 if covering else 3.0)
            if cost < best_cost:
                best_cost = cost
                chosen = (idx, ia, covering)
    elif candidates:
        # no stats: deterministic heuristic — eq-prefix beats range-only;
        # range-only allowed only when covering (presumed unselective)
        best_score = 0
        for idx, ia, col_vis, covering in candidates:
            score = ia.eq_count * 2 + (1 if ia.has_range else 0)
            if idx.unique and ia.eq_count == len(idx.col_offsets):
                score += 100
            if ia.eq_count == 0 and not covering:
                continue
            if score > best_score:
                best_score = score
                chosen = (idx, ia, covering)

    if chosen is not None:
        idx, ia, covering = chosen
        ds.index = idx
        ds.key_ranges = ia.ranges
        ds.path = "index" if covering else "index_lookup"
        ds._rebind_consumed = list(ia.access_conds)
        _drop_conds(ds, ia.access_conds)
        return

    # 3. pk record ranges
    if ha is not None and ha.ranges is not None:
        ds.path = "table"
        ds.key_ranges = ha.ranges
        ds._rebind_consumed = list(ha.access_conds)
        _drop_conds(ds, ha.access_conds)
        return

    # 4. index merge: a top-level OR whose every disjunct is sargable on
    # some index (or is a pk point set) becomes a union of index reads +
    # one double read; the OR stays as a filter so each branch may
    # over-approximate its disjunct (ref: planner/core
    # indexmerge_path.go generateIndexMergeOrPaths, union type only).
    if (variables or {}).get("tidb_enable_index_merge", "ON") == "ON":
        _try_index_merge(ds, conds, table, visible, vis_by_off, pk_vis, tstats)


def _split_dnf(e) -> list:
    from ..expr.expression import ScalarFunc

    if isinstance(e, ScalarFunc) and e.sig.name == "or":
        return _split_dnf(e.args[0]) + _split_dnf(e.args[1])
    return [e]


def _split_cnf(e) -> list:
    from ..expr.expression import ScalarFunc

    if isinstance(e, ScalarFunc) and e.sig.name == "and":
        return _split_cnf(e.args[0]) + _split_cnf(e.args[1])
    return [e]


def _try_index_merge(ds, conds, table, visible, vis_by_off, pk_vis, tstats) -> None:
    from . import ranger

    or_cond = None
    for c in conds:
        if _split_dnf(c) != [c]:
            or_cond = c
            break
    if or_cond is None:
        return
    disjuncts = _split_dnf(or_cond)
    use_hint = getattr(ds, "hint_use_index", None)
    ignore_hint = getattr(ds, "hint_ignore_index", None) or ()
    indexes = []
    for idx in table.indexes:
        if idx.state != "public" or (table.pk_is_handle and idx.primary):
            continue
        lname = idx.name.lower()
        if use_hint is not None and lname not in use_hint:
            continue
        if lname in ignore_hint:
            continue
        col_vis, col_fts, ok = [], [], True
        for off in idx.col_offsets:
            if off not in vis_by_off:
                ok = False
                break
            col_vis.append(vis_by_off[off])
            col_fts.append(table.columns[off].ft)
        if ok:
            indexes.append((idx, col_vis, col_fts))

    branches = []  # ("index", idx, ranges) | ("points", handles)
    est_rows = 0.0
    for d in disjuncts:
        cnf = _split_cnf(d)
        best = None
        if pk_vis is not None:
            ha = ranger.detach_handle_conditions(cnf, table.id, pk_vis)
            if ha is not None and ha.point_handles is not None:
                best = ("points", ha.point_handles)
        if best is None:
            best_eq = -1
            for idx, col_vis, col_fts in indexes:
                ia = ranger.detach_index_conditions(cnf, table.id, idx.id, col_vis, col_fts)
                if ia is None or ia.eq_count == 0 and not ia.has_range:
                    continue
                if ia.eq_count > best_eq:
                    best_eq = ia.eq_count
                    best = ("index", idx, ia.ranges)
        if best is None:
            return  # one unsargable disjunct sinks the whole union
        if tstats is not None and tstats.row_count > 0:
            from ..statistics.selectivity import estimate_conds

            est_rows += estimate_conds(tstats, cnf, visible) * float(tstats.row_count)
        branches.append(best)
    if tstats is not None and tstats.row_count > 0 and est_rows > 0.5 * tstats.row_count:
        return  # union would read most of the table: plain scan is cheaper
    ds.path = "index_merge"
    ds.merge_branches = branches


def _drop_conds(ds: DataSource, consumed: list) -> None:
    ds.pushed_conds = [c for c in ds.pushed_conds if not any(c is a for a in consumed)]


# --------------------------- prepared-plan cache rebind ------------
#
# The statement-id plan cache (session._prepared_plan_for) reuses a built
# physical plan across COM_STMT_EXECUTE repeats by mutating the parameter
# slot Constants in place. Everything the executors evaluate at RUN time
# (filters, projections, join keys) follows the new values automatically;
# what does NOT is the access info `_choose_for_ds` derived from the OLD
# values at optimize time — point handles, key ranges, partition pruning.
# `rebind_cached_ranges` re-derives exactly those from the saved pre-drop
# conjuncts (ref: planner/core/plan_cache.go RebuildPlan4CachedPlan /
# rebuildRange). A rebind that would change the plan SHAPE — a different
# set of conds became (or stopped being) sargable, e.g. `pk = 1.5` where
# the first execution bound an exact int — returns False: the baked
# access/filter split no longer matches and the caller must replan.


def plan_rebindable(root: LogicalPlan) -> bool:
    """Is every DataSource in this plan a shape rebind_cached_ranges can
    re-derive? Index-merge unions (per-branch detachments) and sources
    that never went through choose_access_paths are not."""
    ok = True

    def walk(n: LogicalPlan) -> None:
        nonlocal ok
        if not ok:
            return
        if isinstance(n, DataSource):
            if getattr(n, "_rebind_conds", None) is None:
                ok = False
            elif getattr(n, "path", "table") not in (
                    "point", "table", "index", "index_lookup"):
                ok = False
        for c in n.children:
            walk(c)

    walk(root)
    return ok


def rebind_cached_ranges(root: LogicalPlan) -> bool:
    """Recompute the value-derived access info of a cached prepared plan
    after its parameter slots were rebound. True = plan is ready to
    execute; False = the new values change the plan shape, replan."""
    ok = True

    def walk(n: LogicalPlan) -> None:
        nonlocal ok
        if not ok:
            return
        if isinstance(n, DataSource):
            ok = _rebind_ds(n)
        for c in n.children:
            walk(c)

    walk(root)
    return ok


def _same_conds(a: list, b: list) -> bool:
    """Identity-set equality: the rebind consumed exactly the conds the
    original optimization consumed (so the filters left in the plan
    still cover everything the ranges don't)."""
    return len(a) == len(b) and all(any(x is y for y in b) for x in a)


def _rebind_ds(ds: DataSource) -> bool:
    from . import ranger

    conds = getattr(ds, "_rebind_conds", None)
    if conds is None:
        return False
    table = ds.table
    if table.partition is not None:
        # partitioned sources bake only the pruning verdict; conds were
        # never dropped, so re-pruning is the whole rebind
        visible = table.visible_columns()
        vis_by_off = {c.offset: i for i, c in enumerate(visible)}
        ds.pruned_parts = _prune_partitions(table, conds, vis_by_off)
        return True
    saved = getattr(ds, "_rebind_consumed", [])
    path = getattr(ds, "path", "table")
    if path == "point":
        ha = ranger.detach_pk_handle_access(table, conds)
        if ha is None or ha.point_handles is None or not _same_conds(ha.access_conds, saved):
            return False
        ds.point_handles = ha.point_handles
        return True
    if path in ("index", "index_lookup"):
        visible = table.visible_columns()
        vis_by_off = {c.offset: i for i, c in enumerate(visible)}
        col_vis, col_fts = [], []
        for off in ds.index.col_offsets:
            if off not in vis_by_off:
                return False
            col_vis.append(vis_by_off[off])
            col_fts.append(table.columns[off].ft)
        ia = ranger.detach_index_conditions(conds, table.id, ds.index.id, col_vis, col_fts)
        if ia is None or not _same_conds(ia.access_conds, saved):
            return False
        ds.key_ranges = ia.ranges
        return True
    if path == "table":
        if ds.key_ranges is None:
            # full scan + filters: nothing value-derived was baked, as
            # long as the original consumed nothing either
            return not saved
        ha = ranger.detach_pk_handle_access(table, conds)
        if ha is None or ha.ranges is None or not _same_conds(ha.access_conds, saved):
            return False
        ds.key_ranges = ha.ranges
        return True
    return False  # index_merge & anything new: replan
