"""AST → logical plan with name resolution (copy of tidb_tpu/planner/builder.py; ref: planner/core/
logical_plan_builder.go + preprocess.go, compact redesign).

Aggregate extraction follows the reference's approach: walk select/having/
order expressions, lift aggregate calls into an Aggregation node, and
rewrite the outer expressions to reference aggregation output columns.
Non-aggregated bare columns under GROUP BY become first_row aggregates
(MySQL's permissive mode, like the reference defaults).
"""

from __future__ import annotations

from ..errors import AmbiguousColumn, TiDBError, UnknownColumn
from ..expr.aggregation import AGG_FUNCS, WINDOW_FUNCS, AggDesc, Frame, WinDesc, agg_ret_type
from ..expr.builtins import CAST_SIG
from ..expr.expression import Column as ECol, Constant, Expression, ScalarFunc, make_func
from ..mysqltypes.datum import Datum
from ..mysqltypes.field_type import FieldType, TypeCode, ft_double, ft_longlong, ft_varchar, parse_type_name
from ..mysqltypes.mydecimal import Dec
from ..parser import ast
from .plans import (
    Aggregation,
    CTERef,
    CTEStorage,
    DataSource,
    Dual,
    Join,
    Limit,
    LogicalPlan,
    PlanCol,
    Projection,
    RecursiveCTE,
    Selection,
    SetOp,
    Sort,
    Window,
)


def lit_to_constant(l: ast.Lit) -> Constant:
    v = l.value
    if l.kind == "null":
        return Constant(Datum.null(), FieldType(TypeCode.Null))
    if l.kind == "int":
        # literals above 2^63-1 are BIGINT UNSIGNED (MySQL literal typing);
        # a signed ft would silently wrap the int64 lane
        return Constant(Datum.i(v), ft_longlong(unsigned=v > 0x7FFFFFFFFFFFFFFF))
    if l.kind == "bool":
        return Constant(Datum.i(1 if v else 0), ft_longlong())
    if l.kind == "dec":
        return Constant(Datum.d(v), FieldType(TypeCode.NewDecimal, flen=30, decimal=v.scale))
    if l.kind == "float":
        return Constant(Datum.f(v), ft_double())
    if l.kind == "hex":
        return Constant(Datum.b(v), ft_varchar(len(v)))
    return Constant(Datum.s(v), ft_varchar(max(len(v), 1)))


_CMP_FUNCS = {"eq", "ne", "lt", "le", "gt", "ge", "nulleq", "in"}


def _refine_cmp_constants(fname: str, args: list[Expression]) -> list[Expression]:
    """Convert string constants compared against typed columns into the
    column's domain at plan time (ref: expression/builtin_compare.go
    RefineComparedConstant) — exact datetime/decimal compares, and the
    device engine sees only typed constants."""
    if fname not in _CMP_FUNCS or not args:
        return args
    col = next((a for a in args if isinstance(a, ECol)), None)
    if col is None:
        return args
    out = []
    for a in args:
        if isinstance(a, Constant) and a.value.kind == 5 and not a.value.is_null:  # K_STR
            ft = col.ret_type
            if ft.is_time():
                from ..mysqltypes.coretime import parse_datetime

                p = parse_datetime(a.value.val)
                if p is not None:
                    a = Constant(Datum.t(p), ft.clone())
            elif ft.is_decimal() or ft.is_int():
                d = a.value.to_dec()
                a = Constant(Datum.d(d), FieldType(TypeCode.NewDecimal, flen=30, decimal=d.scale))
            elif ft.is_float():
                a = Constant(Datum.f(a.value.to_float()), ft_double())
        out.append(a)
    return out


class NameScope:
    """Resolution scope over a plan's output columns."""

    def __init__(self, cols: list[PlanCol]):
        self.cols = cols

    def resolve(self, name: ast.Name) -> int:
        col = name.column.lower()
        tbl = (name.table or "").lower()
        hits = [
            i
            for i, c in enumerate(self.cols)
            if c.name.lower() == col and (not tbl or c.table_alias.lower() == tbl)
        ]
        if not hits:
            raise UnknownColumn(f"unknown column {'.'.join(name.parts)!r}")
        if len(hits) > 1:
            raise AmbiguousColumn(f"column {col!r} is ambiguous")
        return hits[0]


class PlanBuilder:
    """Builds logical plans; needs a catalog view + subquery executor hook."""

    def _now_epoch(self) -> float:
        from ..expr.sessioninfo import now_epoch

        return now_epoch(self.context_info.get("vars") or {})

    def _sysvar_constant(self, raw: str) -> Expression:
        """SELECT @@x / @@global.x / @@session.x → typed constant from the
        session registry (ref: expression/util.go GetSessionOrGlobalSystemVar;
        connectors issue these on connect, e.g. @@version_comment)."""
        from ..session.vars import SYSVARS

        name = raw
        want_global = False
        for pre in ("global.", "session.", "local."):
            if name.startswith(pre):
                name = name[len(pre):]
                want_global = pre == "global."
                break
        sv = SYSVARS.get(name)
        if sv is None:
            raise TiDBError(f"Unknown system variable '{name}'")
        if want_global:
            # @@global.x reads the STORE value, not this session's override
            reader = self.context_info.get("sysvar_read_global")
            val = reader(name) if reader is not None else sv.default
        else:
            reader = self.context_info.get("sysvar_read")
            if reader is not None:
                val = reader(name)
            else:
                val = self.context_info.get("vars", {}).get(name, sv.default)
        # live session state must not be baked into a cached plan
        self.used_eager_subquery = True
        if val is None:
            return Constant(Datum.null(), FieldType(TypeCode.Null))
        if sv.kind == "int":
            try:
                return Constant(Datum.i(int(val)), ft_longlong())
            except (TypeError, ValueError):
                pass
        if sv.kind == "float":
            try:
                return Constant(Datum.f(float(val)), ft_double())
            except (TypeError, ValueError):
                pass
        s = str(val)
        return Constant(Datum.s(s), ft_varchar(max(len(s), 1)))

    def _resolve_name(self, node: ast.Name, scope: NameScope) -> Expression:
        """Resolve a column name; names unknown in the local scope fall
        back to the enclosing query's scope as correlated references
        (ref: expression.CorrelatedColumn, rule_decorrelate.go)."""
        if len(node.parts) == 1 and node.parts[0].startswith("@@"):
            return self._sysvar_constant(node.parts[0][2:])
        try:
            idx = scope.resolve(node)
        except UnknownColumn:
            for outer in reversed(self._outer_scopes):
                try:
                    oidx = outer.resolve(node)
                except UnknownColumn:
                    continue
                c = outer.cols[oidx]
                return _CorrRef(oidx, c.ft, c.name)
            raise
        c = scope.cols[idx]
        return ECol(idx, c.ft, c.name)

    def __init__(self, infoschema, current_db: str, run_subquery=None, params=None, memtable_rows=None, context_info=None, hints=None, expose_rowid=None, seq_hook=None):
        self.is_ = infoschema
        self.db = current_db
        self.seq_hook = seq_hook  # session.sequence_op for NEXTVAL/LASTVAL/SETVAL
        # aliases whose hidden `_tidb_rowid` must be addressable (multi-
        # table DML projects per-target handles through the join)
        self.expose_rowid = expose_rowid or set()
        self.run_subquery = run_subquery  # callable(Select ast) -> list[Datum rows]
        self.params = params  # EXECUTE-bound Constants for '?' placeholders
        self.memtable_rows = memtable_rows  # callable(name) -> rows (info schema)
        self.context_info = context_info or {}  # user/conn info for info funcs
        self.hints = hints or []  # [(NAME, [args])] — statement-wide
        # set when a subquery was evaluated eagerly at plan time: such a
        # plan bakes in data and must not enter the plan cache
        self.used_eager_subquery = False
        # correlated-subquery build state (rule_decorrelate.go analog):
        # while building a subquery, unknown names resolve against the
        # enclosing scopes as _CorrRef placeholders
        self._outer_scopes: list[NameScope] = []
        # WITH-clause tables visible to the current (sub)query, innermost
        # last; entries: name → CTEDef | ("recursive", CTERef factory)
        self._cte_frames: list[dict] = []

    # ------------------------------------------------------------------ FROM

    # ------------------------------------------------------------------ CTE

    MAX_CTE_DEPTH = 32

    def _cte_frame(self, wf: ast.WithClause) -> dict:
        frame = {}
        for cte in wf.ctes:
            if cte.name.lower() in frame:
                raise TiDBError(f"Not unique table/alias: {cte.name!r}")
            kind = "recursive" if (wf.recursive and _refs_table(cte.select, cte.name)) else "plain"
            frame[cte.name.lower()] = (kind, cte)
        return frame

    def _lookup_cte(self, name: str):
        key = name.lower()
        # recursive-branch binding shadows everything
        bind = getattr(self, "_rec_bindings", {}).get(key)
        if bind is not None:
            return ("ref", bind)
        for frame in reversed(self._cte_frames):
            if key in frame:
                return frame[key]
        return None

    def _build_cte(self, tn: ast.TableName, entry) -> LogicalPlan:
        kind, payload = entry
        alias = tn.alias or tn.name
        if kind == "ref":
            storage, cols = payload
            return CTERef(tn.name, storage, [PlanCol(c.name, c.ft, alias) for c in cols])
        cte: ast.CTEDef = payload
        if kind == "building":
            raise TiDBError(f"CTE {cte.name!r} references itself but is not declared RECURSIVE")
        if kind == "plain":
            # inline the CTE body (materialization is an executor concern);
            # mark it 'building' so non-recursive self-reference errors
            for frame in reversed(self._cte_frames):
                if frame.get(cte.name.lower()) is entry:
                    frame[cte.name.lower()] = ("building", cte)
                    break
            try:
                sub = self.build_select(cte.select)
            finally:
                for frame in reversed(self._cte_frames):
                    if frame.get(cte.name.lower()) == ("building", cte):
                        frame[cte.name.lower()] = entry
                        break
            return self._alias_barrier(sub, cte.cols, alias)
        # recursive CTE: split seed vs recursive branches
        sel = cte.select
        if not isinstance(sel, ast.SetOpSelect) or len(sel.selects) != 2:
            raise TiDBError("recursive CTE must be 'seed UNION [ALL] recursive' with two branches")
        seed_ast, rec_ast = sel.selects
        if _refs_table(seed_ast, cte.name) or not _refs_table(rec_ast, cte.name):
            raise TiDBError("recursive CTE needs a non-recursive seed branch first")
        distinct = sel.ops[0] == "union"
        seed_plan = self.build_select(seed_ast)
        names = cte.cols or [c.name for c in seed_plan.out_cols]
        if len(names) != len(seed_plan.out_cols):
            raise TiDBError("CTE column list length mismatch")
        cols = [PlanCol(nm, c.ft, cte.name) for nm, c in zip(names, seed_plan.out_cols)]
        storage = CTEStorage()
        if not hasattr(self, "_rec_bindings"):
            self._rec_bindings = {}
        if cte.name.lower() in self._rec_bindings:
            raise TiDBError("nested recursion in recursive CTE is not supported")
        self._rec_bindings[cte.name.lower()] = (storage, cols)
        try:
            rec_plan = self.build_select(rec_ast)
        finally:
            del self._rec_bindings[cte.name.lower()]
        if len(rec_plan.out_cols) != len(cols):
            raise TiDBError(
                f"recursive branch of CTE {cte.name!r} returns {len(rec_plan.out_cols)} "
                f"columns, expected {len(cols)}"
            )
        node = RecursiveCTE(cte.name, seed_plan, rec_plan, storage, distinct,
                            [PlanCol(c.name, c.ft, alias) for c in cols])
        return node

    @staticmethod
    def _alias_barrier(sub: LogicalPlan, declared: list, alias: str, what: str = "CTE") -> LogicalPlan:
        """Re-alias a subplan through a Projection: explicit column list
        (CTE/view) or the subplan's own names (shared by CTEs, derived
        tables, and views)."""
        names = declared or [c.name for c in sub.out_cols]
        if len(names) != len(sub.out_cols):
            raise TiDBError(f"{what} column list length mismatch")
        cols = [PlanCol(nm, c.ft, alias) for nm, c in zip(names, sub.out_cols)]
        exprs = [ECol(i, c.ft, c.name) for i, c in enumerate(sub.out_cols)]
        return Projection(sub, exprs, cols)

    def build_table(self, tn: ast.TableName):
        if tn.db is None:
            ent = self._lookup_cte(tn.name)
            if ent is not None:
                return self._build_cte(tn, ent)
        db = (tn.db or self.db).lower()
        if db == "information_schema" and self.memtable_rows is not None:
            # the memtable schemas (catalog/memtables.py SCHEMAS) come with
            # the rest of the store's catalog (ROADMAP Queue 1, item 4.1)
            from ..errors import NotPortedError

            raise NotPortedError("catalog/memtables.py SCHEMAS", f"information_schema.{tn.name}")
        db = tn.db or self.db
        key = ((tn.db or self.db).lower(), tn.name.lower())
        vdef = self.is_.views.get(key)
        shadow = self.is_.table_or_none(*key)
        # a session temp table shadows a same-named view (temp wins over
        # everything, matching the temp-shadows-permanent rule)
        if vdef is not None and not getattr(shadow, "temporary", False):
            return self._build_view(tn, vdef)
        info = self.is_.table(db, tn.name)
        cols = [
            PlanCol(c.name, c.ft, tn.alias or tn.name, c.offset)
            for c in info.columns
            if not c.hidden
        ]
        if (tn.alias or tn.name).lower() in self.expose_rowid:
            rid = next((c for c in info.columns if c.hidden and c.name == "_tidb_rowid"), None)
            if rid is not None:
                cols.append(PlanCol(rid.name, rid.ft, tn.alias or tn.name, rid.offset))
        ds = DataSource(info, tn.alias or tn.name, cols)
        # an aliased table is addressable ONLY by its alias (TiDB rule)
        name = (tn.alias or tn.name).lower()
        known = {ix.name.lower() for ix in info.indexes}
        for h, args in self.hints:
            if not args or args[0] != name:
                continue
            if h in ("USE_INDEX", "FORCE_INDEX", "IGNORE_INDEX"):
                wanted = {a.lower() for a in args[1:]}
                missing = wanted - known
                if missing:
                    raise TiDBError(
                        f"Key {sorted(missing)[0]!r} doesn't exist in table {name!r}"
                    )
                attr = "hint_ignore_index" if h == "IGNORE_INDEX" else "hint_use_index"
                cur = getattr(ds, attr, None) or set()
                setattr(ds, attr, cur | wanted)
        return ds

    MAX_VIEW_DEPTH = 16

    def _build_view(self, tn: ast.TableName, vdef: dict) -> LogicalPlan:
        """Expand a view reference: re-plan the stored SELECT against the
        current schema, then re-alias through a Projection barrier (ref:
        planner/core/logical_plan_builder.go BuildDataSourceFromView)."""
        self._view_depth = getattr(self, "_view_depth", 0) + 1
        # a view definition is an INDEPENDENT name scope planned in the
        # view's own database: the caller's db, CTE names, hints, and
        # outer scopes must not leak in
        saved = (self.db, self._cte_frames, self._outer_scopes, self.hints,
                 getattr(self, "_rec_bindings", {}))
        self.db = vdef["db"]
        self._cte_frames = []
        self._outer_scopes = []
        self.hints = []
        self._rec_bindings = {}
        try:
            if self._view_depth > self.MAX_VIEW_DEPTH:
                raise TiDBError(f"view {tn.name!r} nests too deeply (cycle?)")
            from ..parser import parse_one

            sub = self.build_select(parse_one(vdef["sql"]))
            return self._alias_barrier(sub, vdef.get("cols") or [], tn.alias or tn.name, what=f"view {tn.name!r}")
        finally:
            self._view_depth -= 1
            (self.db, self._cte_frames, self._outer_scopes, self.hints,
             self._rec_bindings) = saved

    def build_from(self, node) -> LogicalPlan:
        if node is None:
            return Dual()
        if isinstance(node, ast.TableName):
            return self.build_table(node)
        if isinstance(node, ast.SubqueryTable):
            sub = self.build_select(node.select)
            cols = [PlanCol(c.name, c.ft, node.alias) for c in sub.out_cols]
            # re-alias through a projection barrier
            exprs = [ECol(i, c.ft, c.name) for i, c in enumerate(sub.out_cols)]
            return Projection(sub, exprs, cols)
        if isinstance(node, ast.Join):
            return self.build_join(node)
        raise TiDBError(f"unsupported FROM clause {type(node).__name__}")

    def build_join(self, j: ast.Join) -> LogicalPlan:
        left = self.build_from(j.left)
        right = self.build_from(j.right)
        kind = j.kind
        straight = getattr(j, "straight", False)
        cols = list(left.out_cols) + list(right.out_cols)
        scope = NameScope(cols)
        conds = []
        if j.using:
            for name in j.using:
                li = NameScope(left.out_cols).resolve(ast.Name((name,)))
                ri = NameScope(right.out_cols).resolve(ast.Name((name,)))
                conds.append(
                    make_func(
                        "eq",
                        ECol(li, left.out_cols[li].ft, name),
                        ECol(len(left.out_cols) + ri, right.out_cols[ri].ft, name),
                    )
                )
        elif j.on is not None:
            conds = self.split_cnf(self.to_expr(j.on, scope))
        eq, other = [], []
        nl = len(left.out_cols)
        for c in conds:
            pair = self._as_eq_pair(c, nl)
            if pair is not None:
                eq.append(pair)
            else:
                other.append(c)
        if kind == "cross":
            kind = "inner"
        jn = Join(left, right, kind, eq, other, cols)
        jn.straight = straight
        return jn

    @staticmethod
    def _as_eq_pair(c: Expression, nl: int):
        """eq(col_left, col_right) across the join boundary → key pair."""
        if isinstance(c, ScalarFunc) and c.sig.name == "eq":
            a, b = c.args
            asides = set()
            a.collect_columns(asides)
            bsides = set()
            b.collect_columns(bsides)
            if asides and bsides:
                if max(asides) < nl and min(bsides) >= nl:
                    return (a, b)
                if max(bsides) < nl and min(asides) >= nl:
                    return (b, a)
        return None

    @staticmethod
    def split_cnf(e: Expression) -> list[Expression]:
        if isinstance(e, ScalarFunc) and e.sig.name == "and":
            return PlanBuilder.split_cnf(e.args[0]) + PlanBuilder.split_cnf(e.args[1])
        return [e]

    # ------------------------------------------------------------ expressions

    def to_expr(self, node, scope: NameScope, agg_ctx=None, allow_window=False) -> Expression:
        if isinstance(node, ast.Lit):
            return lit_to_constant(node)
        if isinstance(node, ast.Param):
            if self.params is None or node.index >= len(self.params):
                raise TiDBError("statement has placeholders but no parameters were bound")
            return self.params[node.index]
        if isinstance(node, ast.Name):
            return self._resolve_name(node, scope)
        if isinstance(node, ast.Call):
            lname = node.name.lower()
            if lname in ("charset", "collation", "coercibility") and len(node.args) == 1:
                return self._type_meta_func(lname, self.to_expr(node.args[0], scope, agg_ctx))
            info_c = self._info_func(lname, node)
            if info_c is not None:
                return info_c
            if getattr(node, "over", None) is not None or lname in WINDOW_FUNCS:
                if node.over is None:
                    raise TiDBError(f"window function {lname} requires an OVER clause")
                if agg_ctx is None or not allow_window:
                    raise TiDBError(f"window function {lname} is not allowed here")
                return self._window_expr(node, scope, agg_ctx)
            if lname in AGG_FUNCS:
                if agg_ctx is None:
                    raise TiDBError(f"aggregate {lname} not allowed here")
                return agg_ctx.add_agg(node, scope)
            if lname == "in_subquery":
                return self._in_subquery(node, scope, agg_ctx)
            if lname in ("nextval", "next_value", "lastval", "setval") and self.seq_hook is not None:
                return self._sequence_expr(lname, node, scope, agg_ctx)
            if lname in ("date_add", "date_sub", "adddate", "subdate") and len(node.args) == 2 \
                    and isinstance(node.args[1], ast.Interval):
                iv = node.args[1]
                return make_func(
                    lname,
                    self.to_expr(node.args[0], scope, agg_ctx),
                    self.to_expr(iv.expr, scope, agg_ctx),
                    Constant(Datum.s(iv.unit), ft_varchar(16)),
                )
            if lname in ("plus", "minus") and any(isinstance(a, ast.Interval) for a in node.args):
                # d + INTERVAL n unit  /  INTERVAL n unit + d  /  d - INTERVAL n unit
                iv = next(a for a in node.args if isinstance(a, ast.Interval))
                other = next(a for a in node.args if not isinstance(a, ast.Interval))
                fname = "date_add" if lname == "plus" else "date_sub"
                return make_func(
                    fname,
                    self.to_expr(other, scope, agg_ctx),
                    self.to_expr(iv.expr, scope, agg_ctx),
                    Constant(Datum.s(iv.unit), ft_varchar(16)),
                )
            args = [self.to_expr(a, scope, agg_ctx, allow_window) for a in node.args]
            args = _refine_cmp_constants(lname, args)
            return make_func(lname, *args)
        if isinstance(node, ast.CaseWhen):
            args = []
            for cond, res in node.whens:
                c = self.to_expr(cond, scope, agg_ctx, allow_window)
                if node.operand is not None:
                    c = make_func("eq", self.to_expr(node.operand, scope, agg_ctx, allow_window), c)
                args.append(c)
                args.append(self.to_expr(res, scope, agg_ctx, allow_window))
            if node.else_ is not None:
                args.append(self.to_expr(node.else_, scope, agg_ctx, allow_window))
            return make_func("case", *args)
        if isinstance(node, ast.Cast):
            e = self.to_expr(node.expr, scope, agg_ctx, allow_window)
            ft = parse_type_name(node.type_name, node.type_args, node.unsigned)
            return ScalarFunc(CAST_SIG, [e], ft)
        if isinstance(node, ast.SubqueryExpr):
            return self._scalar_subquery(node)
        if isinstance(node, ast.Star):
            raise TiDBError("* not allowed in this context")
        raise TiDBError(f"unsupported expression {type(node).__name__}")

    def _sequence_expr(self, lname: str, node, scope, agg_ctx):
        """NEXTVAL(seq)/LASTVAL(seq)/SETVAL(seq, n): the first argument is
        a sequence IDENTIFIER, not a column (parser sees a Name)."""
        if not node.args or not isinstance(node.args[0], ast.Name):
            raise TiDBError(f"{lname} requires a sequence name argument")
        sn = node.args[0]
        db = sn.parts[0] if len(sn.parts) >= 2 else self.db
        name = sn.parts[-1]
        op = "nextval" if lname == "next_value" else lname
        arg = None
        if op == "setval":
            if len(node.args) != 2:
                raise TiDBError("SETVAL requires (sequence, value)")
            arg = self.to_expr(node.args[1], scope, agg_ctx)
        elif len(node.args) != 1:
            raise TiDBError(f"{lname} takes exactly one argument")
        self.used_eager_subquery = True  # stateful: keep out of the plan cache
        return _SeqExpr(op, db, name, self.seq_hook, arg)

    def _type_meta_func(self, lname: str, arg: Expression) -> Constant:
        """CHARSET()/COLLATION()/COERCIBILITY() — metadata of the argument
        EXPRESSION, folded at plan time where the expression (not just its
        value) is visible (ref: expression/builtin_info.go)."""
        ft = arg.ret_type
        is_null = isinstance(arg, Constant) and arg.value.is_null
        is_str = ft.is_string() and not is_null
        if lname == "charset":
            v = (getattr(ft, "charset", None) or "utf8mb4") if is_str else "binary"
            return Constant(Datum.s(v), ft_varchar(32))
        if lname == "collation":
            v = (getattr(ft, "collate", None) or "utf8mb4_bin") if is_str else "binary"
            return Constant(Datum.s(v), ft_varchar(32))
        # coercibility (MySQL levels: 2=IMPLICIT column, 4=COERCIBLE
        # literal, 5=NUMERIC, 6=IGNORABLE NULL)
        if is_null:
            c = 6
        elif not ft.is_string():
            c = 5
        elif isinstance(arg, Constant):
            c = 4
        else:
            c = 2
        return Constant(Datum.i(c), ft_longlong())

    def _info_func(self, lname: str, node) -> Constant | None:
        """Session/time information functions evaluated at plan time
        (ref: builtin_info.go, builtin_time.go NOW/CURDATE). Plans that
        embed them are flagged uncacheable."""
        import time as _time

        from ..mysqltypes.coretime import pack_time
        from ..mysqltypes.datum import K_DUR
        from ..mysqltypes.field_type import TypeCode as TC

        if node.args:
            return None
        if lname in ("database", "schema"):
            self.used_eager_subquery = True
            return Constant(Datum.s(self.db), ft_varchar(64))
        if lname == "version":
            return Constant(Datum.s("8.0.11-tidb-tpu"), ft_varchar(64))
        if lname in ("user", "current_user", "session_user"):
            self.used_eager_subquery = True
            u = self.context_info.get("user", "root")
            return Constant(Datum.s(f"{u}@%"), ft_varchar(64))
        if lname == "connection_id":
            self.used_eager_subquery = True
            return Constant(Datum.i(int(self.context_info.get("conn_id", 0))), ft_longlong())
        if lname in ("now", "current_timestamp", "sysdate", "localtime", "localtimestamp"):
            self.used_eager_subquery = True
            t = _time.localtime(self._now_epoch())
            ft = FieldType(TC.Datetime)
            return Constant(Datum.t(pack_time(t.tm_year, t.tm_mon, t.tm_mday, t.tm_hour, t.tm_min, t.tm_sec)), ft)
        if lname in ("curdate", "current_date"):
            self.used_eager_subquery = True
            t = _time.localtime(self._now_epoch())
            return Constant(Datum.t(pack_time(t.tm_year, t.tm_mon, t.tm_mday)), FieldType(TC.Date))
        if lname in ("curtime", "current_time"):
            self.used_eager_subquery = True
            t = _time.localtime(self._now_epoch())
            us = (t.tm_hour * 3600 + t.tm_min * 60 + t.tm_sec) * 1_000_000
            return Constant(Datum(K_DUR, us), FieldType(TC.Duration))
        return None

    def _window_expr(self, node: ast.Call, scope, agg_ctx) -> "_WindowFuncExpr":
        """ast window call → placeholder expression lifted later by
        _build_windows (ref: logical_plan_builder.go buildWindowFunctions)."""
        lname = node.name.lower()
        svars = self.context_info.get("vars") or {}
        if svars.get("tidb_enable_window_function", "ON") != "ON":
            raise TiDBError(
                f"window function {lname} is disabled (tidb_enable_window_function=OFF)"
            )
        if node.distinct:
            raise TiDBError(f"DISTINCT is not supported in window function {lname}")
        args = []
        for a in node.args:
            if isinstance(a, ast.Star):
                continue  # COUNT(*) OVER (...)
            args.append(self.to_expr(a, scope, agg_ctx))
        part = [self.to_expr(p, scope, agg_ctx) for p in node.over.partition_by]
        order = [(self.to_expr(b.expr, scope, agg_ctx), b.desc) for b in node.over.order_by]

        def need(lo, hi):
            if not (lo <= len(args) <= hi):
                raise TiDBError(f"wrong argument count for window function {lname}")

        if lname in ("row_number", "rank", "dense_rank", "cume_dist", "percent_rank"):
            need(0, 0)
            ft = ft_double() if lname in ("cume_dist", "percent_rank") else ft_longlong()
        elif lname == "ntile":
            need(1, 1)
            if not (isinstance(args[0], Constant) and self._const_pos_int(args[0])):
                raise TiDBError("NTILE requires a positive integer constant")
            ft = ft_longlong()
        elif lname in ("lead", "lag"):
            need(1, 3)
            if len(args) >= 2:
                ok = isinstance(args[1], Constant) and not args[1].value.is_null
                try:
                    ok = ok and args[1].value.to_int() >= 0
                except Exception:
                    ok = False
                if not ok:
                    raise TiDBError(f"{lname} offset must be a non-negative integer constant")
            if len(args) == 3:
                a0, d2 = args[0].ret_type, args[2]
                if a0.is_string() != d2.ret_type.is_string():
                    raise TiDBError(f"{lname} default value type is incompatible with the value column")
                if a0.is_decimal() and isinstance(d2, Constant) and not d2.value.is_null:
                    # align the default to the value lane's scaled-int form
                    args[2] = Constant(
                        Datum.d(d2.value.to_dec().rescale(max(a0.decimal, 0))), a0.clone()
                    )
            ft = args[0].ret_type.clone()
        elif lname == "nth_value":
            need(2, 2)
            if not (isinstance(args[1], Constant) and self._const_pos_int(args[1])):
                raise TiDBError("NTH_VALUE position must be a positive integer constant")
            ft = args[0].ret_type.clone()
        elif lname in ("first_value", "last_value"):
            need(1, 1)
            ft = args[0].ret_type.clone()
        elif lname == "count":
            need(0, 1)
            ft = ft_longlong()
        elif lname in ("sum", "avg"):
            need(1, 1)
            ft = agg_ret_type(lname, args[0].ret_type)
        elif lname in ("min", "max"):
            need(1, 1)
            ft = args[0].ret_type.clone()
        else:
            raise TiDBError(f"{lname} cannot be used as a window function")
        frame = None
        if node.over.frame is not None and lname not in self._FRAME_IGNORING:
            frame = self._build_frame(node.over.frame, order, scope, agg_ctx)
        return _WindowFuncExpr(WinDesc(lname, args, part, order, ft, frame))

    _BOUND_RANK = {"up": 0, "pre": 1, "cur": 2, "fol": 3, "uf": 4}

    def _build_frame(self, fr, order, scope, agg_ctx) -> Frame:
        """ast.FrameSpec → validated normalized Frame (ref:
        planner/core/logical_plan_builder.go buildWindowFunctionFrame +
        checkFrameBound). RANGE offsets land pre-scaled for decimal keys."""
        if fr.start.kind == "uf":
            raise TiDBError("frame start cannot be UNBOUNDED FOLLOWING")
        if fr.end.kind == "up":
            raise TiDBError("frame end cannot be UNBOUNDED PRECEDING")
        if self._BOUND_RANK[fr.start.kind] > self._BOUND_RANK[fr.end.kind]:
            raise TiDBError("window frame start cannot be after frame end")

        def bound_off(b, what):
            if b.kind not in ("pre", "fol"):
                return 0
            e = self.to_expr(b.offset, scope, agg_ctx)
            if not isinstance(e, Constant) or e.value.is_null:
                raise TiDBError(f"window frame {what} offset must be a constant")
            if fr.unit == "rows":
                try:
                    off = e.value.to_int()
                except Exception:
                    off = -1
                if off < 0:
                    raise TiDBError("ROWS frame offset must be a non-negative integer")
                return off
            # RANGE: numeric offset, compared in the ORDER BY key's space
            if len(order) != 1:
                raise TiDBError("RANGE frame with offset requires exactly one ORDER BY expression")
            kft = order[0][0].ret_type
            if not (kft.is_int() or kft.is_decimal() or kft.is_float()):
                raise TiDBError("RANGE frame with offset requires a numeric ORDER BY expression")
            d = e.value
            if kft.is_decimal():
                # pre-scale exactly into the key lane's scaled-int form
                off = d.to_dec().rescale(max(kft.decimal, 0)).value
            elif kft.is_float():
                off = d.to_float()
            else:
                f = d.to_float()
                off = d.to_int() if float(int(f)) == f else f
            if (off if isinstance(off, (int, float)) else 0) < 0:
                raise TiDBError("RANGE frame offset must be non-negative")
            return off

        so, eo = bound_off(fr.start, "start"), bound_off(fr.end, "end")
        # same-kind offset ordering: (3 FOLLOWING .. 1 FOLLOWING) and
        # (2 PRECEDING .. 5 PRECEDING) are errors, not empty frames
        # (ref: MySQL ER_WINDOW_FRAME_START_ILLEGAL 3586)
        if (fr.start.kind == fr.end.kind == "fol" and so > eo) or (
            fr.start.kind == fr.end.kind == "pre" and so < eo
        ):
            raise TiDBError("window frame start cannot move after frame end")
        return Frame(fr.unit, fr.start.kind, so, fr.end.kind, eo)

    # frame clauses are accepted but ignored for these (SQL standard /
    # ref planner: needFrame==false funcs always use the whole partition)
    _FRAME_IGNORING = frozenset(
        ("row_number", "rank", "dense_rank", "cume_dist", "percent_rank", "ntile", "lead", "lag")
    )

    @staticmethod
    def _const_pos_int(c: Constant) -> bool:
        try:
            return not c.value.is_null and c.value.to_int() > 0
        except Exception:
            return False

    def _build_windows(self, plan, proj_exprs, order_items):
        """Lift _WindowFuncExpr placeholders into stacked Window nodes (one
        per distinct PARTITION/ORDER spec) and rewrite the outer exprs to
        reference the window output columns."""
        descs: list[WinDesc] = []
        seen: dict[str, WinDesc] = {}

        def collect(e):
            if isinstance(e, _WindowFuncExpr):
                k = repr(e.desc)
                if k not in seen:
                    seen[k] = e.desc
                    descs.append(e.desc)
                return
            if isinstance(e, ScalarFunc):
                for a in e.args:
                    collect(a)

        for e in proj_exprs:
            collect(e)
        for k, x, d, n in order_items:
            if k == "expr":
                collect(x)
        if not descs:
            return proj_exprs, order_items, plan

        # group by spec (first-seen order), stack one Window node per spec
        idx_of: dict[str, int] = {}
        by_spec: dict[str, list[WinDesc]] = {}
        for d in descs:
            by_spec.setdefault(d.spec_key(), []).append(d)
        for spec, ds in by_spec.items():
            base = len(plan.out_cols)
            cols = list(plan.out_cols) + [
                PlanCol(f"w{base + j}", d.ret_type) for j, d in enumerate(ds)
            ]
            plan = Window(plan, ds[0].part_by, ds[0].order_by, ds, cols)
            for j, d in enumerate(ds):
                idx_of[repr(d)] = base + j

        def replace(e):
            if isinstance(e, _WindowFuncExpr):
                i = idx_of[repr(e.desc)]
                return ECol(i, e.ret_type, f"w{i}")
            if isinstance(e, ScalarFunc):
                return ScalarFunc(e.sig, [replace(a) for a in e.args], e.ret_type)
            return e

        proj_exprs = [replace(e) for e in proj_exprs]
        order_items = [
            (k, replace(x) if k == "expr" else x, d, n) for k, x, d, n in order_items
        ]
        return proj_exprs, order_items, plan

    def _scalar_subquery(self, node: ast.SubqueryExpr) -> Expression:
        """Uncorrelated subqueries evaluate eagerly at plan time
        (correlated subqueries: decorrelation rule lands with the apply
        operator; ref rule_decorrelate.go)."""
        if self.run_subquery is None:
            raise TiDBError("subqueries not supported in this context")
        self.used_eager_subquery = True
        rows, fts = self.run_subquery(node.select)
        if node.modifier == "exists":
            return Constant(Datum.i(1 if rows else 0), ft_longlong())
        if node.modifier == "scalar":
            if len(rows) > 1:
                raise TiDBError("Subquery returns more than 1 row")
            if not rows:
                return Constant(Datum.null(), FieldType(TypeCode.Null))
            return Constant(rows[0][0], fts[0])
        raise TiDBError(f"unsupported subquery modifier {node.modifier}")

    def _in_subquery(self, node: ast.Call, scope, agg_ctx) -> Expression:
        lhs = self.to_expr(node.args[0], scope, agg_ctx)
        sub = node.args[1]
        self.used_eager_subquery = True
        rows, fts = self.run_subquery(sub.select)
        if not rows:
            return Constant(Datum.i(0), ft_longlong())
        consts = [Constant(r[0], fts[0]) for r in rows]
        return make_func("in", lhs, *consts)

    # ---------------------------------------------------------------- SELECT

    def build_select(self, sel) -> LogicalPlan:
        wf = getattr(sel, "with_", None)
        if wf is not None:
            self._cte_frames.append(self._cte_frame(wf))
            try:
                return self._build_select_body(sel)
            finally:
                self._cte_frames.pop()
        return self._build_select_body(sel)

    def _build_select_body(self, sel) -> LogicalPlan:
        if isinstance(sel, ast.SetOpSelect):
            return self.build_setop(sel)
        plan = self.build_from(sel.from_)
        scope = NameScope(plan.out_cols)

        if sel.where is not None:
            plan = self._build_where(plan, scope, sel.where)

        # expand stars into field list
        fields = []
        for f in sel.fields:
            if isinstance(f, ast.Star):
                for i, c in enumerate(plan.out_cols):
                    if f.table and c.table_alias.lower() != f.table.lower():
                        continue
                    fields.append(ast.SelectField(ast.Name((c.table_alias, c.name)), None))
                if not fields:
                    raise TiDBError("SELECT * with no tables")
            else:
                fields.append(f)

        agg_ctx = AggContext(self)
        group_exprs = []
        for g in sel.group_by:
            if isinstance(g, ast.Lit) and g.kind == "int":  # GROUP BY 2 (position)
                fe = fields[g.value - 1].expr
                group_exprs.append(self.to_expr(fe, scope))
            else:
                group_exprs.append(self.to_expr(g, scope))

        # convert select expressions, lifting aggregates
        proj_exprs = []
        proj_cols = []
        for f in fields:
            e = self.to_expr(f.expr, scope, agg_ctx, allow_window=True)
            name = f.alias or self._field_name(f.expr)
            proj_exprs.append(e)
            proj_cols.append(PlanCol(name, e.ret_type))

        having_expr = None
        if sel.having is not None:
            having_scope = ScopeWithAliases(scope, fields, proj_exprs)
            having_expr = self.to_expr_with_aliases(sel.having, having_scope, agg_ctx)

        # convert ORDER BY early: aliases → projected exprs, other exprs over
        # the child scope (may lift aggregates into agg_ctx)
        alias_scope = ScopeWithAliases(scope, fields, proj_exprs)
        order_items = []  # ('pos', i, desc) | ('expr', Expression, desc, ast)
        for b in sel.order_by:
            if isinstance(b.expr, ast.Lit) and b.expr.kind == "int":
                order_items.append(("pos", b.expr.value - 1, b.desc, None))
            else:
                e = self.to_expr_with_aliases(b.expr, alias_scope, agg_ctx, allow_window=True)
                order_items.append(("expr", e, b.desc, b.expr))

        need_agg = bool(group_exprs) or agg_ctx.aggs
        if need_agg:
            # rewrite first: it may append first_row aggs for bare columns
            proj_exprs = [agg_ctx.rewrite(e, group_exprs) for e in proj_exprs]
            if having_expr is not None:
                having_expr = agg_ctx.rewrite(having_expr, group_exprs)
            order_items = [
                (k, agg_ctx.rewrite(x, group_exprs) if k == "expr" else x, d, n)
                for k, x, d, n in order_items
            ]
            plan = self._build_agg(plan, scope, group_exprs, agg_ctx)

        if having_expr is not None:
            plan = Selection(plan, self.split_cnf(having_expr))

        # window functions sit above aggregation/HAVING, below the final
        # projection/DISTINCT/ORDER BY (ref: logical_plan_builder.go build order)
        proj_exprs, order_items, plan = self._build_windows(plan, proj_exprs, order_items)

        # sort columns: select-list matches by structure; others become
        # hidden projection columns trimmed after the sort
        n_visible = len(proj_exprs)
        hidden: list = []
        by: list = []
        for kind, x, desc, node in order_items:
            if kind == "pos":
                if not (0 <= x < n_visible):
                    raise TiDBError(f"ORDER BY position {x + 1} out of range")
                by.append((ECol(x, proj_exprs[x].ret_type, proj_cols[x].name), desc))
                continue
            idx = None
            for i, pe in enumerate(proj_exprs):
                if repr(pe) == repr(x):
                    idx = i
                    break
            if idx is None:
                hidden.append(x)
                idx = n_visible + len(hidden) - 1
            ft = (proj_exprs + hidden)[idx].ret_type
            by.append((ECol(idx, ft, f"s{idx}"), desc))

        if sel.distinct and hidden:
            raise TiDBError("ORDER BY expression must appear in SELECT DISTINCT list")

        all_exprs = proj_exprs + hidden
        all_cols = proj_cols + [PlanCol(f"h{i}", e.ret_type) for i, e in enumerate(hidden)]
        plan = Projection(plan, all_exprs, all_cols)

        if sel.distinct:
            gb = [ECol(i, c.ft, c.name) for i, c in enumerate(proj_cols)]
            plan = Aggregation(plan, gb, [], list(proj_cols))

        if by:
            plan = Sort(plan, by)

        if hidden:
            trims = [ECol(i, c.ft, c.name) for i, c in enumerate(proj_cols)]
            plan = Projection(plan, trims, proj_cols)

        if sel.limit is not None:
            cnt = self._const_int(sel.limit)
            off = self._const_int(sel.offset) if sel.offset is not None else 0
            plan = Limit(plan, cnt, off)
        return plan

    # ----------------------------------------------- WHERE / decorrelation

    @staticmethod
    def _ast_conjuncts(node) -> list:
        if isinstance(node, ast.Call) and node.name.lower() == "and":
            out = []
            for a in node.args:
                out.extend(PlanBuilder._ast_conjuncts(a))
            return out
        return [node]

    @staticmethod
    def _subquery_conjunct(cj):
        """Classify a WHERE conjunct that can decorrelate into a semi/anti
        join → (kind, lhs_ast, sub_select) or None."""
        if isinstance(cj, ast.SubqueryExpr) and cj.modifier == "exists":
            return ("semi", None, cj.select)
        if isinstance(cj, ast.Call) and cj.name.lower() == "in_subquery":
            return ("semi", cj.args[0], cj.args[1].select)
        if isinstance(cj, ast.Call) and cj.name.lower() == "not" and len(cj.args) == 1:
            inner = cj.args[0]
            if isinstance(inner, ast.SubqueryExpr) and inner.modifier == "exists":
                return ("anti", None, inner.select)
            if isinstance(inner, ast.Call) and inner.name.lower() == "in_subquery":
                return ("anti_in", inner.args[0], inner.args[1].select)
        return None

    @staticmethod
    def _simple_subquery(sel) -> bool:
        """Subqueries the decorrelated semi-join path handles: plain
        SELECT-FROM-WHERE (no agg/group/having/limit/distinct/set-ops)."""
        return (
            isinstance(sel, ast.Select)
            and not sel.group_by
            and sel.having is None
            and sel.limit is None
            and not sel.distinct
            and not sel_has_agg(sel)
        )

    def _build_where(self, plan, scope, where_ast):
        """WHERE with IN/EXISTS conjuncts rewritten to semi/anti hash joins
        (ref: planner/core/rule_decorrelate.go, expression_rewriter.go
        buildSemiJoin) so subqueries never re-execute per row. Subqueries
        beyond plain SPJ shape keep the eager-evaluation path (correct for
        uncorrelated; correlated ones error in name resolution)."""
        normal: list[Expression] = []
        subs = []
        for cj in self._ast_conjuncts(where_ast):
            hit = self._subquery_conjunct(cj)
            if hit is not None and self._simple_subquery(hit[2]):
                subs.append(hit)
                continue
            normal.extend(self.split_cnf(self.to_expr(cj, scope)))
        if normal:
            plan = Selection(plan, normal)
        for kind, lhs_ast, sub_sel in subs:
            plan = self._build_semi_join(plan, scope, kind, lhs_ast, sub_sel)
        return plan

    @staticmethod
    def _contains_corr(e: Expression) -> bool:
        if isinstance(e, _CorrRef):
            return True
        if isinstance(e, ScalarFunc):
            return any(PlanBuilder._contains_corr(a) for a in e.args)
        return False

    def _build_semi_join(self, plan, scope, kind, lhs_ast, sub_sel):
        """Build the subquery's FROM+WHERE manually (join right side keeps
        the subquery's FROM schema), extracting correlated conjuncts into
        join conditions."""
        nl = len(plan.out_cols)
        self._outer_scopes.append(scope)
        try:
            subplan = self.build_from(sub_sel.from_)
            sub_scope = NameScope(subplan.out_cols)
            corr: list[Expression] = []
            local: list[Expression] = []
            if sub_sel.where is not None:
                for cj in self._ast_conjuncts(sub_sel.where):
                    for e in self.split_cnf(self.to_expr(cj, sub_scope)):
                        (corr if self._contains_corr(e) else local).append(e)
            if local:
                subplan = Selection(subplan, local)
            field_e = None
            if lhs_ast is not None:  # IN (SELECT <one expr> ...)
                if len(sub_sel.fields) != 1 or isinstance(sub_sel.fields[0], ast.Star):
                    raise TiDBError("Operand should contain 1 column(s)")
                field_e = self.to_expr(sub_sel.fields[0].expr, sub_scope)
                if self._contains_corr(field_e):
                    raise TiDBError("correlated expression in IN subquery select list is not supported")
        finally:
            self._outer_scopes.pop()

        def rewrite(e):
            # subquery-schema expr → concatenated (outer + inner) schema
            if isinstance(e, _CorrRef):
                return ECol(e.idx, e.ret_type, e.name)
            if isinstance(e, ECol):
                return ECol(e.idx + nl, e.ret_type, e.name)
            if isinstance(e, ScalarFunc):
                return ScalarFunc(e.sig, [rewrite(a) for a in e.args], e.ret_type)
            return e

        def side(e) -> str:
            cols = set()
            e.collect_columns(cols)
            if cols and max(cols) < nl:
                return "outer"
            if cols and min(cols) >= nl:
                return "inner"
            return "mixed"

        eq, other = [], []
        for c in corr:
            rc = rewrite(c)
            if isinstance(rc, ScalarFunc) and rc.sig.name == "eq":
                a, b = rc.args
                sa, sb = side(a), side(b)
                if {sa, sb} == {"outer", "inner"}:
                    eq.append((a, b) if sa == "outer" else (b, a))
                    continue
            other.append(rc)

        na_key = None
        if field_e is not None:
            from .optimizer import _shift_expr

            lhs = self.to_expr(lhs_ast, scope)
            rhs = _shift_expr(field_e, nl)
            if kind == "anti_in":
                na_key = (lhs, rhs)  # null-aware NOT IN key
            else:
                eq.append((lhs, rhs))

        join = Join(plan, subplan, "anti" if kind == "anti_in" else kind, eq, other, list(plan.out_cols))
        join.na_key = na_key
        return join

    def _order_expr(self, node, out_scope: NameScope, fields, in_scope, agg_ctx):
        """ORDER BY resolves against output aliases first, then input."""
        if isinstance(node, ast.Name):
            try:
                idx = out_scope.resolve(node)
                c = out_scope.cols[idx]
                return ECol(idx, c.ft, c.name)
            except (UnknownColumn, AmbiguousColumn):
                pass
        # match structurally identical select expr
        for i, f in enumerate(fields):
            if f.expr == node:
                c = out_scope.cols[i]
                return ECol(i, c.ft, c.name)
        raise TiDBError("ORDER BY expression must appear in select list (hidden-column sort lands later)")

    @staticmethod
    def _has_agg_in_order(order_by) -> bool:
        def walk(n):
            if isinstance(n, ast.Call):
                if n.name.lower() in AGG_FUNCS:
                    return True
                return any(walk(a) for a in n.args)
            return False

        return any(walk(b.expr) for b in order_by)

    def _build_agg(self, plan, scope, group_exprs, agg_ctx):
        cols = [PlanCol(f"g{i}", e.ret_type) for i, e in enumerate(group_exprs)]
        for i, a in enumerate(agg_ctx.aggs):
            cols.append(PlanCol(f"a{i}", a.ret_type))
        return Aggregation(plan, group_exprs, agg_ctx.aggs, cols)

    def to_expr_with_aliases(self, node, scope_w, agg_ctx, allow_window=False):
        if isinstance(node, ast.Name) and len(node.parts) == 1:
            hit = scope_w.find_alias(node.column)
            if hit is not None:
                return hit
        if isinstance(node, ast.Call):
            lname = node.name.lower()
            if lname in ("charset", "collation", "coercibility") and len(node.args) == 1:
                return self._type_meta_func(lname, self.to_expr(node.args[0], scope_w.base, agg_ctx))
            info_c = self._info_func(lname, node)
            if info_c is not None:
                return info_c
            if getattr(node, "over", None) is not None or lname in WINDOW_FUNCS:
                return self.to_expr(node, scope_w.base, agg_ctx, allow_window=allow_window)
            if lname in AGG_FUNCS:
                return agg_ctx.add_agg(node, scope_w.base)
            args = [self.to_expr_with_aliases(a, scope_w, agg_ctx, allow_window) for a in node.args]
            return make_func(lname, *args)
        return self.to_expr(node, scope_w.base, agg_ctx, allow_window=allow_window)

    @staticmethod
    def _field_name(e) -> str:
        if isinstance(e, ast.Name):
            return e.column
        if isinstance(e, ast.Call):
            return f"{e.name}(...)" if e.args else f"{e.name}()"
        if isinstance(e, ast.Lit):
            return str(e.value)
        return "expr"

    def _const_int(self, node) -> int:
        if isinstance(node, ast.Lit) and node.kind == "int":
            return node.value
        raise TiDBError("LIMIT expects an integer literal")

    def build_setop(self, s: ast.SetOpSelect) -> LogicalPlan:
        children = [self.build_select(x) for x in s.selects]
        n = len(children[0].out_cols)
        for c in children[1:]:
            if len(c.out_cols) != n:
                raise TiDBError("The used SELECT statements have a different number of columns")
        from ..expr.builtins import merge_types

        cols = []
        for i in range(n):
            fts = [c.out_cols[i].ft for c in children]
            cols.append(PlanCol(children[0].out_cols[i].name, merge_types(fts)))
        plan = SetOp(children, s.ops, cols)
        if any(op == "union" for op in s.ops):
            gb = [ECol(i, c.ft, c.name) for i, c in enumerate(cols)]
            plan = Aggregation(plan, gb, [], list(cols))
        if s.order_by:
            scope = NameScope(plan.out_cols)
            by = []
            for b in s.order_by:
                if isinstance(b.expr, ast.Lit) and b.expr.kind == "int":
                    i = b.expr.value - 1
                    by.append((ECol(i, plan.out_cols[i].ft, plan.out_cols[i].name), b.desc))
                else:
                    by.append((self.to_expr(b.expr, scope), b.desc))
            plan = Sort(plan, by)
        if s.limit is not None:
            plan = Limit(plan, self._const_int(s.limit), self._const_int(s.offset) if s.offset else 0)
        return plan


class ScopeWithAliases:
    def __init__(self, base: NameScope, fields, proj_exprs):
        self.base = base
        self.fields = fields
        self.proj_exprs = proj_exprs

    def find_alias(self, name: str):
        lname = name.lower()
        for f, e in zip(self.fields, self.proj_exprs):
            if f.alias and f.alias.lower() == lname:
                return e
        return None


class AggContext:
    """Collects aggregates during expression conversion and rewrites outer
    expressions to reference the Aggregation node's output."""

    def __init__(self, builder: PlanBuilder):
        self.builder = builder
        self.aggs: list[AggDesc] = []
        self._agg_exprs: list[Expression] = []  # placeholder per agg

    def add_agg(self, node: ast.Call, scope: NameScope) -> Expression:
        name = node.name.lower()
        args = []
        for a in node.args:
            if isinstance(a, ast.Star):  # COUNT(*)
                args = []
                break
            args.append(self.builder.to_expr(a, scope))
        desc = AggDesc.make(name, args, distinct=node.distinct)
        if getattr(node, "sep", None) is not None:
            desc.sep = node.sep
        if desc.name == "group_concat":
            svars = self.builder.context_info.get("vars") or {}
            desc.max_len = int(svars.get("group_concat_max_len", desc.max_len))
        # dedup identical aggregates
        for i, existing in enumerate(self.aggs):
            if repr(existing) == repr(desc):
                return _AggRef(i, existing.ret_type)
        self.aggs.append(desc)
        return _AggRef(len(self.aggs) - 1, desc.ret_type)

    def rewrite(self, e: Expression, group_exprs) -> Expression:
        """Rewrite an expression over the child schema into one over the
        Aggregation output schema: [group cols..., agg cols...]."""
        ngroups = len(group_exprs)

        def rec(x):
            if isinstance(x, _AggRef):
                return ECol(ngroups + x.agg_idx, x.ret_type, f"a{x.agg_idx}")
            # an expression structurally equal to a group-by expr → its col
            for gi, g in enumerate(group_exprs):
                if repr(x) == repr(g):
                    return ECol(gi, g.ret_type, f"g{gi}")
            if isinstance(x, ECol):
                # bare column not in group by: first_row semantics
                for i, a in enumerate(self.aggs):
                    if a.name == "first_row" and repr(a.args[0]) == repr(x):
                        return ECol(ngroups + i, a.ret_type, f"a{i}")
                desc = AggDesc.make("first_row", [x])
                self.aggs.append(desc)
                return ECol(ngroups + len(self.aggs) - 1, desc.ret_type, "fr")
            if isinstance(x, _WindowFuncExpr):
                d = x.desc
                return _WindowFuncExpr(
                    WinDesc(
                        d.name,
                        [rec(a) for a in d.args],
                        [rec(p) for p in d.part_by],
                        [(rec(o), dsc) for o, dsc in d.order_by],
                        d.ret_type,
                    )
                )
            if isinstance(x, ScalarFunc):
                return ScalarFunc(x.sig, [rec(a) for a in x.args], x.ret_type)
            return x

        return rec(e)


def _refs_table(node, name: str) -> bool:
    """Does this (set-op) select reference `name` as a table — in FROM or
    inside an expression subquery (EXISTS/IN/scalar)?"""
    nm = name.lower()

    def from_tree(f):
        if isinstance(f, ast.TableName):
            return f.db is None and f.name.lower() == nm
        if isinstance(f, ast.Join):
            return from_tree(f.left) or from_tree(f.right)
        if isinstance(f, ast.SubqueryTable):
            return walk(f.select)
        return False

    def expr_walk(e):
        if isinstance(e, ast.SubqueryExpr):
            return walk(e.select)
        if isinstance(e, ast.Call):
            return any(expr_walk(a) for a in e.args)
        if isinstance(e, ast.CaseWhen):
            parts = [e.operand, e.else_] + [x for pair in e.whens for x in pair]
            return any(expr_walk(x) for x in parts if x is not None)
        if isinstance(e, ast.Cast):
            return expr_walk(e.expr)
        return False

    def walk(s):
        if isinstance(s, ast.SetOpSelect):
            return any(walk(x) for x in s.selects)
        if s.from_ is not None and from_tree(s.from_):
            return True
        exprs = [s.where, s.having] + [f.expr for f in s.fields if not isinstance(f, ast.Star)]
        return any(expr_walk(e) for e in exprs if e is not None)

    return walk(node)


def sel_has_agg(sel) -> bool:
    def walk(n):
        if isinstance(n, ast.Call):
            if n.name.lower() in AGG_FUNCS and getattr(n, "over", None) is None:
                return True
            return any(walk(a) for a in n.args)
        if isinstance(n, ast.CaseWhen):
            parts = [n.operand, n.else_] + [x for pair in n.whens for x in pair]
            return any(walk(x) for x in parts if x is not None)
        if isinstance(n, ast.Cast):
            return walk(n.expr)
        return False  # SubqueryExpr: nested aggs belong to the inner scope

    return any(walk(f.expr) for f in sel.fields if not isinstance(f, ast.Star))


class _SeqExpr(Expression):
    """NEXTVAL/LASTVAL/SETVAL over a sequence — evaluated per ROW at
    runtime through the session hook (ref: expression/builtin_other.go
    nextVal/lastVal/setVal; a cached batch makes per-row calls cheap)."""

    def __init__(self, op: str, db: str, name: str, hook, arg: Expression | None = None):
        self.op = op
        self.db = db
        self.name = name
        self.hook = hook
        self.arg = arg
        self.ret_type = ft_longlong()

    def collect_columns(self, out):
        if self.arg is not None:
            self.arg.collect_columns(out)

    def pushable(self) -> bool:
        return False  # stateful: never ships to the device engine

    def eval(self, chunk):
        import numpy as np

        n = max(chunk.num_rows, 1)
        if self.op == "lastval":
            v = self.hook("lastval", self.db, self.name)
            if v is None:
                return np.zeros(n, np.int64), np.zeros(n, bool)
            return np.full(n, v, np.int64), np.ones(n, bool)
        if self.op == "setval":
            d, valid = self.arg.eval(chunk)
            d = np.asarray(d).reshape(-1)
            valid = np.asarray(valid).reshape(-1)
            out = np.zeros(n, np.int64)
            ok = np.zeros(n, bool)
            for i in range(n):
                di, vi = d[i % len(d)], valid[i % len(valid)]
                if vi:  # SETVAL(s, NULL) → NULL for that row
                    out[i] = self.hook("setval", self.db, self.name, int(di))
                    ok[i] = True
            return out, ok
        out = np.fromiter(
            (self.hook("nextval", self.db, self.name) for _ in range(n)), np.int64, n
        )
        return out, np.ones(n, bool)

    def __repr__(self):
        return f"{self.op}({self.db}.{self.name})"


class _CorrRef(Expression):
    """A correlated reference to a column of the enclosing query
    (ref: expression.CorrelatedColumn). Only valid during subquery builds;
    _build_semi_join rewrites it to an outer-schema Column."""

    def __init__(self, idx: int, ret_type, name: str):
        self.idx = idx
        self.ret_type = ret_type
        self.name = name

    def collect_columns(self, out):
        pass  # not a local column

    def eval(self, chunk):
        raise TiDBError(f"correlated reference {self.name!r} is not supported in this position")

    def __repr__(self):
        return f"corr({self.name}#{self.idx})"


class _WindowFuncExpr(Expression):
    """Placeholder for a window function call, lifted into a Window plan
    node by PlanBuilder._build_windows."""

    def __init__(self, desc: WinDesc):
        self.desc = desc
        self.ret_type = desc.ret_type

    def collect_columns(self, out):
        for e in self.desc.args + self.desc.part_by:
            e.collect_columns(out)
        for e, _ in self.desc.order_by:
            e.collect_columns(out)

    def __repr__(self):
        return f"win[{self.desc!r}]"


class _AggRef(Expression):
    """Placeholder node for a lifted aggregate, resolved by AggContext.rewrite."""

    def __init__(self, agg_idx: int, ret_type):
        self.agg_idx = agg_idx
        self.ret_type = ret_type

    def collect_columns(self, out):
        pass

    def __repr__(self):
        return f"aggref#{self.agg_idx}"
