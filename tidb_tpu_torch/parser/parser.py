"""Recursive-descent SQL parser (copy of tidb_tpu/parser/parser.py; ref: pingcap/parser parser.y — the grammar
coverage is modeled on the reference's MySQL dialect; the implementation is
a fresh Pratt/recursive-descent design, not yacc).

Covers the SQL surface the framework executes: SELECT (joins, subqueries,
group/having/order/limit, set-ops), DML, DDL, transactions, SET/SHOW/
EXPLAIN/ANALYZE/ADMIN, prepared statements.
"""

from __future__ import annotations

from ..errors import ParseError
from ..mysqltypes.mydecimal import dec_from_string
from . import ast
from .lexer import Token, tokenize

# binary operator precedence (higher binds tighter); name → builtin func name
BINOPS = {
    "||": (1, "or"),
    "OR": (1, "or"),
    "XOR": (2, "xor"),
    "&&": (3, "and"),
    "AND": (3, "and"),
    "=": (5, "eq"),
    "<=>": (5, "nulleq"),
    "<": (5, "lt"),
    ">": (5, "gt"),
    "<=": (5, "le"),
    ">=": (5, "ge"),
    "!=": (5, "ne"),
    "<>": (5, "ne"),
    "|": (6, "bitor"),
    "&": (7, "bitand"),
    "<<": (8, "lshift"),
    ">>": (8, "rshift"),
    "+": (9, "plus"),
    "-": (9, "minus"),
    "*": (10, "mul"),
    "/": (10, "div"),
    "%": (10, "mod"),
    "DIV": (10, "intdiv"),
    "MOD": (10, "mod"),
    "^": (11, "bitxor"),
}

CMP_PREC = 5

RESERVED_STOP = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "UNION", "EXCEPT", "INTERSECT",
    "ON", "USING", "JOIN", "INNER", "LEFT", "RIGHT", "CROSS", "STRAIGHT_JOIN", "AS", "SET",
    "VALUES", "INTO", "AND", "OR", "NOT", "XOR", "IS", "IN", "LIKE", "BETWEEN", "REGEXP",
    "RLIKE", "ASC", "DESC", "FOR", "LOCK", "THEN", "ELSE", "WHEN", "END", "CASE", "DIV",
    "MOD", "COLLATE", "INTERVAL", "EXISTS", "SELECT", "DUPLICATE", "KEY", "UPDATE", "BY", "WITH",
}


def _walk_tables(node):
    """Yield every TableName under a FROM tree (Join/list), not descending
    into derived-table subqueries — those carry their own AS OF."""
    if node is None:
        return
    if isinstance(node, ast.TableName):
        yield node
    elif isinstance(node, ast.Join):
        yield from _walk_tables(node.left)
        yield from _walk_tables(node.right)
    elif isinstance(node, list):
        for n in node:
            yield from _walk_tables(n)


def parse(sql: str) -> list:
    """Parse a semicolon-separated script into a list of statements."""
    p = Parser(tokenize(sql), sql)
    stmts = []
    while not p.at("eof"):
        if p.try_op(";"):
            continue
        stmts.append(p.statement())
        if not p.at("eof"):
            p.expect_op(";")
    return stmts


def parse_one(sql: str):
    stmts = parse(sql)
    if len(stmts) != 1:
        raise ParseError(f"expected a single statement, got {len(stmts)}")
    return stmts[0]


import re as _re

_HINT_RE = _re.compile(r"(\w+)\s*(?:\(([^()]*)\))?")


def parse_hint_text(text: str) -> list:
    """'/*+ NAME(a, b) NAME2 */' → [(NAME, [a, b]), (NAME2, [])]."""
    body = text[3:-2]
    out = []
    for m in _HINT_RE.finditer(body):
        name = m.group(1).upper()
        args = [a.strip().strip("'\"`").lower() for a in (m.group(2) or "").split(",") if a.strip()]
        out.append((name, args))
    return out


class Parser:
    def __init__(self, toks: list[Token], sql: str = ""):
        # optimizer hints apply statement-wide (query-block scoping is a
        # later refinement): collect and strip them from the stream
        self.hints = []
        for t in toks:
            if t.kind == "hint":
                self.hints.extend(parse_hint_text(t.text))
        self.toks = [t for t in toks if t.kind != "hint"]
        self.i = 0
        self.sql = sql
        self.param_count = 0

    # --- token helpers -----------------------------------------------------

    @property
    def tok(self) -> Token:
        return self.toks[self.i]

    def peek(self, off=1) -> Token:
        j = min(self.i + off, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at(self, kind: str) -> bool:
        return self.tok.kind == kind

    def at_kw(self, *kws: str) -> bool:
        return self.tok.kind == "ident" and self.tok.upper in kws

    def at_op(self, *ops: str) -> bool:
        return self.tok.kind == "op" and self.tok.text in ops

    def try_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def try_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> Token:
        if not self.at_kw(kw):
            self.fail(f"expected {kw}")
        return self.next()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            self.fail(f"expected {op!r}")
        return self.next()

    def ident(self) -> str:
        t = self.tok
        if t.kind in ("ident", "qident"):
            self.next()
            return t.text
        self.fail("expected identifier")

    def fail(self, msg: str):
        t = self.tok
        near = self.sql[max(t.pos - 20, 0) : t.pos + 20]
        raise ParseError(f"{msg} near offset {t.pos}: ...{near!r}... (got {t.text!r})")

    # --- statements --------------------------------------------------------

    def statement(self):
        t = self.tok
        if t.kind != "ident":
            if t.kind == "op" and t.text == "(":
                return self.select_stmt()
            self.fail("expected statement")
        kw = t.upper
        fn = {
            "SELECT": self.select_stmt,
            "WITH": self.select_stmt,
            "INSERT": self.insert_stmt,
            "REPLACE": self.insert_stmt,
            "UPDATE": self.update_stmt,
            "DELETE": self.delete_stmt,
            "CREATE": self.create_stmt,
            "DROP": self.drop_stmt,
            "ALTER": self.alter_stmt,
            "TRUNCATE": self.truncate_stmt,
            "RENAME": self.rename_stmt,
            "BEGIN": self.begin_stmt,
            "START": self.begin_stmt,
            "COMMIT": lambda: (self.next(), ast.Commit())[1],
            "ROLLBACK": lambda: (self.next(), ast.Rollback())[1],
            "SET": self.set_stmt,
            "SHOW": self.show_stmt,
            "EXPLAIN": self.explain_stmt,
            "DESC": self.desc_stmt,
            "DESCRIBE": self.desc_stmt,
            "USE": self.use_stmt,
            "ANALYZE": self.analyze_stmt,
            "PREPARE": self.prepare_stmt,
            "EXECUTE": self.execute_stmt,
            "DEALLOCATE": self.deallocate_stmt,
            "ADMIN": self.admin_stmt,
            "KILL": self.kill_stmt,
            "FLUSH": self.flush_stmt,
            "LOAD": self.load_stmt,
            "SPLIT": self.split_stmt,
            "BACKUP": self.brie_stmt,
            "RESTORE": self.brie_stmt,
            "GRANT": self.grant_stmt,
            "REVOKE": self.grant_stmt,
            "LOCK": self.lock_stmt,
            "UNLOCK": self.unlock_stmt,
            "TRACE": self.trace_stmt,
        }.get(kw)
        if fn is None:
            self.fail(f"unsupported statement {kw}")
        return fn()

    # --- SELECT ------------------------------------------------------------

    def select_stmt(self):
        with_ = None
        if self.at_kw("WITH"):
            self.next()
            recursive = self.try_kw("RECURSIVE")
            ctes = []
            while True:
                name = self.ident()
                cols = []
                if self.try_op("("):
                    cols = self.name_list()
                    self.expect_op(")")
                self.expect_kw("AS")
                self.expect_op("(")
                sub = self.select_stmt()
                self.expect_op(")")
                ctes.append(ast.CTEDef(name, cols, sub))
                if not self.try_op(","):
                    break
            with_ = ast.WithClause(recursive, ctes)
        stmt = self._select_body()
        if with_ is not None:
            stmt.with_ = with_
        if self.hints:
            stmt.hints = list(self.hints)
        return stmt

    def _select_body(self):
        first = self.select_core()
        selects = [first]
        ops = []
        while True:
            if self.at_kw("UNION"):
                self.next()
                ops.append("union_all" if self.try_kw("ALL") else ("union" if not self.try_kw("DISTINCT") else "union"))
            elif self.at_kw("EXCEPT"):
                self.next()
                ops.append("except")
            elif self.at_kw("INTERSECT"):
                self.next()
                ops.append("intersect")
            else:
                break
            selects.append(self.select_core())
        if len(selects) == 1:
            return first
        setop = ast.SetOpSelect(selects, ops)
        # MySQL: a trailing ORDER BY/LIMIT on the (unparenthesized) last
        # branch applies to the whole set operation — hoist it.
        last = selects[-1]
        if isinstance(last, ast.Select):
            setop.order_by, last.order_by = last.order_by, []
            setop.limit, setop.offset, last.limit, last.offset = last.limit, last.offset, None, None
            if last.into_outfile is not None:  # INTO OUTFILE hoists too
                setop.into_outfile, last.into_outfile = last.into_outfile, None
                setop.outfile_fsep = last.outfile_fsep
                setop.outfile_lsep = last.outfile_lsep
        if self.try_kw("ORDER"):
            self.expect_kw("BY")
            setop.order_by = self.by_items()
        if self.try_kw("LIMIT"):
            setop.limit, setop.offset = self.limit_clause()
        return setop

    def select_core(self) -> ast.Select:
        if self.try_op("("):
            s = self.select_stmt()
            self.expect_op(")")
            return s
        self.expect_kw("SELECT")
        sel = ast.Select(fields=[])
        while self.at_kw("DISTINCT", "ALL", "DISTINCTROW", "SQL_CALC_FOUND_ROWS"):
            if self.tok.upper in ("DISTINCT", "DISTINCTROW"):
                sel.distinct = True
            self.next()
        # select list
        while True:
            sel.fields.append(self.select_field())
            if not self.try_op(","):
                break
        if self.try_kw("FROM"):
            sel.from_ = self.table_refs()
            # hoist `AS OF TIMESTAMP` to the statement: the read-ts is a
            # per-statement property (one snapshot), not per-table here
            for t in _walk_tables(sel.from_):
                if getattr(t, "as_of", None) is not None:
                    sel.as_of = t.as_of
        if self.try_kw("WHERE"):
            sel.where = self.expr()
        if self.try_kw("GROUP"):
            self.expect_kw("BY")
            sel.group_by = [b.expr for b in self.by_items()]
        if self.try_kw("HAVING"):
            sel.having = self.expr()
        if self.try_kw("ORDER"):
            self.expect_kw("BY")
            sel.order_by = self.by_items()
        if self.try_kw("LIMIT"):
            sel.limit, sel.offset = self.limit_clause()
        if self.try_kw("INTO"):
            # SELECT ... INTO OUTFILE 'path' (ref: executor/select_into.go)
            self.expect_kw("OUTFILE")
            t = self.next()
            if t.kind != "str":
                self.fail("expected OUTFILE path string")
            sel.into_outfile = t.text
            if self.try_kw("FIELDS") or self.try_kw("COLUMNS"):
                self.expect_kw("TERMINATED")
                self.expect_kw("BY")
                sel.outfile_fsep = self._str_lit("field separator")
            if self.try_kw("LINES"):
                self.expect_kw("TERMINATED")
                self.expect_kw("BY")
                sel.outfile_lsep = self._str_lit("line separator")
        if self.try_kw("FOR"):
            self.expect_kw("UPDATE")
            sel.for_update = True
        elif self.try_kw("LOCK"):
            self.expect_kw("IN")
            self.expect_kw("SHARE")
            self.expect_kw("MODE")
            sel.lock_in_share = True
        return sel

    def select_field(self):
        if self.at_op("*"):
            self.next()
            return ast.Star()
        # t.* / db.t.*
        if self.tok.kind in ("ident", "qident") and self.tok.upper not in RESERVED_STOP:
            j = self.i
            try:
                name = self.ident()
                if self.try_op("."):
                    if self.try_op("*"):
                        return ast.Star(table=name)
                self.i = j
            except ParseError:
                self.i = j
        e = self.expr()
        alias = None
        if self.try_kw("AS"):
            alias = self.ident_or_string()
        elif self.tok.kind in ("ident", "qident") and self.tok.upper not in RESERVED_STOP:
            alias = self.ident()
        return ast.SelectField(e, alias)

    def ident_or_string(self) -> str:
        if self.tok.kind == "str":
            return self.next().text
        return self.ident()

    def by_items(self) -> list:
        items = []
        while True:
            e = self.expr()
            desc = False
            if self.try_kw("DESC"):
                desc = True
            else:
                self.try_kw("ASC")
            items.append(ast.ByItem(e, desc))
            if not self.try_op(","):
                break
        return items

    def limit_clause(self):
        a = self.expr()
        if self.try_op(","):
            b = self.expr()
            return b, a  # LIMIT offset, count
        if self.try_kw("OFFSET"):
            return a, self.expr()
        return a, None

    # --- table references ---------------------------------------------------

    def table_refs(self):
        left = self.table_factor()
        while True:
            natural = False
            if self.at_kw("NATURAL"):
                self.next()
                natural = True
            if self.try_op(","):
                right = self.table_factor()
                left = ast.Join(left, right, "cross")
                continue
            if self.at_kw("JOIN", "INNER", "CROSS", "STRAIGHT_JOIN"):
                kind = "inner"
                straight = self.tok.upper == "STRAIGHT_JOIN"
                if self.tok.upper == "CROSS":
                    kind = "cross"
                if self.tok.upper in ("INNER", "CROSS"):
                    self.next()
                self.expect_kw("JOIN") if self.at_kw("JOIN") else self.next()
                right = self.table_factor()
                j = ast.Join(left, right, kind)
                j.straight = straight
                self._join_cond(j, natural)
                left = j
                continue
            if self.at_kw("LEFT", "RIGHT"):
                kind = self.next().upper.lower()
                self.try_kw("OUTER")
                self.expect_kw("JOIN")
                right = self.table_factor()
                j = ast.Join(left, right, kind)
                self._join_cond(j, natural)
                left = j
                continue
            break
        return left

    def _join_cond(self, j: ast.Join, natural: bool):
        if natural:
            j.kind = "natural_" + j.kind
            return
        if self.try_kw("ON"):
            j.on = self.expr()
        elif self.try_kw("USING"):
            self.expect_op("(")
            j.using = self.name_list()
            self.expect_op(")")

    def table_factor(self):
        if self.try_op("("):
            if self.at_kw("SELECT", "WITH") or self.at_op("("):
                s = self.select_stmt()
                self.expect_op(")")
                alias = None
                self.try_kw("AS")
                if self.tok.kind in ("ident", "qident"):
                    alias = self.ident()
                if alias is None:
                    self.fail("derived table requires an alias")
                return ast.SubqueryTable(s, alias)
            refs = self.table_refs()
            self.expect_op(")")
            return refs
        db = None
        name = self.ident()
        if self.try_op("."):
            db, name = name, self.ident()
        as_of = None
        # `t AS OF TIMESTAMP expr` must be checked before the `AS alias`
        # branch — a bare try_kw("AS") would eat the AS and read OF as the
        # alias (ref: planner stale-read, executor/stale_txn_test.go)
        if self.at_kw("AS") and self.peek().kind == "ident" and self.peek().upper == "OF":
            self.next()  # AS
            self.next()  # OF
            self.expect_kw("TIMESTAMP")
            as_of = self.expr()
        alias = None
        if self.try_kw("AS"):
            alias = self.ident()
        elif self.tok.kind in ("ident", "qident") and self.tok.upper not in RESERVED_STOP:
            alias = self.ident()
        return ast.TableName(db, name, alias, as_of=as_of)

    def name_list(self) -> list:
        names = [self.ident()]
        while self.try_op(","):
            names.append(self.ident())
        return names

    # --- expressions (Pratt) ------------------------------------------------

    def expr(self, min_prec: int = 0):
        left = self.unary()
        while True:
            t = self.tok
            # IS [NOT] NULL / TRUE / FALSE
            if self.at_kw("IS"):
                if CMP_PREC < min_prec:
                    break
                self.next()
                neg = self.try_kw("NOT")
                if self.try_kw("NULL"):
                    left = ast.Call("isnull", [left])
                elif self.try_kw("TRUE"):
                    left = ast.Call("istrue", [left])
                elif self.try_kw("FALSE"):
                    left = ast.Call("isfalse", [left])
                else:
                    self.fail("expected NULL/TRUE/FALSE after IS")
                if neg:
                    left = ast.Call("not", [left])
                continue
            neg = False
            j = self.i
            if self.at_kw("NOT") and self.peek().kind == "ident" and self.peek().upper in ("IN", "LIKE", "BETWEEN", "REGEXP", "RLIKE"):
                if CMP_PREC < min_prec:
                    break
                self.next()
                neg = True
            if self.at_kw("IN"):
                if CMP_PREC < min_prec:
                    self.i = j
                    break
                self.next()
                self.expect_op("(")
                if self.at_kw("SELECT", "WITH"):
                    sub = self.select_stmt()
                    self.expect_op(")")
                    left = ast.Call("in_subquery", [left, ast.SubqueryExpr(sub, "in")])
                else:
                    args = [self.expr()]
                    while self.try_op(","):
                        args.append(self.expr())
                    self.expect_op(")")
                    left = ast.Call("in", [left] + args)
                if neg:
                    left = ast.Call("not", [left])
                continue
            if self.at_kw("LIKE"):
                if CMP_PREC < min_prec:
                    self.i = j
                    break
                self.next()
                pat = self.expr(CMP_PREC + 1)
                esc = None
                if self.try_kw("ESCAPE"):
                    esc = self.expr(CMP_PREC + 1)
                left = ast.Call("like", [left, pat] + ([esc] if esc is not None else []))
                if neg:
                    left = ast.Call("not", [left])
                continue
            if self.at_kw("REGEXP", "RLIKE"):
                if CMP_PREC < min_prec:
                    self.i = j
                    break
                self.next()
                pat = self.expr(CMP_PREC + 1)
                left = ast.Call("regexp", [left, pat])
                if neg:
                    left = ast.Call("not", [left])
                continue
            if self.at_kw("BETWEEN"):
                if CMP_PREC < min_prec:
                    self.i = j
                    break
                self.next()
                lo = self.expr(CMP_PREC + 1)
                self.expect_kw("AND")
                hi = self.expr(CMP_PREC + 1)
                left = ast.Call("and", [ast.Call("ge", [left, lo]), ast.Call("le", [left, hi])])
                if neg:
                    left = ast.Call("not", [left])
                continue
            if neg:
                self.i = j
                break
            # plain binary operators
            key = None
            if t.kind == "op" and t.text in BINOPS:
                key = t.text
            elif t.kind == "ident" and t.upper in BINOPS:
                key = t.upper
            if key is None:
                break
            prec, fname = BINOPS[key]
            if prec < min_prec:
                break
            self.next()
            # comparison against subquery / ANY / ALL
            if prec == CMP_PREC and self.at_op("(") and self.peek().kind == "ident" and self.peek().upper in ("SELECT", "WITH"):
                self.next()
                sub = self.select_stmt()
                self.expect_op(")")
                right = ast.SubqueryExpr(sub, "scalar")
            elif prec == CMP_PREC and self.at_kw("ANY", "SOME", "ALL"):
                mod = "any" if self.tok.upper in ("ANY", "SOME") else "all"
                self.next()
                self.expect_op("(")
                sub = self.select_stmt()
                self.expect_op(")")
                right = ast.SubqueryExpr(sub, mod)
            else:
                right = self.expr(prec + 1)
            left = ast.Call(fname, [left, right])
        return left

    def unary(self):
        if self.at_kw("NOT"):
            self.next()
            return ast.Call("not", [self.expr(4)])
        if self.at_op("!"):
            self.next()
            return ast.Call("not", [self.unary()])
        if self.at_op("-"):
            self.next()
            return ast.Call("unaryminus", [self.unary()])
        if self.at_op("+"):
            self.next()
            return self.unary()
        if self.at_op("~"):
            self.next()
            return ast.Call("bitneg", [self.unary()])
        return self.primary()

    def primary(self):
        t = self.tok
        if t.kind == "num":
            self.next()
            txt = t.text
            if "e" in txt.lower():
                return ast.Lit(float(txt), "float")
            if "." in txt:
                return ast.Lit(dec_from_string(txt), "dec")
            return ast.Lit(int(txt), "int")
        if t.kind == "str":
            self.next()
            return ast.Lit(t.text, "str")
        if t.kind == "hex":
            self.next()
            h = t.text
            if h[0] in "xX":
                h = h[2:-1]
            else:
                h = h[2:]
            return ast.Lit(bytes.fromhex(h if len(h) % 2 == 0 else "0" + h), "hex")
        if t.kind == "op":
            if self.try_op("("):
                if self.at_kw("SELECT", "WITH"):
                    sub = self.select_stmt()
                    self.expect_op(")")
                    return ast.SubqueryExpr(sub, "scalar")
                e = self.expr()
                if self.at_op(","):
                    items = [e]
                    while self.try_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    return ast.Call("row", items)
                self.expect_op(")")
                return e
            if self.try_op("?"):
                p = ast.Param(self.param_count)
                self.param_count += 1
                return p
        if t.kind == "sysvar":
            self.next()
            return ast.Name(parts=("@@" + t.text[2:].lower(),))
        if t.kind == "uservar":
            self.next()
            return ast.Name(parts=(t.text.lower(),))
        if t.kind in ("ident", "qident"):
            up = t.upper
            if up == "NULL":
                self.next()
                return ast.Lit(None, "null")
            if up == "TRUE":
                self.next()
                return ast.Lit(True, "bool")
            if up == "FALSE":
                self.next()
                return ast.Lit(False, "bool")
            if up in ("CURRENT_TIMESTAMP", "CURRENT_DATE", "CURRENT_TIME", "CURRENT_USER",
                      "LOCALTIME", "LOCALTIMESTAMP") and self.peek().text != "(":
                self.next()
                return ast.Call(up.lower(), [])
            if up == "CASE":
                return self.case_expr()
            if up == "CAST" or up == "CONVERT":
                return self.cast_expr()
            if up == "EXISTS":
                self.next()
                self.expect_op("(")
                sub = self.select_stmt()
                self.expect_op(")")
                return ast.SubqueryExpr(sub, "exists")
            if up == "INTERVAL":
                # INTERVAL(n, n1, n2, ...) the comparison function vs
                # INTERVAL <expr> <unit> date arithmetic — disambiguated
                # by a top-level comma inside the parens (MySQL grammar)
                if self.peek().kind == "op" and self.peek().text == "(":
                    depth, j = 0, self.i + 1
                    is_call = False
                    while j < len(self.toks):
                        t = self.toks[j]
                        if t.kind == "op" and t.text == "(":
                            depth += 1
                        elif t.kind == "op" and t.text == ")":
                            depth -= 1
                            if depth == 0:
                                break
                        elif t.kind == "op" and t.text == "," and depth == 1:
                            is_call = True
                            break
                        j += 1
                    if is_call:
                        return self.func_call()
                self.next()
                e = self.expr()
                unit = self.ident().lower()
                return ast.Interval(e, unit)
            if up == "BINARY":
                self.next()
                return ast.Call("binary", [self.unary()])
            if up == "DEFAULT" and self.peek().kind == "op" and self.peek().text != "(":
                self.next()
                return ast.Default()
            if up == "DATE" and self.peek().kind == "str":
                self.next()
                return ast.Lit(self.next().text, "str")
            # function call?
            if self.peek().kind == "op" and self.peek().text == "(":
                return self.func_call()
            # plain column ref (possibly qualified)
            name = self.ident()
            parts = [name]
            while self.at_op(".") and self.peek().kind in ("ident", "qident"):
                self.next()
                parts.append(self.ident())
            return ast.Name(parts=tuple(parts))
        self.fail("expected expression")

    def func_call(self):
        fname = self.ident().lower()
        self.expect_op("(")
        # unit-keyword first arguments (ref: parser.y TimestampDiff/Extract)
        if fname in ("timestampdiff", "timestampadd"):
            unit = self.ident().lower()
            self.expect_op(",")
            args = [ast.Lit(unit, "str"), self.expr()]
            self.expect_op(",")
            args.append(self.expr())
            self.expect_op(")")
            return ast.Call(fname, args)
        if fname == "extract":
            unit = self.ident().lower()
            self.expect_kw("FROM")
            args = [ast.Lit(unit, "str"), self.expr()]
            self.expect_op(")")
            return ast.Call(fname, args)
        distinct = False
        if self.try_kw("DISTINCT"):
            distinct = True
        args = []
        if self.at_op("*") and fname == "count":
            self.next()
            self.expect_op(")")
            return self._maybe_over(ast.Call("count", [ast.Star()], distinct=False))
        sep = None
        if not self.at_op(")"):
            args.append(self.expr())
            while self.try_op(","):
                args.append(self.expr())
            if fname == "group_concat" and self.try_kw("SEPARATOR"):
                sep = self.next().text
        self.expect_op(")")
        call = ast.Call(fname, args, distinct=distinct)
        if sep is not None:
            call.sep = sep
        return self._maybe_over(call)

    def _maybe_over(self, call: ast.Call) -> ast.Call:
        """OVER ([PARTITION BY ...] [ORDER BY ...] [frame]) with full
        ROWS/RANGE BETWEEN frame clauses (ref: parser.y WindowFrameClause,
        executor/pipelined_window.go:37)."""
        if not self.at_kw("OVER"):
            return call
        self.next()
        self.expect_op("(")
        part, order = [], []
        if self.try_kw("PARTITION"):
            self.expect_kw("BY")
            part.append(self.expr())
            while self.try_op(","):
                part.append(self.expr())
        if self.try_kw("ORDER"):
            self.expect_kw("BY")
            order = self.by_items()
        frame = None
        if self.at_kw("ROWS", "RANGE"):
            unit = self.next().upper.lower()
            if self.try_kw("BETWEEN"):
                start = self._frame_bound()
                self.expect_kw("AND")
                end = self._frame_bound()
            else:
                # single-bound form: <bound> .. CURRENT ROW
                start = self._frame_bound()
                end = ast.FrameBound("cur")
            frame = ast.FrameSpec(unit, start, end)
        self.expect_op(")")
        call.over = ast.WindowSpec(part, order, frame)
        return call

    def _frame_bound(self) -> ast.FrameBound:
        if self.try_kw("UNBOUNDED"):
            if self.try_kw("PRECEDING"):
                return ast.FrameBound("up")
            self.expect_kw("FOLLOWING")
            return ast.FrameBound("uf")
        if self.try_kw("CURRENT"):
            self.expect_kw("ROW")
            return ast.FrameBound("cur")
        e = self.expr()
        if self.try_kw("PRECEDING"):
            return ast.FrameBound("pre", e)
        self.expect_kw("FOLLOWING")
        return ast.FrameBound("fol", e)

    def case_expr(self):
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.expr()
        whens = []
        while self.try_kw("WHEN"):
            c = self.expr()
            self.expect_kw("THEN")
            r = self.expr()
            whens.append((c, r))
        else_ = None
        if self.try_kw("ELSE"):
            else_ = self.expr()
        self.expect_kw("END")
        return ast.CaseWhen(operand, whens, else_)

    def cast_expr(self):
        kw = self.next().upper  # CAST or CONVERT
        self.expect_op("(")
        e = self.expr()
        if kw == "CAST":
            self.expect_kw("AS")
        else:
            self.expect_op(",")
        tname, targs, unsigned, _, _ = self.type_spec(cast_ctx=True)
        self.expect_op(")")
        return ast.Cast(e, tname, targs, unsigned)

    def type_spec(self, cast_ctx=False):
        name = self.ident().lower()
        if cast_ctx:
            name = {"signed": "bigint", "unsigned": "bigint", "integer": "bigint", "char": "varchar", "binary": "varbinary"}.get(name, name)
            unsigned_by_name = name == "bigint" and False
        args = ()
        elems = ()
        if self.try_op("("):
            if name in ("enum", "set"):
                vals = [self.tok.text]
                self.next()
                while self.try_op(","):
                    vals.append(self.tok.text)
                    self.next()
                elems = tuple(vals)
            else:
                nums = [int(self.next().text)]
                while self.try_op(","):
                    nums.append(int(self.next().text))
                args = tuple(nums)
            self.expect_op(")")
        unsigned = False
        while self.at_kw("UNSIGNED", "SIGNED", "ZEROFILL"):
            if self.tok.upper == "UNSIGNED":
                unsigned = True
            self.next()
        collate = ""
        if self.try_kw("CHARACTER"):
            self.expect_kw("SET")
            self.ident()
        if self.try_kw("COLLATE"):
            collate = self.ident().lower()
        return name, args, unsigned, elems, collate

    # --- DML ---------------------------------------------------------------

    def insert_stmt(self):
        replace = self.tok.upper == "REPLACE"
        self.next()
        ignore = self.try_kw("IGNORE")
        self.try_kw("INTO")
        tbl = self._table_name()
        cols = []
        if self.at_op("(") :
            self.next()
            cols = self.name_list()
            self.expect_op(")")
        node = ast.Insert(tbl, cols, [], replace=replace, ignore=ignore)
        if self.at_kw("VALUES", "VALUE"):
            self.next()
            while True:
                self.expect_op("(")
                row = []
                if not self.at_op(")"):
                    row.append(self.expr())
                    while self.try_op(","):
                        row.append(self.expr())
                self.expect_op(")")
                node.values.append(row)
                if not self.try_op(","):
                    break
        elif self.at_kw("SELECT", "WITH") or self.at_op("("):
            node.select = self.select_stmt()
        elif self.try_kw("SET"):
            exprs = []
            while True:
                col = self.ident()
                self.expect_op("=")
                node.columns.append(col)
                exprs.append(self.expr())
                if not self.try_op(","):
                    break
            node.values = [exprs]
        if self.try_kw("ON"):
            self.expect_kw("DUPLICATE")
            self.expect_kw("KEY")
            self.expect_kw("UPDATE")
            while True:
                col = self.ident()
                self.expect_op("=")
                node.on_dup.append((col, self.expr()))
                if not self.try_op(","):
                    break
        return node

    def _table_name(self) -> ast.TableName:
        db = None
        name = self.ident()
        if self.try_op("."):
            db, name = name, self.ident()
        return ast.TableName(db, name)

    def update_stmt(self):
        self.expect_kw("UPDATE")
        tbl = self.table_refs()
        self.expect_kw("SET")
        sets = []
        while True:
            parts = [self.ident()]
            while self.try_op("."):
                parts.append(self.ident())
            self.expect_op("=")
            sets.append((ast.Name(tuple(parts)), self.expr()))
            if not self.try_op(","):
                break
        node = ast.Update(tbl, sets)
        if self.try_kw("WHERE"):
            node.where = self.expr()
        if self.try_kw("ORDER"):
            self.expect_kw("BY")
            node.order_by = self.by_items()
        if self.try_kw("LIMIT"):
            node.limit, _ = self.limit_clause()
        return node

    def delete_stmt(self):
        self.expect_kw("DELETE")
        targets = None
        if not self.at_kw("FROM"):
            # multi-table form 1: DELETE t1[.*], t2[.*] FROM <table_refs>
            targets = [self._delete_target()]
            while self.try_op(","):
                targets.append(self._delete_target())
        self.expect_kw("FROM")
        tbl = self.table_refs()
        if self.at_kw("USING"):
            # multi-table form 2: DELETE FROM t1[, t2] USING <table_refs>
            if targets is not None:
                self.fail("USING not allowed after DELETE <tables> FROM")
            targets = []
            def leaves(n):
                if isinstance(n, ast.Join):
                    leaves(n.left)
                    leaves(n.right)
                elif isinstance(n, ast.TableName):
                    targets.append(n.name)
                else:
                    self.fail("expected table names before USING")
            leaves(tbl)
            self.next()
            tbl = self.table_refs()
        node = ast.Delete(tbl, targets=targets)
        if self.try_kw("WHERE"):
            node.where = self.expr()
        if self.try_kw("ORDER"):
            self.expect_kw("BY")
            node.order_by = self.by_items()
        if self.try_kw("LIMIT"):
            node.limit, _ = self.limit_clause()
        return node

    def lock_stmt(self):
        """LOCK TABLES t [AS alias] READ|WRITE [, ...] (ref: lock/lock.go)."""
        self.expect_kw("LOCK")
        self.expect_kw("TABLES") if self.at_kw("TABLES") else self.expect_kw("TABLE")
        items = []
        while True:
            tn = self._table_name()
            if self.try_kw("AS"):
                tn.alias = self.ident()
            if self.try_kw("READ"):
                mode = "READ"
            elif self.try_kw("WRITE"):
                mode = "WRITE"
            else:
                self.fail("expected READ or WRITE")
            items.append((tn, mode))
            if not self.try_op(","):
                break
        return ast.LockTables(items)

    def unlock_stmt(self):
        self.expect_kw("UNLOCK")
        self.expect_kw("TABLES") if self.at_kw("TABLES") else self.expect_kw("TABLE")
        return ast.UnlockTables()

    def _delete_target(self) -> str:
        """One DELETE target: name or name.* (qualifier form)."""
        name = self.ident()
        if self.try_op("."):
            self.expect_op("*")
        return name

    # --- DDL ---------------------------------------------------------------

    def user_spec(self) -> "ast.UserSpec":
        """'user'[@'host'] [IDENTIFIED BY 'pw'] (ref: parser user identity)."""
        t = self.next()
        if t.kind not in ("str", "ident", "qident"):
            self.fail("expected user name")
        host = "%"
        if self.tok.kind == "uservar":  # unquoted u@host lexes the host as @ident
            host = self.next().text[1:]
        elif self.try_op("@"):
            h = self.next()
            if h.kind not in ("str", "ident", "qident"):
                self.fail("expected host")
            host = h.text
        spec = ast.UserSpec(t.text, host)
        if self.try_kw("IDENTIFIED"):
            self.expect_kw("BY")
            pw = self.next()
            spec.password = pw.text
        return spec

    def _user_spec_list(self):
        specs = [self.user_spec()]
        while self.try_op(","):
            specs.append(self.user_spec())
        return specs

    def grant_stmt(self):
        kind = self.next().upper  # GRANT | REVOKE
        privs = []
        if self.try_kw("ALL"):
            self.try_kw("PRIVILEGES")
            privs = ["ALL"]
        else:
            while True:
                p = self.ident().upper()
                if p == "LOCK" and self.try_kw("TABLES"):
                    p = "LOCK TABLES"
                privs.append(p)
                if not self.try_op(","):
                    break
        self.expect_kw("ON")
        db = self.ident() if not self.at_op("*") else (self.next().text and "*")
        self.expect_op(".")
        tbl = self.ident() if not self.at_op("*") else (self.next().text and "*")
        self.expect_kw("TO") if kind == "GRANT" else self.expect_kw("FROM")
        users = self._user_spec_list()
        if kind == "GRANT":
            return ast.Grant(privs, db, tbl, users)
        return ast.Revoke(privs, db, tbl, users)

    def _binding_stmt(self, kind: str, global_: bool):
        """CREATE/DROP [GLOBAL] BINDING FOR <stmt> [USING <stmt>]
        (ref: bindinfo; the FOR/USING statements are captured as raw SQL
        spans so digests normalize identically to live queries)."""
        self.expect_kw("FOR")
        start = self.tok.pos
        self.statement()  # validate + advance
        if kind == "drop":
            end = self.tok.pos if not self.at("eof") else len(self.sql)
            return ast.DropBinding(self.sql[start:end].strip(), global_)
        using_tok = self.tok
        self.expect_kw("USING")
        for_sql = self.sql[start : using_tok.pos].strip()
        ustart = self.tok.pos
        self.statement()
        uend = self.tok.pos if not self.at("eof") else len(self.sql)
        return ast.CreateBinding(for_sql, self.sql[ustart:uend].strip(), global_)

    def create_stmt(self):
        self.expect_kw("CREATE")
        if self.at_kw("OR") and self.peek().upper == "REPLACE":
            self.next(); self.next()
            self.expect_kw("VIEW")
            return self._create_view(or_replace=True)
        if self.try_kw("VIEW"):
            return self._create_view(or_replace=False)
        g = self.try_kw("GLOBAL")
        if not g:
            self.try_kw("SESSION")
        if self.try_kw("BINDING"):
            return self._binding_stmt("create", g)
        if self.try_kw("USER"):
            ine = self._if_not_exists()
            return ast.CreateUser(self._user_spec_list(), ine)
        if self.try_kw("SEQUENCE"):
            ine = self._if_not_exists()
            tn = self._table_name()
            node = ast.CreateSequence(tn, if_not_exists=ine)
            while self.tok.kind == "ident":
                up = self.tok.upper
                if up == "START":
                    self.next()
                    self.try_kw("WITH")
                    node.start = self._int_bound()
                elif up == "INCREMENT":
                    self.next()
                    self.try_kw("BY")
                    node.increment = self._int_bound()
                elif up == "CACHE":
                    self.next()
                    node.cache = self._int_bound()
                elif up == "MAXVALUE":
                    self.next()
                    node.maxvalue = self._int_bound()
                elif up == "MINVALUE":
                    self.next()
                    node.minvalue = self._int_bound()
                elif up == "NOCACHE":
                    self.next()
                    node.cache = 1
                elif up == "CYCLE":
                    self.next()
                    node.cycle = True
                elif up in ("NOCYCLE", "NOMAXVALUE", "NOMINVALUE"):
                    self.next()
                else:
                    break
            return node
        if self.try_kw("RESOURCE"):
            self.expect_kw("GROUP")
            ine = self._if_not_exists()
            return ast.ResourceGroupDDL(
                "create", self.ident(), self._rg_options(), if_not_exists=ine
            )
        if self.at_kw("DATABASE", "SCHEMA"):
            self.next()
            ine = self._if_not_exists()
            name = self.ident()
            while not self.at("eof") and not self.at_op(";"):
                self.next()  # skip charset options
            return ast.CreateDatabase(name, ine)
        unique = self.try_kw("UNIQUE")
        if self.try_kw("INDEX"):
            iname = self.ident()
            self.expect_kw("ON")
            tbl = self._table_name()
            self.expect_op("(")
            cols = self.name_list()
            self.expect_op(")")
            return ast.CreateIndex(ast.IndexDef(iname, cols, unique=unique), tbl)
        temporary = self.try_kw("TEMPORARY")
        self.expect_kw("TABLE")
        ine = self._if_not_exists()
        tbl = self._table_name()
        node = ast.CreateTable(tbl, [], [], if_not_exists=ine, temporary=temporary)
        if self.try_kw("LIKE"):
            node.options["like"] = self._table_name()
            return node
        self.expect_op("(")
        while True:
            if self.at_kw("PRIMARY"):
                self.next()
                self.expect_kw("KEY")
                self.expect_op("(")
                cols = self._key_part_list()
                self.expect_op(")")
                node.indexes.append(ast.IndexDef("PRIMARY", cols, unique=True, primary=True))
            elif self.at_kw("UNIQUE"):
                self.next()
                self.try_kw("KEY") or self.try_kw("INDEX")
                iname = self.ident() if self.tok.kind in ("ident", "qident") and not self.at_op("(") else ""
                self.expect_op("(")
                cols = self._key_part_list()
                self.expect_op(")")
                node.indexes.append(ast.IndexDef(iname or f"uk_{len(node.indexes)}", cols, unique=True))
            elif self.at_kw("KEY", "INDEX"):
                self.next()
                iname = self.ident() if self.tok.kind in ("ident", "qident") and not self.at_op("(") else ""
                self.expect_op("(")
                cols = self._key_part_list()
                self.expect_op(")")
                node.indexes.append(ast.IndexDef(iname or f"idx_{len(node.indexes)}", cols))
            elif self.at_kw("CONSTRAINT", "FOREIGN", "CHECK"):
                # consume and ignore FK/CHECK constraints (parsed, not enforced)
                depth = 0
                while not self.at("eof"):
                    if self.at_op("(") :
                        depth += 1
                    elif self.at_op(")"):
                        if depth == 0:
                            break
                        depth -= 1
                    elif self.at_op(",") and depth == 0:
                        break
                    self.next()
            else:
                node.columns.append(self.column_def())
            if not self.try_op(","):
                break
        self.expect_op(")")
        # table options (the loop refuses PARTITION, parsed after it)
        while self.tok.kind == "ident" and not self.at_op(";") and not self.at_kw("PARTITION"):
            opt = self.ident().lower()
            if self.try_op("="):
                pass
            if self.tok.kind in ("ident", "qident", "num", "str"):
                node.options[opt] = self.next().text
            else:
                break
        if self.at_kw("PARTITION"):
            node.partition = self._partition_spec()
        return node

    def _list_in_values(self) -> tuple:
        """VALUES IN (n | NULL, ...) value tuple for LIST partitions."""
        self.expect_op("(")
        vals = []
        while True:
            if self.try_kw("NULL"):
                vals.append(None)
            else:
                vals.append(self._int_bound())
            if not self.try_op(","):
                break
        self.expect_op(")")
        return tuple(vals)

    def _partition_spec(self):
        """PARTITION BY HASH(col) PARTITIONS n
        | PARTITION BY RANGE (col) (PARTITION p VALUES LESS THAN (n|MAXVALUE), ...)
        | PARTITION BY LIST (col) (PARTITION p VALUES IN (n, ...), ...)"""
        self.expect_kw("PARTITION")
        self.expect_kw("BY")
        if self.try_kw("HASH"):
            self.expect_op("(")
            col = self.ident()
            self.expect_op(")")
            self.expect_kw("PARTITIONS")
            n = int(self.next().text)
            return ast.PartitionSpec("hash", col, count=n)
        if self.try_kw("LIST"):
            self.expect_op("(")
            col = self.ident()
            self.expect_op(")")
            self.expect_op("(")
            defs = []
            while True:
                self.expect_kw("PARTITION")
                name = self.ident()
                self.expect_kw("VALUES")
                self.expect_kw("IN")
                defs.append((name, self._list_in_values()))
                if not self.try_op(","):
                    break
            self.expect_op(")")
            return ast.PartitionSpec("list", col, defs=defs)
        self.expect_kw("RANGE")
        self.expect_op("(")
        col = self.ident()
        self.expect_op(")")
        self.expect_op("(")
        defs = []
        while True:
            self.expect_kw("PARTITION")
            name = self.ident()
            self.expect_kw("VALUES")
            self.expect_kw("LESS")
            self.expect_kw("THAN")
            if self.try_kw("MAXVALUE"):
                defs.append((name, None))
            else:
                self.expect_op("(")
                defs.append((name, self._int_bound()))
                self.expect_op(")")
            if not self.try_op(","):
                break
        self.expect_op(")")
        return ast.PartitionSpec("range", col, defs=defs)

    def _key_part_list(self):
        cols = []
        while True:
            c = self.ident()
            if self.try_op("("):  # prefix length — ignored
                self.next()
                self.expect_op(")")
            self.try_kw("ASC") or self.try_kw("DESC")
            cols.append(c)
            if not self.try_op(","):
                break
        return cols

    def column_def(self) -> ast.ColumnDef:
        name = self.ident()
        tname, targs, unsigned, elems, collate = self.type_spec()
        col = ast.ColumnDef(name, tname, targs, unsigned, elems=elems, collate=collate)
        while True:
            if self.try_kw("NOT"):
                self.expect_kw("NULL")
                col.not_null = True
            elif self.try_kw("NULL"):
                pass
            elif self.try_kw("DEFAULT"):
                if self.at_kw("CURRENT_TIMESTAMP", "NOW"):
                    self.next()
                    if self.try_op("("):
                        self.try_op(")") or (self.next(), self.expect_op(")"))
                    col.default = ast.Call("now", [])
                else:
                    col.default = self.unary()
            elif self.try_kw("AUTO_INCREMENT"):
                col.auto_increment = True
            elif self.try_kw("PRIMARY"):
                self.expect_kw("KEY")
                col.primary_key = True
            elif self.try_kw("UNIQUE"):
                self.try_kw("KEY")
                col.unique = True
            elif self.try_kw("KEY"):
                pass
            elif self.try_kw("COMMENT"):
                col.comment = self.next().text
            elif self.at_kw("COLLATE", "CHARACTER"):
                if self.next().upper == "CHARACTER":
                    self.expect_kw("SET")
                    self.ident()
                else:
                    col.collate = self.ident().lower()
            elif self.try_kw("ON"):
                self.expect_kw("UPDATE")
                self.unary()
                if self.try_op("("):
                    self.expect_op(")")
            else:
                break
        return col

    def _if_not_exists(self) -> bool:
        if self.try_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def drop_stmt(self):
        self.expect_kw("DROP")
        g = self.try_kw("GLOBAL")
        if not g:
            self.try_kw("SESSION")
        if self.try_kw("BINDING"):
            return self._binding_stmt("drop", g)
        if self.try_kw("USER"):
            ie = self._if_exists()
            return ast.DropUser(self._user_spec_list(), ie)
        if self.try_kw("SEQUENCE"):
            ie = self._if_exists()
            names = [self._table_name()]
            while self.try_op(","):
                names.append(self._table_name())
            return ast.DropSequence(names, ie)
        if self.try_kw("VIEW"):
            ie = self._if_exists()
            names = [self._table_name()]
            while self.try_op(","):
                names.append(self._table_name())
            return ast.DropView(names, ie)
        if self.try_kw("RESOURCE"):
            self.expect_kw("GROUP")
            ie = self._if_exists()
            return ast.ResourceGroupDDL("drop", self.ident(), {}, if_exists=ie)
        if self.at_kw("DATABASE", "SCHEMA"):
            self.next()
            ie = self._if_exists()
            return ast.DropDatabase(self.ident(), ie)
        if self.try_kw("INDEX"):
            iname = self.ident()
            self.expect_kw("ON")
            return ast.DropIndex(iname, self._table_name())
        self.expect_kw("TABLE")
        ie = self._if_exists()
        tbls = [self._table_name()]
        while self.try_op(","):
            tbls.append(self._table_name())
        return ast.DropTable(tbls, ie)

    def _if_exists(self) -> bool:
        if self.try_kw("IF"):
            self.expect_kw("EXISTS")
            return True
        return False

    def _rg_options(self) -> dict:
        """RU_PER_SEC = n | PRIORITY = LOW/MEDIUM/HIGH | BURSTABLE [= bool]
        | QUERY_LIMIT = (rules..., ACTION = ..., WATCH = '...') | QUERY_LIMIT = NULL
        (ref: parser.y ResourceGroupOptionList — the RU form plus the
        runaway QUERY_LIMIT option; the RAW mode's per-resource knobs
        have no meaning on one device mesh)."""
        spec: dict = {}
        while self.tok.kind == "ident":
            up = self.tok.upper
            if up == "RU_PER_SEC":
                self.next()
                self.try_op("=")
                spec["ru_per_sec"] = self._int_bound()
            elif up == "QUERY_LIMIT":
                self.next()
                self.try_op("=")
                spec["query_limit"] = self._rg_query_limit()
            elif up == "PRIORITY":
                self.next()
                self.try_op("=")
                p = self.ident().upper()
                if p not in ("LOW", "MEDIUM", "HIGH"):
                    self.fail(f"invalid resource group priority {p!r}")
                spec["priority"] = p
            elif up == "BURSTABLE":
                self.next()
                if self.try_op("="):
                    b = self.next().upper
                    if b in ("TRUE", "1", "ON"):
                        spec["burstable"] = True
                    elif b in ("FALSE", "0", "OFF"):
                        spec["burstable"] = False
                    else:
                        self.fail(f"invalid BURSTABLE value {b!r}")
                else:
                    spec["burstable"] = True
            else:
                break
            self.try_op(",")
        return spec

    def _rg_query_limit(self) -> dict:
        """QUERY_LIMIT = ( EXEC_ELAPSED='10s', RU=n, PROCESSED_ROWS=n,
        ACTION=DRYRUN|COOLDOWN|KILL, WATCH='60s' ) | NULL — the runaway
        watchdog spec (ref: parser.y ResourceGroupRunawayOptionList,
        WATCH collapsed to the EXACT-match digest form this store keys
        its watch list on). NULL (ALTER) clears; the parsed {} sentinel
        survives the DDL merge where None could not. Durations become
        milliseconds at parse time."""
        from ..sched.runaway import ACTIONS, parse_duration_ms

        if self.try_kw("NULL"):
            return {}
        self.expect_op("(")
        ql: dict = {}

        def dur() -> float:
            t = self.next()
            try:
                return parse_duration_ms(t.text)
            except ValueError as e:
                self.fail(str(e))

        while self.tok.kind == "ident":
            u = self.tok.upper
            if u == "EXEC_ELAPSED":
                self.next()
                self.try_op("=")
                ql["exec_elapsed_ms"] = dur()
            elif u == "RU":
                self.next()
                self.try_op("=")
                ql["ru"] = float(self._int_bound())
            elif u == "PROCESSED_ROWS":
                self.next()
                self.try_op("=")
                ql["processed_rows"] = self._int_bound()
            elif u == "ACTION":
                self.next()
                self.try_op("=")
                a = self.ident().upper()
                if a not in ACTIONS:
                    self.fail(f"invalid QUERY_LIMIT action {a!r}")
                ql["action"] = a
            elif u == "WATCH":
                self.next()
                self.try_op("=")
                ql["watch_ms"] = dur()
            else:
                self.fail(f"unknown QUERY_LIMIT option {self.tok.text!r}")
            self.try_op(",")
        self.expect_op(")")
        if not any(k in ql for k in ("exec_elapsed_ms", "ru", "processed_rows")):
            self.fail("QUERY_LIMIT needs at least one rule "
                      "(EXEC_ELAPSED / RU / PROCESSED_ROWS)")
        return ql

    def alter_stmt(self):
        self.expect_kw("ALTER")
        if self.try_kw("RESOURCE"):
            self.expect_kw("GROUP")
            return ast.ResourceGroupDDL("alter", self.ident(), self._rg_options())
        self.expect_kw("TABLE")
        tbl = self._table_name()
        actions = []
        while True:
            if self.try_kw("ADD"):
                if self.at_kw("PARTITION"):
                    self.next()
                    self.expect_op("(")
                    defs = []
                    while True:
                        self.expect_kw("PARTITION")
                        pname = self.ident()
                        self.expect_kw("VALUES")
                        if self.try_kw("IN"):  # LIST partition
                            defs.append((pname, ("in", self._list_in_values())))
                        else:
                            self.expect_kw("LESS")
                            self.expect_kw("THAN")
                            if self.try_kw("MAXVALUE"):
                                defs.append((pname, None))
                            else:
                                self.expect_op("(")
                                defs.append((pname, self._int_bound()))
                                self.expect_op(")")
                        if not self.try_op(","):
                            break
                    self.expect_op(")")
                    actions.append(("add_partition", defs))
                elif self.try_kw("INDEX") or self.try_kw("KEY"):
                    iname = self.ident() if not self.at_op("(") else ""
                    self.expect_op("(")
                    cols = self._key_part_list()
                    self.expect_op(")")
                    actions.append(("add_index", ast.IndexDef(iname or "idx", cols)))
                elif self.try_kw("UNIQUE"):
                    self.try_kw("INDEX") or self.try_kw("KEY")
                    iname = self.ident() if not self.at_op("(") else ""
                    self.expect_op("(")
                    cols = self._key_part_list()
                    self.expect_op(")")
                    actions.append(("add_index", ast.IndexDef(iname or "uk", cols, unique=True)))
                elif self.try_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    self.expect_op("(")
                    cols = self._key_part_list()
                    self.expect_op(")")
                    actions.append(("add_index", ast.IndexDef("PRIMARY", cols, unique=True, primary=True)))
                else:
                    self.try_kw("COLUMN")
                    actions.append(("add_column", self.column_def()))
            elif self.try_kw("DROP"):
                if self.at_kw("PARTITION"):
                    self.next()
                    actions.append(("drop_partition", self._partition_name_list()))
                elif self.try_kw("INDEX") or self.try_kw("KEY"):
                    actions.append(("drop_index", self.ident()))
                elif self.try_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    actions.append(("drop_index", "PRIMARY"))
                else:
                    self.try_kw("COLUMN")
                    actions.append(("drop_column", self.ident()))
            elif self.at_kw("TRUNCATE"):
                self.next()
                self.expect_kw("PARTITION")
                actions.append(("truncate_partition", self._partition_name_list()))
            elif self.try_kw("MODIFY"):
                self.try_kw("COLUMN")
                actions.append(("modify_column", self.column_def()))
            elif self.try_kw("RENAME"):
                self.try_kw("TO") or self.try_kw("AS")
                actions.append(("rename", self._table_name()))
            else:
                self.fail("unsupported ALTER action")
            if not self.try_op(","):
                break
        return ast.AlterTable(tbl, actions)

    def _create_view(self, or_replace: bool):
        """CREATE [OR REPLACE] VIEW v [(cols)] AS <select> — the SELECT is
        stored as SQL text and re-planned at reference time (ref:
        ddl_api.go CreateView; plans always see the current schema)."""
        tn = self._table_name()
        cols = []
        if self.try_op("("):
            cols = self.name_list()
            self.expect_op(")")
        self.expect_kw("AS")
        start = self.tok.pos
        self.select_stmt()  # validate + advance
        end = self.tok.pos if not self.at("eof") else len(self.sql)
        return ast.CreateView(tn, cols, self.sql[start:end].strip(), or_replace)

    def _str_lit(self, what: str) -> str:
        t = self.tok
        if t.kind != "str":
            self.fail(f"expected {what} string literal")
        self.next()
        return t.text

    def _int_bound(self) -> int:
        """Integer partition bound; non-integer bounds are a parse error,
        not a Python exception."""
        neg = bool(self.try_op("-"))
        t = self.tok
        if t.kind != "num" or not t.text.lstrip("-").isdigit():
            self.fail("expected integer partition bound")
        self.next()
        return -int(t.text) if neg else int(t.text)

    _ALTER_ACTION_KWS = {"ADD", "DROP", "MODIFY", "RENAME", "TRUNCATE", "CHANGE"}

    def _partition_name_list(self) -> list[str]:
        """Partition idents; a comma followed by an action keyword ends
        the list (the actions loop owns that comma)."""
        names = [self.ident()]
        while self.at_op(",") and self.peek().kind == "ident" and self.peek().upper not in self._ALTER_ACTION_KWS:
            self.next()
            names.append(self.ident())
        return names

    def truncate_stmt(self):
        self.expect_kw("TRUNCATE")
        self.try_kw("TABLE")
        return ast.TruncateTable(self._table_name())

    def rename_stmt(self):
        self.expect_kw("RENAME")
        self.expect_kw("TABLE")
        old = self._table_name()
        self.expect_kw("TO")
        new = self._table_name()
        return ast.AlterTable(old, [("rename", new)])

    # --- session / admin ----------------------------------------------------

    def begin_stmt(self):
        if self.tok.upper == "START":
            self.next()
            self.expect_kw("TRANSACTION")
        else:
            self.next()
        mode = ""
        if self.try_kw("PESSIMISTIC"):
            mode = "pessimistic"
        elif self.try_kw("OPTIMISTIC"):
            mode = "optimistic"
        return ast.Begin(mode)

    def set_stmt(self):
        self.expect_kw("SET")
        if self.try_kw("NAMES"):
            self.next()
            return ast.SetStmt([])
        if self.at_kw("RESOURCE") and self.peek().upper == "GROUP":
            self.next()
            self.next()
            return ast.SetResourceGroup(self.ident())
        assignments = []
        while True:
            scope = "session"
            if self.try_kw("GLOBAL"):
                scope = "global"
            elif self.try_kw("SESSION") or self.try_kw("LOCAL"):
                scope = "session"
            t = self.tok
            if t.kind == "sysvar":
                self.next()
                name = t.text[2:].lower()
                if name.startswith("global."):
                    scope, name = "global", name[7:]
                elif name.startswith("session."):
                    name = name[8:]
            elif t.kind == "uservar":
                self.next()
                name = t.text
            else:
                name = self.ident().lower()
            self.try_op("=") or self.try_op(":=") or self.fail("expected =")
            if self.at_kw("ON", "OFF") and self.peek().kind in ("op", "eof") and (self.peek().text in (",", ";", "")):
                val = ast.Lit(self.next().text, "str")
            else:
                val = self.expr()
            assignments.append((scope, name, val))
            if not self.try_op(","):
                break
        return ast.SetStmt(assignments)

    def show_stmt(self):
        self.expect_kw("SHOW")
        full = self.try_kw("FULL")
        glob = self.try_kw("GLOBAL")
        self.try_kw("SESSION")
        node = ast.Show("", full=full, global_scope=glob)
        if self.try_kw("TABLES"):
            node.kind = "tables"
            if self.try_kw("FROM") or self.try_kw("IN"):
                node.target = self.ident()
        elif self.try_kw("DATABASES") or self.try_kw("SCHEMAS"):
            node.kind = "databases"
        elif self.try_kw("BINDINGS"):
            node.kind = "bindings"
        elif self.try_kw("RESOURCE"):
            self.expect_kw("GROUPS")
            node.kind = "resource_groups"
        elif self.try_kw("GRANTS"):
            node.kind = "grants"
            if self.try_kw("FOR"):
                node.target = self.user_spec()
        elif self.try_kw("CREATE"):
            self.expect_kw("TABLE")
            node.kind = "create_table"
            node.target = self._table_name()
        elif self.try_kw("STATS_META"):
            node.kind = "stats_meta"
        elif self.try_kw("STATS_HISTOGRAMS"):
            node.kind = "stats_histograms"
        elif self.try_kw("VARIABLES"):
            node.kind = "variables"
        elif self.try_kw("COLUMNS") or self.try_kw("FIELDS"):
            node.kind = "columns"
            self.try_kw("FROM") or self.try_kw("IN")
            node.target = self._table_name()
        elif self.try_kw("INDEX") or self.try_kw("INDEXES") or self.try_kw("KEYS"):
            node.kind = "index"
            self.try_kw("FROM") or self.try_kw("IN")
            node.target = self._table_name()
        elif self.try_kw("STATUS"):
            node.kind = "status"
        elif self.try_kw("WARNINGS"):
            node.kind = "warnings"
        elif self.try_kw("PROCESSLIST"):
            node.kind = "processlist"
        elif self.try_kw("ENGINES"):
            node.kind = "engines"
        elif self.try_kw("COLLATION"):
            node.kind = "collation"
        elif self.try_kw("CHARSET") or (self.try_kw("CHARACTER") and self.expect_kw("SET")):
            node.kind = "charset"
        elif self.try_kw("BINDINGS"):
            node.kind = "bindings"
        elif self.try_kw("GRANTS"):
            node.kind = "grants"
            while not self.at("eof") and not self.at_op(";"):
                self.next()
        elif self.try_kw("STATS_META"):
            node.kind = "stats_meta"
        elif self.try_kw("STATS_HISTOGRAMS"):
            node.kind = "stats_histograms"
        elif self.try_kw("TABLE"):
            self.expect_kw("STATUS")
            node.kind = "table_status"
        else:
            self.fail("unsupported SHOW")
        if self.try_kw("LIKE"):
            node.like = self.expr()
        elif self.try_kw("WHERE"):
            node.where = self.expr()
        return node

    def trace_stmt(self):
        """TRACE [FORMAT = 'row'] <stmt> (ref: executor/trace.go TraceExec:
        renders the statement's span tree as rows)."""
        self.expect_kw("TRACE")
        if self.try_kw("FORMAT"):
            self.expect_op("=")
            fmt = self._str_lit("trace format")
            if fmt.lower() != "row":
                self.fail(f"unsupported TRACE format {fmt!r} (only 'row')")
        return ast.TraceStmt(self.statement())

    def explain_stmt(self):
        self.next()
        analyze = self.try_kw("ANALYZE")
        fmt = "row"
        if self.try_kw("FORMAT"):
            self.expect_op("=")
            fmt = self.next().text.lower()
        if self.at_kw("SELECT", "INSERT", "UPDATE", "DELETE", "REPLACE", "WITH") or self.at_op("("):
            start = self.tok.pos
            inner = self.statement()
            end = self.tok.pos if not self.at("eof") else len(self.sql)
            node = ast.Explain(inner, analyze=analyze, format=fmt)
            node.inner_sql = self.sql[start:end].strip()
            return node
        # EXPLAIN <table> == DESC <table>
        return ast.Show("columns", target=self._table_name())

    def desc_stmt(self):
        self.next()
        if self.at_kw("SELECT", "INSERT", "UPDATE", "DELETE", "WITH"):
            return ast.Explain(self.statement())
        return ast.Show("columns", target=self._table_name())

    def use_stmt(self):
        self.expect_kw("USE")
        return ast.UseDB(self.ident())

    def analyze_stmt(self):
        self.expect_kw("ANALYZE")
        self.expect_kw("TABLE")
        tbls = [self._table_name()]
        while self.try_op(","):
            tbls.append(self._table_name())
        return ast.AnalyzeTable(tbls)

    def prepare_stmt(self):
        self.expect_kw("PREPARE")
        name = self.ident()
        self.expect_kw("FROM")
        t = self.next()
        if t.kind == "uservar":
            return ast.Prepare(name, None, from_var=t.text.lower())
        if t.kind != "str":
            self.fail("PREPARE ... FROM expects a string literal or @user_var")
        return ast.Prepare(name, t.text)  # str tokens are already unquoted

    def execute_stmt(self):
        self.expect_kw("EXECUTE")
        name = self.ident()
        using = []
        if self.try_kw("USING"):
            while True:
                t = self.next()
                if t.kind != "uservar":
                    self.fail("EXECUTE ... USING expects @user_var arguments")
                using.append(t.text)
                if not self.try_op(","):
                    break
        return ast.Execute(name, using)

    def deallocate_stmt(self):
        self.expect_kw("DEALLOCATE")
        self.expect_kw("PREPARE")
        return ast.Deallocate(self.ident())

    def admin_stmt(self):
        self.expect_kw("ADMIN")
        if self.try_kw("CHECK"):
            self.expect_kw("TABLE")
            return ast.AdminStmt("check_table", self._table_name())
        if self.try_kw("CHECKSUM"):
            self.expect_kw("TABLE")
            return ast.AdminStmt("checksum_table", self._table_name())
        if self.try_kw("SHOW"):
            if self.try_kw("DDL"):
                if self.try_kw("JOBS"):
                    return ast.AdminStmt("show_ddl_jobs")
                return ast.AdminStmt("show_ddl")
        if self.try_kw("CANCEL"):
            self.expect_kw("DDL")
            self.expect_kw("JOBS")
            ids = [int(self.next().text)]
            while self.try_op(","):
                ids.append(int(self.next().text))
            return ast.AdminStmt("cancel_ddl_jobs", ids)
        if self.try_kw("RECOVER"):
            self.expect_kw("INDEX")
            tbl = self._table_name()
            idx = self.ident()
            return ast.AdminStmt("recover_index", (tbl, idx))
        if self.try_kw("CLEANUP"):
            self.expect_kw("INDEX")
            tbl = self._table_name()
            idx = self.ident()
            return ast.AdminStmt("cleanup_index", (tbl, idx))
        if self.try_kw("PROMOTE"):
            # ADMIN PROMOTE: flip a warm standby read-write
            return ast.AdminStmt("promote")
        if self.try_kw("REJOIN"):
            # ADMIN REJOIN: rebuild a fenced old primary as a standby of the
            # promoted new primary
            return ast.AdminStmt("rejoin")
        self.fail("unsupported ADMIN")

    def kill_stmt(self):
        self.expect_kw("KILL")
        self.try_kw("TIDB") or self.try_kw("CONNECTION")
        qo = self.try_kw("QUERY")
        return ast.KillStmt(int(self.next().text), query_only=qo)

    def flush_stmt(self):
        self.expect_kw("FLUSH")
        what = []
        while not self.at("eof") and not self.at_op(";"):
            what.append(self.next().text)
        return ast.FlushStmt(" ".join(what))

    def load_stmt(self):
        self.expect_kw("LOAD")
        if self.try_kw("STATS"):
            # LOAD STATS 'dump.json' (ref: executor/load_stats.go)
            t = self.next()
            if t.kind != "str":
                self.fail("expected stats dump path string")
            return ast.LoadStats(t.text)
        self.expect_kw("DATA")
        self.try_kw("LOCAL")
        self.expect_kw("INFILE")
        path = self.next().text
        self.try_kw("IGNORE") or self.try_kw("REPLACE")
        self.expect_kw("INTO")
        self.expect_kw("TABLE")
        tbl = self._table_name()
        node = ast.LoadData(path, tbl)
        if self.try_kw("FIELDS") or self.try_kw("COLUMNS"):
            if self.try_kw("TERMINATED"):
                self.expect_kw("BY")
                node.fields_terminated = self.next().text
            if self.try_kw("ENCLOSED") or (self.try_kw("OPTIONALLY") and self.expect_kw("ENCLOSED")):
                self.expect_kw("BY")
                node.enclosed = self.next().text
        if self.try_kw("LINES"):
            self.expect_kw("TERMINATED")
            self.expect_kw("BY")
            node.lines_terminated = self.next().text
        if self.try_kw("IGNORE"):
            node.ignore_lines = int(self.next().text)
            self.try_kw("LINES") or self.try_kw("ROWS")
        if self.try_op("("):
            node.columns = self.name_list()
            self.expect_op(")")
        if self.try_kw("WITH"):
            # TiDB LOAD DATA options: WITH bulk_ingest=1, batch_size=4096
            while True:
                name = self.next().text.lower()
                self.expect_op("=")
                node.options[name] = self.next().text
                if not self.try_op(","):
                    break
        return node

    def split_stmt(self):
        self.expect_kw("SPLIT")
        self.expect_kw("TABLE")
        tbl = self._table_name()
        node = ast.SplitRegion(tbl)
        if self.try_kw("BETWEEN"):
            self.expect_op("(")
            lo = [self.expr()]
            while self.try_op(","):
                lo.append(self.expr())
            self.expect_op(")")
            self.expect_kw("AND")
            self.expect_op("(")
            hi = [self.expr()]
            while self.try_op(","):
                hi.append(self.expr())
            self.expect_op(")")
            self.expect_kw("REGIONS")
            node.between = (lo, hi, int(self.next().text))
        elif self.try_kw("BY"):
            while self.try_op("("):
                vals = [self.expr()]
                while self.try_op(","):
                    vals.append(self.expr())
                self.expect_op(")")
                node.by.append(vals)
                if not self.try_op(","):
                    break
        return node

    def brie_stmt(self):
        kind = self.next().upper.lower()
        node = ast.BRIEStmt(kind)
        if self.try_kw("DATABASE"):
            if self.try_op("*"):
                pass
            else:
                node.databases.append(self.ident())
                while self.try_op(","):
                    node.databases.append(self.ident())
        self.expect_kw("TO") if kind == "backup" else self.expect_kw("FROM")
        node.storage = self.next().text
        return node
