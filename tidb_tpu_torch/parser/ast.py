"""SQL AST nodes (copy of tidb_tpu/parser/ast.py; ref: pingcap/parser ast package — fresh design).

Nodes are plain dataclasses; the planner walks them. Every expression node
carries no type — typing happens at plan-build (name resolution) time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


# --- expressions -----------------------------------------------------------


@dataclass
class Lit:
    """Literal: int, Dec, float, str, bytes, None (NULL), bool."""

    value: Any
    kind: str  # 'int' | 'dec' | 'float' | 'str' | 'hex' | 'null' | 'bool'


@dataclass
class Name:
    """Column reference: [db.][table.]column; '*' handled by Star."""

    parts: tuple  # (col,) or (tbl, col) or (db, tbl, col)

    @property
    def column(self) -> str:
        return self.parts[-1]

    @property
    def table(self) -> str | None:
        return self.parts[-2] if len(self.parts) >= 2 else None


@dataclass
class Star:
    table: str | None = None  # t.* keeps the qualifier


@dataclass
class FrameBound:
    """One window frame edge (ref: parser ast FrameBound).
    kind: 'up' UNBOUNDED PRECEDING | 'pre' n PRECEDING | 'cur' CURRENT ROW
        | 'fol' n FOLLOWING | 'uf' UNBOUNDED FOLLOWING."""

    kind: str
    offset: Any = None  # expr for 'pre'/'fol'


@dataclass
class FrameSpec:
    """ROWS/RANGE frame clause (ref: parser ast FrameClause)."""

    unit: str  # 'rows' | 'range'
    start: FrameBound
    end: FrameBound


@dataclass
class WindowSpec:
    """OVER (...) clause (ref: parser ast WindowSpec)."""

    partition_by: list
    order_by: list  # ByItem
    frame: FrameSpec | None = None


@dataclass
class Call:
    """Function call, incl. operators desugared to calls (plus, eq, ...)."""

    name: str
    args: list
    distinct: bool = False  # COUNT(DISTINCT x)
    over: Any = None  # WindowSpec for window function calls


@dataclass
class CaseWhen:
    operand: Any  # CASE <operand> WHEN ... or None for searched CASE
    whens: list  # [(cond, result), ...]
    else_: Any = None


@dataclass
class Cast:
    expr: Any
    type_name: str
    type_args: tuple = ()
    unsigned: bool = False


@dataclass
class SubqueryExpr:
    select: "Select"
    modifier: str = "scalar"  # 'scalar' | 'exists' | 'in' | 'any' | 'all'


@dataclass
class Param:
    """Prepared-statement placeholder '?' (ordinal)."""

    index: int


@dataclass
class Default:
    """DEFAULT keyword in INSERT/UPDATE value position."""


@dataclass
class Interval:
    expr: Any
    unit: str  # 'day' | 'month' | 'year' | ...


# --- table references ------------------------------------------------------


@dataclass
class TableName:
    db: str | None
    name: str
    alias: str | None = None
    index_hints: list = field(default_factory=list)
    as_of: Any = None  # AS OF TIMESTAMP expr (ref: stale read)


@dataclass
class SubqueryTable:
    select: "Select"
    alias: str


@dataclass
class Join:
    left: Any
    right: Any
    kind: str  # 'inner' | 'left' | 'right' | 'cross'
    on: Any = None
    using: list = field(default_factory=list)
    straight: bool = False  # STRAIGHT_JOIN: written order is pinned


# --- statements ------------------------------------------------------------


@dataclass
class CTEDef:
    """One WITH-clause table (ref: parser ast CommonTableExpression)."""

    name: str
    cols: list  # optional explicit column names
    select: Any  # Select | SetOpSelect


@dataclass
class WithClause:
    recursive: bool
    ctes: list  # [CTEDef]


@dataclass
class SelectField:
    expr: Any
    alias: str | None = None


@dataclass
class ByItem:
    expr: Any
    desc: bool = False


@dataclass
class Select:
    fields: list  # [SelectField | Star]
    from_: Any = None  # TableName | Join | SubqueryTable | None
    where: Any = None
    group_by: list = field(default_factory=list)
    having: Any = None
    order_by: list = field(default_factory=list)  # [ByItem]
    limit: Any = None  # int expr or None
    offset: Any = None
    distinct: bool = False
    for_update: bool = False
    lock_in_share: bool = False
    windows: list = field(default_factory=list)
    setop: Any = None  # ('union'|'union all'|..., Select) chained
    with_: Any = None  # WithClause
    hints: list = field(default_factory=list)  # [(NAME, [args])]
    into_outfile: str | None = None  # SELECT ... INTO OUTFILE
    outfile_fsep: str = "\t"
    outfile_lsep: str = "\n"
    as_of: Any = None  # AS OF TIMESTAMP expr (stale read), hoisted from FROM


@dataclass
class SetOpSelect:
    """UNION / UNION ALL / EXCEPT / INTERSECT chain."""

    selects: list  # [Select]
    ops: list  # between selects: 'union' | 'union_all' | ...
    order_by: list = field(default_factory=list)
    limit: Any = None
    offset: Any = None
    with_: Any = None  # WithClause
    into_outfile: str | None = None  # hoisted from the last branch
    outfile_fsep: str = "\t"
    outfile_lsep: str = "\n"


@dataclass
class Insert:
    table: TableName
    columns: list  # [str] or []
    values: list  # [[expr,...], ...]
    select: Any = None  # INSERT ... SELECT
    on_dup: list = field(default_factory=list)  # [(col, expr)]
    replace: bool = False
    ignore: bool = False


@dataclass
class Update:
    table: Any  # TableName or Join
    sets: list  # [(Name, expr)]
    where: Any = None
    order_by: list = field(default_factory=list)
    limit: Any = None


@dataclass
class Delete:
    table: Any
    where: Any = None
    order_by: list = field(default_factory=list)
    limit: Any = None
    targets: list | None = None  # multi-table: names/aliases to delete from


@dataclass
class ColumnDef:
    name: str
    type_name: str
    type_args: tuple = ()
    unsigned: bool = False
    not_null: bool = False
    default: Any = None
    auto_increment: bool = False
    primary_key: bool = False
    unique: bool = False
    comment: str = ""
    elems: tuple = ()
    collate: str = ""


@dataclass
class IndexDef:
    name: str
    columns: list  # [str]
    unique: bool = False
    primary: bool = False


@dataclass
class PartitionSpec:
    type: str  # 'hash' | 'range'
    col: str
    count: int = 0  # hash partition count
    defs: list = field(default_factory=list)  # [(name, bound_int | None)]


@dataclass
class CreateTable:
    table: TableName
    columns: list  # [ColumnDef]
    indexes: list  # [IndexDef]
    if_not_exists: bool = False
    options: dict = field(default_factory=dict)
    partition: PartitionSpec | None = None
    temporary: bool = False  # session-local, shadows permanent names


@dataclass
class DropTable:
    tables: list
    if_exists: bool = False


@dataclass
class TruncateTable:
    table: TableName


@dataclass
class CreateIndex:
    index: IndexDef
    table: TableName


@dataclass
class DropIndex:
    name: str
    table: TableName


@dataclass
class AlterTable:
    table: TableName
    actions: list  # [('add_column', ColumnDef) | ('drop_column', str) | ('add_index', IndexDef) | ('drop_index', str) | ('rename', TableName) | ('modify_column', ColumnDef)]


@dataclass
class CreateDatabase:
    name: str
    if_not_exists: bool = False


@dataclass
class DropDatabase:
    name: str
    if_exists: bool = False


@dataclass
class UseDB:
    name: str


@dataclass
class Begin:
    mode: str = ""  # '' (session default) | 'pessimistic' | 'optimistic'


@dataclass
class Commit:
    pass


@dataclass
class Rollback:
    pass


@dataclass
class SetStmt:
    assignments: list  # [(scope, name, expr)] scope in {'session','global'}


@dataclass
class Show:
    kind: str  # 'tables' | 'databases' | 'create_table' | 'variables' | 'columns' | 'index' | 'status' | 'warnings' | 'processlist'
    target: Any = None
    like: Any = None
    where: Any = None
    full: bool = False
    global_scope: bool = False


@dataclass
class Explain:
    stmt: Any
    analyze: bool = False
    format: str = "row"


@dataclass
class AnalyzeTable:
    tables: list


@dataclass
class Prepare:
    name: str
    sql: str | None
    from_var: str | None = None  # PREPARE name FROM @var


@dataclass
class Execute:
    name: str
    using: list = field(default_factory=list)


@dataclass
class Deallocate:
    name: str


@dataclass
class AdminStmt:
    kind: str  # 'check_table' | 'show_ddl' | 'show_ddl_jobs' | 'checksum_table' | 'cancel_ddl_jobs' | 'recover_index'
    target: Any = None


@dataclass
class CreateView:
    table: Any  # TableName
    cols: list  # optional explicit column names
    select_sql: str  # stored definition text
    or_replace: bool = False


@dataclass
class DropView:
    names: list  # [TableName]
    if_exists: bool = False


@dataclass
class CreateSequence:
    table: Any  # TableName (sequences share the table namespace)
    start: int = 1
    increment: int = 1
    cache: int = 1000
    maxvalue: int | None = None
    minvalue: int | None = None
    cycle: bool = False
    if_not_exists: bool = False


@dataclass
class DropSequence:
    names: list  # [TableName]
    if_exists: bool = False


@dataclass
class ResourceGroupDDL:
    """CREATE/ALTER/DROP RESOURCE GROUP (ref: ast ResourceGroupStmt;
    `spec` holds only the options the statement named — ALTER merges)."""

    kind: str  # 'create' | 'alter' | 'drop'
    name: str
    spec: dict = field(default_factory=dict)  # ru_per_sec / priority / burstable
    if_not_exists: bool = False
    if_exists: bool = False


@dataclass
class SetResourceGroup:
    """SET RESOURCE GROUP name — rebind the session mid-flight
    (ref: ast.SetResourceGroupStmt)."""

    name: str


@dataclass
class LoadStats:
    path: str


@dataclass
class LockTables:
    tables: list  # [(TableName, 'READ'|'WRITE')]


@dataclass
class UnlockTables:
    pass


@dataclass
class TraceStmt:
    stmt: Any  # traced inner statement


@dataclass
class KillStmt:
    conn_id: int
    query_only: bool = False


@dataclass
class FlushStmt:
    what: str = ""


@dataclass
class LoadData:
    path: str
    table: TableName
    fields_terminated: str = "\t"
    lines_terminated: str = "\n"
    enclosed: str = ""
    ignore_lines: int = 0
    columns: list = field(default_factory=list)
    # WITH key=value options (TiDB LOAD DATA ... WITH syntax):
    # bulk_ingest=0|1 overrides the tidb_bulk_ingest sysvar per
    # statement; batch_size=N sizes the legacy path's txn batches
    options: dict = field(default_factory=dict)


@dataclass
class SplitRegion:
    table: TableName
    between: tuple | None = None  # (lower expr list, upper expr list, regions int)
    by: list = field(default_factory=list)


@dataclass
class CreateBinding:
    for_sql: str
    using_sql: str
    global_: bool = True


@dataclass
class DropBinding:
    for_sql: str
    global_: bool = True


@dataclass
class UserSpec:
    user: str
    host: str = "%"
    password: str | None = None

    @property
    def key(self) -> str:
        return f"{self.user}@{self.host}"


@dataclass
class CreateUser:
    users: list  # [UserSpec]
    if_not_exists: bool = False


@dataclass
class DropUser:
    users: list
    if_exists: bool = False


@dataclass
class Grant:
    privs: list  # ['ALL'] or ['SELECT', ...]
    db: str  # '*' for global
    table: str  # '*' (table granularity folds into db level)
    users: list  # [UserSpec]


@dataclass
class Revoke:
    privs: list
    db: str
    table: str
    users: list


@dataclass
class BRIEStmt:
    kind: str  # 'backup' | 'restore'
    storage: str = ""
    databases: list = field(default_factory=list)
