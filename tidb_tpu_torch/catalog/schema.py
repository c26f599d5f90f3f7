"""Schema objects + InfoSchema cache (copy of tidb_tpu/catalog/schema.py;
ref: infoschema/, parser/model).

TableInfo/ColumnInfo/IndexInfo serialize to JSON into the meta KV layout
(meta.py) and are cached per schema version in InfoSchema.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..errors import UnknownColumn, UnknownTable, UnknownDatabase
from ..mysqltypes.field_type import FieldType, TypeCode


@dataclass
class ColumnInfo:
    id: int
    name: str
    ft: FieldType
    offset: int
    default: object = None  # rendered default (python value) or None
    has_default: bool = False
    auto_increment: bool = False
    hidden: bool = False
    comment: str = ""

    def to_json(self):
        return {
            "id": self.id,
            "name": self.name,
            "tp": int(self.ft.tp),
            "flag": self.ft.flag,
            "flen": self.ft.flen,
            "decimal": self.ft.decimal,
            "elems": list(self.ft.elems),
            "collate": self.ft.collate,
            "offset": self.offset,
            "default": self.default,
            "has_default": self.has_default,
            "auto_increment": self.auto_increment,
            "hidden": self.hidden,
            "comment": self.comment,
        }

    @staticmethod
    def from_json(d):
        ft = FieldType(TypeCode(d["tp"]), d["flag"], d["flen"], d["decimal"], elems=tuple(d.get("elems", ())))
        ft.collate = d.get("collate", "utf8mb4_bin")
        return ColumnInfo(
            d["id"], d["name"], ft, d["offset"], d.get("default"), d.get("has_default", False),
            d.get("auto_increment", False), d.get("hidden", False), d.get("comment", ""),
        )


@dataclass
class IndexInfo:
    id: int
    name: str
    col_offsets: list[int]
    unique: bool = False
    primary: bool = False
    state: str = "public"  # online DDL states: delete_only/write_only/write_reorg/public

    def to_json(self):
        return {"id": self.id, "name": self.name, "cols": self.col_offsets, "unique": self.unique, "primary": self.primary, "state": self.state}

    @staticmethod
    def from_json(d):
        return IndexInfo(d["id"], d["name"], d["cols"], d["unique"], d["primary"], d.get("state", "public"))


@dataclass
class PartitionDef:
    """One partition: its own physical keyspace id (ref: model
    PartitionDefinition — each partition is a physical table)."""

    id: int
    name: str
    less_than: int | None = None  # RANGE bound; None = MAXVALUE / hash
    in_values: tuple | None = None  # LIST membership (may contain None=NULL)

    def to_json(self):
        return {"id": self.id, "name": self.name, "less_than": self.less_than,
                "in_values": list(self.in_values) if self.in_values is not None else None}

    @staticmethod
    def from_json(d):
        iv = d.get("in_values")
        return PartitionDef(d["id"], d["name"], d.get("less_than"),
                            tuple(iv) if iv is not None else None)


@dataclass
class PartitionInfo:
    """HASH / RANGE / LIST partitioning over one integer column (ref:
    model PartitionInfo + table/tables/partition.go locatePartition /
    locateListPartition)."""

    type: str  # 'hash' | 'range' | 'list'
    col: str  # partitioning column name
    defs: list[PartitionDef] = field(default_factory=list)

    def locate(self, v) -> PartitionDef:
        """Partition for one partition-column value. NULLs go to
        partition 0 for hash, the first range partition for range
        (MySQL: NULL sorts below every bound); LIST requires a partition
        that lists NULL explicitly."""
        from ..errors import TiDBError

        if self.type == "list":
            key = None if v is None else int(v)
            for pd in self.defs:
                if pd.in_values is not None and key in pd.in_values:
                    return pd
            raise TiDBError(
                "Table has no partition for value "
                + ("NULL" if v is None else str(int(v)))
            )
        if v is None:
            return self.defs[0]
        v = int(v)
        if self.type == "hash":
            # MySQL/TiDB use truncated modulo then abs (locateHashPartition,
            # ref table/tables/partition.go): -1 % 4 → p1, not Python's p3.
            # abs(v) % n IS truncated-mod-then-abs in exact int arithmetic.
            return self.defs[abs(v) % len(self.defs)]
        for pd in self.defs:
            if pd.less_than is None or v < pd.less_than:
                return pd
        raise TiDBError(f"Table has no partition for value {v}")

    def prune(self, eq_values=None, lo=None, hi=None) -> list[PartitionDef]:
        """Partitions that can contain rows matching the constraint:
        either an equality value set, or a [lo, hi] closed interval on the
        partition column (range partitioning only for intervals)."""
        if eq_values is not None:
            out, seen = [], set()
            for v in eq_values:
                try:
                    pd = self.locate(v)
                except Exception:  # value beyond the last range bound
                    continue
                if pd.id not in seen:
                    seen.add(pd.id)
                    out.append(pd)
            return out
        if self.type == "list" and (lo is not None or hi is not None):
            # a LIST partition can match iff some listed value intersects
            # the interval (rule_partition_processor.go list pruning)
            return [
                pd for pd in self.defs
                if pd.in_values and any(
                    x is not None
                    and (lo is None or x >= lo)
                    and (hi is None or x <= hi)
                    for x in pd.in_values
                )
            ]
        if self.type == "range" and (lo is not None or hi is not None):
            out = []
            prev_bound = None
            for pd in self.defs:
                # partition covers [prev_bound, less_than)
                if hi is not None and prev_bound is not None and hi < prev_bound:
                    break
                if lo is None or pd.less_than is None or lo < pd.less_than:
                    out.append(pd)
                prev_bound = pd.less_than
            return out
        return list(self.defs)

    def to_json(self):
        return {"type": self.type, "col": self.col, "defs": [d.to_json() for d in self.defs]}

    @staticmethod
    def from_json(d):
        return PartitionInfo(d["type"], d["col"], [PartitionDef.from_json(x) for x in d["defs"]])


@dataclass
class TableInfo:
    id: int
    name: str
    columns: list[ColumnInfo]
    indexes: list[IndexInfo] = field(default_factory=list)
    pk_is_handle: bool = False  # clustered single-int PK == row handle
    auto_inc_id: int = 1
    state: str = "public"
    db_name: str = ""
    partition: PartitionInfo | None = None

    def col_by_name(self, name: str) -> ColumnInfo:
        lname = name.lower()
        for c in self.columns:
            if c.name.lower() == lname:
                return c
        raise UnknownColumn(f"unknown column {name!r} in {self.name!r}")

    def visible_columns(self) -> list[ColumnInfo]:
        return [c for c in self.columns if not c.hidden]

    def handle_col(self) -> ColumnInfo | None:
        if self.pk_is_handle:
            pk = next((i for i in self.indexes if i.primary), None)
            if pk:
                return self.columns[pk.col_offsets[0]]
        return next((c for c in self.columns if c.name == "_tidb_rowid"), None)

    def index_by_name(self, name: str) -> IndexInfo | None:
        lname = name.lower()
        return next((i for i in self.indexes if i.name.lower() == lname), None)

    def physical_ids(self) -> list[int]:
        """Keyspace ids holding this table's rows (partition ids, or the
        table's own id when unpartitioned)."""
        if self.partition is not None:
            return [pd.id for pd in self.partition.defs]
        return [self.id]

    def partition_physical(self, pid: int) -> "TableInfo":
        """Physical TableInfo for one partition: identical schema, the
        partition's keyspace id (ref: tables/partition.go
        GetPartition)."""
        cache = self.__dict__.setdefault("_phys_cache", {})
        t = cache.get(pid)
        if t is None:
            t = TableInfo(
                pid, self.name, self.columns, self.indexes, self.pk_is_handle,
                self.auto_inc_id, self.state, self.db_name,
            )
            cache[pid] = t
        return t

    def to_json(self):
        return {
            "id": self.id,
            "name": self.name,
            "columns": [c.to_json() for c in self.columns],
            "indexes": [i.to_json() for i in self.indexes],
            "pk_is_handle": self.pk_is_handle,
            "auto_inc_id": self.auto_inc_id,
            "state": self.state,
            "db_name": self.db_name,
            "partition": self.partition.to_json() if self.partition else None,
        }

    @staticmethod
    def from_json(d):
        return TableInfo(
            d["id"], d["name"],
            [ColumnInfo.from_json(c) for c in d["columns"]],
            [IndexInfo.from_json(i) for i in d["indexes"]],
            d["pk_is_handle"], d.get("auto_inc_id", 1), d.get("state", "public"), d.get("db_name", ""),
            PartitionInfo.from_json(d["partition"]) if d.get("partition") else None,
        )


@dataclass
class DBInfo:
    name: str
    table_ids: list[int] = field(default_factory=list)

    def to_json(self):
        return {"name": self.name, "table_ids": self.table_ids}

    @staticmethod
    def from_json(d):
        return DBInfo(d["name"], d["table_ids"])


class InfoSchema:
    """Immutable snapshot of the full schema at one version
    (ref: infoschema/infoschema.go)."""

    def __init__(self, version: int, dbs: dict[str, DBInfo], tables: dict[int, TableInfo], views: dict | None = None):
        self.version = version
        self.dbs = {k.lower(): v for k, v in dbs.items()}
        self.tables = tables
        self.views = views or {}  # (db, name) → {"db","name","cols","sql"}
        self._by_name: dict[tuple[str, str], TableInfo] = {}
        for t in tables.values():
            self._by_name[(t.db_name.lower(), t.name.lower())] = t

    def db_names(self) -> list[str]:
        return sorted(self.dbs)

    def has_db(self, db: str) -> bool:
        return db.lower() in self.dbs

    def table_or_none(self, db: str, name: str) -> TableInfo | None:
        """Public lookup without raising (planner shadow checks)."""
        return self._by_name.get((db.lower(), name.lower()))

    def table(self, db: str, name: str) -> TableInfo:
        t = self._by_name.get((db.lower(), name.lower()))
        if t is None:
            if not self.has_db(db):
                raise UnknownDatabase(f"unknown database {db!r}")
            raise UnknownTable(f"table {db}.{name} doesn't exist")
        return t

    def table_by_id(self, tid: int) -> TableInfo | None:
        return self.tables.get(tid)

    def tables_in_db(self, db: str) -> list[TableInfo]:
        d = self.dbs.get(db.lower())
        if d is None:
            raise UnknownDatabase(f"unknown database {db!r}")
        return sorted((self.tables[t] for t in d.table_ids if t in self.tables), key=lambda t: t.name)
