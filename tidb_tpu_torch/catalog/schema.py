"""Schema objects (ref: tidb_tpu/catalog/schema.py:17 ColumnInfo, :182
TableInfo) — the part a ColumnBatch carries: column names, field types and
offsets. JSON persistence, indexes, partitions and the InfoSchema cache
stay in the reference until the port's front door needs them."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..mysqltypes.field_type import FieldType


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


@dataclass
class TableInfo:
    id: int
    name: str
    columns: list[ColumnInfo]
    indexes: list = field(default_factory=list)
    pk_is_handle: bool = False  # clustered single-int PK == row handle
    auto_inc_id: int = 1
    state: str = "public"
    db_name: str = ""

    def col_by_name(self, name: str) -> ColumnInfo:
        lname = name.lower()
        for c in self.columns:
            if c.name.lower() == lname:
                return c
        raise KeyError(f"unknown column {name!r} in {self.name!r}")

    def visible_columns(self) -> list[ColumnInfo]:
        return [c for c in self.columns if not c.hidden]
