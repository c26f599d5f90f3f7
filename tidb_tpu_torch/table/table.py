"""Table row operations (copy of tidb_tpu/table/table.py; ref: table/tables/tables.go AddRecord:634,
UpdateRecord:322, tables/index.go — fresh implementation).

Row layout: record key t{tid}_r{handle} → tagged row codec value.
Handles: single-int primary key becomes the handle (clustered,
pk_is_handle); otherwise a hidden `_tidb_rowid` auto id.
Index layout: unique → t{tid}_i{iid}{vals} = handle;
non-unique → t{tid}_i{iid}{vals}{handle} = b''. NULL-containing unique
keys degrade to non-unique form (MySQL semantics: NULLs don't collide).
"""

from __future__ import annotations

from ..codec.key import encode_datum_key
from ..codec.row import encode_row, decode_row
from ..codec import tablecodec
from ..errors import DuplicateEntry
from ..mysqltypes.datum import Datum
from ..mysqltypes.coretime import parse_datetime
from ..catalog.schema import ColumnInfo, TableInfo, IndexInfo


def datum_from_default(col: ColumnInfo) -> Datum:
    """Materialize a column's stored default for rows written before the
    column existed (ref: rowcodec decoder default fill; table/column.go)."""
    if not col.has_default or col.default is None:
        return Datum.null()
    v = col.default
    ft = col.ft
    if ft.is_time():
        p = parse_datetime(str(v))
        return Datum.t(p) if p is not None else Datum.null()
    if ft.is_decimal():
        return Datum.d(Datum.s(str(v)).to_dec().rescale(max(ft.decimal, 0)))
    if ft.is_float():
        return Datum.f(float(v))
    if ft.is_int():
        return Datum.i(int(v))
    return Datum.s(str(v))


class Table:
    def __init__(self, info: TableInfo):
        self.info = info

    # --- key builders ------------------------------------------------------

    def record_key(self, handle: int) -> bytes:
        return tablecodec.record_key(self.info.id, handle)

    def index_value_key(self, idx: IndexInfo, datums: list[Datum], handle: int | None):
        """→ (key, value, needs_handle_suffix) for one index entry."""
        buf = bytearray()
        has_null = False
        for off in idx.col_offsets:
            d = datums[off]
            if d.is_null:
                has_null = True
            encode_datum_key(buf, d)
        distinct = idx.unique and not has_null
        if distinct:
            key = tablecodec.index_key(self.info.id, idx.id, bytes(buf))
            return key, str(handle).encode() if handle is not None else b"", True
        key = tablecodec.index_key(self.info.id, idx.id, bytes(buf), handle=handle)
        return key, b"", False

    # --- row ops ------------------------------------------------------------

    def row_datums_with_hidden(self, datums: list[Datum], handle: int) -> list[Datum]:
        """Full row including the hidden rowid column if present."""
        out = list(datums)
        for c in self.info.columns:
            if c.hidden and c.name == "_tidb_rowid":
                while len(out) <= c.offset:
                    out.append(Datum.null())
                out[c.offset] = Datum.i(handle)
        return out

    def add_record(self, txn, datums: list[Datum], handle: int, check_dup: bool = True) -> int:
        """Write row + all index entries into the txn membuffer."""
        info = self.info
        rk = self.record_key(handle)
        if check_dup and info.pk_is_handle and txn.get(rk) is not None:
            pk_off = next(i for i in info.indexes if i.primary).col_offsets[0]
            raise DuplicateEntry(f"Duplicate entry '{datums[pk_off].to_str()}' for key 'PRIMARY'")
        col_ids = [c.id for c in info.columns]
        full = self.row_datums_with_hidden(datums, handle)
        txn.put(rk, encode_row(col_ids, full))
        for idx in info.indexes:
            if info.pk_is_handle and idx.primary:
                continue  # clustered: the record key IS the pk index
            if idx.state in ("none", "delete_only"):
                continue  # online DDL: index not yet writable
            key, val, distinct = self.index_value_key(idx, full, handle)
            # unique check applies in EVERY writable state: during
            # write_only/write_reorg a silent overwrite would corrupt the
            # entry backfill already wrote (F1 dual-write invariant)
            if distinct and check_dup:
                existing = txn.get(key)
                if existing is not None and existing != val:
                    raise DuplicateEntry(f"Duplicate entry for key '{idx.name}'")
            txn.put(key, val)
        return handle

    def remove_record(self, txn, handle: int, datums: list[Datum]) -> None:
        txn.delete(self.record_key(handle))
        full = self.row_datums_with_hidden(datums, handle)
        for idx in self.info.indexes:
            if self.info.pk_is_handle and idx.primary:
                continue
            if idx.state == "none":
                continue  # no entries can exist yet
            key, _, _ = self.index_value_key(idx, full, handle)
            txn.delete(key)

    def update_record(self, txn, handle: int, old: list[Datum], new: list[Datum]) -> None:
        self.remove_record(txn, handle, old)
        self.add_record(txn, new, handle, check_dup=True)

    def decode_record(self, value: bytes) -> list[Datum]:
        """KV row value → datums in column offset order."""
        by_id = decode_row(value)
        out = []
        for c in self.info.columns:
            d = by_id.get(c.id)
            if d is None:
                d = datum_from_default(c)
            out.append(d)
        return out

    # --- auto id (ref: meta/autoid — simplified batched allocator) ---------

    def alloc_handles(self, session, n: int) -> int:
        """Allocate n consecutive handles; returns first. Batches through
        the table's auto_inc counter persisted at DDL meta."""
        return session.alloc_auto_id(self.info, n)
