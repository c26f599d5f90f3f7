"""Per-table statistics built from columnar batches (copy of tidb_tpu/statistics/tablestats.py; ref: statistics/
builder.go + executor/analyze.go — here ANALYZE reads the same ColumnBatch
tiles the cop engines scan, so stats build is itself a columnar pass)."""

from __future__ import annotations

import numpy as np

from ..mysqltypes.field_type import FieldType
from ..mysqltypes.datum import Datum, K_STR, K_BYTES
from ..mysqltypes.mydecimal import pow10
from .cmsketch import CMSketch, TopN, hash_values
from .histogram import Histogram

SAMPLE_CAP = 65536  # histogram build sample cap (reference: maxSampleSize)
TOPN_SIZE = 20


def _str_surrogate(s) -> float:
    """Order-preserving float from the first 8 bytes of a string."""
    b = (s if isinstance(s, bytes) else str(s).encode("utf8"))[:8].ljust(8, b"\x00")
    return float(int.from_bytes(b, "big"))


def surrogate_lane(data: np.ndarray, valid: np.ndarray, ft: FieldType) -> np.ndarray:
    """Non-null values → order-preserving float64 surrogate array."""
    sel = data[valid] if valid is not None else data
    if sel.dtype == object:
        return np.array([_str_surrogate(v) for v in sel], dtype=np.float64)
    if ft is not None and ft.is_decimal():
        return sel.astype(np.float64) / pow10(max(ft.decimal, 0))
    return sel.astype(np.float64)


def surrogate_datum(d: Datum, ft: FieldType) -> float | None:
    if d.is_null:
        return None
    if d.kind in (K_STR, K_BYTES):
        return _str_surrogate(d.val)
    if ft is not None and ft.is_decimal():
        dec = d.to_dec()
        return dec.value / pow10(dec.scale) if dec.scale else float(dec.value)
    try:
        return float(d.to_float())
    except (TypeError, ValueError):
        return None


class ColumnStats:
    __slots__ = ("hist", "cms", "topn", "ndv", "null_count", "total")

    def __init__(self, hist, cms, topn, ndv, null_count, total):
        self.hist = hist
        self.cms = cms
        self.topn = topn
        self.ndv = int(ndv)
        self.null_count = int(null_count)
        self.total = int(total)

    @property
    def non_null(self) -> int:
        return self.total - self.null_count

    def eq_rows(self, surrogate: float) -> float:
        """Estimated rows equal to one value (TopN exact → CMS → hist avg)."""
        h = int(hash_values(np.array([surrogate]))[0])
        if self.topn is not None:
            t = self.topn.get(h)
            if t is not None:
                return float(t)
        if self.cms is not None:
            c = self.cms.query_hash(h)
            # CMS overcounts; trust it only when it's below the hist average
            avg = self.hist.equal_row_count(surrogate) if self.hist else self.non_null / max(self.ndv, 1)
            return float(min(c, avg * 4)) if c > 0 else min(1.0, float(self.non_null))
        if self.hist is not None:
            return self.hist.equal_row_count(surrogate)
        return self.non_null / max(self.ndv, 1)

    def range_rows(self, lo, hi, lo_incl, hi_incl) -> float:
        if self.hist is None:
            return self.non_null / 3.0
        return self.hist.range_row_count(lo, hi, lo_incl, hi_incl)

    def to_json(self):
        return {
            "hist": self.hist.to_json() if self.hist else None,
            "cms": self.cms.to_json() if self.cms else None,
            "topn": self.topn.to_json() if self.topn else None,
            "ndv": self.ndv, "null_count": self.null_count, "total": self.total,
        }

    @staticmethod
    def from_json(d) -> "ColumnStats":
        return ColumnStats(
            Histogram.from_json(d["hist"]) if d["hist"] else None,
            CMSketch.from_json(d["cms"]) if d["cms"] else None,
            TopN.from_json(d["topn"]) if d["topn"] else None,
            d["ndv"], d["null_count"], d["total"],
        )


class TableStats:
    __slots__ = ("table_id", "row_count", "version", "columns", "modify_count")

    def __init__(self, table_id: int, row_count: int, version: int, columns: dict[int, ColumnStats]):
        self.table_id = table_id
        self.row_count = int(row_count)
        self.version = version
        self.columns = columns  # by column id
        self.modify_count = 0

    def col(self, col_id: int) -> ColumnStats | None:
        return self.columns.get(col_id)

    def to_json(self):
        return {
            "table_id": self.table_id,
            "row_count": self.row_count,
            "version": self.version,
            "modify_count": self.modify_count,
            "columns": {str(k): v.to_json() for k, v in self.columns.items()},
        }

    @staticmethod
    def from_json(d) -> "TableStats":
        ts = TableStats(
            d["table_id"], d["row_count"], d["version"],
            {int(k): ColumnStats.from_json(v) for k, v in d["columns"].items()},
        )
        ts.modify_count = d.get("modify_count", 0)
        return ts


def build_column_stats(data: np.ndarray, valid: np.ndarray, ft: FieldType) -> ColumnStats:
    total = len(data)
    null_count = total - int(valid.sum())
    sur = surrogate_lane(data, valid, ft)
    n = len(sur)
    if n == 0:
        return ColumnStats(None, None, None, 0, null_count, total)
    # exact NDV + value counts on the (possibly huge) lane — numpy unique
    # is O(n log n), fine for analyze
    uniq, counts = np.unique(sur, return_counts=True)
    ndv = len(uniq)
    # TopN: heaviest repeated values kept exact; CMS takes the remainder
    uh = hash_values(uniq)
    order = np.argsort(counts)[::-1][:TOPN_SIZE]
    topn_items: dict[int, int] = {}
    topn_idx = []
    for i in order:
        if counts[i] > 1:
            topn_items[int(uh[i])] = int(counts[i])
            topn_idx.append(i)
    topn = TopN(topn_items)
    mask = np.ones(len(uniq), dtype=bool)
    if topn_idx:
        mask[np.array(topn_idx)] = False
    cms = CMSketch()
    cms.insert_many(uh[mask], counts[mask])
    # histogram from a sample of the raw lane (equi-depth wants row-level
    # distribution, not distinct values)
    if n > SAMPLE_CAP:
        step = n // SAMPLE_CAP
        sample = sur[::step]
    else:
        sample = sur
    hist = Histogram.build(sample, n, ndv)
    return ColumnStats(hist, cms, topn, ndv, null_count, total)


def build_table_stats(table, batches, version: int) -> TableStats:
    """batches: iterable of ColumnBatch covering the table's regions."""
    visible = table.visible_columns()
    data_parts: dict[int, list] = {c.offset: [] for c in visible}
    valid_parts: dict[int, list] = {c.offset: [] for c in visible}
    rows = 0
    for b in batches:
        rows += b.n_rows
        for c in visible:
            data_parts[c.offset].append(b.data[c.offset])
            valid_parts[c.offset].append(b.valid[c.offset])
    columns: dict[int, ColumnStats] = {}
    for c in visible:
        if not data_parts[c.offset]:
            continue
        data = np.concatenate(data_parts[c.offset])
        valid = np.concatenate(valid_parts[c.offset])
        columns[c.id] = build_column_stats(data, valid, c.ft)
    return TableStats(table.id, rows, version, columns)
