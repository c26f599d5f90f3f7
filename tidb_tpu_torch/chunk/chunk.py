"""Columnar batch format (copy of tidb_tpu/chunk/chunk.py; ref:
util/chunk/chunk.go, column.go).

The reference's Chunk is Arrow-layout columns (null bitmap + offsets +
contiguous data) pulled through Volcano `Next(chk)` with `requiredRows`
sizing. Here a Column is:
  data  — numpy array: int64 (ints/times/durations/enum codes/scaled
          decimals), uint64, float64, or object (strings/bytes/json)
  valid — numpy bool array, True = non-NULL

Fixed-width columns are exactly the host mirror of a device tile lane; a
Chunk becomes a DeviceTile by padding to tile shape (see tile.py). Strings
dictionary-encode at the tile boundary.

The `sel` concept (chunk.go:37) appears here as filter() returning a
compacted chunk — on device the mask itself is kept instead (validity
semantics, SURVEY §7 hard-parts).
"""

from __future__ import annotations

import numpy as np

from ..mysqltypes.field_type import FieldType, TypeCode
from ..mysqltypes.datum import Datum, K_DUR
from ..mysqltypes.mydecimal import Dec

VARLEN = "varlen"


def col_numpy_dtype(ft: FieldType):
    """numpy dtype for a FieldType; VARLEN sentinel for object columns."""
    if ft.is_int():
        return np.uint64 if ft.is_unsigned and ft.tp == TypeCode.Longlong else np.int64
    if ft.tp in (TypeCode.Date, TypeCode.Datetime, TypeCode.Timestamp, TypeCode.Duration, TypeCode.Year):
        return np.int64
    if ft.is_float():
        return np.float64
    if ft.is_decimal():
        return np.int64  # scaled by ft.decimal
    return VARLEN


class Column:
    __slots__ = ("ft", "data", "valid")

    def __init__(self, ft: FieldType, data: np.ndarray, valid: np.ndarray):
        self.ft = ft
        self.data = data
        self.valid = valid

    @staticmethod
    def empty(ft: FieldType, n: int = 0) -> "Column":
        dt = col_numpy_dtype(ft)
        data = np.empty(n, dtype=object) if dt is VARLEN else np.zeros(n, dtype=dt)
        return Column(ft, data, np.zeros(n, dtype=bool))

    def __len__(self):
        return len(self.data)

    def is_varlen(self) -> bool:
        return col_numpy_dtype(self.ft) is VARLEN

    def get_datum(self, i: int) -> Datum:
        if not self.valid[i]:
            return Datum.null()
        v = self.data[i]
        ft = self.ft
        if ft.is_decimal():
            return Datum.d(Dec(int(v), max(ft.decimal, 0)))
        if ft.is_time():
            return Datum.t(int(v))
        if ft.tp == TypeCode.Duration:
            return Datum(K_DUR, int(v))
        if ft.is_float():
            return Datum.f(float(v))
        if ft.is_int():
            return Datum.u(int(v)) if ft.is_unsigned else Datum.i(int(v))
        if isinstance(v, bytes):
            return Datum.b(v)
        return Datum.s(v)

    def set_datum(self, i: int, d: Datum) -> None:
        if d.is_null:
            self.valid[i] = False
            return
        self.valid[i] = True
        ft = self.ft
        if ft.is_decimal():
            self.data[i] = d.to_dec().rescale(max(ft.decimal, 0)).value
        elif self.is_varlen():
            self.data[i] = d.val
        elif ft.is_float():
            self.data[i] = d.to_float()
        else:
            self.data[i] = d.to_int()

    def take(self, idx: np.ndarray) -> "Column":
        return Column(self.ft, self.data[idx], self.valid[idx])

    def slice(self, lo: int, hi: int) -> "Column":
        return Column(self.ft, self.data[lo:hi], self.valid[lo:hi])

    def concat(self, other: "Column") -> "Column":
        return Column(self.ft, np.concatenate([self.data, other.data]), np.concatenate([self.valid, other.valid]))


class Chunk:
    """A batch of rows in columnar form."""

    __slots__ = ("columns",)

    def __init__(self, columns: list[Column]):
        self.columns = columns

    @staticmethod
    def empty(fts: list[FieldType], n: int = 0) -> "Chunk":
        return Chunk([Column.empty(ft, n) for ft in fts])

    @staticmethod
    def from_datum_rows(fts: list[FieldType], rows: list[list[Datum]]) -> "Chunk":
        chk = Chunk.empty(fts, len(rows))
        for i, row in enumerate(rows):
            for c, d in enumerate(row):
                chk.columns[c].set_datum(i, d)
        return chk

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    def field_types(self) -> list[FieldType]:
        return [c.ft for c in self.columns]

    def get_row(self, i: int) -> list[Datum]:
        return [c.get_datum(i) for c in self.columns]

    def iter_rows(self):
        for i in range(self.num_rows):
            yield self.get_row(i)

    def take(self, idx: np.ndarray) -> "Chunk":
        return Chunk([c.take(idx) for c in self.columns])

    def filter(self, mask: np.ndarray) -> "Chunk":
        idx = np.nonzero(mask)[0]
        return self.take(idx)

    def slice(self, lo: int, hi: int) -> "Chunk":
        return Chunk([c.slice(lo, hi) for c in self.columns])

    def concat(self, other: "Chunk") -> "Chunk":
        if self.num_cols == 0:
            return other
        return Chunk([a.concat(b) for a, b in zip(self.columns, other.columns)])

    @staticmethod
    def concat_all(chunks: list["Chunk"]) -> "Chunk":
        chunks = [c for c in chunks if c is not None and c.num_rows > 0]
        if not chunks:
            return Chunk([])
        if len(chunks) == 1:
            return chunks[0]
        # one np.concatenate per column — pairwise concat is O(k^2) copies
        import numpy as np

        cols = []
        for i, c0 in enumerate(chunks[0].columns):
            cols.append(Column(
                c0.ft,
                np.concatenate([c.columns[i].data for c in chunks]),
                np.concatenate([c.columns[i].valid for c in chunks]),
            ))
        return Chunk(cols)

    def to_pylist(self) -> list[tuple]:
        """Render all rows as python tuples (None for NULL) — test/display helper."""
        out = []
        for i in range(self.num_rows):
            out.append(tuple(d.render(c.ft) for d, c in zip(self.get_row(i), self.columns)))
        return out
