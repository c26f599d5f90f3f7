"""MySQL field types (copy of tidb_tpu/mysqltypes/field_type.py; ref:
types/field_type.go, parser/mysql type codes).

The TypeCode values follow the MySQL protocol type space so that a wire
layer can serialize them directly.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class TypeCode(enum.IntEnum):
    Decimal = 0x00  # legacy; we always use NewDecimal
    Tiny = 0x01
    Short = 0x02
    Long = 0x03
    Float = 0x04
    Double = 0x05
    Null = 0x06
    Timestamp = 0x07
    Longlong = 0x08
    Int24 = 0x09
    Date = 0x0A
    Duration = 0x0B
    Datetime = 0x0C
    Year = 0x0D
    NewDate = 0x0E
    Varchar = 0x0F
    Bit = 0x10
    JSON = 0xF5
    NewDecimal = 0xF6
    Enum = 0xF7
    Set = 0xF8
    TinyBlob = 0xF9
    MediumBlob = 0xFA
    LongBlob = 0xFB
    Blob = 0xFC
    VarString = 0xFD
    String = 0xFE


INT_TYPES = {TypeCode.Tiny, TypeCode.Short, TypeCode.Long, TypeCode.Int24, TypeCode.Longlong, TypeCode.Year, TypeCode.Bit}
FLOAT_TYPES = {TypeCode.Float, TypeCode.Double}
STRING_TYPES = {TypeCode.Varchar, TypeCode.VarString, TypeCode.String, TypeCode.TinyBlob, TypeCode.MediumBlob, TypeCode.LongBlob, TypeCode.Blob, TypeCode.Enum, TypeCode.Set}
TIME_TYPES = {TypeCode.Date, TypeCode.Datetime, TypeCode.Timestamp, TypeCode.NewDate}

# Column flags (ref: parser/mysql/type.go)
NOT_NULL_FLAG = 1
PRI_KEY_FLAG = 2
UNIQUE_KEY_FLAG = 4
MULTIPLE_KEY_FLAG = 8
UNSIGNED_FLAG = 32
BINARY_FLAG = 128
AUTO_INCREMENT_FLAG = 512

UNSPECIFIED_LENGTH = -1


@dataclass
class FieldType:
    """Type descriptor for a column or expression result.

    (ref: types/field_type.go FieldType: Tp/Flag/Flen/Decimal/Charset/Collate)
    """

    tp: TypeCode
    flag: int = 0
    flen: int = UNSPECIFIED_LENGTH
    decimal: int = UNSPECIFIED_LENGTH  # fractional digits for NewDecimal/time fsp
    charset: str = "utf8mb4"
    collate: str = "utf8mb4_bin"
    elems: tuple = field(default_factory=tuple)  # enum/set values

    @property
    def is_unsigned(self) -> bool:
        return bool(self.flag & UNSIGNED_FLAG)

    @property
    def not_null(self) -> bool:
        return bool(self.flag & NOT_NULL_FLAG)

    def is_int(self) -> bool:
        return self.tp in INT_TYPES

    def is_float(self) -> bool:
        return self.tp in FLOAT_TYPES

    def is_decimal(self) -> bool:
        return self.tp == TypeCode.NewDecimal

    def is_string(self) -> bool:
        return self.tp in STRING_TYPES

    def is_time(self) -> bool:
        return self.tp in TIME_TYPES

    def clone(self, **kw) -> "FieldType":
        d = dict(tp=self.tp, flag=self.flag, flen=self.flen, decimal=self.decimal, charset=self.charset, collate=self.collate, elems=self.elems)
        d.update(kw)
        return FieldType(**d)

    def type_name(self) -> str:
        n = _TYPE_NAMES.get(self.tp, "unknown")
        if self.tp == TypeCode.NewDecimal and self.flen > 0:
            n = f"{n}({self.flen},{max(self.decimal, 0)})"
        elif self.is_string() and self.flen > 0:
            n = f"{n}({self.flen})"
        if self.is_unsigned:
            n += " unsigned"
        return n


_TYPE_NAMES = {
    TypeCode.Tiny: "tinyint",
    TypeCode.Short: "smallint",
    TypeCode.Long: "int",
    TypeCode.Int24: "mediumint",
    TypeCode.Longlong: "bigint",
    TypeCode.Float: "float",
    TypeCode.Double: "double",
    TypeCode.NewDecimal: "decimal",
    TypeCode.Varchar: "varchar",
    TypeCode.String: "char",
    TypeCode.Blob: "text",
    TypeCode.Date: "date",
    TypeCode.Datetime: "datetime",
    TypeCode.Timestamp: "timestamp",
    TypeCode.Duration: "time",
    TypeCode.JSON: "json",
    TypeCode.Year: "year",
    TypeCode.Bit: "bit",
    TypeCode.Enum: "enum",
    TypeCode.Null: "null",
}


def ft_long(unsigned=False) -> FieldType:
    return FieldType(TypeCode.Long, flag=UNSIGNED_FLAG if unsigned else 0, flen=11)


def ft_longlong(unsigned=False) -> FieldType:
    return FieldType(TypeCode.Longlong, flag=UNSIGNED_FLAG if unsigned else 0, flen=20)


def ft_double() -> FieldType:
    return FieldType(TypeCode.Double, flen=22)


def ft_decimal(flen=11, frac=0) -> FieldType:
    return FieldType(TypeCode.NewDecimal, flen=flen, decimal=frac)


def ft_varchar(flen=255) -> FieldType:
    return FieldType(TypeCode.Varchar, flen=flen)


def ft_date() -> FieldType:
    return FieldType(TypeCode.Date, flen=10, decimal=0)


def ft_datetime(fsp=0) -> FieldType:
    return FieldType(TypeCode.Datetime, flen=19, decimal=fsp)


_NAME_TO_TYPE = {
    "tinyint": TypeCode.Tiny,
    "smallint": TypeCode.Short,
    "mediumint": TypeCode.Int24,
    "int": TypeCode.Long,
    "integer": TypeCode.Long,
    "bigint": TypeCode.Longlong,
    "float": TypeCode.Float,
    "double": TypeCode.Double,
    "real": TypeCode.Double,
    "decimal": TypeCode.NewDecimal,
    "numeric": TypeCode.NewDecimal,
    "varchar": TypeCode.Varchar,
    "char": TypeCode.String,
    "text": TypeCode.Blob,
    "tinytext": TypeCode.TinyBlob,
    "mediumtext": TypeCode.MediumBlob,
    "longtext": TypeCode.LongBlob,
    "blob": TypeCode.Blob,
    "varbinary": TypeCode.VarString,
    "binary": TypeCode.String,
    "date": TypeCode.Date,
    "datetime": TypeCode.Datetime,
    "timestamp": TypeCode.Timestamp,
    "time": TypeCode.Duration,
    "year": TypeCode.Year,
    "json": TypeCode.JSON,
    "bit": TypeCode.Bit,
    "enum": TypeCode.Enum,
    "set": TypeCode.Set,
    "bool": TypeCode.Tiny,
    "boolean": TypeCode.Tiny,
}


def parse_type_name(name: str, args=(), unsigned=False, elems=(), collate="") -> FieldType:
    """Map a SQL type name + length args to a FieldType (used by the DDL parser)."""
    tp = _NAME_TO_TYPE.get(name.lower())
    if tp is None:
        raise ValueError(f"unknown type {name!r}")
    ft = FieldType(tp)
    if collate:
        from .collate import is_supported

        if not is_supported(collate):
            raise ValueError(f"Unknown collation: '{collate}'")
        ft.collate = collate
    if unsigned:
        ft.flag |= UNSIGNED_FLAG
    if tp == TypeCode.NewDecimal:
        ft.flen = args[0] if args else 10
        ft.decimal = args[1] if len(args) > 1 else 0
    elif tp in (TypeCode.Datetime, TypeCode.Timestamp, TypeCode.Duration):
        ft.decimal = args[0] if args else 0
    elif args:
        ft.flen = args[0]
    if tp in (TypeCode.Enum, TypeCode.Set):
        ft.elems = tuple(elems)
    return ft
