"""MySQL value types for the port (copies of tidb_tpu/mysqltypes, trimmed
to what chunk, expr and copr use)."""

from .field_type import FieldType, TypeCode, UNSIGNED_FLAG, NOT_NULL_FLAG, ft_longlong, ft_double, ft_decimal, ft_varchar, ft_date
from .datum import Datum, K_NULL, K_INT, K_UINT, K_FLOAT, K_DEC, K_STR, K_BYTES, K_TIME, K_DUR
from .mydecimal import Dec, dec_from_string
from .coretime import pack_time, parse_datetime, format_time
