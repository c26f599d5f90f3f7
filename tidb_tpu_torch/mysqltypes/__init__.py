"""MySQL value types for the port (copies of tidb_tpu/mysqltypes)."""

from .field_type import (
    FieldType,
    TypeCode,
    NOT_NULL_FLAG,
    PRI_KEY_FLAG,
    UNSIGNED_FLAG,
    AUTO_INCREMENT_FLAG,
    ft_long,
    ft_longlong,
    ft_double,
    ft_decimal,
    ft_varchar,
    ft_date,
    ft_datetime,
    parse_type_name,
)
from .datum import Datum, K_NULL, K_INT, K_UINT, K_FLOAT, K_DEC, K_STR, K_BYTES, K_TIME, K_DUR
from .mydecimal import Dec, dec_from_string, dec_round
from .coretime import (
    pack_time,
    unpack_time,
    parse_datetime,
    format_time,
    time_year,
    time_month,
    time_day,
)
