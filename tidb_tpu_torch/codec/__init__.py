from .key import (
    encode_int,
    decode_int,
    encode_uint,
    encode_bytes,
    decode_bytes,
    encode_float,
    decode_float,
    encode_datum_key,
    decode_datum_key,
)
from .tablecodec import (
    record_key,
    record_prefix,
    index_key,
    index_prefix,
    table_prefix,
    decode_record_handle,
)
from .row import encode_row, decode_row
