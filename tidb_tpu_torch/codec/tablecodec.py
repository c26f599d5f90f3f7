"""Table/index key layout (copy of tidb_tpu/codec/tablecodec.py; ref: tablecodec/tablecodec.go:49-50,94).

  record: t{tableID}_r{handle}
  index : t{tableID}_i{indexID}{encoded values}[{encoded handle}]

IDs/handles use the sign-flipped big-endian int encoding so byte order is
numeric order, making region split points and range scans trivial.
"""

from __future__ import annotations

import struct

_SIGN = 0x8000000000000000


def _cint(v: int) -> bytes:
    return struct.pack(">Q", (v + _SIGN) & 0xFFFFFFFFFFFFFFFF)


def _dint(b: bytes) -> int:
    return struct.unpack(">Q", b)[0] - _SIGN


def table_prefix(table_id: int) -> bytes:
    return b"t" + _cint(table_id)


def record_prefix(table_id: int) -> bytes:
    return b"t" + _cint(table_id) + b"_r"


def record_key(table_id: int, handle: int) -> bytes:
    return b"t" + _cint(table_id) + b"_r" + _cint(handle)


def decode_record_handle(key: bytes) -> int:
    return _dint(key[11:19])


def index_prefix(table_id: int, index_id: int) -> bytes:
    return b"t" + _cint(table_id) + b"_i" + _cint(index_id)


def index_key(table_id: int, index_id: int, encoded_vals: bytes, handle: int | None = None) -> bytes:
    k = index_prefix(table_id, index_id) + encoded_vals
    if handle is not None:
        k += _cint(handle)
    return k


def decode_index_handle(key: bytes) -> int:
    """Handle is the trailing 8 bytes of a non-unique index key."""
    return _dint(key[-8:])


def is_record_key(key: bytes) -> bool:
    return len(key) >= 19 and key[:1] == b"t" and key[9:11] == b"_r"


def decode_table_id(key: bytes) -> int:
    return _dint(key[1:9])
