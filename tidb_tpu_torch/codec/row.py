"""Row value format (copy of tidb_tpu/codec/row.py; ref: util/rowcodec — compact row format v2).

Self-describing column-id tagged encoding. Layout:
  varint(ncols) then per column: varint(col_id), kind byte, payload.
Payloads use little-endian fixed ints / raw bytes with varint lengths.
Row decode into columnar chunks happens in copr/engine; this codec is only
on the txn write path and point-get path, not the scan hot loop (scans read
the columnar tile replica instead).
"""

from __future__ import annotations

import struct

from ..mysqltypes.datum import Datum, K_NULL, K_INT, K_UINT, K_FLOAT, K_DEC, K_STR, K_BYTES, K_TIME, K_DUR
from ..mysqltypes.mydecimal import Dec


def _wvarint(buf: bytearray, v: int) -> None:
    # zigzag for signed
    u = (v << 1) ^ (v >> 63) if v < 0 else v << 1
    while u >= 0x80:
        buf.append((u & 0x7F) | 0x80)
        u >>= 7
    buf.append(u)


def _rvarint(data, pos: int) -> tuple[int, int]:
    shift = 0
    u = 0
    while True:
        b = data[pos]
        pos += 1
        u |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
    v = (u >> 1) ^ -(u & 1)
    return v, pos


def encode_row(col_ids: list[int], datums: list[Datum]) -> bytes:
    buf = bytearray()
    _wvarint(buf, len(col_ids))
    for cid, d in zip(col_ids, datums):
        _wvarint(buf, cid)
        k = d.kind
        buf.append(k)
        if k == K_NULL:
            continue
        if k in (K_INT, K_TIME, K_DUR):
            _wvarint(buf, d.val)
        elif k == K_UINT:
            buf += struct.pack("<Q", d.val)
        elif k == K_FLOAT:
            buf += struct.pack("<d", d.val)
        elif k == K_DEC:
            _wvarint(buf, d.val.scale)
            b = str(d.val.value).encode()
            _wvarint(buf, len(b))
            buf += b
        elif k in (K_STR, K_BYTES):
            b = d.val.encode("utf8") if k == K_STR else d.val
            _wvarint(buf, len(b))
            buf += b
        else:
            raise TypeError(f"cannot row-encode kind {k}")
    return bytes(buf)


def decode_row(data: bytes) -> dict[int, Datum]:
    if data and data[0] == 0x81:  # row format v2 (vectorized batch codec)
        from .rowfast import decode_row_v2

        return decode_row_v2(data)
    pos = 0
    n, pos = _rvarint(data, pos)
    out: dict[int, Datum] = {}
    for _ in range(n):
        cid, pos = _rvarint(data, pos)
        k = data[pos]
        pos += 1
        if k == K_NULL:
            out[cid] = Datum.null()
            continue
        if k in (K_INT, K_TIME, K_DUR):
            v, pos = _rvarint(data, pos)
            out[cid] = Datum(k, v)
        elif k == K_UINT:
            (v,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            out[cid] = Datum.u(v)
        elif k == K_FLOAT:
            (v,) = struct.unpack_from("<d", data, pos)
            pos += 8
            out[cid] = Datum.f(v)
        elif k == K_DEC:
            scale, pos = _rvarint(data, pos)
            ln, pos = _rvarint(data, pos)
            val = int(data[pos : pos + ln].decode())
            pos += ln
            out[cid] = Datum.d(Dec(val, scale))
        elif k in (K_STR, K_BYTES):
            ln, pos = _rvarint(data, pos)
            b = data[pos : pos + ln]
            pos += ln
            out[cid] = Datum.s(b.decode("utf8")) if k == K_STR else Datum.b(bytes(b))
        else:
            raise ValueError(f"bad row kind {k}")
    return out
