"""Memcomparable datum codec (copy of tidb_tpu/codec/key.py; ref: util/codec/codec.go, bytes.go, number.go).

Encoded keys compare bytewise in the same order as the source datums, which
is what makes range scans over the ordered KV store express SQL ranges.
Wire format flags follow the reference's codec:
  0x00 NULL, 0x01 bytes (group-of-8 + pad marker), 0x03 int (sign-flipped
  big-endian), 0x04 uint, 0x05 float (bit-flipped).
"""

from __future__ import annotations

import struct

from ..mysqltypes.datum import Datum, K_NULL, K_INT, K_UINT, K_FLOAT, K_DEC, K_STR, K_BYTES, K_TIME, K_DUR

NIL_FLAG = 0x00
BYTES_FLAG = 0x01
INT_FLAG = 0x03
UINT_FLAG = 0x04
FLOAT_FLAG = 0x05
DECIMAL_FLAG = 0x06
MAX_FLAG = 0xFA

_SIGN_MASK = 0x8000000000000000
_GROUP = 8
_PAD = 0x00
_MARKER = 0xFF


def encode_int(buf: bytearray, v: int) -> None:
    buf.append(INT_FLAG)
    buf += struct.pack(">Q", (v + _SIGN_MASK) & 0xFFFFFFFFFFFFFFFF)


def decode_int(data: memoryview, pos: int) -> tuple[int, int]:
    (u,) = struct.unpack_from(">Q", data, pos)
    return u - _SIGN_MASK, pos + 8


def encode_uint(buf: bytearray, v: int) -> None:
    buf.append(UINT_FLAG)
    buf += struct.pack(">Q", v & 0xFFFFFFFFFFFFFFFF)


def encode_bytes(buf: bytearray, data: bytes) -> None:
    """Group-of-8 escape encoding preserving order (ref: util/codec/bytes.go:33)."""
    buf.append(BYTES_FLAG)
    n = len(data)
    for i in range(0, n + 1, _GROUP):
        grp = data[i : i + _GROUP]
        pad = _GROUP - len(grp)
        buf += grp
        buf += bytes([_PAD]) * pad
        buf.append(_MARKER - pad)


def decode_bytes(data: memoryview, pos: int) -> tuple[bytes, int]:
    out = bytearray()
    while True:
        grp = bytes(data[pos : pos + _GROUP])
        marker = data[pos + _GROUP]
        pos += _GROUP + 1
        pad = _MARKER - marker
        out += grp[: _GROUP - pad]
        if pad > 0:
            break
    return bytes(out), pos


def encode_float(buf: bytearray, f: float) -> None:
    buf.append(FLOAT_FLAG)
    (u,) = struct.unpack(">Q", struct.pack(">d", f))
    if u & _SIGN_MASK:
        u = ~u & 0xFFFFFFFFFFFFFFFF
    else:
        u |= _SIGN_MASK
    buf += struct.pack(">Q", u)


def decode_float(data: memoryview, pos: int) -> tuple[float, int]:
    (u,) = struct.unpack_from(">Q", data, pos)
    if u & _SIGN_MASK:
        u &= ~_SIGN_MASK & 0xFFFFFFFFFFFFFFFF
    else:
        u = ~u & 0xFFFFFFFFFFFFFFFF
    return struct.unpack(">d", struct.pack(">Q", u))[0], pos + 8


def encode_decimal(buf: bytearray, value: int, scale: int) -> None:
    """Exact memcomparable decimal (ref: util/codec/decimal.go idea).

    Layout after the flag: sign byte (0 neg / 1 zero / 2 pos), then for
    non-zero values an exponent byte (count of integer digits + 128) and
    the significant digits (one byte each, digit+1) with a 0x00 terminator;
    negative values complement every post-sign byte so byte order flips.
    Trailing zeros are normalized away, so equal values encode identically
    regardless of scale.
    """
    buf.append(DECIMAL_FLAG)
    if value == 0:
        buf.append(1)
        return
    neg = value < 0
    digits = str(abs(value))
    # exponent: digits to the left of the decimal point
    exp = len(digits) - scale
    digits = digits.rstrip("0") or "0"
    body = bytearray()
    body.append((exp + 128) & 0xFF)
    body += bytes(int(c) + 1 for c in digits)
    body.append(0x00)
    if neg:
        buf.append(0)
        buf += bytes(255 - b for b in body)
    else:
        buf.append(2)
        buf += body


def decode_decimal(data: memoryview, pos: int) -> tuple["Dec", int]:
    from ..mysqltypes.mydecimal import Dec

    sign = data[pos]
    pos += 1
    if sign == 1:
        return Dec(0, 0), pos
    neg = sign == 0
    raw = bytearray()
    while True:
        b = data[pos]
        pos += 1
        if neg:
            b = 255 - b
        if len(raw) > 0 and b == 0x00:
            break
        raw.append(b)
    exp = raw[0] - 128
    digits = "".join(str(b - 1) for b in raw[1:])
    value = int(digits)
    scale = max(len(digits) - exp, 0)
    if exp > len(digits):
        value *= 10 ** (exp - len(digits))
    return Dec(-value if neg else value, scale), pos


def encode_datum_key(buf: bytearray, d: Datum) -> None:
    """Encode one datum in memcomparable form (for index keys / sort keys).

    Times/durations ride the int path (packed int64 order == chronological
    order); decimals use the exact sign/exponent/digits encoding.
    """
    k = d.kind
    if k == K_NULL:
        buf.append(NIL_FLAG)
    elif k in (K_INT, K_TIME, K_DUR):
        encode_int(buf, d.val)
    elif k == K_UINT:
        encode_uint(buf, d.val)
    elif k == K_FLOAT:
        encode_float(buf, d.val)
    elif k == K_DEC:
        encode_decimal(buf, d.val.value, d.val.scale)
    elif k == K_STR:
        encode_bytes(buf, d.val.encode("utf8"))
    elif k == K_BYTES:
        encode_bytes(buf, d.val)
    else:
        raise TypeError(f"cannot key-encode kind {k}")


def decode_datum_key(data: memoryview, pos: int) -> tuple[Datum, int]:
    flag = data[pos]
    pos += 1
    if flag == NIL_FLAG:
        return Datum.null(), pos
    if flag == INT_FLAG:
        v, pos = decode_int(data, pos)
        return Datum.i(v), pos
    if flag == UINT_FLAG:
        (u,) = struct.unpack_from(">Q", data, pos)
        return Datum.u(u), pos + 8
    if flag == FLOAT_FLAG:
        f, pos = decode_float(data, pos)
        return Datum.f(f), pos
    if flag == BYTES_FLAG:
        b, pos = decode_bytes(data, pos)
        return Datum.b(b), pos
    if flag == DECIMAL_FLAG:
        dec, pos = decode_decimal(data, pos)
        return Datum(K_DEC, dec), pos
    raise ValueError(f"bad key flag {flag:#x}")
