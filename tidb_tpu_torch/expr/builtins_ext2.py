"""Builtin registry extension II (copy of tidb_tpu/expr/builtins_ext2.py) —
crypto/encoding, regexp, network,
temporal arithmetic tail (ref: expression/builtin_encryption.go,
builtin_regexp*.go, builtin_miscellaneous.go, builtin_time.go; same
one-kernel architecture as builtins.py). Imported by builtins_ext.py."""

from __future__ import annotations

import base64 as _b64
import datetime as _dt
import hashlib as _hl
import ipaddress as _ip
import os as _os
import re as _re
import time as _time
import uuid as _uuid
import zlib as _zlib

import numpy as np

from ..mysqltypes import coretime as _ct
from ..mysqltypes.field_type import FieldType, TypeCode, ft_double, ft_longlong, ft_varchar
from .builtins import _as_str, _obj_map
from .builtins_ext import _packed_to_date, _multi_str
from .expression import FuncSig, register, is_host

_US = 1_000_000


def _null():
    """Sentinel: raise so _obj_map marks the row NULL."""
    raise ValueError("NULL")


# ---------------------------------------------------------------------------
# bitwise operators (ref: builtin_op.go; MySQL bit ops are uint64)
# ---------------------------------------------------------------------------


def _bit_kernel(op):
    def kernel(xp, avals, fts, ret_ft):
        (a, va), (b, vb) = avals
        a = xp.asarray(a).astype(xp.int64)
        b = xp.asarray(b).astype(xp.int64)
        return op(xp, a, b), va & vb

    return kernel


register(FuncSig("bitor", lambda fts: ft_longlong(True), _bit_kernel(lambda xp, a, b: a | b), arity=2))
register(FuncSig("bitand", lambda fts: ft_longlong(True), _bit_kernel(lambda xp, a, b: a & b), arity=2))
register(FuncSig("bitxor", lambda fts: ft_longlong(True), _bit_kernel(lambda xp, a, b: a ^ b), arity=2))
register(FuncSig("lshift", lambda fts: ft_longlong(True), _bit_kernel(lambda xp, a, b: xp.where((b >= 0) & (b < 64), a << (b & 63), 0)), arity=2))
register(FuncSig("rshift", lambda fts: ft_longlong(True), _bit_kernel(
    lambda xp, a, b: xp.where((b >= 0) & (b < 64),
                              (a.view(xp.uint64) if is_host(xp) else a.astype("uint64")) >> (b.astype("uint64") & xp.uint64(63)), 0).astype(xp.int64)), arity=2))
register(FuncSig(
    "bitneg", lambda fts: ft_longlong(True),
    lambda xp, avals, fts, ret_ft: (~xp.asarray(avals[0][0]).astype(xp.int64), avals[0][1]),
    arity=1,
))


# ---------------------------------------------------------------------------
# hashes / encodings (ref: builtin_encryption.go)
# ---------------------------------------------------------------------------

def _as_bytes(v) -> bytes:
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    return _as_str(v).encode("utf8")


register(FuncSig("md5", lambda fts: ft_varchar(32), _obj_map(lambda s: _hl.md5(_as_bytes(s)).hexdigest()), pushable=False, arity=1))
register(FuncSig("sha1", lambda fts: ft_varchar(40), _obj_map(lambda s: _hl.sha1(_as_bytes(s)).hexdigest()), pushable=False, arity=1))
register(FuncSig("sha", lambda fts: ft_varchar(40), _obj_map(lambda s: _hl.sha1(_as_bytes(s)).hexdigest()), pushable=False, arity=1))


def _sha2(s, bits):
    bits = int(bits) or 256
    algo = {224: _hl.sha224, 256: _hl.sha256, 384: _hl.sha384, 512: _hl.sha512}.get(bits)
    if algo is None:
        _null()  # MySQL: invalid hash length → NULL
    return algo(_as_bytes(s)).hexdigest()


register(FuncSig("sha2", lambda fts: ft_varchar(128), _obj_map(_sha2), pushable=False, arity=2))
register(FuncSig("to_base64", lambda fts: ft_varchar(), _obj_map(lambda s: _b64.b64encode(_as_bytes(s)).decode()), pushable=False, arity=1))
register(FuncSig("from_base64", lambda fts: ft_varchar(), _obj_map(lambda s: _b64.b64decode(_as_str(s), validate=True)), pushable=False, arity=1))


def _compress(s):
    b = _as_bytes(s)
    if not b:
        return b""
    return len(b).to_bytes(4, "little") + _zlib.compress(b)


def _uncompress(s):
    b = _as_bytes(s)
    if not b:
        return b""
    return _zlib.decompress(b[4:])


register(FuncSig("compress", lambda fts: ft_varchar(), _obj_map(_compress), pushable=False, arity=1))
register(FuncSig("uncompress", lambda fts: ft_varchar(), _obj_map(_uncompress), pushable=False, arity=1))
register(FuncSig("uncompressed_length", lambda fts: ft_longlong(), _obj_map(lambda s: 0 if not _as_bytes(s) else int.from_bytes(_as_bytes(s)[:4], "little")), pushable=False, arity=1))
register(FuncSig("random_bytes", lambda fts: ft_varchar(), _obj_map(lambda n: _os.urandom(int(n)) if 0 < int(n) <= 1024 else _null()), pushable=False, arity=1))


def _mysql_aes_key(key: bytes, bits: int = 128) -> bytes:
    """MySQL's key folding: XOR key bytes cyclically into the key buffer."""
    n = bits // 8
    out = bytearray(n)
    for i, b in enumerate(key):
        out[i % n] ^= b
    return bytes(out)


try:  # optional acceleration: only AES_ENCRYPT/DECRYPT use it
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
except ImportError:
    Cipher = None  # pure-Python `_aes` fallback takes over


def _ecb_encrypt(raw: bytes, key: bytes) -> bytes:
    if Cipher is not None:
        enc = Cipher(algorithms.AES(key), modes.ECB()).encryptor()
        return enc.update(raw) + enc.finalize()
    from ._aes import ecb_encrypt

    return ecb_encrypt(raw, key)


def _ecb_decrypt(raw: bytes, key: bytes) -> bytes:
    if Cipher is not None:
        dec = Cipher(algorithms.AES(key), modes.ECB()).decryptor()
        return dec.update(raw) + dec.finalize()
    from ._aes import ecb_decrypt

    return ecb_decrypt(raw, key)


def _aes_encrypt(data, key):
    raw = _as_bytes(data)
    pad = 16 - len(raw) % 16
    raw += bytes([pad]) * pad  # PKCS7, always padded (MySQL semantics)
    return _ecb_encrypt(raw, _mysql_aes_key(_as_bytes(key)))


def _aes_decrypt(data, key):
    raw = _as_bytes(data)
    if not raw or len(raw) % 16:
        _null()
    out = _ecb_decrypt(raw, _mysql_aes_key(_as_bytes(key)))
    pad = out[-1]
    if not 1 <= pad <= 16 or out[-pad:] != bytes([pad]) * pad:
        _null()  # wrong key → invalid padding → NULL (MySQL)
    out = out[:-pad]
    try:
        return out.decode("utf8")
    except UnicodeDecodeError:
        return out


register(FuncSig("aes_encrypt", lambda fts: ft_varchar(), _obj_map(_aes_encrypt), pushable=False, arity=2))
register(FuncSig("aes_decrypt", lambda fts: ft_varchar(), _obj_map(_aes_decrypt), pushable=False, arity=2))


def _password(s):
    """MySQL's password hash: '*' + HEX(SHA1(SHA1(pw))) (the reference's
    privilege/cache.mysql_native_hash)."""
    pw = _as_str(s)
    if not pw:
        return ""
    return "*" + _hl.sha1(_hl.sha1(pw.encode()).digest()).hexdigest().upper()


register(FuncSig("password", lambda fts: ft_varchar(41), _obj_map(_password), pushable=False, arity=1))

# ---------------------------------------------------------------------------
# string tail (ref: builtin_string.go)
# ---------------------------------------------------------------------------

register(FuncSig("find_in_set", lambda fts: ft_longlong(), _obj_map(
    lambda s, l: 0 if "," in _as_str(s) else (
        (_as_str(l).split(",").index(_as_str(s)) + 1) if _as_str(s) in _as_str(l).split(",") else 0)),
    pushable=False, arity=2))


def _nullable_args(fn, infer, name, arity):
    """Kernel passing per-row python values with None for NULL args —
    for functions that SKIP null arguments rather than return NULL
    (MAKE_SET, CHAR; ref: builtin_string.go)."""

    def kernel(xp, avals, fts, ret_ft):
        datas = [np.asarray(d).reshape(-1) for d, _ in avals]
        vs = [np.asarray(v).reshape(-1) for _, v in avals]
        n = max((len(d) for d in datas), default=1)
        out = np.empty(n, dtype=object)
        valid = np.ones(n, dtype=bool)
        for i in range(n):
            args = [d[i % len(d)] if len(vv) and vv[i % len(vv)] else None
                    for d, vv in zip(datas, vs)]
            try:
                out[i] = fn(*args)
            except Exception:  # noqa: BLE001 — malformed input → SQL NULL
                valid[i] = False
        return out, valid

    return FuncSig(name, infer, kernel, pushable=False, arity=arity)


def _make_set(bits, *strs):
    if bits is None:
        _null()
    bits = int(bits)
    return ",".join(_as_str(s) for i, s in enumerate(strs)
                    if s is not None and bits & (1 << i))


register(_nullable_args(_make_set, lambda fts: ft_varchar(), "make_set", (2, None)))
register(FuncSig("quote", lambda fts: ft_varchar(), _obj_map(
    lambda s: "'" + _as_str(s).replace("\\", "\\\\").replace("'", "\\'")
    .replace("\x00", "\\0").replace("\x1a", "\\Z") + "'"), pushable=False, arity=1))


def _soundex(s):
    s = _as_str(s).upper()
    s = "".join(c for c in s if c.isalpha())
    if not s:
        return ""
    codes = {**{c: "1" for c in "BFPV"}, **{c: "2" for c in "CGJKQSXZ"},
             **{c: "3" for c in "DT"}, "L": "4", **{c: "5" for c in "MN"}, "R": "6"}
    out = s[0]
    prev = codes.get(s[0], "")
    for c in s[1:]:
        code = codes.get(c, "")
        if code and code != prev:
            out += code
        if c not in "HW":
            prev = code
    return (out + "000")[:4] if len(out) < 4 else out


register(FuncSig("soundex", lambda fts: ft_varchar(8), _obj_map(_soundex), pushable=False, arity=1))


def _export_set(bits, on, off, *rest):
    sep = _as_str(rest[0]) if len(rest) >= 1 else ","
    n = int(rest[1]) if len(rest) >= 2 else 64
    n = min(max(n, 0), 64)
    bits = int(bits)
    return sep.join(_as_str(on) if bits & (1 << i) else _as_str(off) for i in range(n))


register(_multi_str(_export_set, name="export_set", arity=(3, 5)))


def _insert_str(s, pos, ln, new):
    s, pos, ln, new = _as_str(s), int(pos), int(ln), _as_str(new)
    if pos < 1 or pos > len(s):
        return s
    if ln < 0 or pos + ln - 1 >= len(s):
        return s[: pos - 1] + new
    return s[: pos - 1] + new + s[pos - 1 + ln:]


register(FuncSig("insert", lambda fts: ft_varchar(), _obj_map(_insert_str), pushable=False, arity=4))
register(FuncSig("bit_length", lambda fts: ft_longlong(), _obj_map(lambda s: len(_as_bytes(s)) * 8), pushable=False, arity=1))
register(FuncSig("ord", lambda fts: ft_longlong(), _obj_map(lambda s: ord(_as_str(s)[0]) if _as_str(s) else 0), pushable=False, arity=1))
register(_nullable_args(
    lambda *xs: "".join(chr(int(x) & 0xFF) if int(x) < 256 else chr(int(x)) for x in xs if x is not None),
    lambda fts: ft_varchar(), "char", (1, None)))


def _format_kernel(xp, avals, fts, ret_ft):
    from .expression import lane_as_float

    # decimal lanes are scaled ints: coerce via the type-aware helper
    fx = lane_as_float(np, np.asarray(avals[0][0]).reshape(-1), fts[0])
    scaled = [(fx, avals[0][1]), avals[1]]
    return _obj_map(lambda x, d: f"{float(x):,.{max(int(d), 0)}f}")(xp, scaled, fts, ret_ft)


register(FuncSig("format", lambda fts: ft_varchar(), _format_kernel, pushable=False, arity=2))
register(FuncSig("bin", lambda fts: ft_varchar(64), _obj_map(lambda x: format(int(x) & ((1 << 64) - 1) if int(x) < 0 else int(x), "b")), pushable=False, arity=1))
register(FuncSig("oct", lambda fts: ft_varchar(64), _obj_map(lambda x: format(int(x) & ((1 << 64) - 1) if int(x) < 0 else int(x), "o")), pushable=False, arity=1))


def _conv(s, from_b, to_b):
    from_b, to_b = int(from_b), int(to_b)
    if not (2 <= abs(from_b) <= 36 and 2 <= abs(to_b) <= 36):
        _null()
    v = int(_as_str(s).strip() or "0", abs(from_b))
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    if v == 0:
        return "0"
    neg = v < 0 and to_b < 0
    v = abs(v)
    out = ""
    while v:
        out = digits[v % abs(to_b)] + out
        v //= abs(to_b)
    return ("-" if neg else "") + out


register(FuncSig("conv", lambda fts: ft_varchar(64), _obj_map(_conv), pushable=False, arity=3))

# ---------------------------------------------------------------------------
# regexp family (ref: builtin_regexp.go; MySQL default is case-insensitive
# for nonbinary strings)
# ---------------------------------------------------------------------------


def _re_compile(pat):
    return _re.compile(_as_str(pat), _re.IGNORECASE)


register(FuncSig("regexp_like", lambda fts: ft_longlong(), _obj_map(
    lambda s, p: 1 if _re_compile(p).search(_as_str(s)) else 0), pushable=False, arity=2))
# the REGEXP/RLIKE operator desugars to the same kernel (ref: builtin.go ast.Regexp)
register(FuncSig("regexp", lambda fts: ft_longlong(), _obj_map(
    lambda s, p: 1 if _re_compile(p).search(_as_str(s)) else 0), pushable=False, arity=2))
register(FuncSig("regexp_replace", lambda fts: ft_varchar(), _obj_map(
    lambda s, p, r: _re_compile(p).sub(_as_str(r), _as_str(s))), pushable=False, arity=3))


def _regexp_substr(s, p):
    m = _re_compile(p).search(_as_str(s))
    if m is None:
        _null()
    return m.group(0)


register(FuncSig("regexp_substr", lambda fts: ft_varchar(), _obj_map(_regexp_substr), pushable=False, arity=2))
register(FuncSig("regexp_instr", lambda fts: ft_longlong(), _obj_map(
    lambda s, p: (m.start() + 1) if (m := _re_compile(p).search(_as_str(s))) else 0), pushable=False, arity=2))

# ---------------------------------------------------------------------------
# network / misc (ref: builtin_miscellaneous.go)
# ---------------------------------------------------------------------------


def _inet_aton(s):
    parts = _as_str(s).split(".")
    if not 1 <= len(parts) <= 4:
        _null()
    try:
        nums = [int(p) for p in parts]
    except ValueError:
        _null()
    if any(not 0 <= x <= 255 for x in nums[:-1]) or nums[-1] < 0:
        _null()
    # MySQL: 'a.b' == a<<24 | b etc (last part fills the remaining bytes)
    v = 0
    for x in nums[:-1]:
        v = (v << 8) | x
    v = (v << (8 * (5 - len(parts)))) | nums[-1]
    return v


register(FuncSig("inet_aton", lambda fts: ft_longlong(), _obj_map(_inet_aton), pushable=False, arity=1))
register(FuncSig("inet_ntoa", lambda fts: ft_varchar(15), _obj_map(
    lambda x: str(_ip.IPv4Address(int(x))) if 0 <= int(x) <= 0xFFFFFFFF else _null()), pushable=False, arity=1))
register(FuncSig("inet6_aton", lambda fts: ft_varchar(16), _obj_map(
    lambda s: _ip.ip_address(_as_str(s)).packed), pushable=False, arity=1))
register(FuncSig("inet6_ntoa", lambda fts: ft_varchar(39), _obj_map(
    lambda b: str(_ip.ip_address(bytes(b) if isinstance(b, (bytes, bytearray)) else _as_str(b).encode("latin1")))), pushable=False, arity=1))


def _is_ipv4(s):
    try:
        _ip.IPv4Address(_as_str(s))
        return 1
    except ValueError:
        return 0


def _is_ipv6(s):
    try:
        _ip.IPv6Address(_as_str(s))
        return 1
    except ValueError:
        return 0


register(FuncSig("is_ipv4", lambda fts: ft_longlong(), _obj_map(_is_ipv4), pushable=False, arity=1))
register(FuncSig("is_ipv6", lambda fts: ft_longlong(), _obj_map(_is_ipv6), pushable=False, arity=1))
register(_multi_str(lambda: str(_uuid.uuid1()), name="uuid", arity=0))
register(FuncSig("any_value", lambda fts: fts[0], lambda xp, avals, fts, ret_ft: avals[0], pushable=False, arity=1))


def _sleep(x):
    _time.sleep(min(max(float(x), 0.0), 10.0))  # capped: protect tests/server
    return 0


register(FuncSig("sleep", lambda fts: ft_longlong(), _obj_map(_sleep), pushable=False, arity=1))

# ---------------------------------------------------------------------------
# temporal arithmetic tail (ref: builtin_time.go)
# ---------------------------------------------------------------------------

_DUR_RE = _re.compile(r"^(-)?(\d+):(\d{1,2})(?::(\d{1,2})(?:\.(\d{1,6}))?)?$")


def _parse_duration_us(v) -> int:
    """'[-]HH:MM[:SS[.ffffff]]' or duration-lane int → microseconds."""
    if isinstance(v, (int, np.integer)):
        return int(v)
    m = _DUR_RE.match(_as_str(v).strip())
    if m is None:
        # bare seconds number?
        try:
            return int(float(_as_str(v)) * _US)
        except ValueError:
            _null()
    sign = -1 if m.group(1) else 1
    h, mi = int(m.group(2)), int(m.group(3))
    s = int(m.group(4) or 0)
    frac = int((m.group(5) or "0").ljust(6, "0"))
    return sign * (((h * 60 + mi) * 60 + s) * _US + frac)


def _fmt_duration(us: int) -> str:
    sign = "-" if us < 0 else ""
    us = abs(us)
    s, frac = divmod(us, _US)
    h, rem = divmod(s, 3600)
    mi, sec = divmod(rem, 60)
    out = f"{sign}{h:02d}:{mi:02d}:{sec:02d}"
    if frac:
        out += f".{frac:06d}".rstrip("0")
    return out


_DATE_RE = _re.compile(r"^\s*\d{2,4}-\d{1,2}-\d{1,2}")


def _is_datetime_like(v) -> bool:
    # a leading '-' is a negative duration, not a date
    return isinstance(v, (int, np.integer)) or bool(_DATE_RE.match(_as_str(v)))


def _addtime_like(sign):
    def fn(a, b):
        dus = _parse_duration_us(b)
        if _is_datetime_like(a):  # packed lane int or 'Y-m-d ...' string
            p = int(a) if isinstance(a, (int, np.integer)) else _ct.parse_datetime(_as_str(a))
            if p is None:
                _null()
            t = _packed_to_date(p)
            if t is None:
                _null()
            t2 = t + _dt.timedelta(microseconds=sign * dus)
            return t2.strftime("%Y-%m-%d %H:%M:%S") + (f".{t2.microsecond:06d}" if t2.microsecond else "")
        return _fmt_duration(_parse_duration_us(a) + sign * dus)

    return fn


def _temporal_obj(fn):
    """_obj_map with duration-typed int lanes rendered to 'HH:MM:SS'
    strings first — a TIME column's microsecond lane must not be read as
    a packed datetime."""

    def kernel(xp, avals, fts, ret_ft):
        conv = []
        for (d, v), ft in zip(avals, fts):
            dd = np.asarray(d).reshape(-1)
            if dd.dtype != object and ft is not None and ft.tp == TypeCode.Duration:
                dd = np.array([_fmt_duration(int(x)) for x in dd], dtype=object)
            conv.append((dd, v))
        return _obj_map(fn)(xp, conv, fts, ret_ft)

    return kernel


register(FuncSig("addtime", lambda fts: ft_varchar(32), _temporal_obj(_addtime_like(+1)), pushable=False, arity=2))
register(FuncSig("subtime", lambda fts: ft_varchar(32), _temporal_obj(_addtime_like(-1)), pushable=False, arity=2))


def _timediff(a, b):
    sa, sb = _as_str(a), _as_str(b)
    if _is_datetime_like(a) != _is_datetime_like(b):
        _null()  # mixed datetime/time operands → NULL (MySQL)
    if _is_datetime_like(a):
        pa, pb = _ct.parse_datetime(sa), _ct.parse_datetime(sb)
        if pa is None or pb is None:
            _null()
        ta, tb = _packed_to_date(pa), _packed_to_date(pb)
        return _fmt_duration(int((ta - tb).total_seconds() * _US))
    return _fmt_duration(_parse_duration_us(a) - _parse_duration_us(b))


register(FuncSig("timediff", lambda fts: ft_varchar(32), _temporal_obj(_timediff), pushable=False, arity=2))
register(FuncSig("maketime", lambda fts: ft_varchar(32), _obj_map(
    lambda h, m, s: _fmt_duration(int(((abs(int(h)) * 60 + int(m)) * 60 + float(s)) * _US) * (-1 if int(h) < 0 else 1)) if 0 <= int(m) < 60 and 0 <= float(s) < 60 else _null()),
    pushable=False, arity=3))


def _makedate(y, dy):
    y, dy = int(y), int(dy)
    if dy <= 0:
        _null()
    if y < 70:
        y += 2000
    elif y < 100:
        y += 1900
    try:
        d = _dt.date(y, 1, 1) + _dt.timedelta(days=dy - 1)
    except OverflowError:
        _null()
    return d.strftime("%Y-%m-%d")


register(FuncSig("makedate", lambda fts: ft_varchar(10), _obj_map(_makedate), pushable=False, arity=2))


def _to_date(v):
    if isinstance(v, (int, np.integer)):
        t = _packed_to_date(int(v))
    else:
        p = _ct.parse_datetime(_as_str(v))
        t = _packed_to_date(p) if p is not None else None
    if t is None:
        _null()
    return t


# MySQL day numbers count from year 0 — 365 days before Python's
# proleptic ordinal epoch (0001-01-01): TO_DAYS('1970-01-01') = 719528
_MYSQL_DAY0 = 365

register(FuncSig("to_days", lambda fts: ft_longlong(), _obj_map(lambda v: _to_date(v).toordinal() + _MYSQL_DAY0), pushable=False, arity=1))
register(FuncSig("from_days", lambda fts: ft_varchar(10), _obj_map(
    lambda n: _dt.date.fromordinal(int(n) - _MYSQL_DAY0).strftime("%Y-%m-%d") if int(n) > 730 else _null()), pushable=False, arity=1))
register(FuncSig("to_seconds", lambda fts: ft_longlong(), _obj_map(
    lambda v: (lambda t: (t.toordinal() + _MYSQL_DAY0) * 86400 + t.hour * 3600 + t.minute * 60 + t.second)(_to_date(v))), pushable=False, arity=1))


def _period_to_months(p):
    p = int(p)
    y, m = divmod(p, 100)
    if y < 70:
        y += 2000
    elif y < 100:
        y += 1900
    return y * 12 + m - 1


def _months_to_period(months):
    y, m = divmod(months, 12)
    return y * 100 + m + 1


register(FuncSig("period_add", lambda fts: ft_longlong(), _obj_map(
    lambda p, n: _months_to_period(_period_to_months(p) + int(n))), pushable=False, arity=2))
register(FuncSig("period_diff", lambda fts: ft_longlong(), _obj_map(
    lambda a, b: _period_to_months(a) - _period_to_months(b)), pushable=False, arity=2))
def _days_in_year(y: int) -> int:
    return 366 if (y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)) else 365


def _calc_week(d: _dt.date, mode: int):
    """MySQL's calc_week bit semantics (WEEK_MONDAY_FIRST=1, WEEK_YEAR=2,
    WEEK_FIRST_WEEKDAY=4) — the spec behind WEEK()/YEARWEEK() modes 0-7
    (ref: expression/builtin_time.go calcWeek)."""
    monday_first = bool(mode & 1)
    week_year = bool(mode & 2)
    first_weekday = bool(mode & 4)
    daynr = d.toordinal()
    jan1 = _dt.date(d.year, 1, 1)
    first_daynr = jan1.toordinal()
    wd = jan1.weekday()  # Monday=0
    weekday = wd if monday_first else (wd + 1) % 7
    year = d.year
    if d.month == 1 and d.day <= 7 - weekday:
        if not week_year and (
            (first_weekday and weekday != 0) or (not first_weekday and weekday >= 4)
        ):
            return year, 0
        week_year = True
        year -= 1
        diy = _days_in_year(year)
        first_daynr -= diy
        weekday = (weekday + 53 * 7 - diy) % 7
    if (first_weekday and weekday != 0) or (not first_weekday and weekday >= 4):
        days = daynr - (first_daynr + (7 - weekday))
    else:
        days = daynr - (first_daynr - weekday)
    if week_year and days >= 52 * 7:
        weekday = (weekday + _days_in_year(year)) % 7
        if (not first_weekday and weekday < 4) or (first_weekday and weekday == 0):
            return year + 1, 1
    return year, days // 7 + 1


def _week_mode(mode: int) -> int:
    mode &= 7
    if not (mode & 1):
        mode ^= 4
    return mode


def _default_week_mode() -> int:
    from . import sessioninfo

    try:
        return int((sessioninfo.get("vars") or {}).get("default_week_format", "0"))
    except (TypeError, ValueError):
        return 0


def _week(v, *mode):
    t = _to_date(v)
    d = t.date() if isinstance(t, _dt.datetime) else t
    m = int(mode[0]) if mode and mode[0] is not None else _default_week_mode()
    return _calc_week(d, _week_mode(m))[1]


def _yearweek2(v, *mode):
    t = _to_date(v)
    d = t.date() if isinstance(t, _dt.datetime) else t
    m = int(mode[0]) if mode and mode[0] is not None else _default_week_mode()
    y, w = _calc_week(d, _week_mode(m | 2))
    return y * 100 + w


register(FuncSig("week", lambda fts: ft_longlong(), _obj_map(_week), pushable=False, arity=(1, 2)))
register(FuncSig("yearweek", lambda fts: ft_longlong(), _obj_map(_yearweek2), pushable=False, arity=(1, 2)))
register(FuncSig("weekofyear", lambda fts: ft_longlong(), _obj_map(
    lambda v: _to_date(v).isocalendar()[1]), pushable=False, arity=1))
register(_multi_str(lambda: _dt.datetime.utcnow().strftime("%Y-%m-%d"), name="utc_date", arity=0))
register(_multi_str(lambda: _dt.datetime.utcnow().strftime("%Y-%m-%d %H:%M:%S"), name="utc_timestamp", arity=0))


def _time_of(v):
    s = _as_str(v)
    if " " in s:
        return s.split(" ", 1)[1]
    if isinstance(v, (int, np.integer)):
        t = _packed_to_date(int(v))
        if t is None:
            _null()
        return t.strftime("%H:%M:%S")
    return _fmt_duration(_parse_duration_us(v))


register(FuncSig("time", lambda fts: ft_varchar(32), _temporal_obj(_time_of), pushable=False, arity=1))

_STRPTIME = {
    "%Y": "%Y", "%y": "%y", "%m": "%m", "%c": "%m", "%d": "%d", "%e": "%d",
    "%H": "%H", "%k": "%H", "%h": "%I", "%I": "%I", "%i": "%M", "%s": "%S",
    "%S": "%S", "%p": "%p", "%f": "%f", "%b": "%b", "%M": "%B", "%a": "%a",
    "%W": "%A", "%j": "%j", "%%": "%%",
}


def _mysql_fmt_to_py(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt):
            tok = fmt[i : i + 2]
            out.append(_STRPTIME.get(tok, tok[1]))
            i += 2
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


def _str_to_date(s, fmt):
    try:
        t = _dt.datetime.strptime(_as_str(s), _mysql_fmt_to_py(_as_str(fmt)))
    except ValueError:
        _null()
    if t.hour or t.minute or t.second or t.microsecond:
        return t.strftime("%Y-%m-%d %H:%M:%S")
    return t.strftime("%Y-%m-%d")


register(FuncSig("str_to_date", lambda fts: ft_varchar(26), _obj_map(_str_to_date), pushable=False, arity=2))
register(FuncSig("time_format", lambda fts: ft_varchar(32), _obj_map(
    lambda v, f: (_dt.datetime(2000, 1, 1) + _dt.timedelta(microseconds=abs(_parse_duration_us(v)))).strftime(
        _mysql_fmt_to_py(_as_str(f)).replace("%H", f"{abs(_parse_duration_us(v)) // 3600000000:02d}"))),
    pushable=False, arity=2))

_UNIT_US = {
    "microsecond": 1, "second": _US, "minute": 60 * _US, "hour": 3600 * _US,
    "day": 86400 * _US, "week": 7 * 86400 * _US,
}


def _timestampdiff(unit, a, b):
    unit = _as_str(unit).lower()
    ta, tb = _to_date(a), _to_date(b)
    if unit in ("month", "quarter", "year"):
        months = (tb.year - ta.year) * 12 + tb.month - ta.month
        # partial months don't count
        if months > 0 and (tb.day, tb.time()) < (ta.day, ta.time()):
            months -= 1
        elif months < 0 and (tb.day, tb.time()) > (ta.day, ta.time()):
            months += 1
        return {"month": months, "quarter": int(months / 3), "year": int(months / 12)}[unit]
    us = int((tb - ta).total_seconds() * _US)
    return int(us / _UNIT_US[unit])


def _timestampadd(unit, n, v):
    unit = _as_str(unit).lower()
    t = _to_date(v)
    n = int(n)
    if unit in ("month", "quarter", "year"):
        months = n * {"month": 1, "quarter": 3, "year": 12}[unit]
        total = t.year * 12 + (t.month - 1) + months
        y, m = divmod(total, 12)
        day = min(t.day, [31, 29 if y % 4 == 0 and (y % 100 or y % 400 == 0) else 28,
                          31, 30, 31, 30, 31, 31, 30, 31, 30, 31][m])
        t2 = t.replace(year=y, month=m + 1, day=day)
    else:
        t2 = t + _dt.timedelta(microseconds=n * _UNIT_US[unit])
    if t2.hour or t2.minute or t2.second or t2.microsecond:
        return t2.strftime("%Y-%m-%d %H:%M:%S")
    return t2.strftime("%Y-%m-%d")


register(FuncSig("timestampdiff", lambda fts: ft_longlong(), _obj_map(_timestampdiff), pushable=False, arity=3))
register(FuncSig("timestampadd", lambda fts: ft_varchar(26), _obj_map(_timestampadd), pushable=False, arity=3))


def _extract(unit, v):
    unit = _as_str(unit).lower()
    t = _to_date(v)
    return {
        "year": t.year, "month": t.month, "day": t.day, "hour": t.hour,
        "minute": t.minute, "second": t.second, "microsecond": t.microsecond,
        "quarter": (t.month - 1) // 3 + 1, "week": t.isocalendar()[1],
        "year_month": t.year * 100 + t.month, "day_hour": t.day * 100 + t.hour,
    }.get(unit) if unit in ("year", "month", "day", "hour", "minute", "second",
                            "microsecond", "quarter", "week", "year_month",
                            "day_hour") else _null()


register(FuncSig("extract", lambda fts: ft_longlong(), _obj_map(_extract), pushable=False, arity=2))

from . import builtins_ext3  # noqa: E402,F401  (registration side effects)
