"""Builtin registry extension (copy of tidb_tpu/expr/builtins_ext.py) — date arithmetic, string/math breadth,
JSON functions, duration support (ref: expression/builtin_time.go,
builtin_string.go, builtin_math.go, builtin_json.go; same one-kernel
architecture as builtins.py). Imported by builtins.py at the end."""

from __future__ import annotations

import datetime as _dt
import json as _json
import math

import numpy as np

from ..mysqltypes import coretime as _ct
from ..mysqltypes.field_type import FieldType, TypeCode, ft_double, ft_longlong, ft_varchar
from .builtins import _as_str, _obj_map, infer_first
from .expression import lane_as_float
from .expression import FuncSig, register, is_host

_US = 1_000_000


def _ft_json() -> FieldType:
    return FieldType(TypeCode.JSON, flen=-1)


# ---------------------------------------------------------------------------
# date/time breadth
# ---------------------------------------------------------------------------


def _packed_lane(d, v, ft):
    """Datetime lane → (int64 packed, valid), parsing string lanes/consts
    per row (host path; device kernels only ever see typed int lanes)."""
    dd = np.asarray(d).reshape(-1)
    valid = np.asarray(v).reshape(-1)
    if dd.dtype == object or (ft is not None and ft.is_string()):
        out = np.zeros(len(dd), np.int64)
        valid = valid.copy()
        for i in np.nonzero(valid)[0]:
            p = _ct.parse_datetime(_as_str(dd[i]))
            if p is None:
                valid[i] = False
            else:
                out[i] = p
        return out, valid
    return dd.astype(np.int64), valid


def _packed_to_date(p: int) -> _dt.datetime | None:
    y, mo, d, h, mi, s, us = _ct.unpack_time(int(p))
    try:
        return _dt.datetime(y, mo, d, h, mi, s, us)
    except ValueError:
        return None


def _date_to_packed(t: _dt.datetime) -> int:
    return _ct.pack_time(t.year, t.month, t.day, t.hour, t.minute, t.second, t.microsecond)


_INTERVAL_UNITS = {
    "microsecond": lambda n: _dt.timedelta(microseconds=n),
    "second": lambda n: _dt.timedelta(seconds=n),
    "minute": lambda n: _dt.timedelta(minutes=n),
    "hour": lambda n: _dt.timedelta(hours=n),
    "day": lambda n: _dt.timedelta(days=n),
    "week": lambda n: _dt.timedelta(weeks=n),
}


def _add_months(t: _dt.datetime, n: int) -> _dt.datetime:
    m = t.year * 12 + (t.month - 1) + n
    year, month = divmod(m, 12)
    month += 1
    # clamp day to the target month's length (MySQL semantics)
    for day in (t.day, 30, 29, 28):
        try:
            return t.replace(year=year, month=month, day=day)
        except ValueError:
            continue
    raise ValueError("unreachable")


def _date_addsub_kernel(sign: int):
    def kernel(xp, avals, fts, ret_ft):
        (d, v), (nd, nv), (ud, uv) = avals
        dd, dv = _packed_lane(d, v, fts[0])
        n = len(dd)
        out = np.zeros(n, dtype=np.int64)
        valid = (dv & np.asarray(nv).reshape(-1) & np.asarray(uv).reshape(-1)).copy()
        nn = np.asarray(nd).reshape(-1)
        uu = np.asarray(ud).reshape(-1)
        for i in np.nonzero(valid)[0]:
            t = _packed_to_date(dd[i])
            if t is None:
                valid[i] = False
                continue
            unit = _as_str(uu[i if len(uu) > 1 else 0]).lower()
            amount = sign * int(nn[i])
            if unit in _INTERVAL_UNITS:
                t2 = t + _INTERVAL_UNITS[unit](amount)
            elif unit == "month":
                t2 = _add_months(t, amount)
            elif unit in ("quarter",):
                t2 = _add_months(t, amount * 3)
            elif unit == "year":
                t2 = _add_months(t, amount * 12)
            else:
                valid[i] = False
                continue
            out[i] = _date_to_packed(t2)
        return out, valid

    return kernel


def _infer_datetime(fts):
    ft = FieldType(TypeCode.Datetime)
    ft.decimal = max(fts[0].decimal, 0) if fts and fts[0].is_time() else 0
    return ft


register(FuncSig("date_add", _infer_datetime, _date_addsub_kernel(+1), pushable=False, arity=3))
register(FuncSig("date_sub", _infer_datetime, _date_addsub_kernel(-1), pushable=False, arity=3))
register(FuncSig("adddate", _infer_datetime, _date_addsub_kernel(+1), pushable=False, arity=3))
register(FuncSig("subdate", _infer_datetime, _date_addsub_kernel(-1), pushable=False, arity=3))


def _date_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    if is_host(xp):
        d, v = _packed_lane(d, v, fts[0])
    # truncate time-of-day: packed layout divides evenly at the day radix
    day = _ct.DIV_DAY
    return (d.astype(xp.int64) // day) * day, v


register(FuncSig("date", lambda fts: FieldType(TypeCode.Date), _date_kernel, arity=1))


def _per_row_time(fn, ret="int"):
    def kernel(xp, avals, fts, ret_ft):
        d, v = avals[0]
        dd, valid = _packed_lane(d, v, fts[0] if fts else None)
        n = len(dd)
        out = np.empty(n, dtype=object) if ret == "str" else np.zeros(n, dtype=np.int64)
        valid = valid.copy()
        for i in np.nonzero(valid)[0]:
            t = _packed_to_date(dd[i])
            if t is None:
                valid[i] = False
                continue
            out[i] = fn(t)
        return out, valid

    return kernel


register(FuncSig("dayofweek", lambda fts: ft_longlong(), _per_row_time(lambda t: t.isoweekday() % 7 + 1), pushable=False, arity=1))
register(FuncSig("weekday", lambda fts: ft_longlong(), _per_row_time(lambda t: t.weekday()), pushable=False, arity=1))
register(FuncSig("dayofyear", lambda fts: ft_longlong(), _per_row_time(lambda t: t.timetuple().tm_yday), pushable=False, arity=1))
register(FuncSig("quarter", lambda fts: ft_longlong(), _per_row_time(lambda t: (t.month - 1) // 3 + 1), pushable=False, arity=1))
# week/yearweek: mode-aware _calc_week implementations in builtins_ext2
register(FuncSig("dayname", lambda fts: ft_varchar(16), _per_row_time(lambda t: t.strftime("%A"), "str"), pushable=False, arity=1))
register(FuncSig("monthname", lambda fts: ft_varchar(16), _per_row_time(lambda t: t.strftime("%B"), "str"), pushable=False, arity=1))
register(
    FuncSig(
        "last_day",
        lambda fts: FieldType(TypeCode.Date),
        _per_row_time(
            lambda t: _date_to_packed(
                (_add_months(t.replace(day=1), 1) - _dt.timedelta(days=1)).replace(
                    hour=0, minute=0, second=0, microsecond=0
                )
            )
        ),
        pushable=False,
        arity=1,
    )
)
def _unix_ts_kernel(xp, avals, fts, ret_ft):
    if not avals:  # UNIX_TIMESTAMP() == now
        import time as _time

        return int(_time.time()), True
    return _per_row_time(lambda t: int(t.replace(tzinfo=_dt.timezone.utc).timestamp()))(
        xp, avals, fts, ret_ft
    )


register(FuncSig("unix_timestamp", lambda fts: ft_longlong(), _unix_ts_kernel, pushable=False, arity=(0, 1)))


def _from_unixtime_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    dd = np.asarray(d).reshape(-1)
    fmt_lane = np.asarray(avals[1][0]).reshape(-1) if len(avals) > 1 else None
    out = np.empty(len(dd), dtype=object) if fmt_lane is not None else np.zeros(len(dd), dtype=np.int64)
    valid = np.asarray(v).reshape(-1).copy()
    if fmt_lane is not None:
        valid = valid & np.asarray(avals[1][1]).reshape(-1)
    for i in np.nonzero(valid)[0]:
        t = _dt.datetime.fromtimestamp(float(dd[i]), tz=_dt.timezone.utc).replace(tzinfo=None)
        if fmt_lane is not None:
            fmt = _mysql_fmt_to_py(_as_str(fmt_lane[i if len(fmt_lane) > 1 else 0]))
            out[i] = t.strftime(fmt)
        else:
            out[i] = _date_to_packed(t)
    return out, valid


def _infer_from_unixtime(fts):
    if len(fts) > 1:
        return ft_varchar(64)
    return _infer_datetime(fts)


register(FuncSig("from_unixtime", _infer_from_unixtime, _from_unixtime_kernel, pushable=False, arity=(1, 2)))


def _datediff_kernel(xp, avals, fts, ret_ft):
    # calendar-day difference: the packed radix (32 day slots/month) is
    # NOT a day count, so go through real dates per row
    (a, av), (b, bv) = avals
    a, av = _packed_lane(a, av, fts[0])
    b, bv = _packed_lane(b, bv, fts[1])
    if len(a) != len(b):  # const vs lane broadcast
        if len(a) == 1:
            a, av = np.broadcast_to(a, b.shape), np.broadcast_to(av, bv.shape)
        else:
            b, bv = np.broadcast_to(b, a.shape), np.broadcast_to(bv, av.shape)
    out = np.zeros(len(a), dtype=np.int64)
    valid = np.asarray(av & bv).reshape(-1).copy()
    for i in np.nonzero(valid)[0]:
        ta, tb = _packed_to_date(a[i]), _packed_to_date(b[i])
        if ta is None or tb is None:
            valid[i] = False
            continue
        out[i] = (ta.date() - tb.date()).days
    return out, valid


register(FuncSig("datediff", lambda fts: ft_longlong(), _datediff_kernel, pushable=False, arity=2))

# single-pass specifier translation (sequential replace would collide:
# %i→%M then %M→%B)
_FMT_MAP = {
    "Y": "%Y", "y": "%y", "m": "%m", "d": "%d", "H": "%H", "i": "%M",
    "s": "%S", "S": "%S", "f": "%f", "M": "%B", "b": "%b", "W": "%A",
    "a": "%a", "e": "%-d", "c": "%-m", "T": "%H:%M:%S", "p": "%p",
    "r": "%I:%M:%S %p", "h": "%I", "I": "%I", "j": "%j", "%": "%%",
}
import re as _re

_FMT_RE = _re.compile(r"%(.)")


def _mysql_fmt_to_py(fmt: str) -> str:
    return _FMT_RE.sub(lambda m: _FMT_MAP.get(m.group(1), m.group(1)), fmt)


def _date_format_kernel(xp, avals, fts, ret_ft):
    (d, v), (fd, fv) = avals
    dd, valid = _packed_lane(d, v, fts[0])
    ff = np.asarray(fd).reshape(-1)
    out = np.empty(len(dd), dtype=object)
    valid = (valid & np.asarray(fv).reshape(-1)).copy()
    for i in np.nonzero(valid)[0]:
        t = _packed_to_date(dd[i])
        if t is None:
            valid[i] = False
            continue
        fmt = _mysql_fmt_to_py(_as_str(ff[i if len(ff) > 1 else 0]))
        out[i] = t.strftime(fmt)
    return out, valid


register(FuncSig("date_format", lambda fts: ft_varchar(64), _date_format_kernel, pushable=False, arity=2))


# --- duration helpers (K_DUR lanes are microseconds int64) -----------------


def _time_to_sec_kernel(xp, avals, fts, ret_ft):
    d, v = avals[0]
    src = fts[0]
    if src.tp == TypeCode.Duration:
        return d.astype(xp.int64) // _US, v
    # datetime: seconds within the day
    day_us = (d.astype(xp.int64) % _ct.DIV_DAY)
    return day_us // _US, v


register(FuncSig("time_to_sec", lambda fts: ft_longlong(), _time_to_sec_kernel, arity=1))
register(
    FuncSig(
        "sec_to_time",
        lambda fts: FieldType(TypeCode.Duration),
        lambda xp, avals, fts, ret_ft: (avals[0][0].astype(xp.int64) * _US, avals[0][1]),
        arity=1,
    )
)


# ---------------------------------------------------------------------------
# string breadth (host-only object-lane kernels)
# ---------------------------------------------------------------------------

register(FuncSig("ascii", lambda fts: ft_longlong(), _obj_map(lambda s: ord(_as_str(s)[0]) if _as_str(s) else 0), pushable=False, arity=1))
register(FuncSig("space", lambda fts: ft_varchar(255), _obj_map(lambda n: " " * max(int(n), 0)), pushable=False, arity=1))
register(FuncSig("hex", lambda fts: ft_varchar(255), _obj_map(
    lambda s: (bytes(s).hex().upper() if isinstance(s, (bytes, bytearray))
               else s.encode("utf8").hex().upper() if isinstance(s, str)
               # MySQL: negative ints hex as two's-complement uint64
               else format(int(s) & ((1 << 64) - 1), "X"))), pushable=False, arity=1))
register(FuncSig("unhex", lambda fts: ft_varchar(255), _obj_map(lambda s: bytes.fromhex(_as_str(s))), pushable=False, arity=1))
register(FuncSig("lcase", lambda fts: ft_varchar(255), _obj_map(lambda s: _as_str(s).lower()), pushable=False, arity=1))
register(FuncSig("ucase", lambda fts: ft_varchar(255), _obj_map(lambda s: _as_str(s).upper()), pushable=False, arity=1))


def _multi_str(fn, infer=lambda fts: ft_varchar(255), arity=None, name=None):
    from ..errors import TiDBError

    def kernel(xp, avals, fts, ret_ft):
        if not avals:  # zero-arg form (JSON_OBJECT(), JSON_ARRAY())
            r = fn()
            return r, r is not None
        n = max(len(np.asarray(d).reshape(-1)) for d, _ in avals)
        out = np.empty(n, dtype=object)
        valid = np.ones(n, dtype=bool)
        for _, v in avals:
            valid &= np.asarray(v).reshape(-1)
        cols = [np.asarray(d).reshape(-1) for d, _ in avals]
        for i in np.nonzero(valid)[0]:
            args = [c[i if len(c) > 1 else 0] for c in cols]
            try:
                r = fn(*args)
            except TiDBError:
                raise
            except Exception:  # noqa: BLE001 — malformed input → SQL NULL
                r = None
            if r is None:
                valid[i] = False
            else:
                out[i] = r
        return out, valid

    return FuncSig(name, infer, kernel, pushable=False, arity=arity)


register(_multi_str(lambda *a: _as_str(a[0]).join(_as_str(x) for x in a[1:]), name="concat_ws", arity=(2, None)))
register(_multi_str(lambda s, l, p: _as_str(s)[: int(l)] if len(_as_str(s)) >= int(l) else (_as_str(p) * int(l))[: max(int(l) - len(_as_str(s)), 0)] + _as_str(s), name="lpad", arity=3))
register(_multi_str(lambda s, l, p: _as_str(s)[: int(l)] if len(_as_str(s)) >= int(l) else _as_str(s) + (_as_str(p) * int(l))[: max(int(l) - len(_as_str(s)), 0)], name="rpad", arity=3))
register(_multi_str(lambda s, sub: _as_str(s).find(_as_str(sub)) + 1, infer=lambda fts: ft_longlong(), name="instr", arity=2))
register(_multi_str(lambda sub, s, *pos: _as_str(s).find(_as_str(sub), int(pos[0]) - 1 if pos else 0) + 1, infer=lambda fts: ft_longlong(), name="locate", arity=(2, 3)))
register(_multi_str(lambda sub, s: _as_str(s).find(_as_str(sub)) + 1, infer=lambda fts: ft_longlong(), name="position", arity=2))
register(_multi_str(lambda s, n: _as_str(s) * max(int(n), 0), name="repeat", arity=2))
register(_multi_str(lambda a, b: (_as_str(a) > _as_str(b)) - (_as_str(a) < _as_str(b)), infer=lambda fts: ft_longlong(), name="strcmp", arity=2))


def _substring_index(s, delim, count):
    s, delim, count = _as_str(s), _as_str(delim), int(count)
    if not delim:
        return ""
    parts = s.split(delim)
    if count >= 0:
        return delim.join(parts[:count])
    return delim.join(parts[count:])


register(_multi_str(_substring_index, name="substring_index", arity=3))
register(_multi_str(lambda n, *args: _as_str(args[int(n) - 1]) if 1 <= int(n) <= len(args) else None, name="elt", arity=(2, None)))
register(_multi_str(lambda s, *args: next((i + 1 for i, a in enumerate(args) if _as_str(a) == _as_str(s)), 0), infer=lambda fts: ft_longlong(), name="field", arity=(2, None)))


# ---------------------------------------------------------------------------
# math breadth
# ---------------------------------------------------------------------------


def _f1(fn):
    def kernel(xp, avals, fts, ret_ft):
        d, v = avals[0]
        # decimal lanes are scaled ints: coerce by TYPE, not dtype
        return fn(xp, lane_as_float(xp, d, fts[0])), v

    return kernel


register(FuncSig("asin", lambda fts: ft_double(), _f1(lambda xp, x: xp.arcsin(x)), arity=1))
register(FuncSig("acos", lambda fts: ft_double(), _f1(lambda xp, x: xp.arccos(x)), arity=1))
def _atan_kernel(xp, avals, fts, ret_ft):
    if len(avals) == 2:
        (a, av), (b, bv) = avals
        return xp.arctan2(lane_as_float(xp, a, fts[0]), lane_as_float(xp, b, fts[1])), av & bv
    d, v = avals[0]
    return xp.arctan(lane_as_float(xp, d, fts[0])), v


register(FuncSig("atan", lambda fts: ft_double(), _atan_kernel, arity=(1, 2)))
register(FuncSig("atan2", lambda fts: ft_double(), _atan_kernel, arity=2))
register(FuncSig("cot", lambda fts: ft_double(), _f1(lambda xp, x: 1.0 / xp.tan(x)), arity=1))
register(FuncSig("degrees", lambda fts: ft_double(), _f1(lambda xp, x: x * (180.0 / math.pi)), arity=1))
register(FuncSig("radians", lambda fts: ft_double(), _f1(lambda xp, x: x * (math.pi / 180.0)), arity=1))
register(FuncSig("pi", lambda fts: ft_double(), lambda xp, avals, fts, ret_ft: (xp.asarray(math.pi), xp.asarray(True)), arity=0))
register(
    FuncSig(
        "rand",
        lambda fts: ft_double(),
        # scalar result, broadcast by the projection layer (statement-level
        # randomness; per-row RAND() is a later refinement)
        lambda xp, avals, fts, ret_ft: (float(np.random.random()), True),
        pushable=False,
        arity=(0, 1),
    )
)
register(
    FuncSig(
        "crc32",
        lambda fts: ft_longlong(),
        _obj_map(lambda s: __import__("zlib").crc32(_as_str(s).encode())),
        pushable=False,
        arity=1,
    )
)


def _nullif_kernel(xp, avals, fts, ret_ft):
    (a, av), (b, bv) = avals
    eq = (a == b) & av & bv
    return a, av & ~eq


register(FuncSig("nullif", infer_first, _nullif_kernel, arity=2))


# ---------------------------------------------------------------------------
# JSON (ref: expression/builtin_json.go; documents stored as normalized
# JSON text in object lanes — the binary format is a later optimization)
# ---------------------------------------------------------------------------


def _json_parse(s):
    try:
        return _json.loads(_as_str(s))
    except (ValueError, TypeError):
        return None


def _json_path_tokens(path: str):
    """Tokenize a JSON path: $, .key, ."quoted", [i], [*] →
    [('key', k) | ('idx', i) | ('wild',)] — the ONE path scanner shared by
    the read (json_extract) and modify (json_set/remove/...) families."""
    from ..errors import TiDBError

    if not path.startswith("$"):
        raise TiDBError(f"Invalid JSON path expression {path!r}")
    toks = []
    i, n = 1, len(path)
    while i < n:
        c = path[i]
        if c == ".":
            i += 1
            if i < n and path[i] == '"':
                j = path.find('"', i + 1)
                if j < 0:
                    raise TiDBError(f"Invalid JSON path expression {path!r}")
                toks.append(("key", path[i + 1 : j]))
                i = j + 1
            else:
                j = i
                while j < n and (path[j].isalnum() or path[j] == "_"):
                    j += 1
                if j == i:
                    raise TiDBError(f"Invalid JSON path expression {path!r}")
                toks.append(("key", path[i:j]))
                i = j
        elif c == "[":
            j = path.find("]", i)
            if j < 0:
                raise TiDBError(f"Invalid JSON path expression {path!r}")
            tok = path[i + 1 : j].strip()
            i = j + 1
            if tok == "*":
                toks.append(("wild",))
            else:
                try:
                    toks.append(("idx", int(tok)))
                except ValueError:
                    raise TiDBError(f"Invalid JSON path expression {path!r}")
        else:
            raise TiDBError(f"Invalid JSON path expression {path!r}")
    return toks


def _json_path_get(doc, path: str):
    """Subset of JSON path: $, .key, ."quoted", [i], [*]. Returns a list of
    matches (for [*]) or a single value wrapped in a list."""
    cur = [doc]
    for t in _json_path_tokens(path):
        if t[0] == "key":
            key = t[1]
            cur = [d[key] for d in cur if isinstance(d, dict) and key in d]
        elif t[0] == "idx":
            idx = t[1]
            cur = [d[idx] for d in cur if isinstance(d, list) and -len(d) <= idx < len(d)]
        else:
            nxt = []
            for d in cur:
                if isinstance(d, list):
                    nxt.extend(d)
            cur = nxt
    return cur


def _json_extract(doc, *paths):
    d = _json_parse(doc)
    if d is None:
        return None
    hits = []
    many = len(paths) > 1 or any("*" in _as_str(p) for p in paths)
    for p in paths:
        hits.extend(_json_path_get(d, _as_str(p)))
    if not hits:
        return None
    out = hits if many else hits[0]
    return _json.dumps(out)


register(_multi_str(_json_extract, infer=lambda fts: _ft_json(), name="json_extract", arity=(2, None)))
register(
    _multi_str(
        lambda s: (_json.loads(_as_str(s)) if _as_str(s).startswith('"') else _as_str(s)),
        name="json_unquote",
        arity=1,
    )
)
register(
    _multi_str(
        lambda s: {type(None): "NULL", bool: "BOOLEAN", int: "INTEGER", float: "DOUBLE",
                   str: "STRING", list: "ARRAY", dict: "OBJECT"}[type(_json_parse(s))]
        if _json_parse(s) is not None or _as_str(s).strip() == "null" else None,
        name="json_type",
        arity=1,
    )
)
register(
    _multi_str(
        lambda s: 1 if _json_parse(s) is not None or _as_str(s).strip() == "null" else 0,
        infer=lambda fts: ft_longlong(),
        name="json_valid",
        arity=1,
    )
)


def _json_length(s, *path):
    d = _json_parse(s)
    if d is None:
        return None
    if path:
        hits = _json_path_get(d, _as_str(path[0]))
        if not hits:
            return None
        d = hits[0]
    return len(d) if isinstance(d, (list, dict)) else 1


register(_multi_str(_json_length, infer=lambda fts: ft_longlong(), name="json_length", arity=(1, 2)))
register(
    _multi_str(
        lambda s: _json.dumps(sorted(_json_parse(s).keys())) if isinstance(_json_parse(s), dict) else None,
        infer=lambda fts: _ft_json(),
        name="json_keys",
        arity=1,
    )
)


def _json_scalar(x):
    if isinstance(x, (bytes, bytearray)):
        return x.decode("utf8", "replace")
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    return x


def _json_object(*args):
    if len(args) % 2:
        return None
    return _json.dumps({_as_str(args[i]): _json_scalar(args[i + 1]) for i in range(0, len(args), 2)})


register(_multi_str(_json_object, infer=lambda fts: _ft_json(), name="json_object", arity=(0, None)))
register(
    _multi_str(
        lambda *a: _json.dumps([_json_scalar(x) for x in a]),
        infer=lambda fts: _ft_json(),
        name="json_array",
        arity=(0, None),
    )
)


def _json_contains(doc, cand, *path):
    d = _json_parse(doc)
    c = _json_parse(cand)
    if d is None or c is None:
        return None
    if path:
        hits = _json_path_get(d, _as_str(path[0]))
        if not hits:
            return 0
        d = hits[0]

    def contains(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            return all(k in a and contains(a[k], v) for k, v in b.items())
        if isinstance(a, list):
            if isinstance(b, list):
                return all(any(contains(x, y) for x in a) for y in b)
            return any(contains(x, b) for x in a)
        return a == b

    return 1 if contains(d, c) else 0


register(_multi_str(_json_contains, infer=lambda fts: ft_longlong(), name="json_contains", arity=(2, 3)))

from . import builtins_ext2  # noqa: E402,F401  (registration side effects)
