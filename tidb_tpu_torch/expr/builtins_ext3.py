"""Builtin registry extension III (copy of tidb_tpu/expr/builtins_ext3.py) —
JSON modify/merge/search family,
session info functions, current time family, user locks, and the
miscellaneous tail toward the reference's 279 classes (ref:
expression/builtin_json.go, builtin_info.go, builtin_time.go,
builtin_miscellaneous.go builtin.go:599; same one-kernel architecture
as builtins.py). Imported by builtins_ext2.py."""

from __future__ import annotations

import datetime as _dt
import json as _json
import threading as _th
import time as _time
import uuid as _uuid

import numpy as np

from ..mysqltypes import coretime as _ct
from ..mysqltypes.datum import Datum, K_DUR
from ..mysqltypes.field_type import FieldType, TypeCode, ft_double, ft_longlong, ft_varchar
from . import sessioninfo
from .builtins import _as_str, _obj_map
from .builtins_ext import _ft_json, _json_parse, _json_path_get, _json_path_tokens, _json_scalar, _multi_str, _packed_to_date
from .expression import FuncSig, register

_US = 1_000_000


# ---------------------------------------------------------------------------
# JSON modify family (ref: builtin_json.go jsonSet/Insert/Replace/...)
# ---------------------------------------------------------------------------


def _path_steps(path: str):
    """Wildcard-free JSON path steps for the modify family — the shared
    tokenizer (_json_path_tokens) with [*]/'**' rejected (MySQL rule)."""
    from ..errors import TiDBError

    steps = _json_path_tokens(path)
    if any(t[0] == "wild" for t in steps):
        raise TiDBError("In this situation, path expressions may not contain the * and ** tokens")
    return steps


def _modify(doc, path: str, val, mode: str):
    """One json_set/insert/replace step (mode 'set'|'insert'|'replace')."""
    steps = _path_steps(path)
    if not steps:
        return val if mode != "insert" else doc
    cur = doc
    for kind, k in steps[:-1]:
        if kind == "key":
            if not isinstance(cur, dict) or k not in cur:
                return doc  # missing intermediate: no-op (MySQL)
            cur = cur[k]
        else:
            if not isinstance(cur, list) or not (-len(cur) <= k < len(cur)):
                return doc
            cur = cur[k]
    kind, k = steps[-1]
    if kind == "key":
        if not isinstance(cur, dict):
            return doc
        exists = k in cur
        if (exists and mode != "insert") or (not exists and mode != "replace"):
            cur[k] = val
    else:
        if not isinstance(cur, list):
            # MySQL autowraps scalars: $[0] on a scalar replaces it
            return doc
        if -len(cur) <= k < len(cur):
            if mode != "insert":
                cur[k] = val
        elif mode != "replace":
            cur.append(val)
    return doc


def _json_modify_fn(mode):
    def fn(doc, *pairs):
        d = _json_parse(doc)
        if d is None:
            return None
        if len(pairs) % 2:
            return None
        for i in range(0, len(pairs), 2):
            d = _modify(d, _as_str(pairs[i]), _json_scalar(pairs[i + 1]), mode)
        return _json.dumps(d)

    return fn


for _nm, _md in (("json_set", "set"), ("json_insert", "insert"), ("json_replace", "replace")):
    register(_multi_str(_json_modify_fn(_md), infer=lambda fts: _ft_json(), name=_nm, arity=(3, None)))


def _json_remove(doc, *paths):
    d = _json_parse(doc)
    if d is None:
        return None
    for p in paths:
        steps = _path_steps(_as_str(p))
        if not steps:
            return None  # removing $ is an error → NULL row
        cur = d
        ok = True
        for kind, k in steps[:-1]:
            if kind == "key" and isinstance(cur, dict) and k in cur:
                cur = cur[k]
            elif kind == "idx" and isinstance(cur, list) and -len(cur) <= k < len(cur):
                cur = cur[k]
            else:
                ok = False
                break
        if not ok:
            continue
        kind, k = steps[-1]
        if kind == "key" and isinstance(cur, dict):
            cur.pop(k, None)
        elif kind == "idx" and isinstance(cur, list) and -len(cur) <= k < len(cur):
            del cur[k]
    return _json.dumps(d)


register(_multi_str(_json_remove, infer=lambda fts: _ft_json(), name="json_remove", arity=(2, None)))


def _json_array_append(doc, *pairs):
    d = _json_parse(doc)
    if d is None or len(pairs) % 2:
        return None
    for i in range(0, len(pairs), 2):
        steps = _path_steps(_as_str(pairs[i]))
        val = _json_scalar(pairs[i + 1])
        if not steps:
            d = d + [val] if isinstance(d, list) else [d, val]
            continue
        cur = d
        ok = True
        for kind, k in steps[:-1]:
            if kind == "key" and isinstance(cur, dict) and k in cur:
                cur = cur[k]
            elif kind == "idx" and isinstance(cur, list) and -len(cur) <= k < len(cur):
                cur = cur[k]
            else:
                ok = False
                break
        if not ok:
            continue
        kind, k = steps[-1]
        tgt = None
        if kind == "key" and isinstance(cur, dict) and k in cur:
            tgt = cur[k]
            cur[k] = tgt + [val] if isinstance(tgt, list) else [tgt, val]
        elif kind == "idx" and isinstance(cur, list) and -len(cur) <= k < len(cur):
            tgt = cur[k]
            cur[k] = tgt + [val] if isinstance(tgt, list) else [tgt, val]
    return _json.dumps(d)


register(_multi_str(_json_array_append, infer=lambda fts: _ft_json(), name="json_array_append", arity=(3, None)))


def _json_array_insert(doc, *pairs):
    d = _json_parse(doc)
    if d is None or len(pairs) % 2:
        return None
    for i in range(0, len(pairs), 2):
        steps = _path_steps(_as_str(pairs[i]))
        if not steps or steps[-1][0] != "idx":
            return None  # path must end in an array index (MySQL error)
        val = _json_scalar(pairs[i + 1])
        cur = d
        ok = True
        for kind, k in steps[:-1]:
            if kind == "key" and isinstance(cur, dict) and k in cur:
                cur = cur[k]
            elif kind == "idx" and isinstance(cur, list) and -len(cur) <= k < len(cur):
                cur = cur[k]
            else:
                ok = False
                break
        if ok and isinstance(cur, list):
            k = steps[-1][1]
            cur.insert(max(0, k if k >= 0 else len(cur) + k), val)
    return _json.dumps(d)


register(_multi_str(_json_array_insert, infer=lambda fts: _ft_json(), name="json_array_insert", arity=(3, None)))


def _merge_preserve(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = _merge_preserve(out[k], v) if k in out else v
        return out
    la = a if isinstance(a, list) else [a]
    lb = b if isinstance(b, list) else [b]
    return la + lb


def _merge_patch(a, b):
    if not isinstance(b, dict):
        return b
    out = dict(a) if isinstance(a, dict) else {}
    for k, v in b.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = _merge_patch(out.get(k), v)
    return out


def _json_merge_fn(merge):
    def fn(*docs):
        ds = [_json_parse(x) for x in docs]
        if any(d is None and _as_str(x).strip() != "null" for d, x in zip(ds, docs)):
            return None
        acc = ds[0]
        for d in ds[1:]:
            acc = merge(acc, d)
        return _json.dumps(acc)

    return fn


for _nm in ("json_merge", "json_merge_preserve"):
    register(_multi_str(_json_merge_fn(_merge_preserve), infer=lambda fts: _ft_json(), name=_nm, arity=(2, None)))
register(_multi_str(_json_merge_fn(_merge_patch), infer=lambda fts: _ft_json(), name="json_merge_patch", arity=(2, None)))


def _json_contains_path(doc, one_or_all, *paths):
    d = _json_parse(doc)
    if d is None:
        return None
    mode = _as_str(one_or_all).lower()
    if mode not in ("one", "all"):
        return None
    hits = [bool(_json_path_get(d, _as_str(p))) for p in paths]
    return int(any(hits) if mode == "one" else all(hits))


register(_multi_str(_json_contains_path, infer=lambda fts: ft_longlong(), name="json_contains_path", arity=(3, None)))


def _depth(d):
    if isinstance(d, dict):
        return 1 + max((_depth(v) for v in d.values()), default=0)
    if isinstance(d, list):
        return 1 + max((_depth(v) for v in d), default=0)
    return 1


register(
    _multi_str(
        lambda s: _depth(_json_parse(s)) if _json_parse(s) is not None or _as_str(s).strip() == "null" else None,
        infer=lambda fts: ft_longlong(),
        name="json_depth",
        arity=1,
    )
)
register(
    _multi_str(
        lambda s: _json.dumps(_json_parse(s), indent=2) if _json_parse(s) is not None else None,
        infer=lambda fts: _ft_json(),
        name="json_pretty",
        arity=1,
    )
)
register(_multi_str(lambda s: _json.dumps(_as_str(s)), infer=lambda fts: _ft_json(), name="json_quote", arity=1))
register(
    _multi_str(
        lambda s: len(_json.dumps(_json_parse(s)).encode()) if _json_parse(s) is not None else None,
        infer=lambda fts: ft_longlong(),
        name="json_storage_size",
        arity=1,
    )
)


def _json_subdocs(doc, path: str):
    """[(path string, value)] for every node a (possibly wildcarded)
    path matches — the path-tracking twin of _json_path_get."""
    cur = [("$", doc)]
    for t in _json_path_tokens(path):
        nxt = []
        for p, d in cur:
            if t[0] == "key":
                if isinstance(d, dict) and t[1] in d:
                    k = t[1]
                    nxt.append((f'{p}."{k}"' if not k.isalnum() else f"{p}.{k}", d[k]))
            elif t[0] == "idx":
                if isinstance(d, list) and -len(d) <= t[1] < len(d):
                    nxt.append((f"{p}[{t[1] % len(d)}]", d[t[1]]))
            else:  # wildcard
                if isinstance(d, list):
                    nxt.extend((f"{p}[{i}]", x) for i, x in enumerate(d))
        cur = nxt
    return cur


def _json_search(doc, one_or_all, pat, *rest):
    import fnmatch

    d = _json_parse(doc)
    if d is None or pat is None:
        return None
    mode = _as_str(one_or_all).lower()
    if mode not in ("one", "all"):
        return None
    # rest: [escape_char [, path...]] (MySQL: NULL escape means default \)
    esc = "\\"
    if rest and rest[0] is not None and _as_str(rest[0]) != "":
        esc = _as_str(rest[0])
        if len(esc) != 1:
            return None
    pattern = _as_str(pat)

    def like(s):
        # SQL LIKE: % any run, _ one char, honoring the escape character
        trans = pattern.replace(esc + "%", "\0").replace(esc + "_", "\1")
        trans = trans.replace("%", "*").replace("_", "?")
        trans = trans.replace("\0", "%").replace("\1", "_")
        return fnmatch.fnmatchcase(s, trans)

    roots = [("$", d)]
    if len(rest) > 1:
        roots = []
        for p in rest[1:]:
            roots.extend(_json_subdocs(d, _as_str(p)))

    out = []

    def walk(v, path):
        if isinstance(v, str) and like(v):
            out.append(path)
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(x, f'{path}."{k}"' if not k.isalnum() else f"{path}.{k}")
        elif isinstance(v, list):
            for i, x in enumerate(v):
                walk(x, f"{path}[{i}]")

    for base, sub in roots:
        walk(sub, base)
    seen = set()
    out = [p for p in out if not (p in seen or seen.add(p))]
    if not out:
        return None
    if mode == "one":
        return _json.dumps(out[0])
    return _json.dumps(out if len(out) > 1 else out[0])


def _json_search_kernel(xp, avals, fts, ret_ft):
    """Custom lane kernel: only (doc, one_or_all, pattern) are required
    non-NULL; a NULL escape/path argument reaches _json_search as None
    (MySQL treats a NULL escape as the default backslash)."""
    from ..errors import TiDBError

    cols = [np.asarray(d).reshape(-1) for d, _ in avals]
    vlds = [np.asarray(v).reshape(-1) for _, v in avals]
    n = max(len(c) for c in cols)
    req = np.ones(n, dtype=bool)
    for v in vlds[:3]:
        req &= v
    out = np.empty(n, dtype=object)
    valid = req.copy()
    for i in np.nonzero(req)[0]:
        args = [
            c[i if len(c) > 1 else 0] if bool(v[i if len(v) > 1 else 0]) else None
            for c, v in zip(cols, vlds)
        ]
        try:
            r = _json_search(*args)
        except TiDBError:
            raise
        except Exception:  # noqa: BLE001 — malformed input → SQL NULL
            r = None
        if r is None:
            valid[i] = False
        else:
            out[i] = r
    return out, valid


register(FuncSig("json_search", lambda fts: _ft_json(), _json_search_kernel, pushable=False, arity=(3, None)))


# ---------------------------------------------------------------------------
# session info functions (ref: builtin_info.go; values published by the
# Session through expr.sessioninfo)
# ---------------------------------------------------------------------------


def _scalar0(fn):
    """Zero-arg kernel; numeric results become 0-d arrays so downstream
    kernels can re-coerce them (strings stay python scalars like uuid())."""

    def kernel(xp, avals, fts, ret_ft):
        r = fn()
        if isinstance(r, (int, float)) and not isinstance(r, bool):
            return np.asarray(r), np.asarray(r is not None)
        return r, r is not None

    return kernel


def _info_func(name, fn, ft=None, arity=0):
    register(
        FuncSig(
            name,
            (lambda fts: ft.clone()) if ft is not None else (lambda fts: ft_varchar(64)),
            _obj_map(fn) if arity else _scalar0(fn),
            pushable=False,
            arity=arity,
        )
    )


_info_func("version", lambda: "8.0.11-tidb-tpu")
_info_func("tidb_version", lambda: "8.0.11-tidb-tpu\nEdition: TPU-native (jax/XLA)")
_info_func("database", lambda: sessioninfo.get("db") or None)
_info_func("schema", lambda: sessioninfo.get("db") or None)
_info_func("user", lambda: f"{sessioninfo.get('user', 'root')}@%")
_info_func("current_user", lambda: f"{sessioninfo.get('user', 'root')}@%")
_info_func("session_user", lambda: f"{sessioninfo.get('user', 'root')}@%")
_info_func("system_user", lambda: f"{sessioninfo.get('user', 'root')}@%")
_info_func("current_role", lambda: "NONE")
_info_func("connection_id", lambda: int(sessioninfo.get("conn_id", 0)), ft=ft_longlong())
_info_func("found_rows", lambda: int(sessioninfo.get("found_rows", 0)), ft=ft_longlong())
_info_func("row_count", lambda: int(sessioninfo.get("row_count", -1)), ft=ft_longlong())
_info_func("last_insert_id", lambda: int(sessioninfo.get("last_insert_id", 0)), ft=ft_longlong())
register(
    FuncSig(
        "benchmark",
        lambda fts: ft_longlong(),
        # the lane is already evaluated once per row; MySQL returns 0
        lambda xp, avals, fts, ret_ft: (np.zeros(len(np.asarray(avals[0][0]).reshape(-1)), np.int64), np.ones(len(np.asarray(avals[0][0]).reshape(-1)), bool)),
        pushable=False,
        arity=2,
    )
)


# ---------------------------------------------------------------------------
# current time family (ref: builtin_time.go; the planner also folds these
# at plan time for cacheability — these kernels serve nested/late binding)
# ---------------------------------------------------------------------------


def _now_epoch():
    return sessioninfo.now_epoch()


def _now_packed():
    t = _time.localtime(_now_epoch())
    return _ct.pack_time(t.tm_year, t.tm_mon, t.tm_mday, t.tm_hour, t.tm_min, t.tm_sec)


def _time_func(name, fn, tc):
    register(
        FuncSig(
            name,
            lambda fts, _tc=tc: FieldType(_tc),
            lambda xp, avals, fts, ret_ft, _fn=fn: (_fn(), True),
            pushable=False,
            arity=(0, 1) if name in ("now", "sysdate", "current_timestamp", "localtime", "localtimestamp", "curtime", "current_time", "utc_time") else 0,
        )
    )


for _nm in ("now", "sysdate", "current_timestamp", "localtime", "localtimestamp"):
    _time_func(_nm, _now_packed, TypeCode.Datetime)
for _nm in ("curdate", "current_date"):
    _time_func(
        _nm,
        lambda: (lambda t: _ct.pack_time(t.tm_year, t.tm_mon, t.tm_mday))(_time.localtime(_now_epoch())),
        TypeCode.Date,
    )


def _curtime_us():
    t = _time.localtime(_now_epoch())
    return (t.tm_hour * 3600 + t.tm_min * 60 + t.tm_sec) * _US


for _nm in ("curtime", "current_time"):
    _time_func(_nm, _curtime_us, TypeCode.Duration)


def _utc_time_us():
    t = _time.gmtime(_now_epoch())
    return (t.tm_hour * 3600 + t.tm_min * 60 + t.tm_sec) * _US


_time_func("utc_time", _utc_time_us, TypeCode.Duration)


def _timestamp_fn(expr, *timeadd):
    p = _ct.parse_datetime(_as_str(expr))
    if p is None:
        return None
    if timeadd:
        d = _ct.parse_duration(_as_str(timeadd[0]))
        if d is None:
            return None
        t = _packed_to_date(p)
        if t is None:
            return None
        t = t + _dt.timedelta(microseconds=d)
        return t.strftime("%Y-%m-%d %H:%M:%S")
    t = _packed_to_date(p)
    return t.strftime("%Y-%m-%d %H:%M:%S") if t else None


register(_multi_str(_timestamp_fn, name="timestamp", arity=(1, 2)))


def _tz_offset(tz: str):
    tz = _as_str(tz).strip()
    if tz.upper() in ("SYSTEM", "UTC", "+00:00", "-00:00"):
        if tz.upper() == "SYSTEM":
            off = -_time.timezone if not _time.daylight else -_time.altzone
            return _dt.timedelta(seconds=off)
        return _dt.timedelta(0)
    sign = 1 if tz[0] == "+" else -1 if tz[0] == "-" else None
    if sign is None or ":" not in tz:
        return None  # named zones need a tz database: NULL (documented)
    hh, mm = tz[1:].split(":", 1)
    return sign * _dt.timedelta(hours=int(hh), minutes=int(mm))


def _convert_tz(dtv, frm, to):
    p = _ct.parse_datetime(_as_str(dtv))
    if p is None:
        return None
    o1, o2 = _tz_offset(frm), _tz_offset(to)
    if o1 is None or o2 is None:
        return None
    t = _packed_to_date(p)
    if t is None:
        return None
    return (t - o1 + o2).strftime("%Y-%m-%d %H:%M:%S")


register(_multi_str(_convert_tz, name="convert_tz", arity=3))

_GET_FORMAT = {
    ("date", "usa"): "%m.%d.%Y", ("date", "jis"): "%Y-%m-%d", ("date", "iso"): "%Y-%m-%d",
    ("date", "eur"): "%d.%m.%Y", ("date", "internal"): "%Y%m%d",
    ("datetime", "usa"): "%Y-%m-%d %H.%i.%s", ("datetime", "jis"): "%Y-%m-%d %H:%i:%s",
    ("datetime", "iso"): "%Y-%m-%d %H:%i:%s", ("datetime", "eur"): "%Y-%m-%d %H.%i.%s",
    ("datetime", "internal"): "%Y%m%d%H%i%s",
    ("time", "usa"): "%h:%i:%s %p", ("time", "jis"): "%H:%i:%s", ("time", "iso"): "%H:%i:%s",
    ("time", "eur"): "%H.%i.%s", ("time", "internal"): "%H%i%s",
}
register(
    _multi_str(
        lambda t, loc: _GET_FORMAT.get((_as_str(t).lower(), _as_str(loc).lower())),
        name="get_format",
        arity=2,
    )
)


# ---------------------------------------------------------------------------
# string/misc tail (ref: builtin_string.go, builtin_miscellaneous.go)
# ---------------------------------------------------------------------------

register(
    FuncSig(
        "mid",
        lambda fts: ft_varchar(),
        _obj_map(lambda s, pos, ln: _as_str(s)[int(pos) - 1 : int(pos) - 1 + int(ln)] if int(pos) > 0 else (_as_str(s)[int(pos):][:int(ln)] if int(pos) < 0 else "")),
        pushable=False,
        arity=3,
    )
)
register(
    FuncSig(
        "octet_length",
        lambda fts: ft_longlong(),
        _obj_map(lambda s: len(s) if isinstance(s, (bytes, bytearray)) else len(_as_str(s).encode())),
        pushable=False,
        arity=1,
    )
)
register(
    FuncSig(
        "character_length",
        lambda fts: ft_longlong(),
        _obj_map(lambda s: len(_as_str(s))),
        pushable=False,
        arity=1,
    )
)


def _translate(s, frm, to):
    s, frm, to = _as_str(s), _as_str(frm), _as_str(to)
    table = {}
    for i, ch in enumerate(frm):
        if ch not in table:  # first occurrence wins (MySQL)
            table[ch] = to[i] if i < len(to) else None
    return "".join(t for ch in s for t in [table.get(ch, ch)] if t is not None)


register(_multi_str(_translate, name="translate", arity=3))
register(
    _multi_str(
        # binary collation: the weight string IS the byte sequence
        lambda s: s if isinstance(s, (bytes, bytearray)) else _as_str(s).encode(),
        name="weight_string",
        arity=1,
    )
)
register(
    FuncSig(
        "bit_count",
        lambda fts: ft_longlong(),
        _obj_map(lambda x: bin(int(x) & 0xFFFFFFFFFFFFFFFF).count("1")),
        pushable=False,
        arity=1,
    )
)


def _interval_fn(n, *bounds):
    if n is None:
        return -1
    x = float(n)
    out = 0
    for b in bounds:
        if b is not None and x >= float(b):
            out += 1
        else:
            break
    return out


register(_multi_str(_interval_fn, infer=lambda fts: ft_longlong(), name="interval", arity=(2, None)))
register(
    FuncSig(
        "name_const",
        lambda fts: fts[1].clone() if len(fts) > 1 else ft_varchar(),
        lambda xp, avals, fts, ret_ft: avals[1],
        pushable=False,
        arity=2,
    )
)

_uuid_short_state = {"lock": _th.Lock(), "n": int(_time.time()) << 24}


def _uuid_short():
    with _uuid_short_state["lock"]:
        _uuid_short_state["n"] += 1
        return _uuid_short_state["n"] & 0x7FFFFFFFFFFFFFFF


register(FuncSig("uuid_short", lambda fts: ft_longlong(), _scalar0(_uuid_short), pushable=False, arity=0))


def _uuid_to_bin(s, *swap):
    u = _uuid.UUID(_as_str(s))
    b = u.bytes
    if swap and int(swap[0]):
        b = b[6:8] + b[4:6] + b[0:4] + b[8:]
    return b


def _bin_to_uuid(b, *swap):
    if not isinstance(b, (bytes, bytearray)):
        b = _as_str(b).encode("latin-1")
    if len(b) != 16:
        return None
    b = bytes(b)
    if swap and int(swap[0]):
        b = b[4:8] + b[2:4] + b[0:2] + b[8:]
    return str(_uuid.UUID(bytes=b))


register(_multi_str(_uuid_to_bin, name="uuid_to_bin", arity=(1, 2)))
register(_multi_str(_bin_to_uuid, name="bin_to_uuid", arity=(1, 2)))


def _is_ipv4_compat(b):
    if not isinstance(b, (bytes, bytearray)):
        b = _as_str(b).encode("latin-1")
    return int(len(b) == 16 and b[:12] == b"\x00" * 12)


def _is_ipv4_mapped(b):
    if not isinstance(b, (bytes, bytearray)):
        b = _as_str(b).encode("latin-1")
    return int(len(b) == 16 and b[:12] == b"\x00" * 10 + b"\xff\xff")


register(_multi_str(_is_ipv4_compat, infer=lambda fts: ft_longlong(), name="is_ipv4_compat", arity=1))
register(_multi_str(_is_ipv4_mapped, infer=lambda fts: ft_longlong(), name="is_ipv4_mapped", arity=1))


def _format_bytes(x):
    v = float(x)
    for unit in ("Bytes", "KiB", "MiB", "GiB", "TiB", "PiB", "EiB"):
        if abs(v) < 1024 or unit == "EiB":
            return f"{v:.0f} {unit}" if unit == "Bytes" else f"{v:.2f} {unit}"
        v /= 1024


def _format_nanotime(x):
    v = float(x)
    for unit, div in (("ns", 1), ("µs", 1e3), ("ms", 1e6), ("s", 1e9), ("min", 6e10), ("h", 3.6e12)):
        if abs(v) < div * 1000 or unit == "h":
            return f"{v / div:.2f} {unit}"


register(_multi_str(_format_bytes, name="format_bytes", arity=1))
register(_multi_str(_format_nanotime, name="format_nanotime", arity=1))


# ---------------------------------------------------------------------------
# user-level locks (ref: builtin_miscellaneous.go GET_LOCK; process-global
# table keyed by lock name, reentrant per connection)
# ---------------------------------------------------------------------------

_USER_LOCKS: dict[str, list] = {}  # name -> [conn_id, count]
_USER_LOCKS_MU = _th.Lock()
_USER_LOCKS_CV = _th.Condition(_USER_LOCKS_MU)


def _conn():
    return int(sessioninfo.get("conn_id", 0))


def _get_lock(name, timeout):
    name = _as_str(name)
    me = _conn()
    deadline = _time.monotonic() + max(float(timeout), 0)
    with _USER_LOCKS_CV:
        while True:
            cur = _USER_LOCKS.get(name)
            if cur is None or cur[0] == me:
                if cur is None:
                    _USER_LOCKS[name] = [me, 1]
                else:
                    cur[1] += 1
                return 1
            left = deadline - _time.monotonic()
            if left <= 0:
                return 0
            _USER_LOCKS_CV.wait(min(left, 0.05))


def _release_lock(name):
    name = _as_str(name)
    me = _conn()
    with _USER_LOCKS_CV:
        cur = _USER_LOCKS.get(name)
        if cur is None:
            return None  # lock never existed
        if cur[0] != me:
            return 0
        cur[1] -= 1
        if cur[1] <= 0:
            del _USER_LOCKS[name]
            _USER_LOCKS_CV.notify_all()
        return 1


def _release_all_locks():
    me = _conn()
    with _USER_LOCKS_CV:
        mine = [k for k, v in _USER_LOCKS.items() if v[0] == me]
        n = sum(_USER_LOCKS[k][1] for k in mine)
        for k in mine:
            del _USER_LOCKS[k]
        if mine:
            _USER_LOCKS_CV.notify_all()
        return n


register(_multi_str(_get_lock, infer=lambda fts: ft_longlong(), name="get_lock", arity=2))
register(_multi_str(_release_lock, infer=lambda fts: ft_longlong(), name="release_lock", arity=1))
register(
    _multi_str(
        lambda name: int(_as_str(name) not in _USER_LOCKS),
        infer=lambda fts: ft_longlong(),
        name="is_free_lock",
        arity=1,
    )
)
register(
    _multi_str(
        lambda name: (_USER_LOCKS.get(_as_str(name)) or [None])[0],
        infer=lambda fts: ft_longlong(),
        name="is_used_lock",
        arity=1,
    )
)
register(
    FuncSig(
        "release_all_locks",
        lambda fts: ft_longlong(),
        _scalar0(_release_all_locks),
        pushable=False,
        arity=0,
    )
)


# ---------------------------------------------------------------------------
# encode/decode + password strength + load_file (ref: builtin_encryption.go)
# ---------------------------------------------------------------------------


def _xor_stream(data: bytes, password: str) -> bytes:
    import hashlib

    key = hashlib.sha256(password.encode()).digest()
    out = bytearray(len(data))
    for i, b in enumerate(data):
        out[i] = b ^ key[i % len(key)]
    return bytes(out)


def _encode(s, pw):
    data = s if isinstance(s, (bytes, bytearray)) else _as_str(s).encode()
    return _xor_stream(bytes(data), _as_str(pw))


register(_multi_str(_encode, name="encode", arity=2))
register(_multi_str(_encode, name="decode", arity=2))  # XOR stream is its own inverse


def _password_strength(s):
    s = _as_str(s)
    if len(s) < 4:
        return 0
    if len(s) < 8:
        return 25
    score = 50
    if any(c.isdigit() for c in s):
        score += 12
    if any(c.islower() for c in s) and any(c.isupper() for c in s):
        score += 13
    if any(not c.isalnum() for c in s):
        score += 25
    return min(score, 100)


register(_multi_str(_password_strength, infer=lambda fts: ft_longlong(), name="validate_password_strength", arity=1))


def _load_file(p):
    from ..utils import sem

    sem.check_file_access()
    try:
        with open(_as_str(p), "rb") as f:
            return f.read()
    except OSError:
        return None


register(_multi_str(_load_file, name="load_file", arity=1))


# ---------------------------------------------------------------------------
# TiDB-specific introspection (ref: builtin_info.go tidb* funcs)
# ---------------------------------------------------------------------------


def _tidb_parse_tso(ts):
    ms = int(ts) >> 18
    t = _dt.datetime.fromtimestamp(ms / 1000.0)
    return t.strftime("%Y-%m-%d %H:%M:%S.%f")


register(_multi_str(_tidb_parse_tso, name="tidb_parse_tso", arity=1))
register(
    FuncSig(
        "tidb_is_ddl_owner",
        lambda fts: ft_longlong(),
        # single-process deployment: this node always owns DDL
        _scalar0(lambda: 1),
        pushable=False,
        arity=0,
    )
)


class _tablecodec:
    """The key layout of the reference's codec/tablecodec.py that
    TIDB_DECODE_KEY reads: t{tableID}_r{handle} and
    t{tableID}_i{indexID}{values}[{handle}], ids and handles as
    sign-flipped big-endian int64."""

    @staticmethod
    def _dint(b: bytes) -> int:
        import struct

        return struct.unpack(">Q", b)[0] - 0x8000000000000000

    @classmethod
    def decode_table_id(cls, key: bytes) -> int:
        return cls._dint(key[1:9])

    @classmethod
    def decode_record_handle(cls, key: bytes) -> int:
        return cls._dint(key[11:19])

    @classmethod
    def decode_index_handle(cls, key: bytes) -> int:
        return cls._dint(key[-8:])


def _tidb_decode_key(s):
    tc = _tablecodec

    try:
        key = bytes.fromhex(_as_str(s))
    except ValueError:
        return _as_str(s)
    try:
        tid = tc.decode_table_id(key)
    except Exception:  # noqa: BLE001 — undecodable: echo input (TiDB behavior)
        return _as_str(s)
    try:
        h = tc.decode_record_handle(key)
        return _json.dumps({"table_id": tid, "row_id": h})
    except Exception:  # noqa: BLE001
        try:
            h = tc.decode_index_handle(key)
            return _json.dumps({"table_id": tid, "index_handle": h})
        except Exception:  # noqa: BLE001
            return _json.dumps({"table_id": tid})


register(_multi_str(_tidb_decode_key, name="tidb_decode_key", arity=1))


def _tidb_bounded_staleness(lo, hi):
    # resolved read ts within [lo, hi]: single node resolves to hi
    p = _ct.parse_datetime(_as_str(hi))
    if p is None:
        return None
    t = _packed_to_date(p)
    return t.strftime("%Y-%m-%d %H:%M:%S.%f") if t else None


register(_multi_str(_tidb_bounded_staleness, name="tidb_bounded_staleness", arity=2))
