"""The port's builtin registry (expr/builtins*.py) against the reference's,
on the CPU.

* Every name of the reference's `FUNCS` is in the port's, with the same
  `pushable`, `arity` and `varargs`, and a `post_infer` where the
  reference has one; and no other name.
* Type inference: `make_func` over a grid of argument types (BIGINT,
  BIGINT UNSIGNED, DOUBLE, DECIMAL(15,2) and (20,6), VARCHAR, DATE,
  DATETIME(3), TIME, a NULL literal) gives the same result type (code,
  scale, flags, length) in both packages, or the same error text; an
  unknown name and a wrong argument count raise the same text.
* The host kernels: each builtin over an 8-row chunk of every grid type
  (the same data in both packages: numbers at their edges, strings that
  parse as numbers, dates, JSON, IP addresses and paths, NULL rows) gives
  the reference's NP kernel's lanes — data where valid, and the valid
  mask — or raises the same exception class. Functions of the clock,
  randomness, sleeping, user locks and the file system are held by
  registry and inference only.
"""

import importlib
import itertools

import numpy as np
import pytest

from test_torch_engine import PORT, REF

def _funcs(pkg):
    importlib.import_module(f"{pkg.E.__name__.rsplit('.', 2)[0]}.expr.builtins")
    return pkg.E.FUNCS


RF, PF = _funcs(REF), _funcs(PORT)
NAMES = sorted(RF)

# names whose results depend on the clock, randomness, sleeping, process
# state or the file system: registry and inference only
UNSTABLE = {"rand", "uuid", "uuid_short", "random_bytes", "sleep", "now", "sysdate", "current_timestamp",
            "localtime", "localtimestamp", "curdate", "current_date", "curtime", "current_time", "utc_time",
            "utc_date", "utc_timestamp", "unix_timestamp", "get_lock", "release_lock", "release_all_locks",
            "is_free_lock", "is_used_lock", "load_file", "connection_id", "benchmark", "tidb_parse_tso",
            "from_unixtime", "aes_encrypt", "aes_decrypt", "compress"}


def test_every_reference_builtin_is_registered_with_the_same_signature():
    assert sorted(PF) == NAMES and len(NAMES) == 262
    for n in NAMES:
        r, p = RF[n], PF[n]
        assert (p.name, p.pushable, p.arity, p.varargs) == (r.name, r.pushable, r.arity, r.varargs), n
        assert (p.post_infer is None) == (r.post_infer is None), n
    assert sum(f.pushable for f in PF.values()) == 73


TYPES = ["bigint", "ubigint", "double", "dec2", "dec6", "varchar", "date", "datetime", "time", "null"]


def _type(pkg, kind):
    F = pkg.F
    if kind == "bigint":
        return F.ft_longlong()
    if kind == "ubigint":
        return F.ft_longlong(unsigned=True)
    if kind == "double":
        return F.ft_double()
    if kind == "dec2":
        return F.ft_decimal(15, 2)
    if kind == "dec6":
        return F.ft_decimal(20, 6)
    if kind == "varchar":
        return F.ft_varchar(40)
    ft = F.FieldType({"date": F.TypeCode.Date, "datetime": F.TypeCode.Datetime, "time": F.TypeCode.Duration,
                      "null": F.TypeCode.Null}[kind])
    if kind == "datetime":
        ft.decimal = 3
    return ft


def _arg(pkg, kind, j):
    if kind == "null":
        return pkg.E.Constant(pkg.V.Datum.null(), _type(pkg, "null"))
    return pkg.E.Column(j, _type(pkg, kind), f"c{j}")


def _counts(sig):
    ar = sig.arity
    if ar is None:
        return [1, 2, 3]
    lo, hi = (ar, ar) if isinstance(ar, int) else ar
    return sorted({lo, min(lo + 1, hi if hi is not None else lo + 2), hi if hi is not None else lo + 2})


def _combos(name, k):
    if k == 0:
        return [()]
    if k == 1:
        return [(t,) for t in TYPES]
    if k == 2:
        return list(itertools.product(TYPES, TYPES))
    rng = np.random.default_rng(abs(hash(name)) % (1 << 32))
    out = [(t,) * k for t in TYPES]
    out += [tuple(rng.choice(TYPES, k)) for _ in range(20)]
    return out


def _made(pkg, name, kinds):
    try:
        return pkg.E.make_func(name, *[_arg(pkg, t, j) for j, t in enumerate(kinds)]), None
    except Exception as e:  # noqa: BLE001 — the error itself is compared
        return None, f"{type(e).__name__}: {e}"


def _ft_key(ft):
    return (int(ft.tp), ft.decimal, ft.flag, ft.flen)


@pytest.mark.parametrize("part", range(8))
def test_inferred_types_and_errors_match(part):
    for name in NAMES[part::8]:
        for k in _counts(RF[name]):
            for kinds in _combos(name, k):
                (re, rerr), (pe, perr) = _made(REF, name, kinds), _made(PORT, name, kinds)
                assert perr == rerr, (name, kinds)
                if re is not None:
                    assert _ft_key(pe.ret_type) == _ft_key(re.ret_type), (name, kinds)


def test_unknown_names_and_wrong_counts_raise_the_reference_text():
    for name, kinds in (("no_such_fn", ("bigint",)), ("abs", ()), ("abs", ("bigint", "bigint")),
                        ("round", ("double",) * 3), ("coalesce", ()), ("case", ("bigint",)), ("pi", ("bigint",))):
        (_, rerr), (_, perr) = _made(REF, name, kinds), _made(PORT, name, kinds)
        assert rerr is not None and perr == rerr


# --- the host kernels ----------------------------------------------------------

ROWS = 8
STRINGS = np.array(["abc", "Hello, World", "12", "-3.5", "2024-02-29", "2024-02-29 13:45:01.5", "",
                    '{"a": [1, 2], "b": {"c": "x"}}'], dtype=object)
MORE_STRINGS = np.array(["$.a", "192.168.0.1", "::1", "a,b,c", "10:20:30", "%Y-%m-%d", "$.b.c", "ab"], dtype=object)


def _lanes(kind, j):
    """The numpy (data, valid) of a grid type's column j (two string lanes
    alternate so that pairs differ). Every number stays small enough to be
    a count (REPEAT, SPACE, LPAD take their argument as one)."""
    valid = np.ones(ROWS, bool)
    valid[(j + 3) % ROWS] = False
    if kind == "bigint":
        d = np.array([0, 1, -1, 7, 255, 100_000, -12, 3], np.int64)
    elif kind == "ubigint":
        d = np.array([0, 1, 7, 255, (1 << 63) + 5, 3, 12, 64], np.uint64)
    elif kind == "double":
        d = np.array([0.5, -2.25, 1e5, 0.0, 3.75, -0.001, 12.0, 2.5])
    elif kind == "dec2":
        d = np.array([50, -225, 1234567, 0, 375, 1, 1200, -5], np.int64)
    elif kind == "dec6":
        d = np.array([500000, -2250000, 1234567, 0, 3750000, 1, 12000000, -5], np.int64)
    elif kind == "varchar":
        d = (STRINGS if j % 2 == 0 else MORE_STRINGS).copy()
    elif kind in ("date", "datetime"):
        from tidb_tpu.mysqltypes.coretime import parse_datetime

        dates = ["2024-02-29", "1999-12-31", "2000-01-01", "1995-03-15", "2023-06-30", "1970-01-01", "2010-10-10",
                 "1992-07-04"]
        times = [" 13:45:01.5", " 00:00:00", " 23:59:59", " 12:00:00", " 06:30:15.25", "", " 01:02:03", " 18:00:00"]
        d = np.array([parse_datetime(x + (t if kind == "datetime" else "")) for x, t in zip(dates, times)], np.int64)
    elif kind == "time":
        d = np.array([0, 3_600_000_000, -90_000_000, 45_296_000_000, 1, -1, 86_400_000_000, 59_000_000], np.int64)
    else:
        return np.zeros(ROWS, np.int64), np.zeros(ROWS, bool)
    d = d.copy()
    if d.dtype == object:
        d[~valid] = None
    else:
        d[~valid] = 0
    return d, valid


def _chunk(pkg, kinds):
    mod = importlib.import_module(f"{pkg.E.__name__.rsplit('.', 2)[0]}.chunk.chunk")
    cols = []
    for j, t in enumerate(kinds):
        d, v = _lanes(t, j)
        cols.append(mod.Column(_type(pkg, t), d, v))
    if not cols:
        cols.append(mod.Column(_type(pkg, "bigint"), np.zeros(ROWS, np.int64), np.ones(ROWS, bool)))
    return mod.Chunk(cols)


def _eval(pkg, name, kinds):
    e, err = _made(pkg, name, kinds)
    if e is None:
        return ("make", err)
    try:
        d, v = e.eval(_chunk(pkg, kinds))
    except Exception as ex:  # noqa: BLE001 — the class is compared
        return ("raise", type(ex).__name__)
    return ("ok", d, v)


def _norm(x):
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    if isinstance(x, (float, np.floating)) and np.isnan(x):
        return "nan"
    if isinstance(x, np.generic):
        return x.item()
    return x


def _same_lanes(want, got, what):
    assert want[0] == got[0], (what, want[:2], got[:2])
    if want[0] != "ok":
        assert want[1] == got[1], what
        return
    (_, wd, wv), (_, gd, gv) = want, got
    wv, gv = np.broadcast_to(np.asarray(wv), (ROWS,)), np.broadcast_to(np.asarray(gv), (ROWS,))
    assert np.array_equal(wv, gv), (what, wv, gv)
    wd, gd = np.broadcast_to(np.asarray(wd), (ROWS,)), np.broadcast_to(np.asarray(gd), (ROWS,))
    assert str(wd.dtype) == str(gd.dtype), (what, wd.dtype, gd.dtype)
    for i in np.nonzero(wv)[0]:
        assert _norm(wd[i]) == _norm(gd[i]), (what, i, wd[i], gd[i])


# builtins that build a string as long as an argument's value: fed only the
# types whose values are small (a packed date or a TIME's microseconds would
# ask for gigabytes)
COUNTED = {"repeat", "space", "lpad", "rpad", "format"}
SMALL = {"bigint", "ubigint", "double", "dec2", "varchar", "null"}


@pytest.mark.parametrize("part", range(8))
def test_host_kernels_match_the_reference_np_kernels(part):
    for name in NAMES[part::8]:
        if name in UNSTABLE:
            continue
        for k in _counts(RF[name]):
            combos = _combos(name, k)
            if k >= 2:
                combos = combos[::7] + [("varchar",) * k, ("bigint",) * k, ("double",) * k]
            if name in COUNTED:
                combos = [c for c in combos if set(c) <= SMALL]
            for kinds in combos:
                _same_lanes(_eval(REF, name, kinds), _eval(PORT, name, kinds), (name, kinds))


def test_expr_profile_without_a_card_exits_non_zero():
    import subprocess
    import sys
    from pathlib import Path

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: expr_profile.py would run for real")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, str(root / "expr_profile.py")], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
