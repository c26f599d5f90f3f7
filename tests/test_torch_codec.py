"""The port's codecs (tidb_tpu_torch/codec) against the reference's, on the CPU.

For every datum kind — NULL, the int64 and uint64 limits, doubles with
±0.0, NaN, ±inf and subnormals, decimals at scales 0 to 12, dates and
datetimes, durations, strings (ASCII, accented, CJK, emoji, empty) of a
column in every collation the reference supports, bytes with NULs — both
packages give the same memcomparable key bytes, the same v1 row bytes and
the same decoded datums; keys order the same and as the values do. The
v2 batch row codec (rowfast) encodes the same bytes from the same numpy
columns (with NULL rows), and its rows decode back to the columns
through `decode_row_v2`, `decode_row`'s dispatch and the vectorized
`decode_v2_batch`. The table codec's record / index keys and rowfast's key
matrices are the same bytes.
"""

import math

import numpy as np
import pytest

from tidb_tpu.catalog import schema as r_schema
from tidb_tpu.chunk.chunk import Chunk as RChunk
from tidb_tpu.codec import key as r_key, row as r_row, rowfast as r_fast, tablecodec as r_tc
from tidb_tpu.mysqltypes import collate as r_coll, datum as r_datum, field_type as r_ft, mydecimal as r_dec
from tidb_tpu.table.table import Table as RTable

from tidb_tpu_torch.catalog import schema as p_schema
from tidb_tpu_torch.chunk.chunk import Chunk as PChunk
from tidb_tpu_torch.codec import key as p_key, row as p_row, rowfast as p_fast, tablecodec as p_tc
from tidb_tpu_torch.mysqltypes import datum as p_datum, field_type as p_ft, mydecimal as p_dec
from tidb_tpu_torch.table.table import Table as PTable

I64 = np.iinfo(np.int64)
US = 1_000_000
STRINGS = ["", "a", "A", "ab", "abcé", "Été", "中文", "\U0001F600 x", "a" * 7, "a" * 8,
           "a" * 9, "zzzz", "Z", " lead", "trail "]


def _pack(y, mo, d, h=0, mi=0, s=0, us=0):
    return ((((y * 13 + mo) * 32 + d) * 24 + h) * 60 + mi) * 60 * US + s * US + us


# kind → (python values, the Datum constructor name); NULL rides along in every kind
VALUES = {
    "int": ([0, 1, -1, 7, -7, I64.min, I64.max, I64.min + 1, 1 << 40, -(1 << 40)], "i"),
    "uint": ([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, 12345], "u"),
    "float": ([0.0, -0.0, 1.5, -1.5, 5e-324, -5e-324, 2.2250738585072014e-308, 1e300, -1e300, math.inf, -math.inf,
               math.nan, 1 / 3], "f"),
    "dec": ([(0, 0), (1, 0), (-1, 0), (12345, 2), (-12345, 2), (100, 2), (1, 12), (-999999999999, 12),
             (10**18, 3), (-(10**18), 3), (5, 1), (50, 2)], "d"),
    "str": (STRINGS, "s"),
    "bytes": ([b"", b"\x00", b"\x00\x00", b"a\x00b", b"\xff" * 9, b"abc", bytes(range(16))], "b"),
    "date": ([0, _pack(1992, 1, 1), _pack(1998, 12, 31), _pack(2000, 2, 29), _pack(9999, 12, 31)], "t"),
    "datetime": ([_pack(1995, 3, 15, 23, 59, 59, 999999), _pack(1995, 3, 15), _pack(1970, 1, 1, 0, 0, 1)], "t"),
    "duration": ([0, 1, -1, 838 * 3600 * US, -838 * 3600 * US, 12 * 3600 * US + 5], "dur"),
}


def _datum(mod, dec_mod, kind, v):
    D = mod.Datum
    if v is None:
        return D.null()
    ctor = VALUES[kind][1]
    if ctor == "d":
        return D.d(dec_mod.Dec(*v))
    if ctor == "dur":
        return D(mod.K_DUR, v)
    return getattr(D, ctor)(v)


def _both(kind, v):
    return _datum(r_datum, r_dec, kind, v), _datum(p_datum, p_dec, kind, v)


def _key(mod, d) -> bytes:
    buf = bytearray()
    mod.encode_datum_key(buf, d)
    return bytes(buf)


def _same_datum(a, b) -> bool:
    if a.kind != b.kind:
        return False
    if a.kind == r_datum.K_NULL:
        return True
    if a.kind == r_datum.K_FLOAT:
        return np.float64(a.val).tobytes() == np.float64(b.val).tobytes()
    if a.kind == r_datum.K_DEC:
        return (a.val.value, a.val.scale) == (b.val.value, b.val.scale)
    return a.val == b.val


@pytest.mark.parametrize("kind", list(VALUES))
def test_datum_keys_are_the_references_bytes(kind):
    """encode_datum_key: the same bytes for every value and NULL; the
    port's decode_datum_key reads back what the reference's reads."""
    for v in VALUES[kind][0] + [None]:
        rd, pd = _both(kind, v)
        rk, pk = _key(r_key, rd), _key(p_key, pd)
        assert rk == pk, (kind, v)
        rback, rpos = r_key.decode_datum_key(memoryview(rk), 0)
        pback, ppos = p_key.decode_datum_key(memoryview(pk), 0)
        assert rpos == ppos == len(pk)
        assert _same_datum(rback, pback), (kind, v)


@pytest.mark.parametrize("kind", ["int", "uint", "float", "dec", "str", "bytes", "date", "duration"])
def test_keys_order_the_same_and_as_the_values(kind):
    """Seeded random values: the port's keys sort into the reference's
    order, and that order is the values' (NULL first, NaN aside)."""
    rng = np.random.default_rng(5)
    base = [v for v in VALUES[kind][0] if not (isinstance(v, float) and math.isnan(v))]
    if kind == "int":
        base += rng.integers(I64.min, I64.max, 200, dtype=np.int64).tolist()
    elif kind == "float":
        base += (rng.standard_normal(200) * 10.0 ** rng.integers(-300, 300, 200)).tolist()
    elif kind == "dec":
        base += [(int(x), 4) for x in rng.integers(-10**15, 10**15, 200)]
    elif kind == "str":
        base += ["".join(rng.choice(list("aAbBé中0 "), int(k))) for k in rng.integers(0, 20, 200)]
    vals = base + [None]
    keys = []
    for v in vals:
        rd, pd = _both(kind, v)
        keys.append((_key(r_key, rd), _key(p_key, pd)))
    assert [k[0] for k in keys] == [k[1] for k in keys]
    order = sorted(range(len(vals)), key=lambda i: keys[i][1])
    assert order == sorted(range(len(vals)), key=lambda i: keys[i][0])
    assert vals[order[0]] is None

    def value(v):
        if kind == "dec":
            return v[0] / 10 ** v[1]
        if kind in ("str",):
            return v.encode("utf8")
        return v

    seen = [value(vals[i]) for i in order[1:]]
    assert all(a <= b for a, b in zip(seen, seen[1:])), kind


@pytest.mark.parametrize("coll", sorted(r_coll.SUPPORTED))
def test_string_index_keys_in_every_collation(coll):
    """An index on a string column declared in each collation: the port's
    Table.index_value_key gives the reference's key and value bytes,
    unique and not, with NULL and a handle suffix."""
    def info(schema, ft_mod, unique):
        ft = ft_mod.ft_varchar(64)
        ft.collate = coll
        cols = [schema.ColumnInfo(2, "s", ft, 0), schema.ColumnInfo(3, "_tidb_rowid", ft_mod.ft_longlong(), 1,
                                                                    hidden=True)]
        return schema.TableInfo(9, "t", cols, [schema.IndexInfo(4, "ix", [0], unique=unique)])

    for unique in (False, True):
        rt, pt = RTable(info(r_schema, r_ft, unique)), PTable(info(p_schema, p_ft, unique))
        for h, v in enumerate(STRINGS + [None]):
            rd, pd = _both("str", v)
            want = rt.index_value_key(rt.info.indexes[0], [rd, r_datum.Datum.i(h)], h)
            got = pt.index_value_key(pt.info.indexes[0], [pd, p_datum.Datum.i(h)], h)
            assert want == got, (coll, unique, v)


ROW_KINDS = ["int", "uint", "float", "dec", "str", "bytes", "date", "duration"]


@pytest.mark.parametrize("kind", ROW_KINDS)
def test_v1_rows_are_the_references_bytes(kind):
    """encode_row / decode_row (the txn write path's format): the same
    bytes for a row of every value of a kind and NULLs between them."""
    vals = VALUES[kind][0] + [None]
    rds = [_both(kind, v)[0] for v in vals]
    pds = [_both(kind, v)[1] for v in vals]
    ids = list(range(5, 5 + len(vals)))
    rb, pb = r_row.encode_row(ids, rds), p_row.encode_row(ids, pds)
    assert rb == pb
    rback, pback = r_row.decode_row(rb), p_row.decode_row(pb)
    assert sorted(rback) == sorted(pback) == ids
    assert all(_same_datum(rback[i], pback[i]) for i in ids)


def _v2_columns(n, seed):
    """(col_ids, kinds, scales, arrays, valids): every fixed kind and a
    string lane, ~15% NULL, zeroed under NULL as the bulk path stores them."""
    rng = np.random.default_rng(seed)
    K = r_datum
    f = rng.standard_normal(n) * 100
    f[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324][: min(6, n)]
    arrays = [rng.integers(I64.min, I64.max, n, dtype=np.int64),
              rng.integers(0, 1 << 63, n, dtype=np.uint64) | np.uint64(1 << 63),
              f,
              rng.integers(-10**12, 10**12, n),
              np.array([_pack(int(y), int(m), int(d)) for y, m, d in zip(
                  rng.integers(1992, 1999, n), rng.integers(1, 13, n), rng.integers(1, 29, n))], dtype=np.int64),
              rng.integers(-10**12, 10**12, n),
              np.array([STRINGS[i] for i in rng.integers(0, len(STRINGS), n)], dtype=object)]
    kinds = [K.K_INT, K.K_UINT, K.K_FLOAT, K.K_DEC, K.K_TIME, K.K_DUR, K.K_STR]
    scales = [0, 0, 0, 2, 0, 0, 0]
    valids = [rng.random(n) >= 0.15 for _ in arrays]
    valids[0][:] = True
    return [10 + i for i in range(len(arrays))], kinds, scales, arrays, valids


@pytest.mark.parametrize("n", [1, 7, 300])
def test_v2_rows_encode_the_references_bytes_and_round_trip(n):
    ids, kinds, scales, arrays, valids = _v2_columns(n, n)
    rbuf, roffs = r_fast.encode_rows_v2(ids, kinds, scales, arrays, valids)
    pbuf, poffs = p_fast.encode_rows_v2(ids, kinds, scales, arrays, valids)
    assert np.array_equal(rbuf, pbuf) and np.array_equal(roffs, poffs)
    rows = p_fast.split_buffer(pbuf, poffs)
    assert rows == r_fast.split_buffer(rbuf, roffs)
    for i, row in enumerate(rows):
        got, via = p_fast.decode_row_v2(row), p_row.decode_row(row)
        want = r_fast.decode_row_v2(row)
        for cid, arr, v in zip(ids, arrays, valids):
            assert _same_datum(want[cid], got[cid]) and _same_datum(got[cid], via[cid])
            if not v[i]:
                assert got[cid].is_null
            elif arr.dtype == object:
                assert got[cid].val == arr[i]
            elif arr.dtype == np.float64:
                assert np.float64(got[cid].val).tobytes() == arr[i].tobytes()
            elif isinstance(got[cid].val, p_dec.Dec):
                assert got[cid].val.value == int(arr[i])
            else:
                assert got[cid].val == int(arr[i])


def _v2_table(schema, ft_mod, ids):
    F = ft_mod
    fts = [F.ft_longlong(), F.ft_longlong(unsigned=True), F.ft_double(), F.ft_decimal(20, 2),
           F.FieldType(F.TypeCode.Date), F.FieldType(F.TypeCode.Duration), F.ft_varchar(32)]
    return schema.TableInfo(7, "v2", [schema.ColumnInfo(cid, f"c{cid}", ft, i)
                                      for i, (cid, ft) in enumerate(zip(ids, fts))])


def test_v2_batch_decode_fills_the_same_chunk_columns():
    """decode_v2_batch over a buffer of v2 rows: the port's chunk columns
    equal the reference's, data and valid, NULL rows included."""
    n = 500
    ids, kinds, scales, arrays, valids = _v2_columns(n, 3)
    buf, offs = p_fast.encode_rows_v2(ids, kinds, scales, arrays, valids)
    outs = []
    for schema, ft_mod, chunk_cls, fast in ((r_schema, r_ft, RChunk, r_fast), (p_schema, p_ft, PChunk, p_fast)):
        info = _v2_table(schema, ft_mod, ids)
        chk = chunk_cls.empty([c.ft for c in info.columns], n)
        bad = fast.decode_v2_batch(buf, offs[:-1], info, chk.columns, np.arange(n, dtype=np.int64))
        assert len(bad) == 0
        outs.append(chk.columns)
    for rc, pc, v in zip(*outs, valids):
        assert np.array_equal(rc.valid, pc.valid) and np.array_equal(pc.valid, v)
        assert rc.data.dtype == pc.data.dtype
        if rc.data.dtype == object:
            assert list(rc.data[v]) == list(pc.data[v])
        else:
            assert np.array_equal(rc.data[v].view(np.int64), pc.data[v].view(np.int64))


@pytest.mark.parametrize("table_id", [1, 129, -5, (1 << 40) + 3])
def test_table_keys_are_the_references_bytes(table_id):
    """tablecodec's prefixes, record and index keys and their decoders,
    and rowfast's record / int-index key matrices and handle values."""
    handles = np.array([I64.min, -1, 0, 1, 2, 1 << 33, I64.max], dtype=np.int64)
    assert r_tc.table_prefix(table_id) == p_tc.table_prefix(table_id)
    assert r_tc.record_prefix(table_id) == p_tc.record_prefix(table_id)
    assert r_tc.index_prefix(table_id, 7) == p_tc.index_prefix(table_id, 7)
    for h in handles.tolist():
        rk = r_tc.record_key(table_id, h)
        assert rk == p_tc.record_key(table_id, h)
        assert p_tc.decode_record_handle(rk) == h and p_tc.decode_table_id(rk) == table_id
        assert p_tc.is_record_key(rk) == r_tc.is_record_key(rk)
        ik = r_tc.index_key(table_id, 7, b"\x03abc", h)
        assert ik == p_tc.index_key(table_id, 7, b"\x03abc", h) and p_tc.decode_index_handle(ik) == h
    assert np.array_equal(r_fast.record_key_matrix(table_id, handles), p_fast.record_key_matrix(table_id, handles))
    cols = [np.array([5, -5, 0, I64.max, I64.min, 3, 3], dtype=np.int64), handles[::-1].copy()]
    for hs in (None, handles):
        assert np.array_equal(r_fast.int_index_key_matrix(table_id, 7, cols, hs),
                              p_fast.int_index_key_matrix(table_id, 7, cols, hs))
    rv, pv = r_fast.handle_value_buffer(handles), p_fast.handle_value_buffer(handles)
    assert rv[0] == pv[0] and all(np.array_equal(a, b) for a, b in zip(rv[1:], pv[1:]))
