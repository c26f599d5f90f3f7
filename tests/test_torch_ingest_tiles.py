"""The port's bulk ingest and tile cache against the reference's, on the CPU.

The same generated lineitem columns go into the reference through its own
Session (CREATE TABLE from tpch.LINEITEM_DDL, then models/tpch.bulk_load)
and into the port's store through chip_smoke.StoreSession (the Session's
surface bulk_load uses) with the reference's TableInfo carried across by
JSON, both stores splitting regions at 4,096 keys. Then, under both bulk
routes (tidb_bulk_ingest ON and OFF):

  * the region bounds are the same key bytes;
  * every region's ColumnBatch from TileCache.get_batch is bit-identical
    (handles, every data and valid lane, dtypes), and so are the lane
    codecs each engine's device mirror picks (`lane_sigs`, compression
    ON and OFF);
  * Q1, Q6, tpch_topn and Q18's subquery over the port's store batches
    through run_many(device="cpu") give the reference TPUEngine's
    partial chunks over the reference's store batches, region by region,
    with equal fallback counts.

Then one HTAP transaction on both stores through each package's
table.Table — an update of l_discount in one region, deletes in another,
inserts after the last handle — and the batches again: identical, with
the committed rows merged after the runs' kept rows. The reference's
cache rebuilds every region of the table on the version bump; the port's
rebuilds only the regions the transaction wrote (the others kept, their
device lanes with them).

Also: the port's LINEITEM is the TableInfo the reference's DDL builds (ids
aside), and the store's 8-region cut of 16M rows is the one
models/tpch.region_batches makes.
"""

import copy

import numpy as np
import pytest
import torch

from tidb_tpu.codec import tablecodec as r_tc
from tidb_tpu.copr.tpu_engine import DeviceBatch as RDeviceBatch, TPUEngine
from tidb_tpu.models import tpch as r_tpch
from tidb_tpu.mysqltypes.datum import Datum as RDatum
from tidb_tpu.mysqltypes.mydecimal import Dec as RDec
from tidb_tpu.planner.ranger import prefix_next as r_prefix_next
from tidb_tpu.session import Session
from tidb_tpu.table.table import Table as RTable

import chip_smoke as cs
from tidb_tpu_torch.catalog.schema import TableInfo
from tidb_tpu_torch.copr.gpu_engine import DeviceBatch as PDeviceBatch, TorchEngine
from tidb_tpu_torch.entry import run_many
from tidb_tpu_torch.models import tpch
from tidb_tpu_torch.mysqltypes.datum import Datum as PDatum
from tidb_tpu_torch.mysqltypes.mydecimal import Dec as PDec
from tidb_tpu_torch.storage import Storage
from tidb_tpu_torch.table.table import Table as PTable

from test_torch_engine import _assert_same_chunk
from test_torch_tpch import _capture

N = 20_000
SPLIT = 4096
QUERIES = {"Q1": (tpch.Q1, "q1_dag"), "Q6": (tpch.Q6, "q6_dag"), "tpch_topn": (tpch.TOPN, "topn_dag"),
           "q18_inner": (tpch.Q18_INNER, "q18_inner_dag")}


def _strip_ids(d):
    d = copy.deepcopy(d)
    d.pop("id")
    for c in d["columns"]:
        c.pop("id")
    for i in d["indexes"]:
        i.pop("id")
    return d


class Both:
    """The reference Session and the port's StoreSession over the same rows."""

    def __init__(self, route: str):
        self.ref = Session()
        self.ref.store.region_split_size = SPLIT
        self.ref.vars["tidb_bulk_ingest"] = route
        self.ref.execute(r_tpch.LINEITEM_DDL)
        rinfo = self.ref.infoschema().table(self.ref.current_db, "lineitem")
        self.port = cs.StoreSession(Storage())
        self.port.store.region_split_size = SPLIT
        self.port.vars["tidb_bulk_ingest"] = route
        self.port.create_table(TableInfo.from_json(rinfo.to_json()))
        r_tpch.bulk_load(self.ref, "lineitem", r_tpch.gen_lineitem(N, 42))
        tpch.bulk_load(self.port, "lineitem", tpch.gen_lineitem(N, 42))

    @property
    def rinfo(self):
        return self.ref.infoschema().table(self.ref.current_db, "lineitem")

    @property
    def pinfo(self):
        return self.port.infoschema().table("test", "lineitem")

    def ref_batches(self):
        p = r_tc.record_prefix(self.rinfo.id)
        read_ts = self.ref.store.tso.next()
        return [self.ref.cop.tiles.get_batch(self.rinfo, s, e, read_ts)
                for _r, s, e in self.ref.store.regions.split_ranges(p, r_prefix_next(p))]

    def port_batches(self):
        return cs.store_batches(self.port, self.pinfo)


@pytest.fixture(scope="module", params=["ON", "OFF"])
def both(request):
    return Both(request.param)


def _assert_same_batches(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert (w.start, w.end) == (g.start, g.end)
        assert w.handles.dtype == g.handles.dtype and np.array_equal(w.handles, g.handles)
        assert len(w.data) == len(g.data)
        for j, (wd, gd, wv, gv) in enumerate(zip(w.data, g.data, w.valid, g.valid)):
            assert wd.dtype == gd.dtype, j
            assert np.array_equal(wv, gv), j
            if wd.dtype == object:
                assert wd.tolist() == gd.tolist(), j
            else:
                assert np.array_equal(wd.view(np.uint8), gd.view(np.uint8)), j


def test_the_port_lineitem_is_the_table_the_reference_ddl_builds():
    s = Session()
    s.execute(r_tpch.LINEITEM_DDL)
    want = s.infoschema().table(s.current_db, "lineitem").to_json()
    assert _strip_ids(tpch.LINEITEM.to_json()) == _strip_ids(want)
    assert tpch.LINEITEM_DDL == r_tpch.LINEITEM_DDL
    back = TableInfo.from_json(tpch.LINEITEM.to_json())
    assert back.to_json() == tpch.LINEITEM.to_json() and back.handle_col().name == "_tidb_rowid"


def test_the_regions_split_at_the_same_keys(both):
    want = [(r.start, r.end) for r in both.ref.store.regions.regions]
    got = [(r.start, r.end) for r in both.port.store.regions.regions]
    assert got == want
    if both.ref.vars["tidb_bulk_ingest"] == "ON":  # one run a plane: split at every SPLIT-th key
        assert len(got) > N // SPLIT


def test_every_region_batch_is_bit_identical(both):
    want, got = both.ref_batches(), both.port_batches()
    assert [b.n_rows for b in got] == [b.n_rows for b in want] and sum(b.n_rows for b in got) == N
    _assert_same_batches(want, got)
    assert got[0].handles[0] == 1  # the first handle alloc_auto_id hands out, as the reference's


@pytest.mark.parametrize("compress", [True, False])
def test_the_device_mirrors_pick_the_same_lane_codecs(both, compress):
    for rb, pb in zip(both.ref_batches(), both.port_batches()):
        rm, pm = RDeviceBatch(rb, compress=compress), PDeviceBatch(pb, torch.device("cpu"), compress=compress)
        for off in range(len(rb.data)):
            rm.lanes(off)
            pm.lanes(off)
        assert pm.lane_sigs == rm.lane_sigs


@pytest.mark.parametrize("q", list(QUERIES))
def test_the_queries_over_the_store_batches_give_the_reference_engines_partials(both, q):
    sql, builder = QUERIES[q]
    seen, _rows = _capture(both.ref, sql)
    rdag = seen[0]
    rbatches, pbatches = both.ref_batches(), both.port_batches()
    reng, peng = TPUEngine(), TorchEngine(device="cpu")
    want = [reng.execute(rdag, b) for b in rbatches]
    got = run_many([(getattr(tpch, builder)(), b) for b in pbatches], device="cpu", engine=peng)
    for w, g in zip(want, got):
        _assert_same_chunk(w, g)
    assert peng.fallbacks == reng.fallbacks


def _htap(pkg_table, datum, dec, sess, info, batches, rng_seed, region_upd, region_del):
    """One transaction through table.Table: l_discount + 1 (cent) on 50
    rows of `region_upd`, 50 rows of `region_del` deleted, 50 rows
    inserted after the last handle; old rows come from the batches."""
    rng = np.random.default_rng(rng_seed)
    t = pkg_table(info)
    names = [c.name for c in info.columns if not c.hidden]
    disc = names.index("l_discount")
    txn = sess.store.begin()

    def row(b, i):
        out = []
        for c in info.columns:
            if c.hidden:
                continue
            d = b.data[c.offset][i]
            if c.ft.is_decimal():
                out.append(datum.d(dec(int(d), 2)))
            elif c.ft.is_string():
                out.append(datum.s(d))
            elif c.ft.is_time():
                out.append(datum.t(int(d)))
            else:
                out.append(datum.i(int(d)))
        return out

    b = batches[region_upd]
    for i in sorted(rng.choice(b.n_rows, 50, replace=False).tolist()):
        old = row(b, i)
        new = list(old)
        new[disc] = datum.d(dec(int(b.data[disc][i]) + 1, 2))
        t.update_record(txn, int(b.handles[i]), t.row_datums_with_hidden(old, int(b.handles[i])),
                        t.row_datums_with_hidden(new, int(b.handles[i])))
    b = batches[region_del]
    for i in sorted(rng.choice(b.n_rows, 50, replace=False).tolist()):
        t.remove_record(txn, int(b.handles[i]), t.row_datums_with_hidden(row(b, i), int(b.handles[i])))
    first = sess.alloc_auto_id(info, 50)
    src = batches[0]
    for j in range(50):
        h = first + j
        t.add_record(txn, t.row_datums_with_hidden(row(src, j), h), h)
    return txn.commit()


def test_an_htap_transaction_rebuilds_the_written_regions_only(both):
    """After the commit the port's batches are the reference's bit for
    bit; the reference's cache misses on every region, the port's on the
    written ones only, and keeps the others (with their device lanes)."""
    before_r, before_p = both.ref_batches(), both.port_batches()
    for b in before_p:  # device lanes the cache must keep or drop with the batch
        m = PDeviceBatch(b, torch.device("cpu"))
        m.lanes(0)
        b._gpu_mirrors = {("cpu", True): m}
    last = len(before_p) - 1
    _htap(RTable, RDatum, RDec, both.ref, both.rinfo, before_r, 7, 1, 3)
    _htap(PTable, PDatum, PDec, both.port, both.pinfo, before_p, 7, 1, 3)
    rt, pt = both.ref.cop.tiles, both.port.cop.tiles
    r_miss, p_miss, p_hits = rt.misses, pt.misses, pt.hits
    want, got = both.ref_batches(), both.port_batches()
    _assert_same_batches(want, got)
    touched = {1, 3, last}
    assert rt.misses - r_miss == len(want)
    assert pt.misses - p_miss == len(touched) and pt.hits - p_hits == len(got) - len(touched)
    assert pt.revalidated >= len(got) - len(touched)
    for i, (b0, b1) in enumerate(zip(before_p, got)):
        if i in touched:
            assert b1 is not b0 and b0._gpu_mirrors is None  # rebuilt: the old lanes dropped
        else:
            assert b1 is b0 and b0._gpu_mirrors  # kept, lanes resident
    assert got[last].handles[-1] == N + 50 and got[1].n_rows == before_p[1].n_rows
    assert got[3].n_rows == before_p[3].n_rows - 50
    # the updated rows come after the region's kept rows, as the reference merges them
    assert not np.array_equal(got[1].handles, before_p[1].handles)
    for q in ("Q1", "q18_inner"):
        sql, builder = QUERIES[q]
        rdag = _capture(both.ref, sql)[0][0]
        reng = TPUEngine()
        wparts = [reng.execute(rdag, b) for b in want]
        gparts = run_many([(getattr(tpch, builder)(), b) for b in got], device="cpu")
        for w, g in zip(wparts, gparts):
            _assert_same_chunk(w, g)


def test_the_tile_cache_drops_device_lanes_on_invalidate_and_evict():
    sess = cs.StoreSession(Storage())
    sess.store.region_split_size = 512
    sess.create_table(copy.deepcopy(tpch.LINEITEM))
    tpch.bulk_load(sess, "lineitem", tpch.gen_lineitem(3000, 1))
    info = sess.infoschema().table("test", "lineitem")
    bs = cs.store_batches(sess, info)
    assert len(bs) == 6 and cs.store_batches(sess, info)[0] is bs[0]
    for b in bs:
        b._gpu_mirrors = {}
    tiles = sess.cop.tiles
    tiles.invalidate_table(info.id)
    assert all(b._gpu_mirrors is None for b in bs) and not tiles._cache
    bs = cs.store_batches(sess, info)
    assert tiles.evict_all() > 0 and not tiles._cache


def test_the_stores_cut_of_16m_rows_is_region_batches_cut():
    """The split rule over 16,000,000 handles (storage/txn.py's
    _auto_split_run at 2,097,152 keys) gives the row counts
    models/tpch.region_batches cuts: 7 x 2,097,152 and 1,319,936."""
    n, step = 16_000_000, 1 << 21
    handles = np.arange(1, n + 1, dtype=np.int64)
    store = Storage()
    from tidb_tpu_torch.storage.segment import ColumnarRun

    run = ColumnarRun(1, handles, [], 1)
    store._auto_split_run(run)
    keys = [r.start for r in store.regions.regions[1:]]
    from tidb_tpu_torch.codec import tablecodec

    assert keys == [tablecodec.record_key(1, 1 + step * k) for k in range(1, 8)]
    bounds = [0] + [int(tablecodec.decode_record_handle(k)) - 1 for k in keys] + [n]
    counts = [b - a for a, b in zip(bounds, bounds[1:])]
    from tidb_tpu_torch.copr.tilecache import ColumnBatch

    cut = tpch.region_batches(ColumnBatch(tpch.LINEITEM, handles, [], [], 0), step)
    assert counts == [len(c.handles) for c in cut] == [step] * 7 + [1_319_936]


def test_chip_smokes_store_phases_run_narrowed_on_the_cpu():
    """main.store and main.store.htap of chip_smoke.py, narrowed (40,000
    rows in regions of 8,192, 500 rows a kind in the transaction) and on
    the CPU: the regions are the split rule's, the cold reads miss and
    the warm ones hit, the transaction rebuilds the written regions only,
    Q1 and Q18's subquery equal the host engine, and the first rerun
    uploads exactly the rebuilt regions' lanes."""
    out = {}
    cols = tpch.gen_lineitem(40_000, 42)
    sess, info, regions = cs.run_store_path(cols, 40_000, "cpu", out, split=8192)
    assert out["store"]["region_rows"] == cs.split_rule(40_000, 8192) == [8192] * 4 + [7232]
    for builder in ("q1_dag", "q18_inner_dag"):  # the region phases' lanes, resident before the transaction
        dag = getattr(tpch, builder)()
        run_many([(dag, b) for b in regions], device="cpu")
    from tidb_tpu_torch.entry import batch_from_numpy

    cs.run_store_turns("cpu", batch_from_numpy(tpch.LINEITEM, cols), regions, "cpu", out, turns=2, split=8192)
    assert set(out["store_turns"]["q1"]) == {"store", "cut"}
    cs.run_htap_path("cpu", sess, info, regions, 42, "cpu", out, n_rows=500)
    h = out["store_htap"]
    assert h["rebuilt_regions"] == [2, 5] and h["region_rows"] == [8192, 8192, 8192, 8192, 7232 - 500 + 500]
    assert h["runs"]["q1"]["h2d_bytes_first"] > 0 and h["runs"]["q1"]["h2d_bytes_warm"] == 0


def test_row_pairs_decode_to_the_references_batch(both):
    """decode_rows_to_batch over the store's (key, value) pairs of the
    table — the ingest runs' synthesized v2 rows and, after a commit, the
    transactions' v1 rows — gives the reference's batch for the same pairs."""
    from tidb_tpu.copr.tilecache import decode_rows_to_batch as r_decode
    from tidb_tpu_torch.copr.tilecache import decode_rows_to_batch as p_decode

    p = r_tc.record_prefix(both.rinfo.id)
    kvs = both.ref.store.snapshot().scan(p, r_prefix_next(p))[:3000]
    assert kvs == both.port.store.snapshot().scan(p, r_prefix_next(p))[:3000]
    want, got = r_decode(both.rinfo, kvs, 1), p_decode(both.pinfo, kvs, 1)
    for b in (want, got):
        b.start = b.end = b""
    _assert_same_batches([want], [got])
