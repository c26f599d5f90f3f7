"""The port's device window path held to the reference on the CPU.

* Module parity: every window query of the reference's own device tests
  (tests/test_window_device.py QUERIES, tests/test_window_frames.py ROWS
  and RANGE queries) runs through a reference Session with
  tidb_cop_engine='tpu'. A spy on the reference's run_device_window
  captures its numpy inputs and its answer; the port's run_device_window
  (device="cpu": W1 and W2 through their plain versions) must give the
  same answer for the same inputs.
* A random battery at ~5,000 rows (chip_smoke.py's own, which holds W1
  to its plain version on the card) goes straight to both
  run_device_window functions: NULLs in keys and arguments, duplicate keys, negative ints,
  floats with NaN and ±0.0, uint64 arguments, an int64 sum that
  overflows mid-prefix, every frame kind (empty frames, RANGE offsets ASC
  and DESC with NULL keys) and every function.
* The port's WindowExec: a spy on the reference's WindowExec captures its
  child rows, spec and answer; the port's WindowExec over the same rows
  (converted to the port's types) answers the same in 'tpu' and 'host'
  modes, and declines to the host exactly where the reference does, with
  the same fallback_reason.

Ints, decimals, dates, strings, row ids and validity compare bit-exact;
floats within rtol 1e-9 / atol 1e-6 (bench.py's check) with NaN in the
same rows.
"""

import numpy as np
import pytest
import torch
from chip_smoke import win_lanes, window_battery
from test_window_device import QUERIES as DEVICE_QUERIES
from test_window_frames import RANGE_QUERIES, ROWS_QUERIES

from tidb_tpu.executor import executors as ref_ex
from tidb_tpu.executor import window_device as ref_wd
from tidb_tpu.session import Session

from tidb_tpu_torch.chunk.chunk import Chunk as PChunk, Column as PColumn
from tidb_tpu_torch.entry import batch_from_numpy, run_window
from tidb_tpu_torch.executor import window_device as wd
from tidb_tpu_torch.executor.window import WindowExec
from tidb_tpu_torch.expr.aggregation import Frame as PFrame, WinDesc as PWinDesc
from tidb_tpu_torch.expr.expression import FUNCS, Column as PCol, Constant as PConst, ScalarFunc as PFunc
from tidb_tpu_torch.kernels import window, window_ref
from tidb_tpu_torch.models import tpch
from tidb_tpu_torch.mysqltypes import field_type as PF
from tidb_tpu_torch.mysqltypes.datum import Datum as PDatum
from tidb_tpu_torch.mysqltypes.mydecimal import Dec as PDec

RTOL, ATOL = 1e-9, 1e-6

EMP = [
    "CREATE TABLE emp (id INT PRIMARY KEY, dept VARCHAR(10), name VARCHAR(10),"
    " sal INT, bonus DECIMAL(8,2), rate DOUBLE)",
    "INSERT INTO emp VALUES "
    "(1, 'eng',  'ann', 100, 10.50, 1.5),"
    "(2, 'eng',  'bob', 200, NULL, 2.5),"
    "(3, 'eng',  'cat', 200, 20.25, NULL),"
    "(4, 'sales','dan', 150, 5.00, 0.25),"
    "(5, 'sales','eve', 300, 7.75, 4.0),"
    "(6, 'ops',  'fay', 120, NULL, -1.0),"
    "(7, 'ops',  NULL,  NULL, 3.00, 2.0)",
    "CREATE TABLE u (id INT PRIMARY KEY, g INT, v BIGINT UNSIGNED)",
    "INSERT INTO u VALUES (1, 1, 18446744073709551615), (2, 1, NULL),"
    " (3, 1, 5), (4, 2, 9223372036854775808)",
]
UNSIGNED_QUERY = ("SELECT id, MIN(v) OVER (PARTITION BY g), MAX(v) OVER (PARTITION BY g),"
                  " MIN(v) OVER (PARTITION BY g ORDER BY id),"
                  " MAX(v) OVER (PARTITION BY g ORDER BY id) FROM u ORDER BY id")


def _frames_table() -> list[str]:
    """tests/test_window_frames.py's table, the same rows."""
    rng = np.random.default_rng(23)
    rows = []
    for i in range(600):
        g = int(rng.integers(0, 7))
        v = "NULL" if rng.random() < 0.15 else str(int(rng.integers(-50, 50)))
        d = f"{rng.integers(-999, 999)}.{rng.integers(0, 99):02d}"
        f_ = ["1.5", "-2.25", "0.5", "NULL"][int(rng.integers(0, 4))]
        nm = ["'aa'", "'bb'", "'cc'", "'dd'", "NULL"][int(rng.integers(0, 5))]
        rows.append(f"({i}, {g}, {v}, {d}, {f_}, {nm})")
    return ["CREATE TABLE t (id INT PRIMARY KEY, g INT, v INT, d DECIMAL(8,2), f DOUBLE, name VARCHAR(10))",
            "INSERT INTO t VALUES " + ",".join(rows)]


DECLINES = [
    # (query, the reference's fallback_reason)
    ("SELECT id, MIN(s) OVER (PARTITION BY g ORDER BY id) FROM c ORDER BY id",
     "window min over ci-collated strings"),
    ("SELECT id, COUNT(*) OVER (ORDER BY f RANGE BETWEEN 1.0 PRECEDING AND 1.0 FOLLOWING) FROM t ORDER BY id",
     "RANGE offset frame not device-eligible (non-int key/offset or composite overflow)"),
    ("SELECT id, MAX(v) OVER (PARTITION BY g ORDER BY v RANGE BETWEEN 2 PRECEDING AND 2 FOLLOWING)"
     " FROM t ORDER BY id", "peer-bounded MIN/MAX frame has no device kernel"),
    ("SELECT id, MIN(v) OVER (ORDER BY id ROWS BETWEEN 70000 PRECEDING AND CURRENT ROW) FROM t ORDER BY id",
     "ROWS frame too wide for the device sparse table"),
]
CI_TABLE = [
    "CREATE TABLE c (id INT PRIMARY KEY, g INT, s VARCHAR(10) COLLATE utf8mb4_general_ci)",
    "INSERT INTO c VALUES (1, 1, 'b'), (2, 1, 'A'), (3, 2, 'a'), (4, 2, NULL), (5, 1, 'B')",
]


# --- the reference's objects as the port's -----------------------------------------


def port_ft(ft) -> PF.FieldType:
    return PF.FieldType(PF.TypeCode(int(ft.tp)), ft.flag, ft.flen, ft.decimal, ft.charset, ft.collate,
                        tuple(ft.elems))


def port_expr(e):
    name = type(e).__name__
    if name == "Column":
        return PCol(e.idx, port_ft(e.ret_type), e.name)
    if name == "Constant":
        val = e.value.val
        if type(val).__name__ == "Dec":
            val = PDec(val.value, val.scale)
        return PConst(PDatum(e.value.kind, val), port_ft(e.ret_type))
    if name == "ScalarFunc":
        return PFunc(FUNCS[e.sig.name], [port_expr(a) for a in e.args], port_ft(e.ret_type))
    raise TypeError(f"no port form for {e!r}")


def port_win(w) -> PWinDesc:
    frame = None if w.frame is None else PFrame(*w.frame.key())
    return PWinDesc(w.name, [port_expr(a) for a in w.args], [port_expr(p) for p in w.part_by],
                    [(port_expr(e), d) for e, d in w.order_by], port_ft(w.ret_type), frame)


def port_chunk(c) -> PChunk:
    return PChunk([PColumn(port_ft(col.ft), col.data, col.valid) for col in c.columns])


# --- capture -----------------------------------------------------------------------------


class _Rows(ref_ex.Executor):
    """A child that hands over rows already drained."""

    def __init__(self, c):
        self.c, self.out_fts = c, c.field_types()

    def next(self):
        c, self.c = self.c, None
        return c


def capture(setup: list[str], sql: str, monkeypatch):
    """Run `sql` on a fresh reference Session under tidb_cop_engine='tpu'
    → (run_device_window calls [(args, kwargs, result)], WindowExec runs
    [dict]) of the reference."""
    s = Session()
    for q in setup:
        s.execute(q)
    calls, execs = [], []
    orig_run = ref_wd.run_device_window

    def spy_run(*a, **kw):
        res = orig_run(*a, **kw)
        calls.append((a, kw, res))
        return res

    orig_next = ref_ex.WindowExec.next

    def spy_next(self):
        if self._done:
            return orig_next(self)
        rows = ref_ex.drain(self.child)
        self.child = _Rows(rows)
        out = orig_next(self)
        execs.append(dict(rows=rows, part_by=self.part_by, order_by=self.order_by, funcs=self.funcs,
                          out_fts=self.out_fts, out=out, engine=self.last_engine, reason=self.fallback_reason))
        return out

    monkeypatch.setattr(ref_wd, "run_device_window", spy_run)
    monkeypatch.setattr(ref_ex.WindowExec, "next", spy_next)
    s.execute("SET tidb_cop_engine = 'tpu'")
    s.must_query(sql)
    monkeypatch.undo()
    return calls, execs


# --- comparisons -------------------------------------------------------------------------


def same_lane(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == object:
        assert got.dtype == object and got.tolist() == want.tolist(), what
    elif want.dtype == np.float64:
        assert got.dtype == np.float64, what
        assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaN rows differ"
        assert np.allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True), what
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want), what


def same_results(got, want, what: str) -> None:
    assert len(got) == len(want), what
    for j, ((gd, gv), (wd_, wv)) in enumerate(zip(got, want)):
        same_lane(gv, wv, f"{what}: function {j} valid")
        same_lane(gd, wd_, f"{what}: function {j} data")


def port_run(a, kw):
    part, order, fspecs, n = a[:4]
    return wd.run_device_window(part, order, fspecs, n, device="cpu", range_lane=kw.get("range_lane"))


SESSION_QUERIES = ([(EMP, q) for q in DEVICE_QUERIES] + [(EMP, UNSIGNED_QUERY)]
                   + [(None, q) for q in ROWS_QUERIES + RANGE_QUERIES])


@pytest.mark.parametrize("setup,sql", SESSION_QUERIES, ids=[f"q{i}" for i in range(len(SESSION_QUERIES))])
def test_port_window_answers_as_the_reference(setup, sql, monkeypatch):
    calls, execs = capture(setup or _frames_table(), sql, monkeypatch)
    assert execs, "the reference ran no window"
    # the module: the same inputs through the port's run_device_window
    for a, kw, want in calls:
        same_results(port_run(a, kw), want, sql)
    # the executor: the same rows and spec through the port's WindowExec
    for e in execs:
        spec = ([port_expr(p) for p in e["part_by"]], [(port_expr(x), d) for x, d in e["order_by"]],
                [port_win(f) for f in e["funcs"]], [port_ft(ft) for ft in e["out_fts"]])
        want = e["out"].to_pylist()
        for mode in ("tpu", "host"):
            w = WindowExec(port_chunk(e["rows"]), *spec, engine=mode, device="cpu")
            assert w.next().to_pylist() == want, f"{mode}: {sql}"
            if mode == "tpu":
                assert w.last_engine == e["engine"], sql
                assert w.fallback_reason == e["reason"], sql


def test_every_session_query_reached_a_device_or_a_reason(monkeypatch):
    """Guards the battery above: the device queries really ran on the
    reference's device path (so the module parity saw their inputs)."""
    calls, execs = capture(EMP, DEVICE_QUERIES[0], monkeypatch)
    assert calls and execs[0]["engine"] == "tpu"


@pytest.mark.parametrize("sql,reason", DECLINES, ids=[r.split()[0] + str(i) for i, (_, r) in enumerate(DECLINES)])
def test_port_declines_where_the_reference_declines(sql, reason, monkeypatch):
    calls, execs = capture(CI_TABLE + _frames_table(), sql, monkeypatch)
    assert not calls
    assert [e["reason"] for e in execs] == [reason]
    e = execs[0]
    spec = ([port_expr(p) for p in e["part_by"]], [(port_expr(x), d) for x, d in e["order_by"]],
            [port_win(f) for f in e["funcs"]], [port_ft(ft) for ft in e["out_fts"]])
    w = WindowExec(port_chunk(e["rows"]), *spec, engine="tpu", device="cpu")
    assert w.next().to_pylist() == e["out"].to_pylist()
    assert (w.last_engine, w.fallback_reason) == ("host", reason)


# --- the random battery ----------------------------------------------------------------

N_RANDOM = 5000


def _random_lanes(n: int, seed: int):
    return win_lanes(np.random.default_rng(seed), n)


def _fspec(static, args=(), frame=None, post=None):
    return {"name": static[0], "static": static, "args": list(args), "post": post, "frame": frame}


def _both(part, order, fspecs, n, range_lane=None):
    want = ref_wd.run_device_window(part, order, fspecs, n, range_lane=range_lane)
    got = wd.run_device_window(part, order, fspecs, n, device="cpu", range_lane=range_lane)
    same_results(got, want, "random battery")
    return got


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
def test_random_battery_matches_the_reference(desc):
    lanes = _random_lanes(N_RANDOM, 7 + desc)
    part, order, fspecs, range_lane = window_battery(lanes, desc)
    got = _both(part, order, fspecs, N_RANDOM, range_lane)
    # the battery means what it says: the overflowing sum wrapped, some
    # frames were empty, NULL-key rows and NaNs reached the outputs
    big_sum = got[19][0]
    assert (big_sum < 0).any() and (big_sum > 0).any()
    assert not got[22][1].any() and got[23][1].any() and not got[23][1].all()
    assert np.isnan(got[20][0][got[20][1]]).any()


def test_float_and_multi_word_order_keys_match_the_reference():
    """A float DESC key with NaN and ±0.0 ahead of an int key, a uint64
    partition word: rankings, default-frame sums and min/max."""
    lanes = _random_lanes(N_RANDOM, 3)
    fs = [_fspec(("rank",)), _fspec(("dense_rank",)), _fspec(("percent_rank",), post=("percent_rank",)),
          _fspec(("sum", True), [lanes["f"]]), _fspec(("min",), [lanes["f"]]), _fspec(("max",), [lanes["u"]]),
          _fspec(("lead", 1, False), [lanes["f"]]), _fspec(("last_value",), [lanes["i"]], ("rows", "cur", 0, "uf", 0))]
    _both([lanes["h"]], [(lanes["fk"], True), (lanes["o"], False)], fs, N_RANDOM)


@pytest.mark.parametrize("n,parts", [(1, True), (1024, False), (3000, False), (2049, True)],
                         ids=["one_row", "one_partition_full_bucket", "one_partition", "tile_edge"])
def test_edge_shapes_match_the_reference(n, parts):
    lanes = _random_lanes(n, 11)
    part = [lanes["g"]] if parts else []
    fs = [_fspec(("row_number",)), _fspec(("sum", True), [lanes["big"]]),
          _fspec(("max",), [lanes["f"]], ("rows", "pre", 1, "fol", 1)),
          _fspec(("min",), [lanes["u"]], ("rows", "pre", 1, "uf", 0)),
          _fspec(("lag", 1, False), [lanes["i"]]), _fspec(("ntile", 4))]
    _both(part, [(lanes["o"], False)], fs, n)


def test_window_wrapper_takes_the_plain_version_on_the_cpu():
    lanes = _random_lanes(2000, 5)
    part, order, fspecs, range_lane = window_battery(lanes, False)
    got = wd.run_device_window(part, order, fspecs, 2000, device="cpu", range_lane=range_lane)
    assert window.launches == 0
    assert len(got) == len(fspecs)
    P = wd._bucket(2000)
    words = [torch.from_numpy(np.full(P, 1, np.int32)), torch.from_numpy(np.arange(P))]
    spec = (1, 1, (("row_number",),), (None,))
    a = window(words, ((),), spec)
    b = window_ref(words, ((),), spec)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[0], torch.arange(1, P + 1))


def test_window_wrapper_rejects_what_it_does_not_take():
    P = 1024
    w = [torch.zeros(P, dtype=torch.int32)]
    with pytest.raises(ValueError):
        window([torch.zeros(1000, dtype=torch.int32)], ((),), (1, 0, (("row_number",),), (None,)))
    with pytest.raises(TypeError):
        window(w, (((torch.zeros(P, dtype=torch.int32), torch.ones(P, dtype=torch.bool)),),),
               (1, 0, (("min",),), (None,)))
    with pytest.raises(ValueError):
        window(w, ((),), (1, 0, (("ntile", 0),), (None,)))
    with pytest.raises(ValueError):
        window(w, ((),), (1, 0, (("count", False),), (("range", "pre", 1, "cur", 0, False),)))


# --- the entry point and the device-input cache ---------------------------------------


def test_run_window_replays_prepared_inputs_and_keys_on_the_batch(monkeypatch):
    dag, spec = tpch.window_rank_frames_spec()
    data = tpch.gen_lineitem(3000, 5)
    b1 = batch_from_numpy(tpch.LINEITEM, data)
    preps = []
    orig = wd._pack_words
    monkeypatch.setattr(wd, "_pack_words", lambda *a: preps.append(1) or orig(*a))
    first = run_window(dag, spec, b1, device="cpu").to_pylist()
    n_first = len(preps)
    assert n_first == 2  # partition words, order words
    again = run_window(dag, spec, b1, device="cpu").to_pylist()
    assert len(preps) == n_first and again == first  # the warm path: no prep
    data2 = dict(data, l_quantity=data["l_quantity"][::-1].copy())
    b2 = batch_from_numpy(tpch.LINEITEM, data2)
    other = run_window(dag, spec, b2, device="cpu").to_pylist()
    assert len(preps) == 2 * n_first  # another batch: another key
    assert other == run_window(dag, spec, b2, device="cpu", mode="host").to_pylist()
    assert other != first


def test_window_exec_engines():
    dag, spec = tpch.window_sum_partition_spec()
    b = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(2000, 1))
    chunk = b.to_chunk(dag.scan.col_offsets)
    w = WindowExec(chunk, *spec, engine="auto", device="cpu")
    host = w.next()
    assert w.last_engine == "host"  # 2000 rows < MIN_DEVICE_ROWS
    w = WindowExec(chunk, *spec, engine="auto", device="cpu", vars={"tidb_window_device_min_rows": 1000})
    assert w.next().to_pylist() == host.to_pylist() and w.last_engine == "tpu"
    with pytest.raises(ValueError):
        WindowExec(chunk, *spec, engine="gpu", device="cpu")
