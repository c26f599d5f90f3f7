"""K10's task-grid modes and the grouped paths' workloads, on the CPU.

* chip_smoke.grouped_cases — the battery chip_smoke.py holds the kernels
  to on the card — run here, where each wrapper takes its plain version:
  each task mode equals the SOLO plain version run task by task on the
  task's narrowed inputs, for every codec, G and width case; so do
  chip_smoke.sort_edge_cases (K6's, K7's and K8's modes at their designs'
  edges); K7's mode equals the reference's _lower_topn_multi program task
  by task and a numpy lexsort;
* models/tpch.point_agg_dag equals the DAG the reference Session pushes
  for tools/bench_sched.py's point aggregation;
* Q1 over lineitem cut into regions (models/tpch.region_batches), run
  through entry.run_many and merged at the root, equals Q1 over the whole
  batch; so do the sort-based paths of chip_smoke's main.regions_sorted
  (tpch_topn, multikey_topn, Q18's subquery: K10's K6 / K7 / K9 modes);
* models/tpch.point_topn_dag / point_topn_multi_dag equal the DAGs the
  reference Session pushes, and the burst's TopN mixes through run_many
  equal their serial executes and the host engine.
"""

import os
import sys

import numpy as np
import pytest

from tidb_tpu.session import Session

from tidb_tpu_torch.copr import gpu_engine
from tidb_tpu_torch.copr.gpu_engine import TorchEngine
from tidb_tpu_torch.copr.host_engine import execute_dag_host
from tidb_tpu_torch.entry import batch_from_numpy, run_many, run_query
from tidb_tpu_torch.executor.final_agg import merge_partials, order_by_keys, top_n
from tidb_tpu_torch.models import tpch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("G", chip_smoke.GROUP_SIZES)
@pytest.mark.parametrize("kind", chip_smoke.GROUP_KINDS)
def test_task_modes_equal_the_solo_plain_versions(kind, G):
    cases = chip_smoke.grouped_cases("cpu", np.random.default_rng(7 + G), r=256, sizes=(G,), kinds=(kind,))
    assert cases
    failed = []
    for name, fn in cases:
        try:
            fn()
        except AssertionError as e:
            failed.append(f"{name}: {e}")
    assert not failed, "\n".join(failed)


def _ref_topn_multi(m, spec, k):
    """The reference's _lower_topn_multi program body (tpu_engine.py:1812-1830)
    on one task's lanes: its operands, lex_sort_perm, the first min(k, rows)
    row ids and their mask bits."""
    from tidb_tpu.copr.tpu_engine import lex_sort_perm
    from tidb_tpu.jaxenv import jnp

    ops = [(~jnp.asarray(m)).astype(jnp.int32)]
    for d, v, desc in spec:
        d, v = jnp.asarray(d), jnp.asarray(v)
        dd = jnp.where(v, d, jnp.zeros((), d.dtype))
        if desc:
            dd = -dd if jnp.issubdtype(d.dtype, jnp.floating) else ~dd
        ops += [(jnp.where(v, 0, 1) if desc else jnp.where(v, 1, 0)).astype(jnp.int32), dd]
    perm = lex_sort_perm(ops)
    rows = min(k, len(m))
    return np.asarray(perm[:rows]), np.asarray(ops[0][perm][:rows] == 0)


@pytest.mark.parametrize("k", [1, 50, 1005])
def test_topn_multi_tasks_match_the_reference_program_per_task(k):
    """K7's task mode (its plain version here) on three tasks narrowed to a
    width of 1,000 rows — int32 codes ASC, floats with ±0.0, NaN, ±inf and
    subnormals DESC, uint64 with the top bit set, NULLs in every key, one
    task all masked, k past the width — returns each task's reference rows
    and mask bits bit for bit, and a numpy lexsort's rows."""
    import torch

    from tidb_tpu_torch.expr.xp_torch import U64
    from tidb_tpu_torch.kernels.grouped import topn_multi_tasks

    rng = np.random.default_rng(k)
    n, w = 1200, 1000
    specials = np.array([-np.inf, -1.5, -0.0, 0.0, 1.5, np.inf, np.nan, 5e-324])
    tasks = []
    for g in range(3):
        m = np.zeros(n, bool) if g == 2 else rng.random(n) < 0.7
        u = (rng.integers(0, 4, n).astype(np.uint64) << np.uint64(62)) | rng.integers(0, 3, n).astype(np.uint64)
        spec = [(rng.integers(-3, 3, n).astype(np.int32), rng.random(n) < 0.8, False),
                (rng.choice(specials, n), rng.random(n) < 0.8, True), (u, rng.random(n) < 0.9, False)]
        tasks.append((m, spec))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    idx, ok = topn_multi_tasks([t(m) for m, _ in tasks],
                               [[(U64(t(d.view(np.int64))) if d.dtype == np.uint64 else t(d), t(v), desc)
                                 for d, v, desc in spec] for _, spec in tasks], k, w)
    assert tuple(idx.shape) == (3, min(k, w))
    for g, (m, spec) in enumerate(tasks):
        cut = [(d[:w], v[:w], desc) for d, v, desc in spec]
        want_idx, want_ok = _ref_topn_multi(m[:w], cut, k)
        assert idx[g].numpy().tolist() == want_idx.tolist() and ok[g].numpy().tolist() == want_ok.tolist()
        cols = [(~m[:w]).astype(np.int64)]
        for d, v, desc in cut:
            x = np.where(v, d, np.zeros((), d.dtype))
            x = (-x if d.dtype.kind == "f" else ~x) if desc else x
            if d.dtype.kind == "f":
                x = np.where(np.abs(x) < np.finfo(np.float64).tiny, 0.0, x)
                cols += [np.where(v, 0, 1) if desc else np.where(v, 1, 0), np.isnan(x).astype(np.int64),
                         np.where(np.isnan(x), 0.0, x)]
            else:
                cols += [np.where(v, 0, 1) if desc else np.where(v, 1, 0), x]
        assert idx[g].numpy().tolist() == np.lexsort(list(reversed(cols)))[:min(k, w)].tolist()


@pytest.mark.parametrize("G", chip_smoke.EDGE_GROUP_SIZES)
def test_sort_edges_equal_the_solo_plain_versions(G):
    """chip_smoke.sort_edge_cases — K6's, K7's and K8's task modes at the
    edges of their designs (4- and 8-byte words, widths around a tile, k at
    the ordering cap and past it, every row tied) — hold here too."""
    cases = chip_smoke.sort_edge_cases("cpu", np.random.default_rng(11 + G), G)
    assert {name.split()[0] for name, _ in cases} == {"topk_tasks", "topn_multi_tasks", "lex_sort_tasks"}
    failed = []
    for name, fn in cases:
        try:
            fn()
        except AssertionError as e:
            failed.append(f"{name}: {e}")
    assert not failed, "\n".join(failed)


def _pt_session():
    s = Session()
    s.execute("CREATE TABLE pt (id INT PRIMARY KEY, v INT, w INT)")
    s.execute("INSERT INTO pt VALUES " + ",".join(f"({i}, {i % 997}, {(i * 7) % 131})" for i in range(3 * 1024)))
    s.vars["tidb_enable_cop_result_cache"] = "OFF"
    s.vars["tidb_cop_engine"] = "tpu"
    return s


@pytest.mark.parametrize("sql,builder", [(tpch.POINT_TOPN, "point_topn_dag"),
                                         (tpch.POINT_TOPN_MULTI, "point_topn_multi_dag")], ids=["topn", "topn_multi"])
def test_point_topn_dags_are_the_references(sql, builder):
    s = _pt_session()
    ctl = s.store.sched
    seen = []
    real = ctl.batcher.execute

    def capture(engine, dag, batch, **kw):
        seen.append((dag, batch))
        return real(engine, dag, batch, **kw)

    ctl.batcher.execute = capture
    try:
        rows = s.must_query(sql.format(lo=1024, hi=2048))
    finally:
        ctl.batcher.execute = real
    assert len(seen) == 1
    ref, batch = seen[0]
    port = getattr(tpch, builder)()
    assert ref.selection is None and port.selection is None and ref.agg is None and port.agg is None
    assert ref.scan.col_offsets == port.scan.col_offsets
    assert [repr(ft) for ft in ref.scan.col_fts] == [repr(ft) for ft in port.scan.col_fts]
    assert repr(ref.topn.by) == repr(port.topn.by) and ref.topn.n == port.topn.n == 10
    (b,) = [x for x in tpch.point_agg_table(3, 1024) if int(x.handles[0]) == 1024]
    got = top_n(TorchEngine(device="cpu").execute(port, b), port.topn.by, port.topn.n)
    assert [tuple(str(x) for x in r) for r in got.to_pylist()] == [tuple(r) for r in rows]


@pytest.mark.parametrize("builder", ["point_topn_dag", "point_topn_multi_dag"])
@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
def test_point_topn_burst_equals_serial_execute_and_host(builder, compress):
    """main.burst's TopN mixes at 16 tasks: one group, one fetch, each
    task's chunk its serial execute's and the host engine's."""
    dag = getattr(tpch, builder)()
    pairs = [(dag, b) for b in tpch.point_agg_table(16, 1024)]
    eng = TorchEngine(device="cpu")
    eng.tile_compression = compress
    with chip_smoke.TaskSpy() as spy:
        got = run_many(pairs, "cpu", eng)
    serial = [TorchEngine(device="cpu").execute(d, b) for d, b in pairs]
    for g, so, (d, b) in zip(got, serial, pairs):
        assert chip_smoke.chunks_equal(g, so) is None
        assert chip_smoke.chunks_equal(g, execute_dag_host(d, b)) is None
    # compression OFF pads each task to a 64Ki tile, narrowed to its 1,024 rows
    assert eng.fetches == 1 and [(k[1], k[2]) for k in eng._vprograms] == [(16, None if compress else 1024)]
    mode = "topk_tasks" if len(dag.topn.by) == 1 else "topn_multi_tasks"
    assert len(spy.calls[mode]) == 1


@pytest.mark.parametrize("query", [q for q, _, _ in chip_smoke.REGION_QUERIES])
@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
def test_sorted_paths_over_regions_equal_the_one_batch_answers(query, compress, monkeypatch):
    """main.regions_sorted at 60,000 rows cut at 16,384: four regions, one
    launch group (the short last region pads to the same bucket); direct
    addressing capped at 1,024 keys so that Q18's subquery sorts, and
    gcap0 at 256 so that it escalates inside its group. The merged answer
    equals the query over the whole batch, with one fetch a run."""
    _, builder, mode = next(x for x in chip_smoke.REGION_QUERIES if x[0] == query)
    monkeypatch.setattr(gpu_engine, "DIRECT_GROUP_MAX", 1024)
    li = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(60_000, 42))
    regions = tpch.region_batches(li, 16384)
    dag = getattr(tpch, builder)()
    eng = TorchEngine(device="cpu")
    eng.tile_compression = compress
    eng.gcap0 = 256
    want = chip_smoke.oracle(dag, li)
    assert chip_smoke.chunks_equal(run_query(dag, li, device="cpu"), want) is None
    for rep in range(2):
        with chip_smoke.TaskSpy() as spy:
            merged = chip_smoke.merged_regions(dag, run_many([(dag, r) for r in regions], "cpu", eng))
        assert chip_smoke.chunks_equal(merged, want) is None
        assert eng.fetches == rep + 1 and eng.fallbacks == 0
        assert len(spy.calls[mode]) == 1
    assert chip_smoke.launch_classes(eng, [(dag, r) for r in regions]) == (1, 0)
    if query == "q18_inner":
        assert sorted(eng._gcap.values()) == [4096]
        assert len(chip_smoke.task_args(spy.calls, "seg_agg_tasks", keywords=True)) == 1


def test_point_agg_dag_is_the_references():
    s = Session()
    s.execute("CREATE TABLE pt (id INT PRIMARY KEY, v INT, w INT)")
    s.execute("INSERT INTO pt VALUES " + ",".join(f"({i}, {i % 997}, {(i * 7) % 131})" for i in range(3 * 1024)))
    s.vars["tidb_enable_cop_result_cache"] = "OFF"
    s.vars["tidb_cop_engine"] = "tpu"
    ctl = s.store.sched
    seen = []
    real = ctl.batcher.execute

    def capture(engine, dag, batch, **kw):
        seen.append((dag, batch))
        return real(engine, dag, batch, **kw)

    ctl.batcher.execute = capture
    try:
        rows = s.must_query(tpch.POINT_AGG.format(lo=1024, hi=2048))
    finally:
        ctl.batcher.execute = real
    assert len(seen) == 1
    ref, batch = seen[0]
    assert batch.n_rows == 1024 and int(batch.handles[0]) == 1024
    port = tpch.point_agg_dag()
    assert ref.selection is None and port.selection is None
    assert ref.topn is None and port.topn is None and ref.limit is None and port.limit is None
    assert ref.scan.col_offsets == port.scan.col_offsets
    assert [repr(ft) for ft in ref.scan.col_fts] == [repr(ft) for ft in port.scan.col_fts]
    assert repr(ref.agg) == repr(port.agg)
    # and the port answers the same over the same rows
    (b,) = [x for x in tpch.point_agg_table(3, 1024) if int(x.handles[0]) == 1024]
    got = TorchEngine(device="cpu").execute(port, b)
    fts = [a.ret_type for a in port.agg.aggs]
    final = merge_partials([got], [], port.agg.aggs, fts)
    assert [tuple(str(x) for x in r) for r in final.to_pylist()] == [tuple(r) for r in rows]


def test_region_split_points_are_the_references():
    li = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(5000, 3))
    assert [r.n_rows for r in tpch.region_batches(li, 1024)] == [1024, 1024, 1024, 1024, 904]
    assert [r.n_rows for r in tpch.region_batches(li, 4096)] == [5000]  # below 2 * split: no cut
    n, split = 16_000_000, 1 << 21
    cuts = list(range(split, n - split // 2, split))
    sizes = np.diff([0] + cuts + [n]).tolist()
    assert sizes == [split] * 7 + [1_319_936]


@pytest.mark.parametrize("compress", [True, False], ids=["compress_on", "compress_off"])
def test_q1_over_regions_equals_q1_over_the_batch(compress):
    """Q1 over 340,000 rows cut at 2 x 65,536 rows: three 2-tile regions,
    the last one short, form one launch group (gcap 4)."""
    li = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(340_000, 9))
    regions = tpch.region_batches(li, 2 << 16)
    assert [r.n_rows for r in regions] == [131_072, 131_072, 77_856]
    eng = TorchEngine(device="cpu")
    eng.tile_compression = compress
    dag = tpch.q1_dag()
    parts = run_many([(dag, r) for r in regions], "cpu", eng)
    fts = [g.ret_type for g in dag.agg.group_by] + [a.ret_type for a in dag.agg.aggs]
    got = order_by_keys(merge_partials(parts, dag.agg.group_by, dag.agg.aggs, fts), dag.agg.group_by)
    want = run_query(dag, li, device="cpu")
    assert got.to_pylist() == want.to_pylist()
    assert eng.fetches == 1 and eng.fallbacks == 0
    assert [(k[1], k[2]) for k in eng._vprograms] == [(4, None)]


def _captured_group_calls():
    """The task-mode wrappers' arguments as the engine passes them on two
    workloads: the point aggregation (4 tasks) and Q1 over 3 regions."""
    eng = TorchEngine(device="cpu")
    li = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(5000, 3))
    with chip_smoke.TaskSpy() as spy:
        run_many([(tpch.point_agg_dag(), b) for b in tpch.point_agg_table(4, 1024)], "cpu", eng)
        run_many([(tpch.q1_dag(), r) for r in tpch.region_batches(li, 1536)], "cpu", eng)
    return {name: chip_smoke.task_args(spy.calls, name) for name in spy.calls}


def test_task_tables_hold_each_tasks_lanes():
    """The task tables the CUDA modes upload, built here over CPU tensors
    from the engine's own group inputs, hold each task's addresses and
    scalars where csrc/{decode_lane,expr_eval,seg_agg}.cu read them —
    checked entry by entry against the struct layouts (K1's: one entry of
    words a task and coded lane, every lane of the call together)."""
    import torch

    from tidb_tpu_torch.kernels import grouped as gk
    from tidb_tpu_torch.kernels.decode_lane import DICT, PACK, RLE, WORDS, codec, run_ends
    from tidb_tpu_torch.kernels.seg_agg import OPS, _fill_bits, seg_desc

    calls = _captured_group_calls()
    seen = set()
    for lanes, rvs, w in calls["decode_lanes_tasks"]:
        outs, words, ne = gk.decode_lanes_tasks_prepare(lanes, rvs, w, torch.device("cpu"))
        at = 0
        for encs, out in zip(lanes, outs):
            kind = codec(encs[0])
            if kind in ("dense", "alias"):
                assert [o.data_ptr() for o in out] == [(e if kind == "dense" else rv).data_ptr()
                                                       for e, rv in zip(encs, rvs)]
                continue
            seen.add(kind)
            for g, e in enumerate(encs):
                got = [int(x) for x in words[at * WORDS:(at + 1) * WORDS]]
                codes = e.get("p", e.get("c", e.get("rv")))
                aux = {"pack": 0, "dict": e["v"].data_ptr() if "v" in e else 0,
                       "rle": run_ends(e).data_ptr() if "rv" in e else 0}[kind]
                naux = {"pack": 0, "dict": e["v"].shape[0] if "v" in e else 0, "rle": codes.shape[0]}[kind]
                code_bytes = 1 if kind == "rle" else codes.element_size()
                want = [{"pack": PACK, "dict": DICT, "rle": RLE}[kind] | code_bytes << 8
                        | out[g].element_size() << 16, codes.data_ptr(), aux, naux,
                        int(e["b"]) if kind == "pack" else 0, out[g].data_ptr(), w]
                assert got == want
                at += 1
        assert at == ne
    assert "pack" in seen
    assert calls["expr_eval_tasks"]
    for prog, ins, w in calls["expr_eval_tasks"]:
        outs = [torch.empty((len(ins), w), dtype=torch.int64 if b == 8 else torch.bool) for b in prog.outputs]
        tin, tout = gk.expr_tables(prog, ins, outs, w)
        for g, task in enumerate(ins):
            assert [int(x) for x in tin[g, :len(task)]] == [t.data_ptr() for t in task]
            assert [int(x) for x in tout[g, :len(outs)]] == [o[g].data_ptr() for o in outs]
    assert len(calls["seg_agg_tasks"]) == 2
    for masks, keys, lanes, nseg, w in calls["seg_agg_tasks"]:
        G, nk, nl = len(masks), len(keys[0]), len(lanes[0])
        n_i = sum(1 for lane in lanes[0] if not lane.is_float)
        iout, fout = torch.empty((G, n_i, nseg), dtype=torch.int64), torch.empty((G, nl - n_i, nseg))
        base = 1 << 40
        host = seg_desc(masks, keys, lanes, w, base, iout, fout)
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        for g in range(G):
            kaddr, laddr = G * 6 + g * 5 * nk, G * (6 + 5 * nk) + g * 4 * nl
            assert list(host[g * 6:g * 6 + 6]) == [masks[g].data_ptr(), 0, base + 8 * kaddr, base + 8 * laddr,
                                                   iout[g].data_ptr(), fout[g].data_ptr()]
            for j, k in enumerate(keys[g]):
                assert list(host[kaddr + 5 * j:kaddr + 5 * j + 5]) == [
                    k.data.data_ptr(), ptr(k.valid), k.lo, k.dom, k.data.element_size()]
            rows = {False: 0, True: 0}
            for j, lane in enumerate(lanes[g]):
                assert list(host[laddr + 4 * j:laddr + 4 * j + 4]) == [
                    ptr(lane.data), ptr(lane.valid), _fill_bits(lane), OPS[lane.op] | (rows[lane.is_float] << 32)]
                rows[lane.is_float] += 1


def test_task_tables_refuse_tasks_that_differ():
    """A task whose lane differs from task 0's in dtype, presence or
    length is refused before any address reaches a table."""
    import torch

    from tidb_tpu_torch.kernels import grouped as gk
    from tidb_tpu_torch.kernels.seg_agg import seg_desc

    masks, keys, lanes, nseg, w = _captured_group_calls()["seg_agg_tasks"][0]
    G = len(masks)
    iout, fout = torch.empty((G, 8, nseg), dtype=torch.int64), torch.empty((G, 8, nseg))
    bad = [list(ls) for ls in lanes]
    j = next(j for j, lane in enumerate(bad[1]) if lane.data is not None)
    lane = bad[1][j]
    bad[1][j] = type(lane)(lane.op, lane.data.to(torch.int32), lane.valid, lane.fill)
    with pytest.raises(TypeError, match="task 1"):
        seg_desc(masks, keys, bad, w, 0, iout, fout)
    bad[1][j] = type(lane)(lane.op, lane.data, None if lane.valid is not None else lane.data != 0, lane.fill)
    with pytest.raises(ValueError, match="present in some tasks"):
        seg_desc(masks, keys, bad, w, 0, iout, fout)
    short = [m.reshape(-1)[: w // 2] for m in masks]
    with pytest.raises(ValueError, match="at least"):
        seg_desc(short, keys, lanes, w, 0, iout, fout)
    bad[1] = bad[1][:-1]
    with pytest.raises(ValueError, match="differ from task 0"):
        seg_desc(masks, keys, bad, w, 0, iout, fout)


def test_sort_task_tables_hold_each_tasks_lanes(monkeypatch):
    """The task tables of K6's, K7's and K9's modes and K4's segment-lane
    form, built here over CPU tensors from the engine's own group inputs
    (the point TopNs, Q18's subquery over regions), hold each task's
    addresses where csrc/{topk,topn_multi,sort_groups,seg_agg}.cu read
    them."""
    import torch

    from tidb_tpu_torch.kernels import grouped as gk
    from tidb_tpu_torch.kernels.seg_agg import seg_desc
    from tidb_tpu_torch.kernels.tables import lane_table
    from tidb_tpu_torch.kernels.topk import topk_table

    monkeypatch.setattr(gpu_engine, "DIRECT_GROUP_MAX", 1024)
    eng = TorchEngine(device="cpu")
    li = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(30_000, 5))
    with chip_smoke.TaskSpy() as spy:
        for dag in (tpch.point_topn_dag(), tpch.point_topn_multi_dag()):
            run_many([(dag, b) for b in tpch.point_agg_table(4, 1024)], "cpu", eng)
        run_many([(tpch.q18_inner_dag(), r) for r in tpch.region_batches(li, 8192)], "cpu", eng)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    ((datas, valids, masks, desc, k, w),) = chip_smoke.task_args(spy.calls, "topk_tasks")
    tab = topk_table(datas, valids, masks, w, -1)
    assert [list(r) for r in tab] == [[ptr(d), ptr(v), ptr(m)] for d, v, m in zip(datas, valids, masks)]
    for name in ("topn_multi_tasks", "sort_groups_tasks"):
        ((masks, keys, *_, w),) = chip_smoke.task_args(spy.calls, name)
        tab = lane_table(masks, [[(gk.sort_op(x[0]), x[1]) for x in ks] for ks in keys], w, -1, name)
        for g, (m, ks) in enumerate(zip(masks, keys)):
            want = [m.data_ptr()] + [p for x in ks for p in (gk.sort_op(x[0]).data.data_ptr(), ptr(x[1]))]
            assert list(tab[g]) == want
    (((masks, keys, lanes, nseg, w), kw),) = chip_smoke.task_args(spy.calls, "seg_agg_tasks", keywords=True)
    n_i = sum(1 for lane in lanes[0] if not lane.is_float)
    iout, fout = torch.empty((n_i, nseg), dtype=torch.int64), torch.empty((len(lanes[0]) - n_i, nseg))
    host = seg_desc(masks, keys, lanes, w, 1 << 40, iout, fout, kw["segs"])
    G = len(masks)
    assert sum(kw["counts"]) == nseg and G > 1
    for g in range(G):  # one shared output pair, each task's own segment lane
        assert list(host[g * 6:g * 6 + 2]) == [masks[g].data_ptr(), kw["segs"][g].data_ptr()]
        assert list(host[g * 6 + 4:g * 6 + 6]) == [iout.data_ptr(), fout.data_ptr()]
