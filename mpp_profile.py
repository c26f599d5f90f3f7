#!/usr/bin/env python3
"""Time P2 (csrc/exchange.cu), P4 (csrc/sort_join.cu), P5
(csrc/seg_reduce.cu), P6 (csrc/rowpos_agg.cu), P7 (csrc/run_agg.cu), P8
(kernels/dense_agg.py over csrc/seg_agg.cu), M1 (csrc/q1_local.cu), M3
(csrc/hash_repartition.cu) and K1 (csrc/decode_lane.cu) on the main
path's own inputs, on one NVIDIA GPU.

    python3 mpp_profile.py [--seed 42] [--q3-rows 4000000] [--reps 5] [--tree DIR ...]
                           [--only p2|p6|p7|p8|m1|m3|k1]

For each --tree (another checkout of the repository: an earlier commit,
say) and this checkout, each in a fresh process, in turns (the trees, then
the same in reverse order), one JSON object a run under "runs":

  q3_unfused / q18   run_mpp over chip_smoke.py's tables (--q3-rows
                     lineitem rows): the median wall ms of --reps warm runs
                     and that run's phase spans (ms)
  mesh_q3_unfused    the same over make_mesh(4, "cuda") (four ranks sharing
                     the card, gloo), one warm run
  p5                 P5's call on unfused Q3 (the rows of the packed
                     result as the engine passes them): ms, and the K8
                     calls inside it (their rows and ms; own_ms is the call
                     less them)
  p5_mesh            P5's largest rank call of mesh q3_unfused (local
                     reduce, the recorded exchange, final reduce), likewise
  p4_q18, p4_q3_1, p4_q3_2
                     P4's call on Q18's duplicate-key level and on
                     q3_unfused's two unique-key levels (lineitem → orders,
                     then → customer), likewise
  q3_top100 / mesh_q3_top100
                     run_mpp of Q3 LIMIT 100 (the rowpos aggregation), one
                     device and over the 4-rank mesh: walls and spans
  p6, p6_mesh        P6's call on q3_top100 (the rows of the packed result
                     as the engine passes them) and its largest rank call
                     of the mesh run (the recorded collectives' outputs in
                     place of the collectives): ms (CUDA events over 10
                     calls), host_ms (the host clock's median call through a
                     synchronize), enqueue_ms (the host clock's mean call,
                     nothing synchronized), the device ms of each kernel of
                     one profiled call and their sum, and K4's, K6's and
                     P6's own kernels' parts of it

  seg_revenue / mesh_seg_revenue, p8, p8_mesh
                     (--only p8) the same for SEG_REVENUE (the dense
                     aggregation) and P8's call, one device and its largest
                     rank call of the mesh run (its partials, which the
                     all-reduce takes after it), with the launches of the
                     profiled call
  m1                 (--only m1) M1 on Q1's lanes of a lineitem of
                     M1_ROWS rows (chip_smoke.py's generator at its
                     default size, and the dryrun's q1_arrays, one shard): the median single launch
                     (`median_ms`), the mean of 10 (`ms`), the host clock's
                     call through a synchronize, one profiled call's device
                     time and launches, rows/s, and its bytes bound

  q3_mpp / mesh_q3_mpp, p7, p7_mesh
                     (--only p7) Q3 fused (the clustered aggregation) and
                     P7's call, one device and its largest rank call of
                     the mesh run (every rank call held to the plain
                     version): events over 10 calls, the median single
                     call, host and enqueue times, one profiled call's
                     device time, and every launch of the call (torch's
                     and memsets included)
  m3, m3_n2, m3_n1024
                     (--only m3) M3 on the dryrun's lanes (keys
                     l_quantity, payload l_extendedprice) of an M1_ROWS
                     lineitem, cap the rows: n_dev 1, 2 and, over 1M rows,
                     1,024; the same times and launches, rows/s, its bytes
                     bound and torch.argsort(stable=True) of the owner lane

  mesh_q3_unfused, p2, p2_calls, m3, m3_n2, m3_n1024
                     (--only p2) the unfused Q3 over the 4-rank mesh
                     (walls and rank 0's spans, `exchange` among them) and
                     P2's calls of one more run, every rank's call held to
                     the plain version: the largest call's events over 10
                     calls, median single call, host and enqueue times,
                     one profiled call's device time and every launch of
                     the call, its bytes bound and the stable argsort plus
                     one gather a lane beside it (chip_smoke's
                     exchange_timing); the device time of every call
                     (`p2_calls`); and M3 as --only m3 measures it (the
                     ranking and look-back P2 shares with it)
  q1, k1_q1, q1_regions, k1_regions, burst, k1_burst
                     (--only k1) K1 as the engine calls it: Q1 over an
                     M1_ROWS-row lineitem (warm walls and spans, `decode`
                     among them) and its _decode call (every coded lane of
                     the run), Q1 over the same rows in their regions
                     through run_many and its _decode_tasks call (the
                     group's lanes), and bench_sched's 64 x 4,096-row point
                     aggregation through run_many and its _decode_tasks
                     call; each call held to the plain version lane by
                     lane, then timed as P7's (`_timed`), with its bytes
                     bound

--only p2 / p6 / p7 / p8 / m1 / m3 / k1 measures those alone.

Each tree runs its own chip_smoke.py helpers and its own kernels, built in
its own build/. Every call is held to its plain version before it is
timed. Without a card, or without the repository beside it, it exits
non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
M1_ROWS = 16_000_000  # --only m1's lineitem rows: chip_smoke.py's default (its --rows)


def _k8_entry(module):
    """(module, name) through which `module` calls K8: lex_sort_perm where
    the wrapper calls it by that name, else kernels/compact's launch."""
    if hasattr(module, "lex_sort_perm"):
        return module, "lex_sort_perm"
    return importlib.import_module("tidb_tpu_torch.kernels.compact"), "launch"


def _host_ms(fn, reps: int = 10) -> float:
    """Median host-clock ms of fn() through a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[reps // 2]


def _with_k8(cs, module, fn) -> dict:
    """ms of fn() (CUDA events over 10 calls), of the K8 calls inside it
    (their row counts), the host clock's median call, and the device time
    by kernel of one profiled call (`split_ms`, `device_ms` their sum)."""
    where, name = _k8_entry(module)
    seen, k8_ms = cs.calls_inside(where, name, fn)
    rows = [a[1] if name == "launch" else a[0][0].data.numel() if hasattr(a[0][0], "data") else a[0][0].numel()
            for a, _ in seen]
    ms = cs.time_ms(fn)
    split = cs.kernel_split(fn)
    dev_ms = sum(split["split_ms"].values()) if split.get("split_ms") else None
    return {"ms": ms, "k8_ms": k8_ms, "k8_rows": rows, "own_ms": ms - k8_ms, "host_ms": _host_ms(fn),
            "device_ms": dev_ms, **split}


def _call(cs, fn) -> dict:
    """A P6 or P8 call (module doc): event, host and enqueue times, and one
    profiled call's device time by kernel (K4's, K6's and P6's own parts)."""
    import torch

    ms = cs.time_ms(fn)
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        fn()
    enqueue = (time.perf_counter() - t) / 10 * 1e3
    torch.cuda.synchronize()
    split = cs.kernel_split(fn)
    sm = split.get("split_ms") or {}
    part = lambda names: sum(v for n, v in sm.items() if n.startswith(names))  # noqa: E731
    return {"ms": ms, "host_ms": _host_ms(fn), "enqueue_ms": enqueue, "device_ms": sum(sm.values()) if sm else None,
            "k4_device_ms": part(("seg_agg_kernel", "init_kernel")), "k6_device_ms": part("topk_"),
            "p6_device_ms": part(("seg_kernel", "score_kernel", "emit_kernel")), **split}


def host_p6(cs, tables, dev, query, out: dict) -> None:
    """q3_top100 and its P6 calls, one device and the 4-rank mesh."""
    import torch

    from tidb_tpu_torch.entry import run_mpp
    from tidb_tpu_torch.kernels import rowpos_agg, rowpos_agg_ref
    from tidb_tpu_torch.parallel import mpp_program as mp
    from tidb_tpu_torch.parallel.mesh import make_mesh

    plan, engine, variables, out["q3_top100"] = query("q3_top100")
    got, real = [], mp.rowpos_agg
    mp.rowpos_agg = lambda *a, **kw: got.append((a, kw)) or real(*a, **kw)
    try:
        run_mpp(plan, tables, device=dev, engine=engine, variables=variables)
    finally:
        mp.rowpos_agg = real
    a, kw = got[0]
    rows = [torch.zeros_like(kw["rows"]) for _ in range(2)]
    g, w = rowpos_agg(*a, rows=rows[0]), rowpos_agg_ref(*a, rows=rows[1])
    cs.same_rowpos(g, w, "rowpos_agg on q3_top100", a[3])
    cs.same_rows(rows[0], rows[1], 1, "rowpos_agg rows on q3_top100",
                 {2 + j for j, ln in enumerate(a[3][a[8]:]) if ln.is_float})
    out["p6"] = {"n": a[0].numel(), "B": a[2], "lanes": len(a[3]), **_call(cs, lambda: rowpos_agg(*a, rows=rows[0]))}
    mesh = make_mesh(4, dev)
    try:
        plan, engine, variables, out["mesh_q3_top100"] = query("q3_top100", mesh, warm=1)
        with cs.MeshModeSpy() as spy:
            run_mpp(plan, tables, device=dev, engine=engine, variables=variables, mesh=mesh)
    finally:
        mesh.close()
    cs.hold_mesh_modes({"seg_reduce": [], "rowpos_agg": spy.calls["rowpos_agg"]})
    a, kw, col = max(spy.calls["rowpos_agg"], key=lambda c: c[0][0].numel())
    rows_m = torch.zeros_like(kw["rows"])
    out["p6_mesh"] = {"n": a[0].numel(), "B": a[2], "n_dev": kw["n_dev"], "block": col[0][0].numel(),
                      **_call(cs, lambda: rowpos_agg(*a, rows=rows_m, n_dev=kw["n_dev"], collect=lambda *x: col))}


def host_p8(cs, tables, dev, query, out: dict) -> None:
    """SEG_REVENUE and its P8 calls, one device and the 4-rank mesh."""
    import threading

    import torch

    from tidb_tpu_torch.entry import run_mpp
    from tidb_tpu_torch.kernels import dense_agg, dense_agg_ref
    from tidb_tpu_torch.parallel import mpp_program as mp
    from tidb_tpu_torch.parallel.mesh import make_mesh

    def caught(run) -> list:
        got, lock, real = [], threading.Lock(), mp.dense_agg

        def spy(*a, **kw):
            with lock:
                got.append((a, kw))
            return real(*a, **kw)
        mp.dense_agg = spy
        try:
            run()
        finally:
            mp.dense_agg = real
        return got

    def held(a, kw, what):
        rows = torch.zeros_like(kw["rows"])
        cs.same_dense(dense_agg(*a, rows=rows), dense_agg_ref(*a), what, a[3])
        return rows

    plan, engine, variables, out["seg_revenue"] = query("seg_revenue")
    (a, kw), = caught(lambda: run_mpp(plan, tables, device=dev, engine=engine, variables=variables))
    rows = held(a, kw, "dense_agg on seg_revenue")
    out["p8"] = {"n": a[0].numel(), "nseg": a[2], "lanes": len(a[3]), **_call(cs, lambda: dense_agg(*a, rows=rows))}
    mesh = make_mesh(4, dev)
    try:
        plan, engine, variables, out["mesh_seg_revenue"] = query("seg_revenue", mesh, warm=1)
        calls = caught(lambda: run_mpp(plan, tables, device=dev, engine=engine, variables=variables, mesh=mesh))
    finally:
        mesh.close()
    for i, (a, kw) in enumerate(calls):
        held(a, kw, f"dense_agg, rank call {i}")
    a, kw = max(calls, key=lambda c: c[0][0].numel())
    rows_m = held(a, kw, "dense_agg, the largest rank call")
    out["p8_mesh"] = {"n": a[0].numel(), "nseg": a[2], "rank_calls": len(calls),
                      **_call(cs, lambda: dense_agg(*a, rows=rows_m))}


def host_m1(cs, seed: int, out: dict) -> None:
    """M1 on Q1's lanes of an M1_ROWS-row lineitem (module doc)."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels import q1_local, q1_local_ref
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.parallel.mesh import q1_arrays

    spec, args = q1_arrays(tpch.gen_lineitem(M1_ROWS, seed), 1)
    lanes = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda") for a in args]
    m1 = (spec.nseg, spec.cutoff, *lanes)
    cs._same(q1_local(*m1), q1_local_ref(*m1), "q1_local on the lineitem's Q1 lanes")
    nbytes = sum(t.numel() * t.element_size() for t in lanes) + 6 * 8 * spec.nseg
    fn = lambda: q1_local(*m1)  # noqa: E731
    split = cs.kernel_split(fn)
    med = cs.median_ms(fn)
    out["m1"] = {"rows": len(args[0]), "nseg": spec.nseg, "median_ms": med, "ms": cs.time_ms(fn),
                 "host_ms": _host_ms(fn), "rows_per_s": len(args[0]) / (med / 1e3), "bytes": nbytes,
                 "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                 "device_ms": sum(split["split_ms"].values()) if split.get("split_ms") else None, **split}


def _launches(fn) -> dict:
    """Every kernel one call of fn() launches on the card, torch's own and
    memsets included (kernel_split leaves those out): their count
    (`launches`), the memsets among them (`memsets`) and the count by name
    (`kernels`), from one torch.profiler session opened by a marker kernel
    (the session's first, left out). None when the profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    marker = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.name.startswith("Memcpy")),
                 key=lambda e: e.time_range.start)[1:]
    if not evs:
        return {"launches": None, "memsets": None, "kernels": None}
    names: dict = {}
    for e in evs:
        name = e.name.split("(")[0].split("<")[0].replace("void ", "")[:60]
        names[name] = names.get(name, 0) + 1
    return {"launches": len(evs), "memsets": sum(e.name.startswith("Memset") for e in evs), "kernels": names}


def _timed(cs, fn) -> dict:
    """A P7 or M3 call: events over 10 calls (`ms`), the median single call
    (`median_ms`), the host clock's call through a synchronize (`host_ms`)
    and its enqueue (`enqueue_ms`, nothing synchronized), one profiled
    call's device time (`device_ms`, the port's kernels) and every launch
    of the call (`_launches`)."""
    import torch

    ms, med = cs.time_ms(fn), cs.median_ms(fn)
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        fn()
    enqueue = (time.perf_counter() - t) / 10 * 1e3
    torch.cuda.synchronize()
    split = cs.kernel_split(fn)
    sm = split.get("split_ms")
    return {"ms": ms, "median_ms": med, "host_ms": _host_ms(fn), "enqueue_ms": enqueue,
            "device_ms": sum(sm.values()) if sm else None, "split_ms": sm, **_launches(fn)}


def host_p7(cs, tables, dev, query, out: dict) -> None:
    """Q3 (the clustered aggregation) and its P7 calls, one device and the
    4-rank mesh: every call held to the plain version, then timed."""
    import threading

    from tidb_tpu_torch.entry import run_mpp
    from tidb_tpu_torch.kernels import run_agg, run_agg_ref
    from tidb_tpu_torch.parallel import mpp_program as mp
    from tidb_tpu_torch.parallel.mesh import make_mesh

    def caught(run) -> list:
        got, lock, real = [], threading.Lock(), mp.run_agg

        def spy(*a, **kw):
            with lock:
                got.append((a, kw))
            return real(*a, **kw)
        mp.run_agg = spy
        try:
            run()
        finally:
            mp.run_agg = real
        return got

    def held(a, what):
        cs.same_run_agg(run_agg(*a), run_agg_ref(*a), a[0], what)

    plan, engine, variables, out["q3_mpp"] = query("q3_mpp")
    (a, _), = caught(lambda: run_mpp(plan, tables, device=dev, engine=engine, variables=variables))
    held(a, "run_agg on Q3")
    floats = sum(d is not None and d.is_floating_point() for d, _ in a[2])
    out["p7"] = {"L": a[0].numel(), "lanes": len(a[2]), "float_lanes": floats, **_timed(cs, lambda: run_agg(*a))}
    mesh = make_mesh(4, dev)
    try:
        plan, engine, variables, out["mesh_q3_mpp"] = query("q3_mpp", mesh, warm=1)
        calls = caught(lambda: run_mpp(plan, tables, device=dev, engine=engine, variables=variables, mesh=mesh))
    finally:
        mesh.close()
    for i, (a, _) in enumerate(calls):
        held(a, f"run_agg, rank call {i}")
    a, _ = max(calls, key=lambda c: c[0][0].numel())
    out["p7_mesh"] = {"L": a[0].numel(), "rank_calls": len(calls), **_timed(cs, lambda: run_agg(*a))}


M3_CASES = ((1, None), (2, None), (1024, 1_000_000))  # (n_dev, rows: None = M1_ROWS)


def host_m3(cs, seed: int, out: dict) -> None:
    """M3 on the dryrun's lanes of an M1_ROWS-row lineitem (q1_arrays, one
    shard: keys l_quantity, payload l_extendedprice, valid its row mask),
    cap the row count: n_dev 1 (the main path) and n_dev 2 (the mesh's
    two-rank dryrun); and n_dev 1,024 (the widest owner count) over the
    first 1M rows keyed by l_extendedprice (l_quantity holds 50 values),
    cap twice an even share. Each is held to the plain version bit for
    bit, then timed; rows/s and the bytes bound, and
    torch.argsort(stable=True) of the owner lane beside it."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels import hash_repartition, hash_repartition_ref
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.parallel.mesh import q1_arrays

    _, args = q1_arrays(tpch.gen_lineitem(M1_ROWS, seed), 1)
    qty, price, rv = (torch.from_numpy(np.ascontiguousarray(args[k])).to("cuda") for k in (0, 1, 7))
    for n_dev, rows in M3_CASES:
        keys, payload, valid = (t[:rows] for t in ((qty, price, rv) if n_dev < 1024 else (price, qty, rv)))
        n = keys.numel()
        cap = n if n_dev < 1024 else 2 * -(-n // n_dev)
        m3 = (keys, payload, valid, n_dev, cap)
        for j, (g, w) in enumerate(zip(hash_repartition(*m3), hash_repartition_ref(*m3))):
            cs._same(g, w, f"hash_repartition output {j} at n_dev {n_dev}")
        nbytes = 17 * n + 17 * n_dev * cap + 8
        owner = torch.where(valid, torch.remainder(keys, n_dev), n_dev)
        r = {"rows": n, "n_dev": n_dev, "cap": cap, "bytes": nbytes, "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
             "library_ms": cs.time_ms(lambda: torch.argsort(owner, stable=True)),
             **_timed(cs, lambda: hash_repartition(*m3))}
        r["rows_per_s"] = n / (r["median_ms"] / 1e3)
        out["m3" if n_dev == 1 else f"m3_n{n_dev}"] = r


def host_p2(cs, tables, dev, query, seed: int, out: dict) -> None:
    """The unfused Q3 over the 4-rank mesh and its P2 calls (module doc)."""
    from tidb_tpu_torch.entry import run_mpp
    from tidb_tpu_torch.kernels import exchange, exchange_ref
    from tidb_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(4, dev)
    try:
        plan, engine, variables, out["mesh_q3_unfused"] = query("q3_unfused", mesh, warm=3)
        with cs.MeshModeSpy() as spy:
            run_mpp(plan, tables, device=dev, engine=engine, variables=variables, mesh=mesh)
    finally:
        mesh.close()
    calls = spy.calls["exchange"]
    for i, a in enumerate(calls):
        (gs, gd), (ws, wd) = exchange(*a), exchange_ref(*a)
        cs._same(gs, ws, f"exchange send buffer, rank call {i}")
        cs._same(gd, wd, f"exchange dropped count, rank call {i}")
    a = max(calls, key=lambda c: c[2].numel() * len(c[6]))
    t = cs.exchange_timing(calls)
    out["p2"] = {**{k: t[k] for k in ("bytes", "bound_ms", "plain_ms", "library_ms", "rows", "n_dev", "bcap", "lanes",
                                      "keys", "probe", "calls_captured")},
                 "event_ms_chip_smoke": t["ms"], **_timed(cs, lambda: exchange(*a))}
    out["p2_calls"] = []
    for c in calls:
        split = cs.kernel_split(lambda c=c: exchange(*c)).get("split_ms")
        out["p2_calls"].append({"rows": c[2].numel(), "lanes": len(c[6]), "n_dev": c[0],
                                "device_ms": sum(split.values()) if split else None})
    host_m3(cs, seed, out)


def _held_lanes(cs, got: dict, want: dict, what: str) -> None:
    """Two lanes dicts of the engine's _decode ({i: (data, valid)}), lane by lane."""
    for i in want:
        for j in (0, 1):
            g, w = got[i][j], want[i][j]
            g, w = getattr(g, "bits", g), getattr(w, "bits", w)  # a uint64 lane is an xp_torch.U64
            cs._same(g, w, f"{what}: lane {i}.{j}", floats=w.is_floating_point())


def host_k1(cs, seed: int, reps: int, out: dict, dev="cuda") -> None:
    """K1 as the engine calls it: Q1, Q1 over regions, the burst (module doc)."""
    import torch

    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import batch_from_numpy, run_many, run_query
    from tidb_tpu_torch.kernels import decode_lane_ref
    from tidb_tpu_torch.kernels.grouped import narrow_enc
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.torchenv import PhaseTimer

    dev = torch.device(dev)
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(M1_ROWS, seed))
    dag = tpch.q1_dag()

    def caught(eng, name):  # → the engine's method and the (arguments, keywords) of its calls
        real, got = getattr(eng, name), []
        setattr(eng, name, lambda *a, **kw: got.append((a, kw)) or real(*a, **kw))
        return real, got

    eng = TorchEngine(dev)
    real, got = caught(eng, "_decode")
    walls = []
    for _ in range(reps + 1):
        eng.timer = PhaseTimer(eng.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_query(dag, batch, device=dev, engine=eng)
        torch.cuda.synchronize()
        walls.append(((time.perf_counter() - t) * 1e3, eng.timer.totals_ms()))
    warm = sorted(walls[1:], key=lambda r: r[0])
    out["q1"] = {"wall_ms": warm[len(warm) // 2][0], "walls_ms": [w for w, _ in warm],
                 "spans_ms": warm[len(warm) // 2][1]}
    a, _ = got[-1]
    mirror, lanes = a[0], a[1]
    want = {i: (decode_lane_ref(d, mirror.row_valid), decode_lane_ref(v, mirror.row_valid)) for i, (d, v) in
            lanes.items()}
    _held_lanes(cs, real(*a), {i: (getattr(w[0], "bits", w[0]), w[1]) for i, w in want.items()}, "Q1's _decode")
    encs = [e for d_v in lanes.values() for e in d_v if isinstance(e, dict) and e]
    nbytes = cs._decode_bytes(mirror, encs)
    out["k1_q1"] = {"coded_lanes": len(encs), "bytes": nbytes, "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                    **_timed(cs, lambda: real(*a))}

    def grouped(pairs, name):
        eng = TorchEngine(dev)
        real, got = caught(eng, "_decode_tasks")
        walls = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run_many(pairs, dev, eng)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        warm = sorted(walls[1:])
        out[name] = {"wall_ms": warm[len(warm) // 2], "walls_ms": warm, "tasks": len(pairs)}
        a, kw = max(got, key=lambda c: len(c[0][0]))
        argss, order, unsigned, width = a[:4]
        only = kw.get("only", a[4] if len(a) > 4 else None)
        res = real(*a, **kw)
        nbytes = 0
        for g, (flat, rv) in enumerate(argss):
            for k, i in enumerate(order):
                if only is not None and i not in only:
                    continue
                for h in (0, 1):
                    e = flat[2 * k + h]
                    w = decode_lane_ref(narrow_enc(e, width), rv.reshape(-1)[:width])
                    gv = res[g][i][h]
                    gv = getattr(gv, "bits", gv)
                    cs._same(gv.reshape(-1)[:width], w.reshape(-1), f"{name}: task {g} lane {i}.{h}",
                             floats=w.is_floating_point())
                    if isinstance(e, dict) and e:
                        nbytes += sum(x.reshape(-1)[:width].numel() * x.element_size() if k2 in ("p", "c")
                                      else x.numel() * x.element_size() for k2, x in e.items() if k2 not in ("b", "re"))
                        nbytes += width * w.element_size()
        return {"tasks": len(argss), "width": width, "bytes": nbytes, "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
                **_timed(cs, lambda: real(*a, **kw))}

    regions = tpch.region_batches(batch)
    out["k1_regions"] = grouped([(dag, r) for r in regions], "q1_regions")
    out["k1_burst"] = grouped([(tpch.point_agg_dag(), b) for b in tpch.point_agg_table(64, 4096)], "burst")


def host(rows: int, seed: int, reps: int, only: str = "") -> dict:
    """One tree's measurements (module doc), in this process."""
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch.entry import run_mpp
    from tidb_tpu_torch.kernels import seg_reduce, seg_reduce_ref, sort_join, sort_join_ref
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.parallel import mpp_program as mp
    from tidb_tpu_torch.parallel.mesh import make_mesh
    from tidb_tpu_torch.parallel.mpp import MPPEngine
    from tidb_tpu_torch.torchenv import PhaseTimer

    dev = torch.device("cuda")
    out: dict = {}
    if only == "m1":
        host_m1(cs, seed, out)
        return out
    if only == "m3":
        host_m3(cs, seed, out)
        return out
    if only == "k1":
        host_k1(cs, seed, reps, out)
        return out
    li, orders, cust = tpch.generated_columns(rows, seed)
    tables = {"lineitem": li, "orders": orders, "customer": cust}
    specs = {q: (b, v) for q, b, v, _, _ in cs.MPP_QUERIES}
    p4m, p5m = (importlib.import_module(f"tidb_tpu_torch.kernels.{m}") for m in ("sort_join", "seg_reduce"))
    caps: dict = {}

    def query(qname, mesh=None, warm=reps):
        (builder, *bargs), variables = specs[qname]
        plan = getattr(tpch, builder)(*bargs)
        engine = MPPEngine(dev)

        def timed():
            timer = PhaseTimer(engine.device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            run_mpp(plan, tables, device=dev, engine=engine, timer=timer, variables=variables, mesh=mesh)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3, timer.totals_ms()

        runs = sorted([timed() for _ in range(warm + 1)][1:], key=lambda r: r[0])
        med = runs[len(runs) // 2]
        return plan, engine, variables, {"wall_ms": med[0], "walls_ms": [r[0] for r in runs], "spans_ms": med[1]}

    if only == "p2":
        host_p2(cs, tables, dev, query, seed, out)
        return out
    if only == "p6":
        host_p6(cs, tables, dev, query, out)
        return out
    if only == "p8":
        host_p8(cs, tables, dev, query, out)
        return out
    if only == "p7":
        host_p7(cs, tables, dev, query, out)
        return out
    for qname in ("q3_unfused", "q18"):
        plan, engine, variables, out[qname] = query(qname)
        got = caps[qname] = {"sort_join": [], "seg_reduce": []}
        real = {k: getattr(mp, k) for k in got}

        def spy(name, real=real, got=got):
            def call(*a, **kw):
                got[name].append((a, kw))
                return real[name](*a, **kw)
            return call
        for k in got:
            setattr(mp, k, spy(k))
        try:
            run_mpp(plan, tables, device=dev, engine=engine, variables=variables)
        finally:
            for k, fn in real.items():
                setattr(mp, k, fn)

    def p4(a, what):
        cs.same_sort_join(sort_join(*a), sort_join_ref(*a), what)
        n, B = a[5].numel(), a[6].numel()
        return {"n": n, "B": B, "mult": a[8], **_with_k8(cs, p4m, lambda: sort_join(*a))}

    out["p4_q18"] = p4(caps["q18"]["sort_join"][0][0], "sort_join on Q18")
    for i, (a, _) in enumerate(caps["q3_unfused"]["sort_join"]):
        out[f"p4_q3_{i + 1}"] = p4(a, f"sort_join on q3_unfused level {i + 1}")
    a5, kw5 = caps["q3_unfused"]["seg_reduce"][0]
    rows5 = [torch.zeros_like(kw5["rows"]) for _ in range(2)]
    cs.same_seg_reduce(seg_reduce(*a5, rows=rows5[0]), seg_reduce_ref(*a5, rows=rows5[1]), "seg_reduce on Q3",
                       a5[2])
    cs.same_rows(rows5[0], rows5[1], 1, "seg_reduce rows on Q3", {2 + j for j, ln in enumerate(a5[2]) if ln.is_float})
    out["p5"] = {"n": a5[1].numel(), **_with_k8(cs, p5m, lambda: seg_reduce(*a5, rows=rows5[0]))}

    mesh = make_mesh(4, dev)
    try:
        plan, engine, variables, out["mesh_q3_unfused"] = query("q3_unfused", mesh, warm=1)
        with cs.MeshModeSpy() as spy:
            run_mpp(plan, tables, device=dev, engine=engine, variables=variables, mesh=mesh)
    finally:
        mesh.close()
    cs.hold_mesh_modes({"seg_reduce": spy.calls["seg_reduce"], "rowpos_agg": []})
    a, kw, got = max(spy.calls["seg_reduce"], key=lambda c: c[0][1].numel())
    rows_m = torch.zeros_like(kw["rows"])
    ex = lambda *x, got=got: got  # noqa: E731 — the rank's recorded exchange outputs
    out["p5_mesh"] = {"n": a[1].numel(), "fragments": got[2].numel(), "n_dev": kw["n_dev"],
                      **_with_k8(cs, p5m, lambda: seg_reduce(*a, rows=rows_m, exchange=ex, n_dev=kw["n_dev"]))}
    host_p6(cs, tables, dev, query, out)
    host_p8(cs, tables, dev, query, out)
    return out


def worker(tree: str, rows: int, seed: int, reps: int, only: str) -> dict:
    """One tree's measurements in a fresh process rooted at `tree`."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--host-of", tree, "--q3-rows", str(rows),
                        "--seed", str(seed), "--reps", str(reps), "--only", only],
                       capture_output=True, text=True, cwd=tree)
    if r.returncode != 0:
        raise RuntimeError(f"mpp_profile: the run in {tree} failed (exit {r.returncode}):\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--q3-rows", type=int, default=4_000_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tree", action="append", default=[], help="another checkout, timed in turns with this one")
    ap.add_argument("--only", choices=("", "p2", "p6", "p7", "p8", "m1", "m3", "k1"), default="",
                    help="p2: the mesh's unfused Q3 and its P2 calls (and M3); p6: q3_top100 and its P6 calls alone; "
                         "p7: Q3 and its P7 calls; p8: seg_revenue and its P8 calls; m1: M1 alone; m3: M3 alone; "
                         "k1: K1's calls in Q1, Q1 over regions and the burst")
    ap.add_argument("--host-of", help=argparse.SUPPRESS)  # the worker: one tree's measurements
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"mpp_profile: FAILED: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("mpp_profile: FAILED: torch.cuda.is_available() is False: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.host_of or ROOT)
    if not os.path.isdir(os.path.join(root, "tidb_tpu_torch")):
        print(f"mpp_profile: FAILED: no tidb_tpu_torch/ in {root}: run it from the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    if args.host_of:
        print(json.dumps(host(args.q3_rows, args.seed, args.reps, args.only)), flush=True)
        return 0
    import chip_smoke as cs

    card = cs.card_line()
    trees = [os.path.abspath(t) for t in args.tree] + [ROOT]
    runs = [(t, worker(t, args.q3_rows, args.seed, args.reps, args.only)) for t in trees + trees[::-1]]
    print(json.dumps({"runs": [{"tree": os.path.relpath(t, ROOT), **r} for t, r in runs], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
