#!/usr/bin/env python3
"""Profile K8 (csrc/lex_sort.cu), K6 (csrc/topk.cu), K7
(csrc/topn_multi.cu) and K9 (csrc/sort_groups.cu) on one NVIDIA GPU.

    python3 sort_profile.py [--seed 3] [--tree DIR ...] [--only k9|k7|k68] [--rows 16000000] [--reps 3]
                            [--turns 1] [--reads 3]

chip_smoke.py holds the kernels to their plain versions and times them on
the main path's own inputs, late in one long process. This script adds
what that run cannot show, each as one JSON line:

  times   — in a fresh process: K8 on a multikey_topn-like operand set of
            16M rows and its 7 x 2,097,152-row task-leading form, K6 over
            16M rows (k = 100, a padded tail masked) and 7 x 2,097,152,
            beside torch.argsort / torch.topk on the same data; and both
            task modes on tools/bench_sched.py's burst groups (64 tasks x
            4,096 rows, captured from one run_many; K7's mode on the
            multi-key TopN's), where a call is host-bound: `ms` is the
            call, `device_ms` the card's busy time in it (torch.profiler);
  phases  — the cycles one tile of K8's pass spends in each phase, read
            with clock64() by thread 0 of every tile and summed over the 7
            passes of a 16M-row multikey sort, from a copy of
            csrc/lex_sort.cu built with that instrumentation (the
            repository's source is not changed);
  k9      — for this checkout and each --tree (another checkout: an
            earlier commit, say), each in a fresh process rooted there, in
            turns (the trees, then the same in reverse order): Q18's
            subquery through run_query over --rows lineitem rows (seed 42,
            chip_smoke.py's main path), its wall and `sort` span (median of
            --reps warm runs), K9's call on its own inputs (`k9_q18`) and
            K10·K9's call on the regions' q18_inner group (`k10_k9_regions`,
            the last run_many of 8 regions): ms (CUDA events over 10
            calls), host_ms (the host clock's median call through a
            synchronize), K8's share (`k8_ms`, its calls timed apart, and
            `k8_device_ms`, its kernels in one profiled call), the device
            time by kernel of one profiled call.

  k7      — for this checkout and each --tree, in turns as k9's: the
            multi-key TopN's sort phase — multikey_topn through run_query
            over --rows lineitem rows (its wall and `sort` span, median of
            --reps warm runs), its one sort call on the query's own inputs
            (`solo`: K7's select, or an earlier tree's K7 operand kernel
            and K8 over every row), the regions' group (`regions`, 7 x
            2,097,152 rows) and the point multi-key TopN burst's group
            (`burst`, 64 x 4,096 rows) as the engine calls them: `ms` (CUDA
            events over 10 calls), `host_ms`, the device time and launches
            of one profiled call by kernel; beside them
            torch.topk(k, largest=False) of one packed word of the
            operands' varying bits (`topk_word_ms`, the nearest single
            call: it does less) and the bytes bound (chip_smoke.py's
            k7_need_bytes on the call's data: the mask and the first key
            at every row, a later key only where the rows still tie); and
            K6 and K8 on their own 16M-row calls (`k6_16M_k100`,
            `k8_multikey_16M`), which the slice must leave unchanged;
  k68     — only with --only k68, in turns as k9's: K8's and K6's calls
            of k7 alone, --reads readings each of `ms` and `device_ms`
            (torch.profiler, 5 calls) in every turn, and the ptxas lines
            (registers, stack, spills) and a digest of each kernel's SASS
            (cuobjdump) of each tree's lex_sort.cu and topk.cu build;
            `sass_same` says whether every tree built the same code.

--only k9 / k7 / k68 runs those turns alone; --turns repeats the trees
and their reverse that many times. It checks every output it times
against the plain version first. Without
a card, or without the repository beside it, it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
# (anchor in pass_kernel, the clock read that goes before it): phase i is
# the time from mark i to mark i + 1
MARKS = (("  // 1. rank in index order", "  long long clk1 = clock64();\n"),
         ("  // 2. digit t: each chain's count", "  long long clk2 = clock64();\n"),
         ("  // 3. stage the tile in shared memory", "  long long clk3 = clock64();\n"),
         ("  // 4. look-back: digit t's rows", "  long long clk4 = clock64();\n"),
         ("  gbase[t] = doff + (int32_t)excl;\n", "  long long clk5 = clock64();\n"))
PHASES = ("issue loads", "rank (the loads' wait inside)", "chain counts, publish, scans", "stage", "look-back",
          "write-out")


def instrumented(src: str) -> str:
    """csrc/lex_sort.cu with pass_kernel's phase clocks summed into g_clk."""
    first = "  const int64_t tile = (int64_t)s_tile;\n"
    end = "    vals_out[pos] = sval[j];\n  }\n}\n"
    edits = [(first, first + "  long long clk0 = clock64();\n")] + [(a, b + a) for a, b in MARKS]
    edits.append((end, end[:-2] + "  __syncthreads();\n  long long clk6 = clock64();\n  if (t == 0) {\n"
                  "    const long long clk[7] = {clk0, clk1, clk2, clk3, clk4, clk5, clk6};\n"
                  "    for (int q = 0; q < 6; ++q) atomicAdd(&g_clk[q], (u64)(clk[q + 1] - clk[q]));\n"
                  "    atomicAdd(&g_clk[6], 1ULL);\n  }\n}\n"))
    edits.append(("constexpr int kMinTile", "__device__ unsigned long long g_clk[8];\nconstexpr int kMinTile"))
    for a, b in edits:
        if src.count(a) != 1:
            raise RuntimeError(f"sort_profile: csrc/lex_sort.cu no longer has {a.strip()!r} once")
        src = src.replace(a, b)
    return src + ('\nextern "C" int tt_clk(unsigned long long* out, int reset) {\n'
                  '  unsigned long long z[8] = {0};\n'
                  '  if (reset) return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));\n'
                  '  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(z));\n}\n')


def device_ms(fn, calls: int = 5) -> float:
    """The card's busy time of one fn() (the union of its kernels and
    copies under torch.profiler), over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) or 0 for e in p.key_averages()
                if e.device_type.name == "CUDA")
    return total / calls / 1e3


def times(seed: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import run_many
    from tidb_tpu_torch.kernels.grouped import (lex_sort_perm_tasks, lex_sort_perm_tasks_ref, topk_tasks,
                                                topk_tasks_ref, topn_multi_tasks, topn_multi_tasks_ref)
    from tidb_tpu_torch.kernels.topk import sort_key
    from tidb_tpu_torch.models import tpch

    dev, rng, out = "cuda", np.random.default_rng(seed), {}
    (_, ops), = cs.sort_cases(dev, rng, 16_000_000, ("multikey_topn",))
    cs._same(K.lex_sort_perm(ops), K.lex_sort_perm_ref(ops), "K8 multikey")
    word = cs._packed_word(ops)
    out["k8_multikey_16M"] = {"ms": cs.time_ms(lambda: K.lex_sort_perm(ops)),
                              "argsort_ms": cs.time_ms(lambda: torch.argsort(word, stable=True))}
    G, w = 7, 2_097_152
    (_, rops), = cs.sort_cases(dev, rng, G * w, ("multikey_topn",))
    cs._same(lex_sort_perm_tasks(rops, w), lex_sort_perm_tasks_ref(rops, w), "K8 task mode")
    rword = cs._packed_word(rops).reshape(G, w)
    out["k10_k8_7x2M"] = {"ms": cs.time_ms(lambda: lex_sort_perm_tasks(rops, w)),
                          "batched_sort_ms": cs.time_ms(lambda: torch.sort(rword, dim=-1, stable=True))}
    n = 16_056_320
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mask[16_000_000:] = False
    price = torch.from_numpy(rng.integers(90000, 10500000, n)).to(dev)
    (gi, _), (wi, _) = K.topk(price, None, mask, True, 100), K.topk_ref(price, None, mask, True, 100)
    cs._same(gi, wi, "K6 16M")
    sk = sort_key(price, None, mask, True)
    out["k6_16M_k100"] = {"ms": cs.time_ms(lambda: K.topk(price, None, mask, True, 100)),
                          "topk_ms": cs.time_ms(lambda: torch.topk(sk, 100))}
    datas = [torch.from_numpy(rng.integers(90000, 10500000, w)).to(dev) for _ in range(G)]
    masks = [torch.ones(w, dtype=torch.bool, device=dev) for _ in range(G)]
    cs._same(topk_tasks(datas, [None] * G, masks, True, 100, w)[0],
             topk_tasks_ref(datas, [None] * G, masks, True, 100, w)[0], "K6 task mode")
    keys2d = torch.stack([sort_key(d, None, m, True) for d, m in zip(datas, masks)])
    out["k10_k6_7x2M_k100"] = {"ms": cs.time_ms(lambda: topk_tasks(datas, [None] * G, masks, True, 100, w)),
                               "topk_ms": cs.time_ms(lambda: torch.topk(keys2d, 100, dim=-1))}
    batches = tpch.point_agg_table(cs.N_TASKS, cs.ROWS_PER_TASK)
    for builder, name, mode, ref in (("point_topn_dag", "k10_k6_burst", topk_tasks, topk_tasks_ref),
                                     ("point_topn_multi_dag", "k10_k7_burst", topn_multi_tasks,
                                      topn_multi_tasks_ref)):
        with cs.TaskSpy() as spy:
            run_many([(getattr(tpch, builder)(), b) for b in batches], dev, TorchEngine(dev))
        (args,) = cs.task_args(spy.calls, mode.__name__)
        got, want = mode(*args), ref(*args)
        cs._same(got[0] if isinstance(got, tuple) else got, want[0] if isinstance(want, tuple) else want, name)
        out[name] = {"ms": cs.time_ms(lambda: mode(*args), 20), "device_ms": device_ms(lambda: mode(*args))}
    return out


def phases(seed: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.kernels import build as B
    from tidb_tpu_torch.kernels import lex_sort as LS

    out_dir = os.path.join(ROOT, "build", "sort_profile")
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "lex_sort_clk.cu"), os.path.join(out_dir, "liblex_sort_clk.so")
    with open(cu, "w") as f:
        f.write(instrumented((B.CSRC / "lex_sort.cu").read_text()))
    r = subprocess.run([B.nvcc_path(), *B.ARCH_FLAGS, *B.NVCC_FLAGS, "-o", so, cu], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError("sort_profile: the instrumented build failed:\n" + r.stdout + r.stderr)
    lib = ctypes.CDLL(so)
    lib.tt_clk.argtypes = [ctypes.c_void_p, ctypes.c_int]
    real = B.build_all()["lex_sort"]
    B._libs["lex_sort"] = lib  # the wrapper binds the library it finds here
    LS._bound.discard("lex_sort")
    try:
        (_, ops), = cs.sort_cases("cuda", np.random.default_rng(seed), 16_000_000, ("multikey_topn",))
        cs._same(K.lex_sort_perm(ops), K.lex_sort_perm_ref(ops), "instrumented K8")
        torch.cuda.synchronize()
        lib.tt_clk(None, 1)
        K.lex_sort_perm(ops)
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * 8)()
        lib.tt_clk(ctypes.addressof(clk), 0)
    finally:
        B._libs["lex_sort"] = real
        LS._bound.discard("lex_sort")
    tiles = max(int(clk[6]), 1)
    return {"tiles": int(clk[6]), "cycles_per_tile": {p: clk[i] / tiles for i, p in enumerate(PHASES)}}


def _host_ms(fn, reps: int = 10) -> float:
    """Median host-clock ms of fn() through a synchronize."""
    import time

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


def _k9_call(cs, fn, k8_ms: float) -> dict:
    split = cs.kernel_split(fn)
    sm = split.get("split_ms") or {}
    k8_dev = sum(v for n, v in sm.items() if n.startswith(("build_keys", "pass_kernel", "orand_kernel",
                                                               "init_orand")))
    ms = cs.time_ms(fn)
    return {"ms": ms, "host_ms": _host_ms(fn), "k8_ms": k8_ms, "own_ms": ms - k8_ms,
            "device_ms": sum(sm.values()) if sm else None, "k8_device_ms": k8_dev, **split}


def k9(rows: int, reps: int) -> dict:
    """One tree's K9 measurements (module doc), in this process."""
    import importlib
    import time

    import torch

    import chip_smoke as cs
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import batch_from_numpy, run_many, run_query
    from tidb_tpu_torch.kernels import sort_groups, sort_groups_ref
    from tidb_tpu_torch.kernels.grouped import sort_groups_tasks
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.torchenv import PhaseTimer

    dev, out = torch.device("cuda"), {}
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(rows, 42))
    dag = tpch.q18_inner_dag()
    eng, captured = TorchEngine(dev), {}
    cs._spy(eng, captured)
    runs = []
    for _ in range(reps + 1):
        eng.timer = PhaseTimer(eng.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_query(dag, batch, device=dev, engine=eng)
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t) * 1e3, eng.timer.totals_ms()))
    warm = sorted(runs[1:], key=lambda r: r[0])
    out["q18_inner"] = {"rows": rows, "wall_ms": warm[len(warm) // 2][0], "walls_ms": [r[0] for r in warm],
                        "spans_ms": warm[len(warm) // 2][1]}
    (mask, keys, cap_of), _ = captured["sort_groups"]
    cs._same_groups(sort_groups(mask, keys, cap_of), sort_groups_ref(mask, keys, cap_of), "K9 on Q18's subquery")
    k9m = importlib.import_module("tidb_tpu_torch.kernels.sort_groups")
    ops, k8_ms = cs.k8_inside(k9m, lambda: sort_groups(mask, keys, cap_of))
    out["k9_q18"] = {"n": mask.numel(), "k8_rows": [o[0].data.numel() for o in ops],
                     **_k9_call(cs, lambda: sort_groups(mask, keys, cap_of), k8_ms)}
    pairs = [(dag, r) for r in tpch.region_batches(batch)]
    eng2 = TorchEngine(dev)
    run_many(pairs, dev, eng2)  # the cold run escalates the group capacity
    with cs.TaskSpy() as spy:
        run_many(pairs, dev, eng2)
    (args,) = cs.task_args(spy.calls, "sort_groups_tasks")
    cs._k9_tasks(*args)
    out["k10_k9_regions"] = {"tasks": len(args[0]), "width": args[2],
                             **_k9_call(cs, lambda: sort_groups_tasks(*args), 0.0)}
    return out


HBM_BYTES_PER_S = 3.35e12


def _multi_sorter(cs):
    """(solo, tasks): the tree's multi-key TopN sort as the engine calls it
    — (mask, keys, k) → (idx, ok) and (masks, keys, k, width) → ([G, k]
    idx, ok) — with the spied names of its calls: K7's select in this
    slice, K7's operand kernel and K8 over every row before it."""
    import torch

    from tidb_tpu_torch.kernels import grouped

    if "topn_multi_tasks" in cs.SPIED_TASKS:
        from tidb_tpu_torch.kernels import topn_multi

        return ("topn_multi", lambda m, ks, k: topn_multi(m, ks, k)), (
            "topn_multi_tasks", lambda ms, kss, k, w: grouped.topn_multi_tasks(ms, kss, k, w))
    from tidb_tpu_torch.kernels import lex_sort_perm, topn_multi_ops

    def solo(m, ks, k):
        ops = topn_multi_ops(m, ks)
        idx = lex_sort_perm(ops)[:k].long()
        return idx, ops[0].data[idx] == 0

    def tasks(ms, kss, k, w):
        ops = grouped.topn_multi_ops_tasks(ms, kss, w)
        G = len(ms)
        rows = grouped.lex_sort_perm_tasks(ops, w).long().reshape(G, w)[:, :k]
        return rows - torch.arange(G, device=rows.device)[:, None] * w, ops[0].data[rows] == 0

    return ("topn_multi_ops", solo), ("topn_multi_ops_tasks", tasks)


def _here_smoke():
    """This checkout's chip_smoke.py (a worker rooted in another tree
    imports that tree's as `cs`): its k7_need_bytes is the bound of every
    tree's call on the same data."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k7_call(cs, fn, check, word, k: int, nbytes: int) -> dict:
    import torch

    check(fn())
    # a profiled session can miss a kernel (late in a process): the session that saw the most
    split = max((cs.kernel_split(fn) for _ in range(3)), key=lambda x: x.get("launches") or 0)
    sm = split.get("split_ms") or {}
    return {"ms": cs.time_ms(fn), "host_ms": _host_ms(fn), "device_ms": sum(sm.values()) if sm else None, **split,
            "topk_word_ms": None if word is None else cs.time_ms(lambda: torch.topk(word, k, dim=-1, largest=False)),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def k7(rows: int, reps: int, seed: int) -> dict:
    """One tree's K7 measurements (module doc), in this process."""
    import time

    import torch

    import chip_smoke as cs
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import batch_from_numpy, run_many, run_query
    from tidb_tpu_torch.kernels.grouped import _cut
    from tidb_tpu_torch.kernels.lex_sort import lex_sort_perm_ref
    from tidb_tpu_torch.kernels.topn_multi import topn_multi_ops_ref
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.torchenv import PhaseTimer

    (solo_name, solo), (tasks_name, tasks) = _multi_sorter(cs)
    dev, out = torch.device("cuda"), {}

    def ref(m, ks, k):
        idx = lex_sort_perm_ref(topn_multi_ops_ref(m, ks))[:k].long()
        return idx, m[idx]

    need = _here_smoke().k7_need_bytes

    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(rows, 42))
    dag = tpch.multikey_topn_dag()
    eng, captured = TorchEngine(dev), {}

    def spy(*a, _fn=getattr(eng, solo_name), **kw):
        captured["args"] = a
        return _fn(*a, **kw)
    setattr(eng, solo_name, spy)
    runs = []
    for _ in range(reps + 1):
        eng.timer = PhaseTimer(eng.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_query(dag, batch, device=dev, engine=eng)
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t) * 1e3, eng.timer.totals_ms()))
    warm = sorted(runs[1:], key=lambda r: r[0])
    out["multikey_topn"] = {"rows": rows, "wall_ms": warm[len(warm) // 2][0], "walls_ms": [r[0] for r in warm],
                            "spans_ms": warm[len(warm) // 2][1]}
    mask, keys = captured["args"][:2]
    k = min(dag.topn.n, mask.numel())

    def check_solo(got, m=mask, ks=keys, k=k):
        want = ref(m, ks, k)
        cs._same(got[0], want[0], "K7 rows")
        cs._same(got[1], want[1], "K7 ok bits")

    word = cs._packed_word(topn_multi_ops_ref(mask, keys))
    out["solo"] = {"n": mask.numel(), "k": k, **_k7_call(cs, lambda: solo(mask, keys, k), check_solo, word, k,
                                                           need(mask, keys, k))}
    # the reference's regions (a smaller --rows cut at an eighth, to form a group)
    groups = {"regions": [(dag, r) for r in tpch.region_batches(batch, min(1 << 21, max(rows // 8, 1)))],
              "burst": [(tpch.point_topn_multi_dag(), b) for b in tpch.point_agg_table(cs.N_TASKS, cs.ROWS_PER_TASK)]}
    for gname, pairs in groups.items():
        eng2 = TorchEngine(dev)
        run_many(pairs, dev, eng2)  # the cold run uploads the lanes
        with cs.TaskSpy() as tspy:
            run_many(pairs, dev, eng2)
        (args,) = cs.task_args(tspy.calls, tasks_name)
        ms, kss, w = args[0], args[1], args[-1]
        kt = min(pairs[0][0].topn.n, w)

        def check_tasks(got, ms=ms, kss=kss, w=w, kt=kt):
            for g, (m, ks) in enumerate(zip(ms, kss)):
                want = ref(_cut(m, w), [(_cut(d, w), _cut(v, w), s) for d, v, s in ks], kt)
                cs._same(got[0][g], want[0], f"K7 task {g} rows")
                cs._same(got[1][g], want[1], f"K7 task {g} ok bits")

        ops = [topn_multi_ops_ref(_cut(m, w), [(_cut(d, w), _cut(v, w), s) for d, v, s in ks]) for m, ks in zip(ms, kss)]
        gword = cs._packed_word([type(o)(torch.cat([p[q].data for p in ops]), o.kind) for q, o in enumerate(ops[0])])
        nbytes = sum(need(_cut(m, w), [(_cut(d, w), _cut(v, w), s) for d, v, s in ks], kt) for m, ks in zip(ms, kss))
        out[gname] = {"tasks": len(ms), "width": w, "k": kt,
                      **_k7_call(cs, lambda: tasks(ms, kss, kt, w), check_tasks,
                                 None if gword is None else gword.reshape(len(ms), w), kt, nbytes)}
    # K6 and K8 on their own calls (the slice leaves them as they were)
    for name, fn in _k68_calls(cs, seed).items():
        out[name] = {"ms": cs.time_ms(fn)}
    return out


def _k68_calls(cs, seed: int) -> dict:
    """{name: call} of K8 on a multikey_topn-like operand set of 16M rows
    and K6 over 16,056,320 rows (k = 100, the padded tail masked), each
    held to its plain version once."""
    import numpy as np
    import torch

    from tidb_tpu_torch import kernels as K

    rng = np.random.default_rng(seed)
    (_, sops), = cs.sort_cases("cuda", rng, 16_000_000, ("multikey_topn",))
    cs._same(K.lex_sort_perm(sops), K.lex_sort_perm_ref(sops), "K8 multikey")
    n = 16_056_320
    m6 = torch.ones(n, dtype=torch.bool, device="cuda")
    m6[16_000_000:] = False
    price = torch.from_numpy(rng.integers(90000, 10500000, n)).cuda()
    cs._same(K.topk(price, None, m6, True, 100)[0], K.topk_ref(price, None, m6, True, 100)[0], "K6 16M")
    return {"k8_multikey_16M": lambda: K.lex_sort_perm(sops),
            "k6_16M_k100": lambda: K.topk(price, None, m6, True, 100)}


def _ptxas(stems) -> dict:
    """{stem: the ptxas lines of its last build in this tree — each kernel's
    registers, stack and spills}."""
    from tidb_tpu_torch.kernels.build import BUILD_DIR, build_all

    build_all()
    out = {}
    for stem in stems:
        log = BUILD_DIR / f"{stem}.log"
        lines = log.read_text().splitlines() if log.exists() else []
        out[stem] = [" ".join(x.split()) for x in lines
                     if "Compiling entry" in x or "Used" in x or "spill" in x]
    return out


def _sass(stems) -> dict:
    """{stem: {kernel: a digest of its SASS}} of this tree's build
    (cuobjdump beside nvcc; instruction addresses and the anonymous
    namespace's hash left out), so two trees' kernels compare as code."""
    import hashlib
    import re

    from tidb_tpu_torch.kernels.build import CSRC, _target, nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out = {}
    for stem in stems:
        text = subprocess.run([tool, "-sass", str(_target(CSRC / f"{stem}.cu"))], capture_output=True, text=True,
                              check=True).stdout
        text = re.sub(r"/\*[0-9a-f]{4,5}\*/", "", re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", text))
        parts = re.split(r"^\s*Function : (\S+)$", text, flags=re.M)
        out[stem] = {name: hashlib.sha256(body.encode()).hexdigest()[:16]
                     for name, body in zip(parts[1::2], parts[2::2])}
    return out


def k68(seed: int, reads: int) -> dict:
    """One tree's K8 and K6 readings (module doc), in this process."""
    import chip_smoke as cs

    out = {}
    for name, fn in _k68_calls(cs, seed).items():
        out[name] = {"ms": [cs.time_ms(fn) for _ in range(reads)], "device_ms": [device_ms(fn) for _ in range(reads)]}
    out["ptxas"] = _ptxas(("lex_sort", "topk"))
    out["sass"] = _sass(("lex_sort", "topk"))
    return out


def worker(kind: str, tree: str, args) -> dict:
    r = subprocess.run([sys.executable, os.path.abspath(__file__), f"--{kind}-of", tree, "--rows", str(args.rows),
                        "--reps", str(args.reps), "--reads", str(args.reads), "--seed", str(args.seed)],
                       capture_output=True, text=True, cwd=tree)
    if r.returncode != 0:
        raise RuntimeError(f"sort_profile: the {kind} run in {tree} failed (exit {r.returncode}):\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--rows", type=int, default=16_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--turns", type=int, default=1, help="the trees, then in reverse order, this many times")
    ap.add_argument("--reads", type=int, default=3, help="k68: readings of each call in each turn")
    ap.add_argument("--tree", action="append", default=[],
                    help="another checkout, its K9 and K7 timed in turns with this one")
    ap.add_argument("--only", choices=("", "k9", "k7", "k68"), default="", help="k9 / k7 / k68: those turns alone")
    ap.add_argument("--k9-of", help=argparse.SUPPRESS)  # the worker: one tree's K9 measurements
    ap.add_argument("--k7-of", help=argparse.SUPPRESS)  # the worker: one tree's K7 measurements
    ap.add_argument("--k68-of", help=argparse.SUPPRESS)  # the worker: one tree's K6 and K8 readings
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"sort_profile: FAILED: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("sort_profile: FAILED: torch.cuda.is_available() is False: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.k9_of or args.k7_of or args.k68_of or ROOT)
    if not os.path.isdir(os.path.join(root, "tidb_tpu_torch")):
        print(f"sort_profile: FAILED: no tidb_tpu_torch/ in {root}: run it from the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    if args.k9_of:
        print(json.dumps(k9(args.rows, args.reps)), flush=True)
        return 0
    if args.k7_of:
        print(json.dumps(k7(args.rows, args.reps, args.seed)), flush=True)
        return 0
    if args.k68_of:
        print(json.dumps(k68(args.seed, args.reads)), flush=True)
        return 0
    import chip_smoke as cs

    card = cs.card_line()
    if not args.only:
        print(json.dumps({"phase": "times", **times(args.seed), "card": card}), flush=True)
        print(json.dumps({"phase": "phases", **phases(args.seed), "card": card}), flush=True)
    trees = [os.path.abspath(t) for t in args.tree] + [ROOT]
    for kind in ("k9", "k7", "k68"):
        if args.only == kind or (not args.only and kind != "k68"):
            runs = [(t, worker(kind, t, args)) for t in (trees + trees[::-1]) * args.turns]
            extra = {}
            if kind == "k68":  # each stem's kernels the same code in every tree
                sass = [r["sass"] for _, r in runs]
                extra["sass_same"] = {stem: all(x[stem] == sass[0][stem] for x in sass) for stem in sass[0]}
            print(json.dumps({"phase": kind, "runs": [{"tree": os.path.relpath(t, ROOT), **r} for t, r in runs],
                              **extra, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
