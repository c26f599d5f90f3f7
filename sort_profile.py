#!/usr/bin/env python3
"""Profile K8 (csrc/lex_sort.cu), K6 (csrc/topk.cu) and K9
(csrc/sort_groups.cu) on one NVIDIA GPU.

    python3 sort_profile.py [--seed 3] [--tree DIR ...] [--only k9] [--rows 16000000] [--reps 3]

chip_smoke.py holds the kernels to their plain versions and times them on
the main path's own inputs, late in one long process. This script adds
what that run cannot show, each as one JSON line:

  times   — in a fresh process: K8 on a multikey_topn-like operand set of
            16M rows and its 7 x 2,097,152-row task-leading form, K6 over
            16M rows (k = 100, a padded tail masked) and 7 x 2,097,152,
            beside torch.argsort / torch.topk on the same data; and both
            task modes on tools/bench_sched.py's burst groups (64 tasks x
            4,096 rows, captured from one run_many), where a call is
            host-bound: `ms` is the call, `device_ms` the card's busy time
            in it (torch.profiler);
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

--only k9 runs the k9 turns alone. It checks every output it times
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
                                                topk_tasks_ref)
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
                                     ("point_topn_multi_dag", "k10_k8_burst", lex_sort_perm_tasks,
                                      lex_sort_perm_tasks_ref)):
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


def k9_worker(tree: str, rows: int, reps: int) -> dict:
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--k9-of", tree, "--rows", str(rows), "--reps",
                        str(reps)], capture_output=True, text=True, cwd=tree)
    if r.returncode != 0:
        raise RuntimeError(f"sort_profile: the K9 run in {tree} failed (exit {r.returncode}):\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--rows", type=int, default=16_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tree", action="append", default=[], help="another checkout, its K9 timed in turns with this one")
    ap.add_argument("--only", choices=("", "k9"), default="", help="k9: the K9 turns alone")
    ap.add_argument("--k9-of", help=argparse.SUPPRESS)  # the worker: one tree's K9 measurements
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
    root = os.path.abspath(args.k9_of or ROOT)
    if not os.path.isdir(os.path.join(root, "tidb_tpu_torch")):
        print(f"sort_profile: FAILED: no tidb_tpu_torch/ in {root}: run it from the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    if args.k9_of:
        print(json.dumps(k9(args.rows, args.reps)), flush=True)
        return 0
    import chip_smoke as cs

    card = cs.card_line()
    if not args.only:
        print(json.dumps({"phase": "times", **times(args.seed), "card": card}), flush=True)
        print(json.dumps({"phase": "phases", **phases(args.seed), "card": card}), flush=True)
    trees = [os.path.abspath(t) for t in args.tree] + [ROOT]
    runs = [(t, k9_worker(t, args.rows, args.reps)) for t in trees + trees[::-1]]
    print(json.dumps({"phase": "k9", "runs": [{"tree": os.path.relpath(t, ROOT), **r} for t, r in runs],
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
