#!/usr/bin/env python3
"""Profile K4 (csrc/seg_agg.cu) on one NVIDIA GPU: its wrappers' host work
and its register budget.

    python3 k4_profile.py [--seed 42] [--rows 16000000] [--tree DIR ...]

chip_smoke.py holds K4 to its plain version and times it on the main
path's own inputs, late in one long process. This script adds what that
run cannot show, each as one JSON line:

  host    — for each --tree (another checkout of the repository: an earlier
            commit, say) and this checkout, each in a fresh process, in
            turns (the trees, then the same in reverse order): K4's
            task-grid call on tools/bench_sched.py's burst group (64 tasks
            x 4,096 rows of the point aggregation, compression on, from one
            run_many), timed as chip_smoke.py's K10 row times it (`ms`,
            `kernel_ms`, `host_tables_ms`, `solo_x_G_ms`), with each call's
            host-clock time (`*_host_ms`: nothing synchronized) and its
            preparation apart from its launch; and the solo call on Q6's
            own inputs (`ms`, `host_ms`, and where the tree has them the
            kernel alone, the preparation and the descriptor builders
            alone). Each tree runs its own chip_smoke.py helpers and its
            own kernels, built in its own build/;
  bounds  — copies of this checkout's csrc/seg_agg.cu under other launch
            bounds (the source is not changed), built beside it: ptxas's
            registers and spill bytes for each mode's kernel, and K4 on
            Q1's, Q6's and CHECKSUM's own inputs (the call and the kernel
            alone) and on Q1's 7 x 2M regions (K10's call), each variant
            held to the plain version first, in turns (the variants, then
            the same in reverse order). A variant's plan keeps the
            source's block sizes and blocks an SM as its bounds allow.

Without a card, or without the repository beside it, it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
BOUNDS = "__launch_bounds__(MAX_THREADS, 2)"
# name → (launch bounds in the copy, the plan's largest block, resident blocks an SM over the source's 2 of 512)
VARIANTS = {"512x2": (BOUNDS, 512, 1.0), "512x1": ("__launch_bounds__(MAX_THREADS, 1)", 512, 0.5),
            "256x3": ("__launch_bounds__(256, 3)", 256, 1.5)}
MODE_NAMES = {"0": "reg", "1": "warp", "2": "global"}


def ptxas_report(log: str) -> dict:
    """{mode: {registers, spill_stores, spill_loads}} of seg_agg_kernel<MODE>
    from nvcc's -Xptxas -v output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'|Function properties for (\S+)", line)
        if m:
            fn = m.group(1) or m.group(2)
            continue
        mode = re.search(r"seg_agg_kernelILi(\d)E", fn or "")
        if mode is None:
            continue
        rec = out.setdefault(MODE_NAMES[mode.group(1)], {})
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if s:
            rec["spill_stores"], rec["spill_loads"] = int(s.group(1)), int(s.group(2))
        r = re.search(r"Used (\d+) registers", line)
        if r:
            rec["registers"] = int(r.group(1))
    return out


def lineitem_inputs(rows: int, seed: int, queries=("q1", "q6", "checksum"), regions: bool = True) -> dict:
    """K4's inputs as the engine builds them for `queries` over a `rows`-row
    lineitem and, with `regions`, K10's over Q1's regions of it."""
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import batch_from_numpy, run_many, run_query
    from tidb_tpu_torch.models import tpch

    dev = torch.device("cuda")
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(rows, seed))
    out = {}
    for q in queries:
        eng, cap = TorchEngine(dev), {}
        cs._spy(eng, cap)
        run_query(getattr(tpch, q + "_dag")(), batch, device=dev, engine=eng)
        out[q] = cap["seg_agg"]
    if not regions:
        return out
    with cs.TaskSpy() as spy:
        run_many([(tpch.q1_dag(), r) for r in tpch.region_batches(batch)], dev, TorchEngine(dev))
    out["regions"] = cs.task_args(spy.calls, "seg_agg_tasks")[-1]
    return out


def host(rows: int, seed: int) -> dict:
    """The host phase in this process's checkout (module doc)."""
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import run_many
    from tidb_tpu_torch.kernels import seg_agg, seg_agg_ref
    from tidb_tpu_torch.kernels.grouped import seg_agg_tasks_prepare
    from tidb_tpu_torch.models import tpch

    SA = importlib.import_module("tidb_tpu_torch.kernels.seg_agg")
    dev = torch.device("cuda")
    eng = TorchEngine(dev)
    eng.tile_compression = True
    with cs.TaskSpy() as spy:
        run_many([(tpch.point_agg_dag(), b) for b in tpch.point_agg_table(cs.N_TASKS, cs.ROWS_PER_TASK)], dev, eng)
    picked = cs.task_args(spy.calls, "seg_agg_tasks")
    run, _, solo, kernel, tables, *_ = cs._k10_seg(picked)
    prepare = lambda: [seg_agg_tasks_prepare(*c, dev) for c in picked]  # noqa: E731
    out = {"burst": {"calls": len(picked), "ms": cs.time_ms(run), "kernel_ms": cs.time_ms(kernel),
                     "host_tables_ms": cs.host_ms(tables), "solo_x_G_ms": cs.time_ms(solo),
                     "call_host_ms": cs.host_ms(run), "prepare_host_ms": cs.host_ms(prepare),
                     "launch_host_ms": cs.host_ms(kernel), "solo_x_G_host_ms": cs.host_ms(solo)}}
    torch.cuda.synchronize()
    (m, keys, lanes, nseg), kw = lineitem_inputs(rows, seed, ("q6",), False)["q6"]
    seg = kw.get("seg")
    (gi, gf), (wi, wf) = seg_agg(m, keys, lanes, nseg, **kw), seg_agg_ref(m, keys, lanes, nseg, **kw)
    torch.cuda.synchronize()
    cs._same(gi, wi, "Q6's seg_agg ints")
    cs._same(gf, wf, "Q6's seg_agg floats", True)
    call = lambda: seg_agg(m, keys, lanes, nseg, **kw)  # noqa: E731
    q6 = out["q6"] = {"ms": cs.time_ms(call), "host_ms": cs.host_ms(call, 100)}
    if hasattr(SA, "seg_agg_prepare"):
        _, go = SA.seg_agg_prepare(m, keys, lanes, nseg, seg)
        q6.update(kernel_ms=cs.time_ms(go), prepare_host_ms=cs.host_ms(lambda: SA.seg_agg_prepare(
            m, keys, lanes, nseg, seg), 100), launch_host_ms=cs.host_ms(go, 100))
    n_f = sum(1 for lane in lanes if lane.is_float)
    iout = torch.empty((len(lanes) - n_f, nseg), dtype=torch.int64, device=dev)
    fout = torch.empty((n_f, nseg), dtype=torch.float64, device=dev)
    if hasattr(SA, "seg_desc"):
        q6["seg_desc_host_ms"] = cs.host_ms(lambda: SA.seg_desc(
            [m], [keys], [lanes], m.numel(), 0, iout, fout, None if seg is None else [seg]), 100)
    if hasattr(SA, "solo_desc"):
        q6["solo_desc_host_ms"] = cs.host_ms(lambda: SA.solo_desc(m, keys, lanes, 0, iout, fout, seg), 100)
    return out


def build_variants() -> dict:
    """{variant: (its library, its ptxas report)}: the copies of
    csrc/seg_agg.cu under VARIANTS' launch bounds, compiled at once."""
    from tidb_tpu_torch.kernels import build as B

    B.build_all()
    src = (B.CSRC / "seg_agg.cu").read_text()
    if src.count(BOUNDS) != 1:
        raise RuntimeError(f"k4_profile: csrc/seg_agg.cu no longer has {BOUNDS!r} once")
    vdir = B.BUILD_DIR.parent / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (bounds, _, _) in VARIANTS.items():
        cu = vdir / f"seg_agg_{name}.cu"
        cu.write_text(src.replace(BOUNDS, bounds))
        cmd = [B.nvcc_path(), *B.ARCH_FLAGS, *B.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                               text=True))
    out = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"k4_profile: variant {name} failed to build:\n{log}")
        out[name] = (ctypes.CDLL(str(so)), ptxas_report(log))
    return out


def bounds(rows: int, seed: int) -> dict:
    """The bounds phase in this checkout (module doc)."""
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch.kernels import build as B
    from tidb_tpu_torch.kernels import seg_agg, seg_agg_ref
    from tidb_tpu_torch.kernels.grouped import seg_agg_tasks, seg_agg_tasks_prepare, seg_agg_tasks_ref
    from tidb_tpu_torch.kernels.tables import sm_count

    SA = importlib.import_module("tidb_tpu_torch.kernels.seg_agg")
    GR = importlib.import_module("tidb_tpu_torch.kernels.grouped")
    libs = build_variants()
    dev = torch.device("cuda")
    ins = lineitem_inputs(rows, seed)
    sms = sm_count(dev)

    def use(name):
        _, max_threads, per_sm = VARIANTS[name]
        B._libs["seg_agg"] = libs[name][0]
        SA._bound.clear()
        SA.MAX_THREADS = max_threads
        # the plans' blocks: the source's two of MAX_THREADS an SM, scaled to what the bounds keep resident
        SA.sm_count = GR.sm_count = lambda d: int(sms * per_sm)

    def solo(q):
        (m, keys, lanes, nseg), kw = ins[q]
        return lambda: seg_agg(m, keys, lanes, nseg, **kw)

    def alone(q):
        (m, keys, lanes, nseg), kw = ins[q]
        return SA.seg_agg_prepare(m, keys, lanes, nseg, kw.get("seg"))[1]

    def check(q):
        (m, keys, lanes, nseg), kw = ins[q]
        (gi, gf), (wi, wf) = seg_agg(m, keys, lanes, nseg, **kw), seg_agg_ref(m, keys, lanes, nseg, **kw)
        torch.cuda.synchronize()
        cs._same(gi, wi, f"{q}'s seg_agg ints")
        return cs._same(gf, wf, f"{q}'s seg_agg floats", True)

    reg = ins["regions"]
    out = {name: {"ptxas": rep, "times": {}, "max_abs_err": 0.0} for name, (_, rep) in libs.items()}
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for name in order:
        use(name)
        rec = out[name]
        err = max(check(q) for q in ("q1", "q6", "checksum"))
        (gi, gf), (wi, wf) = seg_agg_tasks(*reg), seg_agg_tasks_ref(*reg)
        torch.cuda.synchronize()
        cs._same(gi, wi, "the regions' seg_agg_tasks ints")
        rec["max_abs_err"] = max(rec["max_abs_err"], err, cs._same(gf, wf, "the regions' seg_agg_tasks floats", True))
        go = seg_agg_tasks_prepare(*reg, dev)[1]
        t = {f"{q}_ms": cs.time_ms(solo(q)) for q in ("q1", "q6", "checksum")}
        t.update({f"{q}_kernel_ms": cs.time_ms(alone(q)) for q in ("q1", "q6", "checksum")})
        t.update(regions_ms=cs.time_ms(lambda: seg_agg_tasks(*reg)), regions_kernel_ms=cs.time_ms(go))
        for k, v in t.items():
            rec["times"].setdefault(k, []).append(v)
    return out


def worker(tree: str, rows: int, seed: int) -> dict:
    """The host phase in a fresh process rooted at `tree`."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--host-of", tree, "--rows", str(rows),
                        "--seed", str(seed)], capture_output=True, text=True, cwd=tree)
    if r.returncode != 0:
        raise RuntimeError(f"k4_profile: the host phase in {tree} failed (exit {r.returncode}):\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--rows", type=int, default=16_000_000)
    ap.add_argument("--tree", action="append", default=[], help="another checkout whose host phase runs in turns")
    ap.add_argument("--host-of", help=argparse.SUPPRESS)  # the worker: one tree's host phase
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"k4_profile: FAILED: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("k4_profile: FAILED: torch.cuda.is_available() is False: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.host_of or ROOT)
    if not os.path.isdir(os.path.join(root, "tidb_tpu_torch")):
        print(f"k4_profile: FAILED: no tidb_tpu_torch/ in {root}: run it from the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    if args.host_of:
        print(json.dumps(host(args.rows, args.seed)), flush=True)
        return 0
    import chip_smoke as cs

    card = cs.card_line()
    trees = [os.path.abspath(t) for t in args.tree] + [ROOT]
    runs = [(t, worker(t, args.rows, args.seed)) for t in trees + trees[::-1]]
    print(json.dumps({"phase": "host", "runs": [{"tree": os.path.relpath(t, ROOT), **r} for t, r in runs],
                      "card": card}), flush=True)
    print(json.dumps({"phase": "bounds", **bounds(args.rows, args.seed), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
