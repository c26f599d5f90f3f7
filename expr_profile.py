#!/usr/bin/env python3
"""Profile the expression kernel (K2/K3, csrc/expr_eval.cu) on one NVIDIA
GPU against other checkouts, in turns.

    python3 expr_profile.py [--seed 42] [--rows 16000000] [--turns 2] [--tree DIR ...]

For each --tree (another checkout of the repository: an earlier commit,
say) and this checkout, each in a fresh process, in turns (the trees and
this checkout, then the same in reverse order, `--turns` times), the
expression kernel's launch alone (Params built beforehand, CUDA events:
the mean of 20 launches and the median of 20 single ones) on the program
and lanes the engine builds for TPC-H Q1, Q6 and CHECKSUM over a
`--rows` lineitem (seed `--seed`), and, where the tree has them, FN_MIX
and FN_MATH; beside each its bytes (each distinct input read once, each
output written once), the bound at 3.35 TB/s, the program's ops and
registers, whether it runs the extended instantiation, and ptxas's
registers and spills of each instantiation of the tree's build. Each
tree runs its own package and chip_smoke.py helpers and builds its own
kernels in its own build/. One JSON line per turn, then a summary line:
each query's median over the turns for each tree, and the card's name
and power limit.

Without a card, or without the repository beside it, it exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet (700 W)
QUERIES = ("q1", "q6", "checksum", "fn_mix", "fn_math")


def ptxas(root: str) -> dict:
    """{instantiation: {registers, spill_stores}} of expr_eval_kernel in the
    build log under `root`."""
    path = os.path.join(root, "build", "kernels", "expr_eval.log")
    out, fn = {}, None
    if not os.path.exists(path):
        return out
    for line in open(path, encoding="utf-8"):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = "ext" if "ILb1E" in m.group(1) else "base" if "ILb0E" in m.group(1) else "kernel"
            continue
        if fn is None:
            continue
        s = re.search(r"(\d+) bytes spill stores", line)
        if s:
            out.setdefault(fn, {})["spill_stores"] = int(s.group(1))
        r = re.search(r"Used (\d+) registers", line)
        if r:
            out.setdefault(fn, {})["registers"] = int(r.group(1))
    return out


def measure(rows: int, seed: int) -> dict:
    """One tree's timings (the worker's body, rooted at its tree)."""
    import chip_smoke as cs

    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import batch_from_numpy, run_query
    from tidb_tpu_torch.models import tpch

    EE = importlib.import_module("tidb_tpu_torch.kernels.expr_eval")
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(rows, seed))
    out = {}
    for q in QUERIES:
        if not hasattr(tpch, f"{q}_dag"):
            continue
        eng = TorchEngine("cuda")
        with cs.ExprSpy() as spy:
            run_query(getattr(tpch, f"{q}_dag")(), batch, device="cuda", engine=eng)
        prog, ins, n = spy.calls[-1]
        _, go = EE.expr_eval_prepare(prog, ins, n)
        nbytes = cs._nbytes(*ins) + sum(n * w for w in prog.outputs)  # a lane read twice counts once
        out[q] = {"kernel_ms": cs.time_ms(go, 20), "kernel_median_ms": cs.median_ms(go, 20), "bytes": nbytes,
                  "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "rows": n, "ops": len(prog.ops),
                  "registers": prog.nregs, "extended": bool(getattr(prog, "ext", False))}
    return {"queries": out, "ptxas": ptxas(os.getcwd())}


def worker(tree: str, rows: int, seed: int) -> dict:
    """The measurement in a fresh process rooted at `tree`."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure-of", tree, "--rows", str(rows),
                        "--seed", str(seed)], capture_output=True, text=True, cwd=tree)
    if r.returncode != 0:
        raise RuntimeError(f"expr_profile: the run in {tree} failed (exit {r.returncode}):\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--rows", type=int, default=16_000_000)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--tree", action="append", default=[], help="another checkout timed in turns with this one")
    ap.add_argument("--measure-of", help=argparse.SUPPRESS)  # the worker: one tree's measurement
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"expr_profile: FAILED: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("expr_profile: FAILED: torch.cuda.is_available() is False: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.measure_of or ROOT)
    if not os.path.isdir(os.path.join(root, "tidb_tpu_torch")):
        print(f"expr_profile: FAILED: no tidb_tpu_torch/ in {root}: run it from the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    if args.measure_of:
        print(json.dumps(measure(args.rows, args.seed)), flush=True)
        return 0
    import chip_smoke as cs

    card = cs.card_line()
    trees = [os.path.abspath(t) for t in args.tree] + [ROOT]
    order = []
    for k in range(args.turns):
        order += trees if k % 2 == 0 else trees[::-1]
    per: dict = {}
    for i, t in enumerate(order):
        r = worker(t, args.rows, args.seed)
        name = os.path.relpath(t, ROOT)
        print(json.dumps({"turn": i, "tree": name, **r, "card": card}), flush=True)
        for q, m in r["queries"].items():
            per.setdefault(name, {}).setdefault(q, []).append(m["kernel_median_ms"])
    summary = {name: {q: statistics.median(v) for q, v in qs.items()} for name, qs in per.items()}
    print(json.dumps({"summary_kernel_median_ms": summary, "runs": per, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
