#!/usr/bin/env python3
"""Repeated MPP runs over four ranks sharing one NVIDIA GPU, each held to
the one-device answer: a check for faults that show only now and then,
such as a race between the ranks' threads.

    python3 mesh_stress.py [--iters 100] [--rows 4000000] [--seed 42] [--query q3_top100 --query seg_revenue]
                           [--tree DIR ...]

Each iteration makes a new MPPEngine for each query (by default
q3_top100, the rowpos aggregation, and seg_revenue, the dense one: P8's
four rank calls at once on the card; q3_unfused and q18 put P2's exchange
before their HASH levels) and runs it twice over
make_mesh(4, "cuda") (gloo between the ranks): a cold run, in which the
ranks compile their programs and upload their tables from their threads
at once, then a warm one. Every answer must equal the query's one-device
answer row for row. A run stops at its first difference or CUDA error (the card's
error state is sticky). For each --tree (another checkout of the
repository: an earlier commit, say) and this checkout, each in a fresh
process, one JSON line: the runs made, the first failure (None when every
run agreed) and the card's name and power limit. Without a card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
# query → (models/tpch.py plan builder and its arguments, the session variables it runs under)
QUERIES = {"q3_top100": (("q3_mpp_plan", 100), {}), "q3_mpp": (("q3_mpp_plan",), {}), "q18": (("q18_mpp_plan",), {}),
           "seg_revenue": (("seg_revenue_mpp_plan",), {}),
           "q3_unfused": (("q3_mpp_plan",), {"tidb_tpu_mpp_fused": "OFF"})}


def worker(args) -> int:
    """The loop in this process, over the package of tree `args.root`."""
    sys.path.insert(0, args.root)
    import torch

    import chip_smoke as cs  # the tree's own helpers
    from tidb_tpu_torch.entry import run_mpp
    from tidb_tpu_torch.kernels.build import build_all
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.parallel.mesh import make_mesh
    from tidb_tpu_torch.parallel.mpp import MPPEngine

    build_all()
    li, orders, cust = tpch.generated_columns(args.rows, args.seed)
    tables = {"lineitem": li, "orders": orders, "customer": cust}
    plans, ones = {}, {}
    for q in args.query:
        (make_plan, *bargs), variables = QUERIES[q]
        plans[q] = getattr(tpch, make_plan)(*bargs)
        ones[q] = run_mpp(plans[q], tables, device="cuda", engine=MPPEngine("cuda"), variables=variables)
    mesh = make_mesh(4, "cuda")
    runs, first, t0 = dict.fromkeys(args.query, 0), None, time.perf_counter()
    try:
        for i in range(args.iters):
            for q in args.query:
                engine = MPPEngine("cuda")
                for kind in ("cold", "warm"):
                    runs[q] += 1
                    try:
                        got = run_mpp(plans[q], tables, device="cuda", engine=engine, mesh=mesh,
                                      variables=QUERIES[q][1])
                        torch.cuda.synchronize()
                        diff = cs.chunks_equal(got, ones[q])
                    except Exception:  # noqa: BLE001 — the failure is the result
                        diff = traceback.format_exc(limit=4)
                    if diff is not None:
                        first = f"iteration {i}, {q}, {kind} run: {diff}"
                        break
                if first is not None:
                    break
            if first is not None:
                break
    finally:
        mesh.close()
    print(json.dumps({"tree": args.root, "queries": args.query, "rows": args.rows, "runs": runs,
                      "first_failure": first, "seconds": time.perf_counter() - t0, "card": cs.card_line()}),
          flush=True)
    return 0 if first is None else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--rows", type=int, default=4_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--query", choices=sorted(QUERIES), action="append",
                    help="a query to repeat (again for more; default q3_top100 and seg_revenue)")
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.query = args.query or ["q3_top100", "seg_revenue"]
    import torch

    if not torch.cuda.is_available():
        print("mesh_stress: no CUDA device", file=sys.stderr)
        return 1
    if args.root is not None:
        return worker(args)
    rc = 0
    for tree in [os.path.abspath(t) for t in args.tree] + [ROOT]:
        cmd = [sys.executable, os.path.abspath(__file__), "--root", tree, "--iters", str(args.iters),
               "--rows", str(args.rows), "--seed", str(args.seed)] + [a for q in args.query for a in ("--query", q)]
        rc = subprocess.run(cmd, cwd=tree).returncode
    return rc  # this checkout's


if __name__ == "__main__":
    sys.exit(main())
