#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tidb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows 16000000] [--seed 42] [--reps 3]

Phases, one line each; any failure exits non-zero and prints no result:

 1. device  — torch's device name, and the card's name and power limit
              as nvidia-smi reports them;
 2. build   — compiles every CUDA kernel of the port from csrc/ (nvcc,
              sm_90a) into build/kernels/ and reports the seconds;
 3. kernels — K1 decode_lane and K4 seg_agg against their plain PyTorch
              versions on the card, over every codec and op at the main
              path's shapes (T=245, R=65536, nseg=12) and the edge shapes
              of the CPU tests: integers bit-exact, floats within
              rtol 1e-9 / atol 1e-6 (bench.py's own check); then each
              kernel's time beside its plain version's and its bound;
 4. main path — generates lineitem (--rows, seed --seed) with the port's
              generator, runs TPC-H Q1 and Q6 through run_query on "cuda",
              holds each answer to the port's host engine plus the final
              merge on the same data (exact), requires both kernels'
              launch counters to have moved during the queries, and
              reports rows/s, the median of --reps warm runs and a
              per-phase split timed with CUDA events;
 5. the kernels JSON line, the card line, and last the result line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Without a CUDA device, or run from a directory without the repository,
it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet (700 W)
RTOL, ATOL = 1e-9, 1e-6
T_MAIN, R_MAIN, NSEG_MAIN = 245, 65536, 12


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() over reps launches, CUDA events, after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# --- phase 3: kernels against their plain versions -----------------------


def _same(x, y, what: str, floats: bool = False) -> float:
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        raise AssertionError(f"{what}: shape/dtype {tuple(x.shape)}/{x.dtype} vs {tuple(y.shape)}/{y.dtype}")
    if floats:
        if not torch.allclose(x, y, rtol=RTOL, atol=ATOL, equal_nan=True):
            raise AssertionError(f"{what}: floats differ beyond rtol {RTOL} / atol {ATOL}")
        d = (x - y).abs()
        d = d[~torch.isnan(d)]
        return float(d.max()) if d.numel() else 0.0
    if not torch.equal(x, y):
        raise AssertionError(f"{what}: not bit-identical")
    return 0.0


def decode_cases(dev, rng, t: int, r: int):
    """(name, payload, row_valid) over every codec, at [t, r]."""
    import numpy as np
    import torch

    n = t * r
    rv = torch.ones((t, r), dtype=torch.bool, device=dev)
    rv.view(-1)[n - n // 7:] = False  # a pad tail, as a real last tile has
    cases = []
    for cdt, span in ((np.uint8, 200), (np.uint16, 60000), (np.uint32, 3_000_000_000)):
        codes = rng.integers(0, span, n).astype(cdt)
        view = {np.uint16: np.int16, np.uint32: np.int32}.get(cdt, cdt)
        p = torch.from_numpy(codes.view(view).reshape(t, r)).to(dev)
        cases.append((f"pack_{np.dtype(cdt).name}_i64", {"p": p, "b": torch.tensor(-123456789012, dtype=torch.int64)}, rv))
        if cdt is not np.uint32:
            cases.append((f"pack_{np.dtype(cdt).name}_i32", {"p": p, "b": torch.tensor(-70000, dtype=torch.int32)}, rv))
    big = torch.tensor(-(1 << 63) + 5, dtype=torch.int64)  # uint64 base bits: the add wraps
    cases.append(("pack_uint32_u64bits", {"p": p, "b": big}, rv))  # p: the uint32 codes
    for cdt, nv in ((np.uint8, 11), (np.uint16, 4096)):
        c = torch.from_numpy(rng.integers(0, nv, n).astype(cdt).view(
            {np.uint16: np.int16}.get(cdt, cdt)).reshape(t, r)).to(dev)
        for vdt, vocab in (("i64", torch.from_numpy(np.sort(rng.integers(-10**15, 10**15, nv)))),
                           ("f64", torch.from_numpy(np.sort(rng.standard_normal(nv)))),
                           ("i32", torch.from_numpy(np.arange(nv, dtype=np.int32) * 3 - 7))):
            cases.append((f"dict_{np.dtype(cdt).name}_{vdt}", {"c": c, "v": vocab.to(dev)}, rv))
    for vdt, vals in (("i64", rng.integers(-10**12, 10**12, 4095)), ("f64", rng.standard_normal(4095)),
                      ("bool", rng.random(4095) < 0.5)):
        lens = rng.integers(1, max(2, 2 * n // 4095), 4095).astype(np.int32)
        lens[-1] = 0  # the encoder's zero-length zero pad run
        vals = vals.copy()
        vals[-1] = 0
        cases.append((f"rle_{vdt}", {"rv": torch.from_numpy(vals).to(dev),
                                     "rl": torch.from_numpy(lens).to(dev)}, rv))
    cases.append(("alias", {}, rv))
    return cases


def seg_cases(dev, rng, n: int, nseg: int, all_masked: bool = False, overflow: bool = False):
    """(keys, lanes, mask) exercising every op with a code space of nseg."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels import SegKey, SegLane

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    mask = t(np.zeros(n, bool) if all_masked else rng.random(n) < 0.8)
    if nseg == 12:  # Q1's shape: two dict-code keys, domains 3 and 2, NULL-able
        keys = [SegKey(t(rng.integers(0, 3, n).astype(np.int32)), t(rng.random(n) < 0.95), 0, 3),
                SegKey(t(rng.integers(0, 2, n).astype(np.int32)), None, 0, 2)]
    elif nseg == 1:
        keys = []
    else:  # one int64 key, lo = 1000, domain nseg - 1
        keys = [SegKey(t(rng.integers(1000, 1000 + nseg - 1, n)), None, 1000, nseg - 1)]
    valid = t(rng.random(n) < 0.9)
    i64 = t(np.full(n, (1 << 62) + 12345) if overflow else rng.integers(-10**12, 10**12, n))
    u64 = t(rng.integers(0, 1 << 63, n).view(np.int64) | (rng.integers(0, 2, n) << 63))
    f64 = rng.standard_normal(n) * 1e3
    f64[:: 9973] = np.nan
    lanes = [SegLane("count"), SegLane("count", valid=valid),
             SegLane("sum_i64", i64, valid), SegLane("sum_f64", t(np.nan_to_num(f64)), valid),
             SegLane("min_i64", i64, valid, int(np.iinfo(np.int64).max)),
             SegLane("max_i64", i64, None, int(np.iinfo(np.int64).min)),
             SegLane("min_u64", u64, valid, (1 << 64) - 1), SegLane("max_u64", u64, valid, 0),
             SegLane("min_f64", t(f64), valid, float("inf")), SegLane("max_f64", t(f64), None, float("-inf")),
             SegLane("first_row", None, valid, n)]
    return keys, lanes, mask


def check_kernels(dev, rng) -> dict:
    import torch

    from tidb_tpu_torch.kernels import decode_lane, decode_lane_ref, seg_agg, seg_agg_ref

    from tidb_tpu_torch import kernels as K

    K.reset_launches()
    verdict = {"decode_lane": 0.0, "seg_agg": 0.0}
    shapes = [(T_MAIN, R_MAIN), (1, 256), (3, 1024)]
    ncase = 0
    for t, r in shapes:
        for name, enc, rv in decode_cases(dev, rng, t, r):
            got = decode_lane(enc, rv)
            want = decode_lane_ref(enc, rv)
            torch.cuda.synchronize()
            err = _same(got, want, f"decode_lane {name} [{t},{r}]", floats=got.is_floating_point())
            verdict["decode_lane"] = max(verdict["decode_lane"], err)
            ncase += 1
    for n, nseg, kw in ((T_MAIN * R_MAIN, NSEG_MAIN, {}), (T_MAIN * R_MAIN, NSEG_MAIN, {"overflow": True}),
                        (4096, 1, {}), (4096, 64, {}), (4096, 65, {}), (200_000, 65536, {}),
                        (4096, 12, {"all_masked": True})):
        keys, lanes, mask = seg_cases(dev, rng, n, nseg, **kw)
        gi, gf = seg_agg(mask, keys, lanes, nseg)
        wi, wf = seg_agg_ref(mask, keys, lanes, nseg)
        torch.cuda.synchronize()
        _same(gi, wi, f"seg_agg ints n={n} nseg={nseg} {kw}")
        verdict["seg_agg"] = max(verdict["seg_agg"], _same(gf, wf, f"seg_agg floats n={n} nseg={nseg} {kw}", True))
        ncase += 1
    launched = K.launches()
    return {"cases": ncase, "max_abs_err": verdict,
            "kernels": {k: {"verdict": "match", "max_abs_err": verdict[k], "launches": launched[k]}
                        for k in verdict}}


# --- phase 4: the main path ----------------------------------------------


def _used_encodings(mirror, dag) -> list:
    """The codec payloads K1 decodes for one run of `dag` (alias and
    dense lanes launch nothing)."""
    used: set = set()
    for c in dag.selection.conds:
        c.collect_columns(used)
    for g in dag.agg.group_by:
        g.collect_columns(used)
    for a in dag.agg.aggs:
        for e in a.args:
            e.collect_columns(used)
    return [enc for i in sorted(used) for enc in mirror.lanes(dag.scan.col_offsets[i])
            if isinstance(enc, dict) and enc]


def _decode_bytes(mirror, encs) -> int:
    """Bytes K1 must move: each encoded input read once (the pack base is
    a launch parameter), each dense output written once."""
    total = 0
    for enc in encs:
        total += sum(x.numel() * x.element_size() for k, x in enc.items() if k != "b")
        out = enc["b"] if "p" in enc else enc["v"] if "c" in enc else enc["rv"]
        total += mirror.padded * out.element_size()
    return total


def run_main_path(dev, rows: int, seed: int, reps: int, card: str) -> dict:
    import numpy as np
    import torch

    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.copr.host_engine import execute_dag_host
    from tidb_tpu_torch.entry import batch_from_numpy, run_query
    from tidb_tpu_torch.executor.final_agg import merge_partials, order_by_keys
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.torchenv import PhaseTimer

    t0 = time.perf_counter()
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(rows, seed))
    say("main.data", rows=rows, seed=seed, seconds=time.perf_counter() - t0)
    out = {}
    K.reset_launches()
    per_query = {}
    for qname, mk in (("q1", tpch.q1_dag), ("q6", tpch.q6_dag)):
        dag = mk()
        engine = TorchEngine(dev)
        before = K.launches()
        runs = []
        for rep in range(reps + 1):  # first run is cold: encode + h2d
            engine.timer = PhaseTimer(engine.device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run_query(dag, batch, device=dev, engine=engine)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t, engine.timer.totals_ms(), res))
        after = K.launches()
        per_query[qname] = {k: after[k] - before[k] for k in after}
        idle = [k for k, c in per_query[qname].items() if c == 0]
        if idle:
            raise AssertionError(f"{qname}: kernels {idle} were never launched")
        if engine.fallbacks:
            raise AssertionError(f"{qname}: {engine.fallbacks} host fallbacks on the main path")
        t = time.perf_counter()
        part = execute_dag_host(dag, batch)
        fts = [g.ret_type for g in dag.agg.group_by] + [a.ret_type for a in dag.agg.aggs]
        want = order_by_keys(merge_partials([part], dag.agg.group_by, dag.agg.aggs, fts),
                             dag.agg.group_by).to_pylist()
        host_s = time.perf_counter() - t
        for _, _, res in runs:
            if res.to_pylist() != want:
                raise AssertionError(f"{qname}: GPU answer differs from the host engine's\n"
                                     f"gpu:  {res.to_pylist()}\nhost: {want}")
        if qname == "q1" and not 1 <= len(want) <= 6:
            raise AssertionError(f"q1: {len(want)} groups")
        warm = sorted(runs[1:], key=lambda x: x[0])
        med = warm[len(warm) // 2]
        per_run = (sum(per_query[qname].values()) / (reps + 1))
        out[qname] = {
            "rows": rows, "groups": len(want), "cold_s": runs[0][0], "cold_phases_ms": runs[0][1],
            "warm_median_s": med[0], "warm_s": [r[0] for r in runs[1:]],
            "rows_per_s": rows / med[0], "phases_ms": med[1], "host_oracle_s": host_s,
            "launches_per_run": per_run, "launches": per_query[qname],
            "answer": want if len(want) <= 6 else want[:6], "card": card,
        }
        say(f"main.{qname}", **out[qname])
    counts = K.launches()
    for name, c in counts.items():
        if c == 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    out["launches"] = counts
    out["batch"] = batch
    return out


def measure(dev, main: dict, max_err: dict) -> list[dict]:
    """Each kernel on this run's Q1 inputs: held once more to its plain
    version on exactly those tensors, then timed beside the plain version
    and its bound (bytes over HBM rate). `max_err` carries the largest
    error of the phase-3 cases and is raised by these comparisons."""
    import torch

    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.kernels import decode_lane, decode_lane_ref, seg_agg, seg_agg_ref
    from tidb_tpu_torch.kernels.seg_agg import group_code
    from tidb_tpu_torch.models import tpch

    batch = main["batch"]
    dag = tpch.q1_dag()
    eng = TorchEngine(dev)
    captured = {}

    def spy(mask, keys, lanes, nseg):  # K4's inputs on Q1, as the engine builds them
        captured.update(mask=mask, keys=keys, lanes=lanes, nseg=nseg)
        return seg_agg(mask, keys, lanes, nseg)

    eng.seg_agg = spy
    eng.execute(dag, batch)
    mirror = batch._gpu_mirrors[(str(eng.device), True)]
    encs = _used_encodings(mirror, dag)
    rv = mirror.row_valid
    for e in encs:
        got, want = decode_lane(e, rv), decode_lane_ref(e, rv)
        torch.cuda.synchronize()
        err = _same(got, want, "decode_lane on Q1's lanes", floats=got.is_floating_point())
        max_err["decode_lane"] = max(max_err["decode_lane"], err)
    k1 = {
        "ms": time_ms(lambda: [decode_lane(e, rv) for e in encs]),
        "plain_ms": time_ms(lambda: [decode_lane_ref(e, rv) for e in encs]),
        "bytes": _decode_bytes(mirror, encs), "lanes": len(encs),
    }
    # K1's dict case alone (Q1's l_shipdate lane) beside the nearest single
    # PyTorch call: torch.take over the same codes widened to int64 once
    ship = mirror.lanes(dag.scan.col_offsets[10])[0]
    k1_dict = None
    if isinstance(ship, dict) and "c" in ship:
        wide = ship["c"].to(torch.int64) & 0xFFFF
        k1_dict = {"ms": time_ms(lambda: decode_lane(ship, rv)),
                   "torch_take_int64_codes_ms": time_ms(lambda: torch.take(ship["v"], wide))}
    m, keys, lanes, nseg = captured["mask"], captured["keys"], captured["lanes"], captured["nseg"]
    n = m.numel()
    k4_bytes = n + sum(k.data.numel() * k.data.element_size() + (n if k.valid is not None else 0) for k in keys)
    k4_bytes += sum((l.data.numel() * 8 if l.data is not None else 0) + (n if l.valid is not None else 0)
                    for l in lanes)
    k4_bytes += len(lanes) * nseg * 8
    sums = [l for l in lanes if l.op == "sum_i64"]
    seg = group_code(m, keys, nseg)
    stacked = torch.stack([l.data for l in sums], dim=1)
    acc = torch.zeros((nseg + 1, len(sums)), dtype=torch.int64, device=m.device)
    (gi, gf), (wi, wf) = seg_agg(m, keys, lanes, nseg), seg_agg_ref(m, keys, lanes, nseg)
    torch.cuda.synchronize()
    _same(gi, wi, "seg_agg ints on Q1's lanes")
    max_err["seg_agg"] = max(max_err["seg_agg"], _same(gf, wf, "seg_agg floats on Q1's lanes", True))
    k4 = {
        "ms": time_ms(lambda: seg_agg(m, keys, lanes, nseg)),
        "plain_ms": time_ms(lambda: seg_agg_ref(m, keys, lanes, nseg), reps=3),
        "bytes": k4_bytes,
        # nearest single PyTorch call: index_add_ of the stacked sum lanes
        # given precomputed segment ids (not the same inputs: no mask/key
        # decode, no count/min/max lanes)
        "index_add_stacked_sums_ms": time_ms(lambda: acc.zero_().index_add_(0, seg, stacked)),
        "lanes": len(lanes), "nseg": nseg, "rows": n,
    }
    say("measure", decode_lane=k1, decode_lane_dict=k1_dict, seg_agg=k4)
    return [
        {"name": "decode_lane", "route": "cuda", "source": "tidb_tpu_torch/csrc/decode_lane.cu",
         "replaces": "tidb_tpu/copr/tpu_engine.py:1169", "launches": main["launches"]["decode_lane"],
         "max_abs_err": max_err["decode_lane"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bytes"] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None},
        {"name": "seg_agg", "route": "cuda", "source": "tidb_tpu_torch/csrc/seg_agg.cu",
         "replaces": "tidb_tpu/copr/tpu_engine.py:1287", "launches": main["launches"]["seg_agg"],
         "max_abs_err": max_err["seg_agg"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bytes"] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None},
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    try:
        from tidb_tpu_torch.kernels.build import build_all, last_build
    except ImportError as e:
        return fail(f"the tidb_tpu_torch package is not beside this script ({e})")
    try:
        dev = "cuda"
        name = torch.cuda.get_device_name(0)
        card = card_line()
        say("device", name=name, count=torch.cuda.device_count(), nvidia_smi=card,
            torch=torch.__version__, cuda=torch.version.cuda)
        t = time.perf_counter()
        build_all()
        regs = {}
        for src, log in last_build.get("ptxas", {}).items():
            used = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
            regs[src] = {"kernels": len(used), "max_registers": max(used, default=0),
                         "spill_store_bytes": sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))}
        say("build", seconds=time.perf_counter() - t, compiled=last_build.get("compiled"), ptxas=regs)
        rng = np.random.default_rng(args.seed)
        checked = check_kernels(dev, rng)
        say("kernels", **checked)
        main_res = run_main_path(dev, args.rows, args.seed, args.reps, card)
        kernels = measure(dev, main_res, checked["max_abs_err"])
    except Exception as e:  # noqa: BLE001 — the script's boundary: report and fail
        import traceback

        traceback.print_exc()
        return fail(f"{type(e).__name__}: {e}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
