#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tidb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows 16000000] [--win-rows 8000000] [--q3-rows 4000000]
                          [--seed 42] [--reps 3]

Phases, one line each; any failure exits non-zero and prints no result:

 1. device  — torch's device name, and the card's name and power limit
              as nvidia-smi reports them;
 2. build   — compiles every CUDA kernel of the port from csrc/ (nvcc,
              sm_90a, one process per source, all at once) into
              build/kernels/ and reports the seconds;
 3. kernels — every kernel against its plain PyTorch version on the card,
              at the main path's shapes (T=245, R=65536) and edge shapes:
              K1 decode_lane over every codec (a vocab past its shared
              memory among them), and its many-lane calls
              (decode_many_cases: every codec, code width and value
              width in one launch, odd row counts, codes at unaligned
              addresses, past its by-value tiers into its pinned table;
              the task mode over up to 64 tasks' mixed lanes at odd
              widths); K4 seg_agg over every op
              (nseg 1..65536) and in its segment-lane mode at nseg
              4,194,304; K8 lex_sort over every operand kind, ties and a
              key wider than 64 bits, a 26-bit word (4-byte keys), a
              48-bit one and a 2-bit key of ties, at n = 1, 5, a tile
              (4,096 rows of 8-byte keys, 6,144 of 4-byte ones) less one,
              at it and plus one, 100,000 and the main path's 16M; K6
              topk with NULLs, masked rows, ties past a tile, the int64
              limits, signed zeros, NaNs and ±inf, k = 1, k = N, every
              row tied, k at K6's ordering cap (4,096) and one past it
              (K8 orders those); K7 topn_multi over every key kind
              (NULLs, both orders, ±0.0, NaN, subnormals, uint64), all
              rows masked, fewer masked in than k, every key tied, k =
              1, 50, its ordering cap (4,096), one past it (K8 orders
              those) and past n; K9 sort_groups with
              NULL-able, float (NaN, ±0.0, subnormals), uint64 and
              dict-code keys, all rows masked, every row and one row
              masked in, keys K8 sorts in several words (the sweep
              compares operands), a constant key (no word) and a capacity
              below n_groups; W1 window over every
              window function under every frame kind (default, ROWS
              offsets, unbounded, RANGE offsets ASC/DESC with NULL keys,
              empty frames), uint64 and float arguments with NaN and
              ±0.0, an overflowing int64 sum, P = 1024 with n = 1 and
              P = 2^23, and the edges of its sorted-order design
              (window_edge_battery: one partition of all rows,
              single-row partitions, partitions and peer groups crossing
              2,048-row tiles, LAG / LEAD offsets past a tile, ROWS min /
              max frames of 201 and 3,011 rows (the sparse table), P
              below a tile); W2 pack_flat over every lane kind and bool
              lengths that are not a multiple of 64; P3 lut_join with
              NULL and out-of-domain probe keys, absent LUT slots, a
              two-key LUT and a build mask that drops rows; P7 run_agg
              with an int64 lane whose prefix overflows, float lanes (one
              with NaN and ±inf, at rows 0 and L - 1 too, and -0.0 runs),
              one giant run, a run over every tile, runs of one row, runs
              ending on tile edges, a pad tail, ascending order and 16
              lanes; P9 block_topk with ties, ±0.0, NaN, fewer scores
              than k, n not a multiple of 1024 and n = 2^22, and the edges
              of its two launches (TOPK_EDGE_SHAPES: equal keys, sorted
              lanes, every winner in one chunk, winners tied across chunk
              edges, NaN / ±0.0 / ±inf, the int64 floor, n = 1, 1023,
              1024, 1025 and kk x 1024 ± 1, kk 1, 16 and 512); P4 sort_join
              (sort_join_battery) with unique and duplicate build keys,
              inner and left, two keys, int32 keys (left joins too),
              keys at the sort sentinel, a capacity below the output,
              95% / all / no rows masked (4M probes into 1M build rows
              among them), one key owning more than an expansion tile of
              slots; P5 seg_reduce (seg_reduce_battery) with overflowing
              int64, NaN, ±inf and uint64 lanes, one giant run, fewer
              groups than k, 95% / all / no rows masked (4M rows among
              them), valid codes at the sentinel, more picks than valid
              rows, NaN and floor scores, and its local and final reduces
              over n_dev 2, 3, 4 and 8 ranks (every group arriving from
              n_dev peers); P6 rowpos_agg
              (rowpos_battery) with a dedicated presence lane, fewer
              matched rows than k, B = 1,000,000, B = 1, valid scores at
              and below the floor (integer and float; every build row
              picked, past K6's ordering cap too), and its picks from one
              rank's block of build rows (n_dev 3, 4, 8; the last block
              ragged, a block of one row); P2 exchange (exchange_battery) at n_dev 2, 3, 4, 5, 7,
              8 and 64 with negative keys, NULL keys of a probe side, an
              int32 key, most rows masked, one owner past its bucket, 1M
              rows, fewer rows than a tile, 46 lanes of 8, 4 and 1 bytes
              (15 of them 1-byte), and calls whose send buffer's memory
              was filled with garbage first; P8 dense_agg
              (dense_battery) with dict and int keys, keys above 2^31,
              keys outside their domain (codes below 0, at and past nseg)
              and 2^31 away (wrapping int32 codes), the shared-memory and
              the global path, no key (nseg 1), n = 0, NaN and ±inf
              floats, uint64 min / max, into the packed result's rows at
              widths nseg, nseg + 2 and nseg + 37 (nothing written past
              nseg), and every rank's call of the mesh's seg_revenue; K2/K3
              expr_eval (expr_cases) on identical programs through the
              kernel and its plain version: seeded random trees over every
              device builtin and every lane kind (int64 limits, uint64 above
              2^63, float64 NaN / ±inf / ±0.0 / subnormals, decimals at
              scales 0..12 with a capped product, dates, int32 codes with
              -1, NULL rows; NULL, BIGINT UNSIGNED and float literals),
              every derivation (values, valid lanes, var / stddev limbs,
              bitwise rints with their edges), a 300-deep chain, a program
              past its register budget (lanes reloaded), one holding 120
              lanes (a smaller block, its pointer table in device memory),
              N not a multiple of the block, and the edges of the
              interpreter's design (expr_edge_cases: n of 1, 2 and 3,
              below the 4 rows a thread takes, and not a multiple of 4 x
              a block; a program at REG_BUDGET that reloads its lanes;
              programs that together hold every opcode, directed_trees'
              every op of the extended instantiation also in K10's task
              mode); K4 at the edges
              of its design (seg_edge_cases: nseg 1 with every row in one
              slot, in the register and the warp modes; a warp's 128 rows
              in one segment and in 32; NaN and ±inf among peers; int64
              sums that wrap in one warp's fold; first_row with NULL
              peers; n of 1 to a grid-stride past the card; the last
              block's merge over 1 to 528 partials; the task grid with
              ragged tasks and its shared outputs); K4's bitwise ops
              (bitwise_seg_cases) in the direct and segment-lane modes at
              nseg 1, 64, 65 and 65536 with empty segments; M1 q1_local
              with wrapping products and codes out of range, nseg 6 / 8 /
              12, and at the edges of its staged design (q1_edge_shapes:
              row views starting at every offset 0-15 modulo 16 bytes,
              the lanes' alignments mixed; n of 0, 1, a tile less one, a
              tile, a tile and one, a tile past the grid's first sweep,
              several sweeps; nseg 1-8 and 9); M3 hash_repartition
              (repartition_battery) with negative keys, all rows invalid,
              a cap below the largest bucket and the last owner at its
              cap, n at the tile edges, n_dev 1, 2, 3, 4, 31 and 1,024; K10, the task-grid
              modes of K1, the expression kernel and K4 (grouped_cases),
              against the solo plain versions task by task on narrowed
              inputs: every codec, random programs and a 241-lane one,
              every K4 op with the bitwise ones and an all-masked task, G
              1, 2, 3 and 64, single- and multi-tile groups at the padded
              and a narrowed width; and K10's sort modes
              (sort_grouped_cases): K6's task grid (int64 keys at
              INT64_MIN / INT64_MAX - 1, floats with NaN, ±inf, ±0.0 and
              subnormals, NULL keys, both orders, k up to the
              width), K7's (every key kind, uint64; k = 1, 50 and past
              the width),
              K9's (NULL-able int and float, uint64 and dict-code keys,
              group counts that differ by task) with K4's segment-lane
              form over its ids, and K8's task-leading key alone (every
              operand kind, ties, a key wider than 64 bits), tasks of
              different real row counts, one all masked; and K6's, K7's
              and K8's task modes at the edges of their designs
              (sort_edge_cases: G = 1, 7 and 64 tasks of 1,000, 4,095,
              4,097 and 6,145 rows; 4- and 8-byte words, ties; k = 1,
              50 or 100, the cap, one past it and the width). Integers, row ids and
              group ids bit-exact, floats within rtol 1e-9 / atol 1e-6
              (bench.py's own check; P5's and P7's float totals at run
              starts, the rows the picks can ship); all cases run,
              failures are raised together;
 4. main path — generates lineitem (--rows, seed --seed) with the port's
              generator and runs through run_query on "cuda": TPC-H Q1
              and Q6, tpch_topn (ORDER BY l_extendedprice DESC LIMIT 100),
              multikey_topn (ORDER BY l_extendedprice DESC, l_orderkey,
              l_linenumber LIMIT 50), Q18's subquery (GROUP BY
              l_orderkey), CHECKSUM (BIT_XOR / BIT_OR / BIT_AND per
              l_returnflag: K4's bitwise ops), FN_MIX and FN_MATH (the
              builtins past arithmetic: the expression kernel's extended
              instantiation); holds every run's answer to the port's host
              engine plus the same root step on the same data (exact, in
              order; FN_MIX's and FN_MATH's doubles to the port's engine
              on the CPU within rtol 1e-9), requires each query's kernels' launch counters to
              have moved during its runs, and reports rows/s, the median
              of --reps warm runs and a per-phase split timed with CUDA
              events; then the two window queries of models/tpch.py
              (window_sum_partition, bench.py's SQL, and
              window_rank_frames) over lineitem at --win-rows through
              run_window on "cuda": one cold run (host prep + upload)
              and --reps warm runs (the device-input cache), each held
              exactly, in row order, to the port's host route
              (mode="host"), with the scan / prep / h2d / sort / window /
              pack / d2h / finalize split and one profiled run's idle
              share; then TPC-H Q3 and Q10 through run_mpp on "cuda"
              over lineitem at --q3-rows (bench.py's BENCH_Q3_ROWS),
              orders = rows/4, customers = orders/10 (tpch's
              generated_columns, seed --seed), and at the same scale
              Q18 (a duplicate-key sort-probe level, P4, in rows mode: the
              host aggregates ~4M joined rows, then HAVING and the TopN),
              Q3 with tidb_tpu_mpp_fused OFF (q3_unfused: two unique-key
              sort-probe levels, P4, and the sorted aggregation, P5), Q3
              LIMIT 100 (q3_top100: the rowpos aggregation, P6) and
              SEG_REVENUE (seg_revenue: the dense aggregation, P8): one
              cold run (host prep + h2d) and --reps warm runs (which must
              upload nothing), each answer equal in order to the port's
              engine on the CPU (the plain versions) and to a numpy
              oracle of the query, with the scan / join / aggregation /
              d2h / finalize split and one profiled run's idle share;
              then main.mpp_mesh: Q3, q3_unfused, q3_top100, seg_revenue
              and Q18 over make_mesh(4, "cuda") — four ranks sharing the
              card, collectives through gloo — over the same tables: P2 at
              every HASH sort-probe level (q3_unfused, Q18) and between
              P5's reduces, P6's psum_scatter, P8's all-reduce, P7 + P9 per
              run-aligned shard; every answer equal in order to the
              one-device chunk, the mode asserted, nothing dropped, P2
              launched, with cold and warm walls (Q18 one warm run), the
              collectives' host time, P2's time against its bound and one
              profiled run's idle share per query;
              then the mesh (main.mesh): entry()'s M1 step on its 4096
              example rows, exact against the plain version and a numpy
              recompute, and dryrun_multichip(1) over the --rows lineitem
              already generated (M1 + the identity all_reduce, exact
              against a numpy recompute; M3 + the identity all_to_all,
              nothing dropped, the payload's sum kept); then the grouped
              cop launches: main.burst, tools/bench_sched.py's workload
              (64 point aggregations of 4,096 rows, compression ON and
              OFF) through serial execute, unbatched execute from 64
              threads, run_many (one gcap-64 group, one fetch) and
              run_burst (64 threads through the LaunchBatcher), every
              chunk bit-identical to the serial one and the host
              engine's, with per-task p50 / p99 latencies, launches per
              task and fetches per call, no batcher group falling back
              to solo execute, and one profiled run_many and run_burst
              each (the card's busy time and idle share); and
              main.store: the --rows lineitem bulk-ingested into the
              port's store (models/tpch.bulk_load: the columnar run,
              idx_ship's index run, the split into 8 regions of 7 x
              2,097,152 and 1,319,936 rows at the handles' record keys),
              with the ingest's seconds and rows/s, then one
              TileCache.get_batch per region, cold (the columnar gather,
              seconds per region) and warm (hits, the same batches);
              main.q1_regions, Q1 over the
              store's region batches
              through run_many (the full regions one group, K10 at full
              width), merged at the root and equal to main.q1's answer;
              each task mode must launch; main.regions_sorted, tpch_topn,
              multikey_topn and Q18's subquery over the same regions
              through run_many (K6's and K7's task modes, K9's with K8's
              task-leading key, Q18's escalating from gcap0 inside its
              group), merged at the root (the TopN over the partial rows;
              the final aggregation) and equal to the one-batch answers,
              with one fetch a run and the sort kernels launched solo only
              for the short region; main.store.htap, one Txn through
              table.Table over that store (l_discount changed on 5,000
              rows of region 2, 5,000 rows of region 5 deleted, 5,000
              rows inserted into region 8): the next get_batch rebuilds
              exactly those three regions, merging the committed rows
              after the runs' kept rows, and keeps the other five and
              their device lanes; Q1 and Q18's subquery over the new
              batches through run_many equal the port's host engine over
              the same batches, their first rerun uploading only the
              rebuilt regions' lanes (every other region's device tensors
              the same objects) and the second nothing; before it,
              main.store.turns times Q1 and tpch_topn over the store's
              batches and over region_batches' cut of the one batch in
              alternating turns; the burst also runs the point TopN
              and multi-key TopN mixes (64 x 4,096 rows), with no solo
              K6 / K7 / K8 / K9 inside run_many's group, and both at a
              LIMIT past the narrowed width (8 tasks, LIMIT 8,192: every
              row kept, equal to serial execute and the host engine's,
              the task mode launched once). expr_eval must
              launch in every query with a condition, a computed argument
              or a filter program (Q1, Q6, CHECKSUM, FN_MIX, FN_MATH, both
              window scans, Q3, q3_unfused, q3_top100, seg_revenue);
 5. measure — each kernel on the main path's own inputs: held once more to
              its plain version, then timed beside it, its bytes bound and
              the nearest single PyTorch call where there is one (K1 on
              Q1's coded lanes as one call, as the engine's _decode makes
              it, one call a lane beside it; W1 over
              each window's own sort, computed once, so K8 stays out of
              its time, with its launches per call and its time per inner
              kernel from one profiled call); expr_eval on Q1's,
              Q6's, CHECKSUM's, FN_MIX's, FN_MATH's, Q3's and unfused
              Q3's own programs, K4's
              bitwise ops on CHECKSUM's lanes, K4 on Q1's, Q6's,
              CHECKSUM's and Q18's subquery's own lanes (the call, its
              kernel alone over a table built beforehand, the plain
              version, the bound, the launch plan), P5's and P6's mesh
              calls with the K8 and K6 calls inside P5 timed apart and
              K4's and K6's kernels inside P6 by their device time in one
              profiled call (P6 launches them over its one upload's
              tables; its one-device call likewise), P8's call on
              SEG_REVENUE and its largest mesh rank call (the call, its
              enqueue time, its device time and launches from one
              profiled call), P2 on main.mpp_mesh's
              largest exchange (the unfused Q3's second level), M1 and M3
              (their warm
              medians and rows/s) on the mesh phase's lineitem, K10's
              three task modes on the burst's and Q1 regions' own groups
              (K1's a decode_lanes_tasks call: a group's every coded lane)
              beside the solo kernels launched G times on the same
              tensors, and their launches alone over task tables built
              beforehand (the rest of a call's time is the host's); the
              sort modes (K6, K7, K8, K9 and K4's segment-lane form) on
              the regions' and the TopN bursts' own groups, with
              torch.topk over the [G, width] key and a batched stable
              torch.sort of one packed word as K6's and K8's yardsticks;
              K9's yardstick is torch.unique over the packed word of the
              operands it hands K8, and K9's, P4's and P5's K8 share is
              timed alone (`k8_ms`); P4, P5 and P7 have no single call
              that computes their function (library_ms null; the calls
              that do part of it are reported under their own names);
 6. the kernels JSON line, the card line, and last the result line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Without a CUDA device, or run from a directory without the repository,
it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet (700 W)
RTOL, ATOL = 1e-9, 1e-6
DECODE_VOCAB_SMEM = 32 * 1024  # bytes: K1 keeps a dict vocab up to this in shared memory (csrc's VOCAB_SMEM)
DECODE_RPT = 32  # rows a K1 thread decodes an item (csrc's RPT)
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


def median_ms(fn, reps: int = 10) -> float:
    """Median device time of single fn() calls (CUDA events around each),
    after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


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
    # a vocab past K1's shared memory (DECODE_VOCAB_SMEM bytes), read through the cache; codes past it clamp
    nv = DECODE_VOCAB_SMEM // 8 + 1000
    c = rng.integers(0, nv + 5, n).astype(np.uint32).view(np.int32).reshape(t, r)
    cases.append(("dict_uint32_i64_big", {"c": torch.from_numpy(c).to(dev),
                                          "v": torch.from_numpy(rng.integers(-10**15, 10**15, nv)).to(dev)}, rv))
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


def _offset_view(x, k: int):
    """x's values in a contiguous view that starts k elements into a larger
    buffer: an address no 16-byte load of K1 lines up with."""
    import torch

    buf = torch.empty(x.numel() + k, dtype=x.dtype, device=x.device)
    buf[k:].copy_(x.reshape(-1))
    return buf[k:].view(x.shape)


def _mixed_lanes(dev, rng, t: int, r: int, shift: int = 0):
    """Every codec of decode_cases at [t, r] and a dense lane; with
    `shift`, the pack and dict codes as views `shift` elements into their
    buffers."""
    import torch

    lanes = []
    for _, enc, _ in decode_cases(dev, rng, t, r):
        if shift and enc:
            key = "p" if "p" in enc else "c" if "c" in enc else None
            if key is not None:
                enc = {**enc, key: _offset_view(enc[key], shift)}
        lanes.append(enc)
    lanes.append(torch.from_numpy(rng.integers(-10**9, 10**9, (t, r))).to(dev))
    return lanes


DECODE_MANY = ((1, 1000, 0, 1), (3, 777, 3, 1), (2, 4099, 1, 4), (1, 1000, 0, 33))  # (t, r, code shift, copies)
DECODE_MANY_TASKS = ((3, 1, 1001, 0), (64, 1, 700, 1), (7, 3, 3 * 256 + 5, 2))  # (G, tiles, width, code shift)


def decode_many_cases(dev, rng):
    """(name, fn) of K1's many-lane calls against the plain version lane by
    lane, bit for bit: decode_lanes over every codec (code widths 1, 2, 4;
    values 1, 4, 8 bytes; a vocab past shared memory), the alias and a
    dense lane at odd row counts, codes at unaligned addresses, and copies
    of the lanes enough to pass the by-value tiers (33 copies: past 500
    entries, the pinned table); decode_lanes_tasks over G tasks' mixed
    lanes at odd widths (unaligned output rows), up to 64 tasks (past 500
    entries)."""
    import torch

    from tidb_tpu_torch.kernels import decode_lane_ref, decode_lanes
    from tidb_tpu_torch.kernels.grouped import decode_lanes_tasks

    cases = []
    for t, r, shift, copies in DECODE_MANY:
        rv = torch.ones((t, r), dtype=torch.bool, device=dev)
        rv.view(-1)[t * r - 5:] = False
        encs = [e for _ in range(copies) for e in _mixed_lanes(dev, rng, t, r, shift)]

        def k1(encs=encs, rv=rv):
            got, err = decode_lanes(encs, rv), 0.0
            for j, (g, e) in enumerate(zip(got, encs)):
                want = decode_lane_ref(e, rv)
                err = max(err, _same(g, want, f"lane {j}", floats=want.is_floating_point()))
            return err
        cases.append((f"decode_lane many {len(encs)} lanes [{t},{r}] shift={shift}", k1))
    for G, t, w, shift in DECODE_MANY_TASKS:
        r = max(-(-w // t), 256)
        rvs = [_task_row_valid(dev, rng, t, r, w) for _ in range(G)]
        per_task = [_mixed_lanes(dev, rng, t, r, shift) for _ in range(G)]
        lanes = [[task[k] for task in per_task] for k in range(len(per_task[0]))]

        def k10(lanes=lanes, rvs=rvs, w=w):
            got, err = decode_lanes_tasks(lanes, rvs, w), 0.0
            for k, (outs, encs) in enumerate(zip(got, lanes)):
                for g, (o, e, rv) in enumerate(zip(outs, encs, rvs)):
                    want = decode_lane_ref(_cut_enc(e, w), _cut(rv, w)).reshape(-1)
                    err = max(err, _same(_cut(o, w), want, f"lane {k} task {g}", floats=want.is_floating_point()))
            return err
        cases.append((f"decode_lane_tasks many G={G} {len(lanes)} lanes w={w} shift={shift}", k10))
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


SORT_CASES = ("multikey_topn", "floats_codes", "wide_u64_i64", "all_equal", "one_bit_ties", "word32", "word64",
              "ties")


def sort_cases(dev, rng, n: int, names=SORT_CASES):
    """(name, K8 operands) over every operand kind, ties and a key wider
    than one 64-bit word; 'word32' packs into one word of 26 bits (4-byte
    keys, and 32 bits with the task field of 64 tasks), 'word64' into one
    of 48 bits (8-byte keys), 'ties' is a 2-bit key (one pass, every row
    tied with a quarter of the others)."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels import SortOp

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    specials = np.array([-np.inf, -1.5, -0.0, 0.0, 1.5, np.inf, np.nan, -np.nan, 2.5e-308])
    i64 = lambda lo, hi: SortOp(t(rng.integers(lo, hi, n, dtype=np.int64)), "i64")  # noqa: E731
    full = lambda: i64(-(1 << 63), (1 << 63) - 1)  # noqa: E731

    def multikey():
        zero = t(np.zeros(n, np.int32))
        return [SortOp(t((rng.random(n) < 0.02).astype(np.int32)), "i32"), SortOp(zero, "i32"),
                SortOp(t(~rng.integers(90000, 10500000, n)), "i64"), SortOp(zero, "i32"),
                SortOp(t(np.sort(rng.integers(1, max(n // 4, 2), n))), "i64"), SortOp(zero, "i32"),
                SortOp(t(rng.integers(1, 8, n)), "i64")]

    build = {
        "multikey_topn": multikey,
        "floats_codes": lambda: [SortOp(t(rng.integers(-2, 2, n).astype(np.int32)), "i32"),
                                 SortOp(t(rng.choice(specials, n)), "f64")],
        "wide_u64_i64": lambda: [SortOp(t(rng.integers(0, 4, n)), "u64"), SortOp(full().data, "u64"), full(), full()],
        "all_equal": lambda: [SortOp(t(np.full(n, 7, np.int64)), "i64")],
        "one_bit_ties": lambda: [SortOp(t(rng.integers(0, 2, n).astype(np.int32)), "i32")],
        "word32": lambda: [SortOp(t(rng.integers(0, 1 << 10, n).astype(np.int32)), "i32"), i64(0, 1 << 16)],
        "word64": lambda: [i64(0, 1 << 30), i64(-(1 << 17), 1 << 17)],
        "ties": lambda: [i64(0, 4)],
    }
    return [(name, build[name]()) for name in names]


def topk_cases(dev, rng, n: int):
    """(name, (data, valid, mask, desc, k)) for K6: the main path's key and
    the edges — NULLs, masked rows, ties past one tile, the int64 limits,
    signed zeros and NaNs, ±inf, k = 1, k = N, every row tied, and k at
    the kernel's ordering cap and one past it (K8 orders those)."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels.topk import ORDER_CAP

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    i64 = np.iinfo(np.int64)
    m_all = np.ones(n, bool)
    m_all[n - n // 7:] = False  # a pad tail
    m_rand = rng.random(n) < 0.7
    v_rand = t(rng.random(n) < 0.9)
    price = t(rng.integers(90000, 10500000, n))
    specials = t(rng.choice(np.array([-np.inf, -1.5, -0.0, 0.0, 1.5, np.inf, np.nan, -np.nan]), n))
    limits = t(rng.choice(np.array([i64.min, i64.min + 1, -1, 0, 1, i64.max - 1, i64.max]), n))
    k = min(100, n)
    cases = [("price_desc", (price, None, t(m_all), True, k)), ("price_asc", (price, None, t(m_all), False, k)),
             ("price_nulls_asc", (price, v_rand, t(m_rand), False, min(1000, n)))]
    for desc in (True, False):
        cases += [(f"float_specials_{desc}", (specials, v_rand, t(m_rand), desc, min(5000, n))),
                  (f"int64_limits_{desc}", (limits, v_rand, t(m_rand), desc, min(5000, n)))]
    cases += [("all_masked", (price, None, t(np.zeros(n, bool)), True, min(50, n))),
              ("all_equal_ties", (t(np.full(n, 3, np.int64)), None, t(m_all), True, min(5000, n))),
              ("k_is_n", (price, v_rand, t(m_rand), False, n)),
              ("k_1", (price, v_rand, t(m_rand), True, 1)),
              ("every_row_tied", (t(np.full(n, -7, np.int64)), None, t(np.ones(n, bool)), False, min(100, n))),
              ("float_specials_k100", (specials, v_rand, t(m_rand), True, min(100, n)))]
    if n > ORDER_CAP:  # the kernel orders k up to its cap, K8 above it
        cases += [("k_at_cap", (price, v_rand, t(m_all), True, ORDER_CAP)),
                  ("k_cap_plus_1", (specials, v_rand, t(m_rand), False, ORDER_CAP + 1))]
    return cases


MULTI_CASES = ("mixed", "tied", "all_masked", "few_in", "nulls")


def multi_cases(dev, rng, n: int, names=MULTI_CASES):
    """(name, mask, keys) for K7: every key kind (int32, int64, uint64,
    floats with ±0.0, NaN, ±inf and subnormals), NULLs and both orders
    ('mixed'); every key tied, so the row id decides ('tied'); every row
    masked; three rows masked in, fewer than k; mostly NULL keys, in
    classes K7 picks ('nulls')."""
    import numpy as np
    import torch

    from tidb_tpu_torch.expr.xp_torch import U64

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    v = t(rng.random(n) < 0.9)
    specials = rng.choice(np.array(F_SPECIALS), n)
    mixed = [(t(rng.integers(90000, 10500000, n)), None, True),
             (t(rng.integers(0, 5, n).astype(np.int32)), v, False),
             (t(specials), v, True),
             (U64(t(rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64))), None, False),
             (t(rng.integers(-5, 5, n)), v, True)]
    tied = [(t(np.full(n, 7, np.int64)), None, False), (t(np.full(n, -0.0)), None, True)]
    few = np.zeros(n, bool)
    few[rng.choice(n, min(3, n), replace=False)] = True
    thin = t(rng.random(n) < 0.2)
    build = {"mixed": lambda: (t(rng.random(n) < 0.8), mixed), "tied": lambda: (t(np.ones(n, bool)), tied),
             "all_masked": lambda: (t(np.zeros(n, bool)), mixed[:3]), "few_in": lambda: (t(few), mixed[1:4]),
             "nulls": lambda: (t(rng.random(n) < 0.9), [(t(rng.integers(0, 3, n)), thin, False),
                                                        (t(specials), thin, True)])}
    return [(name, *build[name]()) for name in names]


# K7's k: one row, the main path's LIMIT 50, its ordering cap for up to
# 5 keys, one past it (measure_sort_kernels checks the cap with the library)
MULTI_KS = (1, 50, 4096, 4097)


def group_cases(dev, rng, n: int):
    """(name, mask, keys, cap) for K9: NULL-able, float (±0.0, NaN), uint64
    and dict-code keys; an all-masked batch; a capacity below n_groups; and
    the edges of the compacted design — keys K8 sorts in more than one word
    (the sweep gathers each operand), with and without a cap below
    n_groups, every row masked in, one row masked in, a key constant over
    the rows (K8 sorts nothing), subnormal and NaN float keys; and 34 keys
    of every kind (each a row of the kernels' key table), with and without
    a cap below n_groups."""
    import numpy as np
    import torch

    from tidb_tpu_torch.expr.xp_torch import U64

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    mask = t(rng.random(n) < 0.8)
    v = t(rng.random(n) < 0.9)
    orderkey = t(np.sort(rng.integers(1, max(n // 4, 2), n)))
    fl = t(rng.choice(np.array([-0.0, 0.0, 1.5, -2.5, np.nan, np.inf]), n))
    u = U64(t(rng.integers(0, 3, n) + (1 << 62) * rng.integers(-2, 2, n)))
    codes = t(rng.integers(0, 7, n).astype(np.int32))
    wide = t(rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64) >> rng.integers(0, 62, n))
    sub = t(rng.choice(np.array([5e-324, -1e-310, 2.2250738585072014e-308, -0.0, 0.0, np.nan, -np.nan, 7.5]), n))
    one = np.zeros(n, bool)
    one[rng.integers(0, n)] = True
    base = rng.integers(0, 8, n)
    many = [(t(((base * (j + 1)) % (j + 2)).astype(np.int32)) if j % 3 == 0 else
             t(((base * (j + 1)) % (j + 2)) - 0.5) if j % 3 == 1 else t((base * (j + 1)) % (j + 2)),
             v if j in (5, 20) else None) for j in range(34)]
    return [("q18_orderkey", t(np.ones(n, bool)), [(orderkey, None)], None),
            ("nullable_int_float", mask, [(t(rng.integers(0, 50, n)), v), (fl, v)], None),
            ("u64_codes", mask, [(u, None), (codes, v)], None),
            ("all_masked", t(np.zeros(n, bool)), [(orderkey, v)], None),
            ("capped", mask, [(orderkey, None)], 4),
            ("wide_keys", mask, [(wide, v), (fl, None)], None),
            ("wide_capped", mask, [(wide, None), (codes, v)], 3),
            ("none_masked_wide", t(np.ones(n, bool)), [(wide, v)], None),
            ("one_masked_in", t(one), [(orderkey, v), (fl, v)], None),
            ("constant_key", mask, [(t(np.full(n, 7, np.int64)), None)], None),
            ("subnormal_nan", mask, [(sub, v)], None),
            ("many_keys", mask, many, None),
            ("many_keys_capped", mask, many, 3)]


def gcap_escalation(ng: int, cap: int = 1 << 16) -> int:
    """The engine's group capacity for n_groups from gcap0 (x4 steps)."""
    while cap < ng:
        cap <<= 2
    return cap


def _same_groups(g, w, what: str) -> None:
    if (g.n_groups, g.cap) != (w.n_groups, w.cap):
        raise AssertionError(f"{what}: n_groups/cap {g.n_groups}/{g.cap} vs {w.n_groups}/{w.cap}")
    for name in ("perm", "seg", "kval", "kvalid"):
        _same(getattr(g, name), getattr(w, name), f"{what} {name}")


def win_lanes(rng, n: int) -> dict:
    """Window argument and key lanes (numpy): NULLs, duplicate and negative
    keys, floats with NaN and ±0.0, uint64 values above 2^63, an int64
    lane whose prefix sum overflows."""
    import numpy as np

    def valid(p):
        return rng.random(n) >= p

    floats = rng.standard_normal(n) * 100
    floats[rng.random(n) < 0.03] = np.nan
    floats[rng.random(n) < 0.03] = 0.0
    floats[rng.random(n) < 0.03] = -0.0
    return {
        "g": (rng.integers(0, 7, n), valid(0.1)),
        "h": (rng.integers(0, 3, n).astype(np.uint64) * np.uint64(1 << 62), np.ones(n, bool)),
        "o": (rng.integers(-40, 40, n), valid(0.1)),
        "fk": (np.round(floats / 50), valid(0.05)),
        "i": (rng.integers(-10**6, 10**6, n), valid(0.2)),
        "big": (np.full(n, (1 << 62) + 12345, np.int64) * rng.choice([1, -1], n), valid(0.1)),
        "f": (floats, valid(0.15)),
        "u": (rng.integers(0, 1 << 63, n, dtype=np.int64).view(np.uint64)
              | (rng.integers(0, 2, n).astype(np.uint64) << np.uint64(63)), valid(0.15)),
        "code": (rng.integers(0, 5, n), valid(0.1)),
    }


def window_battery(lanes, desc: bool):
    """(part, order, fspecs, range_lane): every window function under every
    frame kind over one integer ORDER BY key with NULLs, ASC or DESC."""
    import numpy as np

    def f(static, args=(), frame=None, post=None):
        return {"name": static[0], "static": static, "args": list(args), "post": post, "frame": frame}

    L, d = lanes, desc
    o = L["o"]
    n = len(o[0])
    vocab = np.array(["aa", "bb", "cc", "dd", "ee"])
    fs = [
        f(("row_number",)), f(("rank",)), f(("dense_rank",)), f(("ntile", 3)),
        f(("cume_dist",), post=("cume_dist",)), f(("percent_rank",), post=("percent_rank",)),
        f(("lead", 2, False), [L["i"]]),
        f(("lag", 1, True), [L["f"], (np.full(n, -1.5), np.ones(n, bool))]),
        f(("lead", 1, False), [L["u"]]), f(("lag", 3, False), [L["code"]], post=("decode", vocab)),
        f(("first_value",), [L["i"]], ("rows", "pre", 2, "fol", 1)),
        f(("last_value",), [L["f"]], ("range", "up", 0, "cur", 0)),
        f(("nth_value", 2), [L["u"]], ("rows", "up", 0, "uf", 0)),
        f(("first_value",), [L["code"]], ("range", "pre", 5, "fol", 5, d), post=("decode", vocab)),
        f(("last_value",), [L["i"]], ("range", "fol", 3, "fol", 8, d)),
        f(("nth_value", 3), [L["f"]], ("range", "pre", 6, "pre", 1, d)),
        f(("count", False), (), ("rows", "fol", 1, "fol", 3)),
        f(("count", True), [L["i"]], ("range", "pre", 5, "fol", 5, d)),
        f(("count", True), [L["f"]]),
        f(("sum", True), [L["big"]]),
        f(("sum", True), [L["f"]], ("rows", "pre", 3, "cur", 0)),
        f(("sum", True), [L["u"]], ("range", "pre", 10, "pre", 2, d)),
        f(("sum", True), [L["i"]], ("rows", "fol", 5, "fol", 2)),
        f(("sum", True), [L["i"]], ("rows", "pre", 9, "pre", 4)),
        f(("sum", True), [L["big"]], ("range", "cur", 0, "uf", 0)),
        f(("avg", True, "dec"), [L["i"]], ("rows", "pre", 1, "fol", 1), post=("avg_dec", 2, 6)),
        f(("avg", True, "f"), [L["f"]], post=("avg_f",)),
        f(("avg", True, "dec"), [L["i"]], ("range", "pre", 4, "fol", 0, d), post=("avg_dec", 0, 4)),
        f(("min",), [L["i"]]), f(("max",), [L["f"]], ("rows", "up", 0, "fol", 2)),
        f(("min",), [L["u"]], ("rows", "pre", 2, "uf", 0)), f(("max",), [L["u"]], ("rows", "pre", 3, "fol", 3)),
        f(("min",), [L["f"]], ("rows", "pre", 0, "fol", 5)), f(("max",), [L["i"]], ("rows", "fol", 2, "fol", 5)),
        f(("min",), [L["big"]], ("rows", "pre", 20, "pre", 1)),
        f(("max",), [L["f"]], ("range", "up", 0, "fol", 5, d)),
        f(("min",), [L["code"]], ("range", "pre", 3, "uf", 0, d), post=("decode", vocab)),
        f(("max",), [L["i"]], ("range", "cur", 0, "uf", 0)),
    ]
    pres = o[0][o[1]]
    return [L["g"], L["h"]], [(o, desc)], fs, (o[0], o[1], int(pres.min()), int(pres.max()))


def window_edge_battery(rng):
    """[(name, part, order, fspecs, n, range_lane)] at the edges of W1's
    sorted-order design (numpy; a scan tile is 2,048 sorted rows): one
    partition of all rows, single-row partitions, partitions and peer
    groups crossing tile edges, LAG / LEAD offsets past a tile, ROWS min /
    max frames wider than a direct pass (the sparse table: 201 rows) and
    wider than a tile (3,011 rows), P below a tile (n 700 and 1)."""
    import numpy as np

    def f(static, args=(), frame=None, post=None):
        return {"name": static[0], "static": static, "args": list(args), "post": post, "frame": frame}

    def every(L, n):
        return [f(("row_number",)), f(("rank",)), f(("dense_rank",)), f(("ntile", 5)),
                f(("cume_dist",), post=("cume_dist",)), f(("percent_rank",), post=("percent_rank",)),
                f(("lag", 1, False), [L["i"]]), f(("lead", 2, True), [L["f"], (np.full(n, 2.5), np.ones(n, bool))]),
                f(("first_value",), [L["u"]], ("rows", "pre", 3, "cur", 0)),
                f(("last_value",), [L["i"]], ("range", "cur", 0, "uf", 0)),
                f(("nth_value", 2), [L["f"]], ("rows", "up", 0, "fol", 1)),
                f(("count", True), [L["i"]], ("rows", "pre", 2, "fol", 2)), f(("count", False), ()),
                f(("sum", True), [L["big"]]), f(("sum", True), [L["f"]], ("rows", "pre", 5, "fol", 5)),
                f(("avg", True, "f"), [L["f"]], ("range", "cur", 0, "uf", 0), post=("avg_f",)),
                f(("min",), [L["i"]]), f(("max",), [L["u"]], ("rows", "cur", 0, "uf", 0)),
                f(("max",), [L["f"]], ("rows", "pre", 3, "fol", 3)), f(("min",), [L["big"]], ("rows", "pre", 1, "pre", 0))]

    cases = []
    n = 5000
    L = win_lanes(rng, n)
    o = L["o"]
    pres = o[0][o[1]]
    rl = (o[0], o[1], int(pres.min()), int(pres.max()))
    cases.append(("one_partition", [], [(o, False)], every(L, n)
                  + [f(("sum", True), [L["i"]], ("range", "pre", 7, "fol", 3, False))], n, rl))
    n = 3000
    L = win_lanes(rng, n)
    solo = (rng.permutation(n).astype(np.int64), np.ones(n, bool))
    cases.append(("single_row_partitions", [solo], [(L["o"], True)], every(L, n), n, None))
    n = 6000  # partitions of 2,047 / 2,050 / 1 / 1,902 rows: their edges fall around the tiles' at 2,048 and 4,096
    L = win_lanes(rng, n)
    g = rng.permutation(np.repeat(np.arange(4), [2047, 2050, 1, 1902])).astype(np.int64)
    peers = (rng.integers(0, 3, n).astype(np.int64), np.ones(n, bool))  # peer groups of ~700 rows
    cases.append(("tile_edges", [(g, np.ones(n, bool))], [(peers, False)], every(L, n), n, None))
    n = 9000
    L = win_lanes(rng, n)
    two = (np.arange(n) % 2).astype(np.int64)
    cases.append(("offsets_past_a_tile", [(two, np.ones(n, bool))], [(L["o"], False)],
                  [f(("lag", 2500, False), [L["i"]]), f(("lead", 3000, True), [L["u"], L["u"]]),
                   f(("lag", 4499, False), [L["f"]]), f(("lead", 4500, False), [L["i"]])], n, None))
    cases.append(("wide_rows_frames", [(two, np.ones(n, bool))], [(L["o"], True)],
                  [f(("max",), [L["f"]], ("rows", "pre", 100, "fol", 100)),
                   f(("min",), [L["u"]], ("rows", "pre", 3000, "fol", 10)),
                   f(("max",), [L["i"]], ("rows", "fol", 1, "fol", 2500)),
                   f(("min",), [L["f"]], ("rows", "pre", 64, "pre", 2))], n, None))
    for n in (700, 1):
        L = win_lanes(rng, n)
        cases.append((f"below_a_tile_n{n}", [L["g"]], [(L["o"], False)], every(L, n), n, None))
    return cases


def window_cases(dev, rng):
    """(name, W1 inputs) — the battery ASC and DESC at P = 8,192 and at
    P = 2^23, float and multi-word order keys, P = 1024 with n = 1, one
    partition, a partition edge past a scan tile — built by the port's own
    host prep (executor/window_device.prepare)."""
    from tidb_tpu_torch.executor import window_device as wd

    def inputs(part, order, fspecs, n, range_lane=None):
        words, fargs, npw, now, range_dev = wd.prepare(part, order, fspecs, n, dev, range_lane)
        spec = (npw, now, tuple(f["static"] for f in fspecs), tuple(f.get("frame") for f in fspecs))
        return list(words), fargs, spec, range_dev

    def f(static, args=(), frame=None):
        return {"name": static[0], "static": static, "args": list(args), "post": None, "frame": frame}

    cases = []
    for n in (5000, 8_000_000):
        for desc in (False, True):
            part, order, fspecs, rl = window_battery(win_lanes(rng, n), desc)
            cases.append((f"battery n={n} {'desc' if desc else 'asc'}", inputs(part, order, fspecs, n, rl)))
    L = win_lanes(rng, 5000)
    fs = [f(("rank",)), f(("dense_rank",)), f(("sum", True), [L["f"]]), f(("min",), [L["f"]]),
          f(("max",), [L["u"]]), f(("lead", 1, False), [L["f"]]), f(("last_value",), [L["i"]], ("rows", "cur", 0, "uf", 0))]
    cases.append(("float_multiword_keys", inputs([L["h"]], [(L["fk"], True), (L["o"], False)], fs, 5000)))
    for n, parts in ((1, True), (1024, False), (2049, True)):
        L = win_lanes(rng, n)
        fs = [f(("row_number",)), f(("sum", True), [L["big"]]), f(("max",), [L["f"]], ("rows", "pre", 1, "fol", 1)),
              f(("min",), [L["u"]], ("rows", "pre", 1, "uf", 0)), f(("lag", 1, False), [L["i"]]), f(("ntile", 4))]
        cases.append((f"edge n={n} parts={parts}", inputs([L["g"]] if parts else [], [(L["o"], False)], fs, n)))
    for name, part, order, fspecs, n, rl in window_edge_battery(rng):
        cases.append((f"sorted-order edge {name}", inputs(part, order, fspecs, n, rl)))
    return cases


def _same_outs(got, want, what: str) -> float:
    """W1 outputs lane by lane: ints and bools bit-exact, floats within
    tolerance with NaN in the same rows."""
    import torch

    from tidb_tpu_torch.expr.xp_torch import U64

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} lanes vs {len(want)}")
    err = 0.0
    for j, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, U64) != isinstance(w, U64):
            raise AssertionError(f"{what} lane {j}: uint64 vs not")
        g, w = (g.bits, w.bits) if isinstance(g, U64) else (g, w)
        if g.is_floating_point() and not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{what} lane {j}: NaN rows differ")
        err = max(err, _same(g, w, f"{what} lane {j}", floats=g.is_floating_point()))
    return err


def pack_cases(dev, rng):
    """(name, lanes) for W2: every lane kind, bool lengths off the word."""
    import numpy as np
    import torch

    from tidb_tpu_torch.expr.xp_torch import U64

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = []
    for n in (1, 63, 64, 65, 1000, 8_388_608 + 3):
        f64 = rng.standard_normal(n)
        f64[:: 7] = np.nan
        cases.append((f"mixed n={n}", [t(rng.random(n) < 0.5), t(rng.integers(-(1 << 62), 1 << 62, n)), t(f64),
                                      t(f64.astype(np.float32)), U64(t(rng.integers(-(1 << 63), (1 << 63) - 1, n))),
                                      t(rng.integers(-5, 5, n).astype(np.int32)), t(rng.random(n) < 0.01)]))
    return cases


# --- the MPP kernels' batteries (P3, P7, P9): numpy, so the CPU tests hold
# the same inputs to the reference --------------------------------------


def lut_battery(rng, n: int, B: int, sizes) -> dict:
    """P3 inputs: probe keys with NULLs and values outside the build domain
    on both sides, a LUT with absent slots, a build mask that drops rows,
    build lanes of every 8-byte kind (int64 extremes, float64 with NaN and
    -0.0) with NULLs."""
    import numpy as np

    lo = [int(rng.integers(-50, 50)) for _ in sizes]
    stride, acc = [1] * len(sizes), 1
    for i in range(len(sizes) - 1, -1, -1):
        stride[i] = acc
        acc *= sizes[i]
    dom = acc
    lut = np.full(dom, -1, dtype=np.int32)
    m = max(min(B, dom) * 2 // 3, 1)
    lut[rng.choice(dom, m, replace=False)] = rng.choice(B, m, replace=False).astype(np.int32)
    keys = []
    for l, sz in zip(lo, sizes):
        v = rng.random(n) > 0.1
        d = np.where(v, rng.integers(l - 3, l + sz + 3, n), 0).astype(np.int64)
        keys.append((d, v))
    f = rng.standard_normal(B) * 1e3
    f[rng.random(B) < 0.05] = np.nan
    f[rng.random(B) < 0.05] = -0.0
    big = rng.integers(-(1 << 63), (1 << 63) - 1, B, dtype=np.int64)
    gathers = [(big, rng.random(B) > 0.1), (f, rng.random(B) > 0.1), (rng.integers(0, 7, B), np.ones(B, bool))]
    return {"keys": keys, "lo": lo, "size": list(sizes), "stride": stride, "pmask": rng.random(n) > 0.05,
            "lut": lut, "bmask": rng.random(B) > 0.2, "brow": rng.integers(0, 1 << 40, B), "gathers": gathers}


LUT_SHAPES = ((1, 1, (1,)), (1000, 777, (1500,)), (1000, 777, (50, 40)), (100_003, 50_000, (75_000,)),
              (100_003, 50_000, (300, 250)))


def run_battery(rng, L: int, case: str) -> dict:
    """P7 inputs over a key-sorted stream: runs of 1..8 rows, masked rows
    and all-masked runs, an int64 lane whose prefix overflows (values
    ±(2^62 + x)), a float lane with -0.0, a count lane and the build
    row-id lane (constant over a run's matched rows). `case`: 'runs',
    'giant_run' (one run holds 90% of the stream), 'pad_tail' (the last
    30% are pad rows: key 0, masked), 'asc' (ascending ORDER BY on the
    float lane), 'nan' (a NaN, +inf and -inf in the float lane). The edges
    of the one-sweep design: 'one_run' (a run over every tile), 'singles'
    (runs of one row), 'tile_end' (a run ends on every tile's last row),
    'nan_first' / 'nan_last' (a NaN at row 0, an infinity at row L - 1),
    'negzero' (most float values -0.0: runs that total -0.0), 'big_prefix'
    (short float runs after large ones), 'lanes16' (16 lanes)."""
    import numpy as np

    if case == "giant_run":
        kd = np.sort(np.where(rng.random(L) < 0.9, 1000, rng.integers(1, 2000, L))).astype(np.int64)
    elif case == "one_run":
        kd = np.full(L, 7, dtype=np.int64)
    elif case == "singles":
        kd = np.arange(L, dtype=np.int64) - L // 2
    elif case == "tile_end":  # runs change at every multiple of RUN_TILE rows and now and then between
        kd = ((np.cumsum(rng.random(L) < 0.01) + 1) * L + np.arange(L) // RUN_TILE).astype(np.int64)
    else:
        kd = np.cumsum(rng.random(L) < 0.3).astype(np.int64) + 1
    mask = rng.random(L) > 0.2
    if case == "pad_tail":
        pad = L - int(L * 0.7)
        kd[L - pad:] = 0
        mask[L - pad:] = False
    runid = np.cumsum(np.concatenate([[True], kd[1:] != kd[:-1]])) - 1
    big = np.where(rng.random(L) < 0.5, 1, -1) * ((1 << 62) + rng.integers(0, 1 << 40, L))
    f = np.round(rng.random(L) * 1e5, 2)
    f[rng.random(L) < 0.05] = -0.0
    if case == "nan":  # the reference's prefix difference is NaN past these
        f[rng.choice(L, 3, replace=False)] = [np.nan, np.inf, -np.inf]
    vi, vf = rng.random(L) > 0.1, rng.random(L) > 0.1
    if case == "negzero":
        f[rng.random(L) < 0.6] = -0.0
    elif case == "big_prefix":
        f[:L // 2] *= 1e5
    elif case in ("nan_first", "nan_last"):
        at = 0 if case == "nan_first" else L - 1
        f[at], mask[at], vf[at] = (np.nan if at == 0 else np.inf), True, True
    rid = np.where(mask, runid * 3 + 7, -1).astype(np.int64)
    lanes = [(big.astype(np.int64), vi), (None, vi), (f, vf), (None, vf), (None, None), (rid, None)]
    if case == "lanes16":  # int and float lanes, with and without a valid lane
        for j in range(10):
            d = rng.integers(-(1 << 62), 1 << 62, L) if j % 2 else np.round(rng.random(L) * 1e3, 3)
            lanes.append((d, (rng.random(L) > 0.2) if j % 3 else None))
    score = 2 if case == "asc" else 0
    return {"kd": kd, "mask": mask, "lanes": lanes, "cnt_lane": 4, "rid_lane": 5, "score_lane": score,
            "desc": case != "asc"}


RUN_TILE = 1024  # csrc/run_agg.cu's TILE: the rows a tile of P7's sweep
RUN_SHAPES = ((1, "runs"), (1000, "runs"), (4096, "runs"), (100_003, "runs"), (300_000, "giant_run"),
              (65_536, "pad_tail"), (100_003, "asc"), (8192, "nan"),
              (RUN_TILE - 1, "runs"), (RUN_TILE, "tile_end"), (RUN_TILE + 1, "singles"), (3 * RUN_TILE, "tile_end"),
              (100_003, "one_run"), (100_003, "singles"), (100_003, "negzero"), (100_003, "big_prefix"),
              (5000, "nan_first"), (5000, "nan_last"), (5000, "lanes16"), (300_001, "lanes16"))


def topk_battery(rng, n: int, case: str):
    """P9 score lanes: 'ties' (ints from a small range), 'zeros' (±0.0),
    'nan' (NaN and -NaN among floats), 'few' (fewer scores above the
    floor than k: the rest -inf), 'few_int' (the rest -INT64_MAX, as
    _topk_score's invalid slots, and some INT64_MIN), 'floats'."""
    import numpy as np

    if case == "ties":
        return rng.integers(-5, 5, n).astype(np.int64)
    if case == "few_int":
        v = np.full(n, -((1 << 63) - 1), dtype=np.int64)
        v[rng.choice(n, min(n, 3), replace=False)] = rng.integers(0, 100, min(n, 3))
        v[rng.random(n) < 0.01] = -(1 << 63)
        return v
    v = rng.standard_normal(n) * 100
    if case == "zeros":
        v = np.where(rng.random(n) < 0.5, 0.0, -0.0)
        v[rng.random(n) < 0.01] = 1.0
    elif case == "nan":
        v[rng.random(n) < 0.002] = np.nan
        v[rng.random(n) < 0.002] = -np.nan
    elif case == "few":
        keep = rng.random(n) < 3 / max(n, 1)
        v = np.where(keep, v, -np.inf)
    return v


TOPK_SHAPES = ((1, 1, "floats"), (5000, 16, "ties"), (5000, 16, "zeros"), (5000, 16, "nan"), (5000, 16, "few"),
               (5000, 16, "few_int"), (3 * 1024 + 17, 70, "floats"), (3 * 1024 + 17, 70, "ties"),
               (4_194_304, 10, "floats"), (4_194_304, 64, "ties"))


# P9's edges (the two-launch design): equal keys everywhere, sorted lanes,
# every winner in one chunk, winners tied across chunk edges, NaN / ±0.0 /
# ±inf, the int64 floor, n around a chunk and around kk chunks, kk 1, 16
# and 512
TOPK_EDGE_SHAPES = ((5000, 16, "all_equal"), (5000, 16, "ascending"), (5000, 16, "descending"),
                    (20_000, 16, "one_chunk"), (8192, 16, "edge_ties"), (5000, 16, "specials"),
                    (5000, 16, "int_floor"), (1, 1, "floats"), (1023, 16, "floats"), (1024, 16, "ties"),
                    (1025, 16, "floats"), (16 * 1024 - 1, 16, "ties"), (16 * 1024 + 1, 16, "floats"),
                    (5000, 1, "ties"), (1025, 512, "floats"), (512 * 1024 - 1, 512, "ties"),
                    (512 * 1024 + 1, 512, "floats"), (20_000, 512, "all_equal"))


def topk_edge_battery(rng, n: int, case: str):
    """P9 score lanes at the edges of the two-launch design (numpy):
    TOPK_EDGE_SHAPES's cases, and topk_battery's for the rest."""
    import numpy as np

    if case == "all_equal":
        return np.full(n, 7, dtype=np.int64)
    if case == "ascending":
        return np.arange(n, dtype=np.float64)
    if case == "descending":
        return np.arange(n, dtype=np.int64)[::-1].copy()
    if case == "one_chunk":  # chunk 3 holds every winner, with ties
        v = rng.integers(-100, 100, n).astype(np.int64)
        v[3072:4096] = 1000 + rng.integers(0, 5, 1024)
        return v
    if case == "edge_ties":  # equal winners on both sides of chunk edges
        v = rng.integers(-100, 100, n).astype(np.int64)
        for c in range(1, n // 1024):
            v[c * 1024 - 1: c * 1024 + 1] = 500
        return v
    if case == "specials":
        v = rng.standard_normal(n) * 100
        at = rng.choice(n, 14, replace=False)
        v[at] = [np.nan, -np.nan, np.nan, np.nan, -np.nan, 0.0, -0.0, 0.0, -0.0, np.inf, np.inf, -np.inf, -np.inf,
                 np.inf]
        return v
    if case == "int_floor":  # fewer scores above INT64_MIN than k
        v = np.full(n, -(1 << 63), dtype=np.int64)
        v[rng.choice(n, 5, replace=False)] = rng.integers(-(1 << 62), 1 << 62, 5)
        return v
    return topk_battery(rng, n, case)


def p3_args(b: dict, dev):
    """lut_join's positional arguments on `dev` from a lut_battery."""
    import torch

    def t(a):
        import numpy as np

        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ([(t(d), t(v)) for d, v in b["keys"]], b["lo"], b["size"], b["stride"], t(b["pmask"]), t(b["lut"]),
            t(b["bmask"]), t(b["brow"]), [(t(d), t(v)) for d, v in b["gathers"]])


def p7_args(b: dict, dev):
    """run_agg's positional arguments on `dev` from a run_battery."""
    import numpy as np
    import torch

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (t(b["kd"]), t(b["mask"]), [(t(d), t(v)) for d, v in b["lanes"]], b["cnt_lane"], b["rid_lane"],
            b["score_lane"], b["desc"])


def same_lut_join(got, want, what: str) -> float:
    """P3 outputs: match, row ids and gathered lanes bit for bit (float
    lanes compared as their bits: a gather moves words)."""
    import torch

    _same(got[0], want[0], f"{what} match")
    _same(got[1], want[1], f"{what} rowid")
    for j, ((gd, gv), (wd, wv)) in enumerate(zip(got[2], want[2])):
        bits = (lambda x: x.view(torch.int64)) if gd.dtype == torch.float64 else (lambda x: x)
        _same(bits(gd), bits(wd), f"{what} lane {j} data")
        _same(gv, wv, f"{what} lane {j} valid")
    return 0.0


def same_run_agg(got, want, kd, what: str) -> float:
    """P7 outputs: integer totals, group rows, validity and integer scores
    bit for bit at every row; float totals and scores within tolerance at
    the run starts, the only rows P9 can pick as valid. (At a run's
    interior rows the reference's prefix difference of a float lane
    strays from the exact suffix sum by more than the tolerance once the
    prefix is large: ROADMAP Queue 3.)"""
    import torch

    first = torch.cat([torch.ones(1, dtype=torch.bool, device=kd.device), kd[1:] != kd[:-1]])
    err = 0.0
    for j, (g, w) in enumerate(zip(got[0], want[0])):
        if g.is_floating_point():
            err = max(err, _same(g[first], w[first], f"{what} lane {j} at run starts", floats=True))
        else:
            _same(g, w, f"{what} lane {j}")
    _same(got[1], want[1], f"{what} gpos")
    _same(got[2], want[2], f"{what} valid")
    return max(err, _same(got[3], want[3], f"{what} score", floats=got[3].is_floating_point()))


def same_block_topk(got, want, v, what: str) -> float:
    """P9 picks: the same slots valid (score above the floor), and there
    the same positions and scores; past the last valid pick the reference
    may repeat a position."""
    import torch

    floor = float("-inf") if v.dtype == torch.float64 else -(1 << 63)
    gv, wv = got[0] > floor, want[0] > floor
    _same(gv, wv, f"{what} valid slots")
    _same(got[1][gv], want[1][wv], f"{what} positions")
    g, w = got[0][gv], want[0][wv]
    bits = (lambda x: x.view(torch.int64)) if v.dtype == torch.float64 else (lambda x: x)
    # -0.0 ties +0.0: the same position, so the same bits
    _same(bits(g), bits(w), f"{what} scores")
    return 0.0


def same_emit(got_rows, want_rows, what: str) -> None:
    """P9's result rows: group row and valid row everywhere, the lanes at
    the valid slots."""
    _same(got_rows[:2], want_rows[:2], f"{what} group/valid rows")
    ok = want_rows[1] != 0
    _same(got_rows[2:, ok], want_rows[2:, ok], f"{what} lanes at valid picks")


def mpp_kernel_cases(dev, rng):
    """(name, fn) of every P3 / P7 / P9 case: kernel against plain version."""
    import torch

    from tidb_tpu_torch.kernels import block_topk, block_topk_ref, lut_join, lut_join_ref, run_agg, run_agg_ref
    from tidb_tpu_torch.kernels.block_topk import Emit

    cases = []
    for n, B, sizes in LUT_SHAPES:
        args = p3_args(lut_battery(rng, n, B, sizes), dev)
        cases.append((f"lut_join n={n} B={B} sizes={sizes}",
                      lambda args=args: same_lut_join(lut_join(*args), lut_join_ref(*args), "lut_join")))
    for L, case in RUN_SHAPES:
        args = p7_args(run_battery(rng, L, case), dev)
        cases.append((f"run_agg L={L} {case}",
                      lambda args=args: same_run_agg(run_agg(*args), run_agg_ref(*args), args[0], "run_agg")))
    for n, k, case in TOPK_SHAPES:
        v = torch.from_numpy(topk_battery(rng, n, case)).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.3).to(dev)
        gpos = torch.from_numpy(rng.integers(0, 1 << 30, n)).to(dev)
        lanes = [torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n)).to(dev),
                 torch.from_numpy(rng.standard_normal(n)).to(dev)]

        def p9(v=v, k=k, valid=valid, gpos=gpos, lanes=lanes, case=case):
            rows = [torch.zeros((4, k + 3), dtype=torch.int64, device=v.device) for _ in range(2)]
            got = block_topk(v, k, Emit(rows[0], valid, gpos, lanes))
            want = block_topk_ref(v, k)
            from tidb_tpu_torch.kernels.block_topk import emit_ref

            emit_ref(*want, v, Emit(rows[1], valid, gpos, lanes))
            same_emit(rows[0], rows[1], f"block_topk {case}")
            return same_block_topk(got, want, v, f"block_topk {case}")
        cases.append((f"block_topk n={n} k={k} {case}", p9))
    for n, k, case in TOPK_EDGE_SHAPES:
        v = torch.from_numpy(topk_edge_battery(rng, n, case)).to(dev)

        def p9_edge(v=v, k=k, case=case):
            return same_block_topk(block_topk(v, k), block_topk_ref(v, k), v, f"block_topk {case}")
        cases.append((f"block_topk edge n={n} k={k} {case}", p9_edge))
    return cases


# --- the MPP modes' batteries (P4, P5, P6, P8): numpy, so the CPU tests
# hold the same inputs to the reference --------------------------------


def _strides(sizes):
    stride, acc = [1] * len(sizes), 1
    for i in range(len(sizes) - 1, -1, -1):
        stride[i] = acc
        acc *= sizes[i]
    return stride, acc


def sort_join_battery(rng, n: int, B: int, case: str) -> dict:
    """P4 inputs. Build keys unique ('unique', 'unique_left', 'two_keys',
    'i32', 'wide', 'sentinel') or in runs of duplicates ('dup',
    'dup_left', 'dup_none' with no join cardinality, 'overflow' with a
    capacity below the output); NULL and out-of-domain probe keys, masks
    on both sides, build lanes of every 8-byte kind (int64 extremes,
    float64 with NaN and -0.0), probe lanes and row ids to expand. 'i32'
    truncates the packed key to int32 and gives NULL keys data whose
    truncation wraps; 'sentinel' packs probe keys and two build keys (one
    valid, one NULL) equal to the sort sentinel INT64_MAX, which sorts
    them among the invalid build rows; 'wide' keys span +-2^40.
    'masked95' / 'dup_masked95' mask 95% of both sides' rows (the
    compaction keeps few build rows), 'all_masked' / 'dup_all_masked'
    every build row (none kept), 'none_masked' no row and no key of either
    side (every build row kept); 'skew' gives one build key most of the
    rows, so each probe row on it owns more than an expansion tile of
    slots; 'i32_left' / 'i32_dup_left' are left joins over the wrapping
    int32 keys of 'i32'."""
    import numpy as np

    nk = 2 if case == "two_keys" else 1
    dup = case in ("dup", "dup_left", "dup_none", "overflow", "dup_masked95", "dup_all_masked", "none_masked",
                   "skew", "i32_dup_left")
    if case == "wide":
        dom = [1 << 41]
    elif case == "two_keys":
        dom = [max(B // 8, 2), 16]
    else:
        dom = [max(B // 3, 1) if dup else 2 * B]
    lo = [int(rng.integers(-40, 40)) if case != "wide" else -(1 << 40) for _ in dom]
    bkeys, pkeys = [], []
    if case == "skew":  # two thirds of the build rows on one key
        cols = [lo[0] + np.where(rng.random(B) < 2 / 3, 0, rng.integers(0, dom[0], B))]
    elif dup:
        cols = [lo[0] + rng.integers(0, dom[0], B)]
    elif case == "two_keys":
        flat = rng.choice(dom[0] * dom[1], B, replace=False)
        cols = [lo[0] + flat // dom[1], lo[1] + flat % dom[1]]
    else:
        cols = [lo[0] + rng.choice(dom[0], B, replace=False)]
    for j, c in enumerate(cols):
        v = rng.random(B) > 0.08
        bkeys.append((np.where(v, c, 0).astype(np.int64), v))
        v = rng.random(n) > 0.08
        p = rng.integers(lo[j] - 3, lo[j] + dom[j] + 3, n)
        pkeys.append((np.where(v, p, 0).astype(np.int64), v))
    stride, acc = _strides(dom)
    key_i32 = acc < (1 << 31) - 2
    if case.startswith("i32"):  # NULL keys' data far outside the domain: its int32 cast wraps
        for d, v in bkeys + pkeys:
            d[~v] = rng.integers(-(1 << 40), 1 << 40, int((~v).sum()))
    pmask, bmask = rng.random(n) > 0.1, rng.random(B) > 0.15
    if "masked95" in case:
        pmask, bmask = rng.random(n) > 0.95, rng.random(B) > 0.95
    elif "all_masked" in case:
        bmask[:] = False
    elif case == "none_masked":
        pmask[:], bmask[:] = True, True
        for d, v in bkeys + pkeys:
            d[~v] = d[v][0] if v.any() else 0
            v[:] = True
    elif case == "skew":
        pkeys[0][0][:n // 10] = lo[0]  # a tenth of the probe rows on the heavy key
        pkeys[0][1][:n // 10] = True
        pmask[:n // 10] = True
    if case == "sentinel":  # two build keys at INT64_MAX, one valid: the first in row order decides
        key_i32, lo, stride = False, [0], [1]
        (bd, bv), (pd, pv) = bkeys[0], pkeys[0]
        two = rng.choice(B, 2, replace=False)
        bd[two] = (1 << 63) - 1
        bv[two], bmask[two] = [False, True], True
        hit = rng.random(n) < 0.05
        pd[hit], pv[hit] = (1 << 63) - 1, True
    # the join cardinality on key-valid rows, as the engine's jcard
    def packed(keys):
        a = np.zeros(len(keys[0][0]), dtype=np.int64)
        ok = np.ones(len(keys[0][0]), dtype=bool)
        for (d, v), l, st in zip(keys, lo, stride):
            a = a + (d - l) * st
            ok &= v
        return a, ok
    pk, pok = packed(pkeys)
    bk, bok = packed(bkeys)
    bu, bc = np.unique(bk[bok], return_counts=True)
    exp = 0
    if len(bu):
        ii = np.clip(np.searchsorted(bu, pk[pok]), 0, len(bu) - 1)
        exp = int(np.sum((bu[ii] == pk[pok]) * bc[ii]))
    left = case.endswith("_left")
    mult = 2 if dup else 1
    cap = 0
    if dup:
        C = 2 * max(n, B) + 64 if case == "dup_none" else (exp // 2 if case == "overflow" else exp + 64)
        cap = max(C, 1) + (n if left else 0)
    f = rng.standard_normal(B) * 1e3
    f[rng.random(B) < 0.05] = np.nan
    f[rng.random(B) < 0.05] = -0.0
    gathers = [(rng.integers(-(1 << 63), (1 << 63) - 1, B, dtype=np.int64), rng.random(B) > 0.1),
               (f, rng.random(B) > 0.1)]
    probe_lanes = prows = []
    if dup:
        probe_lanes = [(rng.integers(-(1 << 62), 1 << 62, n), rng.random(n) > 0.1),
                       (rng.standard_normal(n), rng.random(n) > 0.1)]
        prows = [np.arange(n, dtype=np.int64) * 3, rng.integers(0, 1 << 40, n)]
    return {"pkeys": pkeys, "bkeys": bkeys, "lo": lo, "stride": stride, "key_i32": bool(key_i32), "pmask": pmask,
            "bmask": bmask, "brow": rng.integers(0, 1 << 40, B), "mult": mult, "left": left, "cap": cap,
            "gathers": gathers, "probe_lanes": probe_lanes, "prows": prows}


SORT_JOIN_SHAPES = ((1, 1, "unique"), (2000, 1500, "unique"), (2000, 1500, "unique_left"), (3000, 1000, "two_keys"),
                    (2000, 500, "i32"), (2000, 800, "wide"), (500, 300, "sentinel"), (2000, 700, "dup"),
                    (2000, 700, "dup_left"), (1500, 600, "dup_none"), (2000, 700, "overflow"), (1, 5, "dup"),
                    (200_003, 100_000, "dup"), (100_003, 300_000, "unique"), (4000, 3000, "masked95"),
                    (4000, 3000, "dup_masked95"), (2000, 1500, "all_masked"), (2000, 700, "dup_all_masked"),
                    (2000, 700, "none_masked"), (300, 3000, "skew"), (2000, 500, "i32_left"),
                    (2000, 500, "i32_dup_left"), (4_000_000, 1_000_000, "masked95"))


def p4_args(b: dict, dev):
    """sort_join's positional arguments on `dev` from a sort_join_battery."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def pairs(x):
        return [(t(d), t(v)) for d, v in x]

    return (pairs(b["pkeys"]), pairs(b["bkeys"]), b["lo"], b["stride"], b["key_i32"], t(b["pmask"]),
            t(b["bmask"]), t(b["brow"]), b["mult"], b["left"], b["cap"], pairs(b["gathers"]),
            pairs(b["probe_lanes"]), [t(r) for r in b["prows"]])


def _bits_of(x):
    import torch

    return x.view(torch.int64) if x.dtype == torch.float64 else x


def same_sort_join(got, want, what: str) -> float:
    """P4 outputs bit for bit: mask, row ids, every gathered and expanded
    lane (floats as their bits: joins move words), the dropped count."""
    _same(got.mask, want.mask, f"{what} mask")
    _same(got.rowid, want.rowid, f"{what} rowid")
    for name, gl, wl in (("build", got.gathered, want.gathered), ("probe", got.probe_lanes, want.probe_lanes)):
        for j, ((gd, gv), (wd, wv)) in enumerate(zip(gl, wl)):
            _same(_bits_of(gd), _bits_of(wd), f"{what} {name} lane {j} data")
            _same(gv, wv, f"{what} {name} lane {j} valid")
    for j, (g, w) in enumerate(zip(got.prows, want.prows)):
        _same(g, w, f"{what} probe row ids {j}")
    if (got.dropped is None) != (want.dropped is None):
        raise AssertionError(f"{what}: dropped {got.dropped} vs {want.dropped}")
    if got.dropped is not None:
        _same(got.dropped, want.dropped, f"{what} dropped")
    return 0.0


def _red_lanes(rng, n: int, spec: str):
    """(op, data, valid) numpy lanes for P5 / P6 / P8, one letter each:
    c count (of the value lane before it, as _agg_partials pairs them), s
    int64 sum whose values +-(2^62 + x) overflow, f float64
    sum with -0.0 (F: and a NaN, +inf and -inf), n float64 min with NaN and -0.0, x int64 max, m / M
    uint64 min / max over values above and below 2^63 (as int64 bits), u
    uint64 sum, d a min over dict codes 0..6. Each value lane comes with
    NULLs."""
    import numpy as np

    out = []
    for ch in spec:
        v = rng.random(n) > 0.1
        if ch == "c":  # the count of the value lane before it shares its NULLs
            out.append(("count", None, out[-1][2] if out and out[-1][0] != "count" else v))
        elif ch == "s":
            out.append(("sum_i64", np.where(rng.random(n) < 0.5, 1, -1) * ((1 << 62) + rng.integers(0, 1 << 40, n)), v))
        elif ch in "fF":
            f = np.round(rng.random(n) * 1e5, 2)
            f[rng.random(n) < 0.05] = -0.0
            if ch == "F":
                f[rng.choice(n, min(n, 3), replace=False)] = [np.nan, np.inf, -np.inf][:min(n, 3)]
            out.append(("sum_f64", f, v))
        elif ch == "n":
            f = rng.standard_normal(n) * 100
            f[rng.random(n) < 0.01] = np.nan
            f[rng.random(n) < 0.05] = -0.0
            out.append(("min_f64", f, v))
        elif ch == "x":
            out.append(("max_i64", rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64), v))
        elif ch in "mMu":
            u = rng.integers(0, 1 << 64, n, dtype=np.uint64)
            u[rng.random(n) < 0.5] >>= np.uint64(1)  # half below 2^63
            out.append(({"m": "min_u64", "M": "max_u64", "u": "sum_u64"}[ch], u.view(np.int64), v))
        elif ch == "d":
            out.append(("min_i64", rng.integers(0, 7, n), v))
    return out


def seg_reduce_battery(rng, n: int, case: str) -> dict:
    """P5 inputs: an int group key with a gcd step and NULLs and a
    dict-coded one, masked rows, every lane kind of _red_lanes (uint64
    min / max whose neutral takes part, a float sum whose runs past a NaN
    or an infinity total NaN), the score on the int64 sum lane
    (ties broken by position). 'runs': a few rows a group; 'giant_run':
    one group holds 90% of the rows; 'few_groups': fewer groups than k;
    'asc': ascending on the count lane (many ties); 'pow2_single': one
    group over all 4096 rows, none masked (no doubling step of the
    reference reaches past it). 'masked95' masks 95% of the rows and
    'all_masked' every row (the compaction keeps few or none: the picks
    take masked positions past the groups), 'none_masked' none;
    'sentinel' gives a few valid rows the code INT64_MAX (they sort among
    the masked rows); 'kk_above' asks for more picks than there are valid
    rows; 'floor_nan' scores ascending on the float sum with NaN and
    infinities (scores of NaN with the sign set rank below the floor,
    -inf at it) and asks for more picks than groups."""
    import numpy as np

    lo0, step = int(rng.integers(-1000, 1000)), 7
    G = {"few_groups": 3, "giant_run": max(n // 50, 2)}.get(case, max(n // 4, 2))
    g = rng.integers(0, G, n)
    if case == "giant_run":
        g = np.where(rng.random(n) < 0.9, 1, g)
    k0 = lo0 + step * g
    v0 = rng.random(n) > 0.05
    k1 = rng.integers(0, 5, n)
    v1 = rng.random(n) > 0.05
    mask = rng.random(n) > 0.2
    if case == "pow2_single":
        k0, v0, k1, v1, mask = np.full(n, lo0), np.ones(n, bool), np.zeros(n, np.int64), np.ones(n, bool), np.ones(n, bool)
    if case in ("masked95", "floor_nan"):
        mask = rng.random(n) > 0.95
    elif case == "all_masked":
        mask[:] = False
    elif case == "none_masked":
        mask[:] = True
    # radixes as the engine builds them: (hi - lo) // step + 2, vocab + 1
    hi0 = int(k0[v0].max()) if v0.any() else lo0
    lo = int(k0[v0].min()) if v0.any() else lo0
    radixes = [(hi0 - lo) // step + 2, 6]
    strides = [radixes[1], 1]
    k1 = k1.astype(np.int64)
    if case == "sentinel":  # (d1 + 1) * 1 + kd0 * stride0 wraps onto INT64_MAX at a few valid rows
        at = rng.choice(n, min(n, 5), replace=False)
        mask[at], v0[at], v1[at] = True, True, True
        kd0 = ((k0[at] - lo) // step + 1) * strides[0]
        k1[at] = np.int64((1 << 63) - 1) - kd0 - 1
    keys = [(k0.astype(np.int64), v0, lo, step, strides[0], True), (k1, v1, 0, 1, strides[1], False)]
    lanes = _red_lanes(rng, n, "csfFnxmMuc")
    score, desc, k = (0, False, 10) if case == "asc" else (1, True, 20 if case == "few_groups" else 10)
    if case == "floor_nan":
        score, desc = 3, False
    k = {"masked95": 1000, "all_masked": 20, "kk_above": n, "floor_nan": 1000}.get(case, k)
    return {"keys": keys, "mask": mask, "lanes": lanes, "score_lane": score, "desc": desc, "k": k}


SEG_REDUCE_SHAPES = ((1, "runs"), (1000, "runs"), (4096, "pow2_single"), (5000, "few_groups"), (100_003, "runs"),
                     (300_000, "giant_run"), (100_003, "asc"), (5000, "masked95"), (4096, "all_masked"),
                     (5000, "none_masked"), (3000, "kk_above"), (5000, "floor_nan"), (4_000_000, "masked95"))
# valid rows whose code is the sentinel: the reference's INT64_MAX run then
# holds their totals (at a row that is no valid run start)
SEG_REDUCE_EDGE_SHAPES = ((5000, "sentinel"), (100_003, "sentinel"))


def _red_args(lanes, dev):
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels.red import RedLane

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return [RedLane(op, t(d), t(v)) for op, d, v in lanes]


def p5_args(b: dict, dev):
    """seg_reduce's positional arguments on `dev` from a seg_reduce_battery."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels.seg_reduce import GroupKey

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    keys = [GroupKey(t(d), t(v), lo, step, st, is_int) for d, v, lo, step, st, is_int in b["keys"]]
    return keys, t(b["mask"]), _red_args(b["lanes"], dev), b["score_lane"], b["desc"], b["k"]


def _same_lane(g, w, what: str, rows=None) -> float:
    """One lane: integers bit for bit, floats within the tolerance (NaN
    equal), at `rows` (a bool mask) or everywhere."""
    if rows is not None:
        g, w = g[rows], w[rows]
    return _same(g, w, what, floats=g.is_floating_point())


def same_seg_reduce(got, want, what: str, lanes) -> float:
    """P5 outputs: the picks, keys, validity and (integer) scores bit for
    bit; the totals at the valid rows (run starts: the rows the picks can
    ship as valid) — integers exactly, floats within the tolerance."""
    _same(got.idx, want.idx, f"{what} picks")
    _same(got.fkey, want.fkey, f"{what} fkey")
    _same(got.fvalid, want.fvalid, f"{what} fvalid")
    ok = want.fvalid
    err = _same_lane(got.score, want.score, f"{what} score", ok)
    for j, (g, w) in enumerate(zip(got.totals, want.totals)):
        err = max(err, _same_lane(g, w, f"{what} lane {j} ({lanes[j].op})", ok))
    return err


def same_rows(got, want, valid_row: int, what: str, float_rows=()) -> float:
    """Packed result rows: every row up to the valid row bit for bit, the
    lane rows below it at the valid picks (floats by value within the
    tolerance)."""
    import torch

    _same(got[:valid_row + 1], want[:valid_row + 1], f"{what} key/valid rows")
    ok = want[valid_row] != 0
    err = 0.0
    for r in range(valid_row + 1, got.shape[0]):
        g, w = got[r, :ok.shape[0]][ok], want[r, :ok.shape[0]][ok]
        if r in float_rows:
            g, w = g.view(torch.float64), w.view(torch.float64)
        err = max(err, _same(g, w, f"{what} row {r}", floats=r in float_rows))
    return err


def rowpos_battery(rng, n: int, B: int, case: str) -> dict:
    """P6 inputs: build row ids (-1 where the join missed: masked), masked
    rows, lanes of every kind. 'presence': a dedicated presence lane
    first (not shipped), score on the int64 sum; 'count': the COUNT(*)
    lane is the presence; 'few': fewer matched build rows than k (the
    picks run out); 'wide': k 100; 'floor' / 'floor_asc': one row a build
    row, few of them matched, valid scores above, at (the sum -INT64_MAX,
    or INT64_MAX ascending) and below the floor (INT64_MIN, whose negation
    wraps onto itself), every build row picked; 'floor_float': float sums
    of -inf (a valid score at the floor -inf)."""
    import numpy as np

    if case.startswith("floor"):
        rid = rng.permutation(B)[:n].astype(np.int64)
        mask = rng.random(n) < 0.3
        if case == "floor_float":
            s = np.round(rng.random(n) * 1e4, 2)
            s[rng.random(n) < 0.3] = -np.inf
            lanes = [("count", None, None), ("sum_f64", s, np.ones(n, bool)), ("count", None, np.ones(n, bool))]
        else:
            s = rng.integers(-(1 << 40), 1 << 40, n)
            edge = rng.random(n)
            s[edge < 0.3] = -((1 << 63) - 1) if case == "floor" else (1 << 63) - 1
            s[(edge >= 0.3) & (edge < 0.5)] = -(1 << 63)
            lanes = [("count", None, None), ("sum_i64", s, np.ones(n, bool)), ("count", None, np.ones(n, bool))]
        return {"mask": mask, "rid": rid, "nseg": B, "lanes": lanes, "pres": 0, "score_lane": 1,
                "desc": case != "floor_asc", "k": B, "ship_from": 1}

    rid = rng.integers(0, B, n)
    if case == "few":
        rid = rng.choice(rng.integers(0, B, 5), n)
    hit = rng.random(n) > 0.1
    rid = np.where(hit, rid, -1).astype(np.int64)
    mask = hit & (rng.random(n) > 0.2)
    if case == "count":
        lanes, pres, score, ship = [("count", None, None)] + _red_lanes(rng, n, "sc"), 0, 1, 0
    else:
        lanes, pres, score, ship = [("count", None, None)] + _red_lanes(rng, n, "scfcncmcMcdc"), 0, 1, 1
    return {"mask": mask, "rid": rid, "nseg": B, "lanes": lanes, "pres": pres, "score_lane": score,
            "desc": True, "k": 100 if case == "wide" else 10, "ship_from": ship}


ROWPOS_SHAPES = ((1, 1, "presence"), (5000, 4096, "presence"), (5000, 4096, "count"), (20_000, 8192, "few"),
                 (100_003, 50_000, "wide"), (300_000, 1_000_000, "presence"), (2000, 1, "presence"),
                 (64, 64, "floor"), (64, 64, "floor_asc"), (64, 64, "floor_float"), (3000, 5000, "floor"),
                 (9000, 9000, "floor_asc"))


def p6_args(b: dict, dev):
    """rowpos_agg's positional arguments on `dev` from a rowpos_battery."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (t(b["mask"]), t(b["rid"]), b["nseg"], _red_args(b["lanes"], dev), b["pres"], b["score_lane"],
            b["desc"], b["k"], b["ship_from"])


def same_rowpos(got, want, what: str, lanes) -> float:
    """P6 outputs: the picks, group rows, validity and (integer) scores
    bit for bit; the [B] partial lanes — integers exactly, floats within
    the tolerance (K4 adds floats in another order)."""
    _same(got.idx, want.idx, f"{what} picks")
    _same(got.gidx, want.gidx, f"{what} gidx")
    _same(got.valid, want.valid, f"{what} valid")
    _same(got.score, want.score, f"{what} score")
    err = 0.0
    for j, (g, w) in enumerate(zip(got.full, want.full)):
        err = max(err, _same_lane(g, w, f"{what} lane {j} ({lanes[j].op})"))
    return err


def dense_battery(rng, n: int, case: str) -> dict:
    """P8 inputs: a dict-coded key (vocab 5) and an int key with NULLs
    ('mixed'), one int key over a narrow domain above 2^31 ('big_keys':
    the reference's int32 code wraps there as int64 would), a domain of
    20,000 ('global': beyond the shared-memory slots), no key at all
    ('no_keys'); keys outside their domain ('codes': below lo, past the
    domain, so codes land in a neighbour's slots, at or past nseg and
    below 0) and keys 2^31 and more away from lo ('wrap': int32 codes that
    turn negative, or wrap back into range); the count over the mask, then
    lanes of every kind (NaN and ±inf floats, uint64 min / max), with
    empty segments."""
    import numpy as np

    mask = rng.random(n) > 0.2
    spec = "scfcncxcmcMcdc"
    if case == "no_keys":  # a join aggregate without GROUP BY: every row codes 0, nseg 1
        keys = []
    elif case == "big_keys":
        lo, dom = 3_000_000_000 + int(rng.integers(0, 1000)), 50
        d = lo + rng.integers(0, dom, n)
        v = rng.random(n) > 0.05
        keys = [(np.where(v, d, 0).astype(np.int64), v, lo, dom)]
    elif case in ("codes", "wrap"):
        lo0, lo1, dom1 = int(rng.integers(-100, 100)), -(1 << 40) + 7, 30
        d0 = lo0 + rng.integers(-2, 7, n)  # dom 5: two below lo, two past the domain
        d1 = lo1 + rng.integers(-3, dom1 + 3, n)
        if case == "wrap":  # 2^31 and 2^32 + 3 away from lo: the int32 code wraps
            far = rng.random(n) < 0.1
            d1 = np.where(far, d1 + rng.choice([1 << 31, -(1 << 31), (1 << 32) + 3, (1 << 33)], n), d1)
        v0, v1 = rng.random(n) > 0.05, rng.random(n) > 0.05
        keys = [(np.where(v0, d0, 0).astype(np.int64), v0, lo0, 5),
                (np.where(v1, d1, 0).astype(np.int64), v1, lo1, dom1)]
        spec = "sFcncxcmcMc"
    else:
        dom1 = 20_000 if case == "global" else 40
        lo1 = int(rng.integers(-100, 100))
        d1 = lo1 + rng.integers(0, dom1 - 3, n)  # the domain's top codes stay empty
        v0, v1 = rng.random(n) > 0.05, rng.random(n) > 0.05
        keys = [(np.where(v0, rng.integers(0, 5, n), 0).astype(np.int64), v0, 0, 5),
                (np.where(v1, d1, 0).astype(np.int64), v1, lo1, dom1)]
    nseg = 1
    for *_, dom in keys:
        nseg *= dom + 1
    lanes = [("count", None, None)] + _red_lanes(rng, n, spec)
    return {"mask": mask, "keys": keys, "nseg": nseg, "lanes": lanes}


DENSE_SHAPES = ((1, "mixed"), (5000, "mixed"), (5000, "big_keys"), (100_003, "global"), (4_000_000, "mixed"),
                (1, "no_keys"), (100_003, "no_keys"))
# the edges of P8's fused code: codes out of range and wrapping int32 codes, no rows
DENSE_EDGE_SHAPES = ((5000, "codes"), (100_003, "codes"), (100_003, "wrap"), (0, "mixed"), (0, "no_keys"))


def p8_args(b: dict, dev):
    """dense_agg's positional arguments on `dev` from a dense_battery."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels.dense_agg import DenseKey

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    keys = [DenseKey(t(d), t(v), lo, dom) for d, v, lo, dom in b["keys"]]
    return t(b["mask"]), keys, b["nseg"], _red_args(b["lanes"], dev)


def same_dense(got, want, what: str, lanes) -> float:
    """P8 lanes: integers bit for bit, floats within the tolerance."""
    err = 0.0
    for j, (g, w) in enumerate(zip(got, want)):
        err = max(err, _same_lane(g, w, f"{what} lane {j} ({lanes[j].op})"))
    return err


# P5's local and final reduces over n_dev ranks (the exchange stands in for
# P2 and the all_to_all: every group arrives from n_dev peers, so the final
# runs hold n_dev fragments: the doubling's window is n_dev's power of two)
SEG_REDUCE_MESH_SHAPES = ((1000, "runs", 3), (100_003, "runs", 4), (300_000, "giant_run", 4), (5000, "few_groups", 8),
                          (5000, "masked95", 4), (4096, "all_masked", 2), (5000, "none_masked", 3),
                          (5000, "sentinel", 4), (5000, "floor_nan", 2))
# P6's picks from one rank's block of build rows (the collect stands in for
# psum_scatter / pmin / pmax: the rank's slice of its own partials)
ROWPOS_MESH_SHAPES = ((5000, 4096, "presence", 4, 1), (20_000, 8192, "few", 3, 2),
                      (300_000, 1_000_000, "presence", 4, 3), (5000, 4097, "count", 8, 7),
                      (64, 64, "floor", 4, 2), (4, 4, "presence", 4, 3))


def mode_kernel_cases(dev, rng):
    """(name, fn) of every P4 / P5 / P6 / P8 case: kernel against plain
    version, on the batteries above (the result rows too); P5's local and
    final reduces and P6's block picks of the multi-device modes."""
    import torch

    from tidb_tpu_torch.kernels import (dense_agg, dense_agg_ref, rowpos_agg, rowpos_agg_ref, seg_reduce,
                                        seg_reduce_ref, sort_join, sort_join_ref)

    cases = []
    for n, B, case in SORT_JOIN_SHAPES:
        args = p4_args(sort_join_battery(rng, n, B, case), dev)
        cases.append((f"sort_join n={n} B={B} {case}",
                      lambda args=args, case=case: same_sort_join(sort_join(*args), sort_join_ref(*args),
                                                                  f"sort_join {case}")))
    for n, case in SEG_REDUCE_SHAPES + SEG_REDUCE_EDGE_SHAPES:
        args = p5_args(seg_reduce_battery(rng, n, case), dev)

        def p5(args=args, case=case):
            nl = len(args[2])
            kk = min(args[5], args[1].shape[0])
            rows = [torch.zeros((2 + nl, kk + 3), dtype=torch.int64, device=dev) for _ in range(2)]
            got, want = seg_reduce(*args, rows=rows[0]), seg_reduce_ref(*args, rows=rows[1])
            err = same_seg_reduce(got, want, f"seg_reduce {case}", args[2])
            fl = {2 + j for j, ln in enumerate(args[2]) if ln.is_float}
            return max(err, same_rows(rows[0], rows[1], 1, f"seg_reduce {case} rows", fl))
        cases.append((f"seg_reduce n={n} {case}", p5))
    for n, B, case in ROWPOS_SHAPES:
        args = p6_args(rowpos_battery(rng, n, B, case), dev)

        def p6(args=args, case=case):
            from tidb_tpu_torch.kernels.rowpos_agg import picks

            lanes, ship = args[3], args[8]
            kk = picks(args[7], len(lanes), args[2])
            rows = [torch.zeros((2 + len(lanes) - ship, kk + 2), dtype=torch.int64, device=dev) for _ in range(2)]
            got, want = rowpos_agg(*args, rows=rows[0]), rowpos_agg_ref(*args, rows=rows[1])
            err = same_rowpos(got, want, f"rowpos_agg {case}", lanes)
            fl = {2 + j for j, ln in enumerate(lanes[ship:]) if ln.is_float}
            return max(err, same_rows(rows[0], rows[1], 1, f"rowpos_agg {case} rows", fl))
        cases.append((f"rowpos_agg n={n} B={B} {case}", p6))
    for n, case, n_dev in SEG_REDUCE_MESH_SHAPES:
        args = p5_args(seg_reduce_battery(rng, n, case), dev)

        def p5m(args=args, case=case, n_dev=n_dev):
            def ex(ukey, uvals, uvalid):  # every group from n_dev peers: final runs of n_dev
                return ukey.repeat(n_dev), [v.repeat(n_dev) for v in uvals], uvalid.repeat(n_dev)

            nl = len(args[2])
            kk = min(args[5], n_dev * args[1].shape[0])
            rows = [torch.zeros((2 + nl, kk + 3), dtype=torch.int64, device=dev) for _ in range(2)]
            got = seg_reduce(*args, rows=rows[0], exchange=ex, n_dev=n_dev)
            want = seg_reduce_ref(*args, rows=rows[1], exchange=ex, n_dev=n_dev)
            err = same_seg_reduce(got, want, f"seg_reduce local+final {case}", args[2])
            fl = {2 + j for j, ln in enumerate(args[2]) if ln.is_float}
            return max(err, same_rows(rows[0], rows[1], 1, f"seg_reduce local+final {case} rows", fl))
        cases.append((f"seg_reduce local+final n={n} n_dev={n_dev} {case}", p5m))
    for n, B, case, n_dev, rank in ROWPOS_MESH_SHAPES:
        args = p6_args(rowpos_battery(rng, n, B, case), dev)

        def p6m(args=args, case=case, n_dev=n_dev, rank=rank):
            from tidb_tpu_torch.kernels.rowpos_agg import picks

            lanes, ship, B = args[3], args[8], args[2]
            blk = -(-B // n_dev)

            def collect(full, ops):  # rank's block, as the collectives leave it
                return [f[rank * blk:(rank + 1) * blk] for f in full], rank * blk

            kk = picks(args[7], len(lanes), blk)
            rows = [torch.zeros((2 + len(lanes) - ship, kk + 2), dtype=torch.int64, device=dev) for _ in range(2)]
            got = rowpos_agg(*args, rows=rows[0], n_dev=n_dev, collect=collect)
            want = rowpos_agg_ref(*args, rows=rows[1], n_dev=n_dev, collect=collect)
            err = same_rowpos(got, want, f"rowpos_agg block picks {case}", lanes)
            fl = {2 + j for j, ln in enumerate(lanes[ship:]) if ln.is_float}
            return max(err, same_rows(rows[0], rows[1], 1, f"rowpos_agg block picks {case} rows", fl))
        cases.append((f"rowpos_agg block picks n={n} B={B} n_dev={n_dev} rank={rank} {case}", p6m))
    for n, case in DENSE_SHAPES + DENSE_EDGE_SHAPES:
        args = p8_args(dense_battery(rng, n, case), dev)
        for pad in (0, 2, 37):  # the packed result's rows: nseg wide, and wider (the engine's packed width)

            def p8(args=args, case=case, pad=pad):
                lanes, nseg = args[3], args[2]
                rows = torch.full((len(lanes) + 2, nseg + pad), -5, dtype=torch.int64, device=dev)
                got = dense_agg(*args, rows=rows[1:1 + len(lanes)])
                err = same_dense(got, dense_agg_ref(*args), f"dense_agg {case} rows [{nseg} + {pad}]", lanes)
                if not bool((rows[0] == -5).all() & (rows[-1] == -5).all() & (rows[:, nseg:] == -5).all()):
                    raise AssertionError(f"dense_agg {case}: wrote outside its rows' first {nseg} columns")
                if pad == 0:  # the wrapper's own rows
                    err = max(err, same_dense(dense_agg(*args), dense_agg_ref(*args), f"dense_agg {case}", lanes))
                return err
            cases.append((f"dense_agg n={n} {case} pad={pad}", p8))
    return cases


# --- the expression kernel, K4's bitwise ops and the mesh kernels ---------

EXPR_COLS = (("i", "i64"), ("u", "u64"), ("f", "f64"), ("d0", 0), ("d2", 2), ("d6", 6), ("d12", 12), ("dt", "date"),
             ("c", "i32"), ("k", "i64"))
F64_EDGES = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 5e-324, -1e-310, 2.2250738585072014e-308, 1e300,
             0.5, 2.5, -2.5, 3.5, 1e19, -1e19, 9.2233720368547748e18)


def expr_lanes(rng, n: int, copies: int = 1) -> dict:
    """{column: (numpy data, numpy valid, FieldType)} over every lane kind:
    int64 at its limits, uint64 above 2^63, float64 with NaN, ±inf, ±0.0,
    subnormals and values past 2^63, decimals at scales 0..12, dates, int32
    dict codes with -1, NULL rows (data zeroed). `copies` repeats the set
    (a wide program's columns)."""
    import numpy as np

    from tidb_tpu_torch.mysqltypes import field_type as F

    i64 = np.iinfo(np.int64)
    out = {}
    for rep in range(copies):
        for j, (name, kind) in enumerate(EXPR_COLS):
            if kind == "i64":
                d = np.where(rng.random(n) < 0.2, rng.choice(np.array([i64.min, i64.max, -1, 0, 1], np.int64), n),
                             rng.integers(-10**6, 10**6, n) if name == "i" else rng.integers(-3, 4, n))
                ft = F.ft_longlong()
            elif kind == "u64":
                d = (rng.integers(0, 1 << 63, n).astype(np.uint64)
                     | (rng.integers(0, 2, n).astype(np.uint64) << np.uint64(63))).view(np.int64)
                ft = F.ft_longlong(unsigned=True)
            elif kind == "f64":
                d = np.where(rng.random(n) < 0.3, rng.choice(np.array(F64_EDGES), n), rng.standard_normal(n) * 100)
                ft = F.ft_double()
            elif kind == "date":
                d = rng.integers(1992, 1999, n) * (13 * 32 * 24 * 3600 * 1_000_000) + rng.integers(0, 400, n)
                ft = F.FieldType(F.TypeCode.Date)
            elif kind == "i32":
                d = rng.integers(-1, 6, n).astype(np.int32)
                ft = F.ft_longlong()
            else:
                d = rng.integers(-10**12, 10**12, n)
                ft = F.ft_decimal(30, kind)
            v = rng.random(n) < 0.88
            out[rep * len(EXPR_COLS) + j] = (np.where(v, d, 0).astype(d.dtype), v, ft, kind)
    return out


def expr_kinds(cols: dict) -> dict:
    """The compiler's lane kinds of expr_lanes' columns (dates and
    decimals are int64 lanes)."""
    return {j: c[3] if c[3] in ("i64", "u64", "f64", "i32") else "i64" for j, c in cols.items()}


# the device builtins past arithmetic, compares and logic (expr/program.py
# EXT_OPS), each with a rule for its arguments: "n" args of any kind, a
# fixed count, or a maker of its own
EXT_BUILTINS = ("div", "intdiv", "mod", "xor", "istrue", "isfalse", "if", "ifnull", "coalesce", "case", "nullif",
                "abs", "sign", "ceil", "ceiling", "floor", "round", "truncate", "sqrt", "exp", "ln", "log", "log2",
                "log10", "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "cot", "degrees", "radians", "pi",
                "pow", "power", "greatest", "least", "year", "month", "day", "dayofmonth", "hour", "minute", "second",
                "microsecond", "date", "time_to_sec", "sec_to_time", "bitand", "bitor", "bitxor", "bitneg", "lshift",
                "rshift", "cast")
CAST_TARGETS = ("double", "signed", "unsigned", "dec2", "dec6", "date")


def _ext_tree(rng, name: str, depth: int, cols: dict):
    """A random call of device builtin `name` over subtrees."""
    from tidb_tpu_torch.expr.expression import FUNCS, Constant, ScalarFunc, make_func
    from tidb_tpu_torch.mysqltypes import field_type as F
    from tidb_tpu_torch.mysqltypes.datum import Datum

    def sub():
        return expr_tree(rng, depth - 1, cols)

    if name == "cast":
        tgt = str(rng.choice(CAST_TARGETS))
        ft = {"double": F.ft_double(), "signed": F.ft_longlong(), "unsigned": F.ft_longlong(unsigned=True),
              "dec2": F.ft_decimal(15, 2), "dec6": F.ft_decimal(20, 6), "date": F.FieldType(F.TypeCode.Date)}[tgt]
        return ScalarFunc(FUNCS["cast"], [sub()], ft)
    if name in ("round", "truncate"):  # a constant frac (the int and decimal paths read it on the host)
        args = [sub()]
        if name == "truncate" or rng.random() < 0.8:
            args.append(Constant(Datum.i(int(rng.integers(-3, 5))), F.ft_longlong()))
        e = make_func(name, *args)
        if e.ret_type.is_float() and len(args) == 2 and rng.random() < 0.3:  # a per-row frac on the float path
            e = make_func(name, args[0], sub())
            if not e.ret_type.is_float():
                e = make_func(name, *args)
        return e
    if name in ("lshift", "rshift"):
        count = Constant(Datum.i(int(rng.choice([0, 3, 62, 63, 64, 65, -1]))), F.ft_longlong())
        return make_func(name, sub(), count if rng.random() < 0.5 else sub())
    arity = FUNCS[name].arity
    lo, hi = (arity, arity) if isinstance(arity, int) else (arity[0], arity[1] or arity[0] + 3)
    return make_func(name, *[sub() for _ in range(int(rng.integers(lo, hi + 1)))])


def expr_tree(rng, depth: int, cols: dict):
    """A random tree over every device builtin of the port (expr/builtins*.py
    pushable), columns of `cols` and NULL, BIGINT UNSIGNED, float and
    decimal literals; sometimes a decimal product whose scale was capped
    (_round_div)."""
    from tidb_tpu_torch.expr import builtins  # noqa: F401 — the registry
    from tidb_tpu_torch.expr.expression import FUNCS, Column, Constant, ScalarFunc, make_func
    from tidb_tpu_torch.mysqltypes import field_type as F
    from tidb_tpu_torch.mysqltypes.datum import Datum
    from tidb_tpu_torch.mysqltypes.mydecimal import dec_from_string

    def col(j):
        return Column(j, cols[j][2], f"c{j}")

    if depth == 0 or rng.random() < 0.25:
        k = int(rng.integers(10))
        if k < 6:
            return col(int(rng.choice(list(cols))))
        if k == 6:
            return Constant(Datum.null(), F.ft_longlong())
        if k == 7:
            return Constant(Datum.u(int(rng.choice([(1 << 63) + 5, (1 << 64) - 1]))), F.ft_longlong(unsigned=True))
        if k == 8:
            return Constant(Datum.f(float(rng.choice([0.5, -0.0, 1e-320, 2.5, 1e19, -3.75]))), F.ft_double())
        return Constant(Datum.d(dec_from_string(str(rng.choice(["0.05", "-12.34", "100"])))), F.ft_decimal(30, 2))
    r = rng.random()
    if r < 0.3:
        op = str(rng.choice(["plus", "minus", "mul", "eq", "ne", "lt", "le", "gt", "ge", "nulleq", "and", "or"]))
        return make_func(op, expr_tree(rng, depth - 1, cols), expr_tree(rng, depth - 1, cols))
    if r < 0.42:
        return make_func(str(rng.choice(["unaryminus", "not", "isnull"])), expr_tree(rng, depth - 1, cols))
    if r < 0.5:
        return make_func("in", *[expr_tree(rng, depth - 1, cols) for _ in range(int(rng.integers(2, 6)))])
    if r < 0.95:
        return _ext_tree(rng, str(rng.choice(EXT_BUILTINS)), depth, cols)
    decs = [j for j, c in cols.items() if isinstance(c[3], int) and c[3] >= 2]
    a, b = int(rng.choice(decs)), int(rng.choice(decs))
    ps = cols[a][3] + cols[b][3]
    return ScalarFunc(FUNCS["mul"], [col(a), col(b)], F.ft_decimal(30, max(ps - 6, 0)))


def expr_specs(rng, cols: dict) -> list:
    """ValueSpecs of every derivation: plain values, valid lanes, the
    var / stddev lanes of a decimal and a float, bitwise rints."""
    from tidb_tpu_torch.expr.expression import Column
    from tidb_tpu_torch.expr.program import ValueSpec

    dec = [j for j, c in cols.items() if isinstance(c[3], int)]
    flt = [j for j, c in cols.items() if c[3] == "f64"]
    d, f = int(rng.choice(dec)), int(rng.choice(flt))
    return [ValueSpec(expr_tree(rng, 3, cols)), ValueSpec(expr_tree(rng, 2, cols), "valid"),
            ValueSpec(Column(d, cols[d][2]), "var_dec"), ValueSpec(expr_tree(rng, 2, cols), "var_f"),
            ValueSpec(Column(f, cols[f][2]), "bit"), ValueSpec(Column(d, cols[d][2]), "bit", cols[d][3]),
            ValueSpec(expr_tree(rng, 3, cols), "bit")]


def random_program(rng, cols: dict, kinds: dict, depth: tuple, nconds: tuple):
    """The program of random conditions (depths in `depth`, their count in
    `nconds`) and expr_specs; a draw whose rescale constant overflows int64
    (a trace the reference's device refuses too) is drawn again."""
    from tidb_tpu_torch.expr.program import compile_program

    while True:
        conds = [expr_tree(rng, int(rng.integers(*depth)), cols) for _ in range(int(rng.integers(*nconds)))]
        try:
            return compile_program(conds, expr_specs(rng, cols), kinds, mask=True)
        except OverflowError:
            continue


def _chain_expr(cols: dict, depth: int):
    """plus over the columns, `depth` deep, both nestings alternating."""
    from tidb_tpu_torch.expr.expression import Column, make_func

    ints = [j for j, c in cols.items() if c[3] in ("i64", "i32", 0, 2, 6, 12)]
    t = Column(ints[0], cols[ints[0]][2])
    for k in range(depth):
        c = Column(ints[k % len(ints)], cols[ints[k % len(ints)]][2])
        t = make_func("plus", t, c) if k % 2 else make_func("plus", c, t)
    return t


def expr_cases(dev, rng):
    """(name, fn) of every expr_eval case: kernel against plain version on
    identical programs (random trees, every derivation, a deep chain, a
    program past its register budget (lanes reloaded), one so wide it
    shrinks its block and reads its pointer table from device memory, the
    bitwise rint edges), N not a multiple of the block."""
    import numpy as np

    from tidb_tpu_torch.expr.expression import Column, make_func
    from tidb_tpu_torch.expr.program import ValueSpec, compile_program
    from tidb_tpu_torch.mysqltypes import field_type as F

    cases = []
    for n, ntrees in ((1, 4), (1000, 8), (100_003, 8), (2_000_003, 3)):
        cols = expr_lanes(rng, n)
        kinds = expr_kinds(cols)
        for j in range(ntrees):
            prog = random_program(rng, cols, kinds, (1, 5), (0, 4))
            cases.append((f"expr_eval random n={n} #{j}", prog, cols, n))
    n = 100_003
    cols = expr_lanes(rng, n)
    kinds = expr_kinds(cols)
    deep = make_func("gt", _chain_expr(cols, 300), _chain_expr(cols, 5))
    cases.append(("expr_eval deep chain 300", compile_program([deep], [ValueSpec(_chain_expr(cols, 200))], kinds),
                  cols, n))
    wide = make_func("and", make_func("gt", _chain_expr(cols, 9), _chain_expr(cols, 4)),
                     make_func("ne", _chain_expr(cols, 9), _chain_expr(cols, 3)))
    prog = compile_program([wide], [ValueSpec(_chain_expr(cols, 7))], kinds, max_regs=6)
    assert prog.reload and prog.nregs <= 6, "the register-split program must reload its lanes"
    cases.append(("expr_eval register split (reload)", prog, cols, n))
    many = expr_lanes(rng, 20_011, copies=20)  # 200 columns, 120 of them summed: 241 input lanes
    mkinds = expr_kinds(many)
    ints = [j for j, c in many.items() if c[3] in ("i64", 0, 2, 6, 12)]
    s1, s2 = Column(ints[0], many[ints[0]][2]), Column(ints[-1], many[ints[-1]][2])
    for j in ints[1:]:
        s1 = make_func("plus", s1, Column(j, many[j][2]))
    for j in ints[-2::-1]:
        s2 = make_func("minus", s2, Column(j, many[j][2]))
    prog = compile_program([make_func("lt", s1, s2)], [ValueSpec(s1), ValueSpec(s2)], mkinds)
    assert len(prog.inputs) > 192 and prog.nregs > 60, (len(prog.inputs), prog.nregs)
    cases.append(("expr_eval wide (120 lanes held)", prog, many, 20_011))
    edge = {0: (np.array(F64_EDGES * 4), np.ones(len(F64_EDGES) * 4, bool), F.ft_double(), "f64")}
    eprog = compile_program([], [ValueSpec(Column(0, edge[0][2]), "bit")], {0: "f64"}, mask=False)
    cases.append(("expr_eval bitwise rint edges", eprog, edge, len(F64_EDGES) * 4))

    def run(prog, cols, n):
        from tidb_tpu_torch.kernels import expr_eval, expr_eval_ref

        ins = _expr_ins(prog, cols, n, dev)
        got, want = expr_eval(prog, ins, n), expr_eval_ref(prog, ins, n)
        return _same_expr_outs(prog, got, want)

    return [(name, lambda p=p, c=c, n=n: run(p, c, n)) for name, p, c, n in cases]


def _expr_ins(prog, cols, n, dev):
    """The program's input lanes on `dev`, in slot order (mask_in: a row
    validity with a false tail)."""
    import numpy as np
    import torch

    ins = []
    for key in prog.inputs:
        if key[0] == "mask_in":
            a = np.ones(n, bool)
            a[n - n // 9:] = False
        else:
            a = cols[key[1]][0] if key[0] == "d" else cols[key[1]][1]
        ins.append(torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    return ins


def _same_expr_outs(prog, got, want) -> float:
    """Bool lanes and int lanes bit for bit, float lanes within the
    tolerance (NaN where NaN)."""
    import torch

    floats = {ref[1] for vo in prog.values for ref in vo.data if ref[0] == "out" and ref[2]}
    err = 0.0
    for j, (g, w) in enumerate(zip(got, want)):
        if j in floats:
            err = max(err, _same(g.view(torch.float64), w.view(torch.float64), f"output {j}", floats=True))
        else:
            _same(g, w, f"output {j}")
    return err


def bitwise_seg_cases(dev, rng):
    """(name, fn) of K4's and_i64 / or_i64 / xor_i64, in the direct mode
    (nseg 1: no key; else one NULL-able key whose top codes stay empty)
    and the segment-lane mode, nseg 1, 64, 65 and 65536."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels import SegKey, SegLane, seg_agg, seg_agg_ref

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    i64 = np.iinfo(np.int64)
    cases = []
    for nseg in (1, 64, 65, 65536):
        n = 200_003 if nseg == 65536 else 100_003
        mask = t(rng.random(n) < 0.8)
        xs = [np.where(rng.random(n) < 0.1, rng.choice(np.array([i64.min, i64.max, -1, 0], np.int64), n),
                       rng.integers(i64.min, i64.max, n, dtype=np.int64)) for _ in range(3)]
        lanes = [SegLane("count"), SegLane("and_i64", t(xs[0]), t(rng.random(n) < 0.9), -1),
                 SegLane("or_i64", t(xs[1]), t(rng.random(n) < 0.9), 0), SegLane("xor_i64", t(xs[2]), None, 0)]
        keys = [] if nseg == 1 else [SegKey(t(rng.integers(0, nseg - 4, n)), t(rng.random(n) < 0.95), 0, nseg - 1)]
        seg = t(rng.integers(0, nseg + nseg // 16 + 2, n).astype(np.int32))
        for mode, kw, kk in (("direct", {}, keys), ("segment-lane", {"seg": seg}, [])):
            def k4b(mask=mask, kk=kk, lanes=lanes, nseg=nseg, kw=kw):
                (gi, _), (wi, _) = seg_agg(mask, kk, lanes, nseg, **kw), seg_agg_ref(mask, kk, lanes, nseg, **kw)
                return _same(gi, wi, "bitwise partials")
            cases.append((f"seg_agg_bitwise {mode} nseg={nseg}", k4b))
    return cases


def seg_edge_cases(dev, rng):
    """(name, fn) of K4 at the edges of its design (csrc/seg_agg.cu), each
    against its plain version: nseg 1 with every row in one slot (the
    register mode at up to 4 lanes, the warp mode past them); the 128 rows
    a warp takes at once all in one segment, and in 32 distinct segments
    (each row a thread takes its own); NaN and ±inf among peers for
    min / max_f64; int64 sums that wrap inside one warp's fold; first_row
    with NULL rows among peers and segments of NULL rows only; the bitwise
    ops among peers; n of 1, below a block, and not a multiple of the 4
    rows a thread takes; block counts from 1 to a grid-stride past the
    card's (the last block's merge over 1, 2, 264 and 528 partials); the
    task grid with tasks whose real rows end at different points and its
    shared-output mode over segment lanes (group counts that differ, one
    task with no group), in the warp and the global modes."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels import SegKey, SegLane, seg_agg, seg_agg_ref
    from tidb_tpu_torch.kernels.grouped import seg_agg_tasks, seg_agg_tasks_ref

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    i64 = np.iinfo(np.int64)
    specials = np.array([np.nan, -np.inf, np.inf, -0.0, 0.0, 1.5, -2.5, 5e-324])

    def lanes_of(n, full: bool):
        valid = t(rng.random(n) < 0.5)
        big = t(np.where(rng.random(n) < 0.5, i64.max - rng.integers(0, 1000, n), (1 << 62) + rng.integers(0, 9, n)))
        f = np.where(rng.random(n) < 0.2, rng.choice(specials, n), rng.standard_normal(n))
        u = t(rng.integers(i64.min, i64.max, n, dtype=np.int64))
        ls = [SegLane("sum_i64", big, None), SegLane("min_f64", t(f), valid, float("inf")),
              SegLane("first_row", None, valid, n), SegLane("xor_i64", u, None, 0)]
        if full:
            ls += [SegLane("count", None, valid), SegLane("max_f64", t(f), None, float("-inf")),
                   SegLane("min_u64", u, valid, (1 << 64) - 1), SegLane("max_i64", big, valid, int(i64.min)),
                   SegLane("and_i64", u, valid, -1), SegLane("or_i64", u, None, 0),
                   SegLane("sum_f64", t(np.nan_to_num(f, posinf=7.0, neginf=-7.0)), valid), SegLane("count")]
        return ls

    def check(mask, keys, lanes, nseg, seg=None):
        kw = {} if seg is None else {"seg": seg}
        (gi, gf), (wi, wf) = seg_agg(mask, keys, lanes, nseg, **kw), seg_agg_ref(mask, keys, lanes, nseg, **kw)
        _same(gi, wi, "ints")
        return _same(gf, wf, "floats", True)

    cases = []
    for n in (1, 3, 5, 130, 2047, 2049, 2048 * 264, 2048 * 264 * 2 + 7):
        mask = t(np.ones(n, bool))
        for full in (False, True):
            ls = lanes_of(n, full)
            cases.append((f"seg_agg edges one slot n={n} lanes={len(ls)}",
                          lambda mask=mask, ls=ls: check(mask, [], ls, 1)))
    for n in (128, 4096 + 77, 100_003):
        rows = np.arange(n)
        ls = lanes_of(n, True)
        mask = t(rng.random(n) < 0.9)
        one = t(((rows // 128) % 5).astype(np.int32))  # a warp's 128 rows: one segment
        cases.append((f"seg_agg edges warp in one segment n={n}",
                      lambda mask=mask, k=one, ls=ls: check(mask, [SegKey(k, None, 0, 5)], ls, 6)))
        distinct = t(((rows // 4) % 32).astype(np.int32))  # each thread's 4 rows: a segment of their own
        cases.append((f"seg_agg edges 32 distinct segments n={n}",
                      lambda mask=mask, k=distinct, ls=ls: check(mask, [SegKey(k, None, 0, 32)], ls, 33)))
        nulls = t((rows // 128) % 3 != 1)  # every third warp's rows NULL: first_row folds n there
        ls2 = [SegLane("first_row", None, nulls, n), SegLane("count", None, nulls), SegLane("sum_i64", t(rows), nulls)]
        cases.append((f"seg_agg edges first_row NULL peers n={n}",
                      lambda mask=mask, k=one, ls=ls2: check(mask, [SegKey(k, None, 0, 5)], ls, 6)))
    # Q1's shape at block counts 1, 2, 264 and 528 (2,048 rows a block's pass)
    for n in (2048, 4097, 2048 * 264, 2048 * 528 + 3):
        keys, lanes, mask = seg_cases(dev, rng, n, NSEG_MAIN)
        cases.append((f"seg_agg edges merge n={n}", lambda m=mask, k=keys, ls=lanes: check(m, k, ls, NSEG_MAIN)))
    # the task grid: real rows ending at different points; the shared-output mode
    for G, width, nseg in ((5, 4096 + 5, 12), (3, 70_001, 65536)):
        masks, keys, lanes = [], [], []
        for g in range(G):
            kk, ls, m = seg_cases(dev, rng, width, nseg)
            m[width - g * (width // (G + 1)):] = False
            masks.append(m)
            keys.append(kk)
            lanes.append(ls)

        def k4t(masks=masks, keys=keys, lanes=lanes, nseg=nseg, w=width):
            (gi, gf), (wi, wf) = (seg_agg_tasks(masks, keys, lanes, nseg, w),
                                  seg_agg_tasks_ref(masks, keys, lanes, nseg, w))
            _same(gi, wi, "ints")
            return _same(gf, wf, "floats", True)
        cases.append((f"seg_agg_tasks edges ragged G={G} nseg={nseg}", k4t))
        counts = [int(c) for c in rng.integers(1, 40 if nseg == 12 else 30_000, G)]
        counts[1] = 0
        offs = np.concatenate([[0], np.cumsum(counts)])
        segs = [t((offs[g] + rng.integers(0, max(counts[g], 1), width) if counts[g] else
                   np.full(width, offs[-1])).astype(np.int32)) for g in range(G)]

        def k4s(masks=masks, lanes=lanes, segs=segs, counts=counts, w=width):
            tot = sum(counts)
            (gi, gf), (wi, wf) = (seg_agg_tasks(masks, [[]] * len(masks), lanes, tot, w, segs=segs, counts=counts),
                                  seg_agg_tasks_ref(masks, [[]] * len(masks), lanes, tot, w, segs=segs,
                                                    counts=counts))
            _same(gi, wi, "ints")
            return _same(gf, wf, "floats", True)
        cases.append((f"seg_agg_tasks edges shared outputs G={G} groups={sum(counts)}", k4s))
    return cases


def expr_edge_cases(dev, rng):
    """(name, fn) of the expression kernel at the edges of its design
    (csrc/expr_eval.cu): n of 1 and 2, below the 4 rows a thread takes, and
    not a multiple of 4 x a block; a program at REG_BUDGET that reloads its
    lanes (360 input lanes: the pointer table in device memory); and
    programs that together hold every opcode (`expr_opcodes`)."""
    from tidb_tpu_torch.expr.expression import Column, make_func
    from tidb_tpu_torch.expr.program import REG_BUDGET, ValueSpec, compile_program

    cases = []
    for n in (1, 2, 3, 5, 1023, 4 * 256 + 3, 4 * 256 * 7 + 1, 100_001):
        cols = expr_lanes(rng, n)
        kinds = expr_kinds(cols)
        for j, prog in enumerate(_opcode_programs(rng, cols, kinds)):
            cases.append((f"expr_eval edges n={n} #{j}", prog, cols, n))
    many = expr_lanes(rng, 20_011, copies=30)
    ints = [j for j, c in many.items() if c[3] in ("i64", 0, 2, 6, 12)]
    s1, s2 = Column(ints[0], many[ints[0]][2]), Column(ints[-1], many[ints[-1]][2])
    for j in ints[1:]:
        s1 = make_func("plus", s1, Column(j, many[j][2]))
    for j in ints[-2::-1]:
        s2 = make_func("minus", s2, Column(j, many[j][2]))
    prog = compile_program([make_func("lt", s1, s2)], [ValueSpec(s1), ValueSpec(s2)], expr_kinds(many))
    assert prog.reload and prog.nregs <= REG_BUDGET and len(prog.inputs) > 192, (prog.nregs, len(prog.inputs))
    cases.append(("expr_eval edges at REG_BUDGET (reload)", prog, many, 20_011))

    def run(prog, cols, n):
        from tidb_tpu_torch.kernels import expr_eval, expr_eval_ref

        ins = _expr_ins(prog, cols, n, dev)
        return _same_expr_outs(prog, expr_eval(prog, ins, n), expr_eval_ref(prog, ins, n))

    out = [(name, lambda p=p, c=c, n=n: run(p, c, n)) for name, p, c, n in cases]
    # K10's task mode over the directed trees (every op of the extended
    # instantiation): G tasks, each read to a narrowed width
    for G, n, w in ((1, 1000, 1000), (3, 5003, 4097), (7, 777, 640)):
        cols = [expr_lanes(rng, n) for _ in range(G)]
        prog = compile_program([make_func("ne", directed_trees(cols[0])[0], directed_trees(cols[0])[1])],
                               [ValueSpec(t) for t in directed_trees(cols[0])], expr_kinds(cols[0]))
        assert prog.ext
        ins = [_expr_ins(prog, c, n, dev) for c in cols]
        out.append((f"expr_eval_tasks edges G={G} n={n} width={w}", lambda p=prog, i=ins, w=w: _expr_tasks(p, i, w)))
    return out


def directed_trees(cols: dict) -> list:
    """Trees over expr_lanes' columns that together hold every opcode of the
    arithmetic, compares and logic and of the extended instantiation (the
    float MOD's product form too, and the fused multiply-add's signs)."""
    from tidb_tpu_torch.expr.expression import Column, Constant, make_func
    from tidb_tpu_torch.mysqltypes import field_type as F
    from tidb_tpu_torch.mysqltypes.datum import Datum

    def col(name):
        j = [c[0] for c in EXPR_COLS].index(name)
        return Column(j, cols[j][2], name)

    i, u, f, k, d2, dt, c, d6 = (col(n) for n in ("i", "u", "f", "k", "d2", "dt", "c", "d6"))
    one, null = Constant(Datum.i(1), F.ft_longlong()), Constant(Datum.null(), F.ft_longlong())
    two = Constant(Datum.i(2), F.ft_longlong())
    return [make_func("intdiv", i, k), make_func("div", d2, d2), make_func("year", dt), make_func("month", dt),
            make_func("truncate", d2, one), make_func("abs", i), make_func("greatest", i, k),
            make_func("least", i, k), make_func("greatest", u, i), make_func("bitand", i, k),
            make_func("bitor", i, k), make_func("bitxor", i, k), make_func("bitneg", i), make_func("lshift", i, k),
            make_func("rshift", u, k), make_func("xor", i, f), make_func("istrue", i), make_func("isfalse", f),
            make_func("if", k, i, f), make_func("ifnull", i, k), make_func("nullif", i, k),
            make_func("div", f, null), make_func("div", f, k), make_func("mod", f, k), make_func("mod", d2, f),
            make_func("abs", f), make_func("floor", f), make_func("ceil", f), make_func("truncate", f, one),
            make_func("round", f, two), make_func("sign", f), make_func("sqrt", f), make_func("pow", f, k),
            make_func("sin", f), make_func("log2", f), make_func("atan2", f, i), make_func("abs", c),
            make_func("plus", i, k), make_func("minus", i, k), make_func("mul", i, k), make_func("plus", f, i),
            make_func("minus", f, d2), make_func("mul", f, f), make_func("unaryminus", i),
            make_func("unaryminus", f), make_func("eq", d2, d6), make_func("in", i, k, one), make_func("and", i, f),
            make_func("or", i, k), make_func("not", f), make_func("isnull", i), make_func("plus", u, f),
            make_func("nulleq", i, null), make_func("round", d2, one), make_func("minus", f, f),
            make_func("plus", f, make_func("mul", f, d2)), make_func("minus", make_func("mul", f, k), f),
            make_func("plus", f, make_func("unaryminus", make_func("mul", f, f)))]


def _opcode_programs(rng, cols, kinds) -> list:
    """Programs over expr_lanes' columns that together hold every opcode
    but NOP: random trees with every derivation, then the directed trees
    (`directed_trees`), a float lane's var_dec limbs (F2I) and FLOOR."""
    from tidb_tpu_torch.expr.expression import Column, make_func
    from tidb_tpu_torch.expr.program import OP, ValueSpec, compile_program

    progs = [random_program(rng, cols, kinds, (2, 5), (1, 4)) for _ in range(24)]
    f = next(j for j, c in cols.items() if c[3] == "f64")
    fcol = Column(f, cols[f][2])
    progs.append(compile_program([], [ValueSpec(t) for t in directed_trees(cols)], kinds, mask=False))
    progs.append(compile_program([], [ValueSpec(fcol, "var_dec"), ValueSpec(make_func("floor", fcol))], kinds,
                                 mask=False))
    missing = set(OP) - {"NOP"} - expr_opcodes(progs)
    assert not missing, f"the battery's programs miss opcodes {sorted(missing)}"
    return progs


def expr_opcodes(progs) -> set:
    """The opcode names the programs hold."""
    from tidb_tpu_torch.expr.program import OP

    names = {v: k for k, v in OP.items()}
    return {names[int(c)] for p in progs for c in p.ops[:, 0]}


# --- K10's task-grid modes (kernels/grouped.py) --------------------------------

GROUP_SIZES = (1, 2, 3, 64)


def group_shapes(r: int):
    """(tiles, rows per tile, width) of a group: single-tile and
    multi-tile, at the padded width and narrowed."""
    return ((1, r, r), (1, r, r // 4), (3, r, 3 * r), (3, r, 2 * r + r // 4))


def _cut(x, w: int):
    return x.reshape(-1)[:w]


def _cut_enc(enc, w: int):
    """One task's lane narrowed to w flattened rows, as _narrow_args cuts
    it: positional payloads keep their first w rows, rle passes whole."""
    import torch

    if isinstance(enc, torch.Tensor):
        return _cut(enc, w)
    if "p" in enc:
        return {**enc, "p": _cut(enc["p"], w)}
    if "c" in enc:
        return {**enc, "c": _cut(enc["c"], w)}
    return enc


def _task_row_valid(dev, rng, t: int, r: int, w: int):
    """A task's row_valid: its real rows a prefix of at most w rows."""
    import torch

    rv = torch.zeros(t * r, dtype=torch.bool)
    rv[:int(rng.integers(w // 2, w + 1))] = True
    return rv.reshape(t, r).to(dev)


GROUP_KINDS = ("decode", "expr", "seg", "topk", "topn_multi", "sort_groups", "lex_sort")


def grouped_cases(dev, rng, r: int = 4096, sizes=GROUP_SIZES, kinds=GROUP_KINDS):
    """(name, fn) of every K10 case: each task-grid wrapper (the kernel on
    the card, the plain version on the CPU) against the SOLO plain version
    run task by task on the task's narrowed inputs. K1 over every codec
    (dense, pack at each code width, dict, rle, the all-valid alias); the
    expression kernel on random programs over every lane kind and a
    241-lane program; K4 over every op, the bitwise ones included, at nseg
    1, 12, 65 (shared memory) and 65536 (global atomics), one task of the
    group all masked; G in `sizes`, single- and multi-tile groups at the
    padded and a narrowed width; and the sort modes (sort_grouped_cases).
    Integers bit for bit, floats within rtol 1e-9 / atol 1e-6 (K4's float
    sums: atomics order them)."""
    import numpy as np
    import torch

    from tidb_tpu_torch.expr.program import compile_program
    from tidb_tpu_torch.kernels import SegLane, decode_lane_ref, expr_eval_ref, seg_agg_ref
    from tidb_tpu_torch.kernels.grouped import decode_lane_tasks, expr_eval_tasks, seg_agg_tasks
    from tidb_tpu_torch.kernels.seg_agg import SegKey

    cases = []
    for t, rr, w in group_shapes(r):
        for G in sizes:
            tag = f"G={G} [{t},{rr}] w={w}"
            rvs = [_task_row_valid(dev, rng, t, rr, w) for _ in range(G)]
            if "decode" in kinds:
                per_task = [{name: enc for name, enc, _ in decode_cases(dev, rng, t, rr)} for _ in range(G)]
                for task in per_task:
                    task["dense"] = torch.from_numpy(rng.integers(-10**9, 10**9, (t, rr))).to(dev)
                for codec in per_task[0]:
                    def k1(encs=[task[codec] for task in per_task], rvs=rvs, w=w):
                        got = decode_lane_tasks(encs, rvs, w)
                        err = 0.0
                        for g, (e, rv) in enumerate(zip(encs, rvs)):
                            want = decode_lane_ref(_cut_enc(e, w), _cut(rv, w)).reshape(-1)
                            err = max(err, _same(_cut(got[g], w), want, f"task {g}", floats=want.is_floating_point()))
                        return err
                    cases.append((f"decode_lane_tasks {codec} {tag}", k1))
            if "expr" in kinds:
                cols = [expr_lanes(rng, t * rr) for _ in range(G)]
                prog = random_program(rng, cols[0], expr_kinds(cols[0]), (1, 5), (1, 4))
                ins = [_expr_ins(prog, c, t * rr, dev) for c in cols]
                cases.append((f"expr_eval_tasks random {tag}", lambda p=prog, i=ins, w=w: _expr_tasks(p, i, w)))
            if "seg" in kinds:
                for nseg in (1, 12, 65, 65536):
                    if nseg == 65536 and G == 64:
                        continue  # the global path at G <= 3: a [64, k, 65536] plain version is slow
                    tasks = [seg_cases(dev, rng, t * rr, nseg, all_masked=(g == G - 1 and G > 1))
                             for g in range(G)]
                    for keys, lanes, _ in tasks:
                        x = [torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, t * rr, dtype=np.int64)).to(dev)
                             for _ in range(3)]
                        vb = torch.from_numpy(rng.random(t * rr) < 0.9).to(dev)
                        lanes += [SegLane("and_i64", x[0], vb, -1), SegLane("or_i64", x[1], vb, 0),
                                  SegLane("xor_i64", x[2], None, 0)]

                    def k4(tasks=tasks, nseg=nseg, w=w):
                        got_i, got_f = seg_agg_tasks([m for _, _, m in tasks], [k for k, _, _ in tasks],
                                                     [l for _, l, _ in tasks], nseg, w)
                        err = 0.0
                        for g, (keys, lanes, m) in enumerate(tasks):
                            wi, wf = seg_agg_ref(
                                _cut(m, w), [SegKey(_cut(k.data, w), None if k.valid is None else _cut(k.valid, w),
                                                    k.lo, k.dom) for k in keys],
                                [SegLane(l.op, None if l.data is None else _cut(l.data, w),
                                         None if l.valid is None else _cut(l.valid, w), l.fill) for l in lanes], nseg)
                            _same(got_i[g], wi, f"task {g} ints")
                            err = max(err, _same(got_f[g], wf, f"task {g} floats", True))
                        return err
                    cases.append((f"seg_agg_tasks nseg={nseg} {tag}", k4))
    if "expr" in kinds:
        # a program over 241 input lanes (the solo mode's device-memory
        # pointer table; every task-grid launch reads its tables there)
        n, w = 3 * r, 2 * r + 17
        many = [expr_lanes(rng, n, copies=20) for _ in range(2)]
        prog = _wide_program(many[0])
        ins = [_expr_ins(prog, c, n, dev) for c in many]
        cases.append((f"expr_eval_tasks wide (241 lanes) G=2 w={w}", lambda p=prog, i=ins, w=w: _expr_tasks(p, i, w)))
    return cases + sort_grouped_cases(dev, rng, r, sizes, kinds)


F_SPECIALS = (float("-inf"), -1.5, -0.0, 0.0, 1.5, float("inf"), float("nan"), -float("nan"), 5e-324,
              -2.5e-308, 2.5e-308)
I64_EDGES = (-(1 << 63), -(1 << 63) + 1, -1, 0, 1, (1 << 63) - 2, (1 << 63) - 1)


def _task_masks(dev, rng, rvs):
    """Each task's filter mask: its row_valid and 80 % of the rows; the
    last task of a group of two or more masks every row."""
    import torch

    out = []
    for g, rv in enumerate(rvs):
        keep = torch.from_numpy(rng.random(rv.numel()) < 0.8).to(dev)
        m = rv.reshape(-1) & keep
        out.append(torch.zeros_like(m) if g == len(rvs) - 1 and len(rvs) > 1 else m)
    return out


def _sort_key_lane(dev, rng, n: int, case: str, scale: int = 1):
    """One task's key lane for the sort modes' batteries."""
    import numpy as np
    import torch

    from tidb_tpu_torch.expr.xp_torch import U64

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if case == "price":
        return t(rng.integers(90000, 10500000, n))
    if case == "orderkey":
        return t(np.sort(rng.integers(1, max(n // (4 * scale), 2), n)))
    if case == "limits":
        return t(rng.choice(np.array(I64_EDGES, dtype=np.int64), n))
    if case == "floats":
        return t(rng.choice(np.array(F_SPECIALS), n))
    if case == "u64":
        return U64(t(rng.integers(0, 3, n) + (1 << 62) * rng.integers(-2, 2, n)))
    if case == "codes":
        return t(rng.integers(0, 7, n).astype(np.int32))
    return t(rng.integers(-5, 50, n))


def sort_grouped_cases(dev, rng, r: int, sizes, kinds):
    """(name, fn) of the sort modes of K10 against the SOLO plain versions
    task by task on narrowed inputs: K6 (int64 price, int64 keys at
    INT64_MIN / INT64_MAX - 1 with many ties, floats with NaN, ±inf, ±0.0
    and subnormals; NULL keys; both orders; k below the width and at it —
    a LIMIT past the width reaches K6 as k = width, the engine's clamp,
    which check_limit_past_width holds on the card), K7 (every key kind, uint64 and NULLs; k = 1, 50 and past
    the width: the engine's clamp takes the width), K9
    (sorted int keys whose group counts differ by task, NULL-able int and
    float keys, uint64 and dict-code keys, the int64 limits) with K4's
    segment-lane mode over its ids, and K8's task-leading mode alone (every
    operand kind, ties, a key wider than 64 bits, constant operands). Every
    group has tasks of different real row counts narrowed to one width,
    the last task (G > 1) all masked; G in `sizes`, single- and
    multi-tile."""
    import torch

    from tidb_tpu_torch.kernels import SegLane, lex_sort_perm_ref, seg_agg_ref, topk_ref
    from tidb_tpu_torch.kernels.grouped import (_cut, lex_sort_perm_tasks, seg_agg_tasks, sort_groups_tasks,
                                                topk_tasks)

    cases = []
    for t, rr, w in group_shapes(r):
        n = t * rr
        for G in sizes:
            tag = f"G={G} [{t},{rr}] w={w}"
            rvs = [_task_row_valid(dev, rng, t, rr, w) for _ in range(G)]
            masks = _task_masks(dev, rng, rvs)
            valids = [torch.from_numpy(rng.random(n) < 0.9).to(dev) for _ in range(G)]
            if "topk" in kinds:
                for case, k in (("price", min(100, w)), ("limits", min(5000, w)), ("floats", w)):
                    datas = [_sort_key_lane(dev, rng, n, case) for _ in range(G)]
                    vs = [None] * G if case == "price" else valids
                    for desc in (True, False):
                        def k6(datas=datas, vs=vs, masks=masks, desc=desc, k=k, w=w, G=G):
                            gi, go = topk_tasks(datas, vs, masks, desc, k, w)
                            for g in range(G):
                                wi, wo = topk_ref(_cut(datas[g], w), _cut(vs[g], w), _cut(masks[g], w), desc, k)
                                _same(gi[g], wi, f"task {g} rows")
                                _same(go[g], wo, f"task {g} ok bits")
                        cases.append((f"topk_tasks {case} desc={desc} k={k} {tag}", k6))
            if "topn_multi" in kinds:
                keys = [[(_sort_key_lane(dev, rng, n, "price"), None, True),
                         (_sort_key_lane(dev, rng, n, "codes"), v, False),
                         (_sort_key_lane(dev, rng, n, "floats"), v, True),
                         (_sort_key_lane(dev, rng, n, "u64"), None, False),
                         (_sort_key_lane(dev, rng, n, "limits"), v, True)] for v in valids]

                for k in (1, min(50, w), w + 5):
                    cases.append((f"topn_multi_tasks k={k} {tag}",
                                  lambda keys=keys, masks=masks, w=w, k=k: _k7_tasks(masks, keys, k, w)))
            if "sort_groups" in kinds:
                for case, spec in (("orderkey", [("orderkey", False)]), ("nullable_int_float", [("ints", True), ("floats", True)]),
                                   ("u64_codes", [("u64", False), ("codes", True)]), ("limits", [("limits", True)]),
                                   ("many_keys", [("codes", j == 7) for j in range(30)] + [("ints", True)] * 4)):
                    keys = [[(_sort_key_lane(dev, rng, n, c, scale=g + 1), v if nullable else None) for c, nullable in spec]
                            for g, v in enumerate(valids)]
                    cases.append((f"sort_groups_tasks {case} {tag}", lambda keys=keys, masks=masks, w=w: _k9_tasks(masks, keys, w)))
                keys = [[(_sort_key_lane(dev, rng, n, "orderkey", scale=g + 1), None)] for g in range(G)]
                lanes = [seg_cases(dev, rng, n, 1)[1] for _ in range(G)]
                for ls in lanes:
                    x = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype="int64")).to(dev)
                    ls += [SegLane("and_i64", x, valids[0], -1), SegLane("xor_i64", x, None, 0)]

                def k4(keys=keys, lanes=lanes, masks=masks, w=w):
                    grp = sort_groups_tasks(masks, keys, w)
                    total = sum(grp.counts)
                    if not total:
                        return 0.0
                    gi, gf = seg_agg_tasks(masks, [[] for _ in masks], lanes, total, w, segs=list(grp.seg),
                                           counts=grp.counts)
                    off, err = 0, 0.0
                    for g, c in enumerate(grp.counts):
                        if c:
                            cut = [SegLane(l.op, _cut(l.data, w), _cut(l.valid, w), l.fill) for l in lanes[g]]
                            wi, wf = seg_agg_ref(_cut(masks[g], w), [], cut, c, seg=_cut(grp.seg[g], w) - off)
                            _same(gi[:, off:off + c], wi, f"task {g} ints")
                            err = max(err, _same(gf[:, off:off + c], wf, f"task {g} floats", True))
                        off += c
                    return err
                cases.append((f"seg_agg_tasks segment-lane {tag}", k4))
            if "lex_sort" in kinds:
                per = [sort_cases(dev, rng, w) for _ in range(G)]
                for j, (cname, ops0) in enumerate(per[0]):
                    ops = [type(o)(torch.cat([p[j][1][q].data for p in per]), o.kind) for q, o in enumerate(ops0)]

                    def k8(ops=ops, w=w, G=G):
                        got = lex_sort_perm_tasks(ops, w)
                        for g in range(G):
                            want = lex_sort_perm_ref([type(o)(o.data[g * w:(g + 1) * w], o.kind) for o in ops])
                            _same(got[g * w:(g + 1) * w] - g * w, want, f"task {g}")
                    cases.append((f"lex_sort_tasks {cname} {tag}", k8))
    return cases


EDGE_GROUP_SIZES = (1, 7, 64)
# task widths: below one tile, a tile of 8-byte keys (4,096 rows) less one
# and plus one, a tile of 4-byte keys (6,144) plus one
EDGE_WIDTHS = (1000, 4095, 4097, 6145)


def sort_edge_cases(dev, rng, G: int, widths=EDGE_WIDTHS):
    """(name, fn) of K6's, K7's and K8's task modes at the edges of their
    designs, G tasks of each width, against the solo plain versions task
    by task. K8: a 26-bit word (4-byte keys; 32 bits with the task field
    of 64 tasks), a 48-bit word (8-byte keys), a 2-bit key of ties. K6: an
    int64 price key, a key every row ties on, float keys with NaN, ±inf,
    ±0.0 and subnormals (NULL-able); k = 1, 100, the ordering cap and one
    past it (K8 orders those) and k = width. K7: multikey_topn's keys
    (price DESC, a sorted orderkey, NULL-able linenumber-like codes), keys
    every row ties on (the row id decides), NULL-able floats with int32
    codes; k = 1, 50, its ordering cap, one past it (K8 orders those) and
    past the width. Random masks, the last task (G > 1) all masked."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels import lex_sort_perm_ref, topk_ref
    from tidb_tpu_torch.kernels.grouped import lex_sort_perm_tasks, topk_tasks
    from tidb_tpu_torch.kernels.topk import ORDER_CAP

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = []
    for w in widths:
        tag = f"G={G} w={w}"
        for cname in ("word32", "word64", "ties"):
            per = [sort_cases(dev, rng, w, (cname,))[0][1] for _ in range(G)]
            ops = [type(o)(torch.cat([p[q].data for p in per]), o.kind) for q, o in enumerate(per[0])]

            def k8(ops=ops, w=w, G=G):
                got = lex_sort_perm_tasks(ops, w)
                for g in range(G):
                    want = lex_sort_perm_ref([type(o)(o.data[g * w:(g + 1) * w], o.kind) for o in ops])
                    _same(got[g * w:(g + 1) * w] - g * w, want, f"task {g}")
            cases.append((f"lex_sort_tasks edge {cname} {tag}", k8))
        masks = [t(np.zeros(w, bool) if g == G - 1 and G > 1 else rng.random(w) < 0.8) for g in range(G)]
        valids = [t(rng.random(w) < 0.9) for _ in range(G)]
        keys = {"price": ([t(rng.integers(90000, 10500000, w)) for _ in range(G)], [None] * G),
                "tied": ([t(np.full(w, 11, np.int64)) for _ in range(G)], [None] * G),
                "floats": ([t(rng.choice(np.array(F_SPECIALS), w)) for _ in range(G)], valids)}
        for case, (datas, vs) in keys.items():
            for j, k in enumerate(sorted({1, min(100, w), min(ORDER_CAP, w), min(ORDER_CAP + 1, w), w})):
                desc = j % 2 == 0

                def k6(datas=datas, vs=vs, masks=masks, desc=desc, k=k, w=w, G=G):
                    gi, go = topk_tasks(datas, vs, masks, desc, k, w)
                    for g in range(G):
                        wi, wo = topk_ref(datas[g], vs[g], masks[g], desc, k)
                        _same(gi[g], wi, f"task {g} rows")
                        _same(go[g], wo, f"task {g} ok bits")
                cases.append((f"topk_tasks edge {case} desc={desc} k={k} {tag}", k6))
        multi = {"multikey": [[(t(rng.integers(90000, 10500000, w)), None, True),
                               (t(np.sort(rng.integers(1, w, w))), None, False),
                               (t(rng.integers(1, 8, w).astype(np.int32)), v, False)] for v in valids],
                 "tied": [[(t(np.full(w, 3, np.int64)), None, True), (t(np.full(w, 0.0)), None, False)]
                          for _ in range(G)],
                 "floats": [[(t(rng.choice(np.array(F_SPECIALS), w)), v, True),
                             (t(rng.integers(-3, 3, w).astype(np.int32)), v, False)] for v in valids]}
        for case, keys in multi.items():
            for k in sorted({min(k, w + 1) for k in (*MULTI_KS, w + 1)}):
                cases.append((f"topn_multi_tasks edge {case} k={k} {tag}",
                              lambda keys=keys, masks=masks, w=w, k=k: _k7_tasks(masks, keys, k, w)))
    return cases


def _k7_tasks(masks, keys, k: int, w: int) -> None:
    """K7's task mode against its solo plain version task by task on the
    narrowed lanes: rows and ok bits bit for bit."""
    from tidb_tpu_torch.kernels import topn_multi_ref
    from tidb_tpu_torch.kernels.grouped import _cut, topn_multi_tasks

    gi, go = topn_multi_tasks(masks, keys, k, w)
    for g in range(len(masks)):
        wi, wo = topn_multi_ref(_cut(masks[g], w), [(_cut(d, w), _cut(v, w), s) for d, v, s in keys[g]], k)
        _same(gi[g], wi, f"task {g} rows")
        _same(go[g], wo, f"task {g} ok bits")


def _k9_tasks(masks, keys, w: int) -> None:
    """K9's task mode against its solo plain version task by task (at
    capacity n_groups), the ids offset by the earlier tasks' counts."""
    import torch

    from tidb_tpu_torch.kernels import sort_groups_ref
    from tidb_tpu_torch.kernels.grouped import _cut, sort_groups_tasks

    got = sort_groups_tasks(masks, keys, w)
    want = [sort_groups_ref(_cut(m, w), [(_cut(d, w), _cut(v, w)) for d, v in ks], lambda ng: ng)
            for m, ks in zip(masks, keys)]
    counts = [x.n_groups for x in want]
    if got.counts != counts:
        raise AssertionError(f"n_groups {got.counts} vs {counts}")
    total, off = sum(counts), 0
    for g, x in enumerate(want):
        _same(got.perm[g * w:(g + 1) * w] - g * w, x.perm, f"task {g} perm")
        _same(got.seg[g], torch.where(x.seg < x.n_groups, x.seg + off, total).to(torch.int32), f"task {g} seg")
        _same(got.kval[:, off:off + x.n_groups], x.kval, f"task {g} kval")
        _same(got.kvalid[:, off:off + x.n_groups], x.kvalid, f"task {g} kvalid")
        off += x.n_groups


def _expr_tasks(prog, ins, w: int) -> float:
    from tidb_tpu_torch.kernels import expr_eval_ref
    from tidb_tpu_torch.kernels.grouped import expr_eval_tasks

    got = expr_eval_tasks(prog, ins, w)
    err = 0.0
    for g, task in enumerate(ins):
        want = expr_eval_ref(prog, [_cut(x, w) for x in task], w)
        err = max(err, _same_expr_outs(prog, [o[g] for o in got], want))
    return err


def _wide_program(many: dict):
    """`lt(s1, s2)` with s1 / s2 sums over the int lanes of 20 column
    copies, both returned: 241 input lanes, 60+ registers."""
    from tidb_tpu_torch.expr.expression import Column, make_func
    from tidb_tpu_torch.expr.program import ValueSpec, compile_program

    ints = [j for j, c in many.items() if c[3] in ("i64", 0, 2, 6, 12)]
    s1, s2 = Column(ints[0], many[ints[0]][2]), Column(ints[-1], many[ints[-1]][2])
    for j in ints[1:]:
        s1 = make_func("plus", s1, Column(j, many[j][2]))
    for j in ints[-2::-1]:
        s2 = make_func("minus", s2, Column(j, many[j][2]))
    prog = compile_program([make_func("lt", s1, s2)], [ValueSpec(s1), ValueSpec(s2)], expr_kinds(many))
    assert len(prog.inputs) > 192 and prog.nregs > 60, (len(prog.inputs), prog.nregs)
    return prog


def q1_battery(rng, n: int, nseg: int, case: str):
    """M1 inputs: Q1's lanes (wrapping products in 'overflow'; codes past
    nseg and negative in 'codes')."""
    import numpy as np

    qty, price = rng.integers(100, 5100, n), rng.integers(90000, 10500000, n)
    disc, tax = rng.integers(0, 11, n), rng.integers(0, 9, n)
    rf, ls = rng.integers(0, 3, n), rng.integers(0, 2, n)
    if case == "overflow":
        price[::3] = np.iinfo(np.int64).max // 7
    if case == "codes":
        rf = rng.integers(-2, 6, n)
    ship = rng.integers(0, 1000, n)
    rv = rng.random(n) < 0.97
    return (qty, price, disc, tax, rf, ls, ship, rv), 700


def q1_edge_shapes(n_sms: int) -> list:
    """(n, nseg, start) of M1's staged design at its edges: every start
    offset 0-15 (the row views of a shard) at a few tiles; n of 0, 1, a
    tile less one, a tile, a tile and one, one tile past the grid's first
    sweep and several sweeps (each stage's mbarrier reused); nseg 1-8 (each
    template of the staged kernel) and 9 (the wide path)."""
    from tidb_tpu_torch.kernels.q1_local import NS, STAGES, TILE

    sweep = n_sms * TILE
    shapes = [(3 * TILE + 5, 8, start) for start in range(16)]
    shapes += [(n, 8, start) for n in (0, 1, TILE - 1, TILE, TILE + 1, sweep + TILE, STAGES * sweep + 3 * sweep + 7)
               for start in (0, 9)]
    shapes += [(2 * TILE + 3, nseg, nseg % 16) for nseg in range(1, NS + 2)]
    return shapes


def repartition_battery(rng, n: int, n_dev: int, case: str):
    """M3 inputs: negative keys, some invalid rows; 'invalid' all rows
    invalid; 'small_cap' a cap below the largest bucket; 'full_last' the
    last owner exactly at its cap with invalid rows after it."""
    import numpy as np

    keys = rng.integers(-1000, 1000, n)
    payload = rng.integers(-(1 << 50), 1 << 50, n)
    valid = rng.random(n) < 0.85
    cap = n
    if case == "invalid":
        valid[:] = False
    elif case == "small_cap":
        cap = max(1, n // (2 * n_dev))
    elif case == "full_last":
        keys = np.full(n, n_dev - 1) + n_dev * rng.integers(-5, 5, n)
        valid[:] = False
        cap = max(1, n // 3)
        valid[:cap] = True
    return keys, payload, valid, cap


REPARTITION_TILE = 2048  # csrc/compact.cuh's TILE: the rows a tile of M3's sweep
REPARTITION_SHAPES = ((1, 1, "mixed"), (1000, 1, "small_cap"), (4097, 4, "mixed"), (4097, 4, "invalid"),
                      (100_003, 4, "small_cap"), (100_003, 1, "full_last"), (20_000, 4, "full_last"),
                      (4_000_000, 4, "mixed"), (4_000_000, 1, "mixed"),
                      (REPARTITION_TILE - 1, 1, "mixed"), (REPARTITION_TILE, 1, "mixed"),
                      (REPARTITION_TILE + 1, 1, "mixed"), (REPARTITION_TILE - 1, 3, "mixed"),
                      (REPARTITION_TILE, 3, "mixed"), (REPARTITION_TILE + 1, 3, "small_cap"),
                      (100_003, 1, "invalid"), (100_003, 2, "full_last"), (100_003, 31, "mixed"),
                      (20_000, 31, "full_last"), (20_000, 1024, "mixed"), (100_003, 1024, "small_cap"),
                      (3, 1024, "mixed"))


def mesh_kernel_cases(dev, rng):
    """(name, fn) of every M1 and M3 case against the plain versions."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels import hash_repartition, hash_repartition_ref, q1_local, q1_local_ref
    from tidb_tpu_torch.kernels.tables import sm_count

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = []
    for n, nseg, case in ((1, 6, "q1"), (1000, 6, "codes"), (100_003, 8, "overflow"), (100_003, 12, "codes"),
                          (4_000_000, 6, "q1")):
        lanes, cutoff = q1_battery(rng, n, nseg, case)
        args = [t(a) for a in lanes]

        def m1(args=args, nseg=nseg, cutoff=cutoff):
            return _same(q1_local(nseg, cutoff, *args), q1_local_ref(nseg, cutoff, *args), "partials")
        cases.append((f"q1_local n={n} nseg={nseg} {case}", m1))
    on_card = torch.device(dev).type == "cuda"
    for n, nseg, start in q1_edge_shapes(sm_count(torch.device(dev)) if on_card else 132):
        lanes, cutoff = q1_battery(rng, n + 16, nseg, "codes" if nseg < 6 else "overflow")
        # row views of a shard: lane k from row (start + k) % 16 of its own
        # tensor (byte offsets 0 or 8 modulo 16, mixed), the valid bytes
        # from byte `start` (any offset modulo 16)
        views = [t(a)[(start + k) % 16:][:n] for k, a in enumerate(lanes[:7])] + [t(lanes[7])[start:][:n]]

        def m1e(views=views, nseg=nseg, cutoff=cutoff):
            return _same(q1_local(nseg, cutoff, *views), q1_local_ref(nseg, cutoff, *views), "partials")
        cases.append((f"q1_local n={n} nseg={nseg} start={start}", m1e))
    for n, n_dev, case in REPARTITION_SHAPES:
        keys, payload, valid, cap = repartition_battery(rng, n, n_dev, case)
        args = (t(keys), t(payload), t(valid), n_dev, cap)

        def m3(args=args):
            for j, (g, w) in enumerate(zip(hash_repartition(*args), hash_repartition_ref(*args))):
                _same(g, w, f"output {j}")
            return 0.0
        cases.append((f"hash_repartition n={n} n_dev={n_dev} {case}", m3))
    return cases


def exchange_battery(rng, n: int, n_dev: int, case: str):
    """P2 inputs: two key lanes (a wide one with negative keys, both with
    NULLs), masked rows, lanes of 8, 4 and 1 bytes (a row id lane among
    them). 'probe' a probe side (a row whose key is NULL owns by its row
    index); 'i32' an int32 build key (NULL rows' keys wrap); 'masked' most
    rows masked; 'skew' every key on one owner, past its bucket."""
    import numpy as np

    k1 = rng.integers(-(1 << 40), 1 << 40, n)
    k2 = rng.integers(-700, 700, n)
    v1, v2 = rng.random(n) > 0.1, rng.random(n) > 0.1
    mask = rng.random(n) > (0.7 if case == "masked" else 0.1)
    lo, st, key_i32 = -(1 << 20), 1 << 21, case == "i32"
    if key_i32:
        lo, st = -5, 3
        k1 = np.where(v1, rng.integers(-5, 1000, n), k1)
    if case == "skew":
        k1, k2, v1, v2 = np.full(n, 3) + n_dev * rng.integers(-50, 50, n), np.zeros(n, np.int64), \
            np.ones(n, bool), np.ones(n, bool)
        lo, st = 0, 1
    lanes = [rng.integers(-(1 << 62), 1 << 62, n), rng.standard_normal(n), rng.random(n) > 0.5,
             rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32), np.arange(n, dtype=np.int64),
             rng.random(n) > 0.3]
    if case == "wide":  # past 40 lanes (the old scatter's chunk), an odd count of 1-byte lanes
        lanes += [rng.integers(-(1 << 62), 1 << 62, n) for _ in range(14)] + \
            [rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32) for _ in range(13)] + \
            [rng.random(n) > 0.5 for _ in range(13)]
    bcap = max(1, n // (4 * n_dev)) if case == "skew" else min(-(-n * 2 // n_dev) + 64, n)
    return n_dev, bcap, mask, [(k1, v1, lo, st), (k2, v2, 0, 1)], key_i32, case == "probe", lanes


# (rows, n_dev, case): tile edges (P2's tile is 2,048 rows: fewer rows than one, one row past 2), n_dev up to
# 64 (the most), 46 lanes ("wide": 15 of them 1-byte), and "garbage": the send buffer's memory filled with
# 0x5A bytes before the call
EXCHANGE_SHAPES = ((1, 2, "mixed"), (5000, 2, "mixed"), (4097, 3, "probe"), (20_000, 4, "i32"), (20_000, 8, "masked"),
                   (20_000, 8, "skew"), (100_003, 3, "skew"), (1_000_000, 4, "probe"), (1000, 4, "mixed"),
                   (2049, 5, "masked"), (50_000, 64, "mixed"), (4097, 64, "probe"), (30_000, 64, "skew"),
                   (20_001, 5, "wide"), (20_001, 4, "garbage"), (300_000, 7, "garbage"))


def exchange_cases(dev, rng):
    """(name, fn) of every P2 case: the send buffer and the dropped count
    against the plain version, bit for bit."""
    import numpy as np
    import torch

    from tidb_tpu_torch.kernels import exchange, exchange_ref
    from tidb_tpu_torch.kernels.exchange import OwnerKey, layout

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = []
    for n, n_dev, case in EXCHANGE_SHAPES:
        n_dev, bcap, mask, keys, key_i32, probe, lanes = exchange_battery(rng, n, n_dev, case)
        args = (n_dev, bcap, t(mask), [OwnerKey(t(d), t(v), lo, st) for d, v, lo, st in keys], key_i32, probe,
                [t(x) for x in lanes])

        def p2(args=args, case=case):
            if case == "garbage" and args[2].device.type == "cuda":
                # the caching allocator hands the send buffer this block again: no slot may rely on zeros
                _, words = layout(args[6], args[1])
                junk = torch.full((args[0] * words + 1,), 0x5A5A5A5A5A5A5A5A, dtype=torch.int64, device=args[2].device)
                del junk
            (gs, gd), (ws, wd) = exchange(*args), exchange_ref(*args)
            _same(gs, ws, "send buffer")
            _same(gd, wd, "dropped")
            if (int(wd[0]) > 0) != (case == "skew"):
                raise AssertionError(f"{case}: dropped {int(wd[0])}")
            return 0.0
        cases.append((f"exchange n={n} n_dev={n_dev} {case}", p2))
    return cases


def check_kernels(dev, rng) -> dict:
    """Every kernel against its plain version on the same tensors. All
    cases run; the failures are raised together at the end."""
    import torch

    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.kernels import (decode_lane, decode_lane_ref, lex_sort_perm, lex_sort_perm_ref,
                                        seg_agg, seg_agg_ref, sort_groups, sort_groups_ref, topk, topk_ref,
                                        topn_multi, topn_multi_ref)

    K.reset_launches()
    verdict = {name: 0.0 for name in K.launches()}
    errors: list[str] = []
    ncase = 0

    def case(name, fn):
        nonlocal ncase
        ncase += 1
        try:
            err = fn()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — gathered and raised below
            errors.append(f"{name}: {type(e).__name__}: {e}")
            return
        kernel = name.split()[0]
        verdict[kernel] = max(verdict[kernel], err or 0.0)

    for t, r in [(T_MAIN, R_MAIN), (1, 256), (3, 1024)]:
        for cname, enc, rv in decode_cases(dev, rng, t, r):
            def k1(enc=enc, rv=rv, cname=cname, t=t, r=r):
                got, want = decode_lane(enc, rv), decode_lane_ref(enc, rv)
                return _same(got, want, f"{cname} [{t},{r}]", floats=got.is_floating_point())
            case(f"decode_lane {cname} [{t},{r}]", k1)
    for name, fn in decode_many_cases(dev, rng):
        case(name, fn)
    for n, nseg, kw in ((T_MAIN * R_MAIN, NSEG_MAIN, {}), (T_MAIN * R_MAIN, NSEG_MAIN, {"overflow": True}),
                        (4096, 1, {}), (4096, 64, {}), (4096, 65, {}), (200_000, 65536, {}),
                        (4096, 12, {"all_masked": True})):
        keys, lanes, mask = seg_cases(dev, rng, n, nseg, **kw)

        def k4(mask=mask, keys=keys, lanes=lanes, nseg=nseg):
            (gi, gf), (wi, wf) = seg_agg(mask, keys, lanes, nseg), seg_agg_ref(mask, keys, lanes, nseg)
            _same(gi, wi, "ints")
            return _same(gf, wf, "floats", True)
        case(f"seg_agg n={n} nseg={nseg} {kw}", k4)
    # K4's segment-lane mode (the sort path), at the Q18 capacity: the
    # global-atomics regime
    for n, nseg in ((T_MAIN * R_MAIN, 1 << 22), (4096, 5)):
        _, lanes, mask = seg_cases(dev, rng, n, nseg)
        seg = torch.from_numpy(rng.integers(0, nseg + nseg // 16 + 2, n).astype("int32")).to(dev)

        def k4s(mask=mask, lanes=lanes, nseg=nseg, seg=seg):
            (gi, gf), (wi, wf) = seg_agg(mask, [], lanes, nseg, seg=seg), seg_agg_ref(mask, [], lanes, nseg, seg=seg)
            _same(gi, wi, "ints")
            return _same(gf, wf, "floats", True)
        case(f"seg_agg segment-lane n={n} nseg={nseg}", k4s)
    # n: the main path's, below one tile, and a tile of 8-byte keys (4,096
    # rows) and of 4-byte keys (6,144) less one, at it and plus one
    for n in (T_MAIN * R_MAIN, 1, 5, 4095, 4096, 4097, 6143, 6144, 6145, 100_000):
        for cname, ops in sort_cases(dev, rng, n):
            if n == T_MAIN * R_MAIN and cname in ("all_equal", "one_bit_ties"):
                continue
            case(f"lex_sort {cname} n={n}",
                 lambda ops=ops: _same(lex_sort_perm(ops), lex_sort_perm_ref(ops), "perm"))
        for cname, args in topk_cases(dev, rng, n):
            def k6(args=args):
                (gi, go), (wi, wo) = topk(*args), topk_ref(*args)
                _same(gi, wi, "rows")
                _same(go, wo, "ok bits")
            case(f"topk {cname} n={n}", k6)
        # the main path's n: the mixed keys only (the plain version sorts every row)
        for cname, mask, keys in multi_cases(dev, rng, n, MULTI_CASES[:1] if n == T_MAIN * R_MAIN else MULTI_CASES):
            for k in sorted({min(k, n + 1) for k in MULTI_KS}):
                def k7(mask=mask, keys=keys, k=k):
                    (gi, go), (wi, wo) = topn_multi(mask, keys, k), topn_multi_ref(mask, keys, k)
                    _same(gi, wi, "rows")
                    _same(go, wo, "ok bits")
                case(f"topn_multi {cname} k={k} n={n}", k7)
        for cname, mask, keys, cap in group_cases(dev, rng, n):
            cap_of = gcap_escalation if cap is None else (lambda ng, cap=cap: cap)
            case(f"sort_groups {cname} n={n}",
                 lambda mask=mask, keys=keys, cap_of=cap_of, cname=cname: _same_groups(
                     sort_groups(mask, keys, cap_of), sort_groups_ref(mask, keys, cap_of), cname))
    from tidb_tpu_torch.kernels import pack_flat, pack_flat_ref, window, window_ref

    for cname, (words, fargs, spec, rk) in window_cases(dev, rng):
        case(f"window {cname}", lambda words=words, fargs=fargs, spec=spec, rk=rk, cname=cname: _same_outs(
            window(words, fargs, spec, rk), window_ref(words, fargs, spec, rk), cname))
    for cname, lanes in pack_cases(dev, rng):
        case(f"pack_flat {cname}", lambda lanes=lanes, cname=cname: _same(
            pack_flat(lanes), pack_flat_ref(lanes), cname))
    for cname, fn in (mpp_kernel_cases(dev, rng) + mode_kernel_cases(dev, rng) + expr_cases(dev, rng)
                      + expr_edge_cases(dev, rng) + seg_edge_cases(dev, rng)
                      + bitwise_seg_cases(dev, rng) + mesh_kernel_cases(dev, rng) + exchange_cases(dev, rng)
                      + grouped_cases(dev, rng) + [c for G in EDGE_GROUP_SIZES for c in sort_edge_cases(dev, rng, G)]):
        case(cname, fn)
    if errors:
        raise AssertionError(f"{len(errors)} of {ncase} kernel cases failed:\n" + "\n".join(errors))
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
    for enc in encs:  # "re": the run ends K1 keeps in an rle lane, not an input of the function
        total += sum(x.numel() * x.element_size() for k, x in enc.items() if k not in ("b", "re"))
        out = enc["b"] if "p" in enc else enc["v"] if "c" in enc else enc["rv"]
        total += mirror.padded * out.element_size()
    return total


# (query, DAG builder of models/tpch.py, kernels its runs must launch)
QUERIES = (
    ("q1", "q1_dag", ("decode_lane", "expr_eval", "seg_agg")),
    ("q6", "q6_dag", ("decode_lane", "expr_eval", "seg_agg")),
    ("checksum", "checksum_dag", ("decode_lane", "expr_eval", "seg_agg", "seg_agg_bitwise")),
    ("tpch_topn", "topn_dag", ("topk",)),
    ("multikey_topn", "multikey_topn_dag", ("topn_multi",)),
    ("q18_inner", "q18_inner_dag", ("lex_sort", "sort_groups", "seg_agg")),
    ("fn_mix", "fn_mix_dag", ("decode_lane", "expr_eval", "seg_agg")),
    ("fn_math", "fn_math_dag", ("decode_lane", "expr_eval", "seg_agg")),
)
# queries whose answers hold doubles the device computes by its own rules
# (XLA's, which the reference's device follows: a decimal as a double is
# x * 10^-s, log2 is log(x) * (1 / ln 2), ...): held to the port's engine on
# the CPU (the plain versions) in every column, and to the host engine in
# the exact ones
DEVICE_FLOAT_QUERIES = ("fn_mix", "fn_math")
# kernels a query's runs must not launch: K6 and K7 order their LIMIT 100 /
# LIMIT 50 rows themselves, with no K8 sort
NOT_LAUNCHED = {"tpch_topn": ("lex_sort",), "multikey_topn": ("lex_sort",)}
SPIED = ("seg_agg", "topk", "topn_multi", "sort_groups")


def _spy(engine, captured: dict) -> None:
    """Record the last inputs of each kernel entry point of `engine`."""
    for name in SPIED:
        def wrapped(*a, _fn=getattr(engine, name), _name=name, **kw):
            captured[_name] = (a, kw)
            return _fn(*a, **kw)
        setattr(engine, name, wrapped)


class ExprSpy:
    """While active, records the (program, input lanes, rows) of every
    expr_eval call the expression programs make (expr/program.kernel), in
    `calls`."""

    def __init__(self):
        from tidb_tpu_torch.expr import program

        self.mod = program
        self.calls: list = []

    def __enter__(self):
        real = self.real = self.mod.kernel

        def spy(prog, ins, n):
            self.calls.append((prog, ins, n))
            return real()(prog, ins, n)
        self.mod.kernel = lambda: spy
        return self

    def __exit__(self, *exc):
        self.mod.kernel = self.real


def oracle(dag, batch):
    """The port's host engine on the same batch, then the same root step."""
    from tidb_tpu_torch.copr.host_engine import execute_dag_host
    from tidb_tpu_torch.executor.final_agg import merge_partials, order_by_keys, top_n

    part = execute_dag_host(dag, batch)
    if dag.topn is not None:
        return top_n(part, dag.topn.by, dag.topn.n)
    fts = [g.ret_type for g in dag.agg.group_by] + [a.ret_type for a in dag.agg.aggs]
    return order_by_keys(merge_partials([part], dag.agg.group_by, dag.agg.aggs, fts), dag.agg.group_by)


def chunks_equal(got, want, skip_floats: bool = False) -> str | None:
    """None when the chunks hold the same rows in the same order, exactly
    (with `skip_floats`, in every column but the float64 ones); else what
    differs."""
    import numpy as np

    if (got.num_rows, got.num_cols) != (want.num_rows, want.num_cols):
        return f"shape {got.num_rows}x{got.num_cols} vs {want.num_rows}x{want.num_cols}"
    for j, (g, w) in enumerate(zip(got.columns, want.columns)):
        if not np.array_equal(g.valid, w.valid):
            return f"column {j}: NULLs differ"
        if skip_floats and w.data.dtype == np.float64:
            continue
        gd, wd = g.data[g.valid], w.data[w.valid]
        same = gd.tolist() == wd.tolist() if wd.dtype == object else np.array_equal(gd, wd)
        if not same:
            return f"column {j}: values differ"
    return None


def chunks_close(got, want) -> str | None:
    """None when the chunks hold the same rows in the same order: float64
    columns within rtol 1e-9 / atol 1e-6 (NaN where NaN), the others
    exactly; else what differs."""
    import numpy as np

    if (got.num_rows, got.num_cols) != (want.num_rows, want.num_cols):
        return f"shape {got.num_rows}x{got.num_cols} vs {want.num_rows}x{want.num_cols}"
    for j, (g, w) in enumerate(zip(got.columns, want.columns)):
        if not np.array_equal(g.valid, w.valid):
            return f"column {j}: NULLs differ"
        gd, wd = g.data[g.valid], w.data[w.valid]
        if wd.dtype == np.float64:
            if gd.dtype != np.float64 or not np.allclose(gd, wd, rtol=1e-9, atol=1e-6, equal_nan=True):
                return f"column {j}: values differ past rtol 1e-9"
        elif (gd.tolist() != wd.tolist()) if wd.dtype == object else not np.array_equal(gd, wd):
            return f"column {j}: values differ"
    return None


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profiled_run(fn, engine, calls: int = 1) -> dict:
    """`calls` more warm runs of fn() in one torch.profiler session, with
    the engine's timer off: their wall (host clock), the time the card was
    busy (union of its kernel and copy spans), both per call, the spans
    seen and the idle share. The profiler adds host time, so the share is
    an upper bound of the unprofiled runs'; a session that saw no span
    says so with device_events 0."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.timer = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us(spans)
    return {"wall_ms": wall_us / 1e3 / calls, "device_busy_ms": busy / 1e3 / calls, "device_events": len(spans),
            "device_idle_share": max(0.0, 1.0 - busy / wall_us), "calls": calls}


# (query, spec builder of models/tpch.py): the window queries of the main path
WINDOW_QUERIES = (("window_sum_partition", "window_sum_partition_spec"),
                  ("window_rank_frames", "window_rank_frames_spec"))
WINDOW_NEEDS = ("decode_lane", "expr_eval", "lex_sort", "window", "pack_flat")


def run_window_path(dev, rows: int, seed: int, reps: int, card: str, out: dict) -> None:
    """The two window queries at `rows` through run_window on the card:
    one cold run and `reps` warm runs each, exact against the port's host
    route, their kernels' counters required to move. W1's and W2's inputs
    of each query's last run land in out["captured"][query]."""
    import torch

    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import batch_from_numpy, run_window
    from tidb_tpu_torch.executor import window_device as wd
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.torchenv import PhaseTimer

    t0 = time.perf_counter()
    batch = batch_from_numpy(tpch.LINEITEM, tpch.gen_lineitem(rows, seed))
    say("main.window_data", rows=rows, seed=seed, seconds=time.perf_counter() - t0)
    for qname, builder in WINDOW_QUERIES:
        dag, spec = getattr(tpch, builder)()
        engine = TorchEngine(dev)
        captured = out["captured"][qname] = {}
        real_window, real_pack = wd.window, wd.pack_flat

        def spy_window(*a, **kw):
            captured["window"] = (a, {k: v for k, v in kw.items() if k != "phase"})
            return real_window(*a, **kw)

        def spy_pack(outs):
            captured["pack_flat"] = outs
            return real_pack(outs)

        wd.window, wd.pack_flat = spy_window, spy_pack
        try:
            before = K.launches()
            runs = []
            for rep in range(reps + 1):  # the first run is cold: host prep + upload
                timer = PhaseTimer(engine.device)
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = run_window(dag, spec, batch, device=dev, engine=engine, timer=timer)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t, timer.totals_ms(), res))
            after = K.launches()
        finally:
            wd.window, wd.pack_flat = real_window, real_pack
        moved = {k: after[k] - before[k] for k in after}
        idle = [k for k in WINDOW_NEEDS if moved[k] == 0]
        if idle:
            raise AssertionError(f"{qname}: kernels {idle} were never launched")
        if any("prep" in r[1] for r in runs[1:]):
            raise AssertionError(f"{qname}: a warm run missed the device-input cache")
        t = time.perf_counter()
        want = run_window(dag, spec, batch, device="cpu", mode="host")
        host_s = time.perf_counter() - t
        for i, (_, _, res) in enumerate(runs):
            diff = chunks_equal(res, want)
            if diff is not None:
                raise AssertionError(f"{qname} run {i}: GPU answer differs from the host route's: {diff}\n"
                                     f"gpu:  {res.slice(0, 3).to_pylist()}\nhost: {want.slice(0, 3).to_pylist()}")
        if want.num_rows != rows or want.num_cols != len(spec[3]):
            raise AssertionError(f"{qname}: {want.num_rows}x{want.num_cols} result")
        warm = sorted(runs[1:], key=lambda x: x[0])
        med = warm[len(warm) // 2]
        prof = profiled_run(lambda: run_window(dag, spec, batch, device=dev, engine=engine), engine)
        (words, _, wspec, _), _ = captured["window"]
        out[qname] = {
            "rows": rows, "P": words[0].numel(), "funcs": [f[0] for f in wspec[2]],
            "cold_s": runs[0][0], "cold_phases_ms": runs[0][1],
            "warm_median_s": med[0], "warm_s": [r[0] for r in runs[1:]], "rows_per_s": rows / med[0],
            "phases_ms": med[1], "host_oracle_s": host_s,
            "launches_per_run": {k: c / (reps + 1) for k, c in moved.items() if c},
            "profiled_run": prof, "answer": want.slice(0, 3).to_pylist(), "card": card,
        }
        say(f"main.{qname}", **out[qname])


# --- plans from SQL, and their descriptions (tests/test_torch_mpp.py,
# tests/test_torch_planner.py and main.sql compare plans by these) -----------


def expr_desc(e):
    """An expression tree by node kind, column offset, constant and field
    type (tp, decimals, unsigned), whatever package built it."""
    ft = e.ret_type
    t = (int(ft.tp), ft.decimal, bool(ft.is_unsigned))
    if hasattr(e, "sig"):
        return (e.sig.name, t, [expr_desc(a) for a in e.args])
    if hasattr(e, "idx"):
        return ("col", e.idx, t)
    return ("const", repr(e.value), e.value.kind, t)


def agg_fn_desc(a):
    return (a.name, a.distinct, repr(a.ret_type), [expr_desc(x) for x in a.args], repr(a))


def frag_tree(f):
    """A fragment tree: join levels with their keys, conditions and
    exchanges; scans with their pushed conditions and output columns."""
    if hasattr(f, "probe"):
        return ("join", f.kind, f.probe_keys, f.build_keys, repr(f.post_conds), f.exchange,
                frag_tree(f.probe), frag_tree(f.build))
    ds = f.ds
    return ("scan", ds.table.name, ds.alias, f.side_offset, repr(ds.pushed_conds),
            [(pc.name, pc.orig_offset, repr(pc.ft)) for pc in ds.out_cols])


def agg_desc(agg):
    """The fused aggregation: group keys and aggregates with their types,
    and the final aggregate's output types."""
    if agg is None:
        return None
    return (repr(agg.group_by), [repr(g.ret_type) for g in agg.group_by], repr(agg.aggs),
            [(a.name, repr(a.ret_type), a.distinct) for a in agg.aggs], [repr(c.ft) for c in agg.out_cols])


def step_desc(step):
    """A RootStep by column offsets and types (the names a planner gives
    its sort keys are not part of the step)."""
    if step is None:
        return None
    return (list(step.proj), [(expr_desc(e), bool(d)) for e, d in step.by], step.n,
            [expr_desc(c) for c in step.having])


def mpp_desc(mplan) -> dict:
    """Every field of an MPPPlan that the engine and the steps above the
    gather read."""
    return {"explain": mplan.explain(), "root": frag_tree(mplan.root), "scans": [frag_tree(s) for s in mplan.scans],
            "agg": agg_desc(mplan.agg), "topn": mplan.topn, "out_cols": [(c.name, repr(c.ft)) for c in mplan.out_cols],
            "root_step": step_desc(getattr(mplan, "root_step", None))}  # the reference's MPPPlan has none


def cop_parts(plan) -> dict:
    """What the reference's executor builder pushes to the coprocessor for
    an optimized one-table plan (executors.py `_build_agg`, `_build_limit`):
    the scan's pushed conditions, the pushed aggregation, and a Limit over
    a Sort as a TopN whose keys are mapped through the projections below
    the Sort into the scan's columns."""
    from tidb_tpu_torch.planner.plans import Aggregation, DataSource, Limit, Projection, Sort

    node, above = plan, []
    while not isinstance(node, (DataSource, Aggregation)):
        above.append(node)
        node = node.children[0]
    agg = node if isinstance(node, Aggregation) else None
    ds = node.children[0] if agg is not None else node
    if not isinstance(ds, DataSource):
        raise AssertionError(f"not a one-table plan: {plan.pretty()}")
    topn = None
    for lim, srt in zip(above, above[1:]):
        if isinstance(lim, Limit) and isinstance(srt, Sort):
            by, below = list(srt.by), srt.children[0]
            while isinstance(below, Projection):
                by = [(below.exprs[e.idx], d) for e, d in by]
                below = below.children[0]
            if below is ds:
                topn = ([(expr_desc(e), bool(d)) for e, d in by], lim.count + lim.offset)
    return {"conds": [expr_desc(c) for c in ds.pushed_conds],
            "group_by": [expr_desc(g) for g in agg.group_by] if agg is not None else None,
            "aggs": [agg_fn_desc(a) for a in agg.aggs] if agg is not None else None, "topn": topn}


def dag_parts(dag) -> dict:
    """The same parts of a DAGRequest."""
    return {"conds": [expr_desc(c) for c in (dag.selection.conds if dag.selection is not None else [])],
            "group_by": [expr_desc(g) for g in dag.agg.group_by] if dag.agg is not None else None,
            "aggs": [agg_fn_desc(a) for a in dag.agg.aggs] if dag.agg is not None else None,
            "topn": ([(expr_desc(e), bool(d)) for e, d in dag.topn.by], dag.topn.n) if dag.topn is not None else None}


# (query, plan builder of models/tpch.py and its arguments, session
# variables, kernels its runs must launch, fusion outcome)
MPP_QUERIES = (
    ("q3_mpp", ("q3_mpp_plan",), {}, ("lut_join", "expr_eval", "run_agg", "block_topk"), "fused"),
    ("q10_mpp", ("q10_mpp_plan",), {}, ("lut_join",), "fused"),
    ("q18", ("q18_mpp_plan",), {}, ("sort_join", "lex_sort"), "unfused"),
    ("q3_unfused", ("q3_mpp_plan",), {"tidb_tpu_mpp_fused": "OFF"},
     ("expr_eval", "sort_join", "lex_sort", "seg_reduce", "topk"), "off"),
    ("q3_top100", ("q3_mpp_plan", 100), {}, ("lut_join", "expr_eval", "seg_agg", "rowpos_agg", "topk"), "fused"),
    ("seg_revenue", ("seg_revenue_mpp_plan",), {}, ("lut_join", "expr_eval", "dense_agg"), "fused"),
)
# the SQL constant of models/tpch.py each MPP query is planned from
MPP_SQL = {"q3_mpp": "Q3", "q10_mpp": "Q10", "q18": "Q18", "q3_unfused": "Q3", "q3_top100": "Q3_TOP100",
           "seg_revenue": "SEG_REVENUE"}
# (query, its SQL constant, the hand-built DAG its plan must push)
COP_SQL = (("q1", "Q1", "q1_dag"), ("q6", "Q6", "q6_dag"), ("tpch_topn", "TOPN", "topn_dag"),
           ("multikey_topn", "MULTIKEY_TOPN", "multikey_topn_dag"), ("q18_inner", "Q18_INNER", "q18_inner_dag"),
           ("checksum", "CHECKSUM", "checksum_dag"), ("fn_mix", "FN_MIX", "fn_mix_dag"),
           ("fn_math", "FN_MATH", "fn_math_dag"))


def catalog_session():
    """A store whose catalog holds models/tpch.py's lineitem, orders and
    customer and no rows: the MPP queries are planned over it, without
    ANALYZE, as the reference's setup_tpch leaves its tables."""
    import copy

    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.storage import Storage

    sess = StoreSession(Storage())
    for info in (tpch.LINEITEM, tpch.ORDERS, tpch.CUSTOMER):
        sess.create_table(copy.deepcopy(info))
    return sess


def plan_mpp(sess, qname: str, infoschema=None):
    """The MPPPlan of one query of MPP_QUERIES, planned from its SQL by
    entry.plan_select and entry.mpp_plan; a planning failure raises."""
    from tidb_tpu_torch import entry
    from tidb_tpu_torch.models import tpch

    variables = dict(next(v for q, _, v, _, _ in MPP_QUERIES if q == qname))
    plan = entry.plan_select(getattr(tpch, MPP_SQL[qname]), infoschema or sess.infoschema(), sess.current_db,
                             sess.store.stats, variables)
    mplan = entry.mpp_plan(plan, variables)
    if mplan is None:
        raise AssertionError(f"{qname}: the planner cut no MPP plan from its SQL")
    return mplan


def plan_phases_ms(sess, infoschema, sql: str, variables: dict, reps: int, cut: bool) -> dict:
    """Host milliseconds to parse, build, optimize and (for an MPP query)
    cut one statement: the median of `reps` runs of each phase, and of
    their sum."""
    from tidb_tpu_torch import entry
    from tidb_tpu_torch.parser import parse_one
    from tidb_tpu_torch.planner.builder import PlanBuilder
    from tidb_tpu_torch.planner.optimizer import optimize

    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        stmt = parse_one(sql)
        t1 = time.perf_counter()
        plan = PlanBuilder(infoschema, sess.current_db, context_info={"vars": variables}).build_select(stmt)
        t2 = time.perf_counter()
        plan = optimize(plan, sess.store.stats, variables)
        t3 = time.perf_counter()
        if cut and entry.mpp_plan(plan, variables) is None:
            raise AssertionError(f"no MPP plan for {sql!r}")
        t4 = time.perf_counter()
        runs.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3, (t4 - t3) * 1e3, (t4 - t0) * 1e3))
    med = dict(zip(("parse", "build", "optimize", "cut", "total"), (sorted(c)[len(c) // 2] for c in zip(*runs))))
    if not cut:
        del med["cut"]
    return med


def plan_sql(sess, reps: int = 10) -> dict:
    """Every MPP query and every cop query of the main path planned from its
    SQL over `sess`'s catalog, each held to its hand-built plan or DAG of
    models/tpch.py (mpp_desc; cop_parts against dag_parts, on the host:
    turning a plan into a DAG is the executors' work), with its planning
    phases timed (plan_phases_ms). Raises on any difference or failure."""
    from tidb_tpu_torch import entry
    from tidb_tpu_torch.models import tpch

    infoschema = sess.infoschema()
    out = {"mpp": {}, "equal": {}, "cop_equal": {}, "ms": {}, "rows_equal_oracle": {}}
    for qname, (builder, *bargs), variables, _, _ in MPP_QUERIES:
        out["ms"][qname] = plan_phases_ms(sess, infoschema, getattr(tpch, MPP_SQL[qname]), dict(variables), reps,
                                          cut=True)
        mplan = plan_mpp(sess, qname, infoschema)
        got, want = mpp_desc(mplan), mpp_desc(getattr(tpch, builder)(*bargs))
        differ = [k for k in want if got[k] != want[k]]
        if differ:
            raise AssertionError(f"{qname}: the plan from its SQL differs from the hand-built one in {differ}\n"
                                 f"planned: {[got[k] for k in differ]}\nhand:    {[want[k] for k in differ]}")
        out["mpp"][qname], out["equal"][qname] = mplan, True
    for qname, sql_name, dag in COP_SQL:
        sql = getattr(tpch, sql_name)
        out["ms"][qname] = plan_phases_ms(sess, infoschema, sql, {}, reps, cut=False)
        got = cop_parts(entry.plan_select(sql, infoschema, sess.current_db, sess.store.stats, {}))
        want = dag_parts(getattr(tpch, dag)())
        differ = [k for k in want if got[k] != want[k]]
        if differ:
            raise AssertionError(f"{qname}: the plan of {sql_name} pushes other {differ} than {dag}\n"
                                 f"planned: {[got[k] for k in differ]}\nhand:    {[want[k] for k in differ]}")
        out["cop_equal"][qname] = True
    return out


MPP_SPIED = ("lut_join", "run_agg", "block_topk", "sort_join", "seg_reduce", "rowpos_agg", "dense_agg")


def _top(keys, sums, k):
    """ORDER BY sum DESC, key LIMIT k."""
    import numpy as np

    return np.lexsort((keys, -sums))[:k]


def mpp_oracle(qname: str, li: dict, orders: dict, cust: dict) -> list[tuple]:
    """The MPP queries in plain numpy over the generated columns: dense key
    arrays for the joins (o_orderkey and c_custkey are 1..n, lineitem is
    sorted by l_orderkey), exact integer decimals (price scale 2 times
    (1 - discount) scale 2 → revenue scale 4; AVG of a scale-2 decimal at
    scale 6, rounded half up), np.add.reduceat per group, then HAVING,
    ORDER BY and LIMIT (ties, which these data do not hold at the cut, by
    the group key ascending). Rows as raw lane values."""
    import numpy as np

    from tidb_tpu_torch.mysqltypes.coretime import parse_datetime

    day = parse_datetime("1995-03-15")
    rev = li["l_extendedprice"] * (100 - li["l_discount"])
    if qname in ("q3_mpp", "q3_unfused", "q3_top100"):
        cust_ok = np.zeros(len(cust["c_custkey"]) + 1, dtype=bool)
        cust_ok[cust["c_custkey"]] = cust["c_mktsegment"] == "BUILDING"
        order_ok = np.zeros(len(orders["o_orderkey"]) + 1, dtype=bool)
        order_ok[orders["o_orderkey"]] = (orders["o_orderdate"] < day) & cust_ok[orders["o_custkey"]]
        sel = np.nonzero((li["l_shipdate"] > day) & order_ok[li["l_orderkey"]])[0]
        ok = li["l_orderkey"][sel]
        starts = np.nonzero(np.concatenate([[True], ok[1:] != ok[:-1]]))[0]
        keys, sums = ok[starts], np.add.reduceat(rev[sel], starts)
        top = _top(keys, sums, 100 if qname == "q3_top100" else 10)
        return [(int(k), int(s), int(orders["o_orderdate"][k - 1])) for k, s in zip(keys[top], sums[top])]
    if qname == "q18":
        ok = li["l_orderkey"]
        starts = np.nonzero(np.concatenate([[True], ok[1:] != ok[:-1]]))[0]
        keys, sums = ok[starts], np.add.reduceat(li["l_quantity"], starts)
        keep = sums > 100 * 100  # HAVING SUM(l_quantity) > 100, quantity at scale 2
        keys, sums = keys[keep], sums[keep]
        top = _top(keys, sums, 10)
        return [(int(k), int(s)) for k, s in zip(keys[top], sums[top])]
    if qname == "seg_revenue":
        sel = np.nonzero(li["l_shipdate"] > day)[0]
        seg = cust["c_mktsegment"][orders["o_custkey"][li["l_orderkey"][sel] - 1] - 1]
        out = []
        for name in sorted(set(seg.tolist())):
            rows = sel[seg == name]
            cnt, qty = len(rows), int(li["l_quantity"][rows].sum())
            avg = (qty * 10 ** 4 * 2 + cnt) // (2 * cnt)  # scale 2 → 6, half up
            out.append((name, cnt, int(rev[rows].sum()), avg, int(li["l_discount"][rows].min()),
                        int(li["l_extendedprice"][rows].max())))
        return out
    sel = np.nonzero(li["l_returnflag"] == "R")[0]
    ck = orders["o_custkey"][li["l_orderkey"][sel] - 1]
    order = np.argsort(ck, kind="stable")
    ck = ck[order]
    starts = np.nonzero(np.concatenate([[True], ck[1:] != ck[:-1]]))[0]
    keys, sums = ck[starts], np.add.reduceat(rev[sel][order], starts)
    top = _top(keys, sums, 20)
    return [(int(k), cust["c_name"][k - 1], int(s)) for k, s in zip(keys[top], sums[top])]


def chunk_rows(chunk) -> list[tuple]:
    return [tuple(c.data[i] if c.data.dtype == object else int(c.data[i]) for c in chunk.columns)
            for i in range(chunk.num_rows)]


def run_mpp_path(dev, rows: int, seed: int, reps: int, card: str, out: dict) -> None:
    """The MPP queries through run_mpp on the card at `rows` lineitem rows
    (with orders = rows/4 and customers = orders/10), each planned from
    its SQL (plan_sql over catalog_session, held to the hand-built plan
    first; out["sql"] keeps the planning times): one cold run and
    `reps` warm runs each, every answer equal, in order, to the port's
    engine on the CPU (the plain versions) and to a numpy oracle; each
    query's kernel counters must move, its fusion outcome be the
    reference's and a warm run upload nothing. The kernels' inputs of each
    query's extra untimed run land in out["captured"][query] (a list per
    kernel)."""
    import torch

    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.entry import run_mpp
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.parallel import mpp_program as mp
    from tidb_tpu_torch.parallel.mpp import MPPEngine
    from tidb_tpu_torch.torchenv import PhaseTimer

    t0 = time.perf_counter()
    catalog = out["sql_catalog"] = catalog_session()
    out["sql"] = plan_sql(catalog)
    say("main.sql_plans", equal=out["sql"]["equal"], cop_equal=out["sql"]["cop_equal"],
        seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    li, orders, cust = tpch.generated_columns(rows, seed)
    tables = {"lineitem": li, "orders": orders, "customer": cust}
    out["mpp_tables"], out["mpp_chunks"] = tables, {}
    say("main.mpp_data", rows=rows, orders=len(orders["o_orderkey"]), customers=len(cust["c_custkey"]),
        seed=seed, seconds=time.perf_counter() - t0)
    real = {k: getattr(mp, k) for k in MPP_SPIED}
    for qname, _, variables, needs, outcome in MPP_QUERIES:
        plan = plan_mpp(catalog, qname)
        engine = MPPEngine(dev)
        captured = out["captured"][qname] = {k: [] for k in MPP_SPIED}

        def spy(name):
            def call(*a, **kw):
                captured[name].append((a, kw))
                return real[name](*a, **kw)
            return call

        def timed():
            timer = PhaseTimer(engine.device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run_mpp(plan, tables, device=dev, engine=engine, timer=timer, variables=variables)
            torch.cuda.synchronize()
            return (time.perf_counter() - t, timer.totals_ms(),
                    dict(engine.last_host_s, h2d_bytes=engine.last_h2d_bytes), res)

        before = K.launches()
        runs = [timed() for _ in range(reps + 1)]  # the first run is cold: host prep + uploads
        # one more run, untimed, with the kernels' inputs captured
        for k in MPP_SPIED:
            setattr(mp, k, spy(k))
        try:
            with ExprSpy() as espy:
                spied = run_mpp(plan, tables, device=dev, engine=engine, variables=variables)
        finally:
            for k in MPP_SPIED:
                setattr(mp, k, real[k])
        captured["expr_eval"] = espy.calls
        after = K.launches()
        moved = {k: after[k] - before[k] for k in after}
        idle = [k for k in needs if moved[k] == 0]
        if idle:
            raise AssertionError(f"{qname}: kernels {idle} were never launched")
        if engine.fallbacks or engine.last_fuse_outcome != outcome:
            raise AssertionError(f"{qname}: outcome {engine.last_fuse_outcome} (want {outcome}), "
                                 f"fallbacks {engine.fallback_counts}")
        if any(r[2]["h2d_bytes"] for r in runs[1:]):
            raise AssertionError(f"{qname}: a warm run uploaded lanes ({[r[2] for r in runs]})")
        t = time.perf_counter()
        cpu = run_mpp(plan, tables, device="cpu", variables=variables)
        cpu_s = time.perf_counter() - t
        t = time.perf_counter()
        want = mpp_oracle(qname, li, orders, cust)
        oracle_s = time.perf_counter() - t
        if chunk_rows(cpu) != want:
            raise AssertionError(f"{qname}: the CPU engine differs from the numpy oracle\n"
                                 f"cpu:    {chunk_rows(cpu)[:3]}\noracle: {want[:3]}")
        for i, res in enumerate([r[3] for r in runs] + [spied]):
            diff = chunks_equal(res, cpu)
            if diff is not None:
                raise AssertionError(f"{qname} run {i}: GPU answer differs from the CPU engine's: {diff}\n"
                                     f"gpu: {chunk_rows(res)[:3]}\ncpu: {chunk_rows(cpu)[:3]}")
        out["mpp_chunks"][qname] = spied
        out["sql"]["rows_equal_oracle"][qname] = True  # the planned plan's rows, every run, in order
        warm = sorted(runs[1:], key=lambda x: x[0])
        med = warm[len(warm) // 2]
        prof = profiled_run(lambda: run_mpp(plan, tables, device=dev, engine=engine, variables=variables), engine)
        prog = next(iter(engine._programs.values()))
        am = prog.agg_meta
        out[qname] = {
            "lineitem_rows": rows, "result_rows": cpu.num_rows, "cold_s": runs[0][0],
            "cold_phases_ms": runs[0][1], "cold_host_s": runs[0][2],
            "warm_median_s": med[0], "warm_s": [r[0] for r in runs[1:]], "rows_per_s": rows / med[0],
            "phases_ms": med[1], "cpu_engine_s": cpu_s, "oracle_s": oracle_s,
            "launches_per_run": {k: c / (reps + 2) for k, c in moved.items() if c},
            "fuse": engine.last_fuse_outcome, "fuse_reasons": engine.last_fuse_reasons,
            "agg_mode": am["mode"] if am is not None else "rows",
            "clustered_reason": am.get("clustered_reason") if am is not None else None,
            "levels": [("lut" if lv.use_lut else f"sort mult {lv.mult}", lv.frag.exchange)
                       for lv in prog.levels.values()],
            "fallback_reason": engine.last_fallback_reason,
            "profiled_run": prof, "answer": want[:3], "card": card,
        }
        say(f"main.{qname}", **out[qname])


def measure_mpp_kernels(main: dict, max_err: dict):
    """The MPP kernels on the main path's own inputs, held once more to
    their plain versions (P3 and P4 on every level of every query), then
    timed beside them, their bytes bound and the nearest single PyTorch
    calls: P3, P7 and P9 on Q3 (P3 on its lineitem → orders level), P4 on
    Q18's duplicate-key level, P5 on unfused Q3, P6 on Q3 LIMIT 100, P8 on
    SEG_REVENUE. P4, P5 and P7 have no call that computes their function
    (`library_ms` None); the calls that do part of it are reported under
    their own names, and P4's and P5's K8 share as `k8_ms`."""
    import torch

    from tidb_tpu_torch.kernels import (block_topk, block_topk_ref, dense_agg, dense_agg_ref, lut_join,
                                        lut_join_ref, rowpos_agg, rowpos_agg_ref, run_agg, run_agg_ref,
                                        seg_reduce, seg_reduce_ref, sort_join, sort_join_ref)
    from tidb_tpu_torch.kernels.dense_agg import dense_code_ref
    from tidb_tpu_torch.kernels.rowpos_agg import picks
    from tidb_tpu_torch.kernels.seg_reduce import I64_MAX, group_code_ref
    from tidb_tpu_torch.kernels.sort_join import pack_keys

    bound = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
    # the kernel modules (the package re-exports their wrappers' names)
    p4_module, p5_module = (importlib.import_module(f"tidb_tpu_torch.kernels.{m}") for m in ("sort_join", "seg_reduce"))
    caps = main["captured"]
    cap = caps["q3_mpp"]
    for qname, *_ in MPP_QUERIES:  # every join level of every query
        for i, (a, kw) in enumerate(caps[qname]["lut_join"]):
            same_lut_join(lut_join(*a), lut_join_ref(*a), f"lut_join on {qname} level {i + 1}")
        for i, (a, _) in enumerate(caps[qname]["sort_join"]):
            same_sort_join(sort_join(*a), sort_join_ref(*a), f"sort_join on {qname} level {i + 1}")
    p3 = cap["lut_join"][0][0]
    keys, lo, size, stride, pmask, lut, bmask, brow, gathers = p3
    n, B = pmask.numel(), bmask.numel()
    p3_bytes = (_nbytes(pmask, lut, bmask, brow, *_pairs(keys), *_pairs(gathers))
                + n * (1 + 8) + sum(n * 9 for _ in gathers))
    idx = torch.clip(keys[0][0] - lo[0], 0, lut.numel() - 1)
    bsel = torch.clip(lut[idx].to(torch.int64), 0, B - 1)
    lane = gathers[0][0] if gathers else brow
    k3 = {"ms": time_ms(lambda: lut_join(*p3)), "plain_ms": time_ms(lambda: lut_join_ref(*p3), 3),
          "take_lut_ms": time_ms(lambda: torch.take(lut, idx)),
          "take_build_lane_ms": time_ms(lambda: torch.take(lane, bsel)),
          "bytes": p3_bytes, "n": n, "B": B, "lut_dom": lut.numel(), "gathers": len(gathers)}
    k3["library_ms"] = k3["take_lut_ms"] + k3["take_build_lane_ms"]

    p7 = cap["run_agg"][0][0]
    kd, mask, lanes = p7[0], p7[1], p7[2]
    max_err["run_agg"] = max(max_err["run_agg"], same_run_agg(run_agg(*p7), run_agg_ref(*p7), kd, "run_agg on Q3"))
    L = kd.numel()
    totals = run_agg(*p7)[0]
    p7_bytes = (_nbytes(kd, mask, *_pairs(lanes)) + _nbytes(*totals)
                + 8 * L + L + 8 * L)
    ilane = next(d for d, _ in lanes if d is not None and d.dtype == torch.int64)
    # no single call computes P7's function: the cumsum of one of its lanes
    # does less work (below P7's own bound), so it is reported apart
    k7 = {"ms": time_ms(lambda: run_agg(*p7)), "plain_ms": time_ms(lambda: run_agg_ref(*p7), 3),
          "library_ms": None, "cumsum_one_lane_ms": time_ms(lambda: torch.cumsum(ilane, 0)), "bytes": p7_bytes,
          "L": L, "lanes": len(lanes), "float_lanes": sum(d is not None and d.is_floating_point() for d, _ in lanes),
          **call_split(lambda: run_agg(*p7))}

    score, kk = cap["block_topk"][0][0][:2]
    max_err["block_topk"] = max(max_err["block_topk"], same_block_topk(
        block_topk(score, kk), block_topk_ref(score, kk), score, "block_topk on Q3"))
    k9 = {"ms": time_ms(lambda: block_topk(score, kk)), "plain_ms": time_ms(lambda: block_topk_ref(score, kk), 3),
          "library_ms": time_ms(lambda: torch.topk(score, kk)), "bytes": _nbytes(score), "n": score.numel(),
          "k": kk, **kernel_split(lambda: block_topk(score, kk))}

    # P4 on Q18's level: orders probe lineitem, duplicate keys, 4M slots
    p4 = caps["q18"]["sort_join"][0][0]
    pkeys, bkeys, lo4, st4, i32, pm, bm, br, mult, left, C, g4, pl4, pr4 = p4
    n4, B4 = pm.numel(), bm.numel()
    m4 = n4 if mult == 1 else C
    p4_bytes = (_nbytes(*_pairs(pkeys + bkeys + g4 + pl4), pm, bm, br, *pr4)
                + m4 * (1 + 8) + 9 * m4 * len(g4) + (9 * m4 * len(pl4) + 8 * m4 * len(pr4) if mult > 1 else 0))
    pk = pack_keys(pkeys, lo4, st4, i32)[0].contiguous()
    sk = torch.sort(pack_keys(bkeys, lo4, st4, i32)[0]).values
    # no single call computes P4's join; searchsorted into a build side that
    # is already sorted does less (reported apart), and K8's share is timed
    p4_k8_ops, p4_k8 = k8_inside(p4_module, lambda: sort_join(*p4))
    k4 = {"ms": time_ms(lambda: sort_join(*p4)), "plain_ms": time_ms(lambda: sort_join_ref(*p4), 3),
          "library_ms": None, "k8_ms": p4_k8, "k8_calls": len(p4_k8_ops),
          "k8_rows": [op[0].data.numel() for op in p4_k8_ops],
          "searchsorted_presorted_ms": time_ms(lambda: torch.searchsorted(sk, pk)),
          "bytes": p4_bytes, "n": n4, "B": B4, "slots": m4, "mult": mult, "gathers": len(g4)}
    # P4 on q3_unfused's first level: 4M lineitem probes into the 1M orders
    # (unique keys; the orders the date filter drops sort at the sentinel)
    q = caps["q3_unfused"]["sort_join"][0][0]
    qn, qB = q[5].numel(), q[6].numel()
    q_bytes = _nbytes(*_pairs(q[0] + q[1] + q[11]), q[5], q[6], q[7]) + qn * (1 + 8) + 9 * qn * len(q[11])
    q_k8_ops, q_k8 = k8_inside(p4_module, lambda: sort_join(*q))
    k4["q3_level1"] = {"ms": time_ms(lambda: sort_join(*q)), "plain_ms": time_ms(lambda: sort_join_ref(*q), 3),
                       "k8_ms": q_k8, "k8_rows": [op[0].data.numel() for op in q_k8_ops], "n": qn, "B": qB,
                       "bytes": q_bytes, "bound_ms": bound(q_bytes), "gathers": len(q[11])}

    def with_rows(call, a, kw):
        rows = torch.zeros_like(kw["rows"])
        return call(*a, rows=rows), rows

    def held(call, ref, a, kw, same, what):
        """(error, kernel rows, plain rows) of one call held to its plain version."""
        (g, gr), (w, wr) = with_rows(call, a, kw), with_rows(ref, a, kw)
        torch.cuda.synchronize()
        return same(g, w, what), gr, wr

    # P5 on unfused Q3: 4M rows of (o_orderkey, o_orderdate) codes
    a5, kw5 = caps["q3_unfused"]["seg_reduce"][0]
    err, gr, wr = held(seg_reduce, seg_reduce_ref, a5, kw5,
                       lambda g, w, what: same_seg_reduce(g, w, what, a5[2]), "seg_reduce on unfused Q3")
    fl = {2 + j for j, ln in enumerate(a5[2]) if ln.is_float}
    max_err["seg_reduce"] = max(max_err["seg_reduce"], err, same_rows(gr, wr, 1, "seg_reduce rows on Q3", fl))
    keys5, mask5, lanes5 = a5[0], a5[1], a5[2]
    n5 = mask5.numel()
    kk5 = min(a5[5], n5)
    code = group_code_ref(keys5, mask5)
    # what this run's data needs: the mask, and the keys and lanes of the
    # rows it keeps (a masked row's code is the sentinel whatever its keys)
    kept5 = int((code != I64_MAX).sum())
    row_bytes = sum(t.element_size() for t in _pairs((k.data, k.valid) for k in keys5)
                    + [t for ln in lanes5 for t in (ln.data, ln.valid) if t is not None])
    p5_bytes = _nbytes(mask5) + kept5 * row_bytes + 8 * kk5 * (2 + len(lanes5))
    # no single call computes P5's sorted aggregation; a sort of its group
    # code alone does less (reported apart), and K8's share is timed
    p5_k8_ops, p5_k8 = k8_inside(p5_module, lambda: with_rows(seg_reduce, a5, kw5))
    k5 = {"ms": time_ms(lambda: with_rows(seg_reduce, a5, kw5)),
          "plain_ms": time_ms(lambda: with_rows(seg_reduce_ref, a5, kw5), 3),
          "library_ms": None, "k8_ms": p5_k8, "k8_calls": len(p5_k8_ops), "kept_rows": kept5,
          "k8_rows": [op[0].data.numel() for op in p5_k8_ops],
          "sort_group_code_ms": time_ms(lambda: torch.sort(code, stable=True)), "bytes": p5_bytes, "n": n5,
          "lanes": len(lanes5), "k": kk5}

    # P6 on Q3 LIMIT 100: 1M orders as segments
    a6, kw6 = caps["q3_top100"]["rowpos_agg"][0]
    err, gr, wr = held(rowpos_agg, rowpos_agg_ref, a6, kw6,
                       lambda g, w, what: same_rowpos(g, w, what, a6[3]), "rowpos_agg on Q3 LIMIT 100")
    fl = {2 + j for j, ln in enumerate(a6[3][a6[8]:]) if ln.is_float}
    max_err["rowpos_agg"] = max(max_err["rowpos_agg"], err, same_rows(gr, wr, 1, "rowpos_agg rows on Q3", fl))
    mask6, rid6, B6, lanes6 = a6[0], a6[1], a6[2], a6[3]
    kk6 = picks(a6[7], len(lanes6), B6)
    p6_bytes = (_nbytes(mask6, rid6, *_pairs((ln.data, ln.valid) for ln in lanes6))
                + 8 * kk6 * (2 + len(lanes6) - a6[8]))
    seg6 = torch.where(mask6, torch.clip(rid6, 0, B6 - 1), B6)
    sl6 = lanes6[a6[5]]
    val6 = sl6.data if sl6.data is not None else torch.ones_like(rid6)
    acc6 = torch.zeros(B6 + 1, dtype=val6.dtype, device=val6.device)
    k6 = {"ms": time_ms(lambda: with_rows(rowpos_agg, a6, kw6)),
          "plain_ms": time_ms(lambda: with_rows(rowpos_agg_ref, a6, kw6), 3),
          "library_ms": time_ms(lambda: acc6.zero_().index_add_(0, seg6, val6)),
          "library_call": "index_add_ of the ORDER BY lane into the build rows", "bytes": p6_bytes,
          "n": mask6.numel(), "B": B6, "lanes": len(lanes6), "k": kk6,
          **rowpos_split(lambda: with_rows(rowpos_agg, a6, kw6))}

    # P8 on SEG_REVENUE: 6 segments, the count and five aggregates' lanes
    a8, kw8 = caps["seg_revenue"]["dense_agg"][0]
    mask8, keys8, nseg8, lanes8 = a8
    rows8 = torch.zeros_like(kw8["rows"])
    got8 = dense_agg(*a8, rows=rows8)
    max_err["dense_agg"] = max(max_err["dense_agg"], same_dense(got8, dense_agg_ref(*a8), "dense_agg on SEG_REVENUE",
                                                                lanes8))
    p8_in = _pairs((k.data, k.valid) for k in keys8) + _pairs((ln.data, ln.valid) for ln in lanes8)
    p8_bytes = _nbytes(mask8, *p8_in) + 8 * nseg8 * len(lanes8)
    seg8 = dense_code_ref(mask8, keys8, nseg8)
    sums8 = torch.stack([ln.data for ln in lanes8 if ln.op == "sum_i64"], dim=1)
    acc8 = torch.zeros((nseg8 + 1, sums8.shape[1]), dtype=torch.int64, device=sums8.device)
    k8 = {"ms": time_ms(lambda: dense_agg(*a8, rows=rows8)), "plain_ms": time_ms(lambda: dense_agg_ref(*a8), 3),
          "library_ms": time_ms(lambda: acc8.zero_().index_add_(0, seg8, sums8)),
          "library_call": "index_add_ of the stacked int64 sum lanes by the precomputed segment",
          "enqueue_ms": host_ms(lambda: dense_agg(*a8, rows=rows8)), "bytes": p8_bytes, "n": mask8.numel(),
          "nseg": nseg8, "lanes": len(lanes8), **call_split(lambda: dense_agg(*a8, rows=rows8))}
    Lc = main["launches"]

    def entry(name, src, ref, meas):
        return {"name": name, "route": "cuda", "source": f"tidb_tpu_torch/csrc/{src}",
                "replaces": f"tidb_tpu/parallel/mpp.py:{ref}", "launches": Lc[name],
                "max_abs_err": max_err[name], "ms": meas["ms"], "plain_ms": meas["plain_ms"],
                "bound_ms": bound(meas["bytes"]), "bound_by": "bytes", "library_ms": meas["library_ms"]}

    return ([entry("lut_join", "lut_join.cu", 1516, k3), entry("run_agg", "run_agg.cu", 1850, k7),
             entry("block_topk", "block_topk.cu", 2008, k9), entry("sort_join", "sort_join.cu", 1546, k4),
             entry("seg_reduce", "seg_reduce.cu", 1655, k5), entry("rowpos_agg", "rowpos_agg.cu", 1788, k6),
             entry("dense_agg", "seg_agg.cu", 1960, k8)],
            {"lut_join": k3, "run_agg": k7, "block_topk": k9, "sort_join": k4, "seg_reduce": k5,
             "rowpos_agg": k6, "dense_agg": k8})


# (query of MPP_QUERIES, its aggregation mode, kernels that must launch, its
# sort-probe levels are HASH): main.mpp_mesh over four ranks on the card
MESH_RANKS = 4
MESH_QUERIES = (
    ("q3_mpp", "clustered", ("lut_join", "run_agg", "block_topk"), False),
    ("q3_unfused", "sorted", ("exchange", "sort_join", "seg_reduce"), True),
    ("q3_top100", "rowpos", ("lut_join", "rowpos_agg"), False),
    ("seg_revenue", "dense", ("lut_join", "dense_agg"), False),
    ("q18", "rows", ("exchange", "sort_join"), True),
)


class MeshModeSpy:
    """While active, records what every rank hands P2, P5, P6 and P8 in
    parallel/mpp_program: calls["exchange"] P2's arguments, and
    calls["seg_reduce"] / calls["rowpos_agg"] / calls["dense_agg"] each
    call's (arguments, keywords, what its exchange / collect returned —
    None for P8, whose all-reduce follows the call): the collectives'
    outputs, so that a replay needs no mesh."""

    def __init__(self):
        from tidb_tpu_torch.parallel import mpp_program

        self.mp = mpp_program
        self.calls: dict = {"exchange": [], "seg_reduce": [], "rowpos_agg": [], "dense_agg": []}

    def __enter__(self):
        mp, calls = self.mp, self.calls
        real = self.real = {name: getattr(mp, name) for name in calls}

        def exchange(*a, **kw):
            calls["exchange"].append(a)
            return real["exchange"](*a, **kw)

        def recorded(name, hook=None):
            def spy(*a, **kw):
                fn, got = kw.get(hook), []
                if fn is not None:
                    kw = dict(kw, **{hook: lambda *x: got.append(fn(*x)) or got[-1]})
                res = real[name](*a, **kw)
                calls[name].append((a, {k: v for k, v in kw.items() if k != hook}, got[0] if got else None))
                return res
            return spy
        mp.exchange = exchange
        mp.seg_reduce = recorded("seg_reduce", "exchange")
        mp.rowpos_agg = recorded("rowpos_agg", "collect")
        mp.dense_agg = recorded("dense_agg")
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.mp, name, fn)


def hold_mesh_modes(calls: dict) -> dict:
    """Every rank's P5, P6 and P8 call of a mesh run (MeshModeSpy.calls)
    replayed against its plain version on the same inputs, the recorded
    exchange / collect outputs standing in for the collectives: P5's local
    reduce (the groups it hands the exchange) and its final reduce, picks
    and rows; P6's scatter into Bp build rows (the partials it hands the
    collectives) and its block picks and rows; P8's rank partials (what
    its all-reduce takes) into rows of the engine's packed width. → the
    largest float error per kernel (P8's where it was called)."""
    import torch

    from tidb_tpu_torch.kernels import (dense_agg, dense_agg_ref, rowpos_agg, rowpos_agg_ref, seg_reduce,
                                        seg_reduce_ref)

    err = {"seg_reduce": 0.0, "rowpos_agg": 0.0}
    for i, (a, kw, _) in enumerate(calls.get("dense_agg", [])):
        rows = torch.zeros_like(kw["rows"])
        err["dense_agg"] = max(err.get("dense_agg", 0.0), same_dense(dense_agg(*a, rows=rows), dense_agg_ref(*a),
                                                                     f"dense_agg, rank call {i}", a[3]))
    for i, (a, kw, out) in enumerate(calls.get("seg_reduce", [])):
        what, lanes, handed = f"seg_reduce local+final, rank call {i}", a[2], []
        if out is None:
            raise AssertionError(f"{what}: no exchange at n_dev {kw['n_dev']}")

        def ex(ukey, uvals, uvalid, out=out, handed=handed):
            handed.append((ukey, uvalid, uvals))
            return out
        rows = [torch.zeros_like(kw["rows"]) for _ in range(2)]
        got = seg_reduce(*a, rows=rows[0], exchange=ex, n_dev=kw["n_dev"])
        want = seg_reduce_ref(*a, rows=rows[1], exchange=ex, n_dev=kw["n_dev"])
        (gk, gv, gt), (wk, wv, wt) = handed
        _same(gk, wk, f"{what}: local group keys")
        _same(gv, wv, f"{what}: local group validity")
        e = max(_same_lane(g, w, f"{what}: local lane {j} ({lanes[j].op})", wv)
                for j, (g, w) in enumerate(zip(gt, wt)))
        fl = {2 + j for j, ln in enumerate(lanes) if ln.is_float}
        err["seg_reduce"] = max(err["seg_reduce"], e, same_seg_reduce(got, want, what, lanes),
                                same_rows(rows[0], rows[1], 1, f"{what} rows", fl))
    for i, (a, kw, out) in enumerate(calls.get("rowpos_agg", [])):
        what, lanes, handed = f"rowpos_agg block picks, rank call {i}", a[3], []
        if out is None:
            raise AssertionError(f"{what}: no collect at n_dev {kw['n_dev']}")

        def collect(full, ops, out=out, handed=handed):
            handed.append(full)
            return out
        rows = [torch.zeros_like(kw["rows"]) for _ in range(2)]
        got = rowpos_agg(*a, rows=rows[0], n_dev=kw["n_dev"], collect=collect)
        want = rowpos_agg_ref(*a, rows=rows[1], n_dev=kw["n_dev"], collect=collect)
        e = max(_same_lane(g, w, f"{what}: scattered lane {j} ({lanes[j].op})")
                for j, (g, w) in enumerate(zip(*handed)))
        fl = {2 + j for j, ln in enumerate(lanes[a[8]:]) if ln.is_float}
        err["rowpos_agg"] = max(err["rowpos_agg"], e, same_rowpos(got, want, what, lanes),
                                same_rows(rows[0], rows[1], 1, f"{what} rows", fl))
    return err


def run_mpp_mesh_path(dev, reps: int, card: str, out: dict) -> None:
    """main.mpp_mesh: the MPP queries of MESH_QUERIES, planned from their
    SQL (plan_mpp), through run_mpp over
    make_mesh(4, "cuda") — four ranks sharing the one card, their
    collectives through gloo — over main.mpp's tables: one cold run and
    `reps` warm runs each (Q18 one), every answer equal in order to the
    one-device chunk of main.mpp (held there to the CPU engine and a numpy
    oracle), the aggregation mode asserted, nothing dropped (no
    capacity_overflow), P2 launched where a level is HASH; the
    collectives' host-clock time per run (the slowest rank's) and one
    profiled run's idle share. What P2, P5, P6 and P8 were handed in one
    extra untimed run of the unfused Q3, of Q3 LIMIT 100 and of SEG_REVENUE
    (MeshModeSpy) lands in out["captured"]["mpp_mesh"]."""
    import torch

    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.entry import run_mpp
    from tidb_tpu_torch.parallel.mesh import make_mesh
    from tidb_tpu_torch.parallel.mpp import MPPEngine
    from tidb_tpu_torch.planner.fragment import HASH
    from tidb_tpu_torch.torchenv import PhaseTimer

    tables = out["mpp_tables"]
    variables_of = {q: v for q, _, v, _, _ in MPP_QUERIES}
    mesh = make_mesh(MESH_RANKS, dev)
    if mesh.n_dev != MESH_RANKS or mesh.backend != "gloo" or len({mesh.device(r) for r in range(MESH_RANKS)}) != 1:
        raise AssertionError(f"mpp_mesh: {mesh.n_dev} ranks over {mesh.backend}, not four sharing one card")
    label = f"{MESH_RANKS} ranks sharing one card, collectives through gloo (CUDA tensors staged by gloo via the host)"
    res_all = out["mpp_mesh"] = {}
    try:
        for qname, mode, needs, hashed in MESH_QUERIES:
            variables = variables_of[qname]
            plan = plan_mpp(out["sql_catalog"], qname)
            engine = MPPEngine(dev)

            def timed():
                timer = PhaseTimer(engine.device)
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = run_mpp(plan, tables, device=dev, engine=engine, timer=timer, variables=variables, mesh=mesh)
                torch.cuda.synchronize()
                return (time.perf_counter() - t, timer.totals_ms(), max(mesh.collective_s), mesh.collectives[0],
                        res)

            warm = 1 if qname == "q18" else reps
            before = K.launches()
            runs = [timed() for _ in range(warm + 1)]
            moved = {k: c - before[k] for k, c in K.launches().items()}
            idle = [k for k in needs if moved[k] == 0]
            if idle:
                raise AssertionError(f"mpp_mesh {qname}: kernels {idle} were never launched")
            if engine.fallbacks:
                raise AssertionError(f"mpp_mesh {qname}: fallbacks {engine.fallback_counts} (rows dropped?)")
            prog = next(iter(engine._programs.values()))
            am = prog.agg_meta
            got_mode = am["mode"] if am is not None else "rows"
            exchanges = [lv.frag.exchange for lv in prog.levels.values() if not lv.use_lut]
            if got_mode != mode or (hashed and (not exchanges or set(exchanges) != {HASH})):
                raise AssertionError(f"mpp_mesh {qname}: mode {got_mode} (want {mode}), levels {exchanges}")
            want = out["mpp_chunks"][qname]
            for i, r in enumerate(runs):
                diff = chunks_equal(r[4], want)
                if diff is not None:
                    raise AssertionError(f"mpp_mesh {qname} run {i}: differs from the one-device chunk: {diff}\n"
                                         f"mesh: {chunk_rows(r[4])[:3]}\none:  {chunk_rows(want)[:3]}")
            if qname in ("q3_unfused", "q3_top100", "seg_revenue"):  # P2's, P5's, P6's, P8's inputs: every call
                with MeshModeSpy() as spy:
                    run_mpp(plan, tables, device=dev, engine=engine, variables=variables, mesh=mesh)
                caught = out["captured"].setdefault("mpp_mesh", {k: [] for k in spy.calls})
                for k, v in spy.calls.items():
                    caught[k] += v
            prof = profiled_run(lambda: run_mpp(plan, tables, device=dev, engine=engine, variables=variables,
                                                mesh=mesh), engine)
            w = sorted(runs[1:], key=lambda x: x[0])
            med = w[len(w) // 2]
            res_all[qname] = {
                "ranks": MESH_RANKS, "lineitem_rows": len(tables["lineitem"]["l_orderkey"]),
                "result_rows": want.num_rows, "cold_s": runs[0][0], "warm_median_s": med[0],
                "warm_s": [r[0] for r in runs[1:]], "rank0_phases_ms": med[1],
                "collectives_s": med[2], "collectives_per_rank": med[3], "collectives": label,
                "launches_per_run": {k: c / (warm + 1) for k, c in moved.items() if c},
                "agg_mode": got_mode, "levels": [("lut" if lv.use_lut else f"sort mult {lv.mult}", lv.frag.exchange)
                                                 for lv in prog.levels.values()],
                "one_device_warm_median_s": out[qname]["warm_median_s"], "dropped": 0,
                "profiled_run": prof, "card": card,
            }
            say(f"main.mpp_mesh.{qname}", **res_all[qname])
    finally:
        mesh.close()
    p2 = exchange_timing(out["captured"]["mpp_mesh"]["exchange"])
    say("main.mpp_mesh", ranks=MESH_RANKS, collectives=label, queries=sorted(res_all),
        warm_median_s={q: r["warm_median_s"] for q, r in res_all.items()},
        cold_s={q: r["cold_s"] for q, r in res_all.items()},
        collectives_s={q: r["collectives_s"] for q, r in res_all.items()},
        idle_share={q: r["profiled_run"]["device_idle_share"] for q, r in res_all.items()},
        exchange_ms=p2["ms"], exchange_bound_ms=p2["bound_ms"], exchange_rows=p2["rows"], card=card)


def run_mesh_path(dev, cols: dict, card: str, out: dict) -> None:
    """The mesh entry on the card: entry()'s M1 step on its 4096 example
    rows, held to the plain version and to an exact numpy recompute; then
    dryrun_multichip(1) over the main path's own lineitem columns (M1 and
    the identity all_reduce, checked exact against a numpy recompute of
    all the rows; M3 and the identity all_to_all, which must drop nothing
    and preserve the payload's sum); then dryrun_multichip(2), whose stage
    3 runs TPC-H Q3 over two ranks sharing the card. M1's and M3's inputs
    (of the n = 1 run) land in out["captured"]["mesh"]."""
    import numpy as np
    import torch

    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.entry import dryrun_multichip, entry
    from tidb_tpu_torch.kernels import q1_local_ref
    from tidb_tpu_torch.parallel.mesh import build_q1_arrays, q1_exact

    before = K.launches()
    step, ex = entry(dev)
    got = torch.stack(step(*ex))
    spec, args = build_q1_arrays(4096, n_shards=1)
    torch.cuda.synchronize()
    _same(got, q1_local_ref(spec.nseg, spec.cutoff, *ex), "entry() step against the plain version")
    if not np.array_equal(got.cpu().numpy(), q1_exact(spec, args)):
        raise AssertionError("entry() step differs from the numpy recompute")
    t = time.perf_counter()
    res = dryrun_multichip(1, device=dev, columns=cols)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t
    t = time.perf_counter()
    dryrun_multichip(2, device=dev)  # stages 1-2 in two gloo processes, stage 3 on two ranks on the card
    torch.cuda.synchronize()
    dry2_s = time.perf_counter() - t
    moved = {k: c - before[k] for k, c in K.launches().items()}
    idle = [k for k in ("q1_local", "hash_repartition") if moved[k] == 0]
    if idle:
        raise AssertionError(f"mesh: kernels {idle} were never launched")
    out["captured"]["mesh"] = {"spec": res["spec"], "lanes": res["lanes"]}
    out["mesh"] = {"entry_rows": 4096, "entry_counts": got[0].tolist(), "dryrun_rows": res["rows"],
                   "dryrun_s": dry_s, "dryrun2_s": dry2_s, "counts": res["counts"],
                   "exchange_total": res["exchange_total"],
                   "dropped": res["dropped"], "launches": {k: c for k, c in moved.items() if c}, "card": card}
    say("main.mesh", **out["mesh"])


# --- the launch batcher's paths: grouped cop launches (K10) -----------------

N_TASKS, ROWS_PER_TASK = 64, 4096  # tools/bench_sched.py's workload
PROFILED_CALLS = 5  # run_many / run_burst calls in the burst's profiled session
# each solo kernel and its task-grid mode (K10)
TASK_MODES = {"decode_lane": "decode_lane_tasks", "expr_eval": "expr_eval_tasks", "seg_agg": "seg_agg_tasks",
              "topk": "topk_tasks", "topn_multi": "topn_multi_tasks", "lex_sort": "lex_sort_tasks",
              "sort_groups": "sort_groups_tasks"}
AGG_TASK_MODES = ("decode_lane_tasks", "expr_eval_tasks", "seg_agg_tasks")  # a filter / direct aggregation's
SORT_SOLO = ("topk", "topn_multi", "sort_groups", "lex_sort")  # never launched inside a group
# the task-grid wrappers the engine calls (copr/gpu_engine's names)
SPIED_TASKS = ("decode_lanes_tasks", "seg_agg_tasks", "topk_tasks", "topn_multi_tasks", "sort_groups_tasks")


class TaskSpy:
    """While active, records the (arguments, keywords) of every call of
    K10's task-grid wrappers the engine makes, in `calls[name]` (the
    expression kernel's under "expr_eval_tasks"); `task_args` picks them
    out."""

    def __init__(self):
        from tidb_tpu_torch.copr import gpu_engine
        from tidb_tpu_torch.expr import program

        self.eng, self.prog = gpu_engine, program
        self.calls: dict = {name: [] for name in SPIED_TASKS + ("expr_eval_tasks",)}

    def __enter__(self):
        self.real = {name: getattr(self.eng, name) for name in SPIED_TASKS}
        self.real_e = self.prog.kernel_tasks

        def rec(name, fn):
            def spy(*a, **kw):
                self.calls[name].append((a, kw))
                return fn(*a, **kw)
            return spy
        for name, fn in self.real.items():
            setattr(self.eng, name, rec(name, fn))
        spy_e = rec("expr_eval_tasks", self.real_e())
        self.prog.kernel_tasks = lambda: spy_e
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.eng, name, fn)
        self.prog.kernel_tasks = self.real_e


def task_args(calls: dict, name: str, keywords: bool = False) -> list:
    """The calls of `name` a TaskSpy recorded that passed no keywords, as
    their arguments; with `keywords`, those that did, as (arguments,
    keywords) — K4's mode over K9's task-grid ids."""
    return [(a, kw) if keywords else a for a, kw in calls.get(name, ()) if bool(kw) == keywords]


def _pcts(lat) -> dict:
    s = sorted(lat)
    return {"p50_ms": s[len(s) // 2] * 1e3, "p99_ms": s[min(len(s) - 1, int(len(s) * 0.99))] * 1e3,
            "samples": len(s)}


def _occupancy():
    from tidb_tpu_torch.utils import metrics as M

    h = M.SCHED_BATCH_OCCUPANCY
    return h._n, h._sum, list(h._counts)


# (mix, DAG builder of models/tpch.py) over tools/bench_sched.py's rows:
# the point aggregation, and the point TopN and multi-key TopN
BURST_MIXES = (("point_agg", "point_agg_dag"), ("point_topn", "point_topn_dag"),
               ("point_topn_multi", "point_topn_multi_dag"))


def in_kernel(dag) -> bool:
    """Whether a TopN DAG's rows are ordered by K6 or K7 themselves: its
    LIMIT within the kernel's ordering cap, so no K8 sort runs."""
    from tidb_tpu_torch.kernels.topk import orders_in_kernel as k6_orders
    from tidb_tpu_torch.kernels.topn_multi import orders_in_kernel as k7_orders

    k, nkeys = dag.topn.n, len(dag.topn.by)
    return k6_orders(k) if nkeys == 1 else k7_orders(k, nkeys)


def run_burst_path(dev, reps: int, card: str, out: dict) -> None:
    """tools/bench_sched.py's workload on the card: 64 tasks of 4,096 rows
    each, compression ON and OFF, for each mix of BURST_MIXES (point
    aggregations, point TopNs, point multi-key TopNs). Serial `execute` of
    each task, unbatched `execute` from 64 threads at once, then
    `run_many` (one call: one group of 64, one fetch) and `run_burst` x
    (reps + 1) (64 threads through the LaunchBatcher). Every chunk must
    equal the serial one and the host engine's, bit for bit (the workload
    is all INT); `run_many` must form the gcap-64 group with one fetch,
    launch each sort mode (K6's, K7's) that the serial runs' solo
    kernels need once for the group and no solo K6, K7, K8 or K9 inside
    it — and for both TopNs (k = 10, which K6 and K7 order themselves) no
    K8 at all, in the serial runs or in `run_many` (`k8_launches`) — the
    batcher a multi-task launch and no group that fell back to solo
    execute, and each task mode whose solo
    kernel the serial runs launched must launch in `run_many` and in
    `run_burst`. More `run_many` and `run_burst` calls run under
    torch.profiler. K10's inputs of the last calls land in
    out["captured"]["burst"] (the point aggregation's under its label,
    the others' under "<mix>.<label>")."""
    import torch

    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.copr.host_engine import execute_dag_host
    from tidb_tpu_torch.entry import concurrent, run_burst, run_many
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.sched import LaunchBatcher

    batches = tpch.point_agg_table(N_TASKS, ROWS_PER_TASK)
    out["burst"] = {}
    for mix, builder in BURST_MIXES:
        dag = getattr(tpch, builder)()
        pairs = [(dag, b) for b in batches]
        host = [execute_dag_host(dag, b) for b in batches]
        for comp in (True, False):
            label = "compression_on" if comp else "compression_off"
            key = label if mix == "point_agg" else f"{mix}.{label}"
            eng = TorchEngine(dev)
            eng.tile_compression = comp
            batcher = LaunchBatcher()

            def check(chunks, what):
                for i, (c, h) in enumerate(zip(chunks, host)):
                    diff = chunks_equal(c, h)
                    if diff is not None:
                        raise AssertionError(f"burst {key}: {what} task {i} differs from the host engine: {diff}")

            before = K.launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            serial = [eng.execute(d, b) for d, b in pairs]
            torch.cuda.synchronize()
            serial_s = time.perf_counter() - t
            solo = {k: c - before[k] for k, c in K.launches().items()}
            check(serial, "serial execute")
            unbatched = []
            for rep in range(reps + 1):
                res, lat = concurrent(eng.execute, pairs)
                check(res, "unbatched concurrent execute")
                if rep:
                    unbatched += lat
            f0, before = eng.fetches, K.launches()
            with TaskSpy() as spy:
                t = time.perf_counter()
                many = run_many(pairs, dev, eng)
                many_s = time.perf_counter() - t
            grouped = {k: c - before[k] for k, c in K.launches().items()}
            many_fetches = eng.fetches - f0
            check(many, "run_many")
            for i, (c, so) in enumerate(zip(many, serial)):
                diff = chunks_equal(c, so)
                if diff is not None:
                    raise AssertionError(f"burst {key}: run_many task {i} differs from its serial execute: {diff}")
            if many_fetches != 1:
                raise AssertionError(f"burst {key}: run_many fetched {many_fetches} times, not once")
            gcaps = sorted(((k[1], k[2]) for k in eng._vprograms), key=repr)
            if not any(g == N_TASKS for g, _ in gcaps):
                raise AssertionError(f"burst {key}: no group of {N_TASKS} formed ({gcaps})")
            idle = [TASK_MODES[k] for k in TASK_MODES if solo[k] and not grouped[TASK_MODES[k]]]
            if idle:
                raise AssertionError(f"burst {key}: task modes {idle} never launched")
            inside = {k: grouped[k] for k in SORT_SOLO if grouped[k]}
            if inside:
                raise AssertionError(f"burst {key}: solo kernels {inside} launched inside the group")
            not_once = {TASK_MODES[k]: grouped[TASK_MODES[k]] for k in SORT_SOLO
                        if solo[k] and grouped[TASK_MODES[k]] != 1}
            if not_once:
                raise AssertionError(f"burst {key}: sort modes {not_once} not launched once for the group")
            k8 = {"serial": solo["lex_sort"], "run_many": grouped["lex_sort"] + grouped["lex_sort_tasks"]}
            if dag.topn is not None and in_kernel(dag) and any(k8.values()):
                raise AssertionError(f"burst {key}: K8 launched {k8} for a TopN whose k = {dag.topn.n} "
                                     f"{'K6' if len(dag.topn.by) == 1 else 'K7'} orders itself")
            n0, s0, c0 = _occupancy()
            f0, before = eng.fetches, K.launches()
            burst = []
            for rep in range(reps + 1):
                res, lat = run_burst(pairs, dev, eng, batcher)
                check(res, "run_burst")
                if rep:
                    burst += lat
            n1, s1, c1 = _occupancy()
            launched = {k: c - before[k] for k, c in K.launches().items() if c - before[k]}
            if not (n1 > n0 and s1 - s0 > n1 - n0):
                raise AssertionError(f"burst {key}: the batcher formed no multi-task launch")
            idle = [TASK_MODES[k] for k in TASK_MODES if solo[k] and not launched.get(TASK_MODES[k])]
            if idle:
                raise AssertionError(f"burst {key}: run_burst never launched task modes {idle}")
            if batcher.serial_fallbacks:
                raise AssertionError(f"burst {key}: {batcher.serial_fallbacks} batcher groups fell back to solo "
                                     "execute (execute_many raised)")
            calls = reps + 1
            # more calls of each under torch.profiler: the card's busy time
            # (union of its spans) against the wall, and the idle share
            prof_many = profiled_run(lambda: run_many(pairs, dev, eng), eng, PROFILED_CALLS)
            prof_burst = profiled_run(lambda: run_burst(pairs, dev, eng, batcher), eng, PROFILED_CALLS)
            out["captured"].setdefault("burst", {})[key] = spy.calls
            out["burst"][key] = {
                "mix": mix, "tasks": N_TASKS, "rows_per_task": ROWS_PER_TASK, "serial_s": serial_s,
                "run_many_s": many_s, "unbatched_execute": _pcts(unbatched), "run_burst": _pcts(burst),
                "launches_per_task": {"serial": {k: c / N_TASKS for k, c in solo.items() if c},
                                      "run_many": {k: c / N_TASKS for k, c in grouped.items() if c},
                                      "run_burst": {k: c / (N_TASKS * calls) for k, c in launched.items()}},
                "fetches_per_call": {"serial_execute": 1, "run_many": many_fetches,
                                     "run_burst": (eng.fetches - f0) / calls}, "k8_launches": k8,
                "batcher_launches": n1 - n0, "batcher_tasks": s1 - s0,
                "occupancy_histogram": dict(zip(["<=1", "<=2", "<=4", "<=8", "<=16", "<=32", "<=64", "<=128",
                                                 "more"], [b - a for a, b in zip(c0, c1)])),
                "groups": gcaps, "profiled_run_many": prof_many, "profiled_run_burst": prof_burst, "card": card,
            }
            say(f"main.burst.{key}", **out["burst"][key])
    check_limit_past_width(dev, batches[:8], out)


def check_limit_past_width(dev, batches, out: dict) -> None:
    """The burst's TopN mixes at LIMIT 2 * ROWS_PER_TASK, past the width
    every task is narrowed to (its 4,096 rows), compression ON and OFF:
    one run_many forms one group whose K6 / K7 task mode takes k = width,
    launches it once, fetches once, and every task's chunk equals its
    serial `execute` and the host engine's."""
    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.copr.host_engine import execute_dag_host
    from tidb_tpu_torch.entry import batch_from_numpy, run_many
    from tidb_tpu_torch.models import tpch

    res = {}
    for mix, builder in BURST_MIXES[1:]:
        dag = getattr(tpch, builder)()
        dag.topn.n = 2 * ROWS_PER_TASK
        pairs = [(dag, b) for b in batches]
        mode = "topk_tasks" if mix == "point_topn" else "topn_multi_tasks"
        for comp in (True, False):
            key = f"{mix}.{'compression_on' if comp else 'compression_off'}"
            eng = TorchEngine(dev)
            eng.tile_compression = comp
            serial = [eng.execute(d, b) for d, b in pairs]
            f0, before = eng.fetches, K.launches()
            many = run_many(pairs, dev, eng)
            moved = {k: c - before[k] for k, c in K.launches().items() if c - before[k]}
            widths = [w for _, w in ((k[1], k[2]) for k in eng._vprograms)]
            for i, (c, so, (d, b)) in enumerate(zip(many, serial, pairs)):
                for what, want in (("its serial execute", so), ("the host engine", execute_dag_host(d, b))):
                    diff = chunks_equal(c, want)
                    if diff is not None:
                        raise AssertionError(f"limit_past_width {key}: task {i} differs from {what}: {diff}")
                if c.num_rows != b.n_rows:
                    raise AssertionError(f"limit_past_width {key}: task {i} kept {c.num_rows} of {b.n_rows} rows")
            if eng.fetches - f0 != 1 or moved.get(mode) != 1 or any(moved.get(k) for k in SORT_SOLO):
                raise AssertionError(f"limit_past_width {key}: fetches {eng.fetches - f0}, launches {moved}")
            res[key] = {"tasks": len(pairs), "limit": dag.topn.n, "widths": widths, "launches": moved}
    out["burst"]["limit_past_width"] = res
    say("main.burst.limit_past_width", **res)


class StoreSession:
    """The part of the reference's Session that models/tpch.bulk_load and
    br/ingest.BulkIngest use, over a port Storage (the Session is a later
    slice of the port): `.store`, `.current_db`, `.vars`, `.cop.tiles` (a
    TileCache), `.infoschema()` (copied from tidb_tpu/session/session.py:251,
    without temporary tables) and `.alloc_auto_id()` (:2322, in a meta
    transaction retried on a write conflict); `create_table` stores a
    TableInfo in the meta keys as the reference's CREATE TABLE does."""

    def __init__(self, store, db: str = "test"):
        from types import SimpleNamespace

        from tidb_tpu_torch.catalog.schema import DBInfo
        from tidb_tpu_torch.copr.tilecache import TileCache

        self.store = store
        self.current_db = db
        self.vars = {"tidb_bulk_ingest": "ON"}
        self.cop = SimpleNamespace(tiles=TileCache(store))

        def mk(txn, m):
            if m.db(db) is None:
                m.put_db(DBInfo(db))
                m.bump_schema_version()

        self._meta_txn(mk)

    def _meta_txn(self, fn):
        from tidb_tpu_torch.catalog.meta import Meta
        from tidb_tpu_torch.errors import RetryableError, WriteConflict

        for _ in range(20):
            txn = self.store.begin()
            try:
                out = fn(txn, Meta(txn))
                txn.commit()
                return out
            except (WriteConflict, RetryableError):
                txn.rollback()
        raise RuntimeError("meta transaction kept conflicting")

    def create_table(self, info) -> None:
        def do(txn, m):
            d = m.db(self.current_db)
            info.db_name = self.current_db
            m.put_table(info)
            d.table_ids.append(info.id)
            m.put_db(d)
            m.bump_schema_version()

        self._meta_txn(do)

    def infoschema(self):
        from tidb_tpu_torch.catalog.meta import Meta
        from tidb_tpu_torch.catalog.schema import InfoSchema

        txn = self.store.begin()
        m = Meta(txn)
        ver = m.schema_version()
        dbs = {d.name: d for d in m.list_dbs()}
        tables = {t.id: t for t in m.list_tables()}
        views = {(v["db"], v["name"]): v for v in m.list_views()}
        txn.rollback()
        return InfoSchema(ver, dbs, tables, views)

    def alloc_auto_id(self, tinfo, n: int) -> int:
        def do(txn, m):
            t = m.table(tinfo.id)
            first = t.auto_inc_id
            t.auto_inc_id += n
            m.put_table(t)
            tinfo.auto_inc_id = t.auto_inc_id
            return first

        return self._meta_txn(do)


def table_regions(store, info) -> list:
    """(region, start, end) of every region over the table's record keys,
    in key order (the cop client's region split of a full scan)."""
    from tidb_tpu_torch.codec import tablecodec
    from tidb_tpu_torch.planner.ranger import prefix_next

    p = tablecodec.record_prefix(info.id)
    return store.regions.split_ranges(p, prefix_next(p))


def store_batches(sess, info) -> list:
    """One TileCache.get_batch per region of the table, at one snapshot."""
    read_ts = sess.store.tso.next()
    return [sess.cop.tiles.get_batch(info, s, e, read_ts) for _r, s, e in table_regions(sess.store, info)]


def split_rule(n: int, step: int) -> list[int]:
    """Row counts of the regions the store's split rule (storage/txn.py
    _auto_split_run: a cut at every step-th key short of the last half
    region, none below 2 * step keys) gives a run of n keys."""
    cuts = list(range(step, n - step // 2, step)) if n >= 2 * step else []
    bounds = [0] + cuts + [n]
    return [b - a for a, b in zip(bounds, bounds[1:])]


def run_store_path(cols: dict, rows: int, card: str, out: dict, split: int | None = None):
    """main.store: the main path's lineitem bulk-ingested into the port's
    store (models/tpch.bulk_load over StoreSession: the columnar run, the
    idx_ship index run, the region split), then one TileCache.get_batch per
    region of the table — cold (the columnar gather), then warm (cache
    hits, the same batch objects). The regions must be the split rule's
    (16M rows: 7 x 2,097,152 and 1,319,936), bounded by the record keys of
    the handles at every 2,097,152nd row. → (session, table info, batches)."""
    import copy

    from tidb_tpu_torch.codec import tablecodec
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.planner.ranger import prefix_next
    from tidb_tpu_torch.storage import Storage

    sess = StoreSession(Storage())
    if split is not None:  # a narrowed run (the CPU tests): regions of `split` rows
        sess.store.region_split_size = split
    sess.create_table(copy.deepcopy(tpch.LINEITEM))
    t = time.perf_counter()
    tpch.bulk_load(sess, "lineitem", cols)
    ingest_s = time.perf_counter() - t
    info = sess.infoschema().table(sess.current_db, "lineitem")
    spans = table_regions(sess.store, info)
    step = sess.store.region_split_size
    want = split_rule(rows, step)
    p = tablecodec.record_prefix(info.id)
    bounds = [p] + [tablecodec.record_key(info.id, 1 + step * k) for k in range(1, len(want))] + [prefix_next(p)]
    got_bounds = [s_ for _r, s_, _e in spans] + [spans[-1][2]]
    if got_bounds != bounds:
        raise AssertionError(f"store: region bounds {[b.hex() for b in got_bounds]}, want {[b.hex() for b in bounds]}")
    tiles = sess.cop.tiles
    read_ts = sess.store.tso.next()
    batches, cold = [], []
    for _r, s_, e in spans:
        t = time.perf_counter()
        batches.append(tiles.get_batch(info, s_, e, read_ts))
        cold.append(time.perf_counter() - t)
    counts = [b.n_rows for b in batches]
    if counts != want:
        raise AssertionError(f"store: region rows {counts}, want {want}")
    if tiles.misses != len(spans) or tiles.hits:
        raise AssertionError(f"store: cold reads gave {tiles.hits} hits, {tiles.misses} misses")
    t = time.perf_counter()
    again = store_batches(sess, info)
    warm_s = time.perf_counter() - t
    if any(a is not b for a, b in zip(again, batches)) or tiles.hits != len(spans):
        raise AssertionError("store: a warm read rebuilt a region")
    out["store"] = {
        "rows": rows, "ingest_s": ingest_s, "ingest_rows_per_s": rows / ingest_s, "regions": len(spans),
        "region_rows": counts, "first_handles": [int(b.handles[0]) for b in batches],
        "cold_get_batch_s": cold, "warm_get_batches_s": warm_s, "tile_hits": tiles.hits,
        "tile_misses": tiles.misses, "store_regions_total": len(sess.store.regions.regions), "card": card,
    }
    say("main.store", **out["store"])
    return sess, info, batches


def run_store_turns(dev, batch, regions, card: str, out: dict, turns: int = 5, split: int = 1 << 21) -> None:
    """main.store.turns: Q1 and tpch_topn through run_many over the
    store's region batches and over models/tpch.region_batches' cut of
    the one batch (the region phases' input before the store), both
    resident, in alternating turns within this call: what reading from
    the store costs a warm run."""
    import torch

    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import run_many
    from tidb_tpu_torch.models import tpch

    cut = tpch.region_batches(batch, split)
    res = {}
    for qname, builder in (("q1", "q1_dag"), ("tpch_topn", "topn_dag")):
        dag = getattr(tpch, builder)()
        eng = TorchEngine(dev)
        walls = {"store": [], "cut": []}
        answers = {}
        for turn in range(turns + 1):  # turn 0 uploads the cut's lanes
            for side in (("cut", "store") if turn % 2 else ("store", "cut")):
                bs = regions if side == "store" else cut
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t = time.perf_counter()
                answers[side] = merged_regions(dag, run_many([(dag, b) for b in bs], dev, eng))
                if turn:
                    walls[side].append(time.perf_counter() - t)
        diff = chunks_equal(answers["store"], answers["cut"])
        if diff is not None:
            raise AssertionError(f"store turns {qname}: the store's answer differs from the cut's: {diff}")
        res[qname] = {side: {"median_s": sorted(w)[len(w) // 2], "walls_s": w} for side, w in walls.items()}
    out["store_turns"] = dict(res, turns=turns, card=card)
    say("main.store.turns", **out["store_turns"])
    for b in cut:
        b._gpu_mirrors = None


def lineitem_datums(info, batch, i: int) -> list:
    """Row i of a lineitem batch as the visible columns' Datums."""
    from tidb_tpu_torch.mysqltypes.datum import Datum
    from tidb_tpu_torch.mysqltypes.mydecimal import Dec

    out = []
    for c in info.columns:
        if c.hidden:
            continue
        d = batch.data[c.offset][i]
        if c.ft.is_decimal():
            out.append(Datum.d(Dec(int(d), max(c.ft.decimal, 0))))
        elif c.ft.is_string():
            out.append(Datum.s(d))
        elif c.ft.is_time():
            out.append(Datum.t(int(d)))
        else:
            out.append(Datum.i(int(d)))
    return out


def lane_tensors(batch) -> dict:
    """(mirror key, lane) → the batch's device tensors (the objects): the
    same objects before and after a run exactly when the run uploaded
    nothing for the batch (a mirror uploads a lane once, at its first use)."""
    out = {}
    for mk, m in (getattr(batch, "_gpu_mirrors", None) or {}).items():
        out[(mk, "row_valid")] = (m, m.row_valid)
        for side, lanes in (("d", m._data), ("v", m._valid)):
            for off, lane in lanes.items():
                out[(mk, side, off)] = tuple(lane.values()) if isinstance(lane, dict) else (lane,)
    return out


def same_objects(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(len(a[k]) == len(b[k]) and all(x is y for x, y in zip(a[k], b[k]))
                                        for k in a)


def device_bytes(batch) -> int:
    """Bytes of the batch's device lanes (every mirror's uploaded tensors)."""
    n = 0
    for m in (getattr(batch, "_gpu_mirrors", None) or {}).values():
        tensors = [m.row_valid]
        for lane in list(m._data.values()) + list(m._valid.values()):  # a pack lane's base "b" stays on the host
            tensors += [t for k, t in lane.items() if k != "b"] if isinstance(lane, dict) else [lane]
        n += sum(t.numel() * t.element_size() for t in tensors)
    return n


HTAP_ROWS = 5000
HTAP_UPDATE, HTAP_DELETE = 1, 4  # the regions (0-based) whose rows the transaction updates / deletes


def run_htap_path(dev, sess, info, regions, seed: int, card: str, out: dict, n_rows: int = HTAP_ROWS) -> None:
    """main.store.htap: one Txn through table.Table over the store that
    main.q1_regions and main.regions_sorted read — l_discount changed on
    5,000 rows of region 2, 5,000 rows of region 5 deleted, 5,000 new rows
    inserted (handles past the last: region 8) — then one get_batch per
    region at a new snapshot. The version bump must rebuild exactly the
    written regions (the committed rows merged after the runs' kept rows)
    and keep the other batches and their device lanes; Q1 and Q18's
    subquery over the new batches through run_many must equal the port's
    host engine over the same batches, and the first rerun may upload only
    the rebuilt regions' lanes."""
    import numpy as np
    import torch

    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.copr.host_engine import execute_dag_host
    from tidb_tpu_torch.entry import batch_from_numpy, run_many
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.mysqltypes.datum import Datum
    from tidb_tpu_torch.mysqltypes.mydecimal import Dec
    from tidb_tpu_torch.table.table import Table
    from tidb_tpu_torch.utils import metrics as M

    rng = np.random.default_rng(seed)
    table = Table(info)
    disc = info.col_by_name("l_discount").offset
    lanes_before = [lane_tensors(b) for b in regions]
    t = time.perf_counter()
    txn = sess.store.begin()
    b = regions[HTAP_UPDATE]
    for i in np.sort(rng.choice(b.n_rows, n_rows, replace=False)).tolist():
        h = int(b.handles[i])
        old = lineitem_datums(info, b, i)
        new = list(old)
        new[disc] = Datum.d(Dec((int(b.data[disc][i]) + 3) % 11, 2))
        table.update_record(txn, h, table.row_datums_with_hidden(old, h), table.row_datums_with_hidden(new, h))
    b = regions[HTAP_DELETE]
    for i in np.sort(rng.choice(b.n_rows, n_rows, replace=False)).tolist():
        h = int(b.handles[i])
        table.remove_record(txn, h, table.row_datums_with_hidden(lineitem_datums(info, b, i), h))
    fresh = batch_from_numpy(info, tpch.gen_lineitem(n_rows, seed + 7))
    first = sess.alloc_auto_id(info, n_rows)
    for j in range(n_rows):
        table.add_record(txn, table.row_datums_with_hidden(lineitem_datums(info, fresh, j), first + j), first + j)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    txn.commit()
    commit_s = time.perf_counter() - t
    tiles = sess.cop.tiles
    hits, misses = tiles.hits, tiles.misses
    touched = {HTAP_UPDATE, HTAP_DELETE, len(regions) - 1}
    t = time.perf_counter()
    batches = store_batches(sess, info)
    rebuild_s = time.perf_counter() - t
    rebuilt = [i for i, (a, b) in enumerate(zip(regions, batches)) if a is not b]
    if sorted(rebuilt) != sorted(touched) or tiles.misses - misses != len(touched) \
            or tiles.hits - hits != len(regions) - len(touched):
        raise AssertionError(f"htap: rebuilt regions {rebuilt}, want {sorted(touched)} "
                             f"({tiles.hits - hits} hits, {tiles.misses - misses} misses)")
    counts = [b.n_rows for b in batches]
    want_counts = [r.n_rows for r in regions]
    want_counts[HTAP_DELETE] -= n_rows
    want_counts[-1] += n_rows
    if counts != want_counts:
        raise AssertionError(f"htap: region rows {counts}, want {want_counts}")
    runs = {}
    h2d = M.TPU_TRANSFER_BYTES
    for qname, builder in (("q1", "q1_dag"), ("q18_inner", "q18_inner_dag")):
        dag = getattr(tpch, builder)()
        eng = TorchEngine(dev)
        walls, moved = [], []
        for _ in range(2):
            before = h2d.value(dir="h2d")
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t = time.perf_counter()
            got = merged_regions(dag, run_many([(dag, b) for b in batches], dev, eng))
            walls.append(time.perf_counter() - t)
            moved.append(h2d.value(dir="h2d") - before)
        want = merged_regions(dag, [execute_dag_host(dag, b) for b in batches])
        diff = chunks_equal(got, want)
        if diff is not None:
            raise AssertionError(f"htap {qname}: the answer differs from the host engine's: {diff}")
        if eng.fallbacks:
            raise AssertionError(f"htap {qname}: {eng.fallbacks} host fallbacks")
        runs[qname] = {"first_s": walls[0], "warm_s": walls[1], "h2d_bytes_first": moved[0],
                       "h2d_bytes_warm": moved[1], "answer": got.slice(0, 4).to_pylist()}
    for i in range(len(regions)):
        if i not in touched and not same_objects(lane_tensors(batches[i]), lanes_before[i]):
            raise AssertionError(f"htap: region {i + 1}'s device lanes were dropped, replaced or added to: "
                                 "an untouched region re-uploaded")
    uploaded = runs["q1"]["h2d_bytes_first"] + runs["q18_inner"]["h2d_bytes_first"]
    if not uploaded or runs["q1"]["h2d_bytes_warm"] or runs["q18_inner"]["h2d_bytes_warm"]:
        raise AssertionError(f"htap: the reruns uploaded {uploaded} bytes, then "
                             f"{runs['q1']['h2d_bytes_warm'] + runs['q18_inner']['h2d_bytes_warm']}")
    fresh_lanes = sum(device_bytes(batches[i]) for i in touched)
    out["store_htap"] = {
        "rows_updated": n_rows, "rows_deleted": n_rows, "rows_inserted": n_rows,
        "txn_build_s": build_s, "commit_s": commit_s, "rebuilt_regions": [i + 1 for i in sorted(rebuilt)],
        "rebuild_get_batches_s": rebuild_s, "region_rows": counts, "tile_hits": tiles.hits,
        "tile_misses": tiles.misses, "tile_revalidated": tiles.revalidated,
        "rebuilt_lane_bytes": fresh_lanes, "runs": runs, "card": card,
    }
    say("main.store.htap", **out["store_htap"])


def run_q1_regions_path(dev, batch, regions, want, reps: int, card: str, out: dict) -> None:
    """TPC-H Q1 over the main path's lineitem cut into its regions at the
    reference's 2,097,152-row split, through run_many: the full regions
    form one launch group (K10 at full width), the short last region
    launches solo; the partials merge at the root (executor/final_agg).
    The merged answer must equal main.q1's (the host oracle's). One cold
    run (encode + h2d of every region) and `reps` warm runs."""
    import torch

    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import run_many
    from tidb_tpu_torch.executor.final_agg import merge_partials, order_by_keys
    from tidb_tpu_torch.models import tpch

    dag = tpch.q1_dag()
    pairs = [(dag, r) for r in regions]
    fts = [g.ret_type for g in dag.agg.group_by] + [a.ret_type for a in dag.agg.aggs]
    eng = TorchEngine(dev)
    before = K.launches()
    runs = []
    for rep in range(reps + 1):
        with TaskSpy() as spy:
            torch.cuda.synchronize()
            t = time.perf_counter()
            parts = run_many(pairs, dev, eng)
            merged = order_by_keys(merge_partials(parts, dag.agg.group_by, dag.agg.aggs, fts), dag.agg.group_by)
            runs.append(time.perf_counter() - t)
        diff = chunks_equal(merged, want)
        if diff is not None:
            raise AssertionError(f"q1_regions run {rep}: merged answer differs from main.q1's: {diff}")
    moved = {k: c - before[k] for k, c in K.launches().items() if c - before[k]}
    idle = [m for m in AGG_TASK_MODES if not moved.get(m)]
    if idle:
        raise AssertionError(f"q1_regions: task modes {idle} never launched")
    out["captured"]["q1_regions"] = spy.calls
    warm = sorted(runs[1:])
    out["q1_regions"] = {
        "rows": batch.n_rows, "regions": [r.n_rows for r in regions], "cold_s": runs[0],
        "warm_median_s": warm[len(warm) // 2], "warm_s": runs[1:],
        "one_batch_q1_warm_median_s": out["q1"]["warm_median_s"],
        "launches_per_run": {k: c / (reps + 1) for k, c in moved.items()},
        "groups": sorted(((k[1], k[2]) for k in eng._vprograms), key=repr),
        "fetches_per_run": eng.fetches / (reps + 1),
        "answer": merged.slice(0, 6).to_pylist(), "card": card,
    }
    say("main.q1_regions", **out["q1_regions"])


# (query of the main path, DAG builder of models/tpch.py, its task mode):
# the sort-based paths over the regions
REGION_QUERIES = (("tpch_topn", "topn_dag", "topk_tasks"), ("multikey_topn", "multikey_topn_dag", "topn_multi_tasks"),
                  ("q18_inner", "q18_inner_dag", "sort_groups_tasks"))


def merged_regions(dag, parts):
    """The root's step over the regions' partial chunks: the TopN over
    their rows in region order, or the final aggregation ordered by the
    group keys (as main.q1_regions merges Q1)."""
    from tidb_tpu_torch.chunk.chunk import Chunk
    from tidb_tpu_torch.executor.final_agg import merge_partials, order_by_keys, top_n

    if dag.topn is not None:
        return top_n(Chunk.concat_all(parts), dag.topn.by, dag.topn.n)
    fts = [g.ret_type for g in dag.agg.group_by] + [a.ret_type for a in dag.agg.aggs]
    return order_by_keys(merge_partials(parts, dag.agg.group_by, dag.agg.aggs, fts), dag.agg.group_by)


def launch_classes(engine, pairs) -> tuple[int, int]:
    """(multi-task groups, tasks launched solo) of one run_many of at most
    MAX_FUSE `pairs` on `engine`: the tasks' program keys, as execute_many
    groups them (after the runs: lowering again records no new program)."""
    from collections import Counter

    sizes = Counter(engine._plan_for(dag, batch).key for dag, batch in pairs).values()
    return sum(1 for c in sizes if c > 1), sum(1 for c in sizes if c == 1)


def run_regions_sorted_path(dev, regions, wants: dict, reps: int, card: str, out: dict) -> None:
    """The slice at full width: tpch_topn (K6's task mode), multikey_topn
    (K7's) and Q18's subquery (K9's + K8's + K4's segment-lane mode) over
    the main path's lineitem in its regions, through run_many: the full
    regions form one launch group, the short last one launches solo. The
    partials merge at the root (merged_regions), and each merged answer
    must equal, in order, the query's one-batch answer (main.<q>, held to
    the host engine). Per run: one fetch, the query's sort mode launched
    once per group (with K8's task-leading mode for Q18's), its solo
    kernels (K6 / K7 / K9, and K8 for K9) only for the solo region — and
    for the TopNs (LIMIT 100 and 50, within K6's and K7's ordering caps)
    no K8 at all. One cold run (the TopNs upload every column), `reps`
    warm runs and one profiled run."""
    import torch

    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import run_many
    from tidb_tpu_torch.models import tpch

    out["regions_sorted"] = {}
    solo_of = {"topk_tasks": "topk", "topn_multi_tasks": "topn_multi", "sort_groups_tasks": "sort_groups"}
    for qname, builder, mode in REGION_QUERIES:
        dag = getattr(tpch, builder)()
        pairs = [(dag, r) for r in regions]
        eng = TorchEngine(dev)
        before, runs = K.launches(), []
        for rep in range(reps + 1):
            with TaskSpy() as spy:
                torch.cuda.synchronize()
                t = time.perf_counter()
                parts = run_many(pairs, dev, eng)
                merged = merged_regions(dag, parts)
                runs.append(time.perf_counter() - t)
            diff = chunks_equal(merged, wants[qname])
            if diff is not None:
                raise AssertionError(f"regions_sorted.{qname} run {rep}: merged answer differs from main.{qname}'s: "
                                     f"{diff}")
        calls = reps + 1
        moved = {k: c - before[k] for k, c in K.launches().items() if c - before[k]}
        groups, singles = launch_classes(eng, pairs)
        # K6 and K7 order their own rows up to their caps: then no K8 at all
        k8 = 0 if dag.topn is not None and in_kernel(dag) else 1
        want = {mode: groups, "lex_sort_tasks": k8 * groups, solo_of[mode]: singles, "lex_sort": k8 * singles}
        if mode == "sort_groups_tasks":
            want["seg_agg_tasks"] = groups
        got = {k: moved.get(k, 0) / calls for k in want}
        if got != want:
            raise AssertionError(f"regions_sorted.{qname}: launches per run {got}, want {want} (the sort kernels "
                                 "run solo only for a group of one)")
        if eng.fetches != calls:
            raise AssertionError(f"regions_sorted.{qname}: {eng.fetches} fetches in {calls} runs")
        fetches = eng.fetches
        prof = profiled_run(lambda: run_many(pairs, dev, eng), eng)
        out["captured"].setdefault("regions_sorted", {})[qname] = spy.calls
        warm = sorted(runs[1:])
        out["regions_sorted"][qname] = {
            "rows": sum(r.n_rows for r in regions), "regions": [r.n_rows for r in regions], "cold_s": runs[0],
            "warm_median_s": warm[len(warm) // 2], "warm_s": runs[1:],
            "one_batch_warm_median_s": out[qname]["warm_median_s"],
            "launches_per_run": {k: c / calls for k, c in moved.items()},
            "groups": sorted(((k[1], k[2]) for k in eng._vprograms), key=repr), "gcap": sorted(eng._gcap.values()),
            "compile_count": eng.compile_count, "fetches_per_run": fetches / calls, "profiled_run": prof,
            "answer": merged.slice(0, 4).to_pylist(), "card": card,
        }
        say(f"main.regions_sorted.{qname}", **out["regions_sorted"][qname])


def run_sql_path(sess, info, rows: int, card: str, out: dict) -> None:
    """main.sql: the planning of every main-path query from its SQL (the
    host milliseconds of each phase, median of 10, and whether its plan
    equals the hand-built one; main.sql_plans held them before the MPP
    runs, whose rows the MPP phases held to the oracle), then ANALYZE of
    main.store's lineitem through
    `store.stats.analyze_table` over the store's TileCache batches, with
    its seconds, and the row count the stats must hold."""
    t = time.perf_counter()
    ts = sess.store.stats.analyze_table(sess, info)
    analyze_s = time.perf_counter() - t
    if ts.row_count != rows or len(ts.columns) != len(info.visible_columns()):
        raise AssertionError(f"ANALYZE: {ts.row_count} rows, {len(ts.columns)} columns (want {rows})")
    if sess.store.stats.get(info.id) is not ts:
        raise AssertionError("ANALYZE: the stats handle does not serve the stats it built")
    sql = out["sql"]
    if sorted(sql["rows_equal_oracle"]) != sorted(sql["equal"]):
        raise AssertionError(f"main.sql: planned MPP queries without checked rows: "
                             f"{sorted(set(sql['equal']) - set(sql['rows_equal_oracle']))}")
    out["main.sql"] = {"plan_ms": sql["ms"], "equal": sql["equal"], "cop_equal": sql["cop_equal"],
                       "rows_equal_oracle": sql["rows_equal_oracle"],
                       "analyze_s": analyze_s, "analyze_rows": ts.row_count,
                       "analyze_ndv": {c.name: ts.columns[c.id].ndv for c in info.visible_columns()},
                       "card": card}
    say("main.sql", **out["main.sql"])


def run_main_path(dev, rows: int, seed: int, reps: int, card: str, win_rows: int = 8_000_000,
                  q3_rows: int = 4_000_000) -> dict:
    import torch

    from tidb_tpu_torch import kernels as K
    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.entry import batch_from_numpy, run_query
    from tidb_tpu_torch.models import tpch
    from tidb_tpu_torch.torchenv import PhaseTimer

    t0 = time.perf_counter()
    cols = tpch.gen_lineitem(rows, seed)
    batch = batch_from_numpy(tpch.LINEITEM, cols)
    say("main.data", rows=rows, seed=seed, seconds=time.perf_counter() - t0)
    out = {"captured": {}}
    K.reset_launches()
    for qname, builder, needs in QUERIES:
        dag = getattr(tpch, builder)()
        engine = TorchEngine(dev)
        captured = out["captured"][qname] = {}
        _spy(engine, captured)
        before = K.launches()
        runs = []
        for rep in range(reps + 1):  # first run is cold: encode + h2d of lanes not yet touched
            engine.timer = PhaseTimer(engine.device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with ExprSpy() as spy:
                res = run_query(dag, batch, device=dev, engine=engine)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t, engine.timer.totals_ms(), res))
        captured["expr_eval"] = spy.calls
        after = K.launches()
        moved = {k: after[k] - before[k] for k in after}
        idle = [k for k in needs if moved[k] == 0]
        if idle:
            raise AssertionError(f"{qname}: kernels {idle} were never launched")
        stray = {k: moved[k] for k in NOT_LAUNCHED.get(qname, ()) if moved[k]}
        if stray:
            raise AssertionError(f"{qname}: kernels {stray} were launched")
        if engine.fallbacks:
            raise AssertionError(f"{qname}: {engine.fallbacks} host fallbacks on the main path")
        t = time.perf_counter()
        want = oracle(dag, batch)
        host_s = time.perf_counter() - t
        want_cpu = run_query(dag, batch, device="cpu") if qname in DEVICE_FLOAT_QUERIES else None
        for i, (_, _, res) in enumerate(runs):
            if want_cpu is not None:
                diff = chunks_equal(res, want, skip_floats=True) or chunks_close(res, want_cpu)
            else:
                diff = chunks_equal(res, want)
            if diff is not None:
                raise AssertionError(f"{qname} run {i}: GPU answer differs from the host engine's: {diff}\n"
                                     f"gpu:  {res.slice(0, 6).to_pylist()}\nhost: {want.slice(0, 6).to_pylist()}")
        if qname == "q1" and not 1 <= want.num_rows <= 6:
            raise AssertionError(f"q1: {want.num_rows} groups")
        if dag.topn is not None and want.num_rows != min(dag.topn.n, rows):
            raise AssertionError(f"{qname}: {want.num_rows} rows")
        warm = sorted(runs[1:], key=lambda x: x[0])
        med = warm[len(warm) // 2]
        prof = profiled_run(lambda: run_query(dag, batch, device=dev, engine=engine), engine)
        out[qname] = {
            "rows": rows, "result_rows": want.num_rows, "cold_s": runs[0][0], "cold_phases_ms": runs[0][1],
            "warm_median_s": med[0], "warm_s": [r[0] for r in runs[1:]],
            "rows_per_s": rows / med[0], "phases_ms": med[1], "host_oracle_s": host_s,
            "launches_per_run": {k: c / (reps + 1) for k, c in moved.items() if c},
            "gcap": sorted(engine._gcap.values()), "profiled_run": prof,
            "answer": want.slice(0, 6).to_pylist(), "card": card,
        }
        say(f"main.{qname}", **out[qname])
        if qname in ("q1",) + tuple(q for q, _, _ in REGION_QUERIES):
            out[f"{qname}_want"] = want
    out["batch"] = batch
    run_window_path(dev, win_rows, seed, reps, card, out)
    run_mpp_path(dev, q3_rows, seed, reps, card, out)
    run_mpp_mesh_path(dev, reps, card, out)
    run_mesh_path(dev, cols, card, out)
    run_burst_path(dev, reps, card, out)
    sess, info, regions = run_store_path(cols, rows, card, out)
    del cols
    run_sql_path(sess, info, rows, card, out)
    run_q1_regions_path(dev, batch, regions, out["q1_want"], reps, card, out)
    run_regions_sorted_path(dev, regions, {q: out.pop(f"{q}_want") for q, _, _ in REGION_QUERIES}, reps, card, out)
    run_store_turns(dev, batch, regions, card, out)
    run_htap_path(dev, sess, info, regions, seed, card, out)
    counts = K.launches()
    for name, c in counts.items():
        if c == 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    out["launches"] = counts
    return out


def measure(dev, main: dict, max_err: dict) -> list[dict]:
    """Each kernel on this run's Q1 inputs: held once more to its plain
    version on exactly those tensors, then timed beside the plain version
    and its bound (bytes over HBM rate). `max_err` carries the largest
    error of the phase-3 cases and is raised by these comparisons."""
    import torch

    from tidb_tpu_torch.copr.gpu_engine import TorchEngine
    from tidb_tpu_torch.kernels import decode_lane, decode_lane_ref, decode_lanes, seg_agg, seg_agg_ref
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
    got = decode_lanes(encs, rv)
    torch.cuda.synchronize()
    for g, e in zip(got, encs):
        err = _same(g, decode_lane_ref(e, rv), "decode_lane on Q1's lanes", floats=g.is_floating_point())
        max_err["decode_lane"] = max(max_err["decode_lane"], err)
    k1 = {  # Q1's coded lanes as the engine's _decode hands them over: one call, one launch
        "ms": time_ms(lambda: decode_lanes(encs, rv)),
        "one_call_a_lane_ms": time_ms(lambda: [decode_lane(e, rv) for e in encs]),
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
    k4_bytes = _nbytes(m, *_pairs((k.data, k.valid) for k in keys), *_pairs((l.data, l.valid) for l in lanes))
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
    entries = [
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
    k4_queries = measure_seg_agg_queries(main, max_err)
    entries[1].update(max_abs_err=max_err["seg_agg"], kernel_ms=k4_queries["q1"]["kernel_ms"])
    new, extra = measure_sort_kernels(main, max_err)
    say("measure", decode_lane=k1, decode_lane_dict=k1_dict, seg_agg=k4, seg_agg_queries=k4_queries, **extra)
    win, win_extra = measure_window_kernels(main, max_err)
    say("measure.window", **win_extra)
    mpp, mpp_extra = measure_mpp_kernels(main, max_err)
    say("measure.mpp", **mpp_extra)
    say("measure.mpp_mesh_modes", **measure_mesh_modes(main, max_err, mpp))
    p2, p2_extra = measure_exchange(main, max_err)
    say("measure.exchange", **p2_extra)
    expr, expr_extra = measure_expr_kernels(main, max_err)
    say("measure.expr", **expr_extra)
    mesh, mesh_extra = measure_mesh_kernels(main, max_err)
    say("measure.mesh", **mesh_extra)
    k10, k10_extra = measure_grouped_kernels(main, max_err)
    say("measure.k10", **k10_extra)
    return entries + new + win + mpp + p2 + expr + mesh + k10


def exchange_timing(calls) -> dict:
    """P2 on the largest of `calls` (main.mpp_mesh's captured exchange
    arguments): held to its plain version, then timed beside it, its bytes
    bound (the mask, keys and lanes read once, the send buffer written
    once) and the nearest PyTorch calls — a stable argsort of the masked
    owner lane and one gather per lane (never used on the path)."""
    import torch

    from tidb_tpu_torch.kernels import exchange, exchange_ref
    from tidb_tpu_torch.kernels.exchange import layout, owner_key_ref

    a = max(calls, key=lambda c: c[2].numel() * len(c[6]))
    n_dev, bcap, mask, keys, key_i32, probe, lanes = a
    (gs, gd), (ws, wd) = exchange(*a), exchange_ref(*a)
    torch.cuda.synchronize()
    _same(gs, ws, "exchange send buffer on the mesh's unfused Q3")
    _same(gd, wd, "exchange dropped count on the mesh's unfused Q3")
    n = mask.numel()
    _, words = layout(lanes, bcap)
    nbytes = _nbytes(mask, *_pairs((k.data, k.valid) for k in keys), *lanes) + n_dev * words * 8 + 8
    own = torch.where(mask, torch.remainder(owner_key_ref(keys, key_i32, probe, n), n_dev), n_dev)

    def library():
        order = torch.argsort(own, stable=True)
        return [t[order] for t in lanes]

    return {"ms": time_ms(lambda: exchange(*a)), "plain_ms": time_ms(lambda: exchange_ref(*a), 3),
            "library_ms": time_ms(library), "library_call": "torch.argsort(stable=True) of the masked owner lane "
                                                            "and one gather per lane",
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "rows": n, "n_dev": n_dev, "bcap": bcap,
            "lanes": len(lanes), "keys": len(keys), "probe": probe, "calls_captured": len(calls)}


def measure_exchange(main: dict, max_err: dict):
    """P2 on main.mpp_mesh's own inputs (exchange_timing: the unfused Q3's
    largest exchange call, one rank's share of a HASH level)."""
    k2 = exchange_timing(main["captured"]["mpp_mesh"]["exchange"])
    entry = {"name": "exchange", "route": "cuda", "source": "tidb_tpu_torch/csrc/exchange.cu",
             "replaces": "tidb_tpu/parallel/mpp.py:1465", "launches": main["launches"]["exchange"],
             "max_abs_err": max_err["exchange"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
             "bound_ms": k2["bound_ms"], "bound_by": "bytes", "library_ms": k2["library_ms"]}
    return [entry], {"exchange": k2}


def measure_seg_agg_queries(main: dict, max_err: dict) -> dict:
    """K4 on each cop query's own inputs (Q1, Q6, CHECKSUM's bitwise form
    and Q18's subquery over K9's ids, the global mode): held to the plain
    version, then timed — the call (`ms`), its kernel alone over a table
    built beforehand (`kernel_ms`: the rest of `ms` is the wrapper's host
    work, which a small call does not hide), the plain version — beside
    the bytes bound and the launch plan (mode, block size, blocks)."""
    import torch

    from tidb_tpu_torch.kernels import seg_agg, seg_agg_ref
    from tidb_tpu_torch.kernels.tables import sm_count

    SA = importlib.import_module("tidb_tpu_torch.kernels.seg_agg")
    out = {}
    for q in ("q1", "q6", "checksum", "q18_inner"):
        (m, keys, lanes, nseg), kw = main["captured"][q]["seg_agg"]
        seg = kw.get("seg")
        (gi, gf), (wi, wf) = seg_agg(m, keys, lanes, nseg, **kw), seg_agg_ref(m, keys, lanes, nseg, **kw)
        torch.cuda.synchronize()
        _same(gi, wi, f"seg_agg ints on {q}'s lanes")
        max_err["seg_agg"] = max(max_err["seg_agg"], _same(gf, wf, f"seg_agg floats on {q}'s lanes", True))
        _, go = SA.seg_agg_prepare(m, keys, lanes, nseg, seg)
        p = SA.plan(m.numel(), 1, len(keys), len(lanes), nseg, sm_count(m.device))
        nbytes = (_nbytes(m, seg, *_pairs((k.data, k.valid) for k in keys), *_pairs((ln.data, ln.valid) for ln in lanes))
                  + 8 * nseg * len(lanes))
        out[q] = {"ms": time_ms(lambda: seg_agg(m, keys, lanes, nseg, **kw)), "kernel_ms": time_ms(go),
                  "plain_ms": time_ms(lambda: seg_agg_ref(m, keys, lanes, nseg, **kw), 3), "bytes": nbytes,
                  "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "rows": m.numel(), "nseg": nseg, "lanes": len(lanes),
                  "mode": p.mode, "threads": p.threads, "blocks": p.blocks}
    return out


def call_split(call) -> dict:
    """One call's launches and device time (kernel_split): `device_ms` the
    sum of its kernels' device times, `launches_per_call` its kernels."""
    split = kernel_split(call)
    sm = split.get("split_ms")
    return {"device_ms": sum(sm.values()) if sm else None, "launches_per_call": split.pop("launches"), **split}


def rowpos_split(call, tries: int = 3) -> dict:
    """One P6 call's device time by kernel (kernel_split): K4's
    (`seg_agg_ms`), K6's (`topk_ms`) and P6's own kernels' (`p6_device_ms`),
    their sum (`device_ms`), and the host clock's time to enqueue the call
    (`enqueue_ms`: nothing synchronized). Late in a long run the profiler
    can miss some of a call's kernels: a session without K4's, P6's and
    K6's is tried again, and after `tries` the parts are None."""
    for _ in range(tries):
        split = kernel_split(call)
        sm = split.get("split_ms") or {}
        if all(any(n.startswith(p) for n in sm) for p in ("seg_agg_kernel", "seg_kernel", "emit_kernel", "topk_")):
            break
    else:
        return {"seg_agg_ms": None, "topk_ms": None, "p6_device_ms": None, "device_ms": None,
                "enqueue_ms": host_ms(call), "profiler_missed_kernels": True, **split}
    k4 = sum(v for n, v in sm.items() if n.startswith(("seg_agg_kernel", "init_kernel")))
    k6 = sum(v for n, v in sm.items() if n.startswith("topk_"))
    own = sum(v for n, v in sm.items() if n in ("seg_kernel", "score_kernel", "emit_kernel"))
    return {"seg_agg_ms": k4, "topk_ms": k6, "p6_device_ms": own, "device_ms": sum(sm.values()),
            "enqueue_ms": host_ms(call), **split}


def measure_mesh_modes(main: dict, max_err: dict, entries: list) -> dict:
    """P5's local + final reduce, P6's block picks and P8's rank partials
    on main.mpp_mesh's own inputs: every rank's call held to its plain
    version (hold_mesh_modes), then the largest call of each timed beside its plain version, its
    bytes bound and the nearest PyTorch call, the recorded exchange /
    collect outputs standing in for the collectives (so the times hold
    the kernels alone), and the kernels each calls timed apart (K8 and K6
    in P5, K4 and K6 in P6: `own_ms` is the call less them — P5's less
    their calls' times, P6's less their kernels' device times in one
    profiled call, so P6's holds their host work too; P8 calls none). The
    times go into the kernels line's seg_reduce, rowpos_agg and dense_agg
    entries as mesh_ms, mesh_plain_ms, mesh_bound_ms, mesh_library_ms and
    mesh_own_ms."""
    import torch

    from tidb_tpu_torch.kernels import dense_agg, dense_agg_ref, rowpos_agg, rowpos_agg_ref, seg_reduce, seg_reduce_ref
    from tidb_tpu_torch.kernels.dense_agg import dense_code_ref
    from tidb_tpu_torch.kernels.rowpos_agg import picks
    from tidb_tpu_torch.kernels.seg_reduce import I64_MAX, group_code_ref

    calls = main["captured"]["mpp_mesh"]
    for name, e in hold_mesh_modes(calls).items():
        max_err[name] = max(max_err[name], e)

    a, kw, out = max(calls["seg_reduce"], key=lambda c: c[0][1].numel())
    keys, mask, lanes, n_dev = a[0], a[1], a[2], kw["n_dev"]
    a5, n5 = a, n_dev
    key2, vals2, exm = out
    n, m, nl = mask.numel(), exm.numel(), len(lanes)
    kk = min(a[5], m)
    rows5 = torch.zeros_like(kw["rows"])
    ex = lambda *x, out=out: out  # noqa: E731 — this call's exchange outputs (out is rebound below)
    code = group_code_ref(keys, mask)
    code2 = torch.where(exm, key2, torch.full((), I64_MAX, dtype=torch.int64, device=exm.device))
    b5 = (_nbytes(mask, *_pairs((k.data, k.valid) for k in keys), *_pairs((ln.data, ln.valid) for ln in lanes))
          + n * (8 + 1 + 8 * nl) + _nbytes(key2, exm, *vals2) + 8 * kk * (2 + nl))
    k5 = {"ms": time_ms(lambda: seg_reduce(*a, rows=rows5, exchange=ex, n_dev=n_dev)),
          "plain_ms": time_ms(lambda: seg_reduce_ref(*a, rows=rows5, exchange=ex, n_dev=n_dev), 3),
          "library_ms": time_ms(lambda: (torch.sort(code, stable=True), torch.sort(code2, stable=True))),
          "library_call": "torch.sort(stable=True) of the local group code and of the exchanged fragments' code",
          "bytes": b5, "bound_ms": b5 / HBM_BYTES_PER_S * 1e3, "rows": n, "fragments": m, "n_dev": n_dev,
          "lanes": nl, "k": kk, "calls_held": len(calls["seg_reduce"])}

    a, kw, out = max(calls["rowpos_agg"], key=lambda c: c[0][0].numel())
    mask, rid, B, lanes, n_dev = a[0], a[1], a[2], a[3], kw["n_dev"]
    space, blk = -(-B // n_dev) * n_dev, out[0][0].numel()
    kk = picks(a[7], len(lanes), blk)
    rows6 = torch.zeros_like(kw["rows"])
    col = lambda full, ops, out=out: out  # noqa: E731
    b6 = (_nbytes(mask, rid, *_pairs((ln.data, ln.valid) for ln in lanes)) + 8 * space * len(lanes)
          + _nbytes(*out[0]) + 8 * kk * (2 + len(lanes) - a[8]))
    seg = torch.where(mask, torch.clip(rid, 0, B - 1), space)
    sl = lanes[a[5]]
    val = sl.data if sl.data is not None else torch.ones_like(rid)
    acc = torch.zeros(space + 1, dtype=val.dtype, device=val.device)
    k6 = {"ms": time_ms(lambda: rowpos_agg(*a, rows=rows6, n_dev=n_dev, collect=col)),
          "plain_ms": time_ms(lambda: rowpos_agg_ref(*a, rows=rows6, n_dev=n_dev, collect=col), 3),
          "library_ms": time_ms(lambda: acc.zero_().index_add_(0, seg, val)),
          "library_call": "index_add_ of the ORDER BY lane into the Bp build rows",
          "bytes": b6, "bound_ms": b6 / HBM_BYTES_PER_S * 1e3, "rows": mask.numel(), "B": B, "block": blk,
          "n_dev": n_dev, "lanes": len(lanes), "k": kk, "calls_held": len(calls["rowpos_agg"])}
    # each call's own time apart from the kernels it calls: K8 and K6 in
    # P5 (their calls timed apart); K4 and K6 in P6, which launches them
    # over the tables of its one upload: their kernels' device time in one
    # profiled call
    mods = {name: importlib.import_module(f"tidb_tpu_torch.kernels.{name}") for name in ("seg_reduce", "rowpos_agg")}
    parts = {f"{w}_ms": (k8_inside(mods["seg_reduce"], lambda: seg_reduce(*a5, rows=rows5, exchange=ex, n_dev=n5))[1]
                         if w == "lex_sort_perm" else calls_inside(mods["seg_reduce"], w, lambda: seg_reduce(
                             *a5, rows=rows5, exchange=ex, n_dev=n5))[1]) for w in ("lex_sort_perm", "topk")}
    k5.update(parts, own_ms=k5["ms"] - sum(parts.values()))
    k6.update(rowpos_split(lambda: rowpos_agg(*a, rows=rows6, n_dev=n_dev, collect=col)))
    k6["own_ms"] = None if k6["seg_agg_ms"] is None else k6["ms"] - k6["seg_agg_ms"] - k6["topk_ms"]
    k5["k8_rows"] = [op[0].data.numel() for op in k8_inside(mods["seg_reduce"], lambda: seg_reduce(
        *a5, rows=rows5, exchange=ex, n_dev=n5))[0]]
    # P8's largest rank call of the mesh's SEG_REVENUE (its partials; the
    # all-reduce follows the call)
    a, kw, _ = max(calls["dense_agg"], key=lambda c: c[0][0].numel())
    mask, keys, nseg, lanes = a
    rows8 = torch.zeros_like(kw["rows"])
    b8 = (_nbytes(mask, *_pairs((k.data, k.valid) for k in keys), *_pairs((ln.data, ln.valid) for ln in lanes))
          + 8 * nseg * len(lanes))
    seg8 = dense_code_ref(mask, keys, nseg)
    sums8 = torch.stack([ln.data for ln in lanes if ln.op == "sum_i64"], dim=1)
    acc8 = torch.zeros((nseg + 1, sums8.shape[1]), dtype=torch.int64, device=sums8.device)
    k8 = {"ms": time_ms(lambda: dense_agg(*a, rows=rows8)), "plain_ms": time_ms(lambda: dense_agg_ref(*a), 3),
          "library_ms": time_ms(lambda: acc8.zero_().index_add_(0, seg8, sums8)),
          "library_call": "index_add_ of the stacked int64 sum lanes by the precomputed segment",
          "enqueue_ms": host_ms(lambda: dense_agg(*a, rows=rows8)), "bytes": b8,
          "bound_ms": b8 / HBM_BYTES_PER_S * 1e3, "rows": mask.numel(), "nseg": nseg, "lanes": len(lanes),
          "calls_held": len(calls["dense_agg"]), **call_split(lambda: dense_agg(*a, rows=rows8))}
    k8["own_ms"] = k8["ms"]  # one launch of K4's kernel, no call inside
    got = {"seg_reduce": k5, "rowpos_agg": k6, "dense_agg": k8}
    for e in entries:
        if e["name"] in got:
            k = got[e["name"]]
            e.update(max_abs_err=max_err[e["name"]], mesh_ms=k["ms"], mesh_plain_ms=k["plain_ms"],
                     mesh_bound_ms=k["bound_ms"], mesh_library_ms=k["library_ms"], mesh_own_ms=k["own_ms"])
    return got


def measure_expr_kernels(main: dict, max_err: dict):
    """The expression kernel on the main path's own programs and lanes
    (Q1's, Q6's, CHECKSUM's, FN_MIX's and FN_MATH's cop programs, Q3's
    aggregate argument, the unfused Q3's scan selections), and K4's
    bitwise ops on CHECKSUM's lanes: held once more to the plain
    versions, then timed beside them and their bytes bound — the expression kernel's call (`ms`) and its
    launch alone over Params built beforehand (`kernel_ms`). No single
    PyTorch call computes either."""
    import torch

    from tidb_tpu_torch.kernels import expr_eval, expr_eval_ref, seg_agg, seg_agg_ref

    EE = importlib.import_module("tidb_tpu_torch.kernels.expr_eval")
    bound = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
    cap = main["captured"]
    per_prog = {}
    for label, q, pick in (("q1", "q1", -1), ("q6", "q6", -1), ("checksum", "checksum", -1),
                           ("fn_mix", "fn_mix", -1), ("fn_math", "fn_math", -1),
                           ("q3_mpp_args", "q3_mpp", -1), ("q3_unfused_scan", "q3_unfused", 0)):
        prog, ins, n = cap[q]["expr_eval"][pick]
        got, want = expr_eval(prog, ins, n), expr_eval_ref(prog, ins, n)
        torch.cuda.synchronize()
        max_err["expr_eval"] = max(max_err["expr_eval"], _same_expr_outs(prog, got, want))
        nbytes = _nbytes(*ins) + sum(n * w for w in prog.outputs)
        _, go = EE.expr_eval_prepare(prog, ins, n)
        per_prog[label] = {"ms": time_ms(lambda: expr_eval(prog, ins, n)), "kernel_ms": time_ms(go),
                           "plain_ms": time_ms(lambda: expr_eval_ref(prog, ins, n), 3), "bytes": nbytes,
                           "bound_ms": bound(nbytes), "rows": n, "ops": len(prog.ops), "registers": prog.nregs,
                           "inputs": len(ins), "outputs": len(prog.outputs), "reload": prog.reload,
                           "extended": prog.ext}
    (m, keys, lanes, nseg), kw = cap["checksum"]["seg_agg"]
    (gi, _), (wi, _) = seg_agg(m, keys, lanes, nseg, **kw), seg_agg_ref(m, keys, lanes, nseg, **kw)
    torch.cuda.synchronize()
    _same(gi, wi, "seg_agg bitwise ints on CHECKSUM's lanes")
    kb_bytes = (_nbytes(m, *_pairs((k.data, k.valid) for k in keys), *_pairs((ln.data, ln.valid) for ln in lanes))
                + 8 * nseg * len(lanes))
    kb = {"ms": time_ms(lambda: seg_agg(m, keys, lanes, nseg, **kw)),
          "plain_ms": time_ms(lambda: seg_agg_ref(m, keys, lanes, nseg, **kw), 3), "bytes": kb_bytes,
          "bound_ms": bound(kb_bytes), "nseg": nseg, "lanes": [ln.op for ln in lanes], "rows": m.numel()}
    L = main["launches"]
    q1 = per_prog["q1"]
    entries = [
        {"name": "expr_eval", "route": "cuda", "source": "tidb_tpu_torch/csrc/expr_eval.cu",
         "replaces": "tidb_tpu/copr/tpu_engine.py:1021", "launches": L["expr_eval"],
         "max_abs_err": max_err["expr_eval"], "ms": q1["ms"], "plain_ms": q1["plain_ms"],
         "bound_ms": q1["bound_ms"], "bound_by": "bytes", "library_ms": None, "kernel_ms": q1["kernel_ms"],
         **{f"{q}_{k}": per_prog[q][k] for q in ("fn_mix", "fn_math") for k in ("ms", "kernel_ms", "bound_ms")}},
        {"name": "seg_agg_bitwise", "route": "cuda", "source": "tidb_tpu_torch/csrc/seg_agg.cu",
         "replaces": "tidb_tpu/copr/tpu_engine.py:1596", "launches": L["seg_agg_bitwise"],
         "max_abs_err": max_err["seg_agg_bitwise"], "ms": kb["ms"], "plain_ms": kb["plain_ms"],
         "bound_ms": kb["bound_ms"], "bound_by": "bytes", "library_ms": None},
    ]
    return entries, {"expr_eval": per_prog, "seg_agg_bitwise": kb}


def measure_mesh_kernels(main: dict, max_err: dict):
    """M1 and M3 on the mesh phase's own lanes (the main path's lineitem):
    held once more to the plain versions, the warm median of single
    launches (CUDA events), rows/s, the bytes bound and the nearest single
    PyTorch calls (M1: index_add_ of the six stacked lanes by a
    precomputed segment; M3: torch.argsort(stable=True) of the owner
    lane)."""
    import torch

    from tidb_tpu_torch.kernels import hash_repartition, hash_repartition_ref, q1_local, q1_local_ref

    bound = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
    cap = main["captured"]["mesh"]
    spec, lanes = cap["spec"], cap["lanes"]
    qty, price, disc, tax, rf, ls, ship, rv = lanes
    n, nseg = rv.numel(), spec.nseg
    m1 = (nseg, spec.cutoff, *lanes)
    got, want = q1_local(*m1), q1_local_ref(*m1)
    torch.cuda.synchronize()
    max_err["q1_local"] = max(max_err["q1_local"], _same(got, want, "q1_local on the main path's lineitem"))
    mask = rv & (ship <= spec.cutoff)
    seg = torch.where(mask, rf * 2 + ls, nseg)
    dp = price * (100 - disc)
    stacked = torch.stack([mask.to(torch.int64), qty, price, dp, dp * (100 + tax), disc], dim=1)
    acc = torch.zeros((nseg + 1, 6), dtype=torch.int64, device=rv.device)
    m1_bytes = _nbytes(*lanes) + 6 * 8 * nseg
    k_m1 = {"median_ms": median_ms(lambda: q1_local(*m1)), "ms": time_ms(lambda: q1_local(*m1)),
            "plain_ms": time_ms(lambda: q1_local_ref(*m1), 3),
            "library_ms": time_ms(lambda: acc.zero_().index_add_(0, seg, stacked)),
            "library_call": "index_add_ of the six stacked lanes by a precomputed segment", "bytes": m1_bytes,
            "bound_ms": bound(m1_bytes), "rows": n, "nseg": nseg}
    k_m1["rows_per_s"] = n / (k_m1["median_ms"] / 1e3)
    keys, payload, valid = qty, price, rv
    m3 = (keys, payload, valid, 1, n)
    for j, (g, w) in enumerate(zip(hash_repartition(*m3), hash_repartition_ref(*m3))):
        _same(g, w, f"hash_repartition output {j} on the main path's lineitem")
    owner = torch.where(valid, torch.remainder(keys, 1), 1)
    m3_bytes = _nbytes(keys, payload, valid) + n * (8 + 8 + 1) + 8
    k_m3 = {"median_ms": median_ms(lambda: hash_repartition(*m3)), "ms": time_ms(lambda: hash_repartition(*m3)),
            "plain_ms": time_ms(lambda: hash_repartition_ref(*m3), 3),
            "library_ms": time_ms(lambda: torch.argsort(owner, stable=True)),
            "library_call": "torch.argsort(stable=True) of the owner lane", "bytes": m3_bytes,
            "bound_ms": bound(m3_bytes), "rows": n, "n_dev": 1, "cap": n,
            **call_split(lambda: hash_repartition(*m3))}
    k_m3["rows_per_s"] = n / (k_m3["median_ms"] / 1e3)
    L = main["launches"]

    def entry(name, src, ref, meas):
        return {"name": name, "route": "cuda", "source": f"tidb_tpu_torch/csrc/{src}",
                "replaces": f"tidb_tpu/parallel/mesh.py:{ref}", "launches": L[name], "max_abs_err": max_err[name],
                "ms": meas["median_ms"], "plain_ms": meas["plain_ms"], "bound_ms": meas["bound_ms"],
                "bound_by": "bytes", "library_ms": meas["library_ms"]}

    return ([entry("q1_local", "q1_local.cu", 57, k_m1), entry("hash_repartition", "hash_repartition.cu", 104, k_m3)],
            {"q1_local": k_m1, "hash_repartition": k_m3, "card": main["mesh"]["card"]})


def _k10_decode(calls):
    """K1's task mode over the captured decode_lanes_tasks calls that launch
    (a coded lane among theirs): (run all, plain version of all, the solo
    kernel G times per call — one decode_lanes a task over its narrowed
    lanes —, the kernel alone over entries built beforehand, the host's
    entry builds, bytes, error, calls, G) — as _k10_expr and _k10_seg
    return them for their modes."""
    import torch

    from tidb_tpu_torch.kernels import decode_lanes
    from tidb_tpu_torch.kernels.decode_lane import codec, launch
    from tidb_tpu_torch.kernels.grouped import (decode_lanes_tasks, decode_lanes_tasks_prepare,
                                                decode_lanes_tasks_ref, narrow_enc)

    coded = lambda encs: codec(encs[0]) in ("pack", "dict", "rle")  # noqa: E731
    calls = [c for c in calls if any(coded(encs) for encs in c[0])]
    err, nbytes = 0.0, 0
    for lanes, rvs, w in calls:
        got, want = decode_lanes_tasks(lanes, rvs, w), decode_lanes_tasks_ref(lanes, rvs, w)
        torch.cuda.synchronize()
        for encs, gl, wl in zip(lanes, got, want):
            if not coded(encs):
                continue
            for g, wv in zip(gl, wl):
                err = max(err, _same(g, wv, "decode_lane_tasks on the main path", floats=wv.is_floating_point()))
            for e, o in zip(encs, gl):
                nbytes += sum(_nbytes(x[:w] if k in ("p", "c") else x) for k, x in
                              ((k, x.reshape(-1)) for k, x in e.items() if k not in ("b", "re"))) + _nbytes(o)
    dev = calls[0][1][0].device if calls else None
    prepared = [decode_lanes_tasks_prepare(*c, dev) for c in calls]
    return (lambda: [decode_lanes_tasks(*c) for c in calls],
            lambda: [decode_lanes_tasks_ref(*c) for c in calls],
            lambda: [decode_lanes([narrow_enc(encs[g], w) for encs in lanes], rv.reshape(-1)[:w])
                     for lanes, rvs, w in calls for g, rv in enumerate(rvs)],
            lambda: [launch(words, ne, dev) for _, words, ne in prepared],
            lambda: [decode_lanes_tasks_prepare(*c, dev) for c in calls],
            nbytes, err, len(calls), len(calls[0][1]) if calls else 0)


def _k10_expr(calls):
    import torch

    from tidb_tpu_torch.kernels import expr_eval
    from tidb_tpu_torch.kernels.grouped import (expr_eval_tasks, expr_eval_tasks_prepare, expr_eval_tasks_ref,
                                                expr_tables)

    err, nbytes = 0.0, 0
    for prog, ins, w in calls:
        got, want = expr_eval_tasks(prog, ins, w), expr_eval_tasks_ref(prog, ins, w)
        torch.cuda.synchronize()
        for g in range(len(ins)):
            err = max(err, _same_expr_outs(prog, [o[g] for o in got], [o[g] for o in want]))
        nbytes += sum(_nbytes(*[x.reshape(-1)[:w] for x in task]) for task in ins) + _nbytes(*got)
    gos = [expr_eval_tasks_prepare(prog, ins, w, ins[0][0].device)[1] for prog, ins, w in calls]
    outs = [expr_eval_tasks_prepare(prog, ins, w, ins[0][0].device)[0] for prog, ins, w in calls]
    return (lambda: [expr_eval_tasks(*c) for c in calls],
            lambda: [expr_eval_tasks_ref(*c) for c in calls],
            lambda: [expr_eval(prog, [x.reshape(-1)[:w] for x in task], w) for prog, ins, w in calls for task in ins],
            lambda: [go() for go in gos if go is not None],
            lambda: [expr_tables(prog, ins, o, w) for (prog, ins, w), o in zip(calls, outs)],
            nbytes, err, len(calls), len(calls[0][1]) if calls else 0)


def _k10_seg(calls):
    import torch

    from tidb_tpu_torch.kernels import SegKey, SegLane, seg_agg
    from tidb_tpu_torch.kernels.grouped import seg_agg_tasks, seg_agg_tasks_prepare, seg_agg_tasks_ref
    from tidb_tpu_torch.kernels.seg_agg import seg_desc

    def cut(t, w):
        return None if t is None else t.reshape(-1)[:w]

    err, nbytes, solo = 0.0, 0, []
    for masks, keys, lanes, nseg, w in calls:
        (gi, gf), (wi, wf) = seg_agg_tasks(masks, keys, lanes, nseg, w), seg_agg_tasks_ref(masks, keys, lanes, nseg, w)
        torch.cuda.synchronize()
        _same(gi, wi, "seg_agg_tasks ints on the main path")
        err = max(err, _same(gf, wf, "seg_agg_tasks floats on the main path", True))
        for m, ks, ls in zip(masks, keys, lanes):
            k2 = [SegKey(cut(k.data, w), cut(k.valid, w), k.lo, k.dom) for k in ks]
            l2 = [SegLane(l.op, cut(l.data, w), cut(l.valid, w), l.fill) for l in ls]
            solo.append((cut(m, w), k2, l2, nseg))
            nbytes += _nbytes(cut(m, w), *_pairs((k.data, k.valid) for k in k2), *_pairs((l.data, l.valid) for l in l2))
        nbytes += _nbytes(gi, gf)
    prepared = [seg_agg_tasks_prepare(*c, c[0][0].device) for c in calls]
    gos = [go for _, go in prepared]
    return (lambda: [seg_agg_tasks(*c) for c in calls],
            lambda: [seg_agg_tasks_ref(*c) for c in calls],
            lambda: [seg_agg(*s) for s in solo],
            lambda: [go() for go in gos],
            lambda: [seg_desc(m, k, l, w, 0, *outs) for (m, k, l, _, w), (outs, _) in zip(calls, prepared)],
            nbytes, err, len(calls), len(calls[0][0]) if calls else 0)


def _k10_topk(calls):
    """K6's task mode over the captured calls, as _k10_decode (the kernels
    alone: the select and, for k within K6's cap, its ordering over its
    prepared table), and the single PyTorch call that computes the same
    function: torch.topk along dim -1 of the [G, width] sort key."""
    import torch

    from tidb_tpu_torch.kernels import topk
    from tidb_tpu_torch.kernels.grouped import _cut, topk_tasks, topk_tasks_prepare, topk_tasks_ref
    from tidb_tpu_torch.kernels.topk import sort_key, topk_table

    err, nbytes, solo, keys2d = 0.0, 0, [], []
    for datas, valids, masks, desc, k, w in calls:
        (gi, go), (wi, wo) = topk_tasks(datas, valids, masks, desc, k, w), topk_tasks_ref(datas, valids, masks, desc, k, w)
        torch.cuda.synchronize()
        _same(gi, wi, "topk_tasks rows on the main path")
        _same(go, wo, "topk_tasks ok bits on the main path")
        cut = [(_cut(d, w), _cut(v, w), _cut(m, w)) for d, v, m in zip(datas, valids, masks)]
        solo += [(d, v, m, desc, k) for d, v, m in cut]
        nbytes += sum(_nbytes(*c) for c in cut) + 5 * gi.numel()
        keys2d.append((torch.stack([sort_key(d, v, m, desc) for d, v, m in cut]), k))
    gos = [topk_tasks_prepare(*c, c[0][0].device)[1] for c in calls]
    return (lambda: [topk_tasks(*c) for c in calls], lambda: [topk_tasks_ref(*c) for c in calls],
            lambda: [topk(*x) for x in solo], lambda: [go() for go in gos],
            lambda: [topk_table(c[0], c[1], c[2], c[5], c[0][0].get_device()) for c in calls],
            nbytes, err, len(calls), len(calls[0][0]) if calls else 0,
            lambda: [torch.topk(x, k, dim=-1) for x, k in keys2d])


def _k10_multi(calls):
    """K7's task mode over the captured calls, as _k10_decode (the kernels
    alone: the select and its ordering over a prepared table), and the
    nearest single PyTorch call: torch.topk(k, largest=False) along dim -1
    of one packed word of the operands' varying bits per row, [G, width]
    (it does less: no tie rule, no mask bits). The bytes are
    k7_need_bytes of each task's narrowed lanes."""
    import torch

    from tidb_tpu_torch.kernels import topn_multi, topn_multi_ops_ref
    from tidb_tpu_torch.kernels.grouped import (_cut, sort_op, topn_multi_tasks, topn_multi_tasks_prepare,
                                                topn_multi_tasks_ref)
    from tidb_tpu_torch.kernels.tables import lane_table

    err, nbytes, solo, words = 0.0, 0, [], []
    for masks, keys, k, w in calls:
        (gi, go), (wi, wo) = topn_multi_tasks(masks, keys, k, w), topn_multi_tasks_ref(masks, keys, k, w)
        torch.cuda.synchronize()
        _same(gi, wi, "topn_multi_tasks rows on the main path")
        _same(go, wo, "topn_multi_tasks ok bits on the main path")
        ops = []
        for m, ks in zip(masks, keys):
            cut = [(_cut(d, w), _cut(v, w), desc) for d, v, desc in ks]
            solo.append((_cut(m, w), cut, k))
            nbytes += k7_need_bytes(_cut(m, w), cut, k)
            ops.append(topn_multi_ops_ref(_cut(m, w), cut))
        word = _packed_word([type(o)(torch.cat([p[q].data for p in ops]), o.kind) for q, o in enumerate(ops[0])])
        words.append(None if word is None else (word.reshape(len(masks), -1), min(k, w)))
    gos = [topn_multi_tasks_prepare(*c, c[0][0].device) for c in calls]
    library = None if any(x is None for x in words) else (
        lambda: [torch.topk(x, k, dim=-1, largest=False) for x, k in words])
    return (lambda: [topn_multi_tasks(*c) for c in calls], lambda: [topn_multi_tasks_ref(*c) for c in calls],
            lambda: [topn_multi(*x) for x in solo], lambda: [go() for go in gos],
            lambda: [lane_table(m, [[(sort_op(d), v) for d, v, _ in ks] for ks in keys], w, m[0].get_device(), "k7")
                     for m, keys, _, w in calls],
            nbytes, err, len(calls), len(calls[0][0]) if calls else 0, library)


def _k8_of_k9_tasks(calls) -> list:
    """The (operands, task width) of the K8 task-leading sort each captured
    K9 task-mode call makes (kernels/grouped.py's sort_launch)."""
    grouped = importlib.import_module("tidb_tpu_torch.kernels.grouped")
    out = []
    for masks, keys, w in calls:
        seen, _ = calls_inside(grouped, "sort_launch", lambda: grouped.sort_groups_tasks(masks, keys, w))
        out += [(a[0], a[2]) for a, _ in seen]
    return out


def _k10_lexsort(calls):
    """K8's task-leading mode over the captured calls (it has no task
    table: the kernels are the call), and the nearest single PyTorch call:
    a batched torch.sort(stable=True) along dim -1 of one packed word per
    row, [G, width] (None when the operands need more than 63 bits)."""
    import torch

    from tidb_tpu_torch.kernels import SortOp, lex_sort_perm
    from tidb_tpu_torch.kernels.grouped import lex_sort_perm_tasks, lex_sort_perm_tasks_ref

    err, nbytes, solo, words = 0.0, 0, [], []
    for ops, w in calls:
        _same(lex_sort_perm_tasks(ops, w), lex_sort_perm_tasks_ref(ops, w), "lex_sort_tasks on the main path")
        n = ops[0].data.numel()
        solo += [[SortOp(o.data[g * w:(g + 1) * w], o.kind) for o in ops] for g in range(n // w)]
        nbytes += sum(_nbytes(o.data) for o in ops) + 4 * n
        word = _packed_word(ops)
        words.append(None if word is None else word.reshape(-1, w))
    library = None if any(x is None for x in words) else (
        lambda: [torch.sort(x, dim=-1, stable=True) for x in words])
    return (lambda: [lex_sort_perm_tasks(*c) for c in calls], lambda: [lex_sort_perm_tasks_ref(*c) for c in calls],
            lambda: [lex_sort_perm(x) for x in solo], None, None,
            nbytes, err, len(calls), calls[0][0][0].data.numel() // calls[0][1] if calls else 0, library)


def _k10_groups(calls):
    """K9's task mode over the captured calls, as _k10_decode (the kernels
    alone: the ops kernel over its prepared table; the rest of a call
    waits on K8's and its own count read), and the solo K9 row's nearest
    single PyTorch call over the same tasks: torch.unique_consecutive over
    every task's first key, sorted within the task, task after task."""
    import torch

    from tidb_tpu_torch.kernels import sort_groups
    from tidb_tpu_torch.kernels.grouped import (_cut, sort_groups_tasks, sort_groups_tasks_prepare,
                                                sort_groups_tasks_ref, sort_op)
    from tidb_tpu_torch.kernels.tables import lane_table

    err, nbytes, solo, skeys = 0.0, 0, [], []
    for masks, keys, w in calls:
        _k9_tasks(masks, keys, w)
        got = sort_groups_tasks(masks, keys, w)
        for m, ks in zip(masks, keys):
            cut = [(_cut(d, w), _cut(v, w)) for d, v in ks]
            solo.append((_cut(m, w), cut, lambda ng: ng))
            nbytes += _nbytes(_cut(m, w), *[getattr(d, "bits", d) for d, _ in cut], *[v for _, v in cut])
        nbytes += 4 * got.seg.numel() + 16 * len(keys[0]) * sum(got.counts)
        first = torch.stack([getattr(d, "bits", d).reshape(-1)[:w] for (d, _), *_ in keys])
        skeys.append(torch.sort(first, dim=-1).values.reshape(-1))
    gos = [sort_groups_tasks_prepare(*c, c[0][0].device)[2] for c in calls]
    return (lambda: [sort_groups_tasks(*c) for c in calls], lambda: [sort_groups_tasks_ref(*c) for c in calls],
            lambda: [sort_groups(*x) for x in solo], lambda: [go() for go in gos],
            lambda: [lane_table(m, [[(sort_op(d), v) for d, v in ks] for ks in keys], w, m[0].get_device(), "k9")
                     for m, keys, w in calls],
            nbytes, err, len(calls), len(calls[0][0]) if calls else 0,
            lambda: [torch.unique_consecutive(x, return_inverse=True) for x in skeys])


def _k10_segs(calls):
    """K4's task mode over K9's task-grid ids (the sort GROUP BY's
    segment-lane calls), as _k10_seg: the solo kernel per task on its
    narrowed lanes and its own ids."""
    import torch

    from tidb_tpu_torch.kernels import SegLane, seg_agg
    from tidb_tpu_torch.kernels.grouped import _cut, seg_agg_tasks, seg_agg_tasks_prepare, seg_agg_tasks_ref
    from tidb_tpu_torch.kernels.seg_agg import seg_desc

    err, nbytes, solo = 0.0, 0, []
    for (masks, keys, lanes, nseg, w), kw in calls:
        (gi, gf), (wi, wf) = (seg_agg_tasks(masks, keys, lanes, nseg, w, **kw),
                              seg_agg_tasks_ref(masks, keys, lanes, nseg, w, **kw))
        torch.cuda.synchronize()
        _same(gi, wi, "seg_agg_tasks segment-lane ints on the main path")
        err = max(err, _same(gf, wf, "seg_agg_tasks segment-lane floats on the main path", True))
        off = 0
        for m, ls, sg, c in zip(masks, lanes, kw["segs"], kw["counts"]):
            cut = [SegLane(l.op, _cut(l.data, w), _cut(l.valid, w), l.fill) for l in ls]
            if c:
                solo.append((_cut(m, w), [], cut, c, _cut(sg, w) - off))
            off += c
            nbytes += _nbytes(_cut(m, w), _cut(sg, w), *_pairs((l.data, l.valid) for l in cut))
        nbytes += _nbytes(gi, gf)
    prepared = [seg_agg_tasks_prepare(*a, a[0][0].device, kw["segs"]) for a, kw in calls]
    return (lambda: [seg_agg_tasks(*a, **kw) for a, kw in calls],
            lambda: [seg_agg_tasks_ref(*a, **kw) for a, kw in calls],
            lambda: [seg_agg(m, k, l, c, seg=sg) for m, k, l, c, sg in solo], lambda: [go() for _, go in prepared],
            lambda: [seg_desc(a[0], a[1], a[2], a[4], 0, *outs, kw["segs"]) for (a, kw), (outs, _) in zip(calls, prepared)],
            nbytes, err, len(calls), len(calls[0][0][0]) if calls else 0, None)


def host_ms(fn, reps: int = 10) -> float:
    """Mean host-clock time of fn() over reps calls, after a warm-up call
    (for host-only work: nothing is synchronized)."""
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps * 1e3


def measure_grouped_kernels(main: dict, max_err: dict):
    """K10's task-grid modes on the main path's own group inputs (the last
    run_many of each main.burst mix, compression ON, of main.q1_regions
    and of each main.regions_sorted query): held once more to their plain
    versions, timed beside them, their bytes bound, and — the yardstick of
    the work K10 replaces — the solo kernel launched G times back to back
    on the same narrowed tensors (`solo_x_G_ms`: never used on the path)
    — and `kernel_ms`, the same launches alone over tables built
    beforehand (`*_prepare`; for K6 and K7 the select and its ordering,
    for K9 the ops kernel, for K8 none: it has no table), so that `ms`
    less `kernel_ms` is the wrappers' host work (and, for K8 and K9, their
    one sync each; K6 and K7 within their ordering caps have none), of
    which `host_tables_ms` builds the task tables. K8's mode is timed on
    the operands K9's mode hands it (Q18's subquery over the regions: the
    multi-key TopN no longer sorts). The sort modes also give the nearest
    single PyTorch call (`library_ms`: torch.topk over the [G, width] sort
    key; torch.topk(largest=False) over one packed word of K7's operands;
    a batched stable torch.sort over one packed word;
    torch.unique_consecutive over every task's sorted key, the solo K9
    row's yardstick). The kernels-line row of K1's and K4's modes is the
    burst's, the expression kernel's (which the point aggregation does not
    launch: its program has no work) Q1's regions', and the sort modes'
    the regions' (the slice at full width); K1's, the expression kernel's and K4's rows keep the
    solo kernel x G in `library_ms`."""
    bound = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
    cap = main["captured"]
    sources = {"burst": cap["burst"]["compression_on"], "q1_regions": cap["q1_regions"],
               "burst.point_topn": cap["burst"]["point_topn.compression_on"],
               "burst.point_topn_multi": cap["burst"]["point_topn_multi.compression_on"]}
    sources.update({f"regions.{q}": calls for q, calls in cap["regions_sorted"].items()})
    modes = (("decode_lane_tasks", "decode_lanes_tasks", _k10_decode), ("expr_eval_tasks", "expr_eval_tasks", _k10_expr),
             ("seg_agg_tasks", "seg_agg_tasks", _k10_seg), ("seg_agg_tasks segment-lane", "seg_agg_tasks", _k10_segs),
             ("topk_tasks", "topk_tasks", _k10_topk), ("topn_multi_tasks", "topn_multi_tasks", _k10_multi),
             ("lex_sort_tasks", "sort_groups_tasks", _k10_lexsort), ("sort_groups_tasks", "sort_groups_tasks", _k10_groups))
    report: dict = {}
    for src, calls in sources.items():
        for mode, spied, fn in modes:
            picked = task_args(calls, spied, keywords=mode.endswith("segment-lane"))
            if mode == "lex_sort_tasks":  # K8's task-leading mode: the operands K9's mode hands it
                picked = _k8_of_k9_tasks(picked)
            if not picked:
                continue
            run, plain, solo, kernel, tables, nbytes, err, ncalls, G, *library = fn(picked)
            name = mode.split()[0]
            max_err[name] = max(max_err[name], err)
            r = report.setdefault(src, {})[mode] = {
                "calls": ncalls, "tasks": G, "ms": time_ms(run), "plain_ms": time_ms(plain, 3),
                "solo_x_G_ms": time_ms(solo), "kernel_ms": None if kernel is None else time_ms(kernel),
                "host_tables_ms": 0.0 if tables is None else host_ms(tables), "bytes": nbytes,
                "bound_ms": bound(nbytes)}
            if library and library[0] is not None:
                r["library_ms"] = time_ms(library[0])
    L = main["launches"]
    entries = []
    rows = (("decode_lane_tasks", "burst", "decode_lane.cu"), ("expr_eval_tasks", "q1_regions", "expr_eval.cu"),
            ("seg_agg_tasks", "burst", "seg_agg.cu"), ("topk_tasks", "regions.tpch_topn", "topk.cu"),
            ("topn_multi_tasks", "regions.multikey_topn", "topn_multi.cu"),
            ("lex_sort_tasks", "regions.q18_inner", "lex_sort.cu"),
            ("sort_groups_tasks", "regions.q18_inner", "sort_groups.cu"))
    for mode, src, cu in rows:
        r = report[src][mode]
        # K1's, the expression kernel's and K4's rows keep the solo kernel x G as their yardstick; the
        # sort modes give the nearest single PyTorch call, where there is one
        lib = r["solo_x_G_ms"] if mode in AGG_TASK_MODES else r.get("library_ms")
        entries.append({"name": mode, "route": "cuda", "source": f"tidb_tpu_torch/csrc/{cu}",
                        "replaces": "tidb_tpu/copr/tpu_engine.py:1096", "launches": L[mode],
                        "max_abs_err": max_err[mode], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": lib})
    return entries, report


def _nbytes(*ts) -> int:
    """Bytes of the distinct tensors among ts: one passed twice (an
    aggregate's value and count lanes share their valid lane) counts once."""
    seen = {(t.data_ptr(), t.numel() * t.element_size()) for t in ts if t is not None}
    return sum(b for _, b in seen)


def _pairs(pairs) -> list:
    """The tensors of (data, valid) pairs, flattened for _nbytes."""
    return [t for pair in pairs for t in pair]


def _packed_word(ops):
    """The operands' ordered keys packed into one int64 (each shifted to
    its range), most significant first — None when they need more than 63
    bits. torch.argsort(stable=True) over it is the one-call yardstick
    for a multi-key sort."""
    from tidb_tpu_torch.kernels.lex_sort import ordered_key

    word, used = None, 0
    for op in reversed(ops):
        k = ordered_key(op)
        lo, hi = int(k.min()), int(k.max())
        if hi - lo >= 1 << 62:
            return None
        width = (hi - lo).bit_length()
        if used + width > 63:
            return None
        part = (k - lo) << used if width else None
        word = part if word is None else (word if part is None else word | part)
        used += width
    return word


def k7_need_bytes(mask, keys, k: int) -> int:
    """The bytes a multi-key TopN of k rows must move on this data: the
    mask and the first key's lanes (data and valid) at every row; a later
    key's lanes only at the rows still tied with the k-th row on every
    operand before it, and at the k rows returned (to order them); the k
    row ids and mask bits written. A later key read at every row (25
    bytes a row on multikey_topn) is what a sort of every row needs, not
    the TopN."""
    import torch

    from tidb_tpu_torch.kernels.lex_sort import lex_sort_perm_ref, ordered_key
    from tidb_tpu_torch.kernels.topn_multi import topn_multi_ops_ref

    n = mask.numel()
    k = min(k, n)
    if k == 0:
        return 0
    ops = topn_multi_ops_ref(mask, keys)
    rows = lex_sort_perm_ref(ops)[:k].long()
    picked = torch.zeros_like(mask)
    picked[rows] = True

    def at_kth(op):
        o = ordered_key(op)
        return o == o[rows[-1]]

    tied, total = at_kth(ops[0]), _nbytes(mask) + 9 * k
    for j, (d, v, _) in enumerate(keys):
        row_bytes = sum(t.element_size() for t in (getattr(d, "bits", d), v) if t is not None)
        total += row_bytes * (n if j == 0 else int((tied | picked).sum()))
        tied &= at_kth(ops[1 + 2 * j]) & at_kth(ops[2 + 2 * j])
    return total


def calls_inside(module, name: str, fn) -> tuple[list, float]:
    """(the (args, kwargs) of every call of `module.name` — a kernel
    wrapper another kernel's module imports by name — that one fn() makes,
    caught on one run, and the mean device ms of those calls alone): the
    share of that kernel in the one that calls it."""
    seen, real = [], getattr(module, name)

    def spy(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)
    setattr(module, name, spy)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return seen, time_ms(lambda: [real(*a, **kw) for a, kw in seen]) if seen else 0.0


def k8_inside(module, fn) -> tuple[list, float]:
    """(the operands of every K8 call one fn() makes through `module`,
    and the mean device ms of those K8 calls alone): calls_inside for
    lex_sort_perm, or for kernels/compact's launch where the module sorts
    the rows its compaction kept (P4, P5)."""
    if hasattr(module, "lex_sort_perm"):
        seen, ms = calls_inside(module, "lex_sort_perm", fn)
    else:
        seen, ms = calls_inside(importlib.import_module("tidb_tpu_torch.kernels.compact"), "launch", fn)
    return [a[0] for a, _ in seen], ms


def measure_sort_kernels(main: dict, max_err: dict):
    """K6-K9 (and K4's segment-lane mode) on the main path's own inputs:
    held once more to the plain versions on exactly those tensors, then
    timed beside the plain version, the bytes bound and the single
    PyTorch call that computes the same function, where there is one
    (K9's: torch.unique over the packed word of the operands K9 hands
    K8). K9's `k8_ms` is the share of its K8 call."""
    import torch

    from tidb_tpu_torch.kernels import (lex_sort_perm, lex_sort_perm_ref, seg_agg, seg_agg_ref, sort_groups,
                                        sort_groups_ref, topk, topk_ref, topn_multi, topn_multi_ops_ref, topn_multi_ref)
    from tidb_tpu_torch.kernels.topk import orders_in_kernel, select_prepare, sort_key
    from tidb_tpu_torch.kernels.topn_multi import _ops_in, order_cap
    from tidb_tpu_torch.kernels.topn_multi import select_prepare as multi_prepare

    cap = main["captured"]
    bound = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
    k9_module = importlib.import_module("tidb_tpu_torch.kernels.sort_groups")  # the package re-exports the wrapper's name
    topk_select = lambda d, v, m, desc, k: select_prepare([d], [v], [m], desc, k, d.numel(), d.device)  # noqa: E731

    (d, v, m, desc, k), _ = cap["tpch_topn"]["topk"]
    (gi, go), (wi, wo) = topk(d, v, m, desc, k), topk_ref(d, v, m, desc, k)
    torch.cuda.synchronize()
    _same(gi, wi, "topk rows on tpch_topn")
    _same(go, wo, "topk ok bits on tpch_topn")
    sk = sort_key(d, v, m, desc)
    # the kernels alone over a prepared one-task table (the select and,
    # for k within the cap, the ordering), and the host's preparation of
    # it: the table's build and pinned copy, the outputs' allocation
    _, select = topk_select(d, v, m, desc, k)
    k6 = {"ms": time_ms(lambda: topk(d, v, m, desc, k)), "plain_ms": time_ms(lambda: topk_ref(d, v, m, desc, k), 3),
          "library_ms": time_ms(lambda: torch.topk(sk, k)), "bytes": _nbytes(d, v, m) + k * 5,
          "select_ms": time_ms(select), "prepare_host_ms": host_ms(lambda: topk_select(d, v, m, desc, k)),
          "rows": d.numel(), "k": k, "desc": desc, "ordered_in_kernel": orders_in_kernel(k)}

    (mask, keys, k), _ = cap["multikey_topn"]["topn_multi"]
    caps = [order_cap(nk) for nk in range(1, 6)]
    if caps != [MULTI_KS[2]] * 5:
        raise AssertionError(f"K7's ordering cap for 1-5 keys is {caps}: MULTI_KS no longer straddles it")
    # the main path's inputs at its k and MULTI_KS's: one row, K7's
    # ordering cap and one past it (K8 orders those)
    for kk in sorted({k, *MULTI_KS}):
        (gi, go), (wi, wo) = topn_multi(mask, keys, kk), topn_multi_ref(mask, keys, kk)
        torch.cuda.synchronize()
        _same(gi, wi, f"topn_multi rows on multikey_topn, k={kk}")
        _same(go, wo, f"topn_multi ok bits on multikey_topn, k={kk}")
    # every key's lanes at every row (what a sort of every row reads): context beside the bound
    k7_all = _nbytes(mask, *_pairs((getattr(kd, "bits", kd), kv) for kd, kv, _ in keys)) + 9 * k
    word7 = _packed_word(topn_multi_ops_ref(mask, keys))
    n7, checked = _ops_in(mask, keys)
    select7 = multi_prepare([mask], [checked], k, n7, mask.device)
    k7 = {"ms": time_ms(lambda: topn_multi(mask, keys, k)), "plain_ms": time_ms(lambda: topn_multi_ref(mask, keys, k), 3),
          "library_ms": None if word7 is None else time_ms(lambda: torch.topk(word7, k, largest=False)),
          "library_call": "torch.topk(k, largest=False) of one packed word of the operands' varying bits (no tie "
                          "rule, no mask bits)",
          "kernels_ms": time_ms(select7), "bytes": k7_need_bytes(mask, keys, k), "all_keys_bytes": k7_all, "keys": len(keys), "k": k, "rows": n7,
          # a profiled session can miss a kernel: the one that saw the most
          **max((kernel_split(lambda: topn_multi(mask, keys, k)) for _ in range(3)),
                key=lambda x: x.get("launches") or 0)}

    (mask, keys, cap_of), _ = cap["q18_inner"]["sort_groups"]
    g, w = sort_groups(mask, keys, cap_of), sort_groups_ref(mask, keys, cap_of)
    torch.cuda.synchronize()
    _same_groups(g, w, "sort_groups on q18_inner")
    skey = torch.sort(keys[0][0]).values
    k9_ops, k9_k8 = k8_inside(k9_module, lambda: sort_groups(mask, keys, cap_of))
    k9_word = _packed_word(k9_ops[0])
    k9 = {"ms": time_ms(lambda: sort_groups(mask, keys, cap_of)),
          "plain_ms": time_ms(lambda: sort_groups_ref(mask, keys, cap_of), 3),
          "library_ms": None if k9_word is None else time_ms(
              lambda: torch.unique(k9_word, sorted=True, return_inverse=True)),
          "library_call": "torch.unique(sorted=True, return_inverse=True) of the packed word of K9's K8 operands",
          "k8_ms": k9_k8, "k8_calls": len(k9_ops),
          "unique_consecutive_sorted_key_ms": time_ms(lambda: torch.unique_consecutive(skey, return_inverse=True)),
          "bytes": _nbytes(mask, *_pairs((getattr(kd, "bits", kd), kv) for kd, kv in keys))
          + 4 * mask.numel() + 16 * len(keys) * g.n_groups,
          "n_groups": g.n_groups, "cap": g.cap,
          "note": "ms includes K8 over the masked-in rows (k8_ms) and two syncs (their count, then n_groups)"}

    # K8 on the main path: the operands K9 hands it on Q18's subquery (the
    # multi-key TopN no longer sorts)
    ops = k9_ops[0]
    _same(lex_sort_perm(ops), lex_sort_perm_ref(ops), "lex_sort on q18_inner's kept rows")
    word = _packed_word(ops)
    k8 = {"ms": time_ms(lambda: lex_sort_perm(ops)), "plain_ms": time_ms(lambda: lex_sort_perm_ref(ops), 3),
          "library_ms": None if word is None else time_ms(lambda: torch.argsort(word, stable=True)),
          "bytes": sum(_nbytes(o.data) for o in ops) + 4 * ops[0].data.numel(), "operands": len(ops),
          "rows": ops[0].data.numel(), "on": "q18_inner"}

    (mask, no_keys, lanes, nseg), kw = cap["q18_inner"]["seg_agg"]
    seg = kw["seg"]
    (gi, gf), (wi, wf) = seg_agg(mask, no_keys, lanes, nseg, seg=seg), seg_agg_ref(mask, no_keys, lanes, nseg, seg=seg)
    torch.cuda.synchronize()
    _same(gi, wi, "seg_agg segment-lane ints on q18_inner")
    max_err["seg_agg"] = max(max_err["seg_agg"], _same(gf, wf, "seg_agg segment-lane floats on q18_inner", True))
    # nearest single PyTorch call: index_add_ of the sum lane on the clamped ids
    ids = torch.where(mask & (seg < nseg), seg, nseg).long()
    sums = next(l.data for l in lanes if l.op == "sum_i64")
    acc = torch.zeros(nseg + 1, dtype=torch.int64, device=sums.device)
    k4s = {"ms": time_ms(lambda: seg_agg(mask, no_keys, lanes, nseg, seg=seg)),
           "plain_ms": time_ms(lambda: seg_agg_ref(mask, no_keys, lanes, nseg, seg=seg), 3),
           "index_add_sum_lane_ms": time_ms(lambda: acc.zero_().index_add_(0, ids, sums)),
           "bytes": _nbytes(mask, seg, *_pairs((l.data, l.valid) for l in lanes)) + 8 * nseg * len(lanes),
           "nseg": nseg, "lanes": len(lanes)}

    L = main["launches"]

    def entry(name, src, ref, meas):
        return {"name": name, "route": "cuda", "source": f"tidb_tpu_torch/csrc/{src}",
                "replaces": f"tidb_tpu/copr/tpu_engine.py:{ref}", "launches": L[name],
                "max_abs_err": max_err[name], "ms": meas["ms"], "plain_ms": meas["plain_ms"],
                "bound_ms": bound(meas["bytes"]), "bound_by": "bytes", "library_ms": meas.get("library_ms")}

    return ([entry("topk", "topk.cu", 1759, k6), entry("topn_multi", "topn_multi.cu", 1796, k7),
             entry("lex_sort", "lex_sort.cu", 195, k8), entry("sort_groups", "sort_groups.cu", 1351, k9)],
            {"topk": k6, "topn_multi": k7, "lex_sort": k8, "sort_groups": k9, "seg_agg_segment_lane": k4s})


def _lane_bytes(x) -> int:
    from tidb_tpu_torch.expr.xp_torch import U64

    return _nbytes(x.bits if isinstance(x, U64) else x)


def kernel_split(call, tries: int = 3) -> dict:
    """{"split_ms": device ms per inner kernel of one call (summed by
    kernel name), "launches": the kernels it launched} from torch.profiler's
    CUDA events, after a warm-up call. A session can miss its first kernel,
    so a marker kernel of torch's (left out of the split, as are torch's own
    kernels: the profiled calls launch none) opens it; a session that saw
    none of the call's kernels is tried again. Late in a long run the
    profiler has seen none of the port's kernels in some sessions (twice,
    on different calls, on the same card): then both values are None and
    `profiler_saw_no_kernels` says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    marker = torch.zeros(1, device="cuda")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            marker.add_(1)
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
        split: dict = {}
        launches = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or e.name.startswith(("void at::", "at::", "Memset")):
                continue
            name = re.sub(r"<.*|\(.*", "", e.name.replace("(anonymous namespace)::", "")).replace("void ", "")
            split[name] = split.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
            launches += not name.startswith("Memcpy")
        if launches:
            return {"split_ms": dict(sorted(split.items(), key=lambda kv: -kv[1])), "launches": launches}
    return {"split_ms": None, "launches": None, "profiler_saw_no_kernels": True}


def measure_window_kernels(main: dict, max_err: dict):
    """W1 and W2 on each window query's own inputs: held once more to the
    plain versions, then timed beside them with their bytes bound. W1 is
    timed over the query's own sort (perm from K8, computed once), so K8
    stays out of its time (`ms`; `with_sort_ms` is K8 and W1 together); its
    launches per call and device ms per inner kernel come from one profiled
    call. Beside them the nearest single PyTorch calls of its steps
    (torch.cumsum for a prefix sum, torch.searchsorted for the RANGE
    search, torch.cummax for the growing-frame max) on lanes of its size."""
    import torch

    from tidb_tpu_torch.kernels import lex_sort_perm, pack_flat, pack_flat_ref, window, window_ref

    W = importlib.import_module("tidb_tpu_torch.kernels.window")  # the package re-exports the wrapper's name
    bound = lambda b: b / HBM_BYTES_PER_S * 1e3  # noqa: E731
    per_query = {}
    for qname, _ in WINDOW_QUERIES:
        cap = main["captured"][qname]
        args, kw = cap["window"]
        words, fargs, spec, rk = args
        err = _same_outs(window(*args, **kw), window_ref(*args, **kw), f"window on {qname}")
        perm = lex_sort_perm(W._words_ops(words))
        err = max(err, _same_outs(W.window_sorted(*args, perm), W.window_sorted_ref(*args, perm),
                                  f"window after its sort on {qname}"))
        max_err["window"] = max(max_err["window"], err)
        outs = cap["pack_flat"]
        _same(pack_flat(outs), pack_flat_ref(outs), f"pack_flat on {qname}")
        P = words[0].numel()
        w_in = sum(_nbytes(w) for w in words) + _nbytes(*(t for fa in fargs for d, v in fa
                                                          for t in (d.bits if hasattr(d, "bits") else d, v)))
        w_in += (_nbytes(rk[0], rk[1]) if rk is not None else 0)
        w_out = sum(_lane_bytes(o) for o in outs)
        flat = pack_flat(outs)
        prof = kernel_split(lambda: W.window_sorted(*args, perm))
        per_query[qname] = {
            "P": P, "funcs": [f[0] for f in spec[2]],
            "window": {"ms": time_ms(lambda: W.window_sorted(*args, perm), 5),
                       "plain_ms": time_ms(lambda: W.window_sorted_ref(*args, perm), 2),
                       "with_sort_ms": time_ms(lambda: window(*args, **kw), 5),
                       "with_sort_plain_ms": time_ms(lambda: window_ref(*args, **kw), 2),
                       "k8_ms": time_ms(lambda: lex_sort_perm(W._words_ops(words)), 5),
                       "bytes": w_in + _nbytes(perm) + w_out, "launches_per_call": prof.pop("launches"),
                       **prof},
            "pack_flat": {"ms": time_ms(lambda: pack_flat(outs)), "plain_ms": time_ms(lambda: pack_flat_ref(outs), 3),
                          "bytes": w_out + _nbytes(flat), "lanes": len(outs)},
        }
    # the nearest single PyTorch calls of W1's steps, on lanes of P rows
    P = per_query["window_rank_frames"]["P"]
    dev = main["captured"]["window_rank_frames"]["window"][0][0][0].device
    lane = torch.randint(-1000, 1000, (P,), dtype=torch.int64, device=dev)
    comp = torch.sort(lane).values
    per_query["torch_calls"] = {
        "P": P,
        "cumsum_int64_ms": time_ms(lambda: torch.cumsum(lane, 0)),
        "searchsorted_int64_ms": time_ms(lambda: torch.searchsorted(comp, comp - 7)),
        "cummax_int64_ms": time_ms(lambda: torch.cummax(lane, 0)),
    }
    L = main["launches"]
    rf = per_query["window_rank_frames"]
    entries = [
        {"name": "window", "route": "cuda", "source": "tidb_tpu_torch/csrc/window.cu",
         "replaces": "tidb_tpu/executor/window_device.py:154", "launches": L["window"],
         "max_abs_err": max_err["window"], "ms": rf["window"]["ms"], "plain_ms": rf["window"]["plain_ms"],
         "bound_ms": bound(rf["window"]["bytes"]), "bound_by": "bytes", "library_ms": None},
        {"name": "pack_flat", "route": "cuda", "source": "tidb_tpu_torch/csrc/pack_flat.cu",
         "replaces": "tidb_tpu/jaxenv.py:104", "launches": L["pack_flat"],
         "max_abs_err": max_err["pack_flat"], "ms": rf["pack_flat"]["ms"], "plain_ms": rf["pack_flat"]["plain_ms"],
         "bound_ms": bound(rf["pack_flat"]["bytes"]), "bound_by": "bytes", "library_ms": None},
    ]
    return entries, per_query


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16_000_000)
    ap.add_argument("--win-rows", type=int, default=8_000_000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--q3-rows", type=int, default=4_000_000)
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
        main_res = run_main_path(dev, args.rows, args.seed, args.reps, card, args.win_rows, args.q3_rows)
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
