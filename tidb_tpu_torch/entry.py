"""Entry points of the port's coprocessor slice.

* `batch_from_numpy(table, columns, valid=None)`: region data as numpy
  lanes (the form of a reference ColumnBatch) → the port's ColumnBatch.
  It takes numpy arrays only, so both packages can be fed the same data.
* `run_query(dag, batch, device="cuda")`: the GPU cop engine over one
  batch, then the root's final step → the result chunk: for an
  aggregation the final merge of the partial chunk, ORDER BY the group
  keys; for a TopN the partial rows ordered by the TopN keys, first n
  kept (the reference's TopNExec).
* `run_window(scan_dag, spec, batch, device="cuda", mode="tpu")`: the
  scan through the GPU cop engine, then the port's WindowExec over its
  rows → the scan columns plus one column per window function, in scan
  row order (the reference's WindowExec.next over a TableReaderExec).
  `mode` is the WindowExec engine: 'tpu' runs W1 + W2 on `device` and
  raises on a device error; 'host' is the host oracle.
* `plan_select(sql_or_stmt, infoschema, db, stats=None, variables=None,
  run_subquery=None)`: a SELECT's optimized logical plan, as the
  reference's `Session.plan_select` makes it: `parser.parse_one`, then
  `PlanBuilder(...).build_select` (with the statement's optimizer hints),
  then `optimize(plan, stats, variables)` (`stats`: a
  statistics.StatsHandle, such as `Storage.stats`, or None).
  `run_subquery(select_ast) -> (rows, field types)` evaluates a subquery
  at plan time; without one such a statement raises NotPortedError (the
  executors are a later slice).
* `mpp_plan(plan, variables=None, engine=None)`: the MPPPlan the
  reference's executor tree runs for an optimized plan — `slice_plan` of
  the Aggregation or Join below the root (a typed decline counted by
  `engine`), the fused TopN attached, the host steps above the cut as its
  `root_step` — or None where the reference runs no MPP gather there.
* `run_mpp(mplan, tables, device="cuda", variables=None, mesh=None)`: an
  MPP fragment plan (its join levels, LUT or sort-probe, and its
  aggregation in the mode the engine chooses, or the joined rows) over the
  numpy columns of its tables on `device`, or over the ranks of `mesh`
  (parallel/mesh.make_mesh(n, device)), then the steps above the gather
  (`mplan.root_step`: the final aggregate, HAVING, the projection and the
  TopN) → the result chunk. `variables` are session variables, such as
  `tidb_tpu_mpp_fused` ("ON" by default).
* `run_many(pairs, device="cuda", engine=None)`: many (DAG, batch) cop
  tasks through `TorchEngine.execute_many` → their partial chunks: tasks
  sharing a program key run as launch groups (K10), and everything comes
  back with one host synchronization.
* `run_burst(pairs, device="cuda", engine=None, batcher=None)`: the same
  tasks from one thread each, released together through a barrier, each
  calling `LaunchBatcher.execute` (tools/bench_sched.py:_concurrent's
  shape, `concurrent(fn, pairs)`) → (partial chunks, per-task seconds).
* `entry(device="cuda")`: the flagship fused cop kernel (M1, TPC-H Q1's
  scan → filter → partial aggregation of one shard) as a function and its
  example lanes at 4096 rows (ref: __graft_entry__.entry).
* `dryrun_multichip(n, device="cuda", columns=None)`: the distributed step
  over n ranks (ref: __graft_entry__.dryrun_multichip): stage 1, M1 on
  each rank's shard merged by an exact int64 all_reduce (M2), held to a
  single-device numpy recompute; stage 2, the MPP hash exchange (M3: the
  send buffers, then all_to_all), which must drop nothing, put every key
  on its owner and preserve the payload's sum. n = 1 runs on `device` with
  identity collectives, over `columns` (lineitem lanes) when given; n > 1
  starts n gloo processes on the CPU, which run the plain versions (one
  H100 cannot host n NCCL ranks), as the reference re-execs onto a virtual
  CPU mesh. Stage 3 is the reference's without SQL: TPC-H Q3 from the
  hand-built models/tpch.q3_mpp_plan through run_mpp over make_mesh(n)
  (n ranks in this process, sharing `device` once the gloo processes have
  exited), equal in order to the one-device answer.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import sys
import threading
import time
from contextlib import nullcontext

import numpy as np
import torch

from .catalog.schema import TableInfo
from .chunk.chunk import Chunk, VARLEN, col_numpy_dtype
from .copr.dag import DAGRequest
from .copr.gpu_engine import TorchEngine
from .copr.tilecache import ColumnBatch
from .executor import mpp_gather
from .executor.executors import _mpp_topn_spec
from .executor.final_agg import merge_partials, order_by_keys, top_n
from .executor.window import WindowExec
from .parallel.mpp import MPPEngine
from .parallel.mesh import build_q1_arrays, distributed_q1_step, hash_repartition, make_mesh, q1_arrays, \
    q1_exact, q1_local_kernel
from .planner.fragment import MPPPlan
from .planner.plans import Aggregation, Join, Limit, Projection, Selection, Sort
from .sched.batcher import LaunchBatcher
from .torchenv import resolve_device


def batch_from_numpy(table: TableInfo, columns: dict[str, np.ndarray],
                     valid: dict[str, np.ndarray] | None = None) -> ColumnBatch:
    """One region's rows as a ColumnBatch: `columns` maps every visible
    column name to its lane (int64 for ints, scaled decimals and packed
    dates, uint64, float64, object for strings); `valid` optionally maps a
    name to its NOT-NULL mask. The hidden `_tidb_rowid` gets the handles."""
    n = len(next(iter(columns.values())))
    handles = np.arange(1, n + 1, dtype=np.int64)
    data, valids = [], []
    for c in table.columns:
        if c.name in columns:
            d = np.asarray(columns[c.name])
            dt = col_numpy_dtype(c.ft)
            d = d.astype(object) if dt is VARLEN else d.astype(dt, copy=False)
        elif c.hidden and c.name == "_tidb_rowid":
            d = handles
        else:
            raise KeyError(f"batch_from_numpy: no lane for column {c.name!r}")
        if len(d) != n:
            raise ValueError(f"batch_from_numpy: column {c.name!r} has {len(d)} rows, not {n}")
        v = (valid or {}).get(c.name)
        v = np.ones(n, dtype=bool) if v is None else np.asarray(v, dtype=bool)
        data.append(d)
        valids.append(v)
    return ColumnBatch(table, handles, data, valids, version=0)


def run_query(dag: DAGRequest, batch: ColumnBatch, device="cuda",
              engine: TorchEngine | None = None) -> Chunk:
    """Answer one pushed-down query over one region batch on `device`."""
    engine = engine or TorchEngine(device)
    partial = engine.execute(dag, batch)
    if dag.topn is not None:
        with engine.phase("finalize"):
            return top_n(partial, dag.topn.by, dag.topn.n)
    if dag.agg is None:
        return partial
    out_fts = [g.ret_type for g in dag.agg.group_by] + [a.ret_type for a in dag.agg.aggs]
    with engine.phase("finalize"):
        final = merge_partials([partial], dag.agg.group_by, dag.agg.aggs, out_fts)
        return order_by_keys(final, dag.agg.group_by)


def run_window(scan_dag: DAGRequest, spec, batch: ColumnBatch, device="cuda",
               engine: TorchEngine | None = None, mode: str = "tpu", timer=None) -> Chunk:
    """One window spec (part_by, order_by, funcs, out_fts) over the rows
    `scan_dag` reads from one region batch. `timer` (a
    torchenv.PhaseTimer) takes the scan / prep / h2d / sort / window /
    pack / d2h / finalize spans."""
    part_by, order_by, funcs, out_fts = spec
    engine = engine or TorchEngine(device)
    with timer.phase("scan") if timer is not None else nullcontext():
        chunk = engine.execute(scan_dag, batch)
    prov = None
    if scan_dag.agg is None and scan_dag.topn is None and scan_dag.limit is None:
        # the same rows every run: a plain scan of an unchanged batch
        digest = repr((part_by, order_by, [(f.name, f.args, f.frame) for f in funcs], scan_dag.digest()))
        prov = (batch.table.id, batch.version, batch.uid, hashlib.sha256(digest.encode()).hexdigest()[:16])
    w = WindowExec(chunk, part_by, order_by, funcs, out_fts, engine=mode, device=engine.device,
                   provenance=prov, phase=timer.phase if timer is not None else None)
    return w.next()


def run_mpp(mplan: MPPPlan, tables: dict, device="cuda", engine: MPPEngine | None = None,
            timer=None, variables: dict | None = None, mesh=None) -> Chunk:
    """Answer one MPP query: `tables` maps each table name to its columns
    ({column name: numpy lane}); `mesh` (parallel/mesh.make_mesh) runs the
    plan over its ranks, one rank on `device` without one. `timer` (a
    torchenv.PhaseTimer) takes rank 0's scan / exchange / join (lut_join,
    sort_join) / aggregation (run_agg and topk, rowpos_agg, seg_reduce,
    dense_agg, collectives) spans and the d2h / finalize spans, and
    host_agg where the host aggregates the joined rows; the engine's
    `last_host_s` holds the host-clock seconds of its host analysis and
    uploads."""
    engine = engine or MPPEngine(device)
    engine.timer = timer
    scans = mpp_gather.scan_datas(mplan, tables, engine)
    partial = mpp_gather.gather(mplan, scans, engine, variables, mesh)
    with engine._phase("finalize"):
        return mpp_gather.finish(mplan, mplan.root_step, partial)


def _no_subquery(select):
    from .errors import NotPortedError

    raise NotPortedError("executor/executors.py build_executor",
                         "a subquery evaluated at plan time runs through the executors (ROADMAP Queue 1, item 4.3)")


def plan_select(sql_or_stmt, infoschema, db: str, stats=None, variables: dict | None = None, run_subquery=None):
    """The optimized logical plan of one SELECT (module doc; ref:
    Session.plan_select and Session._builder, session.py:1679-1690,
    :1823-1828)."""
    from .parser import parse_one
    from .planner.builder import PlanBuilder
    from .planner.optimizer import optimize

    variables = variables if variables is not None else {}
    stmt = parse_one(sql_or_stmt) if isinstance(sql_or_stmt, str) else sql_or_stmt
    # the statement's optimizer hints, as Session.run_select hands them on
    # (`_effective_hints`; SQL bindings come with the Session)
    builder = PlanBuilder(infoschema, db, run_subquery=run_subquery or _no_subquery,
                          context_info={"vars": variables}, hints=list(getattr(stmt, "hints", []) or []))
    plan = builder.build_select(stmt)
    return optimize(plan, stats, variables)


def mpp_plan(plan, variables: dict | None = None, engine: MPPEngine | None = None) -> MPPPlan | None:
    """The MPPPlan of an optimized plan (ref: the executor tree of
    Session.run_select over it): the Aggregation or Join below the host
    operators sliced, the fused ORDER BY <sum/count> LIMIT k attached where
    the reference's `_build_limit` attaches it (executors.py:362-395), and
    the host operators above the cut as its root_step. None where the
    reference runs no MPP gather at the cut."""
    above: list = []
    node = plan
    while not isinstance(node, (Aggregation, Join)):
        if not isinstance(node, (Limit, Sort, Projection, Selection)):
            return None
        above.append(node)
        node = node.children[0]
    mplan = mpp_gather.try_build_mpp(node, variables, engine)
    if mplan is None:
        if isinstance(node, Aggregation):
            # the reference aggregates on the host and tries the join below
            # alone (its decline counted there); the port has no host
            # aggregation above a gather yet, so this is no cut it runs
            child = node.children[0]
            while isinstance(child, (Projection, Selection)):
                child = child.children[0]
            if isinstance(child, Join):
                mpp_gather.try_build_mpp(child, variables, engine)
        return None
    for lim, srt in zip(above, above[1:]):
        if isinstance(lim, Limit) and isinstance(srt, Sort):
            spec = _mpp_topn_spec(srt, srt.children[0])
            if spec is not None and mplan.agg is spec[2]:
                mplan.topn = (spec[0], spec[1], lim.count + lim.offset)
    width = len(mplan.agg.out_cols if mplan.agg is not None else mplan.out_cols)
    mplan.root_step = mpp_gather.root_step_above(above, width)
    return mplan


def run_many(pairs: list, device="cuda", engine: TorchEngine | None = None) -> list[Chunk]:
    """Partial chunks of many (DAG, batch) cop tasks, run as launch groups
    on one device lane (module doc)."""
    engine = engine or TorchEngine(device)
    return engine.execute_many(list(pairs))


def concurrent(fn, pairs: list):
    """fn(dag, batch) for every pair from one thread each, released
    together through a barrier (tools/bench_sched.py:_concurrent) →
    (results, seconds per task). A thread's error is raised after every
    thread has ended."""
    n = len(pairs)
    results: list = [None] * n
    lat = [0.0] * n
    errors: list = []
    barrier = threading.Barrier(n) if n else None

    def worker(i, dag, batch):
        try:
            barrier.wait()
            t0 = time.perf_counter()
            results[i] = fn(dag, batch)
            lat[i] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i, dag, batch)) for i, (dag, batch) in enumerate(pairs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results, lat


def run_burst(pairs: list, device="cuda", engine: TorchEngine | None = None,
              batcher: LaunchBatcher | None = None):
    """The tasks submitted at once from one thread each through the launch
    batcher → (partial chunks, per-task seconds): concurrent compatible
    tasks coalesce into launch groups of one lane."""
    engine = engine or TorchEngine(device)
    batcher = batcher or LaunchBatcher()
    return concurrent(lambda dag, batch: batcher.execute(engine, dag, batch), pairs)


def entry(device="cuda"):
    """(step, example): M1 as a function of Q1's eight lanes, and those
    lanes at 4096 rows on `device` (ref: __graft_entry__.entry)."""
    dev = resolve_device(device)
    spec, args = build_q1_arrays(4096, n_shards=1)

    def step(qty, price, disc, tax, rf, ls, ship, row_valid):
        return q1_local_kernel(spec, qty, price, disc, tax, rf, ls, ship, row_valid)

    return step, tuple(torch.from_numpy(a).to(dev) for a in args)


def _dryrun(n: int, rank: int, dev: torch.device, columns=None, group=None) -> dict:
    """Stages 1 and 2 of the dryrun on this rank (module doc)."""
    spec, args = build_q1_arrays(n * 256, n_shards=n) if columns is None else q1_arrays(columns, n)
    per = len(args[0]) // n
    shard = tuple(torch.from_numpy(np.ascontiguousarray(a[rank * per:(rank + 1) * per])).to(dev) for a in args)
    # stage 1: data-parallel fused scan / filter / partial aggregation + the exact merge
    parts = distributed_q1_step(spec, group)(*shard)
    got = torch.stack(parts).cpu().numpy()
    if got[0].sum() <= 0:
        raise AssertionError("distributed Q1 produced no rows")
    want = q1_exact(spec, args)
    if not np.array_equal(got, want):
        raise AssertionError(f"dryrun_multichip({n}): distributed Q1 partials differ from the recompute")
    # stage 2: MPP-style hash exchange; l_quantity stands in for the key
    keys, payload, valid = shard[0], shard[1], shard[7]
    rk, rp, rv, dropped = hash_repartition(n, group=group)(keys, payload, valid)
    if int(dropped) != 0:
        raise AssertionError(f"dryrun_multichip({n}): the exchange dropped {int(dropped)} rows")
    if not bool((torch.remainder(rk[rv], n) == rank).all()):
        raise AssertionError(f"dryrun_multichip({n}): a key landed off its owner")
    totals = torch.stack([payload[valid].sum(), rp[rv].sum()])
    if n > 1:
        import torch.distributed as dist

        dist.all_reduce(totals, group=group)
    before, after = (int(x) for x in totals.cpu())
    if before != after:
        raise AssertionError(f"dryrun_multichip({n}): exchange sum {after} != {before}")
    if rank == 0:
        print(f"dryrun_multichip({n}): ok — counts={got[0].tolist()}, exchange preserved {after}", flush=True)
    return {"rows": int(len(args[0])), "counts": got[0].tolist(), "exchange_total": after, "dropped": int(dropped),
            "spec": spec, "lanes": shard}


def _dryrun_rank(n: int, rank: int, port: int) -> None:
    """One gloo rank of dryrun_multichip(n) on the CPU."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n, rank=rank)
    try:
        _dryrun(n, rank, torch.device("cpu"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


Q3_DRYRUN_ROWS = 20_000  # the reference's stage 3 (setup_tpch(s, 20_000))


def _dryrun_q3(n: int, device) -> int:
    """Stage 3: TPC-H Q3 over an n-rank mesh on `device` against one
    device (ref: __graft_entry__.py:124-143) → the answer's row count."""
    from .models import tpch

    li, orders, cust = tpch.generated_columns(Q3_DRYRUN_ROWS, 42)
    tables = {"lineitem": li, "orders": orders, "customer": cust}
    want = run_mpp(tpch.q3_mpp_plan(), tables, device=device).to_pylist()
    mesh = make_mesh(n, device)
    try:
        got = run_mpp(tpch.q3_mpp_plan(), tables, device=device, mesh=mesh).to_pylist()
    finally:
        mesh.close()
    if not want or got != want:
        raise AssertionError(f"dryrun_multichip({n}): Q3 over {n} ranks differs from one device\n"
                             f"mesh: {got[:3]}\none:  {want[:3]}")
    print(f"dryrun_multichip({n}): TPC-H Q3 over a {n}-rank mesh ok — {len(got)} rows, equal to one device",
          flush=True)
    return len(got)


def dryrun_multichip(n_devices: int, device="cuda", columns=None, timeout: float = 600.0):
    """The distributed dryrun over n ranks (module doc). → rank 0's
    summary for n = 1 (with stage 3's row count, "q3_rows"); None for
    n > 1 (the ranks print and check)."""
    if n_devices == 1:
        res = _dryrun(1, 0, resolve_device(device), columns)
        res["q3_rows"] = _dryrun_q3(1, device)
        return res
    print(f"dryrun_multichip({n_devices}): {n_devices} gloo processes on the CPU, plain versions of M1 and M3",
          flush=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import sys; sys.path.insert(0, {root!r}); from tidb_tpu_torch.entry import "
                               f"_dryrun_rank; _dryrun_rank({n_devices}, {rank}, {port})"], cwd=root, env=env)
             for rank in range(n_devices)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks exited {rcs}")
    _dryrun_q3(n_devices, device)
    return None
