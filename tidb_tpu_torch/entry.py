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
* `run_mpp(mplan, tables, device="cuda", variables=None)`: an MPP
  fragment plan (its join levels, LUT or sort-probe, and its aggregation
  in the mode the engine chooses, or the joined rows) over the numpy
  columns of its tables on `device`, then the steps above the gather
  (`mplan.root_step`: the final aggregate, HAVING, the projection and the
  TopN) → the result chunk. `variables` are session variables, such as
  `tidb_tpu_mpp_fused` ("ON" by default).
"""

from __future__ import annotations

import hashlib
from contextlib import nullcontext

import numpy as np

from .catalog.schema import TableInfo
from .chunk.chunk import Chunk, VARLEN, col_numpy_dtype
from .copr.dag import DAGRequest
from .copr.gpu_engine import TorchEngine
from .copr.tilecache import ColumnBatch
from .executor import mpp_gather
from .executor.final_agg import merge_partials, order_by_keys, top_n
from .executor.window import WindowExec
from .parallel.mpp import MPPEngine
from .planner.fragment import MPPPlan


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
            timer=None, variables: dict | None = None) -> Chunk:
    """Answer one MPP query: `tables` maps each table name to its columns
    ({column name: numpy lane}). `timer` (a torchenv.PhaseTimer) takes the
    scan / join (lut_join, sort_join) / aggregation (run_agg and topk,
    rowpos_agg, seg_reduce, dense_agg) / d2h / finalize spans, and
    host_agg where the host aggregates the joined rows; the engine's
    `last_host_s` holds the host-clock seconds of its host analysis and
    uploads."""
    engine = engine or MPPEngine(device)
    engine.timer = timer
    scans = mpp_gather.scan_datas(mplan, tables, engine)
    partial = mpp_gather.gather(mplan, scans, engine, variables)
    with engine._phase("finalize"):
        return mpp_gather.finish(mplan, mplan.root_step, partial)
