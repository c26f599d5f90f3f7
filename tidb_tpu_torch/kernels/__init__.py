"""Hand-written Hopper kernels of the port, their plain PyTorch versions
and launch counters.

  K1 decode_lane     (csrc/decode_lane.cu) ← tpu_engine.py:1169 _decode_lane
                                             (decode_lanes: a call's every
                                             coded lane in one launch)
  K2/K3 expr_eval    (csrc/expr_eval.cu)   ← tpu_engine.py:1021 _eval_device,
                                             :1044 _mask (+ the MPP scan stage,
                                             post-join conditions and aggregate
                                             arguments, P1); the program comes
                                             from expr/program.py
  K4 seg_agg         (csrc/seg_agg.cu)     ← tpu_engine.py:1287-1304 + :175-193
                                             + :1527-1617 _agg_partials_device
                                             (its bitwise ops: K5's recombination)
  K6 topk            (csrc/topk.cu)        ← tpu_engine.py:1759-1781 _lower_topn
  K7 topn_multi      (csrc/topn_multi.cu)  ← tpu_engine.py:1796-1835 _lower_topn_multi
                                             (a radix select; K8 orders its rows
                                             only past its ordering cap)
  K8 lex_sort_perm   (csrc/lex_sort.cu)    ← tpu_engine.py:195-208 lex_sort_perm
  K9 sort_groups     (csrc/sort_groups.cu) ← tpu_engine.py:1351-1400 _lower_agg_sorted
  W1 window          (csrc/window.cu)      ← executor/window_device.py:154-442
                                             _build_kernel.kernel (sorts with K8)
  W2 pack_flat       (csrc/pack_flat.cu)   ← jaxenv.py:104-138 pack_flat
  P3 lut_join        (csrc/lut_join.cu)    ← parallel/mpp.py:1516-1544 lut_join
  P4 sort_join       (csrc/sort_join.cu)   ← parallel/mpp.py:1546-1653 join_stage
                                             (non-LUT level) + :1451 pack_keys;
                                             sorts with K8
  P5 seg_reduce      (csrc/seg_reduce.cu)  ← parallel/mpp.py:1655-1786
                                             sorted_agg_stage (K8 sort, K6 picks;
                                             its local and final reduces over
                                             n_dev ranks)
  P6 rowpos_agg      (csrc/rowpos_agg.cu)  ← parallel/mpp.py:1788-1848
                                             rowpos_agg_stage (K4 scatter, K6
                                             picks; per block over n_dev ranks)
  P7 run_agg         (csrc/run_agg.cu)     ← parallel/mpp.py:1850-1913
                                             clustered_agg_stage (+ :1984
                                             _topk_score)
  P9 block_topk      (csrc/block_topk.cu)  ← parallel/mpp.py:2008-2045
                                             _block_topk (+ the result rows,
                                             :1914-1929)
  P8 dense_agg       (csrc/seg_agg.cu)     ← parallel/mpp.py:1960-1973 dense
                                             partials + :2048 _agg_partials
                                             (K4's kernel over its int32-wrap
                                             keys, into the packed rows)
  M1 q1_local        (csrc/q1_local.cu)    ← parallel/mesh.py:57 q1_local_kernel
  M3 hash_repartition (csrc/hash_repartition.cu) ← parallel/mesh.py:104
                                             hash_repartition (its local half;
                                             the all_to_all is torch.distributed)
  P2 exchange        (csrc/exchange.cu)    ← parallel/mpp.py:1465-1514
                                             exchange_all + :1451 pack_keys (the
                                             owner buckets; the all_to_all is the
                                             mesh's, parallel/mesh.py)
  K10 decode_lane_tasks (decode_lanes_tasks), expr_eval_tasks, seg_agg_tasks, topk_tasks,
      topn_multi_tasks, lex_sort_perm_tasks, sort_groups_tasks (task-grid
      modes in csrc/decode_lane.cu, csrc/expr_eval.cu, csrc/seg_agg.cu,
      csrc/topk.cu, csrc/topn_multi.cu, csrc/sort_groups.cu, and K8's
      task-leading key in csrc/lex_sort.cu; kernels/grouped.py)
                                           ← tpu_engine.py:1096-1134
                                             _vmapped_program + :1065-1094
                                             _narrow_args (a launch group's
                                             filter, direct- and sort-
                                             aggregation and TopN programs)

Each wrapper runs its plain version for CPU tensors only; on a CUDA
tensor it launches its kernel (built at first use, kernels/build.py) or
raises. `<wrapper>.launches` counts kernel launches (`seg_agg.bit_launches`
those of K4 that reduced a bitwise aggregate; `decode_lane.launches` and
`decode_lane_tasks.launches` those of K1's solo and task modes, made by
`decode_lanes` / `decode_lanes_tasks`).
"""

from .block_topk import block_topk, block_topk_ref
from .decode_lane import decode_lane, decode_lane_ref, decode_lanes
from .dense_agg import dense_agg, dense_agg_ref
from .exchange import exchange, exchange_ref
from .expr_eval import expr_eval, expr_eval_ref
from .grouped import (decode_lane_tasks, decode_lanes_tasks, expr_eval_tasks, lex_sort_perm_tasks, seg_agg_tasks, sort_groups_tasks,
                      topk_tasks, topn_multi_tasks)
from .hash_repartition import hash_repartition, hash_repartition_ref
from .lex_sort import SortOp, lex_sort_perm, lex_sort_perm_ref
from .lut_join import lut_join, lut_join_ref
from .pack_flat import pack_flat, pack_flat_ref
from .q1_local import q1_local, q1_local_ref
from .rowpos_agg import rowpos_agg, rowpos_agg_ref
from .run_agg import run_agg, run_agg_ref
from .seg_agg import SegKey, SegLane, seg_agg, seg_agg_ref
from .seg_reduce import seg_reduce, seg_reduce_ref
from .sort_join import sort_join, sort_join_ref
from .sort_groups import sort_groups, sort_groups_ref
from .topk import topk, topk_ref
from .topn_multi import topn_multi, topn_multi_ops_ref, topn_multi_ref
from .window import window, window_ref

WRAPPERS = {"decode_lane": decode_lane, "seg_agg": seg_agg, "topk": topk,
            "topn_multi": topn_multi, "lex_sort": lex_sort_perm, "sort_groups": sort_groups,
            "window": window, "pack_flat": pack_flat, "lut_join": lut_join, "run_agg": run_agg,
            "block_topk": block_topk, "sort_join": sort_join, "seg_reduce": seg_reduce,
            "rowpos_agg": rowpos_agg, "dense_agg": dense_agg, "expr_eval": expr_eval,
            "q1_local": q1_local, "hash_repartition": hash_repartition, "exchange": exchange,
            "decode_lane_tasks": decode_lane_tasks, "expr_eval_tasks": expr_eval_tasks,
            "seg_agg_tasks": seg_agg_tasks, "topk_tasks": topk_tasks, "topn_multi_tasks": topn_multi_tasks,
            "lex_sort_tasks": lex_sort_perm_tasks, "sort_groups_tasks": sort_groups_tasks}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0
    seg_agg.bit_launches = 0


def launches() -> dict[str, int]:
    """Launches per wrapper, and K4's bitwise ones as "seg_agg_bitwise"."""
    out = {name: w.launches for name, w in WRAPPERS.items()}
    out["seg_agg_bitwise"] = seg_agg.bit_launches
    return out
