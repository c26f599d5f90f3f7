"""Hand-written Hopper kernels of the port, their plain PyTorch versions
and launch counters.

  K1 decode_lane  (csrc/decode_lane.cu) ← tpu_engine.py:1169 _decode_lane
  K4 seg_agg      (csrc/seg_agg.cu)     ← tpu_engine.py:1287-1304 + :175-193
                                          + :1527-1617 _agg_partials_device

Each wrapper runs its plain version for CPU tensors only; on a CUDA
tensor it launches its kernel (built at first use, kernels/build.py) or
raises. `<wrapper>.launches` counts kernel launches.
"""

from .decode_lane import decode_lane, decode_lane_ref
from .seg_agg import SegKey, SegLane, seg_agg, seg_agg_ref

WRAPPERS = {"decode_lane": decode_lane, "seg_agg": seg_agg}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def launches() -> dict[str, int]:
    return {name: w.launches for name, w in WRAPPERS.items()}
