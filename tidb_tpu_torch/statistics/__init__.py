"""Statistics & CBO inputs (copy of tidb_tpu/statistics/__init__.py; ref: statistics/ — histogram.go, cmsketch.go,
fmsketch.go, selectivity.go, handle/)."""

from .histogram import Histogram
from .cmsketch import CMSketch, TopN
from .fmsketch import FMSketch
from .tablestats import ColumnStats, TableStats, build_table_stats, surrogate_lane
from .handle import StatsHandle
from .selectivity import estimate_conds, AccessEstimate

__all__ = [
    "Histogram", "CMSketch", "TopN", "FMSketch",
    "ColumnStats", "TableStats", "build_table_stats", "surrogate_lane",
    "StatsHandle", "estimate_conds", "AccessEstimate",
]
