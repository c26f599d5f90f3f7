"""The planner (copy of tidb_tpu/planner/): logical plan nodes, the AST →
plan builder, the rule-based optimizer, key ranges and MPP fragment
slicing."""

from .plans import (
    LogicalPlan,
    DataSource,
    Selection,
    Projection,
    Aggregation,
    Join,
    Sort,
    Limit,
    Dual,
    SetOp,
    PlanCol,
)
from .builder import PlanBuilder
from .optimizer import optimize
