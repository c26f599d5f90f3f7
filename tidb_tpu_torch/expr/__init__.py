"""Scalar expressions and aggregate descriptors of the port (copies of
tidb_tpu/expr, trimmed to the builtins the slice uses)."""

from .expression import Expression, Column, Constant, ScalarFunc, make_func, FUNCS
from . import builtins  # populate the registry
from .aggregation import AggDesc, AGG_FUNCS
