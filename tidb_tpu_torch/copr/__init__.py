"""Coprocessor pushdown: DAG IR, region batches, host and GPU engines."""
