"""Columnar batches (copy of tidb_tpu/chunk)."""
