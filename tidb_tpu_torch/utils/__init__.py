"""Failpoints, metrics, tracing, the device timeline and memory trackers
(copies of the reference's tidb_tpu/utils modules the launch batcher and
the engine call)."""
