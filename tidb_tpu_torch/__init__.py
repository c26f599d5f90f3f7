"""tidb_tpu_torch — the PyTorch/CUDA port of tidb_tpu for one NVIDIA H100.

The JAX package `tidb_tpu/` is the reference every module here is held
against; this package imports neither `jax` nor anything of `tidb_tpu`.
Ported so far: coprocessor pushdown of filters and direct-address GROUP BY
(TPC-H Q1/Q6), with hand-written CUDA kernels for lane decode and
segment aggregation (`kernels/`, `csrc/`). Entry points default to
`device="cuda"` and never fall back to the CPU on their own.
"""
