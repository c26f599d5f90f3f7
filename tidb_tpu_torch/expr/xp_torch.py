"""BIGINT UNSIGNED lanes on the port's device path.

CPU torch has no uint64 arithmetic ("add_stub" not implemented for
'UInt64'), so a BIGINT UNSIGNED lane travels as a `U64`: an int64 tensor
holding the uint64 bit patterns. The wrapper only marks the lane as
unsigned; the kernels that read it (the expression program's unsigned
compares and exactly rounded conversion to float64, K4's unsigned
min/max, the sorts, the window kernels, the packers) take its `bits`.
The reference moves uint64 the same way in its packed outputs
(tidb_tpu/copr/tpu_engine.py:1563-1565).

The module's name is the reference's: there `eval_xp` received an array
namespace per device. The port's device path compiles expressions
instead (expr/program.py), so only the lane marker is left here.
"""

from __future__ import annotations

import torch


class U64:
    """A BIGINT UNSIGNED lane: `bits` is an int64 tensor of uint64 bit
    patterns."""

    __slots__ = ("bits",)

    def __init__(self, bits: torch.Tensor):
        if bits.dtype != torch.int64:
            raise TypeError(f"U64 carries int64 bit patterns, got {bits.dtype}")
        self.bits = bits

    @property
    def ndim(self) -> int:
        return self.bits.ndim

    @property
    def shape(self):
        return self.bits.shape

    def reshape(self, *shape) -> "U64":
        return U64(self.bits.reshape(*shape))

    def __repr__(self):
        return f"U64({self.bits!r})"
