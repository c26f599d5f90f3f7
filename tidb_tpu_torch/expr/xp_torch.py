"""The array namespace `eval_xp` receives on the port's device path.

The reference hands `jax.numpy` to every builtin kernel
(tidb_tpu/expr/expression.py ScalarFunc.eval_xp). Over torch three gaps
need bridging:

  * torch has no `power`: the namespace maps it to `torch.pow`;
  * tensors have no `.astype`: the port's kernels call `xp.astype(x, dt)`
    instead, which both namespaces provide;
  * CPU torch has no uint64 arithmetic ("add_stub" not implemented for
    'UInt64'). A BIGINT UNSIGNED lane therefore travels as a `U64`: an
    int64 tensor holding the uint64 bit pattern, with unsigned compares
    emulated by flipping the sign bit and an exactly rounded conversion to
    float64. The reference moves uint64 the same way in its packed outputs
    (tidb_tpu/copr/tpu_engine.py:1563-1565).

`U64.dtype` stringifies as "uint64", so `expression.numeric_common` picks
its "uint" / "int2" comparison domains exactly as it does for numpy and
jax lanes.
"""

from __future__ import annotations

import numpy as np
import torch

_I64_MIN = -(1 << 63)
_TWO32 = float(1 << 32)


class _U64Dtype:
    """Stand-in dtype for uint64 lanes: torch has no usable one on CPU."""

    def __str__(self):
        return "uint64"

    __repr__ = __str__


UINT64 = _U64Dtype()


def _bits_of(x):
    """int64 bit pattern of a U64, a tensor or a Python int."""
    if isinstance(x, U64):
        return x.bits
    if isinstance(x, int) and x > np.iinfo(np.int64).max:
        return x - (1 << 64)
    return x


class U64:
    """A BIGINT UNSIGNED lane: `bits` is an int64 tensor of uint64 bit
    patterns. Arithmetic wraps like uint64 (the same bits as int64 wrap);
    ordering compares are unsigned."""

    __slots__ = ("bits",)
    dtype = UINT64

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

    # unsigned order = signed order of the sign-flipped bit patterns
    def _ord(self, o):
        return self.bits ^ _I64_MIN, _bits_of(o) ^ _I64_MIN

    def __lt__(self, o):
        a, b = self._ord(o)
        return a < b

    def __le__(self, o):
        a, b = self._ord(o)
        return a <= b

    def __gt__(self, o):
        a, b = self._ord(o)
        return a > b

    def __ge__(self, o):
        a, b = self._ord(o)
        return a >= b

    def __eq__(self, o):
        return self.bits == _bits_of(o)

    def __ne__(self, o):
        return self.bits != _bits_of(o)

    __hash__ = None

    def __add__(self, o):
        return U64(self.bits + _bits_of(o))

    def __sub__(self, o):
        return U64(self.bits - _bits_of(o))

    def __mul__(self, o):
        return U64(self.bits * _bits_of(o))

    __radd__ = __add__
    __rmul__ = __mul__

    def __repr__(self):
        return f"U64({self.bits!r})"


def u64_to_float(bits: torch.Tensor) -> torch.Tensor:
    """uint64 bit patterns → float64, rounded once like numpy's cast:
    the high and low 32-bit halves are exact doubles, so only their sum
    rounds."""
    hi = ((bits >> 32) & 0xFFFFFFFF).to(torch.float64)
    lo = (bits & 0xFFFFFFFF).to(torch.float64)
    return hi * _TWO32 + lo


class _TorchXP:
    """The namespace itself: the names the slice's builtins use."""

    int64 = torch.int64
    int32 = torch.int32
    float64 = torch.float64
    bool_ = torch.bool
    uint64 = UINT64

    @staticmethod
    def astype(x, dtype):
        if isinstance(x, U64):
            if dtype is UINT64:
                return x
            if dtype == torch.float64:
                return u64_to_float(x.bits)
            return x.bits.to(dtype)
        if dtype is UINT64:
            return U64(x.to(torch.int64))
        return x.to(dtype)

    @staticmethod
    def asarray(v, dtype=None):
        if dtype is UINT64 or str(dtype) == "uint64":
            return U64(torch.tensor(_bits_of(int(v)), dtype=torch.int64))
        return torch.tensor(v, dtype=dtype)

    @staticmethod
    def where(cond, a, b):
        if isinstance(a, U64) or isinstance(b, U64):
            return U64(torch.where(cond, _bits_of(a), _bits_of(b)))
        return torch.where(cond, a, b)

    abs = staticmethod(torch.abs)
    power = staticmethod(torch.pow)
    trunc = staticmethod(torch.trunc)
    ones_like = staticmethod(torch.ones_like)
    zeros_like = staticmethod(torch.zeros_like)

    @staticmethod
    def full_like(x, v):
        return torch.full_like(x, v)


XP = _TorchXP()
