"""W2 pack_flat on the CPU: the port's buffer is the reference's word for
word (tidb_tpu/jaxenv.py:104 pack_flat), and torchenv.unpack_flat takes
it apart again. The CUDA kernel (csrc/pack_flat.cu) runs only on the card:
chip_smoke.py holds it to pack_flat_ref there."""

import numpy as np
import pytest
import torch

from tidb_tpu.jaxenv import jnp
from tidb_tpu.jaxenv import pack_flat as ref_pack_flat

from tidb_tpu_torch.expr.xp_torch import U64
from tidb_tpu_torch.kernels import pack_flat, pack_flat_ref
from tidb_tpu_torch.torchenv import unpack_flat


def _lane(kind: str, n: int, rng):
    """(numpy lane for the reference, the same lane for the port)."""
    if kind == "i64":
        a = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
        return a, torch.from_numpy(a)
    if kind == "f64":
        a = rng.standard_normal(n) * 1e6
        a[:: 7] = np.nan
        a[1:: 11] = -0.0
        a[2:: 13] = np.inf
        return a, torch.from_numpy(a)
    if kind == "f32":
        a = (rng.standard_normal(n) * 1e3).astype(np.float32)
        a[:: 5] = np.nan
        return a, torch.from_numpy(a)
    if kind == "u64":
        a = rng.integers(0, 1 << 63, n, dtype=np.int64).view(np.uint64) | np.uint64(1 << 63)
        a[:: 3] = np.uint64(5)
        return a, U64(torch.from_numpy(a.view(np.int64)))
    if kind == "i32":
        a = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
        return a, torch.from_numpy(a)
    a = rng.random(n) < 0.5
    return a, torch.from_numpy(a)


def _same_words(port: torch.Tensor, ref) -> None:
    got = port.numpy()
    want = np.asarray(ref)
    assert got.dtype == want.dtype == np.int64
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["i64", "f64", "f32", "u64", "i32", "bool"])
def test_each_kind_packs_as_the_reference(kind):
    rng = np.random.default_rng(3)
    ref, port = _lane(kind, 777, rng)
    _same_words(pack_flat([port]), ref_pack_flat([jnp.asarray(ref)]))
    assert pack_flat.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
def test_bool_lengths_pack_as_the_reference(n):
    rng = np.random.default_rng(n)
    ref, port = _lane("bool", n, rng)
    ones = np.ones(n, dtype=bool)
    _same_words(pack_flat([port, torch.from_numpy(ones)]),
                ref_pack_flat([jnp.asarray(ref), jnp.asarray(ones)]))


def test_a_window_shaped_output_round_trips():
    """Several lanes of mixed kinds and lengths, as a window spec ships
    them; unpack_flat gives back every lane bit for bit."""
    rng = np.random.default_rng(11)
    kinds = ["i64", "bool", "f64", "bool", "u64", "i64", "f32", "bool", "i32"]
    lanes = [_lane(k, 1024 + 37 * j, rng) for j, k in enumerate(kinds)]
    flat = pack_flat([p for _, p in lanes])
    _same_words(flat, ref_pack_flat([jnp.asarray(r) for r, _ in lanes]))
    back = unpack_flat(flat.numpy())
    assert len(back) == len(lanes)
    for (ref, _), got, kind in zip(lanes, back, kinds):
        want = ref.astype(np.float64) if kind == "f32" else ref.astype(np.int64) if kind == "i32" else ref
        assert got.dtype == want.dtype, kind
        if want.dtype == np.float64:
            assert np.array_equal(got.view(np.int64), want.view(np.int64)), kind
        else:
            assert np.array_equal(got, want), kind


def test_plain_version_is_what_the_wrapper_gives_on_the_cpu():
    rng = np.random.default_rng(5)
    lanes = [_lane(k, 300, rng)[1] for k in ("bool", "f64", "u64")]
    assert torch.equal(pack_flat(lanes), pack_flat_ref(lanes))


def test_unsupported_lanes_raise():
    with pytest.raises(TypeError):
        pack_flat([torch.zeros(4, dtype=torch.complex64)])
    with pytest.raises(ValueError):
        pack_flat([torch.zeros((2, 2), dtype=torch.int64)])
    with pytest.raises(ValueError):
        pack_flat([])
