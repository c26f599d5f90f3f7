"""The port's kernels, held to the reference on the CPU.

K1: every lane codec goes through the reference's own encoder
(tidb_tpu/copr/tilecache.py) and decodes twice — through
TPUEngine._decode_lane under JAX and through the port's decode_lane_ref —
and the dense lanes must be bit-identical.

K4: the same masked rows, keys and value lanes go through the reference's
_seg_sum/_seg_min/_seg_max (and _agg_partials_device for whole aggregate
functions) and through the port's seg_agg_ref; integers, uint64 bit
patterns and codes must be bit-identical, floats within bench.py's
rtol 1e-9 / atol 1e-6 (summation order differs).

On the CPU each wrapper takes its plain version; the CUDA kernels are held
to these plain versions on the card by chip_smoke.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tidb_tpu.copr import tpu_engine as ref_engine
from tidb_tpu.copr.tilecache import encode_data_lane as ref_encode_data
from tidb_tpu.copr.tilecache import encode_valid_lane as ref_encode_valid
from tidb_tpu.copr.tilecache import pow2_rows
from tidb_tpu.expr.aggregation import AggDesc as RefAgg
from tidb_tpu.expr.expression import Column as RefCol
from tidb_tpu.jaxenv import jnp
from tidb_tpu.mysqltypes import field_type as ref_ft

from tidb_tpu_torch.copr import tilecache as port_tilecache
from tidb_tpu_torch.copr.gpu_engine import TorchEngine, _upload, _upload_payload
from tidb_tpu_torch.expr.aggregation import AggDesc as PortAgg
from tidb_tpu_torch.expr.expression import Column as PortCol
from tidb_tpu_torch.expr.program import evaluate
from tidb_tpu_torch.expr.xp_torch import U64
from tidb_tpu_torch.kernels import SegKey, SegLane, decode_lane, decode_lane_ref, seg_agg, seg_agg_ref
from tidb_tpu_torch.mysqltypes import field_type as port_ft

RTOL, ATOL = 1e-9, 1e-6
CPU = torch.device("cpu")


def _bits(a: np.ndarray) -> np.ndarray:
    """A lane's raw bits, for bit-identity whatever the dtype."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype == bool else a.view(f"u{a.dtype.itemsize}")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


# --- K1 decode_lane -----------------------------------------------------


def _lane(case: str, n: int, rng):
    """(data, valid, expected codec) for one codec case."""
    v = np.ones(n, dtype=bool)
    if case == "pack_u8":
        return rng.integers(1000, 1200, n), v, "pack"
    if case == "pack_u16":
        return rng.integers(-30000, 30000, n), v, "pack"
    if case == "pack_u32":
        return rng.integers(0, 3_000_000_000, n) - 10**11, v, "pack"
    if case == "pack_u64_lane":  # BIGINT UNSIGNED above 2^63: uint64 base
        return (np.uint64(1 << 63) + rng.integers(0, 200, n).astype(np.uint64)), v, "pack"
    if case == "pack_i32_codes":  # a dict-code lane (int32) packed again
        return rng.integers(0, 3, n).astype(np.int32), v, "pack"
    if case == "dict_int":
        return rng.choice(np.array([-10**15, 3, 7, 10**15]), n), v, "dict"
    if case == "dict_float":
        return rng.choice(np.round(rng.standard_normal(50), 3), n), v, "dict"
    if case == "dict_u64_lane":
        return rng.choice(np.array([1, 1 << 63, (1 << 64) - 1], dtype=np.uint64), n), v, "dict"
    if case == "rle_int":
        return np.repeat(rng.integers(-10**14, 10**14, 4), n // 4 + 1)[:n], v, "rle"
    if case == "rle_float_nulls":
        d = np.repeat(rng.standard_normal(3), n // 3 + 1)[:n]
        v = np.ones(n, dtype=bool)
        v[n // 5: n // 4] = False
        return d, v, "rle"
    if case == "dense_float":
        return rng.standard_normal(n), v, "dense"
    raise ValueError(case)


DECODE_CASES = ["pack_u8", "pack_u16", "pack_u32", "pack_u64_lane", "pack_i32_codes", "dict_int",
                "dict_float", "dict_u64_lane", "rle_int", "rle_float_nulls", "dense_float"]


def _ref_decode(payload, shape, n):
    rv = np.zeros(shape[0] * shape[1], dtype=bool)
    rv[:n] = True
    enc = {k: jnp.asarray(x) for k, x in payload.items()}
    return np.asarray(ref_engine.TPUEngine._decode_lane(enc, jnp.asarray(rv.reshape(shape))))


def _port_decode(payload, shape, n):
    rv = np.zeros(shape[0] * shape[1], dtype=bool)
    rv[:n] = True
    return _np(decode_lane(_upload_payload(payload, CPU), _upload(rv.reshape(shape), CPU)))


@pytest.mark.parametrize("n", [1000, 70_000])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_lane_matches_reference(case, n):
    rng = np.random.default_rng(7)
    d, v, want_codec = _lane(case, n, rng)
    shape = (1, pow2_rows(n)) if n <= 1 << 16 else ((n + (1 << 16) - 1) >> 16, 1 << 16)
    pay, sig = ref_encode_data(d, v, shape)
    assert sig[0] == want_codec, f"{case}: the encoder chose {sig}"
    # the port's own encoder makes the same choice with the same payload
    pay2, sig2 = port_tilecache.encode_data_lane(d, v, shape)
    assert sig2 == sig
    if pay is None:  # dense: the padded lane itself reaches the program
        lane = _upload(port_tilecache._pad2d(d, shape), CPU)
        assert decode_lane(lane, torch.ones(shape, dtype=torch.bool)) is lane
        return
    for k in pay:
        assert np.array_equal(np.asarray(pay[k]), np.asarray(pay2[k]))
    want = _ref_decode(pay, shape, n)
    got = _port_decode(pay, shape, n)
    assert got.shape == want.shape
    if want.dtype == np.uint64:
        want = want.view(np.int64)  # the port carries uint64 as int64 bit patterns
    assert got.dtype == want.dtype, case
    assert np.array_equal(_bits(got), _bits(want)), case


@pytest.mark.parametrize("kind", ["alias", "rle_few_runs", "dense_ragged"])
def test_decode_valid_lane_matches_reference(kind):
    n = 5000
    rng = np.random.default_rng(11)
    shape = (1, pow2_rows(n))
    v = {"alias": np.ones(n, dtype=bool),
         "rle_few_runs": np.repeat([True, False, True], [2000, 1000, 2000]),
         "dense_ragged": rng.random(n) < 0.5}[kind]
    pay, sig = ref_encode_valid(v, shape)
    assert port_tilecache.encode_valid_lane(v, shape)[1] == sig
    rv = np.zeros(shape[1], dtype=bool)
    rv[:n] = True
    rv_t = _upload(rv.reshape(shape), CPU)
    if pay is None:
        assert kind == "dense_ragged"
        lane = _upload(port_tilecache._pad2d(v, shape), CPU)
        assert decode_lane(lane, rv_t) is lane  # dense lanes pass through
        return
    want = _ref_decode(pay, shape, n)
    got = decode_lane(_upload_payload(pay, CPU), rv_t)
    if kind == "alias":
        assert got is rv_t  # the alias is row_valid itself, nothing decoded
    assert np.array_equal(_np(got), want)


def test_decode_rle_rows_past_last_run_read_the_last_entry():
    """jnp.repeat(total_repeat_length) clamps rows past the runs to the
    LAST entry (the encoder's zero pad run): decode the same way."""
    vals = np.array([5, 6, 9], dtype=np.int64)
    lens = np.array([2, 1, 0], dtype=np.int32)
    rv = np.ones((1, 8), dtype=bool)
    want = np.asarray(ref_engine.TPUEngine._decode_lane(
        {"rv": jnp.asarray(vals), "rl": jnp.asarray(lens)}, jnp.asarray(rv)))
    got = decode_lane_ref({"rv": torch.from_numpy(vals), "rl": torch.from_numpy(lens)}, torch.from_numpy(rv))
    assert np.array_equal(_np(got), want)
    assert want.tolist() == [[5, 5, 6, 9, 9, 9, 9, 9]]


# --- K4 seg_agg: the reductions ---------------------------------------------


def _seg_inputs(n, nseg, rng, all_masked=False, overflow=False):
    mask = np.zeros(n, dtype=bool) if all_masked else rng.random(n) < 0.8
    if nseg == 12:  # two NULL-able dict-code keys, domains 3 and 2 (Q1's shape)
        keys = [(rng.integers(0, 3, n).astype(np.int32), rng.random(n) < 0.95, 0, 3),
                (rng.integers(0, 2, n).astype(np.int32), np.ones(n, dtype=bool), 0, 2)]
    elif nseg == 1:
        keys = []
    else:
        keys = [(rng.integers(1000, 1000 + nseg - 1, n), np.ones(n, dtype=bool), 1000, nseg - 1)]
    valid = rng.random(n) < 0.9
    if overflow:  # every row near 2^62: per-segment sums wrap int64
        i64 = np.full(n, (1 << 62) + 12345, dtype=np.int64)
    else:
        i64 = rng.integers(-10**12, 10**12, n)
    u64 = rng.integers(0, 1 << 63, n).astype(np.uint64) | (rng.integers(0, 2, n).astype(np.uint64) << np.uint64(63))
    f64 = rng.standard_normal(n) * 1e3
    f64[::997] = np.nan
    codes = rng.integers(0, 40, n).astype(np.int32)
    return mask, keys, valid, i64, u64, f64, codes


def _ref_seg(mask, keys, nseg):
    code = jnp.zeros(mask.shape, dtype=jnp.int32)
    for d, v, lo, dom in keys:  # tpu_engine.py:1292-1298
        code = code * (dom + 1) + (jnp.asarray(d).astype(jnp.int32) - lo + 1) * jnp.asarray(v)
    return jnp.where(jnp.asarray(mask), code, nseg)


SEG_CASES = [
    {"nseg": 1}, {"nseg": 12}, {"nseg": 64}, {"nseg": 65}, {"nseg": 65536},
    {"nseg": 12, "all_masked": True}, {"nseg": 12, "overflow": True},
]


@pytest.mark.parametrize("case", SEG_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_seg_agg_reductions_match_reference(case):
    nseg = case["nseg"]
    n = 6000
    rng = np.random.default_rng(nseg)
    mask, keys, valid, i64, u64, f64, codes = _seg_inputs(
        n, nseg, rng, case.get("all_masked", False), case.get("overflow", False))
    seg = _ref_seg(mask, keys, nseg)
    ok = jnp.asarray(mask & valid)
    s, f64m = ref_engine._seg_sum, np.nan_to_num(f64)
    i64_info, i32_info, u64_info = np.iinfo(np.int64), np.iinfo(np.int32), np.iinfo(np.uint64)
    J = jnp.asarray
    want_i = [
        s(J(mask).astype(jnp.int64), seg, nseg),
        s(ok.astype(jnp.int64), seg, nseg),
        s(jnp.where(ok, J(i64), 0), seg, nseg),
        ref_engine._seg_min(jnp.where(ok, J(i64), i64_info.max), seg, nseg, J(i64_info.max)),
        ref_engine._seg_max(jnp.where(J(mask), J(i64), i64_info.min), seg, nseg, J(i64_info.min)),
        ref_engine._seg_min(jnp.where(ok, J(u64), J(u64_info.max, jnp.uint64)), seg, nseg,
                            J(u64_info.max, jnp.uint64)),
        ref_engine._seg_max(jnp.where(ok, J(u64), J(0, jnp.uint64)), seg, nseg, J(0, jnp.uint64)),
        ref_engine._seg_min(jnp.where(ok, J(codes), i32_info.max), seg, nseg, J(i32_info.max, jnp.int32)),
        ref_engine._seg_min(jnp.where(ok, jnp.arange(n), n), seg, nseg, J(n)),
    ]
    want_f = [
        s(jnp.where(ok, J(f64m), 0.0), seg, nseg),
        ref_engine._seg_min(jnp.where(ok, J(f64), jnp.inf), seg, nseg, J(jnp.inf)),
        ref_engine._seg_max(jnp.where(J(mask), J(f64), -jnp.inf), seg, nseg, J(-jnp.inf)),
    ]
    T = torch.from_numpy
    tv = T(valid)
    lanes = [
        SegLane("count"), SegLane("count", valid=tv),
        SegLane("sum_i64", T(i64), tv),
        SegLane("min_i64", T(i64), tv, int(i64_info.max)),
        SegLane("max_i64", T(i64), None, int(i64_info.min)),
        SegLane("min_u64", T(u64.view(np.int64)), tv, int(u64_info.max)),
        SegLane("max_u64", T(u64.view(np.int64)), tv, 0),
        SegLane("min_i64", T(codes.astype(np.int64)), tv, int(i32_info.max)),
        # the reference's segment_min path (nseg > 64) leaves empty
        # segments at the dtype's max, not at the dense path's fill n
        SegLane("first_row", None, tv, n if nseg <= 64 else int(i64_info.max)),
        SegLane("sum_f64", T(f64m), tv),
        SegLane("min_f64", T(f64), tv, float("inf")),
        SegLane("max_f64", T(f64), None, float("-inf")),
    ]
    skeys = [SegKey(T(d), T(v), lo, dom) for d, v, lo, dom in keys]
    gi, gf = seg_agg(T(mask), skeys, lanes, nseg)  # CPU tensors: the plain version
    assert gi.shape == (len(want_i), nseg) and gf.shape == (len(want_f), nseg)
    for k, w in enumerate(want_i):
        w = np.asarray(w)
        w = w.view(np.int64) if w.dtype == np.uint64 else w.astype(np.int64)
        assert np.array_equal(_np(gi[k]), w), f"int row {k}"
    for k, w in enumerate(want_f):
        assert np.allclose(_np(gf[k]), np.asarray(w), rtol=RTOL, atol=ATOL, equal_nan=True), f"float row {k}"
    if case.get("overflow"):
        assert (np.asarray(want_i[2]) < 0).any(), "the forced overflow must wrap"
    if case.get("all_masked"):
        assert not _np(gi[0]).any()


def test_seg_agg_wrapper_uses_plain_version_only_on_cpu():
    mask = torch.ones(4, dtype=torch.bool)
    lanes = [SegLane("sum_i64", torch.arange(4), None)]
    assert seg_agg(mask, [], lanes, 1)[0].tolist() == [[6]]
    assert seg_agg.launches == 0 and decode_lane.launches == 0  # no kernel ran here
    with pytest.raises(TypeError):  # a float lane under an int op is refused
        seg_agg_ref(mask, [], [SegLane("sum_i64", torch.ones(4, dtype=torch.float64))], 1)


# --- K4: whole aggregate functions (_agg_partials_device) ----------------


AGG_CASES = [
    ("count", "int"), ("sum", "int"), ("sum", "dec"), ("sum", "float"), ("sum", "uint"),
    ("avg", "dec"), ("min", "int"), ("max", "float"), ("min", "uint"), ("max", "uint"),
    ("min", "codes"), ("max", "codes"), ("first_row", "int"),
    ("var_pop", "dec"), ("stddev_samp", "dec"), ("var_samp", "float"), ("stddev_pop", "float"),
    ("bit_and", "int"), ("bit_or", "dec"), ("bit_xor", "int"), ("bit_and", "float"),
]


def _arg(kind, n, rng):
    if kind == "int":
        return rng.integers(-10**6, 10**6, n), ref_ft.ft_longlong(), port_ft.ft_longlong()
    if kind == "dec":
        return rng.integers(-10**9, 10**9, n), ref_ft.ft_decimal(15, 2), port_ft.ft_decimal(15, 2)
    if kind == "float":
        return rng.standard_normal(n) * 100, ref_ft.ft_double(), port_ft.ft_double()
    if kind == "uint":
        d = rng.integers(0, 1 << 63, n).astype(np.uint64) | (rng.integers(0, 2, n).astype(np.uint64) << np.uint64(63))
        return d, ref_ft.ft_longlong(unsigned=True), port_ft.ft_longlong(unsigned=True)
    return rng.integers(0, 30, n).astype(np.int32), ref_ft.ft_longlong(), port_ft.ft_longlong()


@pytest.mark.parametrize("name,kind", AGG_CASES, ids=lambda x: x)
def test_agg_partials_match_reference(name, kind):
    n, nseg = 4000, 12
    rng = np.random.default_rng(5)
    d, rft, pft = _arg(kind, n, rng)
    v = rng.random(n) < 0.85
    mask = rng.random(n) < 0.8
    keys = [(rng.integers(0, 3, n).astype(np.int32), np.ones(n, dtype=bool), 0, 3),
            (rng.integers(0, 2, n).astype(np.int32), rng.random(n) < 0.9, 0, 2)]
    args_r = [] if name == "count" else [RefCol(0, rft, "x")]
    args_p = [] if name == "count" else [PortCol(0, pft, "x")]
    ra, pa = RefAgg.make(name, args_r), PortAgg.make(name, args_p)
    ra._device_args = args_r
    want = ref_engine.TPUEngine()._agg_partials_device(
        ra, {0: (jnp.asarray(d), jnp.asarray(v))}, jnp.asarray(mask), _ref_seg(mask, keys, nseg), nseg)

    eng = TorchEngine("cpu")
    pd = torch.from_numpy(d.view(np.int64) if d.dtype == np.uint64 else d)
    lane = U64(pd) if kind == "uint" else pd
    dev = SimpleNamespace(padded=n, row_valid=None)
    specs = [eng._agg_spec(pa, args_p)]
    # the argument lanes from the expression program, as the engine builds them
    _, vals = evaluate(eng.programs, [], [s for s in specs if s is not None], {0: (lane, torch.from_numpy(v))},
                       None, n, mask=False)
    lanes = eng._agg_lanes([pa], specs, vals, dev, nseg)
    T = torch.from_numpy
    i_mat, f_mat = seg_agg(T(mask), [SegKey(T(a), T(b), lo, dom) for a, b, lo, dom in keys], lanes, nseg)
    layout = eng._layout(lanes)
    assert len(layout) == len(want)
    for (t, k), w in zip(layout, want):
        w = np.asarray(w)
        if t == "f":
            assert w.dtype.kind == "f"
            assert np.allclose(_np(f_mat[k]), w, rtol=RTOL, atol=ATOL, equal_nan=True)
        else:
            assert w.dtype.kind in "iub"
            w = w.view(np.int64) if w.dtype == np.uint64 else w.astype(np.int64)
            assert np.array_equal(_np(i_mat[k]), w)
