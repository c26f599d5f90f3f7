"""The root's final step of the port (executor/final_agg.py) on the CPU.

* `_exact_sum`: the vectorised int64 path and the Python-int loop give the
  same exact sums; past the float64 shadow guard (2^62 of magnitude per
  group) the loop takes over, and a total beyond int64 raises in the
  merge instead of wrapping.
* `top_n`: the partial rows in the reference's TopNExec order (its
  `_lex_argsort`: NULLs first ASC, last DESC, stable), first n kept.
"""

import numpy as np
import pytest

from tidb_tpu.copr.host_engine import _lex_argsort as ref_lex_argsort

from tidb_tpu_torch.chunk.chunk import Chunk, Column
from tidb_tpu_torch.executor import final_agg
from tidb_tpu_torch.expr.aggregation import AggDesc
from tidb_tpu_torch.expr.expression import Column as ExprCol
from tidb_tpu_torch.mysqltypes.field_type import ft_decimal, ft_longlong


@pytest.mark.parametrize("dtype", [np.int64, np.uint64])
def test_exact_sum_vectorised_equals_the_loop(dtype):
    rng = np.random.default_rng(1)
    n, G = 50_000, 997
    inv = rng.integers(0, G, n)
    hi = 10**12 if dtype == np.uint64 else 10**15
    data = rng.integers(0 if dtype == np.uint64 else -hi, hi, n).astype(dtype)
    valid = rng.random(n) < 0.9
    got = final_agg._exact_sum(inv, G, data, valid)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    assert got.tolist() == final_agg._exact_sum_loop(inv, G, data, valid)


def test_exact_sum_falls_back_to_python_ints_past_the_guard():
    big = (1 << 61) + 12345
    inv = np.array([0, 0, 0, 1, 1])
    data = np.array([big, big, -big, big, -big], dtype=np.int64)  # group 0's magnitudes pass 2^62
    valid = np.ones(5, bool)
    got = final_agg._exact_sum(inv, 2, data, valid)
    assert isinstance(got, list)
    assert got == [big, 0] == final_agg._exact_sum_loop(inv, 2, data, valid)


def test_merge_raises_when_the_exact_total_leaves_int64():
    big = (1 << 62) + 1
    ft = ft_decimal(15, 2)
    part = Chunk([Column(ft_longlong(), np.array([7, 7, 7], dtype=np.int64), np.ones(3, bool)),
                  Column(ft, np.array([big, big, big], dtype=np.int64), np.ones(3, bool))])
    key = ExprCol(0, ft_longlong(), "k")
    agg = AggDesc.make("sum", [ExprCol(1, ft, "x")])
    with pytest.raises(OverflowError, match="does not fit"):
        final_agg.merge_partials([part], [key], [agg], [ft_longlong(), agg.ret_type])
    ok = Chunk([c.slice(0, 1) for c in part.columns])
    out = final_agg.merge_partials([ok], [key], [agg], [ft_longlong(), agg.ret_type])
    assert out.columns[1].data.tolist() == [big]


@pytest.mark.parametrize("n", [1, 5, 40])
def test_top_n_is_the_reference_topn_order(n):
    rng = np.random.default_rng(n)
    rows = 40
    a = rng.integers(0, 4, rows)
    av = rng.random(rows) < 0.8
    b = rng.integers(-3, 3, rows)
    bv = rng.random(rows) < 0.8
    chunk = Chunk([Column(ft_longlong(), a, av), Column(ft_longlong(), b, bv)])
    by = [(ExprCol(0, ft_longlong(), "a"), True), (ExprCol(1, ft_longlong(), "b"), False)]
    got = final_agg.top_n(chunk, by, n)
    order = ref_lex_argsort([(a, av, True), (b, bv, False)], rows)[:n]
    assert got.columns[0].data.tolist() == a[order].tolist()
    assert got.columns[1].valid.tolist() == bv[order].tolist()
    assert got.num_rows == n
