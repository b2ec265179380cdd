"""Port parity for the applies of the bfloat16, int32, uint32 and int64
value plans: ``spmv_plan`` and ``SparseOperator.from_matrix(...,
device="cpu") @ x`` on every plan family (DIA, Hybrid, SELL window,
resident, deep and stream, Chunk, Packed, Cached, CooTail) against the
JAX package's apply of its own plan (Pallas in interpret mode, one 8-tile
group a grid step) and against the exact product.

y has the reference's type: float32 for bfloat16 (1e-5 of max(1, |y|)
from JAX and from float64 over the bfloat16-rounded values), int32 and
uint32 exactly equal to JAX and to the int64 product wrapped mod 2^32
(int64 plans run as int32), under plus_times and, where the family takes
it, max_times.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu.formats import cached as jcached
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import operator as joperator
from spmv_vector_cache_tpu.ops import semiring as jsr
from spmv_vector_cache_tpu_torch.formats import cached as pcached
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.ops import semiring as psr
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_dtypes import (KINDS, check_y, jax_y, scircuit_small,
                                     typed, typed_x, zipf_small)
from tests.test_torch_packed import mac_econ_small
from tests.test_torch_plan import banded, both, hybrid, shuffled_band

#: family -> (matrix, the plan type auto_plan gives)
FAMILIES = {
    "dia": (lambda: banded(4096, list(range(-13, 14)), seed=1), "DiaPlan"),
    "hybrid": (lambda: hybrid(32768, seed=2), "HybridPlan"),
    "window": (lambda: shuffled_band(4096, seed=3), "SellPlan"),
    "packed": (lambda: mac_econ_small(20000), "PackedPlan"),
    "chunk": (scircuit_small, "ChunkPlan"),
    "cached": (zipf_small, "CachedPlan"),
}


def _apply(plan, x, **kw):
    return psell.spmv_plan(pplan.place(plan, "cpu"), torch.from_numpy(x),
                           **kw)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plan_apply_matches_jax(kind, family):
    make, name = FAMILIES[family]
    m = typed(make(), kind)
    ja, pa = both(m)
    x = typed_x(kind, m.shape[1])
    jp = jplan.auto_plan(ja, value_dtype=KINDS[kind])
    pp = pplan.auto_plan(pa, value_dtype=KINDS[kind])
    assert type(pp).__name__ == type(jp).__name__ == name
    check_y(_apply(pp, x), jax_y(jp, x), m, x, kind)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_coo_tail_apply_matches_jax(kind):
    m = typed(sp.random(2000, 30000, density=3e-4, random_state=5,
                        format="csr"), kind)
    ja, pa = both(m)
    x = typed_x(kind, m.shape[1])
    jp = jcached.coo_tail_from_csr(ja, KINDS[kind])
    check_y(_apply(pcached.coo_tail_from_csr(pa, KINDS[kind]), x),
            jax_y(jp, x), m, x, kind)


def _windowless():
    """Random columns over 8,000 (63 blocks, under the resident cap): a
    windowless SellPlan that every global-column strategy runs."""
    return sp.random(2048, 8000, density=0.004, random_state=3, format="csr")


#: the SELL strategies and the matrices they run
STRATEGIES = {"window": lambda: shuffled_band(2048, seed=3),
              "resident": _windowless, "deep": _windowless,
              "stream": _windowless}


@pytest.mark.parametrize("semiring,strategy", [
    (s, t) for s in ("plus_times", "max_times") for t in sorted(STRATEGIES)]
    + [("or_and", "window"), ("or_and", "deep")])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sell_strategies_match_jax(kind, strategy, semiring):
    nonneg = semiring != "plus_times"
    m = typed(STRATEGIES[strategy](), kind, nonneg=nonneg)
    x = typed_x(kind, m.shape[1], nonneg=nonneg)
    if semiring == "or_and":
        m.data = (m.data > 0.5).astype(np.float64)
        x = (x > 0.5).astype(x.dtype)
    ja, pa = both(m)
    pad = float(jsr.get(semiring).zero)
    jp = jplan.build_sell_plan(ja, value_dtype=KINDS[kind], pad_value=pad)
    pp = pplan.build_sell_plan(pa, value_dtype=KINDS[kind], pad_value=pad)
    assert (pp.stats.window_blocks > 0) == (strategy == "window")
    y = _apply(pp, x, semiring=semiring, strategy=strategy)
    want = jax_y(jp, x, semiring, strategy)
    if semiring == "or_and":
        assert y.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(y.numpy(), want)
        assert set(np.unique(want)) <= {0, 1}
    else:
        check_y(y, want, m, x, kind, semiring)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cached_max_times_matches_jax(kind):
    m = typed(zipf_small(), kind, nonneg=True)
    x = typed_x(kind, m.shape[1], nonneg=True)
    ja, pa = both(m)
    jp = jplan.auto_plan(ja, value_dtype=KINDS[kind], semiring="max_times")
    pp = pplan.auto_plan(pa, value_dtype=KINDS[kind], semiring="max_times")
    assert isinstance(pp, pcached.CachedPlan)
    check_y(_apply(pp, x, semiring="max_times"),
            jax_y(jp, x, "max_times"), m, x, kind, "max_times")


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_operator_matches_jax(kind, family):
    # SparseOperator.from_matrix(value_dtype=...) @ x, against the JAX
    # operator's plan applied by the JAX package
    make, name = FAMILIES[family]
    m = typed(make(), kind, seed=7)
    ja, pa = both(m)
    x = typed_x(kind, m.shape[1], seed=8)
    op = SparseOperator.from_matrix(pa, value_dtype=KINDS[kind],
                                    device="cpu")
    jop = joperator.SparseOperator.from_matrix(ja, value_dtype=KINDS[kind])
    assert type(op.plan).__name__ == type(jop.plan).__name__ == name
    assert op.strategy == jop.strategy
    check_y(op @ x, jax_y(jop.plan, x), m, x, kind)
    # an x of another type is cast to the plan's, as the reference casts it
    if kind != "bf16":
        y = op @ x.astype(np.float64)
        assert y.dtype == (op @ x).dtype
        np.testing.assert_array_equal(y.numpy(), (op @ x).numpy())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_semiring_epilogues_in_the_value_type(kind):
    # the segment reduce, the lane fold's add and the split-slice init of
    # each type: uint32 through int32 (plus_times) or int64 (max) and
    # back, int32 max's empty segment INT_MIN, uint32's 0
    dtype = {"bf16": torch.float32, "i32": torch.int32, "u32": torch.uint32,
             "i64": torch.int32}[kind]
    v = torch.tensor([3, 4294967295 if kind == "u32" else -1, 7, 2])
    v = v.to(torch.int64).to(dtype) if kind == "u32" else v.to(dtype)
    ids = torch.tensor([0, 0, 2, 2])
    s = psr.PLUS_TIMES.segment_reduce(v, ids, 3)
    assert s.dtype == dtype
    want = [2, 0, 9] if kind != "u32" else [2, 0, 9]
    assert s.to(torch.int64).tolist() == want
    mx = psr.MAX_TIMES.segment_reduce(v, ids, 3)
    assert mx.dtype == dtype
    empty = {"bf16": float("-inf"), "i32": -2 ** 31, "i64": -2 ** 31,
             "u32": 0}[kind]
    top = 4294967295 if kind == "u32" else 3
    assert mx.to(torch.float64).tolist() == [top, empty, 7]
    assert psr.init_value("max_times", dtype) == empty
    both_ways = psr.MAX_TIMES.combine(v, psr.take(v, torch.arange(3, -1,
                                                                 -1)))
    assert both_ways.dtype == dtype
    plain = [3, top, 7, 2] if kind == "u32" else [3, -1, 7, 2]
    assert both_ways.to(torch.float64).tolist() == [
        max(a, b) for a, b in zip(plain, plain[::-1])]
