"""Port parity for the slice as a whole:
``SparseOperator.from_matrix(a, device="cpu") @ x`` against the JAX
package's ``SparseOperator.from_matrix(a) @ x`` and against the float64
host loop, for a DIA, a Hybrid and a SELL-window matrix.

The plan type, the strategy and every stat must be equal (bar the
plan-build seconds); y must match JAX to rtol = atol = 2e-5 (float32) and
the host loop below 1e-4 relative (bench.py's gate).
"""

import numpy as np
import pytest
import torch

from spmv_vector_cache_tpu.ops import operator as joperator
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops import spmv_pallas as jsell
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_plan import (assert_plans_equal, banded, both, hybrid,
                                   shuffled_band)

CASES = {
    "dia": (lambda: banded(4096, list(range(-13, 14)), seed=1), "DiaPlan"),
    "hybrid": (lambda: hybrid(32768, seed=2), "HybridPlan"),
    "sell_window": (lambda: shuffled_band(4096, seed=3), "SellPlan"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_matches_jax(case):
    make, kind = CASES[case]
    ja, pa = both(make())
    x = np.random.default_rng(4).standard_normal(ja.shape[1]).astype(
        np.float32)
    jop = joperator.SparseOperator.from_matrix(ja)
    op = SparseOperator.from_matrix(pa, device="cpu")
    assert type(op.plan).__name__ == type(jop.plan).__name__ == kind
    assert op.strategy == jop.strategy
    assert_plans_equal(op.plan, jop.plan)
    drop = ("plan_seconds", "detect_seconds", "build_seconds",
            "place_seconds", "discarded_build_seconds")
    want_stats = {k: v for k, v in jop.stats.as_dict().items()
                  if k not in drop}
    got_stats = {k: v for k, v in op.stats.as_dict().items()
                 if k not in drop}
    assert got_stats == want_stats

    y = op @ x
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    if case == "hybrid":
        # the reference operator hands its 'dia' strategy on to the SELL
        # residual, which rejects it; run the reference plan directly
        want = np.asarray(jsell.spmv_plan(jop.plan, x))
    else:
        want = np.asarray(jop @ x)
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-5, atol=2e-5)
    want64 = jref.spmv_numpy(ja, x.astype(np.float64))
    assert np.abs(y.numpy() - want64).max() / \
        max(1.0, np.abs(want64).max()) < 1e-4


def test_operator_exec_and_compare_golden():
    ja, pa = both(shuffled_band(2048, seed=5))
    x = np.random.default_rng(6).standard_normal(2048).astype(np.float32)
    op = SparseOperator.from_matrix(pa, device="cpu")
    gold = jref.spmv_numpy(ja, x.astype(np.float64))
    y = op.exec(x)
    assert isinstance(y, np.ndarray)
    np.testing.assert_allclose(y, gold, rtol=1e-4, atol=1e-4)
    for k in ("first_exec_seconds", "spmvtime", "gnnz_per_s"):
        assert op.stats[k] > 0
    np.testing.assert_allclose(op.exec(x, y=np.ones(2048)), gold + 1,
                               rtol=1e-4, atol=1e-4)
    assert op.compare_golden(x, gold) == 0
    bad = gold.copy()
    bad[:7] += 1.0
    assert op.compare_golden(x, bad) == 7
    assert op.stats["diffFromGolden"] == 7


def test_operator_tune_matches_jax():
    # tune=True runs both sweeps (tests/test_torch_tune.py): the winners
    # may differ between the packages, the product may not
    m = banded(512, list(range(-3, 4)), seed=2)
    ja, pa = both(m)
    jop = joperator.SparseOperator.from_matrix(ja, tune=True)
    op = SparseOperator.from_matrix(pa, tune=True, device="cpu")
    assert any(k.startswith("tune_") for k in op.stats.keys())
    assert type(op.plan).__name__ == type(jop.plan).__name__ == "DiaPlan"
    x = np.random.default_rng(4).standard_normal(512).astype(np.float32)
    np.testing.assert_allclose((op @ x).numpy(), np.asarray(jop @ x),
                               rtol=2e-5, atol=2e-5)


def test_operator_unported_paths_raise():
    _, pa = both(banded(512, [-1, 0, 1], seed=7))
    # SpMM runs now (tests/test_torch_spmm.py), under plus_times only
    op = SparseOperator.from_matrix(pa, semiring="min_plus", device="cpu")
    with pytest.raises(NotImplementedError, match="SpMM"):
        op @ np.ones((512, 4), np.float32)
