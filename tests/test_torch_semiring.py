"""Port parity: the semirings' segment reduce and the torch executor
``reference.spmv`` on a CSR matrix against the JAX package's.

Empty segments must get what ``jax.ops.segment_*`` gives them: 0 for the
sum, -inf for max, +inf for min, and 0 (False) for or_and.  Values are
float32 and each segment reduces at most a few terms, so the sum is held
to rtol = atol = 1e-6 and the min/max/or reductions exactly.
"""

import numpy as np
import pytest
import torch

from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops import semiring as jsr
from spmv_vector_cache_tpu_torch.ops import reference as pref
from spmv_vector_cache_tpu_torch.ops import semiring as psr
from tests.test_torch_plan import both, random_sparse

SEMIRINGS = ("plus_times", "min_plus", "max_plus", "max_times", "or_and")


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_segment_reduce_matches_jax(semiring):
    rng = np.random.default_rng(1)
    ids = np.sort(rng.integers(0, 40, 100)).astype(np.int32)
    ids = ids[(ids % 5) != 0]                  # every fifth segment empty
    vals = rng.standard_normal((ids.shape[0], 3)).astype(np.float32)
    if semiring == "or_and":
        vals = (vals > 0).astype(np.float32)
    want = np.asarray(jsr.get(semiring).segment_reduce(vals, ids, 41))
    got = psr.get(semiring).segment_reduce(
        torch.from_numpy(vals), torch.from_numpy(ids), 41).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(np.isinf(got), np.isinf(want))


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_spmv_csr_matches_jax(semiring):
    m = random_sparse(200, 150, 0.05, seed=2,
                      nonneg=semiring in ("max_times", "or_and"))
    if semiring == "or_and":
        m.data = (m.data > 0.5).astype(np.float32)
    ja, pa = both(m)
    x = np.abs(np.random.default_rng(3).standard_normal(150)).astype(
        np.float32)
    if semiring == "or_and":
        x = (x > 0.7).astype(np.float32)
    want = np.asarray(jref.spmv(ja, x, semiring=semiring)).astype(np.float32)
    got = pref.spmv(pa, torch.from_numpy(x), semiring).to(
        torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
