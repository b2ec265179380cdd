"""Port parity: the port's ``spmv_dia`` against the JAX package's.

The JAX side runs its Pallas DIA kernels in interpret mode on the CPU,
resident and windowed; the port side runs kernel A's plain PyTorch
version (a CPU tensor), on the same plan carried over with
``plan_from_reference``.  Tolerances: y against JAX rtol = atol = 2e-5
(float32, the JAX DIA tests' own bound); y against the float64 host loop
below 1e-4 relative (bench.py's gate).
"""

import numpy as np
import pytest
import torch

from spmv_vector_cache_tpu.formats import dia as jdia
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops.spmv_dia import spmv_dia as jspmv_dia
from spmv_vector_cache_tpu_torch.interop import plan_from_reference
from spmv_vector_cache_tpu_torch.ops import spmv_dia as pdia_ops
from tests.test_torch_plan import banded, both


def _check(m, resident, seed):
    ja, _ = both(m)
    jp = jdia.build_dia_plan(ja, sublanes=8)
    x = np.random.default_rng(seed).standard_normal(m.shape[1]).astype(
        np.float32)
    want_jax = np.asarray(jspmv_dia(jp.to_device(), x, resident=resident))
    pp = plan_from_reference(jp, "cpu")
    y = pdia_ops.spmv_dia(pp, torch.from_numpy(x)).numpy()
    assert y.dtype == np.float32 and y.shape == (m.shape[0],)
    np.testing.assert_allclose(y, want_jax, rtol=2e-5, atol=2e-5)
    want64 = jref.spmv_numpy(ja, x.astype(np.float64))
    assert np.abs(y - want64).max() / max(1.0, np.abs(want64).max()) < 1e-4


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("offs", [
    [0],                                   # identity-like
    [-1, 0, 1],                            # tridiagonal
    [-130, -7, 0, 3, 200],                 # offsets crossing 128/1024 bounds
    [-1025, 0, 1300],
])
def test_spmv_dia_matches_jax(offs, resident):
    _check(banded(700, offs, seed=1), resident, seed=2)


@pytest.mark.parametrize("resident", [True, False])
def test_spmv_dia_rectangular(resident):
    _check(banded(300, [0, 200], seed=3, cols=520), resident, seed=4)


@pytest.mark.parametrize("resident", [True, False])
def test_spmv_dia_multi_step(resident):
    # 3000 rows at 8 sublanes: three 1024-row steps, the last one ragged
    _check(banded(3000, list(range(-13, 14)), seed=5), resident, seed=6)


def test_spmv_dia_rejects_wrong_x():
    _, pa = both(banded(300, [0, 1], seed=7))
    from spmv_vector_cache_tpu_torch.formats.dia import build_dia_plan
    from spmv_vector_cache_tpu_torch.formats.plan import place

    plan = place(build_dia_plan(pa, sublanes=8), torch.device("cpu"))
    with pytest.raises(ValueError, match="x has shape"):
        pdia_ops.spmv_dia(plan, torch.zeros(299))


def test_spmv_dia_kernel_rejects_offsets_of_another_plan():
    _, pa = both(banded(300, [0, 1], seed=8))
    from spmv_vector_cache_tpu_torch.formats.dia import build_dia_plan

    plan = build_dia_plan(pa, sublanes=8)
    with pytest.raises(ValueError, match="offsets"):
        pdia_ops.spmv_dia_kernel(torch.from_numpy(plan.vals), (0, 1, 2),
                                 torch.zeros(300), 300)
