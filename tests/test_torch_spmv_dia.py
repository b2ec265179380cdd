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


# ---------------------------------------------------------------------------
# kernels A and M's launch shape (``dia_launch_shape``) and the staged x
# window's layout, as the kernels index it
# ---------------------------------------------------------------------------

HEADLINE = tuple(range(-13, 14))


@pytest.mark.parametrize("offsets", [HEADLINE, (-1025, 0, 1300),
                                     (-20000, 0, 20000)],
                         ids=["headline", "wide", "over_budget"])
@pytest.mark.parametrize("rows", [100, 5037, 65536, 1 << 18, 1 << 20])
@pytest.mark.parametrize("slot_bytes", [1, 2, 4])
def test_dia_launch_shape(slot_bytes, rows, offsets):
    # one shard of the cut band (65,536 rows), a full shard and the cut
    # band (2^18), the DIA headline (2^20); 128 steps of 8192 rows
    step = 8192
    shape = pdia_ops.dia_launch_shape(rows, step, slot_bytes, offsets)
    R, threads = shape.rows_per_thread, shape.threads
    assert R & (R - 1) == 0 and R * slot_bytes <= pdia_ops.VECTOR_BYTES
    assert R <= pdia_ops.MAX_ROWS
    assert step % R == 0
    assert threads % 32 == 0 and threads <= pdia_ops.MAX_THREADS
    # every row exactly once: thread t sums rows [tR, tR + R), the last
    # CTA holds a row
    assert shape.ctas == -(-rows // (R * threads))
    owned = np.arange(shape.ctas * threads * R).reshape(-1, R)
    owned = owned[owned < rows]
    assert owned.size == rows and np.array_equal(np.sort(owned),
                                                 np.arange(rows))
    assert (shape.ctas - 1) * threads * R < rows
    # R shrinks only for a launch that would not fill the card
    if R < min(pdia_ops.MAX_ROWS, pdia_ops.VECTOR_BYTES // slot_bytes):
        assert -(-rows // (2 * R)) < (pdia_ops.H100_SMS
                                       * pdia_ops.FILL_THREADS_PER_SM)
    # the staged window fits the budget and holds every entry read
    span = max(offsets) - min(offsets)
    words = pdia_ops.stage_words(threads, R, span)
    assert shape.staged == (4 * words <= pdia_ops.STAGE_BYTES)
    assert shape.smem_bytes == (4 * words if shape.staged else 0)
    assert shape.smem_bytes <= pdia_ops.STAGE_BYTES
    assert pdia_ops.stage_address(threads - 1, span, R - 1, R) < words
    if offsets != (-1025, 0, 1300):       # the wide span: either path
        assert shape.staged == (offsets == HEADLINE)


@pytest.mark.parametrize("span", [0, 26, 69, 2325])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_dia_stage_layout(R, span):
    # thread i's row j on the diagonal at c = off - min(offsets) reads
    # window entry iR + c + j, and a warp's 32 threads read 32 banks
    i = np.arange(64)[:, None, None]
    c = np.arange(span + 1)[None, :, None]
    j = np.arange(R)[None, None, :]
    addr = pdia_ops.stage_address(i, c, j, R)
    assert np.array_equal(pdia_ops.stage_entry(addr, R), i * R + c + j)
    assert addr.max() < pdia_ops.stage_words(64, R, span)
    for warp in (addr[:32], addr[32:]):
        banks = np.sort(warp % 32, axis=0)
        assert (np.diff(banks, axis=0) != 0).all()


def test_dia_kernel_shape_of_a_host_slab():
    _, pa = both(banded(3000, list(HEADLINE), seed=9))
    from spmv_vector_cache_tpu_torch.formats.dia import build_dia_plan
    from spmv_vector_cache_tpu_torch.formats.plan import place

    plan = place(build_dia_plan(pa, sublanes=8), torch.device("cpu"))
    ptr = plan.vals.data_ptr()
    assert pdia_ops.kernel_shape(plan.vals, plan.offsets, 3000) == \
        pdia_ops.dia_launch_shape(3000, 1024, 4, HEADLINE,
                                  align=min(16, ptr & -ptr))
