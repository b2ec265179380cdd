"""Port parity for the SpMM, the sweeps and the interop of the float16,
int8, uint8, int16, uint16 and uint64 value plans.

* kernel H's and kernel I's plain versions (``spmm_plan``) against the
  JAX package's SpMM (Pallas in interpret mode): the integers exactly,
  and equal to the int64 product narrowed to Y's type; float16 within
  4e-3 of max(1, |Y|) of JAX, which sums in float16, and within one
  float16 rounding of the float64 product over the rounded values;
* ``op @ B`` on every plan family, the fused kernels and the
  ``reference.spmm`` fallback, Y in the plan's y type;
* the sweeps (``from_matrix(tune=True)``) on narrow plans;
* a ``formats.plan_io`` save and load, and ``plan_from_reference`` of
  a JAX plan, give the port's own plan's y bit for bit.
"""

import numpy as np
import pytest
import torch

from spmv_vector_cache_tpu.formats import dia as jdia
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import spmm_dia as jspmm_dia
from spmv_vector_cache_tpu.ops import spmm_pallas as jspmm
from spmv_vector_cache_tpu_torch.formats import dia as pdia
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.formats import plan_io
from spmv_vector_cache_tpu_torch.interop import plan_from_reference
from spmv_vector_cache_tpu_torch.ops import semiring as psr
from spmv_vector_cache_tpu_torch.ops import spmm_sell as pspmm
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_dtypes import small
from tests.test_torch_dtypes_apply import FAMILIES
from tests.test_torch_dtypes_narrow import (F16_JAX_RTOL, KINDS, Y_DTYPE,
                                            exact, f16_bound_ok, typed,
                                            typed_x)
from tests.test_torch_plan import banded, both, shuffled_band


def typed_b(kind, rows, k, seed=2) -> np.ndarray:
    """B (rows, k), column-wise as ``typed_x``."""
    return np.stack([typed_x(kind, rows, seed=seed + j) for j in range(k)],
                    1)


def check_Y(Y, want_jax, m, b, kind):
    """Y against the JAX SpMM's Y (when given) and the exact product,
    column by column."""
    assert isinstance(Y, torch.Tensor) and Y.dtype == Y_DTYPE[kind]
    got = Y.numpy()
    for j in range(b.shape[1]):
        if kind == "f16":
            assert f16_bound_ok(got[:, j], m, b[:, j])
        else:
            np.testing.assert_array_equal(got[:, j], exact(m, b[:, j], kind))
    if want_jax is None:
        return
    want_jax = np.asarray(want_jax)
    if kind == "f16":
        scale = max(1.0, float(np.abs(want_jax.astype(np.float64)).max()))
        assert np.abs(got.astype(np.float64) - want_jax).max() / scale <= \
            F16_JAX_RTOL
    else:
        np.testing.assert_array_equal(got, want_jax.astype(got.dtype))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_spmm_sell_matches_jax(kind):
    # kernel H's plain version on a window plan
    m = typed(shuffled_band(2048, seed=3), kind)
    ja, pa = both(m)
    b = typed_b(kind, m.shape[1], 16)
    jp = jplan.build_sell_plan(ja, value_dtype=KINDS[kind])
    pp = pplan.place(pplan.build_sell_plan(pa, value_dtype=KINDS[kind]),
                     "cpu")
    assert pp.stats.window_blocks > 0 and pspmm.has_fused_spmm(pp)
    want = jspmm.spmm_plan(small(jp).to_device(), b, interpret=True)
    check_Y(pspmm.spmm_plan(pp, torch.from_numpy(b)), want, m, b, kind)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_spmm_dia_matches_jax(kind):
    # kernel I's plain version
    m = typed(banded(4096, list(range(-13, 14)), seed=1), kind)
    ja, pa = both(m)
    b = typed_b(kind, m.shape[1], 8)
    jp = jdia.build_dia_plan(ja, value_dtype=KINDS[kind])
    pp = pplan.place(pdia.build_dia_plan(pa, value_dtype=KINDS[kind]),
                     "cpu")
    want = jspmm_dia.spmm_dia(jp.to_device(), b, interpret=True)
    check_Y(pspmm.spmm_plan(pp, torch.from_numpy(b)), want, m, b, kind)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_matmat_on_every_family(kind, family):
    # op @ B: kernels H and I where the plan has them, else reference.spmm
    # on the matrix's values as the plan stores them
    make, _ = FAMILIES[family]
    m = typed(make(), kind, seed=5)
    _, pa = both(m)
    op = SparseOperator.from_matrix(pa, value_dtype=KINDS[kind],
                                    device="cpu")
    b = typed_b(kind, m.shape[1], 3, seed=6)
    Y = op @ b
    assert pspmm.has_fused_spmm(op.plan) == (family in ("dia", "hybrid",
                                                        "window"))
    check_Y(Y, None, m, b, kind)
    # column j of Y is op @ B[:, j], the same sums narrowed once
    y1 = op @ b[:, 1]
    if kind == "f16":
        assert np.abs(Y.numpy()[:, 1].astype(np.float64) - y1.numpy()).max() \
            <= 2.0 ** -10 * max(1.0, float(y1.float().abs().max()))
    else:
        assert torch.equal(psr.signed(Y[:, 1].contiguous()), psr.signed(y1))


@pytest.mark.parametrize("kind", ["f16", "i8", "u16"])
def test_narrow_from_matrix_tune(kind, tmp_path):
    # both sweeps run on the CPU with x = ones in the plan's sum type, and
    # the operator they leave returns y of the reference's type
    m = typed(shuffled_band(2048, seed=3), kind)
    _, pa = both(m)
    op = SparseOperator.from_matrix(pa, value_dtype=KINDS[kind], tune=True,
                                    tune_store=str(tmp_path / "t.json"),
                                    device="cpu")
    assert op.stats["tuned"] in (0, 1)
    x = typed_x(kind, m.shape[1])
    y = op @ x
    assert y.dtype == Y_DTYPE[kind]
    plain = psell.spmv_plan(pplan.place(pplan.auto_plan(
        pa, value_dtype=KINDS[kind]), "cpu"), torch.from_numpy(x))
    if kind == "f16":
        assert f16_bound_ok(y.numpy(), m, x)
    else:
        assert torch.equal(psr.signed(y), psr.signed(plain))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_plan_io_round_trip(kind, tmp_path):
    # a saved narrow SellPlan loads with its slab's type and bits, and
    # applies to the same y; the JAX package loads the port's file
    m = typed(shuffled_band(2048, seed=3), kind)
    ja, pa = both(m)
    host = pplan.build_sell_plan(pa, value_dtype=KINDS[kind])
    path = plan_io.save_plan(host, str(tmp_path / "p.npz"))
    back = plan_io.load_plan(path)
    assert back.vals.dtype == host.vals.dtype
    assert back.vals.tobytes() == host.vals.tobytes()
    x = torch.from_numpy(typed_x(kind, m.shape[1]))
    y0 = psell.spmv_plan(pplan.place(host, "cpu"), x)
    y1 = psell.spmv_plan(pplan.place(back, "cpu"), x)
    assert torch.equal(psr.signed(y0), psr.signed(y1))
    from spmv_vector_cache_tpu.formats import plan_io as jplan_io

    jback = jplan_io.load_plan(path)
    assert np.asarray(jback.vals).tobytes() == host.vals.tobytes()


@pytest.mark.parametrize("family", ["dia", "window", "chunk", "packed"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_plan_from_reference(kind, family):
    # a JAX plan carried across (uint64 values as uint32) gives the
    # port's own plan's y bit for bit
    make, _ = FAMILIES[family]
    m = typed(make(), kind, seed=9)
    ja, pa = both(m)
    x = torch.from_numpy(typed_x(kind, m.shape[1], seed=10))
    carried = plan_from_reference(jplan.auto_plan(ja,
                                                  value_dtype=KINDS[kind]),
                                  "cpu")
    own = pplan.place(pplan.auto_plan(pa, value_dtype=KINDS[kind]), "cpu")
    y = psell.spmv_plan(carried, x)
    assert y.dtype == Y_DTYPE[kind]
    assert torch.equal(psr.signed(y), psr.signed(psell.spmv_plan(own, x)))
