"""Port parity for the SpMM, the sweeps and the interop of the bfloat16,
int32, uint32 and int64 value plans.

* kernel H's and kernel I's plain versions (``spmm_plan``) against the
  JAX package's SpMM (Pallas in interpret mode): bfloat16 SELL summed in
  float32 (1e-5 of max(1, |Y|)), int32 and uint32 SELL and DIA exactly,
  and equal to the int64 product wrapped mod 2^32;
* reference fault 1: the JAX DIA SpMM of a bfloat16 plan rounds B to
  bfloat16 and sums in bfloat16 (its Y is no better than 2e-3 of the
  float64 product over the rounded values); the port's sums in float32
  (1e-5);
* ``op @ B`` on every plan family, the fused kernels and the
  ``reference.spmm`` fallback, in the plan's value type;
* the sweeps (``from_matrix(tune=True)``) and ``audit`` on typed plans;
* ``plan_from_reference`` of a JAX bfloat16, int32, uint32 and int64
  plan gives the y of the port's own plan, bit for bit.
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
from spmv_vector_cache_tpu_torch.interop import plan_from_reference
from spmv_vector_cache_tpu_torch.ops import spmm_sell as pspmm
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_dtypes import (BF16_RTOL, KINDS, Y_DTYPE,
                                     exact_product, rounded, small, typed,
                                     typed_x)
from tests.test_torch_dtypes_apply import FAMILIES
from tests.test_torch_plan import banded, both, shuffled_band


def typed_b(kind, rows, k, seed=2) -> np.ndarray:
    """B (rows, k) in the plan's sum type, column-wise as ``typed_x``."""
    return np.stack([typed_x(kind, rows, seed=seed + j) for j in range(k)],
                    1)


def check_Y(Y, want_jax, m, b, kind):
    """Y against the JAX SpMM's Y (when given) and the exact product:
    integers equal, bfloat16 within 1e-5 of max(1, |Y|)."""
    assert isinstance(Y, torch.Tensor) and Y.dtype == Y_DTYPE[kind]
    got = Y.numpy()
    if kind == "bf16":
        want64 = rounded(m) @ b.astype(np.float64)
        scale = max(1.0, float(np.abs(want64).max()))
        assert np.abs(got - want64).max() / scale <= BF16_RTOL
        if want_jax is not None:
            want_jax = np.asarray(want_jax)
            assert np.abs(got - want_jax.astype(np.float64)).max() / \
                scale <= BF16_RTOL
        return
    if want_jax is not None:
        np.testing.assert_array_equal(got, np.asarray(want_jax))
    want = np.stack([exact_product(m, b[:, j], kind)
                     for j in range(b.shape[1])], 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_spmm_sell_matches_jax(kind):
    # kernel H's plain version on a window plan
    m = typed(shuffled_band(2048, seed=3), kind)
    ja, pa = both(m)
    b = typed_b(kind, m.shape[1], 16)
    jp = jplan.build_sell_plan(ja, value_dtype=KINDS[kind])
    pp = pplan.place(pplan.build_sell_plan(pa, value_dtype=KINDS[kind]),
                     "cpu")
    assert pp.stats.window_blocks > 0 and pspmm.has_fused_spmm(pp)
    want = jspmm.spmm_plan(small(jp).to_device(), b, interpret=True)
    if kind == "bf16":
        assert np.asarray(want).dtype == np.float32    # summed in float32
    check_Y(pspmm.spmm_plan(pp, torch.from_numpy(b)), want, m, b, kind)


@pytest.mark.parametrize("kind", ["i32", "u32", "i64"])
def test_spmm_dia_integer_matches_jax(kind):
    # kernel I's plain version, exact in the value type
    m = typed(banded(4096, list(range(-13, 14)), seed=1), kind)
    ja, pa = both(m)
    b = typed_b(kind, m.shape[1], 8)
    jp = jdia.build_dia_plan(ja, value_dtype=KINDS[kind])
    pp = pplan.place(pdia.build_dia_plan(pa, value_dtype=KINDS[kind]),
                     "cpu")
    want = jspmm_dia.spmm_dia(jp.to_device(), b, interpret=True)
    check_Y(pspmm.spmm_plan(pp, torch.from_numpy(b)), want, m, b, kind)


def test_dia_spmm_bf16_sums_in_float32():
    # the reference's DIA SpMM accumulates in the plan's bfloat16 (its
    # acc_dtype is the value dtype) and returns a bfloat16 Y; the port's
    # kernel I sums the same rounded values in float32
    n, offs = 1 << 14, list(range(-3, 4))
    m = typed(banded(n, offs, seed=4), "bf16")
    ja, pa = both(m)
    b = typed_b("bf16", n, 16)
    want64 = rounded(m) @ b.astype(np.float64)
    scale = np.abs(want64).max()
    jY = np.asarray(jspmm_dia.spmm_dia(
        jdia.build_dia_plan(ja, value_dtype=KINDS["bf16"]).to_device(), b,
        interpret=True))
    assert jY.dtype.name == "bfloat16"
    assert np.abs(jY.astype(np.float64) - want64).max() / scale > 2e-3
    pp = pplan.place(pdia.build_dia_plan(pa, value_dtype="bfloat16"), "cpu")
    Y = pspmm.spmm_plan(pp, torch.from_numpy(b))
    assert Y.dtype == torch.float32
    assert np.abs(Y.numpy() - want64).max() / scale <= BF16_RTOL


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", ["bf16", "i32", "u32"])
def test_matmat_on_every_family(kind, family):
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
    # column j of Y is op @ B[:, j]
    y1 = (op @ b[:, 1]).numpy()
    if kind == "bf16":
        assert np.abs(Y.numpy()[:, 1] - y1).max() <= BF16_RTOL * max(
            1.0, float(np.abs(y1).max()))
    else:
        np.testing.assert_array_equal(Y.numpy()[:, 1], y1)


@pytest.mark.parametrize("kind", ["bf16", "i32"])
def test_from_matrix_tune_on_typed_plans(kind, tmp_path):
    # both sweeps run on the CPU with x = ones in the plan's x type, and
    # the operator they leave returns y of the reference's type
    m = typed(shuffled_band(2048, seed=3), kind)
    _, pa = both(m)
    op = SparseOperator.from_matrix(pa, value_dtype=KINDS[kind], tune=True,
                                    tune_store=str(tmp_path / "t.json"),
                                    device="cpu")
    assert op.stats["tuned"] in (0, 1)
    assert any(k.startswith("tune_") for k in op.stats.as_dict())
    x = typed_x(kind, m.shape[1])
    y = op @ x
    assert y.dtype == Y_DTYPE[kind]
    plain = psell.spmv_plan(pplan.place(pplan.auto_plan(
        pa, value_dtype=KINDS[kind]), "cpu"), torch.from_numpy(x))
    if kind == "bf16":
        assert float((y - plain).abs().max()) <= BF16_RTOL * max(
            1.0, float(plain.abs().max()))
    else:
        assert torch.equal(y, plain)


@pytest.mark.parametrize("kind", ["bf16", "u32"])
def test_audit_on_typed_plans(kind):
    # the default x is ones in the plan's x type; an integer y is
    # normalised in float64 along the chain
    m = typed(shuffled_band(2048, seed=3), kind)
    _, pa = both(m)
    op = SparseOperator.from_matrix(pa, value_dtype=KINDS[kind],
                                    device="cpu")
    out = op.audit(iters=2)
    assert out["gnnz_per_s"] > 0 and out["bytes_per_apply"] > 0


@pytest.mark.parametrize("family", ["dia", "window", "chunk", "packed"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plan_from_reference_typed(kind, family):
    # a JAX plan carried across (bfloat16 by its bits, int64 as int32)
    # gives the port's own plan's y bit for bit
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
    assert torch.equal(y.view(torch.int32) if kind == "u32" else y,
                       psell.spmv_plan(own, x).view(torch.int32)
                       if kind == "u32" else psell.spmv_plan(own, x))
