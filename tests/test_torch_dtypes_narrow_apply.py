"""Port parity for the applies of the float16, int8, uint8, int16, uint16
and uint64 value plans: ``spmv_plan`` and ``SparseOperator.from_matrix(...,
device="cpu") @ x`` on every plan family (DIA, Hybrid, SELL window,
resident, deep and stream, Chunk, Packed, Cached, CooTail) against the
JAX package's apply of its own plan (Pallas in interpret mode, one 8-tile
group a grid step) and against the exact product.

y has the reference's type (uint32 for uint64).  The integers are
exactly JAX's and the int64 product narrowed mod 2^8, 2^16 or 2^32;
float16 is within 4e-3 of max(1, |y|) of JAX (which sums in float16) and
within one float16 rounding of the float64 product over the rounded A
and x (``tests/test_torch_dtypes_narrow.py`` ``f16_bound_ok``).  The
other semirings are in ``tests/test_torch_dtypes_narrow_semirings.py``.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu.formats import cached as jcached
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu_torch.formats import cached as pcached
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.ops import semiring as psr
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_dtypes import jax_y
from tests.test_torch_dtypes_apply import FAMILIES
from tests.test_torch_dtypes_narrow import (KINDS, Y_DTYPE, check_y, typed,
                                            typed_x)
from tests.test_torch_plan import both


def _apply(plan, x, **kw):
    return psell.spmv_plan(pplan.place(plan, "cpu"), torch.from_numpy(x),
                           **kw)


@functools.lru_cache(maxsize=None)
def _case(kind, family):
    """The draw of ``family`` for ``kind``, its x, both packages' auto
    plans and the JAX package's y: shared by the plan and operator
    tests."""
    make, name = FAMILIES[family]
    m = typed(make(), kind, seed=7)
    ja, pa = both(m)
    x = typed_x(kind, m.shape[1], seed=8)
    jp = jplan.auto_plan(ja, value_dtype=KINDS[kind])
    assert type(jp).__name__ == name
    return m, pa, x, jp, jax_y(jp, x)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_plan_apply_matches_jax(kind, family):
    m, pa, x, jp, want = _case(kind, family)
    pp = pplan.auto_plan(pa, value_dtype=KINDS[kind])
    assert type(pp).__name__ == type(jp).__name__
    check_y(_apply(pp, x), want, m, x, kind)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_operator_matches_jax(kind, family):
    m, pa, x, jp, want = _case(kind, family)
    op = SparseOperator.from_matrix(pa, value_dtype=KINDS[kind],
                                    device="cpu")
    assert type(op.plan).__name__ == type(jp).__name__
    check_y(op @ x, want, m, x, kind)
    if kind == "f16":
        return
    # a wider x wraps to the value type, as the reference's cast does
    wide = x.astype(np.uint64 if kind == "u64" else np.int64) + \
        (1 << 8 * Y_DTYPE[kind].itemsize)
    assert torch.equal(psr.signed(op @ wide), psr.signed(op @ x))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_coo_tail_apply_matches_jax(kind):
    m = typed(sp.random(2000, 30000, density=3e-4, random_state=5,
                        format="csr"), kind)
    ja, pa = both(m)
    x = typed_x(kind, m.shape[1])
    jp = jcached.coo_tail_from_csr(ja, KINDS[kind])
    check_y(_apply(pcached.coo_tail_from_csr(pa, KINDS[kind]), x),
            jax_y(jp, x), m, x, kind)
