"""Port parity: the PackedPlan family against the JAX package's.

The matrices of the JAX package's ``tests/test_packed.py`` (random at
several ``chunk_blocks``, dense rows with overflow, empty matrices and
unvisited windows), made from a seed with numpy, go through both
packages:

* ``build_packed_plan`` and ``auto_plan`` give byte-equal plans;
* pass A (kernel E's plain version) and ``spmv_packed`` (kernels E and F)
  agree with the JAX Pallas kernels in interpret mode to a max abs error
  <= 1e-5 * max(1, max|ref|): float32 sums in another order (the
  plain scan runs the reference's Hillis-Steele order, so it is usually
  exact);
* y agrees with the float64 host loop to 1e-4 * max(1, max|y|), the
  JAX package's own bound for these matrices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spmv_vector_cache_tpu.formats import packed as jpacked
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import operator as joperator
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops import spmv_packed as jspmv_packed
from spmv_vector_cache_tpu_torch.formats import packed as ppacked
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.interop import plan_from_reference
from spmv_vector_cache_tpu_torch.ops import spmv_packed as pspmv_packed
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops import strategy as pstrategy
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_chunk import _assert_close
from tests.test_torch_plan import assert_plans_equal, both


def random_csr(rows, cols, density, seed=7):
    """Uniformly random positions (no repeats), N(0, 1) values."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(rows * cols, int(rows * cols * density), replace=False)
    a = sp.csr_matrix((rng.standard_normal(flat.shape[0]).astype(
        np.float32), (flat // cols, flat % cols)), shape=(rows, cols))
    a.sort_indices()
    return a


#: name -> (matrix, chunk_blocks)
CASES = {
    "narrow_cb8": (lambda: random_csr(300, 5000, 0.01), 8),
    "wide_cb64": (lambda: random_csr(1000, 40000, 0.002), 64),
    "dense_cb1": (lambda: random_csr(64, 64, 0.5), 1),
    "very_wide_cb32": (lambda: random_csr(500, 100000, 0.0005), 32),
    "many_windows_cb16": (lambda: random_csr(20000, 9000, 0.001), 16),
    "dense_rows_overflow": (lambda: random_csr(50, 3000, 0.3, seed=1), 4),
    "empty": (lambda: sp.csr_matrix((100, 200), dtype=np.float32), 32),
    "empty_windows": (lambda: sp.csr_matrix(
        (np.ones(3, np.float32), ([0, 1, 2], [5, 6, 7])),
        shape=(40000, 1000)), 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_packed_plan_byte_equal(case):
    make, cb = CASES[case]
    ja, pa = both(make())
    port = ppacked.build_packed_plan(pa, chunk_blocks=cb)
    assert_plans_equal(port, jpacked.build_packed_plan(ja, chunk_blocks=cb))
    if case == "dense_rows_overflow":
        assert port.stats.overflow_nnz > 0
    assert np.all(np.diff(port.wstep) >= 0)     # kernel F's precondition


@pytest.mark.parametrize("case", sorted(CASES))
def test_spmv_packed_matches_jax_and_host(case):
    make, cb = CASES[case]
    m = make()
    ja, _ = both(m)
    x = np.random.default_rng(3).standard_normal(m.shape[1]).astype(
        np.float32)
    jp = jpacked.build_packed_plan(ja, chunk_blocks=cb)
    want = jspmv_packed.spmv_packed(jp, x, interpret=True)
    y = pspmv_packed.spmv_packed(plan_from_reference(jp, "cpu"),
                                 torch.from_numpy(x)).numpy()
    _assert_close(y, want)
    want64 = jref.spmv_numpy(ja, x.astype(np.float64))
    scale = max(1.0, float(np.abs(want64).max()))
    assert np.abs(y - want64).max() <= 1e-4 * scale
    if case == "empty_windows":
        assert np.all(y[3:] == 0)


def test_packed_scan_matches_jax():
    """Pass A alone: the plain scan against the Pallas scan kernel, on
    the grid the JAX package's ``_spmv_packed`` gives it."""
    make, cb = CASES["dense_rows_overflow"]
    ja, _ = both(make())
    jp = jpacked.build_packed_plan(ja, chunk_blocks=cb)
    st = jp.stats
    x = np.random.default_rng(8).standard_normal(ja.shape[1]).astype(
        np.float32)
    nchunks = -(-ja.shape[1] // (cb * 128))
    x2d = np.zeros(nchunks * cb * 128, np.float32)
    x2d[:ja.shape[1]] = x
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(st.num_steps_a,),
        in_specs=[pl.BlockSpec((st.step_tiles, 8, 128),
                               lambda i, cs: (i, 0, 0))] * 2 +
        [pl.BlockSpec((cb, 128), lambda i, cs: (cs[i], 0))],
        out_specs=pl.BlockSpec((st.step_tiles, 8, 128),
                               lambda i, cs: (i, 0, 0)))
    want = pl.pallas_call(
        jspmv_packed._make_scan_kernel(cb, st.step_tiles, True,
                                       jnp.float32),
        grid_spec=spec, interpret=True,
        out_shape=jax.ShapeDtypeStruct(jp.vals.shape, jnp.float32))(
        jp.cstep, jp.vals, jp.cols, x2d.reshape(-1, 128))
    p = plan_from_reference(jp, "cpu")
    got = pspmv_packed.packed_scan_kernel(
        p.vals, p.cols, p.cstep, torch.from_numpy(x), chunk_blocks=cb,
        step_tiles=st.step_tiles)
    _assert_close(got.numpy(), want)


def test_packed_extract_plain_sums_visits_in_order():
    """Pass B alone, on a hand-made visit list: two visits to window 0,
    none to window 1, one to window 2."""
    scan = torch.arange(2 * 8 * 1024, dtype=torch.float32).reshape(
        2 * 8, 8, 128)                         # two S blocks of 8 tiles
    esrc = torch.full((3, 64, 128), -1, dtype=torch.int16)
    esrc[0, 0, 0], esrc[1, 0, 0] = 5, 7        # window 0, row 0
    esrc[2, 63, 127] = 1                       # window 2, its last row
    out = pspmv_packed.packed_extract_kernel(
        scan, torch.tensor([0, 1, 1], dtype=torch.int32),
        torch.tensor([0, 0, 2], dtype=torch.int32), esrc, num_windows=3,
        step_tiles=8)
    assert out.shape == (3 * 64, 128)
    flat = out.reshape(-1)
    assert flat[0].item() == 5 + (8192 + 7)
    assert flat[2 * 8192 + 8191].item() == 8192 + 1
    assert int((flat != 0).sum()) == 2


def test_auto_plan_routes_locality_poor_to_packed():
    # the first recipe of the JAX package's
    # test_auto_plan_routes_locality_poor_to_packed_or_cached
    rng = np.random.RandomState(11)
    n = 1 << 17
    rows = np.repeat(np.arange(n, dtype=np.int64), 4)
    cols = rng.randint(0, n, rows.shape[0])
    m = sp.csr_matrix((rng.standard_normal(rows.shape[0]).astype(
        np.float32), (rows, cols)), shape=(n, n))
    m.sort_indices()
    ja, pa = both(m)
    port = pplan.auto_plan(pa)
    assert isinstance(port, ppacked.PackedPlan)
    assert pstrategy.select_strategy(port) == "packed"
    assert_plans_equal(port, jplan.auto_plan(ja))


def test_auto_plan_column_skew_still_raises_for_cached():
    # the second recipe: skewed columns make the reference build a
    # CachedPlan (a 2,048-column window tier, K=16, with a packed cold
    # part); the port no longer raises there but builds the same plan,
    # array for array
    rng = np.random.RandomState(11)
    n = 1 << 17
    rows = np.repeat(np.arange(n, dtype=np.int64), 4)
    u = rng.random_sample(rows.shape[0])
    cols = np.minimum((n * u ** 8).astype(np.int64), n - 1)
    m = sp.csr_matrix((rng.standard_normal(rows.shape[0]).astype(
        np.float32), (rows, cols)), shape=(n, n))
    m.sort_indices()
    ja, pa = both(m)
    port = pplan.auto_plan(pa)
    assert type(port).__name__ == "CachedPlan"
    assert isinstance(port.cold, ppacked.PackedPlan)
    assert port.hot_cols.shape == (2048,)
    assert port.hot.stats.window_blocks == 16
    assert pstrategy.select_strategy(port) == "cached"
    assert_plans_equal(port, jplan.auto_plan(ja))


def test_operator_on_packed_plan_matches_jax():
    m = random_csr(20000, 9000, 0.001)
    ja, pa = both(m)
    x = np.random.default_rng(9).standard_normal(m.shape[1]).astype(
        np.float32)
    # a packed plan through the operator: build it in both packages
    jop = joperator.SparseOperator(jpacked.build_packed_plan(ja))
    op = SparseOperator(pplan.place(ppacked.build_packed_plan(pa), "cpu"))
    assert op.strategy == jop.strategy == "packed"
    assert op.stats.as_dict() == jop.stats.as_dict()
    _assert_close((op @ x).numpy(), jop @ x)


def test_packed_counters_and_bytes_match_jax():
    from spmv_vector_cache_tpu.ops import strategy as jstrategy

    ja, pa = both(random_csr(2000, 50000, 0.001, seed=5))
    jp = jpacked.build_packed_plan(ja, chunk_blocks=32)
    pp = ppacked.build_packed_plan(pa, chunk_blocks=32)
    assert pstrategy.plan_nnz(pp) == jstrategy.plan_nnz(jp)
    assert pstrategy.execution_counters(pp) == \
        jstrategy.execution_counters(jp)
    assert pstrategy.plan_bytes_per_apply(pp) == \
        jstrategy.plan_bytes_per_apply(jp)


def test_packed_rejects_non_ring_semirings():
    _, pa = both(sp.eye(64, format="csr", dtype=np.float32))
    plan = pplan.place(ppacked.build_packed_plan(pa), "cpu")
    with pytest.raises(ValueError, match="plus_times"):
        psell.spmv_plan(plan, torch.ones(64), semiring="min_plus")
    with pytest.raises(ValueError, match="packed"):
        psell.spmv_plan(plan, torch.ones(64), strategy="window")
