"""Port parity: the CachedPlan family and the resident, deep and stream
SELL strategies against the JAX package's.

Matrices made from a seed with numpy go through both packages:

* ``build_cached_plan``, ``_compact_full_cover`` and ``auto_plan`` give
  byte-equal plans, equal ``hot_cols`` and equal ``coverage`` (a window
  tier with a nested full-cover tier, one full-cover resident tier, a
  window tier ending in a CooTail, a hot set with no cold part), and
  both refuse a matrix with uniform column popularity;
* ``spmv_plan`` with ``strategy="resident"``, ``"deep"`` and ``"stream"``
  (kernel G's plain version) agrees with the JAX Pallas kernels in
  interpret mode for all five semirings: to rtol = atol = 2e-5 under
  plus_times (float32 sums in another order), exactly under the other
  four (their reductions do not depend on order and each product is one
  float32 operation);
* the CachedPlan apply agrees with JAX's ``spmv_plan`` the same way, and
  with the float64 host loop below 1e-4 relative;
* the strategy caps, the stream warning, the operator's stats and
  counters and the interop behave as the reference's do.

The JAX side runs window tiers with one 8-tile group per grid step
(``_small_steps``): the grid step sets only how the interpreted kernel
is blocked, not what y it computes.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu.formats import cached as jcached
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import operator as joperator
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops import semiring as jsr
from spmv_vector_cache_tpu.ops import spmv_pallas as jsell
from spmv_vector_cache_tpu.ops import strategy as jstrategy
from spmv_vector_cache_tpu_torch.formats import cached as pcached
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.formats.costmodel import estimate_seconds
from spmv_vector_cache_tpu_torch.interop import (plan_from_reference,
                                                 plan_to_numpy)
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops import strategy as pstrategy
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_chunk import _semiring_data
from tests.test_torch_plan import (assert_plans_equal, both, random_sparse,
                                   shuffled_band)

SEMIRINGS = ("plus_times", "min_plus", "max_plus", "max_times", "or_and")


# ---------------------------------------------------------------------------
# matrices (scipy CSR, float32, sorted)
# ---------------------------------------------------------------------------

def powerlaw_cols(seed, rows=8192, cols=65536, nnz_row=32, a=1.6):
    """``tests/test_cached.py``'s ``powerlaw_cols_csr``: column popularity
    a power law, the hot columns scattered over the whole range."""
    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(a, size=rows * nnz_row) - 1, cols - 1)
    c = rng.permutation(cols)[ranks]
    r = np.repeat(np.arange(rows), nnz_row)
    m = sp.coo_matrix((rng.standard_normal(rows * nnz_row).astype(
        np.float32), (r, c)), shape=(rows, cols)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    return m.astype(np.float32)


def zipf_cols(rows, cols, per_row, s, shift, seed):
    """``tools/report.py``'s zipf-column recipe, column ranks weighted by
    ``(rank + shift) ** -s`` and permuted over the whole range."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(rows, dtype=np.int64), per_row)
    w = (np.arange(cols, dtype=np.float64) + shift) ** -s
    c = rng.choice(cols, size=r.shape[0], p=w / w.sum())
    c = rng.permutation(cols)[c]
    m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=(rows, cols))
    m.sort_indices()
    return m


def few_columns(seed=0, rows=512, cols=32768, used=200):
    """Every nonzero in ``used`` distinct columns of a wide matrix
    (``tests/test_cached.py``'s no-cold case)."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(cols, used, replace=False)
    c = hot[rng.integers(0, used, rows * 8)]
    r = np.repeat(np.arange(rows), 8)
    m = sp.coo_matrix((np.ones(rows * 8, np.float32), (r, c)),
                      shape=(rows, cols)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    return m.astype(np.float32)


#: name -> (matrix, the chains that build_cached_plan and auto_plan give:
#: (hot tier's strategy, cold part's kind) per level)
CACHED = {
    # build_cached_plan: a window tier over the hottest columns, then a
    # nested full-cover tier; auto_plan: one full-cover resident tier of
    # about 3,200 columns
    "powerlaw_full_cover": (lambda: powerlaw_cols(0),
                            [("window", "CachedPlan"), ("resident", None)],
                            [("resident", None)]),
    # a 2,048-column window tier, then a CooTail
    "zipf2.0_coo_tail": (lambda: zipf_cols(8192, 1 << 18, 24, 2.0, 300, 3),
                         [("window", "CooTail")], [("window", "CooTail")]),
    # 200 distinct columns: the hot set covers all, no cold part
    "no_cold": (few_columns, [("window", None)], [("window", None)]),
}


def _chain(plan):
    """[(hot strategy, cold kind or None)] down a CachedPlan's levels."""
    out = []
    while isinstance(plan, pcached.CachedPlan):
        cold = None if plan.cold is None else type(plan.cold).__name__
        out.append((pstrategy.select_strategy(plan.hot), cold))
        plan = plan.cold
    return out


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CACHED))
def test_build_cached_plan_byte_equal(case):
    make, chain, _ = CACHED[case]
    ja, pa = both(make())
    port = pcached.build_cached_plan(pa)
    ref = jcached.build_cached_plan(ja)
    assert isinstance(port, pcached.CachedPlan)
    assert_plans_equal(port, ref)
    assert np.asarray(port.hot_cols).tobytes() == \
        np.asarray(ref.hot_cols).tobytes()
    assert port.coverage == ref.coverage
    assert _chain(port) == chain
    assert pstrategy.plan_nnz(port) == ja.nnz


@pytest.mark.parametrize("case", sorted(CACHED))
def test_auto_plan_cached_byte_equal(case):
    make, _, chain = CACHED[case]
    ja, pa = both(make())
    port = pplan.auto_plan(pa)
    assert _chain(port) == chain
    assert_plans_equal(port, jplan.auto_plan(ja))
    assert estimate_seconds(port) > 0


def test_compact_full_cover_byte_equal():
    ja, pa = both(powerlaw_cols(1, rows=4096, cols=32768))
    kw = dict(value_dtype=np.float32, lane_rows=128, positions=8,
              max_window_blocks=16, pad_value=0.0)
    port = pcached._compact_full_cover(pa, kw)
    assert port is not None and port.cold is None and port.coverage == 1.0
    assert_plans_equal(port, jcached._compact_full_cover(ja, kw))


def test_cached_plan_refused_without_skew():
    # uniform column popularity: no working set to cache
    m = random_sparse(400, 65536, 0.001, seed=3)
    ja, pa = both(m)
    assert pcached.build_cached_plan(pa) is None
    assert jcached.build_cached_plan(ja) is None
    assert pcached.hot_set_coverage(pa) == jcached.hot_set_coverage(ja)


# ---------------------------------------------------------------------------
# the resident, deep and stream strategies
# ---------------------------------------------------------------------------

def _assert_matches(y, want, semiring):
    """2e-5 under plus_times, exact under the other semirings."""
    want = np.asarray(want)
    assert y.shape == want.shape and y.dtype == want.dtype
    if semiring == "plus_times":
        np.testing.assert_allclose(y, want, rtol=2e-5, atol=2e-5)
    else:
        assert y.tobytes() == want.tobytes()


#: strategy -> (matrix, build_sell_plan kwargs): a windowless plan over
#: 12 blocks (resident), 320 blocks (deep, stream), and the uniform-parts
#: layout of test_torch_spmv_sell.py (resident with the per-group fold
#: and the lane-fold epilogue)
STRATEGY_PLANS = {
    "resident": (lambda: random_sparse(300, 1500, 0.02, seed=1),
                 dict(max_window_blocks=4)),
    "deep": (lambda: random_sparse(300, 40960, 0.002, seed=2), {}),
    "stream": (lambda: random_sparse(300, 40960, 0.002, seed=2), {}),
    "resident_uniform_parts": (
        lambda: shuffled_band(2048, seed=5),
        dict(split=16, uniform_split=True, window_group_tiles=2,
             groups_per_step=8)),
}


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("case", sorted(STRATEGY_PLANS))
def test_sell_strategies_match_jax(case, semiring):
    make, kw = STRATEGY_PLANS[case]
    strategy = case.split("_")[0]
    m, x = _semiring_data(make(), semiring, seed=4)
    ja, pa = both(m)
    pad = float(jsr.get(semiring).zero)
    jp = jplan.build_sell_plan(ja, pad_value=pad, **kw)
    port = pplan.build_sell_plan(pa, pad_value=pad, **kw)
    assert_plans_equal(port, jp)
    if case == "resident_uniform_parts":
        assert port.stats.group_fold and port.stats.uniform_parts
    if case in ("resident", "deep"):
        assert port.stats.window_blocks == 0
        assert pstrategy.select_strategy(port) == strategy
    want = jsell.spmv_plan(jp.to_device(), x, strategy=strategy,
                           interpret=True, semiring=semiring)
    y = psell.spmv_plan(pplan.place(port, "cpu"), torch.from_numpy(x),
                        strategy=strategy, semiring=semiring).numpy()
    _assert_matches(y, want, semiring)
    if semiring == "plus_times":
        want64 = jref.spmv_numpy(ja, x.astype(np.float64))
        assert np.abs(y - want64).max() / \
            max(1.0, np.abs(want64).max()) < 1e-4


@pytest.mark.parametrize("fold", [True, False])
def test_sell_global_plain_folds_groups(fold):
    """The plain version sums each slice's run of tiles; with the lane
    fold (two uniform parts) it folds them to y's rows, else it returns
    the slice sums; columns past x read as 0."""
    rng = np.random.default_rng(7)
    vals = torch.from_numpy(rng.standard_normal((8, 8, 128)).astype(
        np.float32))
    cols = torch.from_numpy(rng.integers(0, 110, (8, 8, 128)).astype(
        np.int32))
    tile_slice = torch.tensor([0, 0, 1, 1, 1, 2, 3, 3], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal(100).astype(np.float32))
    got = psell.sell_global_kernel(vals, cols, tile_slice, x, num_slices=4,
                                   parts=2 if fold else 0, rows=250,
                                   semiring="plus_times")
    xz = torch.cat([x, torch.zeros(10)])
    tiles = (vals * xz[cols.long()]).sum(1)
    slices = torch.zeros(4, 128).index_add_(0, tile_slice, tiles)
    want = (slices[:, :64] + slices[:, 64:]).reshape(-1)[:250] if fold \
        else slices
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_sell_global_kernel_checks_operands():
    vals = torch.zeros(8, 8, 128)
    cols = torch.zeros(8, 8, 128, dtype=torch.int32)
    ts = torch.zeros(8, dtype=torch.int32)
    kw = dict(num_slices=1, parts=1, rows=128, semiring="plus_times")
    with pytest.raises(ValueError, match="int32"):
        psell.sell_global_kernel(vals, cols.to(torch.int16), ts,
                                 torch.ones(4), **kw)
    with pytest.raises(NotImplementedError, match="float32"):
        psell.sell_global_kernel(vals.double(), cols, ts, torch.ones(4),
                                 **kw)
    with pytest.raises(ValueError, match="must be equal"):
        psell.sell_global_kernel(vals[:4], cols, ts, torch.ones(4), **kw)
    with pytest.raises(ValueError, match="tile_slice"):
        psell.sell_global_kernel(vals, cols, ts.long(), torch.ones(4), **kw)
    with pytest.raises(ValueError, match="parts"):
        psell.sell_global_kernel(vals, cols, ts, torch.ones(4), num_slices=1,
                                 parts=3, rows=42, semiring="plus_times")
    with pytest.raises(ValueError, match="cover"):
        psell.sell_global_kernel(vals, cols, ts, torch.ones(4), num_slices=1,
                                 parts=2, rows=65, semiring="plus_times")


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("ncols", [5001, 8192, 12289, 1 << 18, 1 << 19,
                                   (1 << 19) + 1])
def test_global_plain_at_x_widths(ncols, semiring):
    """Kernel G's plain version equals the host loop at the x widths of
    the cached tier 2 (5,001), around the resident cap (8192 floats), at
    the deep draw (2^18) and on either side of the stream draw (2^19)."""
    rng = np.random.default_rng(ncols)
    rows = 512
    r = np.repeat(np.arange(rows), 8)
    c = rng.integers(0, ncols, r.shape[0])
    v = np.abs(rng.standard_normal(r.shape[0])).astype(np.float32)
    m = sp.csr_matrix((v, (r, c)), shape=(rows, ncols))
    m.sum_duplicates()
    m.sort_indices()
    x = np.abs(rng.standard_normal(ncols)).astype(np.float32)
    _, pa = both(m)
    plan = pplan.place(pplan.build_sell_plan(
        pa, pad_value=float(jsr.get(semiring).zero)), "cpu")
    parts = psell.row_parts(plan)
    y = psell.sell_global_kernel(plan.vals, plan.cols, plan.tile_slice,
                                 torch.from_numpy(x),
                                 num_slices=plan.num_slices, parts=parts,
                                 rows=rows, semiring=semiring)
    y = (y if parts else psell._fixup_rows(plan, y, semiring)).numpy()
    if semiring == "plus_times":
        want = m.astype(np.float64) @ x.astype(np.float64)
        assert np.abs(y - want).max() / max(1.0, np.abs(want).max()) < 1e-5
    else:
        want = np.minimum.reduceat(m.data + x[m.indices], m.indptr[:-1])
        np.testing.assert_array_equal(y, want)


#: kernel G's row layouts: matrix, build_sell_plan arguments, the
#: reference's strategy, and what G writes (row_parts: 1 identity map, 2
#: the uniform-parts lane fold, 0 slice sums for the row_map reduce)
G_LAYOUTS = {
    "identity": (lambda: random_sparse(300, 40960, 0.002, seed=2), {},
                 "deep", 1),
    "uniform_parts": (lambda: shuffled_band(2048, seed=5),
                      dict(split=16, uniform_split=True, window_group_tiles=2,
                           groups_per_step=8), "resident", 2),
    "row_map": (lambda: random_sparse(300, 40960, 0.01, seed=6),
                dict(split=8, sigma=64), "stream", 0),
}


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("layout", sorted(G_LAYOUTS))
def test_global_kernel_output_matches_jax(layout, semiring):
    """Kernel G's plain version writes y's rows (or the slice sums that
    the row_map reduce takes) equal to the JAX spmv_plan's y."""
    make, kw, strategy, parts = G_LAYOUTS[layout]
    m, x = _semiring_data(make(), semiring, seed=5)
    ja, pa = both(m)
    pad = float(jsr.get(semiring).zero)
    jp = jplan.build_sell_plan(ja, pad_value=pad, **kw)
    port = pplan.place(pplan.build_sell_plan(pa, pad_value=pad, **kw), "cpu")
    assert_plans_equal(port, jp)
    assert psell.row_parts(port) == parts
    out = psell.sell_global_kernel(port.vals, port.cols, port.tile_slice,
                                   torch.from_numpy(x),
                                   num_slices=port.num_slices, parts=parts,
                                   rows=port.shape[0], semiring=semiring)
    assert out.shape == ((port.shape[0],) if parts else
                         (port.num_slices, port.lane_rows))
    y = out if parts else psell._fixup_rows(port, out, semiring)
    want = jsell.spmv_plan(jp.to_device(), x, strategy=strategy,
                           interpret=True, semiring=semiring)
    _assert_matches(y.numpy(), want, semiring)


# ---------------------------------------------------------------------------
# the CachedPlan apply
# ---------------------------------------------------------------------------

def _small_steps(plan_ref):
    """The JAX plan with one 8-tile group per grid step in every SELL
    tier (see the module docstring); arrays unchanged."""
    name = type(plan_ref).__name__
    if name == "CachedPlan":
        return dataclasses.replace(
            plan_ref, hot=_small_steps(plan_ref.hot),
            cold=None if plan_ref.cold is None else _small_steps(
                plan_ref.cold))
    if name == "SellPlan" and plan_ref.stats.window_blocks > 0:
        return dataclasses.replace(plan_ref, stats=dataclasses.replace(
            plan_ref.stats, groups_per_step=1))
    return plan_ref


@pytest.mark.parametrize("case", sorted(CACHED))
def test_spmv_cached_matches_jax_and_host(case):
    make, _, _ = CACHED[case]
    m = make()
    ja, pa = both(m)
    x = np.random.default_rng(5).standard_normal(m.shape[1]).astype(
        np.float32)
    jp = jcached.build_cached_plan(ja)
    want = jsell.spmv_plan(_small_steps(jp), x, interpret=True)
    port = pplan.place(pcached.build_cached_plan(pa), "cpu")
    y = psell.spmv_plan(port, torch.from_numpy(x)).numpy()
    _assert_matches(y, want, "plus_times")
    want64 = jref.spmv_numpy(ja, x.astype(np.float64))
    assert np.abs(y - want64).max() / max(1.0, np.abs(want64).max()) < 1e-4


@pytest.mark.parametrize("semiring", ["min_plus", "or_and"])
def test_cached_semirings_match_jax(semiring):
    # the recipe of the JAX package's test_cached_semirings
    m = powerlaw_cols(6, rows=16384, cols=32768)
    m.data = np.abs(m.data) + np.float32(0.1)
    if semiring == "or_and":
        m.data = np.ones_like(m.data)
    rng = np.random.default_rng(7)
    x = np.abs(rng.standard_normal(m.shape[1])).astype(np.float32)
    if semiring == "or_and":
        x = (x > 0.8).astype(np.float32)
    ja, pa = both(m)
    jp = jplan.auto_plan(ja, semiring=semiring)
    port = pplan.auto_plan(pa, semiring=semiring)
    assert isinstance(port, pcached.CachedPlan)
    assert_plans_equal(port, jp)
    want = jsell.spmv_plan(_small_steps(jp), x, interpret=True,
                           semiring=semiring)
    y = psell.spmv_plan(pplan.place(port, "cpu"), torch.from_numpy(x),
                        semiring=semiring).numpy()
    _assert_matches(y, want, semiring)


def test_cached_plan_rejects_other_strategies():
    _, pa = both(few_columns())
    plan = pplan.place(pcached.build_cached_plan(pa), "cpu")
    with pytest.raises(ValueError, match="cached"):
        psell.spmv_plan(plan, torch.ones(plan.shape[1]), strategy="deep")


# ---------------------------------------------------------------------------
# caps and the stream warning
# ---------------------------------------------------------------------------

def _wide_plans(blocks):
    cols = blocks * 128
    m = random_sparse(32, cols, 0.0004, seed=8)
    ja, pa = both(m)
    return jplan.build_sell_plan(ja), pplan.build_sell_plan(pa), cols


def test_resident_cap_raises_as_reference():
    jp, port, cols = _wide_plans(pplan.RESIDENT_MAX_BLOCKS + 1)
    x = np.ones(cols, np.float32)
    with pytest.raises(ValueError, match="RESIDENT_MAX_BLOCKS"):
        jsell.spmv_plan(jp, x, strategy="resident", interpret=True)
    with pytest.raises(ValueError, match="RESIDENT_MAX_BLOCKS"):
        psell.spmv_plan(pplan.place(port, "cpu"), torch.from_numpy(x),
                        strategy="resident")


def test_deep_cap_raises_as_reference():
    jp, port, cols = _wide_plans(pplan.DEEP_MAX_BLOCKS + 1)
    x = np.ones(cols, np.float32)
    with pytest.raises(ValueError, match="DEEP_MAX_BLOCKS"):
        jsell.spmv_plan(jp, x, strategy="deep", interpret=True)
    with pytest.raises(ValueError, match="DEEP_MAX_BLOCKS"):
        psell.spmv_plan(pplan.place(port, "cpu"), torch.from_numpy(x),
                        strategy="deep")


def test_stream_warns_as_reference():
    jp, port, cols = _wide_plans(pplan.DEEP_MAX_BLOCKS + 1)
    for select, plan in ((jstrategy.select_strategy, jp),
                         (pstrategy.select_strategy, port)):
        with pytest.warns(RuntimeWarning, match="stream"):
            assert select(plan) == "stream"
    x = np.random.default_rng(9).standard_normal(cols).astype(np.float32)
    with pytest.warns(RuntimeWarning, match="stream"):
        want = jsell.spmv_plan(jp, x, interpret=True)
    with pytest.warns(RuntimeWarning, match="stream"):
        y = psell.spmv_plan(pplan.place(port, "cpu"), torch.from_numpy(x))
    _assert_matches(y.numpy(), want, "plus_times")
    # an explicit strategy="stream" is the caller's choice: no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        psell.spmv_plan(pplan.place(port, "cpu"), torch.from_numpy(x),
                        strategy="stream")


# ---------------------------------------------------------------------------
# operator, counters and interop
# ---------------------------------------------------------------------------

def test_operator_on_cached_plan_matches_jax():
    m = powerlaw_cols(10, rows=8192, cols=32768)
    ja, pa = both(m)
    x = np.random.default_rng(11).standard_normal(m.shape[1]).astype(
        np.float32)
    jop = joperator.SparseOperator.from_matrix(ja)
    op = SparseOperator.from_matrix(pa, device="cpu")
    assert isinstance(op.plan, pcached.CachedPlan)
    assert op.strategy == jop.strategy == "cached"
    assert op.device == torch.device("cpu")
    assert_plans_equal(op.plan, jop.plan)
    drop = ("plan_seconds", "detect_seconds", "build_seconds",
            "place_seconds", "discarded_build_seconds")
    got = {k: v for k, v in op.stats.as_dict().items() if k not in drop}
    assert got == {k: v for k, v in jop.stats.as_dict().items()
                   if k not in drop}
    assert got["strategy_cached"] == 1 and 0 < got["cache_coverage"] <= 1
    assert got["hot_hits"] + got["cold_misses"] == m.nnz
    assert pstrategy.execution_counters(op.plan) == \
        jstrategy.execution_counters(jop.plan)
    assert pstrategy.plan_bytes_per_apply(op.plan) == \
        jstrategy.plan_bytes_per_apply(jop.plan)
    y = op @ x
    want = jsell.spmv_plan(_small_steps(jop.plan), x, interpret=True)
    _assert_matches(y.numpy(), want, "plus_times")


@pytest.mark.parametrize("strategy", ["resident", "deep", "stream"])
def test_global_strategy_counters_match_jax(strategy):
    ja, pa = both(random_sparse(300, 1500, 0.02, seed=1))
    jp, port = jplan.build_sell_plan(ja), pplan.build_sell_plan(pa)
    assert pstrategy.execution_counters(port, strategy) == \
        jstrategy.execution_counters(jp, strategy)
    assert pstrategy.plan_bytes_per_apply(port, strategy) == \
        jstrategy.plan_bytes_per_apply(jp, strategy)


def test_plan_from_reference_carries_nested_cached_plan():
    ja, _ = both(CACHED["powerlaw_full_cover"][0]())
    jp = jcached.build_cached_plan(ja)
    assert isinstance(jp.cold, jcached.CachedPlan) and jp.cold.cold is None
    port = plan_from_reference(jp.to_device(), "cpu")
    assert isinstance(port.cold, pcached.CachedPlan) and port.cold.cold is None
    assert isinstance(port.coverage, float) and port.coverage == jp.coverage
    assert isinstance(port.hot_cols, torch.Tensor)
    assert port.cold.hot.vals.device == torch.device("cpu")
    host = plan_to_numpy(port)
    assert host.hot_cols.tobytes() == np.asarray(jp.hot_cols).tobytes()
    assert host.cold.hot.cols.tobytes() == \
        np.asarray(jp.cold.hot.cols).tobytes()
    assert_plans_equal(host, jp)
