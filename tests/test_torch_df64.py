"""Port parity for the double-precision SpMV path (``value_dtype=np.float64``).

The same matrix and x, made from a seed with numpy, go through the JAX
package (its double-float Pallas kernels in interpret mode on the CPU,
window plans with one 8-tile group per grid step as ``_small_steps``
does, so that the interpreted kernels compile in seconds) and through
the port (kernels J, K and L's plain PyTorch versions on CPU tensors).

* the df64 helpers: ``split_f64``/``join_f64`` byte-equal, the error-free
  transforms bit for bit;
* double plans byte-equal to the reference's (``build_sell_plan``,
  ``build_dia_plan``, ``auto_plan``), ``estimate_seconds`` and the
  strategy counters equal, and the reference's ``ValueError``s;
* y of ``spmv_dia_double``/``spmv_dia_df``, ``spmv_sell_double`` (every
  strategy) and ``spmv_sell_double_pair``, and of
  ``SparseOperator.from_matrix(a, value_dtype=np.float64) @ x``, against
  the JAX functions and scipy float64;
* the reference faults the port repairs (ROADMAP queue 3).

Tolerances are the reference's own (``tests/test_df64.py``): rtol 1e-11
and atol 1e-13 * max(1, max|want|), and a median relative error below
1e-13.  The port sums in FP64 and the reference in f32 pairs (about
2^-48 relative), so the two agree to the reference's accuracy.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu.formats import costmodel as jcost
from spmv_vector_cache_tpu.formats import dia as jdia
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import df64 as jdf64
from spmv_vector_cache_tpu.ops import operator as joperator
from spmv_vector_cache_tpu.ops import spmv_dia as jspmv_dia
from spmv_vector_cache_tpu.ops import spmv_pallas as jsell
from spmv_vector_cache_tpu.ops import strategy as jstrategy
from spmv_vector_cache_tpu_torch.formats import costmodel as pcost
from spmv_vector_cache_tpu_torch.formats import dia as pdia
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.interop import plan_from_reference
from spmv_vector_cache_tpu_torch.ops import df64 as pdf64
from spmv_vector_cache_tpu_torch.ops import spmv_dia as pspmv_dia
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops import strategy as pstrategy
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from spmv_vector_cache_tpu_torch.ops.spmm_sell import has_fused_spmm
from tests.test_torch_plan import (assert_plans_equal, banded, both, hybrid,
                                   random_sparse, shuffled_band)


def f64(m, seed=0):
    """The matrix with float64 N(0, 1) values from a seeded generator
    (every value carries a non-zero low word)."""
    m = m.astype(np.float64)
    m.data = np.random.default_rng(seed).standard_normal(m.data.shape[0])
    return m


def skewed(n=4096, cols=1024, seed=11):
    """Every 100th row 512 long, the others 4: a split SellPlan (f64
    never takes the ChunkPlan)."""
    rng = np.random.default_rng(seed)
    lens = np.where(np.arange(n) % 100 == 0, cols // 2, 4)
    r = np.repeat(np.arange(n, dtype=np.int64), lens)
    c = rng.integers(0, cols, r.shape[0])
    m = sp.csr_matrix((np.ones(r.shape[0]), (r, c)), shape=(n, cols))
    m.sum_duplicates()
    m.sort_indices()
    return f64(m, seed)


def assert_f64_close(got, want):
    """The reference's df64 gate (``tests/test_df64.py``)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=1e-11, atol=1e-13 * max(1.0, np.abs(want).max()))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert np.median(rel) < 1e-13


def small_steps(plan_ref):
    """The JAX plan with one 8-tile group per grid step in its SELL
    parts (what the interpreted kernel is blocked by, not what it
    computes)."""
    kind = type(plan_ref).__name__
    if kind == "HybridPlan":
        return dataclasses.replace(plan_ref, rest=small_steps(plan_ref.rest))
    if kind == "SellPlan":
        return dataclasses.replace(plan_ref, stats=dataclasses.replace(
            plan_ref.stats, groups_per_step=1))
    return plan_ref


def x_of(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


# ---------------------------------------------------------------------------
# df64 helpers
# ---------------------------------------------------------------------------

def test_split_join_byte_equal():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096) * np.exp(rng.standard_normal(4096) * 8)
    hi, lo = pdf64.split_f64(a)
    jhi, jlo = jdf64.split_f64(a)
    for p, j in ((hi, jhi), (lo, jlo)):
        assert (p.dtype, p.tobytes()) == (j.dtype, j.tobytes())
    back = pdf64.join_f64(hi, lo)
    assert back.tobytes() == jdf64.join_f64(jhi, jlo).tobytes()
    np.testing.assert_allclose(back, a, rtol=2e-14, atol=0)
    # the tensor forms give the same words, and join them exactly
    th, tl = pdf64.split(torch.from_numpy(a))
    assert th.numpy().tobytes() == hi.tobytes()
    assert tl.numpy().tobytes() == lo.tobytes()
    assert pdf64.join(th, tl).numpy().tobytes() == back.tobytes()


@pytest.mark.parametrize("fn", ["two_sum", "quick_two_sum", "veltkamp_split",
                                "two_prod", "add", "mul"])
def test_error_free_transforms_match_jax(fn):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    a = rng.standard_normal(1024)
    b = rng.standard_normal(1024) * 1e-6
    if fn in ("add", "mul"):
        args = [*jdf64.split_f64(a), *jdf64.split_f64(b)]
    elif fn == "veltkamp_split":
        args = [a.astype(np.float32)]
    else:
        args = [a.astype(np.float32), b.astype(np.float32)]
    got = getattr(pdf64, fn)(*[torch.from_numpy(v) for v in args])
    want = getattr(jdf64, fn)(*[jnp.asarray(v) for v in args])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert g.numpy().tobytes() == np.asarray(w).tobytes(), fn
    if fn in ("two_sum", "two_prod"):
        # error-free: the pair holds the exact float64 result
        exact = (args[0].astype(np.float64) + args[1]) if fn == "two_sum" \
            else args[0].astype(np.float64) * args[1]
        np.testing.assert_array_equal(pdf64.join(*got).numpy(), exact)
    if fn in ("add", "mul"):
        x = jdf64.join_f64(*args[:2])
        y = jdf64.join_f64(*args[2:])
        np.testing.assert_allclose(pdf64.join(*got).numpy(),
                                   x + y if fn == "add" else x * y,
                                   rtol=1e-13)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

SELL_CASES = {
    "plain": (lambda: f64(random_sparse(300, 200, 0.05, seed=1), 1), {}),
    "split_sigma": (lambda: f64(random_sparse(400, 300, 0.05, seed=2), 2),
                    dict(split=8, sigma=512)),
    "stripe_width": (lambda: f64(random_sparse(300, 5000, 0.02, seed=4), 4),
                     dict(stripe_width=512, max_window_blocks=4)),
    "uniform_split": (lambda: f64(shuffled_band(2048, seed=3), 3),
                      dict(split=16, uniform_split=True,
                           window_group_tiles=2)),
}


@pytest.mark.parametrize("case", sorted(SELL_CASES))
def test_build_sell_plan_f64_byte_equal(case):
    make, kw = SELL_CASES[case]
    ja, pa = both(make())
    port = pplan.build_sell_plan(pa, value_dtype=np.float64, **kw)
    ref = jplan.build_sell_plan(ja, value_dtype=np.float64, **kw)
    assert port.stats.double and port.vals.dtype == np.float32
    T, P2, R = port.vals.shape
    assert P2 == 2 * port.positions and port.cols.shape == (T, P2 // 2, R)
    assert_plans_equal(port, ref)
    pplan.validate_plan(port, pa)
    assert pcost.estimate_seconds(port) == jcost.estimate_seconds(ref)


@pytest.mark.parametrize("offs,rows,cols", [
    ([-2, -1, 0, 1, 2], 700, 700),
    ([-1025, 0, 1300], 3000, 3000),
    ([0, 200], 300, 520),
])
def test_build_dia_plan_f64_byte_equal(offs, rows, cols):
    ja, pa = both(f64(banded(rows, offs, seed=7, cols=cols), 7))
    port = pdia.build_dia_plan(pa, sublanes=8, value_dtype=np.float64)
    ref = jdia.build_dia_plan(ja, sublanes=8, value_dtype=np.float64)
    assert port.double and port.vals.shape[1] == 2 * len(offs)
    assert_plans_equal(port, ref)
    assert pcost.estimate_seconds(port) == jcost.estimate_seconds(ref)


#: matrices whose f64 auto_plan gives each double plan family, with the
#: strategy the operator picks
AUTO_CASES = {
    "dia": (lambda: f64(banded(4096, list(range(-13, 14)), seed=8), 8),
            "DiaPlan", "dia"),
    "hybrid": (lambda: f64(hybrid(8192, seed=10), 10), "HybridPlan", "dia"),
    "window": (lambda: f64(shuffled_band(4096, seed=9), 9), "SellPlan",
               "window"),
    "windowless": (lambda: f64(random_sparse(2048, 20000, 0.001, seed=3), 3),
                   "SellPlan", "deep"),
    "skewed": (skewed, "SellPlan", "window"),
}


def _auto(case):
    make, kind, strategy = AUTO_CASES[case]
    m = make()
    ja, pa = both(m)
    ref = jplan.auto_plan(ja, value_dtype=np.float64)
    port = pplan.auto_plan(pa, value_dtype=np.float64)
    assert type(port).__name__ == type(ref).__name__ == kind
    return m, ja, pa, ref, port, strategy


@pytest.mark.parametrize("case", sorted(AUTO_CASES))
def test_auto_plan_f64_same_plan(case):
    _, _, _, ref, port, strategy = _auto(case)
    assert_plans_equal(port, ref)
    sell = port.rest if case == "hybrid" else port
    if case != "dia":
        assert sell.stats.double
        assert (sell.stats.window_blocks > 0) == (case != "windowless")
    if case == "skewed":
        assert sell.stats.num_splits > 0
    assert pcost.estimate_seconds(port) == jcost.estimate_seconds(ref)
    assert pstrategy.select_strategy(port) == \
        jstrategy.select_strategy(ref) == strategy
    for s in ("auto", strategy):
        assert pstrategy.plan_bytes_per_apply(port, s) == \
            jstrategy.plan_bytes_per_apply(ref, s)
        assert pstrategy.execution_counters(port, s) == \
            jstrategy.execution_counters(ref, s)


def test_double_plans_raise_as_the_reference():
    _, pa = both(f64(random_sparse(300, 200, 0.05, seed=1), 1))
    with pytest.raises(ValueError, match="pad_value"):
        pplan.build_sell_plan(pa, value_dtype=np.float64,
                              pad_value=float("inf"))
    with pytest.raises(ValueError, match="power-of-two"):
        pplan.build_sell_plan(pa, value_dtype=np.float64, positions=6)
    plan = pplan.place(pplan.build_sell_plan(pa, value_dtype=np.float64),
                       "cpu")
    x = torch.ones(200, dtype=torch.float64)
    with pytest.raises(ValueError, match="plus_times"):
        psell.spmv_plan(plan, x, semiring="max_plus")
    with pytest.raises(ValueError, match="value_dtype"):
        psell.spmv_sell_double(pplan.place(pplan.build_sell_plan(pa),
                                           "cpu"), x)
    dplan = pplan.place(pdia.build_dia_plan(
        both(f64(banded(300, [0, 1], seed=2), 2))[1],
        value_dtype=np.float64), "cpu")
    with pytest.raises(ValueError, match="spmv_dia_double"):
        pspmv_dia.spmv_dia(dplan, torch.ones(300))


# ---------------------------------------------------------------------------
# execution: the double kernels' plain versions against JAX and scipy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offs,rows", [
    ([-2, -1, 0, 1, 2], 4096),
    ([-1025, 0, 1300], 3000),            # offsets past either end
])
def test_spmv_dia_double_and_pair_match_jax(offs, rows):
    m = f64(banded(rows, offs, seed=5), 5)
    ja, _ = both(m)
    jp = jdia.build_dia_plan(ja, sublanes=8, value_dtype=np.float64)
    pp = plan_from_reference(jp, "cpu")
    x = x_of(rows, 6)
    want = m @ x
    y = pspmv_dia.spmv_dia_double(pp, torch.from_numpy(x))
    assert y.dtype == torch.float64
    assert_f64_close(y.numpy(), want)
    assert_f64_close(y.numpy(), jspmv_dia.spmv_dia_double(jp, x,
                                                           interpret=True))
    # the pair API: the port's pair joins to within the JAX pair's join
    xh, xl = jdf64.split_f64(x)
    yh, yl = pspmv_dia.spmv_dia_df(pp, torch.from_numpy(xh),
                                   torch.from_numpy(xl))
    assert yh.dtype == yl.dtype == torch.float32
    jyh, jyl = jspmv_dia.spmv_dia_df(jp, xh, xl, interpret=True)
    assert_f64_close(pdf64.join(yh, yl).numpy(),
                     jdf64.join_f64(np.asarray(jyh), np.asarray(jyl)))
    assert_f64_close(pdf64.join(yh, yl).numpy(), want)


#: (matrix, build_sell_plan kwargs) of the SELL execution cases
EXEC_CASES = {
    "window_fold": (lambda: f64(shuffled_band(2048, seed=12), 12),
                    dict(split=16, uniform_split=True,
                         window_group_tiles=2)),
    "window_row_map": (lambda: f64(random_sparse(700, 600, 0.02, seed=13),
                                   13), dict(split=8, sigma=512)),
    "windowless": (lambda: f64(random_sparse(1024, 20000, 0.001, seed=14),
                               14), {}),
}


@pytest.mark.parametrize("case", sorted(EXEC_CASES))
def test_spmv_sell_double_matches_jax(case):
    make, kw = EXEC_CASES[case]
    m = make()
    ja, _ = both(m)
    jp = jplan.build_sell_plan(ja, value_dtype=np.float64, **kw)
    windowed = case != "windowless"
    assert (jp.stats.window_blocks > 0) == windowed
    pp = plan_from_reference(jp, "cpu")
    x = x_of(m.shape[1], 15)
    want = m @ x
    jstrats = ("window", "stream") if windowed else ("stream",)
    for s in jstrats:
        jy = jsell.spmv_sell_double(small_steps(jp), x, strategy=s,
                                    interpret=True)
        y = psell.spmv_sell_double(pp, torch.from_numpy(x), strategy=s)
        assert y.dtype == torch.float64
        assert_f64_close(y.numpy(), jy)
        assert_f64_close(y.numpy(), want)
    # the strategies the operator hands a windowless plan, which the
    # reference's double path rejects, run kernel L
    for s in ("auto", "resident", "deep"):
        y = psell.spmv_sell_double(pp, torch.from_numpy(x), strategy=s)
        assert_f64_close(y.numpy(), want)
    # the pair API joins to within the JAX pair's join
    xh, xl = jdf64.split_f64(x)
    jyh, jyl = jsell.spmv_sell_double_pair(small_steps(jp), xh, xl,
                                           interpret=True)
    yh, yl = psell.spmv_sell_double_pair(pp, torch.from_numpy(xh),
                                         torch.from_numpy(xl))
    assert yh.dtype == yl.dtype == torch.float32
    assert_f64_close(pdf64.join(yh, yl).numpy(),
                     jdf64.join_f64(np.asarray(jyh), np.asarray(jyl)))


def _long_rows(n=1024, cols=40000, seed=22):
    """Every 100th row 600 long, the others 4, at uniform columns: a
    windowless plan whose long rows' slices hold 75 tiles, past RUN_CAP."""
    rng = np.random.default_rng(seed)
    lens = np.where(np.arange(n) % 100 == 0, 600, 4)
    r = np.repeat(np.arange(n, dtype=np.int64), lens)
    m = sp.csr_matrix((np.ones(r.shape[0]),
                       (r, rng.integers(0, cols, r.shape[0]))),
                      shape=(n, cols))
    m.sum_duplicates()
    m.sort_indices()
    return f64(m, seed)


#: windowless double plans: (matrix, build_sell_plan kwargs, what kernel L
#: writes: "rows" through the identity map or a lane fold of uniform
#: parts, "slices" for a general row_map)
WINDOWLESS_CASES = {
    "identity": (lambda: f64(random_sparse(1024, 20000, 0.001, seed=23), 23),
                 {}, "rows"),
    "uniform_parts": (lambda: f64(random_sparse(1024, 40000, 0.0004,
                                                seed=24), 24),
                      dict(split=8, uniform_split=True), "rows"),
    "row_map": (lambda: f64(random_sparse(700, 30000, 0.001, seed=25), 25),
                dict(split=8, sigma=512), "slices"),
    "long_slice": (_long_rows, {}, "rows"),
}


@pytest.mark.parametrize("case", sorted(WINDOWLESS_CASES))
def test_windowless_double_plans_match_jax(case):
    # kernel L (its plain version here) on every windowless route, against
    # the JAX pair API's stream path and the float64 host loop
    from spmv_vector_cache_tpu.ops import reference as jref
    from spmv_vector_cache_tpu_torch.formats import tables as ptables

    make, kw, writes = WINDOWLESS_CASES[case]
    m = make()
    ja, _ = both(m)
    jp = jplan.build_sell_plan(ja, value_dtype=np.float64, **kw)
    assert jp.stats.window_blocks == 0
    pp = plan_from_reference(jp, "cpu")
    parts = psell.row_parts(pp)
    assert (parts > 0) == (writes == "rows")
    if case == "uniform_parts":
        assert parts == pp.stats.uniform_parts > 1
    if case == "long_slice":
        # the long rows' slices are split over records, combined atomically
        tiles = np.bincount(pp.tile_slice.numpy())
        assert tiles.max() > ptables.RUN_CAP
        assert pp.work.split
    x = x_of(m.shape[1], 26)
    xh, xl = jdf64.split_f64(x)
    jyh, jyl = jsell.spmv_sell_double_pair(jp, xh, xl, strategy="stream",
                                           interpret=True)
    want_jax = jdf64.join_f64(np.asarray(jyh), np.asarray(jyl))
    want_host = jref.spmv_numpy(ja, x)
    for strategy in ("resident", "deep", "stream"):
        y = psell.spmv_sell_double(pp, torch.from_numpy(x),
                                   strategy=strategy)
        assert y.dtype == torch.float64 and y.shape == (m.shape[0],)
        assert_f64_close(y.numpy(), want_jax)
        assert_f64_close(y.numpy(), want_host)
    # the kernel's own output: y's rows, or the slice sums that the
    # row_map reduce folds; its per-tile sums match the JAX kernel's
    out = psell.sell_global_f64_kernel(
        pp.vals, pp.cols, pp.tile_slice, torch.from_numpy(x),
        num_slices=pp.num_slices, parts=parts, rows=pp.shape[0])
    assert out.shape == ((pp.shape[0],) if parts else
                         (pp.num_slices, pp.lane_rows))
    th, tl = jsell._spmv_stream_df(small_steps(jp), xh, xl, interpret=True)
    tile_sums = psell._tile_sums(pdf64.join_channels(pp.vals), pp.cols,
                                 torch.from_numpy(x), "plus_times")
    assert_f64_close(tile_sums.numpy(),
                     jdf64.join_f64(np.asarray(th), np.asarray(tl)))


def test_sell_double_folds_like_the_window_kernel():
    # kernel K folds per group where kernel B does; per-tile and
    # per-group partials reduce to the same y
    m = f64(shuffled_band(2048, seed=16), 16)
    _, pa = both(m)
    plan = pplan.place(pplan.build_sell_plan(
        pa, value_dtype=np.float64, split=16, uniform_split=True,
        window_group_tiles=2), "cpu")
    assert psell.folds_groups(plan)
    st = plan.stats
    x = torch.from_numpy(x_of(2048, 17))
    args = (plan.vals, plan.cols_win, plan.window_base, x)
    kw = dict(group_tiles=st.group_tiles, window_grain=st.window_grain)
    per_group = psell.sell_window_f64_kernel(*args, fold=True, **kw)
    per_tile = psell.sell_window_f64_kernel(*args, fold=False, **kw)
    assert per_group.shape == (st.num_tiles // st.group_tiles, 128)
    y_g = psell._reduce_partials(plan, per_group, per_group=True)
    y_t = psell._reduce_partials(plan, per_tile)
    assert_f64_close(y_g.numpy(), m @ x.numpy())
    assert_f64_close(y_t.numpy(), y_g.numpy())
    # kernel L on the window plan's global columns gives the same y: the
    # plan's rows through its uniform-parts lane fold
    parts = psell.row_parts(plan)
    assert parts == st.uniform_parts > 1
    y_l = psell.sell_global_f64_kernel(
        plan.vals, plan.cols, plan.tile_slice, x,
        num_slices=plan.num_slices, parts=parts, rows=plan.shape[0])
    assert_f64_close(y_l.numpy(), y_g.numpy())


# ---------------------------------------------------------------------------
# the slice as a whole: SparseOperator.from_matrix(a, value_dtype=f64) @ x
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dia", "hybrid", "window", "windowless"])
def test_operator_f64_matches_jax_and_scipy(case):
    make, kind, strategy = AUTO_CASES[case]
    m = make()
    ja, pa = both(m)
    jop = joperator.SparseOperator.from_matrix(ja, value_dtype=np.float64)
    op = SparseOperator.from_matrix(pa, value_dtype=np.float64,
                                    device="cpu")
    assert type(op.plan).__name__ == type(jop.plan).__name__ == kind
    assert op.strategy == jop.strategy == strategy
    assert_plans_equal(op.plan, jop.plan)
    drop = ("plan_seconds", "detect_seconds", "build_seconds",
            "place_seconds", "discarded_build_seconds")
    want_stats = {k: v for k, v in jop.stats.as_dict().items()
                  if k not in drop}
    got_stats = {k: v for k, v in op.stats.as_dict().items()
                 if k not in drop}
    assert got_stats == want_stats
    x = x_of(m.shape[1], 18)
    y = op @ x
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float64
    assert_f64_close(y.numpy(), m @ x)
    # what the port is held against: the reference's spmv_plan with the
    # default strategy (its operator's apply fails or truncates x, below)
    want = np.asarray(jsell.spmv_plan(small_steps(jop.plan), x,
                                      interpret=True))
    assert_f64_close(y.numpy(), want)
    # a float32 x is widened, not split: y is the f64 product of its values
    x32 = x.astype(np.float32)
    assert_f64_close((op @ x32).numpy(), m @ x32.astype(np.float64))


def test_matmat_on_a_double_plan_raises_before_anything_runs():
    for case in ("dia", "hybrid", "windowless"):
        _, pa = both(AUTO_CASES[case][0]())
        op = SparseOperator.from_matrix(pa, value_dtype=np.float64,
                                        device="cpu")
        assert not has_fused_spmm(op.plan)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            op @ np.ones((op.shape[1], 4))


# ---------------------------------------------------------------------------
# reference faults (ROADMAP queue 3), shown
# ---------------------------------------------------------------------------

def test_reference_operator_truncates_x_port_does_not():
    # the JAX operator's jnp.asarray(x) casts an f64 x to f32 (x64 off)
    m = f64(banded(4096, [-2, -1, 0, 1, 2], seed=19), 19)
    ja, pa = both(m)
    x = x_of(4096, 20)
    want = m @ x
    scale = max(1.0, np.abs(want).max())
    jop = joperator.SparseOperator.from_matrix(ja, value_dtype=np.float64)
    assert type(jop.plan).__name__ == "DiaPlan"
    jerr = np.abs(np.asarray(jop @ x, np.float64) - want).max() / scale
    assert jerr > 1e-9
    op = SparseOperator.from_matrix(pa, value_dtype=np.float64, device="cpu")
    assert np.abs((op @ x).numpy() - want).max() / scale < 1e-13


@pytest.mark.parametrize("case", ["windowless", "hybrid"])
def test_reference_operator_raises_port_runs(case):
    # windowless: select_strategy gives 'deep', which spmv_sell_double
    # does not know; hybrid: 'dia' is passed on to the SELL residual
    m = AUTO_CASES[case][0]()
    ja, pa = both(m)
    jop = joperator.SparseOperator.from_matrix(ja, value_dtype=np.float64)
    x = x_of(m.shape[1], 21)
    with pytest.raises(ValueError, match="unknown strategy"):
        jop @ x
    op = SparseOperator.from_matrix(pa, value_dtype=np.float64, device="cpu")
    assert_f64_close((op @ x).numpy(), m @ x)
