"""Port parity: SpMM, ``Y = A @ B`` with B of shape (cols, k), against the
JAX package's.

* ``spmm_dia`` (kernel I's plain version) against the JAX ``spmm_dia``
  (its Pallas kernel in interpret mode) on the JAX DIA SpMM tests'
  shapes, and against JAX ``reference.spmm`` past the width where the
  JAX kernel's VMEM budget refuses the plan;
* ``spmm_plan`` on window SellPlans (kernel H's plain version, which
  sums each slice's tiles and folds its lanes, and the ``row_map``
  reduce over a trailing k axis) against the JAX ``spmm_plan``, with
  identity and row_map fixups, a folded uniform-parts layout, and window
  grains 128 and 32; kernel H's output against kernel B's partials
  reduced the same way, column by column; kernel H's work list
  (``tile_runs``) against ``tile_slice``;
* ``spmm_plan`` on a HybridPlan and on a CooTail;
* ``SparseOperator.matmat`` for every plan family, and its refusals.

The JAX window plans run with one grid step per 8 tiles
(``groups_per_step=1``, or ``_small_steps``): the grid step sets only how
the interpreted kernel is blocked, not what it computes, and a small one
keeps the interpreted kernels quick to compile.  Plans are carried over
with ``plan_from_reference`` or checked byte-equal.  Tolerance: rtol =
atol = 2e-5 against JAX (float32, the JAX SpMM tests' own bound) and
against the float64 product.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spmv_vector_cache_tpu.formats import cached as jcached
from spmv_vector_cache_tpu.formats import dia as jdia
from spmv_vector_cache_tpu.formats import packed as jpacked
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import operator as joperator
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops import spmm_dia as jspmm_dia
from spmv_vector_cache_tpu.ops import spmm_pallas as jspmm
from spmv_vector_cache_tpu_torch.formats import cached as pcached
from spmv_vector_cache_tpu_torch.formats import packed as ppacked
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.formats import tables as ptables
from spmv_vector_cache_tpu_torch.interop import plan_from_reference
from spmv_vector_cache_tpu_torch.ops import spmm_dia as pdia
from spmv_vector_cache_tpu_torch.ops import spmm_sell as pspmm
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_cached import few_columns
from tests.test_torch_chunk import pareto_banded
from tests.test_torch_packed import random_csr
from tests.test_torch_plan import (assert_plans_equal, banded, both, hybrid,
                                   random_sparse, shuffled_band)

TOL = dict(rtol=2e-5, atol=2e-5)


def _b(cols, k, seed):
    return np.random.default_rng(seed).standard_normal((cols, k)).astype(
        np.float32)


def _small_steps(plan_ref):
    """A JAX SellPlan with one 8-tile step per grid step."""
    return dataclasses.replace(plan_ref, stats=dataclasses.replace(
        plan_ref.stats, groups_per_step=1))


# ---------------------------------------------------------------------------
# DIA: kernel I
# ---------------------------------------------------------------------------

def _check_dia(m, k, seed):
    ja, _ = both(m)
    jp = jdia.build_dia_plan(ja, sublanes=8)
    b = _b(m.shape[1], k, seed)
    want = np.asarray(jspmm_dia.spmm_dia(jp.to_device(), b))
    pp = plan_from_reference(jp, "cpu")
    bt = torch.from_numpy(b)
    y = pdia.spmm_dia(pp, bt)
    assert y.dtype == torch.float32 and y.shape == (m.shape[0], k)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(y.numpy(), m.astype(np.float64) @ b, **TOL)
    # on a CPU tensor the wrapper is kernel I's plain version
    assert torch.equal(pdia.spmm_dia_kernel(pp.vals, pp.offsets, bt,
                                            m.shape[0]),
                       pdia.spmm_dia_plain(pp.vals, pp.offsets, bt,
                                           m.shape[0]))


@pytest.mark.parametrize("k", [1, 8, 20])
def test_spmm_dia_matches_jax(k):
    # tests/test_dia.py's shape: offsets crossing 128-row boundaries
    _check_dia(banded(900, [-130, -1, 0, 3, 200], seed=1), k, seed=k)


@pytest.mark.parametrize("k", [1, 8, 20])
def test_spmm_dia_rectangular_matches_jax(k):
    _check_dia(banded(300, [0, 200], seed=2, cols=520), k, seed=k + 1)


def test_spmm_dia_past_the_reference_vmem_limit():
    # 2^18 columns: 8 RHS of the JAX x image outgrow its VMEM budget, so
    # the JAX spmm_plan refuses the plan and its operator falls back to
    # reference.spmm; kernel I has no such limit
    n = 1 << 18
    m = banded(n, [-1, 0, 2], seed=3)
    ja, pa = both(m)
    jp = jdia.build_dia_plan(ja)
    assert not jspmm_dia.spmm_dia_feasible(jp)
    b = _b(n, 4, seed=4)
    with pytest.raises(ValueError, match="VMEM"):
        jspmm.spmm_plan(jp, b)
    want = np.asarray(jref.spmm(ja, b))
    pp = plan_from_reference(jp, "cpu")
    y = pspmm.spmm_plan(pp, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(y, want, **TOL)


def test_spmm_dia_rejects_wrong_b():
    _, pa = both(banded(300, [0, 1], seed=5))
    from spmv_vector_cache_tpu_torch.formats.dia import build_dia_plan

    plan = pplan.place(build_dia_plan(pa, sublanes=8), "cpu")
    with pytest.raises(ValueError, match="B has shape"):
        pdia.spmm_dia(plan, torch.zeros((299, 4)))
    with pytest.raises(ValueError, match="offsets"):
        pdia.spmm_dia_kernel(plan.vals, (0, 1, 2), torch.zeros((300, 4)),
                             300)
    with pytest.raises(NotImplementedError, match="float32"):
        pdia.spmm_dia_kernel(plan.vals, plan.offsets,
                             torch.zeros((300, 4), dtype=torch.float64), 300)


#: bench.py's 27 diagonals (-13..13)
BENCH_OFFSETS = tuple(range(-13, 14))


@pytest.mark.parametrize("k", [1, 16, 64, 128, 1000])
def test_spmm_dia_tiling_of_the_bench_offsets_is_one_band(k):
    # every k stages bench.py's 27 diagonals as one band, single buffered
    t = pdia.spmm_dia_tiling(BENCH_OFFSETS, k)
    assert t.bands == ((0, 27),) and t.buffers == 1
    assert t.buf_rows == t.rows_per_cta + 26


def test_spmm_dia_tiling_of_far_offsets_is_three_bands():
    # the CUDA tests' [-1025, 0, 1300]: no two diagonals share a band at
    # k = 16, so the CTA stages three, double buffered
    t = pdia.spmm_dia_tiling((-1025, 0, 1300), 16)
    assert t.bands == ((0, 1), (1, 2), (2, 3)) and t.buffers == 2
    assert t.buf_rows == t.rows_per_cta and t.band_diags == 1
    assert t.smem_bytes <= pdia.SPMM_DIA_SMEM
    # at k = 1 a staged row is 16 bytes, and all three fit one buffer
    t1 = pdia.spmm_dia_tiling((-1025, 0, 1300), 1)
    assert t1.bands == ((0, 3),) and t1.buffers == 1


@pytest.mark.parametrize("offsets,spread,diags,want", [
    ((-5, -4, 0, 100, 101, 300), 10, None, ((0, 3), (3, 5), (5, 6))),
    ((-5, -4, 0, 100, 101, 300), 0, None, ((0, 1), (1, 2), (2, 3), (3, 4),
                                           (4, 5), (5, 6))),
    ((-5, -4, 0, 100, 101, 300), 305, None, ((0, 6),)),
    ((0, 0, 7), 6, None, ((0, 2), (2, 3))),
    ((), 10, None, ()),
    (tuple(range(-13, 14)), 26, None, ((0, 27),)),
    (tuple(range(-13, 14)), 26, 8, ((0, 8), (8, 16), (16, 24), (24, 27))),
])
def test_dia_bands_groups_consecutive_diagonals(offsets, spread, diags,
                                                want):
    assert pdia.dia_bands(offsets, spread, diags) == want


def test_dia_bands_rejects_unsorted_offsets():
    with pytest.raises(ValueError, match="nondecreasing"):
        pdia.dia_bands((0, -1), 10)
    with pytest.raises(ValueError, match="max_spread"):
        pdia.dia_bands((0, 1), -1)


@pytest.mark.parametrize("k", [1, 3, 5, 8, 16, 17, 33, 64, 100, 128, 300])
@pytest.mark.parametrize("offsets", [BENCH_OFFSETS, (-1025, 0, 1300),
                                     (-300, -200, -2, 0, 5, 900)])
def test_spmm_dia_tiling_fits_the_kernel(offsets, k):
    t = pdia.spmm_dia_tiling(offsets, k)
    cols = t.threads_per_row * t.cols_per_thread
    assert t.cols_per_thread in (4, 8, 16, 32)
    assert cols >= min(k, pdia.SPMM_DIA_COLS) and cols <= max(
        4, 2 * min(k, pdia.SPMM_DIA_COLS))
    assert t.rows_per_cta * t.threads_per_row <= pdia.SPMM_DIA_THREADS
    # a quarter warp's float4 reads of 8 / tpr rows hit distinct banks
    words = {(r * t.stride + 4 * q) % 32 for r in range(8 // min(
        8, t.threads_per_row)) for q in range(min(8, t.threads_per_row))}
    assert len(words) == 8 and t.stride % 4 == 0 and t.stride >= cols
    assert t.smem_bytes <= pdia.SPMM_DIA_SMEM
    # the bands cover the diagonals in order, each within a buffer
    assert [d for b in t.bands for d in range(*b)] == list(range(len(
        offsets)))
    for d0, d1 in t.bands:
        assert t.rows_per_cta + offsets[d1 - 1] - offsets[d0] <= t.buf_rows
        assert d1 - d0 <= t.band_diags
    assert t.buffers == (1 if len(t.bands) == 1 else 2)


# ---------------------------------------------------------------------------
# SELL window: kernel H
# ---------------------------------------------------------------------------

#: name -> (matrix, build_sell_plan arguments, (identity map, uniform
#: parts, folds groups)); one 8-tile step per grid step
WINDOW_PLANS = {
    "identity": (lambda: random_sparse(400, 300, 0.04, seed=4),
                 dict(groups_per_step=1), (True, 0, False)),
    "row_map": (lambda: random_sparse(400, 200, 0.06, seed=6),
                dict(split=8, sigma=512, groups_per_step=1),
                (False, 0, False)),
    "uniform_fold": (lambda: shuffled_band(2048, seed=5),
                     dict(split=16, uniform_split=True, window_group_tiles=2,
                          groups_per_step=1), (False, 2, True)),
    "grain32": (lambda: banded(1500, [-20, -3, 0, 5, 30], seed=5),
                dict(window_grain=32, groups_per_step=1), (True, 0, False)),
}
WINDOW_CASES = [(name, k) for name in sorted(WINDOW_PLANS)
                for k in (1, 5, 8, 20)]


@pytest.mark.parametrize("case,k", WINDOW_CASES)
def test_spmm_window_matches_jax(case, k):
    make, kw, layout = WINDOW_PLANS[case]
    m = make()
    ja, _ = both(m)
    jp = jplan.build_sell_plan(ja, **kw)
    pp = plan_from_reference(jp, "cpu")
    st = pp.stats
    assert st.window_blocks > 0
    assert (pp.identity_map, st.uniform_parts, psell.folds_groups(pp)) == \
        layout
    assert (st.window_grain == 32) == (case == "grain32")
    b = _b(m.shape[1], k, seed=k)
    want = np.asarray(jspmm.spmm_plan(jp.to_device(), b, interpret=True))
    bt = torch.from_numpy(b)
    y = pspmm.spmm_plan(pp, bt)
    assert y.dtype == torch.float32 and y.shape == (m.shape[0], k)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(y.numpy(), m.astype(np.float64) @ b, **TOL)

    # kernel H's plain version: Y itself where H folds the lanes, else
    # the slice sums that the row_map reduce takes
    parts = psell.row_parts(pp)
    assert parts == (1 if layout[0] else layout[1])
    args = (pp.vals, pp.cols_win, pp.window_base, pp.tile_slice)
    kwargs = dict(num_slices=pp.num_slices, group_tiles=st.group_tiles,
                  window_grain=st.window_grain, parts=parts,
                  rows=m.shape[0])
    out = pspmm.spmm_window_plain(*args, bt, **kwargs)
    y_h = out if parts else psell._fixup_rows(pp, out, "plus_times")
    np.testing.assert_allclose(y_h.numpy(), want, **TOL)
    # ... and, on a CPU tensor, the wrapper
    assert torch.equal(pspmm.spmm_window_kernel(*args, bt, **kwargs), out)
    # kernel H's output is kernel B's per-tile partials reduced the same
    # way, one RHS column at a time
    for j in range(k):
        col = psell.sell_window_plain(
            pp.vals, pp.cols_win, pp.window_base, bt[:, j].contiguous(),
            group_tiles=st.group_tiles, window_grain=st.window_grain,
            fold=False, semiring="plus_times")
        col = psell.sr.PLUS_TIMES.segment_reduce(col, pp.tile_slice,
                                                 num_segments=pp.num_slices)
        if parts:
            col = psell.fold_lanes(col, parts, m.shape[0])
        np.testing.assert_allclose(out[..., j].numpy(), col.numpy(),
                                   rtol=1e-6, atol=1e-6)


def _window_args(plan, parts=0):
    st = plan.stats
    return ((plan.vals, plan.cols_win, plan.window_base, plan.tile_slice),
            dict(num_slices=plan.num_slices, group_tiles=st.group_tiles,
                 window_grain=st.window_grain, parts=parts,
                 rows=plan.shape[0]))


def test_spmm_window_plain_reads_zero_past_b():
    # padding slots and columns past the last row of B read 0
    _, pa = both(shuffled_band(1024, seed=7))
    plan = pplan.place(pplan.build_sell_plan(pa), "cpu")
    b = torch.from_numpy(_b(1024, 3, seed=8))
    args, kw = _window_args(plan)
    short = pspmm.spmm_window_plain(*args, b[:1000].contiguous(), **kw)
    zeroed = b.clone()
    zeroed[1000:] = 0
    full = pspmm.spmm_window_plain(*args, zeroed, **kw)
    assert torch.equal(short, full)


def test_spmm_window_kernel_checks_operands():
    _, pa = both(shuffled_band(1024, seed=9))
    plan = pplan.place(pplan.build_sell_plan(pa), "cpu")
    args, kw = _window_args(plan)
    with pytest.raises(NotImplementedError, match="float32"):
        pspmm.spmm_window_kernel(*args, torch.zeros((1024, 2),
                                                    dtype=torch.float64),
                                 **kw)
    with pytest.raises(ValueError, match="B must be"):
        pspmm.spmm_window_kernel(*args, torch.zeros(1024), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        pspmm.spmm_window_kernel(*args, torch.zeros((2, 1024)).T, **kw)
    with pytest.raises(ValueError, match="tile_slice"):
        pspmm.spmm_window_kernel(*args[:3], args[3][1:],
                                 torch.zeros((1024, 2)), **kw)
    with pytest.raises(ValueError, match="parts"):
        pspmm.spmm_window_kernel(*args, torch.zeros((1024, 2)),
                                 **dict(kw, parts=3))


# ---------------------------------------------------------------------------
# kernel H's work list: the tile run of each slice
# ---------------------------------------------------------------------------

def _runs_cover(runs, tile_slice, num_slices):
    """Every tile summed once, into its own slice; every slice written by
    one plain record or by the pieces of one split slice."""
    ts = np.asarray(tile_slice)
    written = np.zeros(num_slices, np.int64)
    seen = np.zeros(ts.shape[0], np.int64)
    for t0, t1, s0, w in runs.tolist():
        s1 = w & ~ptables.RUN_ATOMIC
        assert t0 <= t1 and s0 < s1
        seen[t0:t1] += 1
        assert ((ts[t0:t1] >= s0) & (ts[t0:t1] < s1)).all()
        if w & ptables.RUN_ATOMIC:
            assert s1 == s0 + 1 and t1 - t0 <= ptables.RUN_CAP
            assert (ts == s0).sum() > ptables.RUN_CAP
        else:
            assert t1 - t0 <= max(ptables.RUN_PACK, ptables.RUN_CAP)
            written[s0:s1] += 1
    assert (seen == 1).all()
    split = {t0 for t0, _, _, w in runs.tolist() if w & ptables.RUN_ATOMIC}
    assert (written[np.bincount(ts, minlength=num_slices) <=
                    ptables.RUN_CAP] == 1).all()
    return split


def test_tile_runs_of_a_padded_plan():
    # build_sell_plan appends the grid step's padding tiles to the last
    # slice: 64 real tiles, 448 padding ones in slice 31, split in 14
    _, pa = both(shuffled_band(2048, seed=5))
    plan = pplan.build_sell_plan(pa, split=16, uniform_split=True,
                                 window_group_tiles=2)
    ts = plan.tile_slice
    assert plan.num_slices == 32 and ts.shape[0] == 512
    assert (ts == 31).sum() == 450
    runs = ptables.tile_runs(ts, plan.num_slices)
    _runs_cover(runs, ts, plan.num_slices)
    pieces = runs[(runs[:, 3] & ptables.RUN_ATOMIC) != 0]
    assert len(pieces) == 15 and (pieces[:, 2] == 31).all()
    assert pieces[0, 0] == 62 and pieces[-1, 1] == 512
    # the other slices, 2 tiles each, two to a record
    plain = runs[(runs[:, 3] & ptables.RUN_ATOMIC) == 0]
    assert plain.tolist()[0] == [0, 4, 0, 2]


def test_tile_runs_of_one_tile_slices():
    ts = np.arange(20, dtype=np.int32)
    runs = ptables.tile_runs(ts, 20)
    _runs_cover(runs, ts, 20)
    assert runs.tolist() == [[t, t + 4, t, t + 4] for t in range(0, 20, 4)]


def test_tile_runs_of_a_run_past_the_cap():
    # slice 1 holds 70 tiles: three pieces of 23-24; slices 3 and 5
    # none, packed with their neighbours (4 tiles at most a record)
    counts = np.array([3, 70, 2, 0, 1, 0, 5])
    ts = np.repeat(np.arange(7, dtype=np.int32), counts)
    runs = ptables.tile_runs(ts, 7)
    _runs_cover(runs, ts, 7)
    atomic = ptables.RUN_ATOMIC
    assert runs.tolist() == [
        [0, 3, 0, 1], [3, 26, 1, 2 | atomic], [26, 49, 1, 2 | atomic],
        [49, 73, 1, 2 | atomic], [73, 76, 2, 6], [76, 81, 6, 7]]


def test_tile_runs_of_a_sharded_plan():
    # a shard with fewer slices than the stacked plan leaves the slices
    # in between empty, and its padding tiles name the last one
    ts = np.concatenate([np.repeat(np.arange(6, dtype=np.int32), 2),
                         np.full(4, 9, np.int32)])
    runs = ptables.tile_runs(ts, 10)
    _runs_cover(runs, ts, 10)
    assert runs.tolist() == [[0, 4, 0, 2], [4, 8, 2, 4], [8, 12, 4, 9],
                             [12, 16, 9, 10]]


@pytest.mark.parametrize("bad", ["decreasing", "out_of_range"])
def test_tile_runs_rejects_a_bad_tile_slice(bad):
    ts = np.array([0, 2, 1] if bad == "decreasing" else [0, 1, 3], np.int32)
    with pytest.raises(ValueError, match="nondecreasing"):
        ptables.tile_runs(ts, 3)


@pytest.mark.parametrize("kind", ["sell", "hybrid", "sharded", "windowless",
                                  "cached", "double"])
def test_placement_builds_the_work_list(kind):
    # the work list of kernels G, H and L is built once, when the plan is
    # placed, for each tile_slice that they read: every SellPlan's, a
    # double plan's (kernel L) included
    from spmv_vector_cache_tpu_torch.formats.dia import (HybridPlan,
                                                         build_dia_plan)
    from spmv_vector_cache_tpu_torch.parallel import (build_sharded_plan,
                                                      make_mesh, place_on_mesh)
    from tests.test_torch_cached import powerlaw_cols

    _, pa = both(shuffled_band(2048, seed=17))
    if kind == "sharded":
        plan = place_on_mesh(build_sharded_plan(pa, 4),
                             make_mesh(4, device="cpu"))
        read = [(w, ts, plan.num_slices)
                for w, ts in zip(plan.works, plan.tile_slice)]
        assert place_on_mesh(plan, make_mesh(4, device="cpu")) is plan
    elif kind == "hybrid":
        _, pb = both(banded(2048, [-1, 0, 1], seed=18))
        plan = pplan.place(HybridPlan(dia=build_dia_plan(pb, sublanes=8),
                                      rest=pplan.build_sell_plan(pa)), "cpu")
        read = [(plan.rest.work, plan.rest.tile_slice, plan.rest.num_slices)]
    elif kind == "cached":
        # a window tier and a nested full-cover resident tier
        _, pc = both(powerlaw_cols(0))
        plan = pplan.place(pcached.build_cached_plan(pc), "cpu")
        tier2 = plan.cold.hot
        assert isinstance(plan.cold, pcached.CachedPlan)
        read = [(plan.hot.work, plan.hot.tile_slice, plan.hot.num_slices),
                (tier2.work, tier2.tile_slice, tier2.num_slices)]
    else:
        built = {"sell": lambda: pplan.build_sell_plan(pa),
                 "windowless": lambda: _windowless(pplan, both(random_sparse(
                     300, 5000, 0.02, seed=4))[1]),
                 "double": lambda: pplan.build_sell_plan(
                     pa, value_dtype=np.float64)}[kind]()
        plan = pplan.place(built, "cpu")
        read = [(plan.work, plan.tile_slice, plan.num_slices)]
        # the host plan holds none: the work list is the placed plan's
        assert built.work is None
    for work, ts, num_slices in read:
        want = ptables.tile_runs(ts, num_slices)
        assert work.runs.device == ts.device
        assert np.array_equal(work.runs.numpy(), want)
        assert work.split == bool((want[:, 3] & ptables.RUN_ATOMIC).any())
        s1 = want[:, 3] & ~ptables.RUN_ATOMIC
        assert work.max_tiles == (want[:, 1] - want[:, 0]).max()
        assert work.max_slices == (s1 - want[:, 2]).max()


# ---------------------------------------------------------------------------
# Hybrid and COO tail
# ---------------------------------------------------------------------------

def hybrid_coo_tail():
    """``tests/test_dia.py``'s Hybrid SpMM matrix: a 17-diagonal band of
    512 rows plus 200 entries of 1.0 at random positions."""
    rng = np.random.default_rng(12)
    m = banded(512, list(range(-8, 9)), seed=13).tolil()
    for r, c in zip(rng.integers(0, 512, 200), rng.integers(0, 512, 200)):
        m[int(r), int(c)] = 1.0
    m = m.tocsr().astype(np.float32)
    m.sort_indices()
    return m


def test_spmm_plan_dispatch_hybrid():
    m = hybrid_coo_tail()
    ja, pa = both(m)
    jp = jplan.auto_plan(ja)
    assert type(jp).__name__ == "HybridPlan"
    assert type(jp.rest).__name__ == "CooTail"
    assert_plans_equal(pplan.auto_plan(pa), jp)
    b = _b(512, 8, seed=14)
    want = np.asarray(jspmm.spmm_plan(jp.to_device(), b))
    y = pspmm.spmm_plan(plan_from_reference(jp, "cpu"),
                        torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(y, want, **TOL)
    np.testing.assert_allclose(y, m.astype(np.float64) @ b, **TOL)


@pytest.mark.parametrize("k", [1, 6])
def test_spmm_coo_tail_matches_jax(k):
    m = random_sparse(300, 250, 0.03, seed=15)
    ja, pa = both(m)
    jp = jcached.coo_tail_from_csr(ja)
    pp = pplan.place(pcached.coo_tail_from_csr(pa), "cpu")
    assert_plans_equal(pp, jp)
    b = _b(250, k, seed=16)
    want = np.asarray(jspmm.spmm_plan(jp, b))
    y = pspmm.spmm_plan(pp, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(y, want, **TOL)


# ---------------------------------------------------------------------------
# the operator: every plan family
# ---------------------------------------------------------------------------

def _windowless(c, a):
    plan = c.build_sell_plan(a, max_window_blocks=2)
    assert plan.stats.window_blocks == 0
    return plan


#: how an operator's plan is built, (port, JAX): None is auto_plan (the
#: port's operator through from_matrix)
BUILDERS = {
    None: (None, jplan.auto_plan),
    "coo_tail": (pcached.coo_tail_from_csr, jcached.coo_tail_from_csr),
    "windowless": (lambda a: _windowless(pplan, a),
                   lambda a: _windowless(jplan, a)),
    "packed": (ppacked.build_packed_plan, jpacked.build_packed_plan),
}

#: name -> (matrix, builder, plan type, fused kernel?, the JAX side: "op"
#: for the JAX operator's ``op @ B``, "small" for the JAX spmm_plan on the
#: plan with one step per grid step, "reference" for JAX reference.spmm)
OPERATOR_CASES = {
    "dia": (lambda: banded(4096, list(range(-13, 14)), seed=1), None,
            "DiaPlan", True, "op"),
    "hybrid_sell": (lambda: hybrid(32768, seed=2), None, "HybridPlan", True,
                    "small"),
    "hybrid_coo_tail": (hybrid_coo_tail, None, "HybridPlan", True, "op"),
    "sell_window": (lambda: shuffled_band(4096, seed=3), None, "SellPlan",
                    True, "small"),
    "coo_tail": (lambda: random_sparse(300, 250, 0.03, seed=15),
                 "coo_tail", "CooTail", True, "op"),
    # no fused kernel in the reference either: its operator falls back to
    # reference.spmm on the ValueError
    "sell_windowless": (lambda: random_sparse(300, 5000, 0.02, seed=4),
                        "windowless", "SellPlan", False, "op"),
    "packed": (lambda: random_csr(20000, 9000, 0.001), "packed",
               "PackedPlan", False, "op"),
    # reference fault: the JAX spmm_plan sends ChunkPlan and CachedPlan to
    # its window SpMM, which reads plan.vals and raises AttributeError, an
    # error its operator does not catch; JAX reference.spmm is the want
    "chunk": (lambda: pareto_banded(n=4096, seed=13, cap=2048), None,
              "ChunkPlan", False, "reference"),
    "cached": (few_columns, None, "CachedPlan", False, "reference"),
}


@pytest.mark.parametrize("case", sorted(OPERATOR_CASES))
def test_operator_matmat_matches_jax(case):
    make, build, kind, fused, jax_side = OPERATOR_CASES[case]
    m = make()
    ja, pa = both(m)
    port_build, jax_build = BUILDERS[build]
    if port_build is None:
        op = SparseOperator.from_matrix(pa, device="cpu")
    else:
        op = SparseOperator(pplan.place(port_build(pa), "cpu"), matrix=pa)
    assert type(op.plan).__name__ == kind
    assert pspmm.has_fused_spmm(op.plan) == fused
    b = _b(m.shape[1], 8, seed=17)
    y = op @ b
    assert isinstance(y, torch.Tensor) and y.dtype == torch.float32
    assert y.shape == (m.shape[0], 8)
    if jax_side == "reference":
        want = np.asarray(jref.spmm(ja, b))
    else:
        jp = jax_build(ja)
        assert_plans_equal(op.plan, jp)
        if jax_side == "op":
            want = np.asarray(joperator.SparseOperator(jp, matrix=ja) @ b)
        else:
            jp = dataclasses.replace(jp, rest=_small_steps(jp.rest)) \
                if kind == "HybridPlan" else _small_steps(jp)
            want = np.asarray(jspmm.spmm_plan(jp, b, interpret=True))
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(y.numpy(), m.astype(np.float64) @ b, **TOL)


def test_hybrid_without_fused_residual_runs_the_reference():
    # a HybridPlan whose residual has no fused kernel runs reference.spmm
    # as a whole, as the reference's operator does on its ValueError
    from spmv_vector_cache_tpu_torch.formats.dia import (HybridPlan,
                                                         build_dia_plan,
                                                         split_diagonal)

    m = hybrid_coo_tail()
    ja, pa = both(m)
    dia, rest, _ = split_diagonal(pa)
    plan = HybridPlan(dia=build_dia_plan(dia), rest=_windowless(pplan, rest))
    assert not pspmm.has_fused_spmm(plan)
    op = SparseOperator(pplan.place(plan, "cpu"), matrix=pa)
    b = _b(512, 8, seed=21)
    with pytest.raises(pspmm.NoFusedSpmm):
        pspmm.spmm_plan(op.plan, torch.from_numpy(b))
    np.testing.assert_allclose((op @ b).numpy(), np.asarray(jref.spmm(ja, b)),
                               **TOL)


@pytest.mark.parametrize("kind", ["ChunkPlan", "CachedPlan"])
def test_reference_has_no_spmm_for_chunk_and_cached_plans(kind):
    # the reference fault the port's matmat routes around
    m = pareto_banded(n=4096, seed=13, cap=2048) if kind == "ChunkPlan" \
        else few_columns()
    ja, _ = both(m)
    jp = jplan.auto_plan(ja)
    assert type(jp).__name__ == kind
    with pytest.raises(AttributeError):
        jspmm.spmm_plan(jp, _b(m.shape[1], 2, seed=18))


def test_operator_matmat_refusals():
    m = banded(512, [-1, 0, 1], seed=19)
    _, pa = both(m)
    b = _b(512, 4, seed=20)
    # the reference's SpMM ignores the semiring and returns a plus-times
    # product over the min-plus padding; the port refuses
    op = SparseOperator.from_matrix(pa, semiring="min_plus", device="cpu")
    with pytest.raises(NotImplementedError, match="plus_times"):
        op @ b
    # a plan without a fused kernel and no matrix to fall back on
    bare = SparseOperator(pplan.place(_windowless(pplan, pa), "cpu"))
    with pytest.raises(pspmm.NoFusedSpmm):
        bare @ b
    with pytest.raises(pspmm.NoFusedSpmm):
        pspmm.spmm_plan(bare.plan, torch.from_numpy(b))
    dia = SparseOperator.from_matrix(pa, device="cpu")
    with pytest.raises(ValueError, match="B has shape"):
        dia @ np.ones((511, 4), np.float32)
