"""Port parity: SpMM, ``Y = A @ B`` with B of shape (cols, k), against the
JAX package's.

* ``spmm_dia`` (kernel I's plain version) against the JAX ``spmm_dia``
  (its Pallas kernel in interpret mode) on the JAX DIA SpMM tests'
  shapes, and against JAX ``reference.spmm`` past the width where the
  JAX kernel's VMEM budget refuses the plan;
* ``spmm_plan`` on window SellPlans (kernel H's plain version and the
  slice/sub-row epilogue over a trailing k axis) against the JAX
  ``spmm_plan``, with identity and row_map fixups, a folded
  uniform-parts layout, and window grains 128 and 32; kernel H's
  partials against kernel B's, column by column;
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

    # kernel H's partials are kernel B's partials, one RHS column at a
    # time
    args = (pp.vals, pp.cols_win, pp.window_base)
    kwargs = dict(group_tiles=st.group_tiles, window_grain=st.window_grain,
                  fold=layout[2])
    partials = pspmm.spmm_window_kernel(*args, bt, **kwargs)
    for j in range(k):
        col = psell.sell_window_plain(*args, bt[:, j].contiguous(),
                                      semiring="plus_times", **kwargs)
        np.testing.assert_allclose(partials[..., j].numpy(), col.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_spmm_window_plain_reads_zero_past_b():
    # padding slots and columns past the last row of B read 0
    _, pa = both(shuffled_band(1024, seed=7))
    plan = pplan.place(pplan.build_sell_plan(pa), "cpu")
    st = plan.stats
    b = torch.from_numpy(_b(1024, 3, seed=8))
    kw = dict(group_tiles=st.group_tiles, window_grain=st.window_grain,
              fold=False)
    args = (plan.vals, plan.cols_win, plan.window_base)
    short = pspmm.spmm_window_plain(*args, b[:1000].contiguous(), **kw)
    zeroed = b.clone()
    zeroed[1000:] = 0
    full = pspmm.spmm_window_plain(*args, zeroed, **kw)
    assert torch.equal(short, full)


def test_spmm_window_kernel_checks_operands():
    _, pa = both(shuffled_band(1024, seed=9))
    plan = pplan.place(pplan.build_sell_plan(pa), "cpu")
    st = plan.stats
    kw = dict(group_tiles=st.group_tiles, window_grain=st.window_grain,
              fold=False)
    args = (plan.vals, plan.cols_win, plan.window_base)
    with pytest.raises(NotImplementedError, match="float32"):
        pspmm.spmm_window_kernel(*args, torch.zeros((1024, 2),
                                                    dtype=torch.float64),
                                 **kw)
    with pytest.raises(ValueError, match="B must be"):
        pspmm.spmm_window_kernel(*args, torch.zeros(1024), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        pspmm.spmm_window_kernel(*args, torch.zeros((2, 1024)).T, **kw)


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
