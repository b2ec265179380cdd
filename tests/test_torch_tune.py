"""Port parity for the plan-parameter and strategy sweeps:
``spmv_vector_cache_tpu_torch/ops/tune.py`` and the sweep of
``ops/strategy.py`` against the JAX package's.

* ``plan_signature`` gives the reference's string;
* ``_candidates`` gives the reference's names and parameters, and every
  candidate's host plan is byte-equal to the JAX candidate's;
* a store written by the JAX ``autotune_plan`` makes the port rebuild the
  same winner with no timing;
* only a builder's ``ValueError`` / ``NotImplementedError`` skips a
  candidate; an error raised by the apply propagates;
* ``from_matrix(tune=True, device="cpu")`` records the ``tune_*`` stats;
* ``autotune``'s strategy list is the reference's on SellPlans either
  side of the v5e caps (JAX side: its kernels stubbed out, so that only
  its feasibility rule runs).
"""

import json
from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops import spmv_pallas as jpallas
from spmv_vector_cache_tpu.ops import strategy as jstrategy
from spmv_vector_cache_tpu.ops import tune as jtune
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.ops import strategy as pstrategy
from spmv_vector_cache_tpu_torch.ops import tune as ptune
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_cached import powerlaw_cols, zipf_cols
from tests.test_torch_packed import mac_econ_small
from tests.test_torch_plan import (assert_plans_equal, banded, both,
                                   random_sparse, shuffled_band)

#: name -> (scipy matrix, plan type auto_plan gives)
CASES = {
    "dia": (lambda: banded(2048, list(range(-3, 4)), seed=1), "DiaPlan"),
    "sell_uniform": (lambda: shuffled_band(2048, seed=3), "SellPlan"),
    "sell_random": (lambda: random_sparse(2000, 1500, 0.01, seed=1),
                    "SellPlan"),
    "packed": (mac_econ_small, "PackedPlan"),
    "cached": (lambda: powerlaw_cols(0), "CachedPlan"),
    "zipf": (lambda: zipf_cols(8192, 1 << 18, 24, 2.0, 300, 3),
             "CachedPlan"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_signature_matches_jax(case):
    ja, pa = both(CASES[case][0]())
    assert ptune.plan_signature(pa) == jtune.plan_signature(ja)


def test_plan_signature_discriminates():
    _, a = both(banded(4096, [-1, 0, 1], seed=1))
    _, b = both(banded(2048, [-1, 0, 1], seed=1))
    assert ptune.plan_signature(a) == ptune.plan_signature(a)
    assert ptune.plan_signature(a) != ptune.plan_signature(b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_candidates_match_jax(case):
    make, kind = CASES[case]
    ja, pa = both(make())
    pbase, jbase = pplan.auto_plan(pa), jplan.auto_plan(ja)
    assert type(pbase).__name__ == kind
    pc = ptune._candidates(pa, pbase, np.float32, "plus_times")
    jc = jtune._candidates(ja, jbase, np.float32, "plus_times")
    assert [(n, p) for n, p, _ in pc] == [(n, p) for n, p, _ in jc]
    assert len(pc) >= 2
    for (name, _, pbuild), (_, _, jbuild) in zip(pc, jc):
        assert_plans_equal(pbuild(), jbuild(), path=name)


def test_min_plus_candidates_pad_with_the_semirings_zero():
    # the reference pads its SELL candidates with 0 under every semiring;
    # the port pads them with the semiring's zero, so each gives the
    # min-plus product
    m = random_sparse(2000, 1500, 0.01, seed=1, nonneg=True)
    _, pa = both(m)
    base = pplan.auto_plan(pa, semiring="min_plus")
    x = np.abs(np.random.default_rng(2).standard_normal(1500)).astype(
        np.float32)
    prod = np.asarray(pa.data, np.float64) + x.astype(np.float64)[
        np.asarray(pa.indices)]
    indptr = np.asarray(pa.indptr)
    want = np.array([prod[indptr[i]:indptr[i + 1]].min()
                     if indptr[i + 1] > indptr[i] else np.inf
                     for i in range(2000)])
    for name, _, build in ptune._candidates(pa, base, np.float32,
                                            "min_plus"):
        plan = pplan.place(build(), "cpu")
        y = pstrategy.spmv_plan(plan, torch.from_numpy(x),
                                semiring="min_plus").numpy()
        np.testing.assert_allclose(y, want, rtol=1e-6, err_msg=name)


def test_jax_store_rebuilds_the_same_winner(tmp_path):
    # as tests/test_tune.py runs it: 2048 rows, iters=1
    m = banded(2048, list(range(-3, 4)), seed=1)
    ja, pa = both(m)
    store = str(tmp_path / "tuned.json")
    jres = jtune.autotune_plan(ja, iters=1, store=store)
    with open(store) as f:
        assert jres.signature in json.load(f)

    def no_timing(*a, **k):
        raise AssertionError("a stored winner is rebuilt without timing")

    with mock.patch.object(ptune, "_time_rounds", no_timing):
        res = ptune.autotune_plan(pa, iters=1, store=store, device="cpu")
    assert res.signature == jres.signature and res.best == jres.best
    assert [(e.name, e.seconds, e.gnnz_per_s) for e in res.table] == \
        [(jres.best, 0.0, 0.0)]
    assert_plans_equal(res.plan, jres.plan)
    assert res.plan.vals.device.type == "cpu"


def test_port_store_round_trip(tmp_path):
    _, pa = both(shuffled_band(2048, seed=3))
    store = str(tmp_path / "tuned.json")
    seen = []
    res = ptune.autotune_plan(pa, iters=1, store=store, device="cpu",
                              check=lambda n, p, y: seen.append(n))
    names = [n for n, _, _ in ptune._candidates(
        pa, pplan.auto_plan(pa), np.float32, "plus_times")]
    assert seen == names == [e.name for e in res.table]
    assert res.best in names and not res.skipped
    assert all(e.seconds > 0 for e in res.table)
    with open(store) as f:
        stored = json.load(f)[res.signature]
    assert stored["best"] == res.best
    assert [e["name"] for e in stored["table"]] == names
    again = ptune.autotune_plan(pa, iters=1, store=store, device="cpu")
    assert again.best == res.best and again.table[0].seconds == 0.0
    assert len(again.table) == 1


def test_check_sees_every_candidate_before_any_is_timed():
    _, pa = both(banded(2048, list(range(-3, 4)), seed=1))
    events = []
    real = pstrategy._time_device

    def timed(fn, *a, **k):
        events.append("time")
        return real(fn, *a, **k)

    ones = np.ones(2048)
    want = jref.spmv_numpy(both(banded(2048, list(range(-3, 4)),
                                       seed=1))[0], ones)

    def check(name, plan, y):
        events.append(name)
        assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)

    with mock.patch.object(pstrategy, "_time_device", timed):
        res = ptune.autotune_plan(pa, iters=1, device="cpu", check=check)
    n = len(res.table)
    assert events == [e.name for e in res.table] + ["time"] * (2 * n)


def test_builder_value_error_skips_only_that_candidate():
    _, pa = both(banded(2048, list(range(-3, 4)), seed=1))
    real = ptune._candidates

    def with_bad(a, base, value_dtype, semiring):
        def refuse():
            raise ValueError("no such layout")
        return real(a, base, value_dtype, semiring) + [("bad", {}, refuse)]

    with mock.patch.object(ptune, "_candidates", with_bad):
        res = ptune.autotune_plan(pa, iters=1, device="cpu")
    assert res.skipped == [("bad", "ValueError: no such layout")]
    assert "bad" not in [e.name for e in res.table]
    assert len(res.table) == len(real(pa, pplan.auto_plan(pa), np.float32,
                                      "plus_times"))


def test_apply_error_propagates():
    _, pa = both(banded(2048, list(range(-3, 4)), seed=1))

    def broken(plan, x, **kw):
        raise RuntimeError("CUDA kernel failed to launch")

    with mock.patch.object(ptune, "spmv_plan", broken):
        with pytest.raises(RuntimeError, match="failed to launch"):
            ptune.autotune_plan(pa, iters=1, device="cpu")


def test_from_matrix_tune_records_stats(tmp_path):
    m = shuffled_band(2048, seed=5)
    ja, pa = both(m)
    store = str(tmp_path / "tuned.json")
    op = SparseOperator.from_matrix(pa, tune=True, tune_store=store,
                                    device="cpu")
    assert op.stats["tuned"] in (0, 1)
    names = [k for k in op.stats.keys() if k.startswith("tune_")]
    assert len(names) >= 2 and all(k.endswith("_gnnz_per_s") for k in names)
    # the strategy sweep ran on the winner
    assert "window_seconds" in op.stats and "stream_seconds" in op.stats
    assert op.strategy in ("window", "resident", "deep", "stream")
    x = np.random.default_rng(6).standard_normal(2048).astype(np.float32)
    want = jref.spmv_numpy(ja, x.astype(np.float64))
    y = (op @ x).numpy()
    assert np.abs(y - want).max() / max(1.0, np.abs(want).max()) < 1e-4
    # a second operator reads the winner from the store
    again = SparseOperator.from_matrix(pa, tune=True, tune_store=store,
                                       device="cpu")
    tuned = [k for k in again.stats.keys() if k.startswith("tune_")]
    assert len(tuned) == 1 and again.stats[tuned[0]] == 0.0
    assert tuned[0] in names and again.stats["tuned"] == op.stats["tuned"]


def test_from_matrix_tune_double_plan_sweeps_in_float64():
    m = banded(1024, [-2, 0, 3], seed=8).astype(np.float64)
    _, pa = both(m)
    op = SparseOperator.from_matrix(pa, tune=True, value_dtype=np.float64,
                                    device="cpu")
    x = np.random.default_rng(3).standard_normal(1024)
    y = (op @ x).numpy()
    assert y.dtype == np.float64
    np.testing.assert_allclose(y, m @ x, rtol=1e-11, atol=1e-11)


def _jax_feasible(jp):
    """The JAX autotune's strategy list, its kernels stubbed out."""
    tried = []

    def fake_apply(plan, x, strategy="auto", **kw):
        tried.append(strategy)
        return np.zeros(1)

    with mock.patch.object(jpallas, "spmv_plan", fake_apply), \
            mock.patch.object(jstrategy, "_time_device",
                              lambda fn, iters=10: (fn(), 1.0)[1]):
        res = jstrategy.autotune(jp, np.zeros(jp.shape[1], np.float32))
    assert tried == list(res)
    return list(res)


def _wide(rows, cols, seed):
    """A few nonzeros a row, spread over ``cols`` columns: windowless."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(rows), 4)
    c = rng.integers(0, cols, r.shape[0])
    m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=(rows, cols))
    m.sum_duplicates()
    m.sort_indices()
    return m


@pytest.mark.parametrize("cols", [64 * 128, 64 * 128 + 1, 2048 * 128,
                                  2048 * 128 + 1])
def test_autotune_lists_the_references_strategies(cols):
    ja, pa = both(_wide(256, cols, seed=cols % 97))
    jp = jplan.build_sell_plan(ja)
    pp = pplan.place(pplan.build_sell_plan(pa), "cpu")
    want = _jax_feasible(jp)
    assert pstrategy.feasible_strategies(pp) == want
    x = torch.ones(cols)
    res = pstrategy.autotune(pp, x, iters=1)
    assert list(res) == want
    assert all(r.seconds > 0 and r.gnnz_per_s > 0 for r in res.values())
    assert pstrategy.best_strategy(pp, x, iters=1) in want


def test_autotune_window_plan_admits_all_four():
    ja, pa = both(shuffled_band(2048, seed=3))
    jp = jplan.build_sell_plan(ja)
    pp = pplan.place(pplan.build_sell_plan(pa), "cpu")
    want = _jax_feasible(jp)
    assert want == ["window", "resident", "deep", "stream"]
    stats = {}
    res = pstrategy.autotune(pp, torch.ones(2048), iters=1, stats=stats)
    assert list(res) == want
    assert set(stats) == {f"{s}_{k}" for s in want
                          for k in ("seconds", "gnnz_per_s")}


def test_autotune_other_plans_run_their_one_route():
    ja, pa = both(banded(2048, list(range(-3, 4)), seed=1))
    pp = pplan.place(pplan.auto_plan(pa), "cpu")
    jp = jplan.auto_plan(ja)
    assert pstrategy.feasible_strategies(pp) == _jax_feasible(jp) == ["dia"]
    _, pc = both(mac_econ_small())
    assert pstrategy.feasible_strategies(pplan.auto_plan(pc)) == ["auto"]


def test_autotune_skips_only_a_refused_strategy():
    _, pa = both(_wide(256, 64 * 128, seed=1))
    pp = pplan.place(pplan.build_sell_plan(pa), "cpu")
    real = pstrategy.spmv_plan

    def refuse_deep(plan, x, strategy="auto", **kw):
        if strategy == "deep":
            raise ValueError("x spans too many blocks")
        if strategy == "stream":
            raise RuntimeError("CUDA kernel failed to launch")
        return real(plan, x, strategy=strategy, **kw)

    with mock.patch.object(pstrategy, "spmv_plan", refuse_deep):
        with pytest.raises(RuntimeError, match="failed to launch"):
            pstrategy.autotune(pp, torch.ones(64 * 128), iters=1)

    def refuse_only_deep(plan, x, strategy="auto", **kw):
        if strategy == "deep":
            raise ValueError("x spans too many blocks")
        return real(plan, x, strategy=strategy, **kw)

    with mock.patch.object(pstrategy, "spmv_plan", refuse_only_deep):
        res = pstrategy.autotune(pp, torch.ones(64 * 128), iters=1)
    assert list(res) == ["resident", "stream"]


def test_time_device_on_the_cpu_is_wall_time():
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(3)

    dt = pstrategy._time_device(fn, iters=4)
    assert dt > 0 and len(calls) == 5


def test_time_rounds_runs_forward_then_backward_and_keeps_the_lower():
    order = []
    clock = iter([5.0, 1.0, 2.0, 9.0])     # a: 5 then 9; b: 1 then 2

    def fake(fn, iters=10):
        order.append(fn())
        return next(clock)

    with mock.patch.object(pstrategy, "_time_device", fake):
        got = pstrategy._time_rounds({"a": lambda: "a", "b": lambda: "b"},
                                     iters=3)
    assert order == ["a", "b", "b", "a"]
    assert got == {"a": 5.0, "b": 1.0}


def test_autotune_on_a_chunk_plan_runs_its_route():
    # the reference's rule reads a window width that ChunkStats lacks
    from spmv_vector_cache_tpu.formats import chunk as jchunk
    from spmv_vector_cache_tpu_torch.formats import chunk as pchunk
    from tests.test_torch_chunk import pareto_banded

    ja, pa = both(pareto_banded())
    with pytest.raises(AttributeError, match="window_blocks"):
        _jax_feasible(jchunk.build_chunk_plan(ja))
    pp = pplan.place(pchunk.build_chunk_plan(pa), "cpu")
    assert pstrategy.feasible_strategies(pp) == ["auto"]
    res = pstrategy.autotune(pp, torch.ones(pa.shape[1]), iters=1)
    assert list(res) == ["auto"] and res["auto"].seconds > 0
