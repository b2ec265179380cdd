"""The planner on power-law graphs: the heuristic prices its SELL and
chunk candidates from their statistics, builds only what it keeps, and
still returns the JAX package's plan byte for byte.

* ``auto_plan`` on Graph500 Kronecker draws (``tools/graphs.py``) at
  scales 10-13 equals the JAX package's ``auto_plan``;
* ``sell_plan_stats`` is the ``stats`` (and what the cost model reads)
  of ``build_sell_plan`` with the same arguments, and ``chunk_price``
  prices exactly what ``build_chunk_plan`` builds;
* the two shortcuts of the heuristic's analyses (the working-set test,
  the stripe count) and the DIA offset count agree with the analyses;
* each candidate is a span ``spmv.plan.build.<family>`` only while a
  profiler records, the seconds of those not kept reach ``op.stats``,
  and the counters ``plan.nnz`` and ``plan.slots`` always count.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu_torch import CSR, SparseOperator
from spmv_vector_cache_tpu_torch.formats import analysis
from spmv_vector_cache_tpu_torch.formats import chunk as pchunk
from spmv_vector_cache_tpu_torch.formats import dia as pdia
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.formats.costmodel import estimate_seconds
from spmv_vector_cache_tpu_torch.tools import graphs
from spmv_vector_cache_tpu_torch.utils import stats
from tests.test_torch_chunk import (duplicates, empty_rows,
                                    heavy_two_buckets, pareto_banded)
from tests.test_torch_plan import (assert_plans_equal, banded, both,
                                   hybrid, random_sparse, shuffled_band)

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh():
    stats.span_totals.clear()
    stats.counters.clear()
    yield
    stats.span_totals.clear()
    stats.counters.clear()


def kron(scale, seed=7):
    """A kron draw as a sorted scipy CSR (what ``both`` takes)."""
    p = graphs.kron(scale, seed=seed)
    return sp.csr_matrix((p.data, p.indices, p.indptr), shape=p.shape)


def as_port(m) -> CSR:
    return both(m)[1]


@pytest.mark.parametrize("scale", [10, 11, 12, 13])
def test_auto_plan_on_kron_draws_is_the_jax_plan(scale):
    ja, pa = both(kron(scale, seed=scale))
    port = pplan.auto_plan(pa)
    assert_plans_equal(port, jplan.auto_plan(ja))


SELL = {
    "kron": lambda: kron(11),
    "pareto": lambda: pareto_banded(n=3000, seed=2, cap=1500),
    "band": lambda: banded(2000, [-40, -1, 0, 3, 90], seed=1),
    "shuffled": lambda: shuffled_band(2048, seed=3),
    "random": lambda: random_sparse(700, 5000, 0.01, seed=4),
    "one_row": lambda: random_sparse(1, 300, 0.2, seed=5),
    "empty": lambda: sp.csr_matrix((300, 200), dtype=np.float32),
}


@pytest.mark.parametrize("sigma,split", [(None, None), (1024, None),
                                         (None, 16), (1024, 40)])
@pytest.mark.parametrize("case", sorted(SELL))
def test_sell_plan_stats_are_the_built_plans(case, sigma, split):
    a = as_port(SELL[case]())
    for mwb in (16, 2):
        full = pplan.build_sell_plan(a, sigma=sigma, split=split,
                                     max_window_blocks=mwb)
        price = pplan.sell_plan_stats(a, sigma=sigma, split=split,
                                      max_window_blocks=mwb)
        assert price.stats == full.stats
        assert price.identity_map == full.identity_map
        assert price.slots_y == full.row_map.shape[0]
        assert estimate_seconds(price) == estimate_seconds(full)


CHUNK = {
    "kron10": lambda: kron(10),
    "kron12": lambda: kron(12, seed=3),
    "pareto": lambda: pareto_banded(n=4096, seed=0),
    "heavy_two_buckets": heavy_two_buckets,
    "duplicates": duplicates,
    "empty_rows": empty_rows,
}


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("case", sorted(CHUNK))
def test_chunk_price_prices_the_built_plan(case, merge):
    a = as_port(CHUNK[case]())
    plan = pchunk.build_chunk_plan(a, merge_duplicates=merge)
    price = pchunk.chunk_price(a, merge_duplicates=merge)
    assert estimate_seconds(price) == estimate_seconds(plan)
    assert [b.stats.num_tiles for b in price.buckets] == \
        [b.stats.num_tiles for b in plan.buckets]
    assert [h.num_tiles for h in price.hbuckets] == \
        [h.num_tiles for h in plan.hbuckets]


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("case", sorted(CHUNK))
def test_the_chunk_floors_are_below_the_price(case, merge):
    a = as_port(CHUNK[case]())
    rows = pchunk.ChunkRows(a, merge_duplicates=merge)
    floor, tighter = (pchunk.chunk_seconds_floor(
        rows, merge_duplicates=merge, heavy_exact=exact)
        for exact in (False, True))
    price = estimate_seconds(pchunk.chunk_price(rows, merge_duplicates=merge))
    assert 0 < floor <= tighter <= price


@pytest.mark.parametrize("case", ["kron10", "kron12"])
def test_the_chunk_plan_of_a_kron_draw_is_the_jax_plan(case):
    from spmv_vector_cache_tpu.formats import chunk as jchunk

    ja, pa = both(CHUNK[case]())
    assert_plans_equal(pchunk.build_chunk_plan(pa),
                       jchunk.build_chunk_plan(ja))


@pytest.mark.parametrize("limit", [0, 5, 40, 2048])
@pytest.mark.parametrize("case", ["kron", "band", "random", "shuffled"])
def test_the_working_set_shortcut_agrees_with_the_analysis(case, limit):
    a = as_port(SELL[case]())
    assert pplan._column_working_set_above(a, limit) == \
        (analysis.column_working_set(a) > limit)


@pytest.mark.parametrize("sw", [256, 2048])
@pytest.mark.parametrize("case", ["kron", "random", "empty", "one_row"])
def test_the_stripe_count_is_the_distinct_row_stripe_runs(case, sw):
    a = as_port(SELL[case]())
    lens = np.diff(np.asarray(a.indptr, dtype=np.int64))
    rows = np.repeat(np.arange(a.shape[0]), lens)
    runs = {(int(r), int(c) // sw) for r, c in zip(rows, a.indices)}
    assert pplan._stripe_pieces(a, lens, sw) == len(runs)


@pytest.mark.parametrize("shape", [(5, 7), (300, 1000), (2000, 2000),
                                   (100, 100000)])
def test_the_offset_count_is_numpys_unique(shape):
    rows, cols = shape
    rng = np.random.default_rng(rows)
    n = 4 * rows
    d = rng.integers(0, cols, n) - rng.integers(0, rows, n)
    want = np.unique(d, return_counts=True)
    got = pdia._offset_counts(d, rows, cols)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)


def test_candidates_are_spans_only_under_a_profiler():
    a = as_port(kron(10))
    stages = {}
    plan = pplan.auto_plan(a, stages=stages)
    assert isinstance(plan, pchunk.ChunkPlan)
    assert stats.span_totals == {}
    assert 0 <= stages["spmv.plan.discarded_build"] <= \
        stages["spmv.plan.build"]
    with torch.profiler.profile(activities=CPU) as prof:
        pplan.auto_plan(a)
    # the SELL rival priced, the chunk plan built, the COO backstop's
    # candidate (a small matrix) built and not taken
    names = {"spmv.plan.build.sell", "spmv.plan.build.chunk",
             "spmv.plan.build.coo"}
    assert names <= {e.name for e in prof.events()}
    assert set(stats.span_totals) == names | {"spmv.plan.detect",
                                              "spmv.plan.build"}
    for name in names:
        assert stats.span_totals[name].parents == {"spmv.plan.build": 1}


def test_the_discarded_seconds_are_the_candidates_not_kept(monkeypatch):
    """On a kron draw at scale 12 the SELL rival is priced and the chunk
    plan built and kept: the discarded seconds are the rival's."""
    seen = []
    inner = pplan._candidate

    def spy(family):
        cm = inner(family)

        class Spy:
            def __enter__(self):
                self.rec = cm.__enter__()
                return self.rec

            def __exit__(self, *exc):
                out = cm.__exit__(*exc)
                seen.append(self.rec)
                return out
        return Spy()

    monkeypatch.setattr(pplan, "_candidate", spy)
    stages = {}
    plan = pplan.auto_plan(as_port(kron(12)), stages=stages)
    assert isinstance(plan, pchunk.ChunkPlan)
    assert [r["family"] for r in seen] == ["sell", "chunk"]
    assert seen[0]["plan"] is None and seen[1]["plan"] is plan
    assert stages["spmv.plan.discarded_build"] == seen[0]["seconds"]
    assert 0 < stages["spmv.plan.discarded_build"] < \
        stages["spmv.plan.build"]


def scattered(rows=20000, cols=30000, per_row=5, seed=6, zipf=None):
    """``per_row`` entries a row at uniform columns, or at Zipf-popular
    ones (a small hot set covers most of them)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(rows), per_row)
    c = rng.integers(0, cols, r.size) if zipf is None else \
        rng.permutation(cols)[(rng.zipf(zipf, r.size) - 1) % cols]
    m = sp.csr_matrix((rng.standard_normal(r.size).astype(np.float32),
                       (r, c)), shape=(rows, cols))
    m.sum_duplicates()
    m.sort_indices()
    return m


#: family -> matrix the planner gives that family
MATRICES = {
    "DiaPlan": lambda: banded(3000, [-1, 0, 1], seed=2),
    "HybridPlan": lambda: hybrid(32768, seed=10),
    "SellPlan": lambda: shuffled_band(2048, seed=5),
    "ChunkPlan": lambda: kron(10),
    "CachedPlan": lambda: scattered(zipf=2.0),
    "PackedPlan": lambda: scattered(),
    "CooTail": lambda: scattered(rows=500, cols=100000, per_row=20),
}


@pytest.mark.parametrize("case", sorted(MATRICES))
def test_plan_counters_count_the_returned_plan(case):
    a = as_port(MATRICES[case]())
    op = SparseOperator.from_matrix(a, device="cpu")
    assert type(op.plan).__name__ == case
    nnz, slots = pplan.stored_and_streamed(op.plan)
    want = {"plan.nnz": nnz, "plan.slots": slots}
    if case == "PackedPlan":
        # kernel F's list, compacted when the plan is placed
        st = op.plan.stats
        want.update({"packed.f_entries": st.num_pieces,
                     "packed.f_dense_entries": st.num_steps_b * 8192})
    assert stats.counters == want
    assert stats.span_totals == {}
    assert 0 < nnz <= slots
    dedup = a.nnz if case != "HybridPlan" else \
        int((sp.csr_matrix((a.data, a.indices, a.indptr),
                           shape=a.shape) != 0).nnz)
    assert nnz == dedup
    assert 0 <= op.stats["discarded_build_seconds"] <= \
        op.stats["build_seconds"]


def test_a_cached_plan_with_a_chunk_hot_tier_applies():
    # at scale 16 the heuristic keeps a CachedPlan whose hot tier is a
    # ChunkPlan and whose cold part is a PackedPlan: the apply reads the
    # value type through both levels
    csr = graphs.kron(16, seed=20150804)
    op = SparseOperator.from_matrix(csr, device="cpu")
    assert type(op.plan).__name__ == "CachedPlan"
    assert type(op.plan.hot).__name__ == "ChunkPlan"
    x = torch.randn(csr.shape[1], generator=torch.Generator().manual_seed(5))
    a = sp.csr_matrix((csr.data.astype(np.float64), csr.indices,
                       csr.indptr), shape=csr.shape)
    ref = a @ x.double().numpy()
    scale = (abs(a) @ np.abs(x.double().numpy())).max()
    got = (op @ x).double().numpy()
    assert np.abs(got - ref).max() <= 1e-6 * scale
