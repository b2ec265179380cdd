"""The port's spans and counters (``utils/stats.py``), on the CPU.

* With no profiler recording a span does nothing (one shared null
  context), the span table stays empty, and the counters still count.
* Under ``torch.profiler.profile(activities=[CPU])`` each apply of the
  operator is one ``spmv.apply`` event and one count in the table,
  whichever of ``op @ x``, ``matvec`` or ``matmat`` made it.
* Self seconds are the duration less the child spans', on a fake clock,
  and leave out the child's profiler range too; a launch is the child
  ``spmv.launch`` of the apply around it.
* ``cg`` counts one solve and one host read of the residual per
  iteration, plus the read that ends an early exit, and of those reads
  the ones made with the next iteration queued, and the queued
  iterations an exit threw away; ``bicgstab`` counts nothing and
  records no span.
* ``from_matrix`` times its planner stages into ``op.stats``, and their
  sum stays inside ``plan_seconds``; the planner counts the stored
  entries and streamed slots of the plan it returns (``plan.nnz``,
  ``plan.slots``).
* Every span the port names is ``spmv.<...>``: never the benchmark's
  ``portbench.`` prefix.
"""

import collections
import pathlib
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu_torch import CSR, SparseOperator
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.models import solvers
from spmv_vector_cache_tpu_torch.ops import _kernels
from spmv_vector_cache_tpu_torch.utils import stats

PORT = pathlib.Path(__file__).resolve().parent.parent / \
    "spmv_vector_cache_tpu_torch"
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def fresh():
    stats.span_totals.clear()
    stats.counters.clear()
    yield
    stats.span_totals.clear()
    stats.counters.clear()


def csr_of(m) -> CSR:
    m = m.tocsr()
    m.sort_indices()
    return CSR(data=m.data, indices=m.indices, indptr=m.indptr,
               shape=m.shape)


def stencil(n=256, dtype=np.float64):
    """An SPD tridiagonal matrix: the planner makes it a DiaPlan."""
    return csr_of(sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n),
                           dtype=dtype))


def _slots(op) -> int:
    """The value slots the operator's plan streams, padding included."""
    return pplan.stored_and_streamed(op.plan)[1]


def scattered(n=512, seed=3):
    """Random columns, no diagonal structure: a SELL plan."""
    rng = np.random.default_rng(seed)
    return csr_of(sp.random(n, n, density=0.02, random_state=rng,
                            dtype=np.float32))


def test_without_a_profiler_spans_record_nothing_and_counters_count():
    assert stats.span("spmv.a") is stats.span("spmv.b")
    op = SparseOperator.from_matrix(stencil(), value_dtype=np.float64,
                                    device="cpu")
    b = torch.ones(256, dtype=torch.float64)
    op @ b
    solvers.cg(op.matvec, b, tol=0.0, maxiter=3)
    assert stats.span_totals == {}
    assert stats.counters == {"cg.solves": 1, "cg.host_syncs": 3,
                              "cg.reads_overlapped": 1,
                              "cg.spec_discarded": 0, "plan.nnz": 766,
                              "plan.slots": _slots(op)}


CALLS = {
    "matmul_vector": lambda op, x, B: op @ x,
    "matvec": lambda op, x, B: op.matvec(x),
    "matmul_matrix": lambda op, x, B: op @ B,
    "matmat": lambda op, x, B: op.matmat(B),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_each_apply_is_one_span_under_the_profiler(call):
    op = SparseOperator.from_matrix(stencil(dtype=np.float32),
                                    device="cpu")
    x = torch.ones(256)
    B = torch.ones(256, 4)
    calls = 5
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(calls):
            CALLS[call](op, x, B)
    events = [e for e in prof.events() if e.name == "spmv.apply"]
    assert len(events) == calls
    row = stats.span_totals["spmv.apply"]
    assert row.count == calls and row.parents == {"": calls}
    assert 0 < row.self_seconds <= row.seconds
    assert set(stats.span_totals) == {"spmv.apply"}


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_self_seconds_are_the_duration_less_the_child_spans(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(stats, "clock", clock)
    with torch.profiler.profile(activities=CPU):
        with stats.span("spmv.outer"):
            clock.now += 1.0
            with stats.span("spmv.inner"):
                clock.now += 2.0
            clock.now += 4.0
            with stats.span("spmv.inner"):
                clock.now += 8.0
                with stats.span("spmv.leaf"):
                    clock.now += 16.0
    outer, inner, leaf = (stats.span_totals[f"spmv.{n}"]
                          for n in ("outer", "inner", "leaf"))
    assert (outer.count, outer.seconds, outer.self_seconds) == (1, 31, 5)
    assert (inner.count, inner.seconds, inner.self_seconds) == (2, 26, 10)
    assert (leaf.count, leaf.seconds, leaf.self_seconds) == (1, 16, 16)
    assert outer.parents == {"": 1} and inner.parents == {"spmv.outer": 2}
    assert leaf.parents == {"spmv.inner": 1}


class FakeRange:
    """A profiler range that costs ``enter`` and ``exit`` seconds of the
    fake clock."""

    def __init__(self, clock, enter, exit):
        self.clock, self.enter, self.exit = clock, enter, exit

    def __call__(self, name):
        return self

    def __enter__(self):
        self.clock.now += self.enter

    def __exit__(self, *exc):
        self.clock.now += self.exit


def test_self_seconds_leave_out_the_child_spans_ranges(monkeypatch):
    """A child's profiler range (its record_function pair) is time of
    the tracing, not of the parent: the parent's self seconds leave it
    out, and each span's own seconds hold its body alone."""
    clock = FakeClock()
    monkeypatch.setattr(stats, "clock", clock)
    monkeypatch.setattr(stats, "_range", FakeRange(clock, 0.5, 0.25))
    with torch.profiler.profile(activities=CPU):
        with stats.span("spmv.outer"):
            clock.now += 1.0
            with stats.span("spmv.inner"):
                clock.now += 2.0
            clock.now += 4.0
    outer, inner = (stats.span_totals[f"spmv.{n}"] for n in ("outer", "inner"))
    assert (inner.seconds, inner.self_seconds) == (2.0, 2.0)
    assert (outer.seconds, outer.self_seconds) == (7.75, 5.0)


def test_a_span_given_a_dict_times_into_it_with_or_without_profiler(
        monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(stats, "clock", clock)
    into = {}
    with stats.span("spmv.stage", into):
        clock.now += 0.5
    assert into == {"spmv.stage": 0.5} and stats.span_totals == {}
    with torch.profiler.profile(activities=CPU):
        with stats.span("spmv.stage", into):
            clock.now += 0.25
    assert into == {"spmv.stage": 0.75}
    assert stats.span_totals["spmv.stage"].seconds == 0.25


def test_a_launch_is_the_child_of_the_apply_around_it(monkeypatch):
    """The C call of ``_kernels.launch`` (here a stand-in entry point, on
    a fake clock) is ``spmv.launch``; the apply's self time leaves it
    out."""
    clock = FakeClock()

    def entry(*args):
        clock.now += 3.0
        return 0

    monkeypatch.setattr(stats, "clock", clock)
    monkeypatch.setitem(_kernels._BOUND, "stand_in", entry)
    monkeypatch.setattr(_kernels, "current_stream", lambda index: 0)
    monkeypatch.setattr(_kernels, "launches", collections.Counter())
    with torch.profiler.profile(activities=CPU) as prof:
        with stats.span("spmv.apply"):
            clock.now += 1.0
            _kernels.launch("stand_in", 0)
    launch, apply = stats.span_totals["spmv.launch"], \
        stats.span_totals["spmv.apply"]
    assert launch.parents == {"spmv.apply": 1} and launch.seconds == 3.0
    assert (apply.seconds, apply.self_seconds) == (4.0, 1.0)
    assert _kernels.launches == {"stand_in": 1}
    assert "spmv.launch" in {e.name for e in prof.events()}


@pytest.mark.parametrize("maxiter", [1, 4, 9])
def test_cg_to_maxiter_reads_the_host_maxiter_times(maxiter):
    op = SparseOperator.from_matrix(stencil(), value_dtype=np.float64,
                                    device="cpu")
    b = torch.ones(256, dtype=torch.float64)
    res = solvers.cg(op.matvec, b, tol=0.0, maxiter=maxiter)
    assert res.iterations == maxiter
    assert stats.counters == {"cg.solves": 1, "cg.host_syncs": maxiter,
                              "cg.reads_overlapped": max(maxiter - 2, 0),
                              "cg.spec_discarded": 0, "plan.nnz": 766,
                              "plan.slots": _slots(op)}


def _distinct_eigenvalues(k, n=300):
    """diag(1, 2, ..., k, 1, 2, ...): k distinct eigenvalues, so CG
    converges in k iterations."""
    d = torch.arange(1, k + 1, dtype=torch.float64).repeat(n // k)
    return (lambda v: d * v), torch.ones(n // k * k, dtype=torch.float64)


@pytest.mark.parametrize("k", [2, 3])
def test_an_early_exit_at_iteration_k_reads_the_host_k_plus_1_times(k):
    matvec, b = _distinct_eigenvalues(k)
    with torch.profiler.profile(activities=CPU):
        res = solvers.cg(matvec, b, tol=1e-10, maxiter=50)
    assert res.iterations == k
    assert stats.counters == {"cg.solves": 1, "cg.host_syncs": k + 1,
                              "cg.reads_overlapped": k - 1,
                              "cg.spec_discarded": 1}
    assert stats.span_totals["spmv.cg.read"].count == k + 1
    assert stats.span_totals["spmv.cg.read"].parents == {"spmv.cg": k + 1}
    assert stats.span_totals["spmv.cg"].count == 1


def test_bicgstab_counts_nothing_and_records_no_span():
    matvec, b = _distinct_eigenvalues(3)
    with torch.profiler.profile(activities=CPU):
        res = solvers.bicgstab(matvec, b, tol=1e-10, maxiter=50)
    assert res.iterations == 3
    assert stats.counters == {} and stats.span_totals == {}


MATRICES = {
    "dia": lambda: (stencil(), "plus_times"),
    "sell": lambda: (scattered(), "plus_times"),
    "sell_min_plus": lambda: (csr_of(abs(sp.random(
        512, 512, density=0.02, random_state=np.random.default_rng(4),
        dtype=np.float32))), "min_plus"),
}


@pytest.mark.parametrize("kind", sorted(MATRICES))
def test_from_matrix_times_its_stages_inside_plan_seconds(kind):
    a, semiring = MATRICES[kind]()
    op = SparseOperator.from_matrix(a, semiring=semiring, device="cpu")
    s = op.stats
    stages = [s["detect_seconds"], s["build_seconds"], s["place_seconds"]]
    assert all(t >= 0 for t in stages)
    assert sum(stages) <= s["plan_seconds"]
    assert stats.span_totals == {}


def test_from_matrix_stages_are_spans_under_the_profiler():
    with torch.profiler.profile(activities=CPU) as prof:
        SparseOperator.from_matrix(stencil(), device="cpu")
    names = {"spmv.plan", "spmv.plan.detect", "spmv.plan.build",
             "spmv.plan.place"}
    assert names <= {e.name for e in prof.events()}
    assert set(stats.span_totals) == names
    for stage in ("detect", "build", "place"):
        assert stats.span_totals[f"spmv.plan.{stage}"].parents == \
            {"spmv.plan": 1}


def test_no_span_takes_the_benchmarks_prefix():
    """Every span name the port's sources give begins ``spmv.``, and so
    does every span a traced run of the planner, the operator and CG
    records."""
    named = re.compile(r"\bspan(?:ned)?\(\s*f?\"([^\"]*)\"")
    found = [m.group(1) for p in sorted(PORT.rglob("*.py"))
             for m in named.finditer(p.read_text())]
    assert len(found) >= 8
    assert all(n.startswith("spmv.") for n in found), found
    with torch.profiler.profile(activities=CPU):
        op = SparseOperator.from_matrix(stencil(), value_dtype=np.float64,
                                        device="cpu")
        b = torch.ones(256, dtype=torch.float64)
        solvers.cg(lambda v: op @ v, b, tol=0.0, maxiter=2)
    assert set(stats.span_totals) == {
        "spmv.plan", "spmv.plan.detect", "spmv.plan.build",
        "spmv.plan.place", "spmv.apply", "spmv.cg", "spmv.cg.read"}
    assert not any(n.startswith("portbench.") for n in stats.span_totals)
