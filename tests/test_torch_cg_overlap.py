"""``models.solvers.cg``'s lagged residual read, on the CPU.

``cg`` queues iteration k + 1 before it waits for the test of r_k where
the residual history says that test will pass, and drops that
iteration's tensors where it fails.  Held against the synchronous loop
of ``tests/cg_reference.py`` (``sync_cg``, which reads
``bool(r . r > atol2)`` before every iteration), it must give the same
``x``, iteration count and residual norm bit for bit:

* at ``tol = 0`` for ``maxiter`` 0 to 9, where every read from r_2 on
  overlaps and nothing is discarded;
* at early exits after 2, 3 and 5 iterations (a matvec with that many
  distinct eigenvalues), which the extrapolation misses: one queued
  iteration is thrown away;
* with a Jacobi preconditioner, and on the port's operator;
* in float32 and float64;
* where ``(r . r)^2`` passes a float's range, and with a solve nested
  in another's preconditioner.

A preconditioned solve that converges in one iteration speculates
nothing; solves in turn reuse one ring of host slots.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu_torch import CSR, SparseOperator
from spmv_vector_cache_tpu_torch.models import solvers
from spmv_vector_cache_tpu_torch.utils import stats
from cg_reference import assert_same, sync_cg

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def overlap_counts():
    return (stats.counters["cg.host_syncs"],
            stats.counters["cg.reads_overlapped"],
            stats.counters["cg.spec_discarded"])


@pytest.fixture(autouse=True)
def fresh():
    stats.counters.clear()
    yield
    stats.counters.clear()


def stencil(n, dtype):
    """An SPD tridiagonal matrix and its diagonal."""
    m = sp.diags([-1.0, 2.5, -1.0], [-1, 0, 1], shape=(n, n),
                 dtype=np.float64).tocsr()
    m.sort_indices()
    return m, torch.full((n,), 2.5, dtype=dtype)


def dense_matvec(m, dtype):
    a = torch.from_numpy(m.toarray()).to(dtype)
    return lambda v: a @ v


def rhs(n, dtype, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n)).to(dtype)


def distinct_eigenvalues(k, dtype, n=300):
    """diag(1, 2, ..., k, 1, 2, ...): k distinct eigenvalues, so CG
    converges in k iterations."""
    d = torch.arange(1, k + 1, dtype=dtype).repeat(n // k)
    return (lambda v: d * v), torch.ones(n // k * k, dtype=dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("maxiter", [0, 1, 2, 3, 9])
def test_tol_zero_equals_the_synchronous_loop(maxiter, dtype):
    m, _ = stencil(200, DTYPES[dtype])
    matvec, b = dense_matvec(m, DTYPES[dtype]), rhs(200, DTYPES[dtype])
    res = solvers.cg(matvec, b, tol=0.0, maxiter=maxiter)
    assert_same(res, sync_cg(matvec, b, tol=0.0, maxiter=maxiter))
    assert overlap_counts() == (maxiter, max(maxiter - 2, 0), 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", [2, 3, 5])
def test_a_missed_early_exit_discards_one_iteration(k, dtype):
    matvec, b = distinct_eigenvalues(k, DTYPES[dtype])
    tol = 1e-10 if dtype == "float64" else 1e-5
    res = solvers.cg(matvec, b, tol=tol, maxiter=50)
    assert_same(res, sync_cg(matvec, b, tol=tol, maxiter=50))
    assert res.iterations == k
    # reads r_0 .. r_k; those of r_2 .. r_k had the next iteration queued,
    # and the one queued behind the failed test of r_k was thrown away
    assert overlap_counts() == (k + 1, k - 1, 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_a_jacobi_preconditioned_solve_equals_the_synchronous_loop(dtype):
    m, diag = stencil(300, DTYPES[dtype])
    m = m + sp.diags(np.linspace(0.0, 3.0, 300))
    diag = diag + torch.linspace(0.0, 3.0, 300, dtype=DTYPES[dtype])
    matvec, b = dense_matvec(m, DTYPES[dtype]), rhs(300, DTYPES[dtype], 1)

    def jacobi(r):
        return r / diag

    res = solvers.cg(matvec, b, tol=1e-5, maxiter=200, M=jacobi)
    want = sync_cg(matvec, b, tol=1e-5, maxiter=200, M=jacobi)
    assert_same(res, want)
    assert 2 < want[1] < 200
    syncs, overlapped, discarded = overlap_counts()
    assert syncs == want[1] + 1 and overlapped + 2 <= syncs
    assert discarded in (0, 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_a_one_iteration_preconditioned_solve_speculates_nothing(dtype):
    d = torch.linspace(1.0, 9.0, 300, dtype=DTYPES[dtype])

    def matvec(v):
        return d * v

    def exact(r):
        return r / d

    b = rhs(300, DTYPES[dtype], 2)
    res = solvers.cg(matvec, b, tol=1e-5, maxiter=50, M=exact)
    assert_same(res, sync_cg(matvec, b, tol=1e-5, maxiter=50, M=exact))
    assert res.iterations == 1
    assert overlap_counts() == (2, 0, 0)


@pytest.mark.parametrize("tol", [0.0, 1e-9])
def test_cg_on_the_operator_equals_the_synchronous_loop(tol):
    m, _ = stencil(256, torch.float64)
    op = SparseOperator.from_matrix(
        CSR(data=m.data, indices=m.indices, indptr=m.indptr, shape=m.shape),
        value_dtype=np.float64, device="cpu")
    b = rhs(256, torch.float64, 3)
    res = solvers.cg(op.matvec, b, tol=tol, maxiter=40)
    assert_same(res, sync_cg(op.matvec, b, tol=tol, maxiter=40))
    assert stats.counters["cg.solves"] == 1


def test_the_counters_add_up_over_solves():
    matvec, b = distinct_eigenvalues(3, torch.float64)
    m, _ = stencil(200, torch.float64)
    for _ in range(2):
        solvers.cg(matvec, b, tol=1e-10, maxiter=50)
        solvers.cg(dense_matvec(m, torch.float64), rhs(200, torch.float64),
                   tol=0.0, maxiter=6)
    assert dict(stats.counters) == {
        "cg.solves": 4, "cg.host_syncs": 2 * (4 + 6),
        "cg.reads_overlapped": 2 * (2 + 4), "cg.spec_discarded": 2}


@pytest.mark.parametrize("tol", [0.0, 1e-6])
def test_a_residual_whose_square_overflows_equals_the_synchronous_loop(tol):
    # r . r near 1e162: its square is past a float's range, which the
    # speculation rule must take as inf, not raise on
    m, _ = stencil(200, torch.float64)
    matvec = dense_matvec(m, torch.float64)
    b = rhs(200, torch.float64, 4) * 1e80
    res = solvers.cg(matvec, b, tol=tol, maxiter=9)
    assert_same(res, sync_cg(matvec, b, tol=tol, maxiter=9))
    assert res.iterations > 2


def test_solves_in_turn_reuse_one_ring_of_slots(monkeypatch):
    monkeypatch.setattr(solvers, "_IDLE", {})
    m, _ = stencil(200, torch.float64)
    matvec, b = dense_matvec(m, torch.float64), rhs(200, torch.float64)
    solvers.cg(matvec, b, tol=0.0, maxiter=5)
    (ring,), = solvers._IDLE.values()
    for maxiter in (3, 0, 7):
        res = solvers.cg(matvec, b, tol=0.0, maxiter=maxiter)
        assert_same(res, sync_cg(matvec, b, tol=0.0, maxiter=maxiter))
    assert list(solvers._IDLE.values()) == [[ring]]
    solvers.cg(dense_matvec(m, torch.float32), b.float(), tol=0.0,
               maxiter=3)
    assert sorted(len(v) for v in solvers._IDLE.values()) == [1, 1]


def test_a_solve_nested_in_the_preconditioner_takes_its_own_ring(
        monkeypatch):
    # M runs three iterations of an inner CG on the diagonal: the inner
    # solves read while the outer one holds queued reads
    monkeypatch.setattr(solvers, "_IDLE", {})
    m, diag = stencil(300, torch.float64)
    m = m + sp.diags(np.linspace(0.0, 3.0, 300))
    diag = diag + torch.linspace(0.0, 3.0, 300, dtype=torch.float64)
    matvec, b = dense_matvec(m, torch.float64), rhs(300, torch.float64, 5)

    def inner(solve):
        return lambda r: solve(lambda v: diag * v, r, tol=0.0,
                               maxiter=3)[0]

    res = solvers.cg(matvec, b, tol=1e-8, maxiter=100,
                     M=inner(solvers.cg))
    want = sync_cg(matvec, b, tol=1e-8, maxiter=100, M=inner(sync_cg))
    assert_same(res, want)
    assert want[1] > 2 and stats.counters["cg.reads_overlapped"] > 0
    assert [len(v) for v in solvers._IDLE.values()] == [2]

