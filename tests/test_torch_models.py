"""Port parity for the models over the operator (``models/solvers``,
``models/gnn``) and for the slice as a whole, on the CPU.

* Every solver runs over the port's ``reference.spmv`` and over a
  ``SparseOperator(device="cpu")`` (the kernels' plain versions) against
  the JAX solver over the JAX ``reference.spmv`` on the same seeded
  inputs.  The fixed-length loops (Jacobi, power iteration, PageRank)
  must agree to 1e-5 relative; the residual-tested ones (CG, BiCGSTAB)
  in x to 1e-4 relative, and in their iteration count exactly: the
  systems here converge fast enough that no float32 residual lands on
  the tolerance (where one did, the count could differ by one, since the
  dot products reduce in another order).
* The slice: the flagship ``__graft_entry__.entry()`` CG step on its
  Pallas DiaPlan against ``cg_step`` over the plan carried across
  (1e-5); ILU(0)-preconditioned CG (the JAX package's
  ``test_ilu0_preconditioner_accelerates_cg`` setup) against the JAX
  one; one sharded CG step at ``dryrun_multichip``'s shapes over
  ``make_mesh(8, device="cpu")`` against the JAX step on its 8 virtual
  devices.
* GCN: normalized adjacency byte-equal; forward and ``backward()`` with
  the JAX parameters carried across against ``jax.grad``, to 1e-4.
* Gradients: the port's operator refuses an operand that requires a
  gradient while autograd records, where ``jax.grad`` through the JAX
  operator's Pallas kernels fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu.formats import convert as jconvert
from spmv_vector_cache_tpu.models import gnn as jgnn
from spmv_vector_cache_tpu.models import solvers as jsolvers
from spmv_vector_cache_tpu.ops import operator as joperator
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops import sptrsv as jtri
from spmv_vector_cache_tpu_torch.formats import convert as pconvert
from spmv_vector_cache_tpu_torch.formats.containers import CSR
from spmv_vector_cache_tpu_torch.formats.plan import place
from spmv_vector_cache_tpu_torch.interop import (gcn_params_from_reference,
                                                 plan_from_reference)
from spmv_vector_cache_tpu_torch.models import gnn, solvers
from spmv_vector_cache_tpu_torch.ops import reference, sptrsv
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from spmv_vector_cache_tpu_torch.ops.spmv_sell import spmv_plan
from tests.test_torch_spgemm_sptrsv import spd_banded

CPU = torch.device("cpu")


def _t(v):
    return torch.from_numpy(np.asarray(v).copy())


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def spd_matrix(n, density=0.05, seed=0):
    """``tests/test_models.py``'s SPD matrix: B B^T + n I, float32."""
    b = sp.random(n, n, density=density, format="csr",
                  random_state=np.random.RandomState(seed), dtype=np.float64)
    a = (b @ b.T + n * sp.eye(n)).tocsr()
    a.sort_indices()
    return a.astype(np.float32)


def dominant(n, seed, density=0.1):
    """A diagonally dominant nonsymmetric matrix, float32."""
    m = sp.random(n, n, density=density, format="csr",
                  random_state=np.random.RandomState(seed), dtype=np.float64)
    m = (m + n * sp.eye(n)).tocsr()
    m.sort_indices()
    return m.astype(np.float32)


def _matvecs(m):
    """(JAX matvec, the port's matvecs by name) of one scipy matrix."""
    ja, pa = jconvert.from_scipy(m), pconvert.from_scipy(m)
    op = SparseOperator.from_matrix(pa, device="cpu")
    return (lambda v: jref.spmv(ja, v)), {
        "reference": lambda v: reference.spmv(pa, v),
        "operator": op.matvec,
    }


PORT_MATVECS = ["reference", "operator"]


@pytest.mark.parametrize("via", PORT_MATVECS)
@pytest.mark.parametrize("n,seed", [(128, 0), (200, 1)])
def test_cg_matches_jax(via, n, seed):
    m = spd_matrix(n, seed=seed)
    jmv, pmv = _matvecs(m)
    b = np.random.default_rng(seed + 10).standard_normal(n).astype(
        np.float32)
    want = jsolvers.cg(jmv, jnp.asarray(b), tol=1e-6, maxiter=200)
    got = solvers.cg(pmv[via], _t(b), tol=1e-6, maxiter=200)
    assert got.iterations == int(want.iterations) > 0
    _close(got.x, want.x, 1e-4)
    assert float(got.residual_norm) < 1e-4 * np.linalg.norm(b)


@pytest.mark.parametrize("via", PORT_MATVECS)
def test_preconditioned_cg_matches_jax(via):
    n = 128
    m = spd_matrix(n, seed=2)
    d = m.diagonal().astype(np.float32)
    jmv, pmv = _matvecs(m)
    b = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    want = jsolvers.cg(jmv, jnp.asarray(b), tol=1e-8, maxiter=500,
                       M=lambda r: r / jnp.asarray(d))
    got = solvers.cg(pmv[via], _t(b), tol=1e-8, maxiter=500,
                     M=lambda r: r / _t(d))
    assert got.iterations == int(want.iterations)
    _close(got.x, want.x, 1e-4)


@pytest.mark.parametrize("via", PORT_MATVECS)
def test_cg_stops_at_maxiter_and_takes_x0(via):
    m = spd_matrix(128, seed=4)
    jmv, pmv = _matvecs(m)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(128).astype(np.float32)
    x0 = rng.standard_normal(128).astype(np.float32)
    want = jsolvers.cg(jmv, jnp.asarray(b), jnp.asarray(x0), tol=1e-12,
                       maxiter=3)
    got = solvers.cg(pmv[via], _t(b), _t(x0), tol=1e-12, maxiter=3)
    assert got.iterations == int(want.iterations) == 3
    _close(got.x, want.x, 1e-5)
    _close(got.residual_norm, want.residual_norm, 1e-4)


@pytest.mark.parametrize("via", PORT_MATVECS)
def test_bicgstab_matches_jax(via):
    n = 96
    m = dominant(n, seed=6)
    jmv, pmv = _matvecs(m)
    b = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    want = jsolvers.bicgstab(jmv, jnp.asarray(b), tol=1e-6, maxiter=300)
    got = solvers.bicgstab(pmv[via], _t(b), tol=1e-6, maxiter=300)
    assert got.iterations == int(want.iterations) > 0
    _close(got.x, want.x, 1e-4)
    r = b - m.astype(np.float64) @ got.x.numpy()
    assert np.linalg.norm(r) < 1e-3 * np.linalg.norm(b)


@pytest.mark.parametrize("via", PORT_MATVECS)
def test_jacobi_matches_jax(via):
    n = 80
    m = dominant(n, seed=8, density=0.05)
    d = m.diagonal().astype(np.float32)
    jmv, pmv = _matvecs(m)
    b = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    want = jsolvers.jacobi(jmv, jnp.asarray(d), jnp.asarray(b), iters=100,
                           omega=0.9)
    got = solvers.jacobi(pmv[via], _t(d), _t(b), iters=100, omega=0.9)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("via", PORT_MATVECS)
def test_power_iteration_matches_jax(via):
    m = spd_matrix(64, seed=10)
    jmv, pmv = _matvecs(m)
    v0 = np.random.default_rng(11).standard_normal(64).astype(np.float32)
    jlam, jv = jsolvers.power_iteration(jmv, jnp.asarray(v0), iters=200)
    lam, v = solvers.power_iteration(pmv[via], _t(v0), iters=200)
    _close(lam, jlam, 1e-5)
    _close(v, jv, 1e-4)
    lam_true = np.linalg.eigvalsh(m.toarray().astype(np.float64)).max()
    assert abs(float(lam) - lam_true) / lam_true < 1e-3


@pytest.mark.parametrize("via", PORT_MATVECS)
def test_pagerank_matches_jax(via):
    # a column-stochastic P of a random graph with out-degree >= 1
    n = 64
    rng = np.random.default_rng(12)
    src = np.concatenate([np.arange(n), rng.integers(0, n, 4 * n)])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, 4 * n)])
    adj = sp.csr_matrix((np.ones(src.shape[0]), (src, dst)), shape=(n, n))
    adj.data[:] = 1.0
    out_deg = np.asarray(adj.sum(axis=1)).ravel()
    p = sp.csr_matrix(adj.T.multiply(1.0 / out_deg[None, :]))
    jmv, pmv = _matvecs(p.astype(np.float32))
    want = jsolvers.pagerank(jmv, n, iters=60)
    got = solvers.pagerank(pmv[via], n, iters=60, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _close(got, want, 1e-5)
    assert abs(float(got.sum()) - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_entry_cg_step_matches_jax():
    """``__graft_entry__.entry()``: one CG step over a Pallas DiaPlan
    (n = 4096), against ``cg_step`` over the same plan carried across."""
    from __graft_entry__ import entry

    fn, (plan, state) = entry()
    assert type(plan).__name__ == "DiaPlan"
    want = jax.jit(fn)(plan, state)
    pplan = plan_from_reference(plan, device="cpu")
    got = solvers.cg_step(lambda v: spmv_plan(pplan, v),
                          tuple(_t(s) for s in state))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    # and over the operator of the same matrix, built by the port
    from __graft_entry__ import _banded_system

    a = _banded_system(4096)
    op = SparseOperator.from_matrix(
        CSR(data=np.asarray(a.data), indices=np.asarray(a.indices),
            indptr=np.asarray(a.indptr), shape=a.shape), device="cpu")
    assert type(op.plan).__name__ == "DiaPlan" and op.strategy == "dia"
    got = solvers.cg_step(op.matvec, tuple(_t(s) for s in state))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_ilu0_preconditioned_cg_matches_jax():
    """The JAX package's ``test_ilu0_preconditioner_accelerates_cg``
    setup (n = 256, band 3), both packages' PCG side by side."""
    n = 256
    rng = np.random.default_rng(13)
    m = spd_banded(rng, n, band=3)
    b = rng.standard_normal(n).astype(np.float32)
    m32 = m.astype(np.float32)
    ja, ja32 = jconvert.from_scipy(m), jconvert.from_scipy(m32)
    pa, pa32 = pconvert.from_scipy(m), pconvert.from_scipy(m32)

    jl, ju = jtri.ilu0(ja)
    jlp = jtri.build_trisolve_plan(jl, lower=True, unit_diag=True)
    jup = jtri.build_trisolve_plan(ju, lower=False)
    jmv = lambda v: jref.spmv(ja32, v)
    jplain = jsolvers.cg(jmv, jnp.asarray(b), tol=1e-8, maxiter=400)
    jpc = jsolvers.cg(jmv, jnp.asarray(b), tol=1e-8, maxiter=400,
                      M=lambda r: jtri.trisolve(jup, jtri.trisolve(jlp, r)))

    pl, pu = sptrsv.ilu0(pa)
    lp = place(sptrsv.build_trisolve_plan(pl, lower=True, unit_diag=True),
               CPU)
    up = place(sptrsv.build_trisolve_plan(pu, lower=False), CPU)
    op = SparseOperator.from_matrix(pa32, device="cpu")
    plain = solvers.cg(op.matvec, _t(b), tol=1e-8, maxiter=400)
    pc = solvers.cg(op.matvec, _t(b), tol=1e-8, maxiter=400,
                    M=lambda r: sptrsv.trisolve(up, sptrsv.trisolve(lp, r)))

    assert pc.iterations < plain.iterations
    assert float(pc.residual_norm) < 1e-4 * np.linalg.norm(b)
    assert plain.iterations == int(jplain.iterations)
    assert pc.iterations == int(jpc.iterations)
    _close(pc.x, jpc.x, 1e-4)
    _close(plain.x, jplain.x, 1e-4)


def test_sharded_cg_step_matches_jax():
    """``dryrun_multichip``'s sharded CG step (n = 128 * 8, the banded
    system, all-gather exchange, b from ``default_rng(2)``) on the port's
    8-shard CPU mesh against the JAX step on 8 virtual devices (the JAX
    side on its plain sharded route: its interpreted Pallas route
    computes the same y)."""
    from __graft_entry__ import _banded_system
    from spmv_vector_cache_tpu.parallel.spmv_sharded import (
        build_sharded_plan as jbuild, spmv_sharded as jspmv)
    from spmv_vector_cache_tpu_torch.parallel import (build_sharded_plan,
                                                      make_mesh,
                                                      spmv_sharded)

    n_dev = 8
    n = 128 * n_dev
    a = _banded_system(n)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    jsp = jax.tree.map(jnp.asarray, jbuild(a, n_dev))
    b = np.random.default_rng(2).standard_normal(n).astype(np.float32)

    def jstep(x, r, p, rz):
        ap = jspmv(jsp, p, jmesh, mode="all_gather", use_pallas=False)
        alpha = rz / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rz_new = jnp.vdot(r, r)
        return x, r, r + (rz_new / rz) * p, rz_new

    bj = jnp.asarray(b)
    want = jstep(jnp.zeros(n, jnp.float32), bj, bj, jnp.vdot(bj, bj))

    mesh = make_mesh(n_dev, device="cpu")
    pa = CSR(data=np.asarray(a.data), indices=np.asarray(a.indices),
             indptr=np.asarray(a.indptr), shape=a.shape)
    psp = build_sharded_plan(pa, n_dev)
    bt = _t(b)
    got = solvers.cg_step(
        lambda v: spmv_sharded(psp, v, mesh, mode="all_gather"),
        (torch.zeros(n), bt, bt, torch.vdot(bt, bt)))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    assert np.linalg.norm(got[1].numpy()) < np.linalg.norm(b)


def test_cg_over_the_sharded_executor_matches_jax():
    from __graft_entry__ import _banded_system
    from spmv_vector_cache_tpu_torch.parallel import (build_sharded_plan,
                                                      make_mesh,
                                                      spmv_sharded)

    n = 1024
    a = _banded_system(n)
    b = np.random.default_rng(16).standard_normal(n).astype(np.float32)
    want = jsolvers.cg(lambda v: jref.spmv(a, v), jnp.asarray(b), tol=1e-6)
    mesh = make_mesh(4, device="cpu")
    psp = build_sharded_plan(
        CSR(data=np.asarray(a.data), indices=np.asarray(a.indices),
            indptr=np.asarray(a.indptr), shape=a.shape), 4)
    got = solvers.cg(lambda v: spmv_sharded(psp, v, mesh), _t(b), tol=1e-6)
    assert got.iterations == int(want.iterations)
    _close(got.x, want.x, 1e-4)


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

def _graph(n, density, seed):
    m = sp.random(n, n, density=density, format="csr",
                  random_state=np.random.RandomState(seed), dtype=np.float64)
    m.sort_indices()
    return m.astype(np.float32)


def test_normalized_adjacency_byte_equal():
    m = _graph(300, 0.02, 17)
    for loops in (True, False):
        want = jgnn.normalized_adjacency(jconvert.from_scipy(m), loops)
        got = gnn.normalized_adjacency(pconvert.from_scipy(m), loops)
        for f in ("data", "indices", "indptr"):
            a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("sizes", [[8, 16, 4], [12, 32, 32, 5]])
def test_gcn_forward_and_grad_match_jax(sizes):
    n = 96
    rng = np.random.default_rng(18)
    m = _graph(n, 0.05, 19)
    ja = jgnn.normalized_adjacency(jconvert.from_scipy(m))
    pa = gnn.normalized_adjacency(pconvert.from_scipy(m))
    h = rng.standard_normal((n, sizes[0])).astype(np.float32)
    jparams = jgnn.init_gcn_params(jax.random.PRNGKey(0), sizes)
    # the biases are zero at init: make them count
    jparams = [(w, b + 0.1 * (i + 1)) for i, (w, b) in enumerate(jparams)]

    def jloss(params):
        return jnp.sum(jgnn.gcn_forward(ja, jnp.asarray(h), params) ** 2)

    want_out = jgnn.gcn_forward(ja, jnp.asarray(h), jparams)
    want_grads = jax.grad(jloss)(jparams)

    params = gcn_params_from_reference(jparams, device="cpu")
    for w, b in params:
        w.requires_grad_()
        b.requires_grad_()
    out = gnn.gcn_forward(pa, _t(h), params)
    assert out.shape == (n, sizes[-1])
    _close(out, want_out, 1e-4)
    torch.sum(out ** 2).backward()
    for (w, b), (gw, gb) in zip(params, want_grads):
        _close(w.grad, gw, 1e-4)
        _close(b.grad, gb, 1e-4)
        assert torch.isfinite(w.grad).all() and w.grad.abs().max() > 0


def test_gcn_over_the_operator_matches_reference():
    n = 256
    m = _graph(n, 0.03, 20)
    pa = gnn.normalized_adjacency(pconvert.from_scipy(m))
    op = SparseOperator.from_matrix(pa, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = gnn.init_gcn_params(gen, [16, 32, 8], device="cpu")
    x = torch.randn((n, 16), generator=gen)
    want = gnn.gcn_forward(pa, x, params)
    with torch.no_grad():
        got = gnn.gcn_forward(pa, x, params, spmm=lambda _, b: op.matmat(b))
    _close(got, want.detach().numpy(), 1e-5)


def test_init_gcn_params():
    sizes = [10, 20, 3]
    p1 = gnn.init_gcn_params(torch.Generator().manual_seed(1), sizes,
                             device="cpu")
    p2 = gnn.init_gcn_params(torch.Generator().manual_seed(1), sizes,
                             device="cpu")
    for i, ((w, b), (w2, b2)) in enumerate(zip(p1, p2)):
        lim = np.sqrt(6.0 / (sizes[i] + sizes[i + 1]))
        assert w.shape == (sizes[i], sizes[i + 1]) and b.shape == (
            sizes[i + 1],)
        assert w.dtype == b.dtype == torch.float32
        assert float(w.abs().max()) <= lim and float(w.std()) > lim / 4
        assert torch.equal(w, w2) and not b.any()
    p64 = gnn.init_gcn_params(torch.Generator().manual_seed(1), sizes,
                              dtype=torch.float64, device="cpu")
    assert p64[0][0].dtype == torch.float64


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def test_jax_operator_has_no_gradient():
    """The reference: ``jax.grad`` through its Pallas kernels fails."""
    m = sp.diags([np.ones(512 - 1), 2 * np.ones(512), np.ones(512 - 1)],
                 [-1, 0, 1]).tocsr().astype(np.float32)
    jop = joperator.SparseOperator.from_matrix(jconvert.from_scipy(m))
    assert type(jop.plan).__name__ == "DiaPlan"
    x = jnp.ones(512, jnp.float32)
    with pytest.raises(AssertionError):
        jax.grad(lambda v: jnp.sum(jop.matvec(v) ** 2))(x)
    with pytest.raises(AssertionError):
        jax.grad(lambda B: jnp.sum(jop.matmat(B) ** 2))(
            jnp.ones((512, 4), jnp.float32))


@pytest.mark.parametrize("call", ["matvec", "matmat", "matmul_x", "matmul_b"])
def test_operator_refuses_an_operand_that_requires_grad(call):
    m = sp.diags([np.ones(511), 2 * np.ones(512), np.ones(511)],
                 [-1, 0, 1]).tocsr().astype(np.float32)
    op = SparseOperator.from_matrix(pconvert.from_scipy(m), device="cpu")
    vec = call in ("matvec", "matmul_x")
    v = torch.ones(512) if vec else torch.ones((512, 4))
    run = {"matvec": op.matvec, "matmat": op.matmat,
           "matmul_x": op.__matmul__, "matmul_b": op.__matmul__}[call]
    with pytest.raises(RuntimeError, match="no gradient"):
        run(v.clone().requires_grad_())
    # a gradient-carrying product through a layer refuses as well
    w = torch.ones((), requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        run(v * w)
    want = run(v)
    assert not want.requires_grad
    with torch.no_grad():
        assert torch.equal(run(v.clone().requires_grad_()), want)
    assert torch.equal(run(v.clone().requires_grad_().detach()), want)
