"""The synchronous CG loop that ``models.solvers.cg`` is held to, bit for
bit, in ``tests/test_torch_cg_overlap.py`` (on the CPU) and
``tests/test_torch_cuda.py`` (on the card)."""

import torch

from spmv_vector_cache_tpu_torch.models import solvers


def sync_cg(matvec, b, x0=None, *, tol=1e-6, maxiter=100, M=None):
    """CG with the host's blocking read before every iteration: the
    loop ``cg`` must equal, as ``(x, iterations, residual_norm)``."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = r if M is None else M(r)
    p = z
    rz = torch.vdot(r, z)
    atol2 = solvers._atol2(b, tol)
    k = 0
    while k < maxiter and bool(torch.vdot(r, r) > atol2):
        ap = matvec(p)
        alpha = rz / torch.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = r if M is None else M(r)
        rz_new = torch.vdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k, torch.linalg.vector_norm(r)


def assert_same(res, want):
    x, k, rnorm = want
    assert res.iterations == k
    assert res.x.dtype == x.dtype and torch.equal(res.x, x)
    assert torch.equal(res.residual_norm, rnorm)
