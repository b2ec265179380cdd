"""Iterative solvers over any ``matvec`` callable; counterpart of
``spmv_vector_cache_tpu/models/solvers.py``.

Every solver is a plain function of a ``matvec`` on 1-D tensors: the
port's ``SparseOperator.matvec`` (its CUDA kernels on the card), the
reference executor ``ops.reference.spmv``, or the sharded
``parallel.spmv_sharded`` with a mesh.  Vectors stay on the device of
``b``.

The reference's loops are ``lax.while_loop`` and ``lax.scan``.  Here:

* a residual-tested loop (:func:`cg`, :func:`bicgstab`) is a Python loop
  whose condition reads one scalar from the device per iteration (the
  host sync that JAX's while loop keeps on the device; a trip of the
  loop cannot be queued before the last one's residual is known);
* a fixed-length loop (:func:`jacobi`, :func:`power_iteration`,
  :func:`pagerank`) is a plain loop with no sync.

The arithmetic is the reference's, operation for operation; its dot
products reduce in another order, so near the tolerance an iteration
count may differ by one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

MatVec = Callable[[torch.Tensor], torch.Tensor]


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int         # read by the host every iteration anyway
    residual_norm: torch.Tensor


def _atol2(b: torch.Tensor, tol: float) -> torch.Tensor:
    """The squared absolute tolerance, on b's device, in b's dtype."""
    return (tol * torch.linalg.vector_norm(b).clamp(min=1e-30)) ** 2


def cg(matvec: MatVec, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       *, tol: float = 1e-6, maxiter: int = 100,
       M: Optional[MatVec] = None) -> SolveResult:
    """Conjugate gradient for SPD systems, optionally preconditioned."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = r if M is None else M(r)
    p = z
    rz = torch.vdot(r, z)
    atol2 = _atol2(b, tol)
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
    return SolveResult(x=x, iterations=k,
                       residual_norm=torch.linalg.vector_norm(r))


def cg_step(matvec: MatVec, state: Tuple[torch.Tensor, ...]):
    """One CG iteration on ``(x, r, p, rz)``: the flagship step, with no
    host sync."""
    x, r, p, rz = state
    ap = matvec(p)
    alpha = rz / torch.vdot(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    rz_new = torch.vdot(r, r)
    p = r + (rz_new / rz) * p
    return x, r, p, rz_new


def bicgstab(matvec: MatVec, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, *, tol: float = 1e-6,
             maxiter: int = 100) -> SolveResult:
    """BiCGSTAB for general (non-symmetric) systems."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    atol2 = _atol2(b, tol)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = one
    k = 0
    while k < maxiter and bool(torch.vdot(r, r) > atol2):
        rho_new = torch.vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = matvec(p)
        alpha = rho_new / torch.vdot(rhat, v)
        s = r - alpha * v
        t = matvec(s)
        omega = torch.vdot(t, s) / torch.vdot(t, t).clamp(min=1e-30)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        k += 1
    return SolveResult(x=x, iterations=k,
                       residual_norm=torch.linalg.vector_norm(r))


def jacobi(matvec: MatVec, diag: torch.Tensor, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None, *, iters: int = 50,
           omega: float = 1.0) -> torch.Tensor:
    """(Weighted) Jacobi iteration: x += omega * (b - A x) / diag."""
    x = torch.zeros_like(b) if x0 is None else x0
    inv_d = torch.where(diag != 0, 1.0 / diag, torch.zeros_like(diag))
    for _ in range(iters):
        x = x + omega * inv_d * (b - matvec(x))
    return x


def power_iteration(matvec: MatVec, v0: torch.Tensor, *, iters: int = 50
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dominant eigenpair by power iteration."""
    v = v0 / torch.linalg.vector_norm(v0)
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.linalg.vector_norm(w).clamp(min=1e-30)
    lam = torch.vdot(v, matvec(v))
    return lam, v


def pagerank(matvec_transpose: MatVec, n: int, *, damping: float = 0.85,
             iters: int = 50, dtype=torch.float32,
             device="cuda") -> torch.Tensor:
    """PageRank over a column-stochastic link matrix ``P``: the matvec must
    compute ``P @ r`` (use the CSC/CSR duality to get the transpose free).
    The ranks live on ``device`` (the card unless the caller asks for
    ``"cpu"``)."""
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=device)
    for _ in range(iters):
        r = damping * matvec_transpose(r) + (1.0 - damping) / n
        r = r / torch.sum(r)
    return r
