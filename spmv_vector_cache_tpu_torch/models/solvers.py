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
  host sync that JAX's while loop keeps on the device).  :func:`cg`
  makes that read lag one iteration where it can: each ``r . r`` is
  copied into a host slot and waited on by its own event, so the next
  trip can be queued on the card before the host knows whether it is
  wanted (see :func:`cg`); :func:`bicgstab` reads and then queues;
* a fixed-length loop (:func:`jacobi`, :func:`power_iteration`,
  :func:`pagerank`) is a plain loop with no sync.

The arithmetic is the reference's, operation for operation; its dot
products reduce in another order, so near the tolerance an iteration
count may differ by one.

:func:`cg` counts its solves and its host reads in ``utils.stats.counters``
(``cg.solves``, ``cg.host_syncs``): an early exit at iteration k reads
k + 1 times, a solve that runs to ``maxiter`` reads ``maxiter`` times.
``cg.reads_overlapped`` counts the reads made with the next iteration
already queued, ``cg.spec_discarded`` the queued iterations an exit
threw away.  While a torch profiler records, the solve is the span
``spmv.cg`` and each wait for a read ``spmv.cg.read``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..utils.stats import counters, spanned

MatVec = Callable[[torch.Tensor], torch.Tensor]


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int         # read by the host every iteration anyway
    residual_norm: torch.Tensor


def _atol2(b: torch.Tensor, tol: float) -> torch.Tensor:
    """The squared absolute tolerance, on b's device, in b's dtype."""
    return (tol * torch.linalg.vector_norm(b).clamp(min=1e-30)) ** 2


_IDLE: dict = {}    # (device index, stream id, dtype) -> idle _Reads


class _Reads:
    """The host's reads of a solve: a ring of two host slots (pinned on
    the card), each filled by copies queued on the stream with an event
    recorded after them.  A wait is on that event alone, so the work
    queued after the copy runs on; ``bool(t)`` or ``t.item()`` would
    wait for all of it.  On the CPU a copy is done when queued and a
    wait returns at once.

    A solve takes one from ``_IDLE`` and gives it back at its end, so
    slots and events are made once per stream and dtype.  A copy that
    an exit left unread is on the same stream, ahead of any the next
    solve queues into the same slot."""

    def __init__(self, stream, dtype: torch.dtype):
        self.slots = [torch.empty(2, dtype=dtype,
                                  pin_memory=stream is not None)
                      for _ in range(2)]
        self.cells = [(slot[0], slot[1]) for slot in self.slots]
        self.events = None if stream is None else [torch.cuda.Event()
                                                   for _ in range(2)]
        self.stream = stream

    @classmethod
    def take(cls, device: torch.device, dtype: torch.dtype) -> "_Reads":
        stream = None
        key = (None, None, dtype)
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            key = (stream.device_index, stream.stream_id, dtype)
        idle = _IDLE.setdefault(key, [])
        try:
            reads = idle.pop()
        except IndexError:
            reads = cls(stream, dtype)
        reads.idle = idle
        reads.queued = reads.read = 0
        return reads

    def give_back(self) -> None:
        self.idle.append(self)

    def queue(self, *values: torch.Tensor) -> None:
        """Copy the device scalars ``values`` (one, or two) into the
        next slot, without waiting."""
        i = self.queued % 2
        for cell, value in zip(self.cells[i], values):
            cell.copy_(value, non_blocking=True)
        if self.events is not None:
            self.events[i].record(self.stream)
        self.queued += 1

    @spanned("spmv.cg.read")
    def wait(self) -> list:
        """The oldest queued read as Python floats: the host's read of
        the device (a sync), counted as ``cg.host_syncs``."""
        counters["cg.host_syncs"] += 1
        i = self.read % 2
        if self.events is not None:
            self.events[i].synchronize()
        self.read += 1
        return self.slots[i].tolist()


@spanned("spmv.cg")
def cg(matvec: MatVec, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       *, tol: float = 1e-6, maxiter: int = 100,
       M: Optional[MatVec] = None) -> SolveResult:
    """Conjugate gradient for SPD systems, optionally preconditioned.

    Iteration k's residual test ``r_k . r_k > atol2`` is made on the
    host, on the two values in the dtype the device's ``>`` compares in
    (each a Python float exactly, so the test is the device's);
    ``atol2`` comes back with ``r_0 . r_0``, in its slot.  Where the host
    holds the two reads before and their geometric extrapolation,
    ``rr_{k-1}^2 / rr_{k-2}``, is above ``atol2``, iteration k + 1 is
    queued before the host waits for the test of r_k; if the test then
    fails, that iteration's tensors are dropped and x_k, r_k and k
    returned.  The ops are out of
    place, so nothing is recomputed or undone: the result is the
    synchronous loop's bit for bit, and the reads are the same.  The
    rule reads only the solve's own residuals: at ``tol = 0`` every
    read from r_2 on overlaps, and a solve about to converge runs as a
    synchronous one."""
    counters["cg.solves"] += 1
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = r if M is None else M(r)
    p = z
    rz = torch.vdot(r, z)
    atol2 = _atol2(b, tol)
    # the test's dtype: the device's ">" compares in the wider of the two
    dtype = torch.promote_types(r.dtype, atol2.dtype)
    reads = _Reads.take(b.device, dtype)

    def step(x, r, p, rz, read):
        ap = matvec(p)
        alpha = rz / torch.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        if read:
            reads.queue(torch.vdot(r, r))
        z = r if M is None else M(r)
        rz_new = torch.vdot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new

    if maxiter > 0:
        reads.queue(torch.vdot(r, r), atol2)
    state = (x, r, p, rz)
    rr = []                    # the host's reads of r . r, oldest first
    bound = 0.0                # atol2, read with r_0 . r_0
    k = overlapped = discarded = 0
    while k < maxiter:
        # (a product, not ** 2: a Python float's power raises on overflow)
        ahead = len(rr) >= 2 and rr[-1] * rr[-1] > bound * rr[-2]
        if ahead:
            queued = step(*state, k + 1 < maxiter)
        got = reads.wait()
        overlapped += ahead
        if k == 0:
            bound = got[1]
        rr.append(got[0])
        if not rr[-1] > bound:
            discarded += ahead
            break
        state = queued if ahead else step(*state, k + 1 < maxiter)
        k += 1
    reads.give_back()
    counters["cg.reads_overlapped"] += overlapped
    counters["cg.spec_discarded"] += discarded
    return SolveResult(x=state[0], iterations=k,
                       residual_norm=torch.linalg.vector_norm(state[1]))


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
