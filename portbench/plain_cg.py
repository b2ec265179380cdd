"""Plain unpreconditioned conjugate gradient, the reference of the solve
cells.  Plain torch over any reference ``matvec``; it imports nothing of
the port."""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def plain_cg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
             iterations: int) -> Tuple[torch.Tensor, float]:
    """``iterations`` CG steps from x0 = 0 with no early exit, in b's
    dtype.  Returns x and the norm of the recurrence residual."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.dot(r, r)
    for _ in range(iterations):
        ap = matvec(p)
        alpha = rr / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
    return x, float(torch.linalg.vector_norm(r))
