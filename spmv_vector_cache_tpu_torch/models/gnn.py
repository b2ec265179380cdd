"""Graph neural network building blocks over the SpMM; counterpart of
``spmv_vector_cache_tpu/models/gnn.py``.

A GCN layer is the library's SpMM against the normalized adjacency
(``H' = act(Â H W)``).  The aggregate defaults to the reference SpMM
(``ops.reference.spmm``, torch ops on the device of H), which carries
gradients to its dense operand, as the reference's does under
``jax.grad``.  ``spmm=lambda a, m: op.matmat(m)`` runs a planned
operator's SpMM instead: its kernels have no gradient, so it refuses an
operand that requires one while autograd records (use it under
``torch.no_grad()``).
The dense ``H W`` is ``torch.matmul``: the reference computes it outside
any Pallas kernel (``jnp.dot``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..formats.containers import COO, CSR
from ..formats.convert import coo_to_csr, csr_to_coo
from ..ops import reference


def normalized_adjacency(adj: CSR, add_self_loops: bool = True) -> CSR:
    """Symmetric GCN normalization D^-1/2 (A + I) D^-1/2 (host-side prep)."""
    coo = csr_to_coo(adj)
    row = np.asarray(coo.row)
    col = np.asarray(coo.col)
    val = np.ones_like(np.asarray(coo.data), dtype=np.float32)
    n = adj.shape[0]
    if add_self_loops:
        row = np.concatenate([row, np.arange(n, dtype=row.dtype)])
        col = np.concatenate([col, np.arange(n, dtype=col.dtype)])
        val = np.concatenate([val, np.ones(n, np.float32)])
    deg = np.bincount(row, weights=val, minlength=n)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    val = val * dinv[row] * dinv[col]
    return coo_to_csr(COO(data=val.astype(np.float32),
                          row=row.astype(np.int32), col=col.astype(np.int32),
                          shape=adj.shape))


def gcn_layer(a_norm, h: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None,
              activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
              spmm: Optional[Callable] = None) -> torch.Tensor:
    """One GCN layer: ``act(Â @ (H W) + b)``.

    ``spmm(a_norm, m)``: override the sparse aggregate (e.g. a planned
    operator's ``op.matmat(m)``, or the sharded executor); defaults to
    the reference SpMM on H's device.
    """
    hw = torch.matmul(h, w)
    agg = (spmm or reference.spmm)(a_norm, hw)
    if b is not None:
        agg = agg + b
    return activation(agg)


def init_gcn_params(generator: torch.Generator, sizes, dtype=torch.float32,
                    device="cuda") -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Glorot-initialized (W, b) per layer for sizes [in, h1, ..., out],
    drawn from ``generator`` on its own device and put on ``device`` (the
    card unless the caller asks for ``"cpu"``).  The draws differ from
    the reference's ``jax.random`` ones; ``interop.gcn_params_from_reference``
    carries the reference's parameters across instead."""
    params = []
    for i in range(len(sizes) - 1):
        lim = float(np.sqrt(6.0 / (sizes[i] + sizes[i + 1])))
        u = torch.rand((sizes[i], sizes[i + 1]), generator=generator,
                       dtype=dtype, device=generator.device)
        w = (u * (2 * lim) - lim).to(device)
        params.append((w, torch.zeros((sizes[i + 1],), dtype=dtype,
                                      device=device)))
    return params


def gcn_forward(a_norm, x: torch.Tensor, params,
                spmm: Optional[Callable] = None) -> torch.Tensor:
    """Multi-layer GCN forward; last layer linear (logits)."""
    h = x
    for i, (w, b) in enumerate(params):
        act = torch.relu if i < len(params) - 1 else (lambda z: z)
        h = gcn_layer(a_norm, h, w, b, activation=act, spmm=spmm)
    return h
