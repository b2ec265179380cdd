"""Sparse triangular solve + ILU(0) factorization; counterpart of
``spmv_vector_cache_tpu/ops/sptrsv.py``.

A triangular matrix is densified on the host into 128-row blocks (the
reference's :class:`TriSolvePlan`, byte for byte): the dense diagonal
blocks, and for each block row its W nearest neighbour blocks.  The
solve sweeps the blocks in order, forward for a lower matrix and
backward for an upper one; block i waits for its W neighbours.

The reference's sweep is a ``lax.scan``: each step subtracts the W
neighbour products from the right-hand side and multiplies by the
inverse of the diagonal block, which it inverts on every call.  Here
the sweep is a Python loop of one launch a step on the plan's device:

* once, when the plan is placed (:func:`build_sweep`, the plan's
  ``sweep``), the inverses ``D_i^-1`` and the coupling
  ``G_i = D_i^-1 [N_i,1 ... N_i,W]``, the W neighbour blocks side by
  side in the order in which their solved blocks lie in memory;
* per call, one batched product ``c = D^-1 b`` for all blocks at once;
* per block, ``x_i = c_i - G_i x_nbrs``: one ``addmv_`` in place, over
  the contiguous W solved neighbour blocks of a zero-padded x.

Mathematically this is the reference's ``D_i^-1 (b_i - sum N x)``; the
float32 rounding differs.  The chain of ``nb`` dependent steps makes the
solve host-bound on the card (PERF.md).

ILU(0) itself (:func:`ilu0`) is sequential host preprocessing: the
reference's vectorized-numpy Doolittle on the fixed pattern, run once;
the solves run on the device every iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..formats.containers import CSR
from ..formats.tables import table

Array = Any

BLOCK = 128


class Sweep(NamedTuple):
    """The per-plan operators of the sweep (see the module docstring)."""

    inv: torch.Tensor        # (nb, BLOCK, BLOCK) inverses of the blocks
    coupling: tuple          # nb views (BLOCK, W * BLOCK): D_i^-1 [N_i,w ...]


def build_sweep(plan) -> Sweep:
    """The sweep operators of a placed TriSolvePlan (its ``sweep``), on
    its device."""
    diag = plan.diag_blocks
    tri = torch.tril(diag) if plan.lower else torch.triu(diag)
    inv = torch.linalg.inv_ex(tri).inverse
    off = plan.off_blocks
    if plan.lower:
        # the solved neighbours i-W .. i-1 lie in memory in that order:
        # slot w (block i-1-w) goes last first
        off = off.flip(1)
    nb, W = plan.num_blocks, plan.width
    side = off.permute(0, 2, 1, 3).reshape(nb, BLOCK, W * BLOCK)
    return Sweep(inv=inv, coupling=torch.bmm(inv, side).unbind(0))


@dataclasses.dataclass(frozen=True)
class TriSolvePlan:
    """Blocked dense form of a sparse triangular matrix.

    ``diag_blocks``: (nb, BLOCK, BLOCK) dense diagonal blocks;
    ``off_blocks``: (nb, W, BLOCK, BLOCK) — for block row i, its W nearest
    sub(super)-diagonal block neighbors (banded window; padding zero);
    exact for matrices whose block bandwidth <= W, which the constructor
    verifies.  ``lower`` selects forward vs backward sweep.  Arrays are
    numpy on the host and tensors once placed (``formats.plan.place``),
    which builds ``sweep``.
    """

    diag_blocks: Array
    off_blocks: Array
    n: int
    lower: bool
    unit_diag: bool
    sweep: Optional[Sweep] = table(build_sweep)

    @property
    def num_blocks(self) -> int:
        return int(self.diag_blocks.shape[0])

    @property
    def width(self) -> int:
        return int(self.off_blocks.shape[1])


def build_trisolve_plan(a: CSR, *, lower: bool, unit_diag: bool = False,
                        value_dtype=np.float32) -> TriSolvePlan:
    """Densify a sparse triangular matrix into the blocked form (host)."""
    n = a.shape[0]
    nb = -(-n // BLOCK)
    np_pad = nb * BLOCK
    indptr = np.asarray(a.indptr, dtype=np.int64)
    cols = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data).astype(value_dtype)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    bi = rows // BLOCK
    bj = cols // BLOCK
    # block bandwidth (how far off the diagonal block coupling reaches)
    W = int(np.abs(bi - bj).max()) if rows.size else 0
    if W * nb * BLOCK * BLOCK * np.dtype(value_dtype).itemsize > 1 << 31:
        raise ValueError(
            f"block bandwidth {W} too wide to densify ({nb} blocks); "
            "reorder the matrix (RCM) to reduce bandwidth first")

    diag = np.zeros((nb, BLOCK, BLOCK), dtype=value_dtype)
    off = np.zeros((nb, max(W, 1), BLOCK, BLOCK), dtype=value_dtype)
    on_diag = bi == bj
    diag[bi[on_diag], rows[on_diag] % BLOCK, cols[on_diag] % BLOCK] = \
        data[on_diag]
    od = ~on_diag
    dist = np.abs(bi[od] - bj[od]) - 1            # 0-based neighbor slot
    off[bi[od], dist, rows[od] % BLOCK, cols[od] % BLOCK] = data[od]

    if unit_diag:
        diag[:, np.arange(BLOCK), np.arange(BLOCK)] = 1.0
    else:
        # padding rows need a nonsingular diagonal
        if np_pad > n:
            pad_rows = np.arange(n, np_pad)
            diag[pad_rows // BLOCK, pad_rows % BLOCK, pad_rows % BLOCK] = 1.0
        dvals = diag[np.arange(nb)[:, None], np.arange(BLOCK)[None, :],
                     np.arange(BLOCK)[None, :]]
        if np.any(dvals == 0):
            raise ValueError("triangular matrix has zero diagonal entries")

    return TriSolvePlan(diag_blocks=diag, off_blocks=off, n=n, lower=lower,
                        unit_diag=unit_diag)


def trisolve(plan: TriSolvePlan, b) -> torch.Tensor:
    """Solve T x = b for blocked triangular T on the placed plan's device
    (x in the plan's dtype): ``nb`` dependent steps of one ``addmv_``
    each, after one batched product."""
    sw = plan.sweep
    if sw is None:
        raise TypeError("trisolve runs a placed TriSolvePlan: place it "
                        "with formats.plan.place(plan, device)")
    nb, W = plan.num_blocks, plan.width
    diag = plan.diag_blocks
    bp = diag.new_zeros(nb * BLOCK)
    bp[:plan.n] = torch.as_tensor(b, device=diag.device).to(diag.dtype)
    # x with W zero blocks before (lower) or after (upper) the nb blocks:
    # block i lives at row i + W (lower) or i (upper), and its solved
    # neighbours are rows [i, i + W) or [i + 1, i + 1 + W), all in range
    xs = diag.new_zeros(nb + W, BLOCK)
    first = W if plan.lower else 0
    torch.bmm(sw.inv, bp.view(nb, BLOCK, 1),
              out=xs[first:first + nb].view(nb, BLOCK, 1))
    # every view the loop takes, made up front: the target rows and the
    # W-block windows of x (window j starts at row j)
    rows = xs.unbind(0)
    windows = xs.view(-1).unfold(0, W * BLOCK, BLOCK).unbind(0)
    if plan.lower:
        for i in range(nb):
            rows[i + W].addmv_(sw.coupling[i], windows[i], alpha=-1)
    else:
        for i in range(nb - 1, -1, -1):
            rows[i].addmv_(sw.coupling[i], windows[i + 1], alpha=-1)
    return xs[first:first + nb].reshape(-1)[:plan.n]


# ---------------------------------------------------------------------------
# ILU(0)
# ---------------------------------------------------------------------------

def _ilu0_values(a: CSR) -> np.ndarray:
    """Factored CSR value array on A's pattern (sorted columns required):
    the native C++ factorisation (``native_lib.ilu0_inplace``) where a
    C++ compiler is present, counted in ``_ilu0_values.native_calls``,
    else the reference's vectorized-numpy Doolittle
    (:func:`_ilu0_numpy`).  Both run on the host."""
    from .. import native_lib

    if native_lib.available():
        out = native_lib.ilu0_inplace(a.indptr, a.indices, a.data)
        _ilu0_values.native_calls += 1
        return out
    return _ilu0_numpy(a)


_ilu0_values.native_calls = 0


def _ilu0_numpy(a: CSR) -> np.ndarray:
    """The vectorized-numpy Doolittle ILU(0) of CSR values."""
    n = a.shape[0]
    indptr = np.asarray(a.indptr, dtype=np.int64)
    cols = np.asarray(a.indices, dtype=np.int64)
    data = np.asarray(a.data, dtype=np.float64).copy()

    # diagonal position per row (cols are sorted within each row)
    diag_idx = indptr[:-1] + np.array(
        [np.searchsorted(cols[indptr[i]:indptr[i + 1]], i)
         for i in range(n)], dtype=np.int64)
    bad = (diag_idx >= indptr[1:]) | (cols[np.minimum(
        diag_idx, cols.shape[0] - 1)] != np.arange(n))
    if bad.any():
        raise ValueError(
            f"ILU(0): missing diagonal in row {int(np.flatnonzero(bad)[0])}")

    for i in range(n):
        row_lo, row_hi = indptr[i], indptr[i + 1]
        for e in range(row_lo, diag_idx[i]):
            k = cols[e]
            pivot = data[diag_idx[k]]
            if pivot == 0:
                raise ZeroDivisionError(f"ILU(0): zero pivot at row {k}")
            lik = data[e] / pivot
            data[e] = lik
            # row_i[j] -= lik * row_k[j] on the shared pattern, j > k:
            # vectorized intersect of the two sorted column slices
            f0, f1 = diag_idx[k] + 1, indptr[k + 1]
            if f0 >= f1:
                continue
            tgt = cols[e + 1:row_hi]
            pos = np.searchsorted(tgt, cols[f0:f1])
            ok = pos < tgt.shape[0]
            pos_ok = pos[ok]
            hit = tgt[pos_ok] == cols[f0:f1][ok]
            upd = (e + 1) + pos_ok[hit]
            data[upd] -= lik * data[f0:f1][ok][hit]
    return data


def ilu0(a: CSR) -> Tuple[CSR, CSR]:
    """ILU(0) factorization on the host: A ~= L U with L unit-lower and U
    upper, both on A's sparsity pattern (IKJ Doolittle over CSR), float64
    values.

    Returns (L, U) as CSR.  Use :func:`build_trisolve_plan` +
    :func:`trisolve` for the device-side application
    ``M^{-1} r = U^{-1} (L^{-1} r)`` as a CG/BiCGSTAB preconditioner.
    """
    n = a.shape[0]
    indptr = np.asarray(a.indptr, dtype=np.int64)
    cols = np.asarray(a.indices, dtype=np.int64)
    data = _ilu0_values(a)

    # split into L (unit diag) and U
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    lower_mask = rows > cols
    upper_mask = rows <= cols

    def _make(mask, add_unit_diag):
        r, c, v = rows[mask], cols[mask], data[mask]
        if add_unit_diag:
            r = np.concatenate([r, np.arange(n, dtype=np.int64)])
            c = np.concatenate([c, np.arange(n, dtype=np.int64)])
            v = np.concatenate([v, np.ones(n)])
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        ip = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(r, minlength=n), out=ip[1:])
        return CSR(data=v, indices=c.astype(np.int32),
                   indptr=ip.astype(np.int32), shape=a.shape)

    return _make(lower_mask, True), _make(upper_mask, False)
