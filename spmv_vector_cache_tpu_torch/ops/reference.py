"""Reference executors (counterpart of
``spmv_vector_cache_tpu/ops/reference.py``): the host oracle and the
loop-free torch executors for every container format.

* :func:`spmv_numpy` — the exact sequential-order host loop, used as the
  float64 oracle;
* :func:`spmv` — ``y (+)= A (x) x`` for CSR, CSC, COO, ELL and BSR over
  the semirings the reference defines for each, on ``x.device``;
* :func:`spmm` — ``Y = A @ B`` for CSR, CSC, COO and BSR, on
  ``B.device``: the path of every plan that has no fused SpMM kernel.

A container's arrays may be numpy arrays or torch tensors; the
executors move them to the operand's device for the call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..formats.containers import BSR, COO, CSC, CSR, ELL
from . import semiring as sr


def spmv_numpy(a, x: np.ndarray, y: Optional[np.ndarray] = None) -> np.ndarray:
    """Sequential-order SpMV on the host: ``y += A @ x``.  ``np.add.at``
    is unbuffered and applies updates in element order."""
    if isinstance(a, CSC):
        indptr = np.asarray(a.indptr, dtype=np.int64)
        rows = np.asarray(a.indices, dtype=np.int64) & 0x3FFFFFFF
        data = np.asarray(a.data)
        cols = np.repeat(np.arange(a.shape[1], dtype=np.int64), np.diff(indptr))
        out = np.zeros(a.shape[0], dtype=np.result_type(data, x)) if y is None \
            else y.copy()
        np.add.at(out, rows, data * np.asarray(x)[cols])
        return out
    if isinstance(a, CSR):
        indptr = np.asarray(a.indptr, dtype=np.int64)
        cols = np.asarray(a.indices, dtype=np.int64)
        data = np.asarray(a.data)
        rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(indptr))
        out = np.zeros(a.shape[0], dtype=np.result_type(data, x)) if y is None \
            else y.copy()
        np.add.at(out, rows, data * np.asarray(x)[cols])
        return out
    if isinstance(a, COO):
        out = np.zeros(a.shape[0], dtype=np.result_type(a.data, x)) if y is None \
            else y.copy()
        np.add.at(out, np.asarray(a.row, dtype=np.int64),
                  np.asarray(a.data) * np.asarray(x)[np.asarray(a.col, dtype=np.int64)])
        return out
    raise TypeError(f"unsupported container {type(a)}")


def golden(a, x: Optional[np.ndarray] = None) -> np.ndarray:
    """y = A @ x with x defaulting to ones."""
    if x is None:
        x = np.ones(a.shape[1], dtype=np.asarray(a.data).dtype
                    if np.asarray(a.data).dtype.kind == "f" else np.float64)
    return spmv_numpy(a, x)


# ---------------------------------------------------------------------------
# torch executors
# ---------------------------------------------------------------------------

def _on(v, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device)


def _expand_indptr(indptr: torch.Tensor) -> torch.Tensor:
    """Per-nonzero major index from compressed pointers."""
    n = indptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n, device=indptr.device), torch.diff(indptr.long()))


def _triples(a, device):
    """(row, col, data) of a CSR, CSC or COO matrix, on ``device``."""
    if isinstance(a, CSR):
        row = _expand_indptr(_on(a.indptr, device))
        col = _on(a.indices, device).long()
    elif isinstance(a, CSC):
        col = _expand_indptr(_on(a.indptr, device))
        row = _on(a.indices, device).long() & 0x3FFFFFFF
    elif isinstance(a, COO):
        row = _on(a.row, device).long()
        col = _on(a.col, device).long()
    else:
        raise TypeError(f"unsupported container {type(a)}")
    return row, col, _on(a.data, device)


#: the reductions of ELL rows and BSR block rows, by semiring; or_and has
#: none in the reference (its ELL executor raises, its BSR one fails)
_ROW_REDUCE = {"plus_times": torch.sum, "max_plus": torch.amax,
               "max_times": torch.amax, "min_plus": torch.amin}


def _row_reduce(s: sr.Semiring):
    if s.name not in _ROW_REDUCE:
        raise NotImplementedError(s.name)
    return _ROW_REDUCE[s.name]


def _spmv_ell(a: ELL, x: torch.Tensor, s: sr.Semiring) -> torch.Tensor:
    """A dense gather + row reduction.  As in the reference, padding
    slots (value 0, column 0) take part: under min_plus and max_plus
    they contribute ``x[0]``."""
    reduce = _row_reduce(s)
    data = _on(a.data, x.device)
    return reduce(s.mul(data, x[_on(a.indices, x.device).long()]), dim=1)


def _spmv_bsr(a: BSR, x: torch.Tensor, s: sr.Semiring) -> torch.Tensor:
    """Per-block dense matvec + block-row segment reduce.  As in the
    reference, the zeros stored inside blocks take part under every
    semiring."""
    br, bc = a.blocksize
    data = _on(a.data, x.device)                           # (nb, br, bc)
    gathered = x.reshape(-1, bc)[_on(a.indices, x.device).long()]  # (nb, bc)
    if s.name == "plus_times":
        contrib = torch.bmm(data, gathered[:, :, None])[:, :, 0]
    else:
        red = _row_reduce(s)(s.mul(data, gathered[:, None, :]), dim=2)
        contrib = s.add(red, red.new_tensor(s.zero))   # the reduce's init
    block_row = _expand_indptr(_on(a.indptr, x.device))
    return s.segment_reduce(contrib, block_row, a.shape[0] // br).reshape(-1)


def spmv(a, x, semiring=sr.PLUS_TIMES, y=None) -> torch.Tensor:
    """Generalized ``y (+)= A (x) x`` on ``x``'s device, for every
    container.  The semiring's own ``mul`` and ``add`` run, as in the
    reference, so or_and yields booleans."""
    s = sr.get(semiring)
    x = torch.as_tensor(x)
    if isinstance(a, ELL):
        out = _spmv_ell(a, x, s)
    elif isinstance(a, BSR):
        out = _spmv_bsr(a, x, s)
    else:
        row, col, data = _triples(a, x.device)
        out = s.segment_reduce(s.mul(data, x[col]), row, a.shape[0])
    return out if y is None else s.add(torch.as_tensor(y, device=x.device),
                                       out)


def spmm(a, b, semiring=sr.PLUS_TIMES) -> torch.Tensor:
    """Sparse x dense ``Y = A @ B`` with B of shape (cols, k), on ``B``'s
    device.  plus_times only: the reference raises for any other
    semiring on CSR, CSC and COO, and computes plus_times on BSR whatever
    it is asked; here every format raises."""
    s = sr.get(semiring)
    if s.name != "plus_times":
        raise NotImplementedError(f"SpMM runs plus_times only, not "
                                  f"{s.name}")
    b = torch.as_tensor(b)
    if b.dim() != 2 or b.shape[0] != a.shape[1]:
        raise ValueError(f"B has shape {tuple(b.shape)}, the matrix needs "
                         f"({a.shape[1]}, k)")
    rows, k = a.shape[0], b.shape[1]
    if isinstance(a, BSR):
        br, bc = a.blocksize
        data = _on(a.data, b.device)
        gathered = b.reshape(a.shape[1] // bc, bc, k)[
            _on(a.indices, b.device).long()]                # (nb, bc, k)
        contrib = torch.bmm(data, gathered)                 # (nb, br, k)
        block_row = _expand_indptr(_on(a.indptr, b.device))
        out = contrib.new_zeros((rows // br, br, k))
        return out.index_add_(0, block_row, contrib).reshape(rows, k)
    row, col, data = _triples(a, b.device)
    products = sr.widen(data)[:, None] * sr.widen(b)[col]
    y = products.new_zeros((rows, k)).index_add_(0, row, products)
    # a bfloat16 matrix sums in float32; a uint32 one in its int32 view
    return sr.narrow(y, b.dtype) if data.dtype == torch.uint32 else y
