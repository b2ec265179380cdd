"""Reference executors (counterpart of
``spmv_vector_cache_tpu/ops/reference.py``; the host oracle and a torch
CSR executor — the CSC/COO/ELL/BSR device executors come later).

* :func:`spmv_numpy` — the exact sequential-order host loop, used as the
  float64 oracle;
* :func:`spmv_csr` — a loop-free torch CSR executor over any semiring,
  runnable on the CPU or the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..formats.containers import COO, CSC, CSR
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


def spmv_csr(a: CSR, x: torch.Tensor, semiring=sr.PLUS_TIMES) -> torch.Tensor:
    """Generalized ``y = A (+).(x) x`` for a CSR matrix on ``x.device``:
    one gather, one multiply, one segment reduce."""
    s = sr.get(semiring)
    mul, _ = sr.kernel_ops(s.name)           # float ops, or_and included
    indptr = torch.as_tensor(np.asarray(a.indptr, dtype=np.int64),
                             device=x.device)
    row = torch.repeat_interleave(
        torch.arange(a.shape[0], device=x.device), torch.diff(indptr))
    col = torch.as_tensor(np.asarray(a.indices, dtype=np.int64) & 0x3FFFFFFF,
                          device=x.device)
    data = torch.as_tensor(np.asarray(a.data), device=x.device).to(x.dtype)
    return s.segment_reduce(mul(data, x[col]), row, a.shape[0])
