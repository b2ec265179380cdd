"""Sparse-matrix containers as plain numpy dataclasses (counterpart of
``spmv_vector_cache_tpu/formats/containers.py``).

CSR / CSC / COO hold host arrays: conversion and planning are host-side
numpy work, and only the finished plans move to the device.  BSR and ELL
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

Array = Any  # numpy array


class _SparseBase:
    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


@dataclasses.dataclass(frozen=True)
class CSR(_SparseBase):
    """Compressed sparse row.  ``indptr``: (rows+1,), ``indices``: (nnz,) col ids."""

    data: Array
    indices: Array
    indptr: Array
    shape: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class CSC(_SparseBase):
    """Compressed sparse column: ``indptr``: (cols+1,) column pointers,
    ``indices``: (nnz,) row ids."""

    data: Array
    indices: Array
    indptr: Array
    shape: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class COO(_SparseBase):
    """Coordinate format: parallel (row, col, data) arrays of length nnz."""

    data: Array
    row: Array
    col: Array
    shape: Tuple[int, int]
