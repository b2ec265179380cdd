"""Sparse-matrix containers as plain numpy dataclasses (counterpart of
``spmv_vector_cache_tpu/formats/containers.py``).

CSR / CSC / COO / BSR / ELL hold host arrays: conversion and planning
are host-side numpy work, and only the finished plans move to the device.
The reference executors (``ops/reference.py``) also take a container
whose arrays are torch tensors, and leave them where they are.
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


@dataclasses.dataclass(frozen=True)
class BSR(_SparseBase):
    """Block sparse row: dense (br, bc) blocks on a CSR skeleton.

    ``data``: (nblocks, br, bc); ``indices``: (nblocks,) block-column ids;
    ``indptr``: (rows/br + 1,).
    """

    data: Array
    indices: Array
    indptr: Array
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0]) * self.blocksize[0] * self.blocksize[1]

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])


@dataclasses.dataclass(frozen=True)
class ELL(_SparseBase):
    """ELLPACK: fixed width per row, padded.

    ``data``/``indices``: (rows, width); padding slots hold value 0 and
    column 0.
    """

    data: Array
    indices: Array
    shape: Tuple[int, int]

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def nnz(self) -> int:  # counts padding; true nnz is not tracked here
        return int(self.data.shape[0]) * self.width
