"""The work of each measured call, counted from shapes.

The counts are defined by the mathematics, not by the format or kernel
that runs it, so they read the same whatever plan a later change puts in
place.  Bytes count each input once and each output once.
"""

from __future__ import annotations


def stencil27_nnz(nx: int, ny: int, nz: int) -> int:
    """Stored nonzeros of the 27-point stencil on an nx x ny x nz grid:
    each axis contributes 3n - 2 in-grid (point, neighbour) pairs."""
    return (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)


def spmv_bytes(nnz: int, rows: int, cols: int, value_bytes: int,
               index_bytes: int = 0) -> int:
    """Least bytes of one y = A x: each stored value once, x read once,
    y written once.  A stencil needs no index bytes."""
    return nnz * (value_bytes + index_bytes) + (rows + cols) * value_bytes

