"""HPCG's problem, the 27-point stencil, and its plain reference.

The matrix is built on the host with numpy as the CSR a user hands the
port.  The reference applies the stencil on the 3-D grid with plain
torch slices: it never forms the matrix and reads nothing the port made.
Grid points are numbered x fastest, then y, then z, as HPCG numbers them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def grid(cfg) -> Tuple[int, int, int]:
    return int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])


def shape(cfg) -> Tuple[int, int]:
    nx, ny, nz = grid(cfg)
    return nx * ny * nz, nx * ny * nz


def make_csr(cfg):
    """(indptr int64, indices int32, data float64, shape) of the stencil
    matrix, columns ascending within each row."""
    nx, ny, nz = grid(cfg)
    n = nx * ny * nz
    steps = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
             for dx in (-1, 0, 1)]                # ascending column offset

    def inside(m, d):
        i = np.arange(m)
        return (i + d >= 0) & (i + d < m)

    mask = np.empty((n, 27), dtype=bool)
    for j, (dz, dy, dx) in enumerate(steps):
        mask[:, j] = (inside(nz, dz)[:, None, None] & inside(ny, dy)[None, :, None]
                      & inside(nx, dx)[None, None, :]).ravel()
    offsets = np.array([dz * nx * ny + dy * nx + dx for dz, dy, dx in steps],
                       dtype=np.int32)
    cols = np.arange(n, dtype=np.int32)[:, None] + offsets[None, :]
    indices = cols[mask]
    del cols
    vals = np.where(offsets == 0, float(cfg["diagonal"]),
                    float(cfg["off_diagonal"]))
    data = np.broadcast_to(vals, (n, 27))[mask]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    return indptr, indices, data, (n, n)


def _box(cfg, v: torch.Tensor) -> torch.Tensor:
    """The sum over each point's 3x3x3 neighbourhood inside the grid."""
    nx, ny, nz = grid(cfg)
    p = torch.nn.functional.pad(v.reshape(nz, ny, nx), (1, 1, 1, 1, 1, 1))
    out = torch.zeros_like(v.reshape(nz, ny, nx))
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                out += p[dz:dz + nz, dy:dy + ny, dx:dx + nx]
    return out.reshape(-1)


def reference_matvec(cfg, x: torch.Tensor) -> torch.Tensor:
    """y = A x by the stencil, in x's dtype and on x's device."""
    d, o = float(cfg["diagonal"]), float(cfg["off_diagonal"])
    return (d - o) * x + o * _box(cfg, x)


def reference_abs_matvec(cfg, x: torch.Tensor) -> torch.Tensor:
    """|A| |x|: the scale each row of y is judged against."""
    d, o = abs(float(cfg["diagonal"])), abs(float(cfg["off_diagonal"]))
    ax = x.abs()
    return (d - o) * ax + o * _box(cfg, ax)


def rhs(cfg, device, dtype) -> torch.Tensor:
    """HPCG's right-hand side: b = A 1, so the exact solution is ones."""
    ones = torch.ones(shape(cfg)[0], dtype=dtype, device=device)
    return reference_matvec(cfg, ones)

