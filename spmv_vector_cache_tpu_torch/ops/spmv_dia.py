"""DIA SpMV (counterpart of ``spmv_vector_cache_tpu/ops/spmv_dia.py``).

``y[r] = sum_k vals[k, r] * x[r + off_k]``: the column of a diagonal
nonzero is its row plus a constant, so there is no index stream.
:func:`spmv_dia_kernel` wraps kernel A (``csrc/spmv_dia.cu``), which
replaces the reference's resident and windowed Pallas kernels;
:func:`spmv_dia_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import functools

import torch

from ..formats.dia import DiaPlan
from ..utils import platform
from . import _kernels


def _check(vals: torch.Tensor, offsets, x: torch.Tensor) -> None:
    if vals.dim() != 4 or vals.shape[3] != 128:
        raise ValueError(f"DIA vals must be (T, D, S, 128), got "
                         f"{tuple(vals.shape)}")
    if len(offsets) != vals.shape[1]:
        raise ValueError(f"{len(offsets)} offsets for {vals.shape[1]} "
                         f"diagonals")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise NotImplementedError(
            f"DIA SpMV runs float32 only (vals {vals.dtype}, x {x.dtype})")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if vals.device != x.device:
        raise ValueError(f"vals on {vals.device}, x on {x.device}")
    if not (vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("DIA operands must be contiguous")


def spmv_dia_plain(vals: torch.Tensor, offsets, x: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """Plain PyTorch version of kernel A: the same sum, in the same
    diagonal order, with out-of-range columns reading 0.  An x with a
    trailing RHS axis, B of shape (cols, k), gives Y (rows, k): kernel
    I's plain version (``ops/spmm_dia.py``)."""
    T, D, S, L = vals.shape
    tail = (1,) * (x.dim() - 1)            # broadcast over B's RHS axis
    v = vals.permute(1, 0, 2, 3).reshape(D, T * S * L)[:, :rows]
    r = torch.arange(rows, device=x.device)
    cols = x.shape[0]
    acc = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    for k, off in enumerate(offsets):
        c = r + int(off)
        ok = (c >= 0) & (c < cols)
        xv = torch.where(ok.view(-1, *tail), x[c.clamp(0, max(cols - 1, 0))],
                         torch.zeros((), dtype=x.dtype, device=x.device))
        acc = acc + v[k].view(-1, *tail) * xv
    return acc


@functools.lru_cache(maxsize=64)
def _offsets_on(offsets: tuple, device: torch.device) -> torch.Tensor:
    """The plan's static offsets as an int32 device array, uploaded once
    per (offset pattern, device) rather than once per apply."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def spmv_dia_kernel(vals: torch.Tensor, offsets, x: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """Kernel A on a CUDA tensor; the plain version on a CPU tensor."""
    _check(vals, offsets, x)
    if not platform.is_cuda(x):
        return spmv_dia_plain(vals, offsets, x, rows)
    T, D, S, L = vals.shape
    if rows > T * S * L:
        raise ValueError(f"rows={rows} exceeds the plan's {T * S * L}")
    offs = _offsets_on(tuple(int(o) for o in offsets), x.device)
    y = torch.empty(rows, dtype=torch.float32, device=x.device)
    err = _kernels.library().spmv_dia_f32(
        vals.data_ptr(), x.data_ptr(), offs.data_ptr(), y.data_ptr(),
        rows, x.shape[0], D, S * L,
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(err, "spmv_dia_f32")
    spmv_dia_kernel.launches += 1
    return y


spmv_dia_kernel.launches = 0


def spmv_dia(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` from a prebuilt :class:`DiaPlan` on ``x.device``.

    The reference's ``resident`` argument is dropped: it chose between
    keeping the x image in VMEM and streaming sliding blocks, a capacity
    question the card does not have — the kernel reads x from device
    memory through L1/L2 at any size.
    """
    if plan.double:
        raise NotImplementedError("double-float DIA plans are not ported "
                                  "(ROADMAP.md queue 1, item 10)")
    if x.shape != (plan.shape[1],):
        raise ValueError(f"x has shape {tuple(x.shape)}, the plan needs "
                         f"({plan.shape[1]},)")
    return spmv_dia_kernel(plan.vals, plan.offsets,
                           x.to(plan.vals.dtype).contiguous(), plan.shape[0])
