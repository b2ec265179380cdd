"""DIA SpMM (counterpart of ``spmv_vector_cache_tpu/ops/spmm_dia.py``).

``Y[r, j] = sum_d vals[d, r] * B[r + off_d, j]`` with B of shape
(cols, k): the multi-RHS form of :mod:`.spmv_dia`, reading each value
slab once for all k right-hand sides.  :func:`spmm_dia_kernel` wraps
kernel I (``csrc/spmm_dia.cu``), which replaces the reference's
``_make_dia_spmm_kernel``; :func:`spmm_dia_plain` is its plain PyTorch
version.
"""

from __future__ import annotations

import torch

from ..formats.dia import DiaPlan
from ..utils import platform
from . import _kernels
from .spmv_dia import _offsets_on, spmv_dia_plain


def _check(vals: torch.Tensor, offsets, b: torch.Tensor) -> None:
    if vals.dim() != 4 or vals.shape[3] != 128:
        raise ValueError(f"DIA vals must be (T, D, S, 128), got "
                         f"{tuple(vals.shape)}")
    if len(offsets) != vals.shape[1]:
        raise ValueError(f"{len(offsets)} offsets for {vals.shape[1]} "
                         f"diagonals")
    if vals.dtype != torch.float32 or b.dtype != torch.float32:
        raise NotImplementedError(
            f"DIA SpMM runs float32 only (vals {vals.dtype}, B {b.dtype})")
    if b.dim() != 2 or b.shape[1] < 1:
        raise ValueError(f"B must be (cols, k) with k >= 1, got shape "
                         f"{tuple(b.shape)}")
    if vals.device != b.device:
        raise ValueError(f"vals on {vals.device}, B on {b.device}")
    if not (vals.is_contiguous() and b.is_contiguous()):
        raise ValueError("DIA SpMM operands must be contiguous")


#: plain PyTorch version of kernel I: kernel A's plain version, whose
#: per-diagonal loop runs over B's trailing k axis
spmm_dia_plain = spmv_dia_plain


def spmm_dia_kernel(vals: torch.Tensor, offsets, b: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """Kernel I on a CUDA tensor; the plain version on a CPU tensor.
    Returns Y of shape (rows, k)."""
    _check(vals, offsets, b)
    if not platform.is_cuda(b):
        return spmm_dia_plain(vals, offsets, b, rows)
    T, D, S, L = vals.shape
    if rows > T * S * L:
        raise ValueError(f"rows={rows} exceeds the plan's {T * S * L}")
    offs = _offsets_on(tuple(int(o) for o in offsets), b.device)
    y = torch.empty((rows, b.shape[1]), dtype=torch.float32, device=b.device)
    _kernels.launch(
        "spmm_dia_f32", b.get_device(), vals.data_ptr(), b.data_ptr(),
        offs.data_ptr(), y.data_ptr(), rows, b.shape[0], b.shape[1], D, S * L)
    spmm_dia_kernel.launches += 1
    return y


spmm_dia_kernel.launches = 0


def spmm_dia(plan: DiaPlan, b: torch.Tensor) -> torch.Tensor:
    """Fused DIA SpMM ``Y = A @ B`` (B: (cols, k)) on ``b.device``.

    The reference's ``spmm_dia_feasible`` is dropped: it refused the
    kernel when 8 RHS columns of the zero-padded x image outgrew 0.6 of
    the TPU's VMEM (so the bench.py headline matrix never reached it), a
    capacity question the card does not have — kernel I reads B from
    device memory through L1/L2 at any width.
    """
    if plan.double:
        raise NotImplementedError("double-float DIA plans have no SpMM "
                                  "kernel (ROADMAP.md queue 3)")
    if b.dim() != 2 or b.shape[0] != plan.shape[1]:
        raise ValueError(f"B has shape {tuple(b.shape)}, the plan needs "
                         f"({plan.shape[1]}, k)")
    return spmm_dia_kernel(plan.vals, plan.offsets,
                           b.to(plan.vals.dtype).contiguous(), plan.shape[0])
