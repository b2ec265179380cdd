"""In-block lane un-permutation, the ChunkPlan's row fixup (counterpart of
``spmv_vector_cache_tpu/ops/lane_perm.py``).

The chunk layout sorts rows by length within aligned windows of 1024
rows, so a row's reduced value lands in the same (8, 128) block of the
per-block sums as its home position.  :func:`lane_unpermute` wraps
kernel C (``csrc/lane_perm.cu``) and undoes that sort;
:func:`lane_unpermute_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from ..utils import platform
from . import _kernels


def lane_unpermute_plain(y2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C (same inputs, same output)."""
    base = (torch.arange(y2d.shape[0], device=y2d.device) // 8 * 1024)[:, None]
    return y2d.reshape(-1)[base + idx.long()]


def _check(y2d, idx):
    if y2d.dim() != 2 or y2d.shape[1] != 128 or y2d.shape[0] % 8:
        raise ValueError(f"y2d must be (8k, 128), got {tuple(y2d.shape)}")
    if idx.shape != y2d.shape:
        raise ValueError(f"idx {tuple(idx.shape)} must match y2d "
                         f"{tuple(y2d.shape)}")
    if y2d.dtype != torch.float32 or idx.dtype != torch.int16:
        raise ValueError(f"y2d must be float32 and idx int16, got "
                         f"{y2d.dtype} and {idx.dtype}")
    if idx.device != y2d.device:
        raise ValueError(f"operands on {y2d.device} and {idx.device}")
    if not (y2d.is_contiguous() and idx.is_contiguous()):
        raise ValueError("lane_unpermute operands must be contiguous")


def lane_unpermute(y2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[s, l] = y2d.flat[(s // 8) * 1024 + idx[s, l]]``: kernel C on
    CUDA tensors, the plain version on CPU tensors.

    ``y2d``: (S, 128) float32, S a multiple of 8; ``idx``: (S, 128) int16
    in [0, 1024), the source offset within the output's aligned 8-row
    block (``build_chunk_plan`` guarantees the range).
    """
    _check(y2d, idx)
    if not platform.is_cuda(y2d):
        return lane_unpermute_plain(y2d, idx)
    out = torch.empty_like(y2d)
    err = _kernels.library().lane_unpermute_f32(
        y2d.data_ptr(), idx.data_ptr(), out.data_ptr(), y2d.numel(),
        torch.cuda.current_stream(y2d.device).cuda_stream)
    _kernels.check(err, "lane_unpermute_f32")
    lane_unpermute.launches += 1
    return out


lane_unpermute.launches = 0
