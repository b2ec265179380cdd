"""In-block lane un-permutation, the ChunkPlan's row fixup (counterpart of
``spmv_vector_cache_tpu/ops/lane_perm.py``).

The chunk layout sorts rows by length within aligned windows of 1024
rows, so a row's reduced value lands in the same (8, 128) block of the
per-block sums as its home position.  :func:`lane_unpermute` wraps
kernel C (``csrc/lane_perm.cu``) and undoes that sort;
:func:`lane_unpermute_plain` is its plain PyTorch version.  The ChunkPlan
apply calls :func:`unpermute_plan_rows`, which skips the checks of the
plan's own ``perm_idx`` (placement made them once,
``formats/chunk.check_perm_idx``) and un-permutes in place.  Kernel C
moves 4-byte words and computes nothing, so its one build serves the
int32 and uint32 sums of an integer plan bit for bit as it serves
float32 (the pointers are handed over as they are), and the float32 or
int32 sums of a float16 or 8- or 16-bit plan, which y is narrowed from
only after it.
"""

from __future__ import annotations

import torch

from ..utils import platform
from . import _kernels
from . import semiring as sr


def lane_unpermute_plain(y2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C (same inputs, same output)."""
    base = (torch.arange(y2d.shape[0], device=y2d.device) // 8 * 1024)[:, None]
    return sr.take(y2d.reshape(-1), base + idx.long())


#: the sums kernel C moves, 4-byte words bit for bit
WORDS = (torch.float32, torch.int32, torch.uint32)


def _check(y2d, idx):
    shape = y2d.shape
    if len(shape) != 2 or shape[1] != 128 or shape[0] % 8:
        raise ValueError(f"y2d must be (8k, 128), got {tuple(shape)}")
    if idx.shape != shape:
        raise ValueError(f"idx {tuple(idx.shape)} must match y2d "
                         f"{tuple(shape)}")
    if y2d.dtype not in WORDS or idx.dtype is not torch.int16:
        raise ValueError(f"y2d must be float32, int32 or uint32 and idx "
                         f"int16, got {y2d.dtype} and {idx.dtype}")
    if y2d.get_device() != idx.get_device():
        raise ValueError(f"operands on {y2d.device} and {idx.device}")
    if not (y2d.is_contiguous() and idx.is_contiguous()):
        raise ValueError("lane_unpermute operands must be contiguous")
    if (y2d.data_ptr() | idx.data_ptr()) % 16:
        raise ValueError("lane_unpermute operands must start on a 16-byte "
                         "boundary (kernel C reads them as 16-byte vectors)")


def _launch(y2d: torch.Tensor, idx: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    _kernels.launch("lane_unpermute_f32", y2d.get_device(), y2d.data_ptr(),
                    idx.data_ptr(), out.data_ptr(), y2d.numel())
    return out


def lane_unpermute(y2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[s, l] = y2d.flat[(s // 8) * 1024 + idx[s, l]]``: kernel C on
    CUDA tensors, the plain version on CPU tensors.

    ``y2d``: (S, 128) float32 (or int32, uint32: the same words), S a
    multiple of 8; ``idx``: (S, 128) int16
    in [0, 1024), the source offset within the output's aligned 8-row
    block (``build_chunk_plan`` guarantees the range).  Both contiguous
    and 16-byte aligned (a view at an offset of a multiple of 4 floats
    and 8 int16s), on either device.
    """
    _check(y2d, idx)
    if not platform.is_cuda(y2d):
        return lane_unpermute_plain(y2d, idx)
    return _launch(y2d, idx, torch.empty_like(y2d))


def unpermute_plan_rows(y2d: torch.Tensor, perm_idx: torch.Tensor
                        ) -> torch.Tensor:
    """:func:`lane_unpermute` of the ChunkPlan apply's light-block sums
    (contiguous float32, made on the plan's device) by the plan's
    ``perm_idx``, which placement checked (dtype, shape, range).  On the
    card kernel C un-permutes ``y2d`` in place and returns it: the apply
    owns those sums, and an output allocation would cost the host more
    than the kernel costs the card."""
    if y2d.shape != perm_idx.shape or y2d.dtype not in WORDS or \
            not y2d.is_contiguous():
        raise ValueError(f"y2d ({tuple(y2d.shape)}, {y2d.dtype}) must be "
                         f"contiguous float32, int32 or uint32 of "
                         f"perm_idx's shape {tuple(perm_idx.shape)}")
    if not platform.is_cuda(y2d):
        return lane_unpermute_plain(y2d, perm_idx)
    return _launch(y2d, perm_idx, y2d)
