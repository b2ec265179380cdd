"""Device policy for the CUDA kernels (counterpart of
``spmv_vector_cache_tpu/utils/platform.py``).

The JAX package chooses between compiled Mosaic and Pallas interpret
mode.  Here the choice follows the tensor: a kernel wrapper launches its
CUDA kernel for a tensor on a CUDA device and runs its plain PyTorch
version for a tensor on the CPU.  There is no interpret mode and no VMEM
budget.
"""

from __future__ import annotations

import torch


def is_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda                  # no torch.device object: per launch


def require_cuda() -> None:
    """Raise unless a CUDA device is usable (measurement paths never fall
    back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
