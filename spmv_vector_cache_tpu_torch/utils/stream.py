"""The stream checksum (counterpart of ``_checksum_stream`` in
``tests/test_backend_stream.py``).

A (T, P, R) float32 stream is cut into blocks of ``block`` tiles, and
each block reduces to one sum: the reference's ``StreamReducer``
checksum, which proves that the pipeline delivers exactly the right
bytes in the right order (a ramp's sums have a closed form).  The same
pass is the port's bandwidth probe (``utils/roofline.py``,
:func:`~.roofline.measure_stream_bandwidth`), so it lives in the package.

:func:`checksum_stream` wraps kernel N (``csrc/stream_checksum.cu``);
:func:`checksum_stream_plain` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from ..ops import _kernels
from . import platform


def checksum_stream_plain(data: torch.Tensor, block: int) -> torch.Tensor:
    """Plain PyTorch version of kernel N: the (T // block,) float32
    per-block sums.  The JAX function returns the ``[:, 0, 0]`` column of
    a (T // block, P, R) broadcast store; the values are the same."""
    T = data.shape[0]
    return data.reshape(T // block, -1).sum(1)


def _check(data: torch.Tensor, block: int) -> None:
    if data.dim() != 3:
        raise ValueError(f"data must be (T, P, R), got {tuple(data.shape)}")
    if data.dtype != torch.float32:
        raise NotImplementedError(f"the stream checksum runs float32 only "
                                  f"(got {data.dtype})")
    if block < 1 or data.shape[0] % block:
        raise ValueError(f"T={data.shape[0]} is not a multiple of "
                         f"block={block}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")


def checksum_stream(data: torch.Tensor, block: int) -> torch.Tensor:
    """Kernel N on a CUDA tensor; the plain version on a CPU tensor."""
    _check(data, block)
    if not platform.is_cuda(data):
        return checksum_stream_plain(data, block)
    T, P, R = data.shape
    block_elems = block * P * R
    if block_elems % 4 or data.data_ptr() % 16:
        raise ValueError("kernel N reads 16-byte vectors: block * P * R "
                         "must be a multiple of 4 and data 16-byte aligned")
    num_blocks = T // block
    out = torch.empty(num_blocks, dtype=torch.float32, device=data.device)
    _kernels.launch(
        "stream_checksum_f32", data.get_device(), data.data_ptr(),
        out.data_ptr(), num_blocks, block_elems)
    return out
