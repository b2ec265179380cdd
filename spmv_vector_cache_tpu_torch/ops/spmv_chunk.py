"""ChunkPlan SpMV (counterpart of ``_subwin_partials`` and ``_spmv_chunk``
in ``spmv_vector_cache_tpu/ops/spmv_pallas.py``).

:func:`subwin_kernel` wraps kernel D (``csrc/spmv_subwin.cu``), the
heavy-row tiles; :func:`subwin_plain` is its plain PyTorch version.  The
light buckets are window SellPlans and run on kernel B
(``spmv_sell._window_partials``).  The epilogue is torch ops, as the
reference computes it in XLA outside Pallas: each bucket's sorted
segment reduce over the unified segment space, the semiring add across
buckets, the lane un-permutation of the light blocks (kernel C), the
heavy rows' lane fold and merge, and the residue add.
"""

from __future__ import annotations

import torch

from ..formats.cached import CooTail
from ..formats.chunk import ChunkPlan, SubwinPlan
from ..formats.packed import PackedPlan
from ..utils import platform
from . import _kernels
from . import semiring as sr
from .lane_perm import unpermute_plan_rows
from .spmv_packed import spmv_packed
from .spmv_sell import _spmv_coo, _window_partials

# ---------------------------------------------------------------------------
# heavy rows: kernel D
# ---------------------------------------------------------------------------

def subwin_plain(vals, cols_win, bases, x, *, semiring: str) -> torch.Tensor:
    """Plain PyTorch version of kernel D (same inputs, same output)."""
    mul, axis_reduce = sr.kernel_ops(semiring)
    cols = x.shape[0]
    c = bases.long()[:, :, None] * 128 + cols_win.long()
    xz = torch.cat([x, x.new_zeros(1)])        # c >= cols reads 0
    return axis_reduce(mul(vals, xz[c.clamp_(max=cols)]), 1)


def _check_subwin(vals, cols_win, bases, x):
    if vals.dim() != 3 or cols_win.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols_win "
                         f"{tuple(cols_win.shape)} must be equal (T, P, R)")
    if bases.shape != vals.shape[:2]:
        raise ValueError(f"bases {tuple(bases.shape)} must be (T, P) = "
                         f"{tuple(vals.shape[:2])}")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise NotImplementedError(f"subwindow SpMV runs float32 only (vals "
                                  f"{vals.dtype}, x {x.dtype})")
    if cols_win.dtype != torch.int16 or bases.dtype != torch.int32:
        raise ValueError("cols_win must be int16 and bases int32")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    for t in (cols_win, bases, x):
        if t.device != vals.device:
            raise ValueError(f"operands on {vals.device} and {t.device}")
    if not all(t.is_contiguous() for t in (vals, cols_win, bases, x)):
        raise ValueError("subwindow operands must be contiguous")


def subwin_kernel(vals, cols_win, bases, x, *, semiring: str) -> torch.Tensor:
    """Kernel D on CUDA tensors; the plain version on CPU tensors."""
    _check_subwin(vals, cols_win, bases, x)
    if not platform.is_cuda(x):
        return subwin_plain(vals, cols_win, bases, x, semiring=semiring)
    T, P, R = vals.shape
    out = torch.empty((T, R), dtype=torch.float32, device=x.device)
    _kernels.launch(
        "spmv_subwin_f32", x.get_device(), vals.data_ptr(),
        cols_win.data_ptr(), bases.data_ptr(), x.data_ptr(), out.data_ptr(), T,
        P, R, x.shape[0], sr.KERNEL_CODE[semiring])
    subwin_kernel.launches += 1
    return out


subwin_kernel.launches = 0


def _subwin_partials(plan: SubwinPlan, x: torch.Tensor,
                     semiring: str) -> torch.Tensor:
    """Run one SubwinPlan bucket -> (T, 128) per-tile lane partials."""
    return subwin_kernel(plan.vals, plan.cols_win, plan.bases,
                         x.to(plan.vals.dtype).contiguous(),
                         semiring=semiring)


# ---------------------------------------------------------------------------
# the ChunkPlan apply
# ---------------------------------------------------------------------------

def spmv_chunk(plan: ChunkPlan, x: torch.Tensor,
               semiring: str = "plus_times") -> torch.Tensor:
    """Per-bucket kernels -> one sorted segment reduction over the
    unified (light blocks + heavy rows) space -> lane un-permutation of
    the light part, lane fold and merge of the heavy part, residue add."""
    s = sr.get(semiring)
    _, axis_reduce = sr.kernel_ops(semiring)
    nblk = plan.num_blocks
    nheavy = plan.num_heavy
    rows = plan.shape[0]
    parts = []
    for b in plan.buckets:
        part, fold = _window_partials(b, x, semiring)
        ids = b.tile_slice[::b.stats.group_tiles] if fold else b.tile_slice
        parts.append((part, ids))
    for h in plan.hbuckets:
        parts.append((_subwin_partials(h, x, semiring), h.tile_seg))
    y2d = None
    for part, ids in parts:
        y2b = s.segment_reduce(part, ids, num_segments=nblk + nheavy)
        # or_and's logical add yields bool; restore the float encoding
        y2d = y2b if y2d is None else s.add(y2d, y2b).to(y2b.dtype)
    y = unpermute_plan_rows(y2d[:nblk], plan.perm_idx).reshape(-1)[:rows]
    if nheavy:
        yh = axis_reduce(y2d[nblk:], 1)            # (nheavy,)
        yh = s.segment_reduce(yh, plan.heavy_rows,
                              num_segments=rows + 1)[:rows]
        y = s.add(y, yh).to(y.dtype)
    if isinstance(plan.residue, CooTail):
        y = s.add(y, _spmv_coo(plan.residue, x, semiring)).to(y.dtype)
    elif isinstance(plan.residue, PackedPlan):
        y = s.add(y, spmv_packed(plan.residue, x,
                                 semiring=semiring)).to(y.dtype)
    return y
