"""SELL window SpMM and the SpMM plan dispatch (counterpart of
``spmv_vector_cache_tpu/ops/spmm_pallas.py``).

``Y = A @ B`` with B of shape (cols, k): the fused multi-RHS product,
which streams a plan's nonzeros once for many right-hand sides instead of
once per column.  :func:`spmm_window_kernel` wraps kernel H
(``csrc/spmm_sell_window.cu``), which replaces the reference's
``_make_spmm_kernel`` and its ``_bt_windows`` operand; its partials
reduce to Y through the SELL SpMV epilogue (``_reduce_partials``) over a
trailing k axis.  :func:`spmm_window_plain` is its plain PyTorch
version.  :func:`spmm_plan` dispatches on plan type;
:func:`has_fused_spmm` says, before anything runs, whether a plan has a
fused kernel at all.
"""

from __future__ import annotations

import torch

from ..formats.cached import CooTail
from ..formats.dia import DiaPlan, HybridPlan
from ..formats.plan import SellPlan
from ..utils import platform
from . import _kernels
from .spmm_dia import spmm_dia
from .spmv_sell import _reduce_partials, folds_groups, sell_window_plain


class NoFusedSpmm(ValueError):
    """The plan has no fused SpMM kernel (a PackedPlan, a ChunkPlan, a
    CachedPlan, a windowless or double SellPlan, a double DiaPlan, or a
    HybridPlan with such a part): run ``reference.spmm`` on the matrix
    instead, as ``SparseOperator.matmat`` does for float32 plans."""


def is_double(plan) -> bool:
    """Whether the plan holds float64 values as hi/lo float32 pairs: a
    double DiaPlan or SellPlan, or a HybridPlan of those."""
    if isinstance(plan, HybridPlan):
        return is_double(plan.dia)
    if isinstance(plan, DiaPlan):
        return plan.double
    return isinstance(plan, SellPlan) and plan.stats.double


def has_fused_spmm(plan) -> bool:
    """Whether :func:`spmm_plan` runs ``plan``: a CooTail, a float32
    DiaPlan, a float32 window SellPlan, or a HybridPlan of those (the
    reference has no float64 SpMM kernel)."""
    if is_double(plan):
        return False
    if isinstance(plan, (CooTail, DiaPlan)):
        return True
    if isinstance(plan, HybridPlan):
        return has_fused_spmm(plan.rest)
    return isinstance(plan, SellPlan) and plan.stats.window_blocks > 0


# ---------------------------------------------------------------------------
# window SpMM: kernel H
# ---------------------------------------------------------------------------

def spmm_window_plain(vals, cols_win, window_base, b, *, group_tiles: int,
                      window_grain: int, fold: bool) -> torch.Tensor:
    """Plain PyTorch version of kernel H (same inputs, same output):
    kernel B's plain version under plus_times, over B's trailing k axis;
    per-tile partials (T, R, k), or per-group (T/wg, R, k) when
    ``fold``."""
    return sell_window_plain(vals, cols_win, window_base, b,
                             group_tiles=group_tiles,
                             window_grain=window_grain, fold=fold,
                             semiring="plus_times")


def _check_window(vals, cols_win, window_base, b, group_tiles):
    if vals.dim() != 3 or cols_win.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols_win "
                         f"{tuple(cols_win.shape)} must be equal (T, P, R)")
    if vals.dtype != torch.float32 or b.dtype != torch.float32:
        raise NotImplementedError(f"window SpMM runs float32 only (vals "
                                  f"{vals.dtype}, B {b.dtype})")
    if cols_win.dtype != torch.int16 or window_base.dtype != torch.int32:
        raise ValueError("cols_win must be int16 and window_base int32")
    if vals.shape[0] % group_tiles or \
            window_base.shape != (vals.shape[0] // group_tiles,):
        raise ValueError("window_base must hold one base per group")
    if b.dim() != 2 or b.shape[1] < 1:
        raise ValueError(f"B must be (cols, k) with k >= 1, got shape "
                         f"{tuple(b.shape)}")
    for t in (cols_win, window_base, b):
        if t.device != vals.device:
            raise ValueError(f"operands on {vals.device} and {t.device}")
    if not all(t.is_contiguous() for t in (vals, cols_win, window_base, b)):
        raise ValueError("window SpMM operands must be contiguous")


def spmm_window_kernel(vals, cols_win, window_base, b, *, group_tiles: int,
                       window_grain: int, fold: bool) -> torch.Tensor:
    """Kernel H on CUDA tensors; the plain version on CPU tensors."""
    _check_window(vals, cols_win, window_base, b, group_tiles)
    if not platform.is_cuda(b):
        return spmm_window_plain(vals, cols_win, window_base, b,
                                 group_tiles=group_tiles,
                                 window_grain=window_grain, fold=fold)
    T, P, R = vals.shape
    k = b.shape[1]
    out_rows = T // group_tiles if fold else T
    out = torch.empty((out_rows, R, k), dtype=torch.float32, device=b.device)
    err = _kernels.library().spmm_sell_window_f32(
        vals.data_ptr(), cols_win.data_ptr(), window_base.data_ptr(),
        b.data_ptr(), out.data_ptr(), out_rows, P, R, group_tiles,
        int(fold), window_grain, b.shape[0], k,
        torch.cuda.current_stream(b.device).cuda_stream)
    _kernels.check(err, "spmm_sell_window_f32")
    spmm_window_kernel.launches += 1
    return out


spmm_window_kernel.launches = 0


def _spmm_window(plan: SellPlan, b: torch.Tensor) -> torch.Tensor:
    """Kernel H, then the slice reduction and sub-row fixup of the SpMV
    window path over the trailing k axis.  The reference's per-chunk
    ``segment_sum`` loop and its (S, k8, 8, R) transpose reduce to the
    same Y."""
    st = plan.stats
    fold = folds_groups(plan)
    out = spmm_window_kernel(plan.vals, plan.cols_win, plan.window_base, b,
                             group_tiles=st.group_tiles,
                             window_grain=st.window_grain, fold=fold)
    return _reduce_partials(plan, out, "plus_times", per_group=fold)


def _spmm_coo(plan: CooTail, b: torch.Tensor) -> torch.Tensor:
    """COO tail: a gather of B's rows + ``index_add_`` (torch ops, as the
    reference runs it in XLA)."""
    prod = plan.vals.to(b.dtype)[:, None] * b[plan.cols.long()]
    rows = plan.shape[0]
    y = b.new_zeros((rows + 1, b.shape[1]))
    return y.index_add_(0, plan.rows_idx, prod)[:rows]


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def spmm_plan(plan, b: torch.Tensor) -> torch.Tensor:
    """Fused SpMM ``Y = A @ B`` (plus_times) from a prebuilt plan, with B
    of shape (cols, k) float32 on the plan's device.

    Dispatches on plan type as the reference does: a CooTail gathers B's
    rows, a DiaPlan runs kernel I, a window SellPlan kernel H, a
    HybridPlan kernel I on its DIA part plus its residual's SpMM.  Every
    other plan raises :class:`NoFusedSpmm` before anything runs (see
    :func:`has_fused_spmm`).
    """
    if b.dim() != 2 or b.shape[0] != plan.shape[1]:
        raise ValueError(f"B has shape {tuple(b.shape)}, the plan needs "
                         f"({plan.shape[1]}, k)")
    if not has_fused_spmm(plan):
        raise NoFusedSpmm(f"{type(plan).__name__} has no fused SpMM kernel; "
                          f"run reference.spmm on the matrix")
    b = b.to(torch.float32).contiguous()
    if isinstance(plan, CooTail):
        return _spmm_coo(plan, b)
    if isinstance(plan, DiaPlan):
        return spmm_dia(plan, b)
    if isinstance(plan, HybridPlan):
        return spmm_dia(plan.dia, b) + spmm_plan(plan.rest, b)
    return _spmm_window(plan, b)
