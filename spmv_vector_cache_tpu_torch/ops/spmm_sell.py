"""SELL window SpMM and the SpMM plan dispatch (counterpart of
``spmv_vector_cache_tpu/ops/spmm_pallas.py``).

``Y = A @ B`` with B of shape (cols, k): the fused multi-RHS product,
which streams a plan's nonzeros once for many right-hand sides instead of
once per column.  :func:`spmm_window_kernel` wraps kernel H
(``csrc/spmm_sell_window.cu``), which replaces the reference's
``_make_spmm_kernel`` and its ``_bt_windows`` operand and sums each
slice's tiles itself (the placed plan's work list, ``formats/tables.py``):
it writes Y's rows where the plan's rows are an identity map or a
uniform-parts lane fold, and slice sums for the SELL SpMV epilogue's
``row_map`` reduce otherwise.
:func:`spmm_window_plain` is its plain PyTorch version.
:func:`spmm_plan` dispatches on plan type; :func:`has_fused_spmm` says,
before anything runs, whether a plan has a fused kernel at all.
"""

from __future__ import annotations

import torch

from ..formats.cached import CooTail
from ..formats.dia import DiaPlan, HybridPlan
from ..formats.plan import SellPlan
from ..formats.tables import placed
from ..utils import platform
from . import _kernels
from . import semiring as sr
from .spmm_dia import spmm_dia_kernel
from .spmv_sell import (_fixup_rows, fold_lanes, plan_as_x,
                        plan_vals_dtype, row_parts, sell_window_plain)


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
    """Whether :func:`spmm_plan` runs ``plan``: a CooTail, a DiaPlan, a
    window SellPlan, or a HybridPlan of those, of any value type but
    float64 (the reference has no float64 SpMM kernel)."""
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

def spmm_window_plain(vals, cols_win, window_base, tile_slice, b, *,
                      num_slices: int, group_tiles: int, window_grain: int,
                      parts: int, rows: int) -> torch.Tensor:
    """Plain PyTorch version of kernel H (same inputs, same output):
    kernel B's per-tile partials under plus_times over B's trailing k
    axis, their segment sums over ``tile_slice``, then, for ``parts`` >=
    1, the lane fold to Y's (rows, k), in B's type."""
    partials = sell_window_plain(vals, cols_win, window_base, b,
                                 group_tiles=group_tiles,
                                 window_grain=window_grain, fold=False,
                                 semiring="plus_times")
    y2d = sr.PLUS_TIMES.segment_reduce(partials, tile_slice,
                                       num_segments=num_slices)
    return fold_lanes(y2d, parts, rows) if parts else y2d


def _check_window(vals, cols_win, window_base, tile_slice, b, group_tiles,
                  num_slices, parts):
    if vals.dim() != 3 or cols_win.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols_win "
                         f"{tuple(cols_win.shape)} must be equal (T, P, R)")
    if vals.dtype not in _kernels.BUILDS or \
            b.dtype != sr.x_dtype(vals.dtype):
        raise NotImplementedError(
            f"window SpMM runs float32, bfloat16, float16 and 8-, 16- and "
            f"32-bit integer values with a B of their sum type (vals "
            f"{vals.dtype}, B {b.dtype})")
    if cols_win.dtype != torch.int16 or window_base.dtype != torch.int32 or \
            tile_slice.dtype != torch.int32:
        raise ValueError("cols_win must be int16, window_base and "
                         "tile_slice int32")
    if vals.shape[0] % group_tiles or \
            window_base.shape != (vals.shape[0] // group_tiles,):
        raise ValueError("window_base must hold one base per group")
    if tile_slice.shape != vals.shape[:1] or num_slices < 1:
        raise ValueError("tile_slice must hold one slice per tile")
    if parts < 0 or (parts and vals.shape[2] % parts):
        raise ValueError(f"parts={parts} must divide the {vals.shape[2]} "
                         f"lanes")
    if b.dim() != 2 or b.shape[1] < 1:
        raise ValueError(f"B must be (cols, k) with k >= 1, got shape "
                         f"{tuple(b.shape)}")
    for t in (cols_win, window_base, tile_slice, b):
        if t.device != vals.device:
            raise ValueError(f"operands on {vals.device} and {t.device}")
    if not all(t.is_contiguous()
               for t in (vals, cols_win, window_base, tile_slice, b)):
        raise ValueError("window SpMM operands must be contiguous")


def spmm_window_kernel(vals, cols_win, window_base, tile_slice, b, *,
                       num_slices: int, group_tiles: int, window_grain: int,
                       parts: int, rows: int, work=None) -> torch.Tensor:
    """Kernel H on CUDA tensors; the plain version on CPU tensors.
    Returns Y (rows, k) for ``parts`` >= 1, else the (num_slices, R, k)
    slice sums.  On the card ``work`` is the work list of ``tile_slice``
    (a placed plan's ``work``)."""
    _check_window(vals, cols_win, window_base, tile_slice, b, group_tiles,
                  num_slices, parts)
    kw = dict(num_slices=num_slices, group_tiles=group_tiles,
              window_grain=window_grain, parts=parts, rows=rows)
    if not platform.is_cuda(b):
        return spmm_window_plain(vals, cols_win, window_base, tile_slice, b,
                                 **kw)
    T, P, R = vals.shape
    k = b.shape[1]
    work = placed(work, "the work list of kernel H")
    if parts:
        shape = (rows, k)
        covered = rows <= num_slices * (R // parts)
    else:
        shape, covered = (num_slices, R, k), True
    alloc = torch.empty if covered and not work.split else torch.zeros
    out = alloc(shape, dtype=b.dtype, device=b.device)
    _kernels.launch(
        _kernels.entry("spmm_sell_window_f32", vals.dtype), b.get_device(),
        vals.data_ptr(),
        cols_win.data_ptr(), window_base.data_ptr(), tile_slice.data_ptr(),
        work.runs.data_ptr(), b.data_ptr(), out.data_ptr(),
        work.runs.shape[0], P, R, group_tiles, window_grain, b.shape[0], k,
        parts, rows)
    return out


def _spmm_window(plan: SellPlan, b: torch.Tensor) -> torch.Tensor:
    """Kernel H, which sums each slice's tiles and folds its lanes into
    Y's rows itself; a general ``row_map`` then takes the SpMV path's
    segment reduce over the trailing k axis.  The reference's per-chunk
    ``segment_sum`` loop and its (S, k8, 8, R) transpose reduce to the
    same Y."""
    st = plan.stats
    parts = row_parts(plan)
    out = spmm_window_kernel(plan.vals, plan.cols_win, plan.window_base,
                             plan.tile_slice, b, num_slices=plan.num_slices,
                             group_tiles=st.group_tiles,
                             window_grain=st.window_grain, parts=parts,
                             rows=plan.shape[0], work=plan.work)
    return out if parts else _fixup_rows(plan, out, "plus_times")


def _spmm_coo(plan: CooTail, b: torch.Tensor) -> torch.Tensor:
    """COO tail: a gather of B's rows + ``index_add_`` (torch ops, as the
    reference runs it in XLA), in B's type."""
    bw = sr.widen(b)
    prod = sr.widen(plan.vals.to(b.dtype))[:, None] * bw[plan.cols.long()]
    rows = plan.shape[0]
    y = bw.new_zeros((rows + 1, b.shape[1]))
    return sr.narrow(y.index_add_(0, plan.rows_idx, prod)[:rows], b.dtype)


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
    return sr.finish_y(_spmm_sums(plan, plan_as_x(plan, b)),
                       plan_vals_dtype(plan))


def _spmm_sums(plan, b: torch.Tensor) -> torch.Tensor:
    """:func:`spmm_plan`'s dispatch, B (cast once, by the caller) and Y
    in the plan's sum type."""
    if isinstance(plan, CooTail):
        return _spmm_coo(plan, b)
    if isinstance(plan, DiaPlan):
        return spmm_dia_kernel(plan.vals, plan.offsets, b, plan.shape[0])
    if isinstance(plan, HybridPlan):
        return sr.PLUS_TIMES.combine(_spmm_sums(plan.dia, b),
                                     _spmm_sums(plan.rest, b))
    return _spmm_window(plan, b)
