"""SELL window SpMV and the plan dispatch (counterpart of
``spmv_vector_cache_tpu/ops/spmv_pallas.py``).

:func:`sell_window_kernel` wraps kernel B (``csrc/spmv_sell_window.cu``),
which replaces the reference's window kernel; :func:`sell_window_plain`
is its plain PyTorch version.  The epilogues — the slice reduction, the
sub-row fixup, the Hybrid add and the COO tail — are torch ops, as the
reference computes them in XLA outside Pallas.  :func:`spmv_plan`
dispatches every plan type, ChunkPlan (``ops/spmv_chunk.py``) and
PackedPlan (``ops/spmv_packed.py``) included.  The ``resident``,
``deep`` and ``stream`` strategies and the df64 and Cached paths are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..formats.cached import CooTail
from ..formats.chunk import ChunkPlan
from ..formats.dia import DiaPlan, HybridPlan
from ..formats.packed import PackedPlan
from ..formats.plan import DEEP_MAX_BLOCKS, RESIDENT_MAX_BLOCKS, SellPlan
from ..formats.plan import TILES_PER_STEP
from ..utils import platform
from . import _kernels
from . import semiring as sr
from .spmv_dia import spmv_dia
from .spmv_packed import spmv_packed

# ---------------------------------------------------------------------------
# epilogues
# ---------------------------------------------------------------------------

def _fixup_rows(plan: SellPlan, y2d: torch.Tensor,
                semiring: str) -> torch.Tensor:
    """(num_slices, R) slice sums -> y: identity slice, uniform-parts
    lane fold, or the general row_map segment reduce."""
    rows = plan.shape[0]
    if plan.identity_map:
        return y2d.reshape(-1)[:rows]
    s = sr.get(semiring)
    p = plan.stats.uniform_parts
    if p:
        # part j of row r sits at lane j*rps + r%rps: fold contiguous
        # lane slices
        rps = plan.lane_rows // p
        acc = y2d[:, :rps]
        for j in range(1, p):
            acc = s.add(acc, y2d[:, j * rps:(j + 1) * rps])
        # or_and's logical add yields bool; restore the float encoding
        return acc.to(y2d.dtype).reshape(-1)[:rows]
    y = s.segment_reduce(y2d.reshape(-1), plan.row_map, num_segments=rows + 1)
    return y[:rows]


def _reduce_partials(plan: SellPlan, partials: torch.Tensor,
                     semiring: str = "plus_times",
                     per_group: bool = False) -> torch.Tensor:
    """Kernel output -> y.  ``partials`` holds per-tile rows (T, R), or
    per-group rows (ngroups, R) when the kernel folded slices
    (``per_group``); both reduce to y2d, then the sub-row fixup runs."""
    s = sr.get(semiring)
    st = plan.stats
    if per_group and st.group_slice_identity:
        y2d = partials[:plan.num_slices]
    else:
        ids = plan.tile_slice
        if per_group:
            ids = ids[::st.group_tiles]
        y2d = s.segment_reduce(partials, ids, num_segments=plan.num_slices)
    return _fixup_rows(plan, y2d, semiring)


# ---------------------------------------------------------------------------
# window strategy: kernel B
# ---------------------------------------------------------------------------

def sell_window_plain(vals, cols_win, window_base, x, *, group_tiles: int,
                      window_grain: int, fold: bool,
                      semiring: str) -> torch.Tensor:
    """Plain PyTorch version of kernel B (same inputs, same output)."""
    mul, axis_reduce = sr.kernel_ops(semiring)
    T, P, R = vals.shape
    cols = x.shape[0]
    base = window_base.long().repeat_interleave(group_tiles) * window_grain
    c = (base[:, None, None] + cols_win.long()).clamp_(max=cols)
    xz = torch.cat([x, x.new_zeros(1)])        # c >= cols reads 0
    prod = mul(vals, xz[c])
    if fold:
        return axis_reduce(prod.reshape(T // group_tiles, group_tiles * P, R),
                           1)
    return axis_reduce(prod, 1)


def _check_window(vals, cols_win, window_base, x, group_tiles):
    if vals.dim() != 3 or cols_win.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols_win "
                         f"{tuple(cols_win.shape)} must be equal (T, P, R)")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise NotImplementedError(f"window SpMV runs float32 only (vals "
                                  f"{vals.dtype}, x {x.dtype})")
    if cols_win.dtype != torch.int16 or window_base.dtype != torch.int32:
        raise ValueError("cols_win must be int16 and window_base int32")
    if vals.shape[0] % group_tiles or \
            window_base.shape != (vals.shape[0] // group_tiles,):
        raise ValueError("window_base must hold one base per group")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    for t in (cols_win, window_base, x):
        if t.device != vals.device:
            raise ValueError(f"operands on {vals.device} and {t.device}")
    if not all(t.is_contiguous() for t in (vals, cols_win, window_base, x)):
        raise ValueError("window operands must be contiguous")


def sell_window_kernel(vals, cols_win, window_base, x, *, group_tiles: int,
                       window_grain: int, fold: bool,
                       semiring: str) -> torch.Tensor:
    """Kernel B on CUDA tensors; the plain version on CPU tensors."""
    _check_window(vals, cols_win, window_base, x, group_tiles)
    if not platform.is_cuda(x):
        return sell_window_plain(vals, cols_win, window_base, x,
                                 group_tiles=group_tiles,
                                 window_grain=window_grain, fold=fold,
                                 semiring=semiring)
    T, P, R = vals.shape
    out_rows = T // group_tiles if fold else T
    out = torch.empty((out_rows, R), dtype=torch.float32, device=x.device)
    err = _kernels.library().spmv_sell_window_f32(
        vals.data_ptr(), cols_win.data_ptr(), window_base.data_ptr(),
        x.data_ptr(), out.data_ptr(), out_rows, P, R, group_tiles,
        int(fold), window_grain, x.shape[0], sr.KERNEL_CODE[semiring],
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(err, "spmv_sell_window_f32")
    sell_window_kernel.launches += 1
    return out


sell_window_kernel.launches = 0


def _window_partials(plan: SellPlan, x: torch.Tensor, semiring: str):
    """Run the window kernel, returning (per-tile or per-group partial
    rows, fold) before any slice/row reduction."""
    st = plan.stats
    if st.window_blocks <= 0:
        raise ValueError(
            "window strategy infeasible for this plan "
            "(stats.window_blocks == 0); rebuild with stripe_width")
    NG = TILES_PER_STEP * st.groups_per_step // st.group_tiles
    fold = st.group_fold and NG % 8 == 0
    out = sell_window_kernel(
        plan.vals, plan.cols_win, plan.window_base,
        x.to(plan.vals.dtype).contiguous(), group_tiles=st.group_tiles,
        window_grain=st.window_grain, fold=fold, semiring=semiring)
    return out, fold


def _spmv_window(plan: SellPlan, x: torch.Tensor,
                 semiring: str = "plus_times") -> torch.Tensor:
    out, fold = _window_partials(plan, x, semiring)
    return _reduce_partials(plan, out, semiring, per_group=fold)


def _spmv_coo(plan: CooTail, x: torch.Tensor, semiring: str) -> torch.Tensor:
    """COO tail: element gather + segment reduce (torch ops, as the
    reference runs it in XLA)."""
    s = sr.get(semiring)
    mul, _ = sr.kernel_ops(semiring)
    prod = mul(plan.vals.to(x.dtype), x[plan.cols.long()])
    rows = plan.shape[0]
    return s.segment_reduce(prod, plan.rows_idx, num_segments=rows + 1)[:rows]


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def spmv_plan(plan, x: torch.Tensor, *, strategy: str = "auto",
              semiring: str = "plus_times") -> torch.Tensor:
    """Run SpMV ``y = A (+).(x) x`` from a prebuilt plan on ``x.device``.

    Dispatches on plan type: DiaPlan runs kernel A, HybridPlan adds its
    residual pass, a SellPlan runs the 'window' strategy on kernel B, a
    ChunkPlan kernels B, D and C, a PackedPlan kernels E and F, a CooTail
    the gather + segment reduce.  DIA and packed plans support
    plus_times only; SELL and chunk plans must have been built with
    ``pad_value`` = the semiring's zero (``auto_plan(semiring=...)``
    does this).
    """
    semiring = sr.get(semiring).name
    if isinstance(plan, ChunkPlan):
        if strategy not in ("auto", "window", "chunk"):
            raise ValueError(f"ChunkPlan supports only the 'chunk' "
                             f"strategy, got {strategy!r}")
        from .spmv_chunk import spmv_chunk   # spmv_chunk imports this module

        return spmv_chunk(plan, x, semiring=semiring)
    if isinstance(plan, CooTail):
        return _spmv_coo(plan, x, semiring)
    if isinstance(plan, PackedPlan):
        if strategy not in ("auto", "packed"):
            raise ValueError(f"PackedPlan supports only the 'packed' "
                             f"strategy, got {strategy!r}")
        return spmv_packed(plan, x, semiring=semiring)
    if isinstance(plan, (DiaPlan, HybridPlan)) and semiring != "plus_times":
        raise ValueError("DIA plans encode absence as 0 and support only "
                         "plus_times; build a SELL plan via "
                         "auto_plan(semiring=...)")
    if isinstance(plan, DiaPlan):
        if strategy not in ("auto", "dia"):
            raise ValueError(f"DiaPlan supports only the 'dia' strategy, "
                             f"got {strategy!r}")
        return spmv_dia(plan, x)
    if isinstance(plan, HybridPlan):
        # 'dia' (what select_strategy gives a HybridPlan) names the DIA
        # part; the residual then picks its own strategy.  The reference
        # passes 'dia' on to a SELL residual, which rejects it.
        rest_strategy = "auto" if strategy == "dia" else strategy
        return (spmv_dia(plan.dia, x) +
                spmv_plan(plan.rest, x, strategy=rest_strategy))
    if not isinstance(plan, SellPlan):
        raise NotImplementedError(
            f"{type(plan).__name__} is not ported yet (ROADMAP.md queue 1)")
    if plan.stats.double:
        raise NotImplementedError("double-float SELL plans are not ported "
                                  "(ROADMAP.md queue 1, item 10)")
    if strategy == "auto":
        nb = -(-plan.shape[1] // 128)
        if plan.stats.window_blocks > 0:
            strategy = "window"
        elif nb <= RESIDENT_MAX_BLOCKS:
            strategy = "resident"
        elif nb <= DEEP_MAX_BLOCKS:
            strategy = "deep"
        else:
            strategy = "stream"
    if strategy == "window":
        return _spmv_window(plan, x, semiring=semiring)
    if strategy in ("resident", "deep", "stream"):
        raise NotImplementedError(
            f"the {strategy!r} SELL strategy is not ported yet (ROADMAP.md "
            f"queue 1, item 5)")
    raise ValueError(f"unknown strategy {strategy!r}")
