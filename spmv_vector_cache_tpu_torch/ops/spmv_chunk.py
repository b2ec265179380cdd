"""ChunkPlan SpMV (counterpart of ``_subwin_partials`` and ``_spmv_chunk``
in ``spmv_vector_cache_tpu/ops/spmv_pallas.py``).

:func:`heavy_kernel` wraps kernel D (``csrc/spmv_subwin.cu``): one launch
over all the plan's heavy subwindow tiles (the slab and work list that
placement builds, ``ops/runs.py`` :func:`~.runs.heavy_on`), which adds
each heavy row's sum into y in place; :func:`heavy_plain` is its plain
PyTorch version, and :func:`subwin_plain` the reference's per-tile
function (``_subwin_partials``).  The light buckets are window
SellPlans and run on kernel B (``spmv_sell._window_partials``).  The
rest is torch ops, as the reference computes it in XLA outside Pallas:
each light bucket's sorted segment reduce over the unified segment
space, the semiring add across buckets, the lane un-permutation of the
light blocks (kernel C), the lane fold and merge of the heavy segments'
light tiles, and the residue add.
"""

from __future__ import annotations

import torch

from ..formats.cached import CooTail
from ..formats.chunk import ChunkPlan
from ..formats.packed import PackedPlan
from ..utils import platform
from . import _kernels
from . import semiring as sr
from .lane_perm import unpermute_plan_rows
from .runs import heavy_on, runs_on
from .spmv_packed import spmv_packed
from .spmv_sell import _spmv_coo, _window_partials

# ---------------------------------------------------------------------------
# heavy rows: kernel D
# ---------------------------------------------------------------------------

def subwin_plain(vals, cols_win, bases, x, *, semiring: str) -> torch.Tensor:
    """The reference's ``_subwin_partials`` on tensors: per tile t and
    lane l, (+)_p vals (x) x[bases[t, p] * 128 + cols_win[t, p, l]], a
    column past x reading 0; (T, 128)."""
    mul, axis_reduce = sr.kernel_ops(semiring)
    cols = x.shape[0]
    c = bases.long()[:, :, None] * 128 + cols_win.long()
    xz = torch.cat([x, x.new_zeros(1)])        # c >= cols reads 0
    return axis_reduce(mul(vals, xz[c.clamp_(max=cols)]), 1)


def heavy_plain(vals, cols_win, bases, tile_row, rows, x, y, *,
                semiring: str) -> torch.Tensor:
    """Plain PyTorch version of kernel D (same inputs, same output): for
    each heavy row k, ``y[rows[k]] = y[rows[k]] (+) s_k``, in place, where
    s_k is the semiring sum over row k's tiles (``tile_row == k``), their
    positions and lanes (or_and: 1 where the max_times sum is >= 1, as
    the reference's segment reduce gives it); returns y."""
    s = sr.get(semiring)
    _, axis_reduce = sr.kernel_ops(semiring)
    per_tile = axis_reduce(subwin_plain(vals, cols_win, bases, x,
                                        semiring=semiring), 1)
    sums = s.segment_reduce(per_tile, tile_row, num_segments=rows.shape[0])
    idx = rows.long()
    # or_and's logical add yields bool; restore the float encoding
    y[idx] = s.add(y[idx], sums).to(y.dtype)
    return y


def _check_heavy(vals, cols_win, bases, tile_row, rows, x, y):
    if vals.dim() != 3 or cols_win.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols_win "
                         f"{tuple(cols_win.shape)} must be equal (T, P, R)")
    if bases.shape != vals.shape[:2] or tile_row.shape != vals.shape[:1]:
        raise ValueError(f"bases {tuple(bases.shape)} and tile_row "
                         f"{tuple(tile_row.shape)} must be (T, P) and (T,) "
                         f"for T, P = {tuple(vals.shape[:2])}")
    if vals.dtype != torch.float32 or x.dtype != torch.float32 or \
            y.dtype != torch.float32:
        raise NotImplementedError(f"subwindow SpMV runs float32 only (vals "
                                  f"{vals.dtype}, x {x.dtype}, y {y.dtype})")
    if cols_win.dtype != torch.int16 or bases.dtype != torch.int32 or \
            tile_row.dtype != torch.int32 or rows.dtype != torch.int32:
        raise ValueError("cols_win must be int16, bases, tile_row and rows "
                         "int32")
    if x.dim() != 1 or y.dim() != 1 or rows.dim() != 1:
        raise ValueError("x, y and rows must be 1-D")
    for t in (cols_win, bases, tile_row, rows, x, y):
        if t.device != vals.device:
            raise ValueError(f"operands on {vals.device} and {t.device}")
    if not all(t.is_contiguous()
               for t in (vals, cols_win, bases, tile_row, rows, x, y)):
        raise ValueError("subwindow operands must be contiguous")


def heavy_kernel(vals, cols_win, bases, tile_row, rows, x, y, *,
                 semiring: str) -> torch.Tensor:
    """Kernel D on CUDA tensors; the plain version on CPU tensors.
    Updates and returns ``y``.  On the card ``tile_row`` must be a
    placed plan's heavy slab's (its work list, ``ops/runs.py``, is built
    at placement)."""
    _check_heavy(vals, cols_win, bases, tile_row, rows, x, y)
    if not platform.is_cuda(x):
        return heavy_plain(vals, cols_win, bases, tile_row, rows, x, y,
                           semiring=semiring)
    T, P, R = vals.shape
    work = runs_on(tile_row, rows.shape[0])
    _kernels.launch(
        "spmv_subwin_f32", x.get_device(), vals.data_ptr(),
        cols_win.data_ptr(), bases.data_ptr(), tile_row.data_ptr(),
        rows.data_ptr(), work.runs.data_ptr(), x.data_ptr(), y.data_ptr(),
        work.runs.shape[0], P, R, x.shape[0], work.max_tiles,
        work.max_slices, sr.KERNEL_CODE[semiring])
    heavy_kernel.launches += 1
    return y


heavy_kernel.launches = 0


# ---------------------------------------------------------------------------
# the ChunkPlan apply
# ---------------------------------------------------------------------------

def spmv_chunk(plan: ChunkPlan, x: torch.Tensor,
               semiring: str = "plus_times") -> torch.Tensor:
    """Light buckets' kernels -> one sorted segment reduction over the
    unified (light blocks + heavy rows) space -> lane un-permutation of
    the light part, lane fold and merge of the heavy segments' light
    tiles -> kernel D adds the heavy subwindow tiles into y -> residue
    add."""
    s = sr.get(semiring)
    _, axis_reduce = sr.kernel_ops(semiring)
    nblk = plan.num_blocks
    nheavy = plan.num_heavy
    rows = plan.shape[0]
    y2d = None
    for b in plan.buckets:
        part, fold = _window_partials(b, x, semiring)
        ids = b.tile_slice[::b.stats.group_tiles] if fold else b.tile_slice
        y2b = s.segment_reduce(part, ids, num_segments=nblk + nheavy)
        # or_and's logical add yields bool; restore the float encoding
        y2d = y2b if y2d is None else s.add(y2d, y2b).to(y2b.dtype)
    if y2d is None:                 # no light tiles: every segment empty
        y2d = s.segment_reduce(
            torch.zeros((0, 128), dtype=torch.float32, device=x.device),
            torch.zeros(0, dtype=torch.int32, device=x.device),
            num_segments=nblk + nheavy)
    y = unpermute_plan_rows(y2d[:nblk], plan.perm_idx).reshape(-1)[:rows]
    if nheavy:
        yh = axis_reduce(y2d[nblk:], 1)            # (nheavy,)
        yh = s.segment_reduce(yh, plan.heavy_rows,
                              num_segments=rows + 1)[:rows]
        y = s.add(y, yh).to(y.dtype)               # a new y: D adds in place
        heavy = heavy_on(plan)
        if heavy is not None:
            y = heavy_kernel(heavy.vals, heavy.cols_win, heavy.bases,
                             heavy.tile_row, heavy.rows,
                             x.to(torch.float32).contiguous(), y,
                             semiring=semiring)
    if isinstance(plan.residue, CooTail):
        y = s.add(y, _spmv_coo(plan.residue, x, semiring)).to(y.dtype)
    elif isinstance(plan.residue, PackedPlan):
        y = s.add(y, spmv_packed(plan.residue, x,
                                 semiring=semiring)).to(y.dtype)
    return y
