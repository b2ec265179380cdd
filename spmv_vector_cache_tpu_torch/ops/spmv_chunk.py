"""ChunkPlan SpMV (counterpart of ``_subwin_partials`` and ``_spmv_chunk``
in ``spmv_vector_cache_tpu/ops/spmv_pallas.py``).

:func:`light_kernel` wraps the chunk light route
(``csrc/spmv_chunk_light.cu``): one launch over the real slots of all
the plan's light buckets (the records by lane row that placement builds,
the plan's ``light``, ``formats/tables.py``), which writes every lane row
of the unified segment space once: what the reference's window kernel
gives per bucket, its sorted segment reduce and the add across buckets
give together.  :func:`light_plain` is its plain PyTorch version.
:func:`heavy_kernel` wraps kernel D (``csrc/spmv_subwin.cu``): one
launch over all the plan's heavy subwindow tiles (the slab and work
list that placement builds, the plan's ``heavy``), which adds each
heavy row's sum into y in place; :func:`heavy_plain` is its plain
PyTorch version, and :func:`subwin_plain` the reference's per-tile
function (``_subwin_partials``).  The rest is as the reference computes
it outside Pallas: the lane un-permutation of the light blocks (kernel
C), the lane fold and merge of the heavy segments' light tiles (torch
ops), and the residue add.  The light route and kernel D have a build
for each value type of ``ops/semiring.py``'s policy, and the heavy
merge runs in the sums' type.
"""

from __future__ import annotations

import torch

from ..formats.cached import CooTail
from ..formats.chunk import ChunkPlan
from ..formats.packed import PackedPlan
from ..formats.tables import HeavyTiles, LightRecords, placed
from ..utils import platform
from . import _kernels
from . import semiring as sr
from .lane_perm import unpermute_plan_rows
from .spmv_packed import spmv_packed
from .spmv_sell import _spmv_coo

# ---------------------------------------------------------------------------
# light buckets: the chunk light route
# ---------------------------------------------------------------------------

def light_plain(light: LightRecords, x, *, semiring: str) -> torch.Tensor:
    """Plain PyTorch version of the light route (same inputs, same
    output): the sorted segment reduce of the records' products over
    lane rows, a column past x reading 0; a lane row of a ``tiled``
    segment also sums the semiring's zero.  (segments, 128), in x's
    type."""
    s = sr.get(semiring)
    mul, axis_reduce = sr.kernel_ops(semiring, light.vals.dtype)
    out_dtype = x.dtype
    vals, x = sr.widen(light.vals, semiring), sr.widen(x, semiring)
    nrows = light.row_off.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(nrows, device=x.device), light.row_off.diff().long())
    xz = torch.cat([x, x.new_zeros(1)])        # c >= cols reads 0
    prod = mul(vals, xz[light.cols.long().clamp(max=x.shape[0])])
    y2d = s.segment_reduce(prod, rows, num_segments=nrows).reshape(-1, 128)
    padded = axis_reduce(torch.stack([y2d, torch.full_like(y2d, s.zero)]),
                         0)
    return sr.narrow(torch.where(light.tiled[:, None], padded, y2d),
                     out_dtype)


def _check_light(light: LightRecords, x):
    if light.vals.dtype not in _kernels.BUILDS or x.dim() != 1 or \
            x.dtype != sr.x_dtype(light.vals.dtype):
        raise ValueError(f"x must be 1-D of the records' sum type "
                         f"({light.vals.dtype} values), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if light.row_off.shape != (light.tiled.shape[0] * 128 + 1,):
        raise ValueError(f"row_off {tuple(light.row_off.shape)} and tiled "
                         f"{tuple(light.tiled.shape)}: not one offset a "
                         f"lane row of those segments")
    if light.units.dim() != 2 or light.units.shape[1] != 2:
        raise ValueError(f"units {tuple(light.units.shape)}: not (CTAs + "
                         f"1, 2) bounds")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device != light.vals.device:
        raise ValueError(f"the records on {light.vals.device}, x on "
                         f"{x.device}")


def light_kernel(light: LightRecords, x, *, semiring: str) -> torch.Tensor:
    """The light route on CUDA tensors; the plain version on CPU tensors.
    Returns the (segments, 128) sums of the unified segment space, in
    x's type.  ``light`` is a placed plan's (``formats/tables.py``
    ``light_records``, which made its tensors contiguous and typed)."""
    _check_light(light, x)
    sr.check_integer(semiring, light.vals.dtype)
    if not platform.is_cuda(x):
        return light_plain(light, x, semiring=semiring)
    y2d = torch.empty((light.tiled.shape[0], 128), dtype=x.dtype,
                      device=x.device)
    _kernels.launch(
        _kernels.entry("spmv_chunk_light_f32", light.vals.dtype),
        x.get_device(), light.row_off.data_ptr(),
        light.cols.data_ptr(), light.vals.data_ptr(),
        light.tiled.data_ptr(), light.units.data_ptr(), x.data_ptr(),
        y2d.data_ptr(), light.units.shape[0] - 1, x.shape[0],
        sr.KERNEL_CODE[semiring])
    return y2d


# ---------------------------------------------------------------------------
# heavy rows: kernel D
# ---------------------------------------------------------------------------

def subwin_plain(vals, cols_win, bases, x, *, semiring: str) -> torch.Tensor:
    """The reference's ``_subwin_partials`` on tensors: per tile t and
    lane l, (+)_p vals (x) x[bases[t, p] * 128 + cols_win[t, p, l]], a
    column past x reading 0; (T, 128), in :func:`~.semiring.widen`'s
    types."""
    mul, axis_reduce = sr.kernel_ops(semiring, vals.dtype)
    vals, x = sr.widen(vals, semiring), sr.widen(x, semiring)
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
    sums = s.segment_reduce(sr.narrow(per_tile, y.dtype), tile_row,
                            num_segments=rows.shape[0])
    idx = rows.long()
    new = s.combine(sr.take(y, idx), sums)
    # torch writes no uint32 by index: its int32 view takes the same bits
    dst = y.view(torch.int32) if y.dtype == torch.uint32 else y
    dst[idx] = new.view(dst.dtype)
    return y


def _check_heavy(vals, cols_win, bases, tile_row, rows, x, y):
    if vals.dim() != 3 or cols_win.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols_win "
                         f"{tuple(cols_win.shape)} must be equal (T, P, R)")
    if bases.shape != vals.shape[:2] or tile_row.shape != vals.shape[:1]:
        raise ValueError(f"bases {tuple(bases.shape)} and tile_row "
                         f"{tuple(tile_row.shape)} must be (T, P) and (T,) "
                         f"for T, P = {tuple(vals.shape[:2])}")
    if vals.dtype not in _kernels.BUILDS or \
            not x.dtype == y.dtype == sr.x_dtype(vals.dtype):
        raise NotImplementedError(
            f"subwindow SpMV runs float32, bfloat16, float16 and 8-, 16- "
            f"and 32-bit integer values with x and y of their sum type "
            f"(vals {vals.dtype}, x {x.dtype}, y {y.dtype})")
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


def heavy_kernel(heavy: HeavyTiles, x, y, *, semiring: str) -> torch.Tensor:
    """Kernel D on CUDA tensors; the plain version on CPU tensors, over
    a placed ChunkPlan's heavy slab (its ``heavy``, which carries the
    slab's work list).  Updates and returns ``y``."""
    vals, cols_win, bases, tile_row, rows = (
        heavy.vals, heavy.cols_win, heavy.bases, heavy.tile_row, heavy.rows)
    _check_heavy(vals, cols_win, bases, tile_row, rows, x, y)
    sr.check_integer(semiring, vals.dtype)
    if not platform.is_cuda(x):
        return heavy_plain(vals, cols_win, bases, tile_row, rows, x, y,
                           semiring=semiring)
    T, P, R = vals.shape
    work = heavy.work
    _kernels.launch(
        _kernels.entry("spmv_subwin_f32", vals.dtype), x.get_device(),
        vals.data_ptr(),
        cols_win.data_ptr(), bases.data_ptr(), tile_row.data_ptr(),
        rows.data_ptr(), work.runs.data_ptr(), x.data_ptr(), y.data_ptr(),
        work.runs.shape[0], P, R, x.shape[0], work.max_tiles,
        work.max_slices, sr.KERNEL_CODE[semiring])
    return y


# ---------------------------------------------------------------------------
# the ChunkPlan apply
# ---------------------------------------------------------------------------

def spmv_chunk(plan: ChunkPlan, x: torch.Tensor,
               semiring: str = "plus_times") -> torch.Tensor:
    """The light route writes the unified (light blocks + heavy rows)
    segment space -> lane un-permutation of the light part, lane fold
    and merge of the heavy segments' light tiles -> kernel D adds the
    heavy subwindow tiles into y -> residue add."""
    s = sr.get(semiring)
    _, axis_reduce = sr.kernel_ops(semiring)
    nblk = plan.num_blocks
    nheavy = plan.num_heavy
    rows = plan.shape[0]
    light = placed(plan.light, "the light records of the chunk route")
    xf = sr.as_x(x, light.vals.dtype)
    y2d = light_kernel(light, xf, semiring=semiring)
    y = unpermute_plan_rows(y2d[:nblk], plan.perm_idx).reshape(-1)[:rows]
    if nheavy:
        yh = sr.narrow(axis_reduce(sr.widen(y2d[nblk:], semiring), 1),
                       y2d.dtype)                  # (nheavy,)
        yh = s.segment_reduce(yh, plan.heavy_rows,
                              num_segments=rows + 1)[:rows]
        y = s.combine(y, yh)                       # a new y: D adds in place
        if plan.heavy is not None:
            y = heavy_kernel(plan.heavy, xf, y, semiring=semiring)
    if isinstance(plan.residue, CooTail):
        y = s.combine(y, _spmv_coo(plan.residue, x, semiring))
    elif isinstance(plan.residue, PackedPlan):
        y = s.combine(y, spmv_packed(plan.residue, x, semiring=semiring))
    return y
