"""SELL window SpMV and the plan dispatch (counterpart of
``spmv_vector_cache_tpu/ops/spmv_pallas.py``).

:func:`sell_window_kernel` wraps kernel B (``csrc/spmv_sell_window.cu``),
which replaces the reference's window kernel; :func:`sell_global_kernel`
wraps kernel G (``csrc/spmv_sell_global.cu``), which replaces its
resident, deep and stream kernels and their slice reduction: G sums each
slice's tiles itself (the placed plan's work list, ``formats/tables.py``)
and writes y's rows, or the slice sums of a general ``row_map`` plan.
:func:`sell_window_plain` and :func:`sell_global_plain` are their plain
PyTorch versions.  A double
plan (``value_dtype=np.float64``: (T, 2P, R) hi/lo float32 values) runs
:func:`spmv_sell_double` or the pair API :func:`spmv_sell_double_pair`:
its window strategy on kernel K (:func:`sell_window_f64_kernel`), every
other strategy on kernel L (:func:`sell_global_f64_kernel`), the float64
builds of B and G, which replace the reference's double-float window
and stream kernels (L, like G, sums each slice itself).  The epilogues —
the slice reduction after kernels B and K, the sub-row fixup, the Hybrid
and CachedPlan joins and the COO tail — are torch ops,
as the reference computes them in XLA outside Pallas; over a double
plan's float64 partials they are plain float64 sums, where the
reference needs compensated pair additions over dense fold matrices.
B and G have a build for each value type of ``ops/semiring.py``'s
policy (bfloat16 and float16 summed in float32; the integers summed
exactly, the 8- and 16-bit ones in int32, under plus_times, max_times
and or_and), and the epilogues run in the same types; :func:`spmv_plan`
narrows a narrow plan's y once, at the end.
:func:`spmv_plan` dispatches every plan type, ChunkPlan
(``ops/spmv_chunk.py``) and PackedPlan (``ops/spmv_packed.py``)
included.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import numpy as np
import torch

from ..formats.cached import CachedPlan, CooTail
from ..formats.chunk import ChunkPlan
from ..formats.dia import DiaPlan, HybridPlan
from ..formats.packed import PackedPlan
from ..formats.plan import DEEP_MAX_BLOCKS, RESIDENT_MAX_BLOCKS, SellPlan
from ..formats.plan import TILES_PER_STEP
from ..formats.tables import placed
from ..utils import platform
from . import _kernels, df64
from . import semiring as sr
from .spmv_dia import spmv_dia, spmv_dia_double
from .spmv_packed import spmv_packed

# ---------------------------------------------------------------------------
# epilogues
# ---------------------------------------------------------------------------

def fold_lanes(y2d: torch.Tensor, parts: int, rows: int,
               semiring: str = "plus_times") -> torch.Tensor:
    """(num_slices, R[, k]) slice sums -> the first ``rows`` rows of y
    (Y), where part j of row r of a slice sits at lane j*rps + r%rps
    (rps = R / parts): the uniform-parts lane fold, and at ``parts`` = 1
    the identity map."""
    tail = tuple(y2d.shape[2:])
    rps = y2d.shape[1] // parts
    acc = y2d[:, :rps]
    s = sr.get(semiring)
    for j in range(1, parts):
        acc = s.combine(acc, y2d[:, j * rps:(j + 1) * rps])
    return acc.reshape((-1,) + tail)[:rows]


def _fixup_rows(plan: SellPlan, y2d: torch.Tensor,
                semiring: str) -> torch.Tensor:
    """(num_slices, R) slice sums -> y: identity slice, uniform-parts
    lane fold, or the general row_map segment reduce.  A trailing RHS
    axis, (num_slices, R, k) -> Y (rows, k), rides along (SpMM)."""
    rows = plan.shape[0]
    tail = tuple(y2d.shape[2:])
    if plan.identity_map:
        return y2d.reshape((-1,) + tail)[:rows]
    p = plan.stats.uniform_parts
    if p:
        return fold_lanes(y2d, p, rows, semiring)
    s = sr.get(semiring)
    y = s.segment_reduce(y2d.reshape((-1,) + tail), plan.row_map,
                         num_segments=rows + 1)
    return y[:rows]


def _reduce_partials(plan: SellPlan, partials: torch.Tensor,
                     semiring: str = "plus_times",
                     per_group: bool = False) -> torch.Tensor:
    """Kernel B's or K's output -> y (kernels G, H and L sum each
    slice's tiles themselves).  ``partials`` holds per-tile rows
    (T, R), or per-group rows (ngroups, R) when the kernel folded slices
    (``per_group``); both reduce to y2d, then the sub-row fixup runs.
    SpMM partials carry a trailing RHS axis, (T or ngroups, R, k), and
    reduce to Y (rows, k) the same way."""
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
    """Plain PyTorch version of kernel B (same inputs, same output).  An
    x with a trailing RHS axis, B of shape (cols, k), gives partials with
    that axis: kernel H's plain version (``ops/spmm_sell.py``).  The
    sums in :func:`~.semiring.widen`'s types, the partials in x's."""
    mul, axis_reduce = sr.kernel_ops(semiring, vals.dtype)
    out_dtype = x.dtype
    vals, x = sr.widen(vals, semiring), sr.widen(x, semiring)
    T, P, R = vals.shape
    cols, tail = x.shape[0], tuple(x.shape[1:])
    base = window_base.long().repeat_interleave(group_tiles) * window_grain
    c = (base[:, None, None] + cols_win.long()).clamp_(max=cols)
    xz = torch.cat([x, x.new_zeros((1,) + tail)])      # c >= cols reads 0
    prod = mul(vals.reshape(vals.shape + (1,) * len(tail)), xz[c])
    if fold:
        prod = prod.reshape((T // group_tiles, group_tiles * P, R) + tail)
    return sr.narrow(axis_reduce(prod, 1), out_dtype)


def _check_slab(vals, idx, x, name: str, double: bool) -> None:
    """``vals`` (T, P, R) of a value type of ``_kernels.BUILDS``, x of
    their sum type (:func:`~.semiring.x_dtype`), and the index array ``idx``
    (T, P, R); a double slab holds float32 hi and lo halves, (T, 2P, R),
    beside a (T, P, R) index array and a float64 x."""
    channels = 2 if double else 1
    if vals.dim() != 3 or idx.dim() != 3 or tuple(vals.shape) != (
            idx.shape[0], channels * idx.shape[1], idx.shape[2]):
        raise ValueError(f"vals {tuple(vals.shape)} and {name} "
                         f"{tuple(idx.shape)} must be equal (T, P, R)"
                         f"{'; double vals are (T, 2P, R)' if double else ''}")
    if double:
        ok = vals.dtype == torch.float32 and x.dtype == torch.float64
    else:
        ok = vals.dtype in _kernels.BUILDS and \
            x.dtype == sr.x_dtype(vals.dtype)
    if not ok:
        raise NotImplementedError(
            f"SELL SpMV runs float32, bfloat16, float16 and 8-, 16- and "
            f"32-bit integer values with an x of their sum type, or a double "
            f"plan's pairs with a float64 x (vals {vals.dtype}, x "
            f"{x.dtype})")


def _check_window(vals, cols_win, window_base, x, group_tiles,
                  double=False):
    _check_slab(vals, cols_win, x, "cols_win", double)
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


#: kernel B's launch: 4 lanes a thread (one vector load of slots a
#: position: 4 B of 1-byte slots, 16 B of 4-byte ones) and 4 output rows
#: a CTA of 128 threads, at every value width: within a few per cent of
#: the fastest shape on every window plan ``probes_torch/window_shapes.py``
#: times, on an H100; mirrored by ``csrc/spmv_sell_window.cu``
#: (``SPMV_WINDOW_LANES``)
WINDOW_LANES = 4
WINDOW_ROWS_PER_CTA = 4


@dataclasses.dataclass(frozen=True)
class WindowShape:
    """Kernel B's launch: ``lanes_per_thread`` consecutive lanes of an
    output row (a tile, or a group when folding) a thread,
    ``rows_per_cta`` output rows a CTA of ``threads``, ``ctas`` CTAs."""
    lanes_per_thread: int
    rows_per_cta: int
    threads: int
    ctas: int


@functools.lru_cache(maxsize=256)
def window_launch_shape(out_rows: int, lanes: int) -> WindowShape:
    """Kernel B's launch for ``out_rows`` output rows of ``lanes`` lanes,
    the same at every value width: :data:`WINDOW_LANES` lanes a thread,
    :data:`WINDOW_ROWS_PER_CTA` output rows a CTA."""
    n = WINDOW_ROWS_PER_CTA
    return WindowShape(WINDOW_LANES, n, n * lanes // WINDOW_LANES,
                       -(-out_rows // n))


def kernel_window_shape(vals, group_tiles: int, fold: bool) -> WindowShape:
    """The launch shape kernel B takes for the slab ``vals`` (T, P, R)."""
    T, _, R = vals.shape
    return window_launch_shape(T // group_tiles if fold else T, R)


def sell_window_kernel(vals, cols_win, window_base, x, *, group_tiles: int,
                       window_grain: int, fold: bool, semiring: str,
                       shape: WindowShape | None = None) -> torch.Tensor:
    """Kernel B on CUDA tensors; the plain version on CPU tensors.
    ``shape``: the launch (:class:`WindowShape`), else
    :func:`kernel_window_shape`'s."""
    _check_window(vals, cols_win, window_base, x, group_tiles)
    sr.check_integer(semiring, vals.dtype)
    if not platform.is_cuda(x):
        return sell_window_plain(vals, cols_win, window_base, x,
                                 group_tiles=group_tiles,
                                 window_grain=window_grain, fold=fold,
                                 semiring=semiring)
    T, P, R = vals.shape
    shape = shape or kernel_window_shape(vals, group_tiles, fold)
    if vals.data_ptr() % min(16, shape.lanes_per_thread
                             * vals.element_size()) or \
            cols_win.data_ptr() % min(16, 2 * shape.lanes_per_thread):
        raise ValueError(f"kernel B reads {shape.lanes_per_thread} lanes "
                         f"of vals and cols_win at a time: both must be "
                         f"aligned to that")
    out_rows = T // group_tiles if fold else T
    out = torch.empty((out_rows, R), dtype=x.dtype, device=x.device)
    _kernels.launch(
        _kernels.entry("spmv_sell_window_f32", vals.dtype), x.get_device(),
        vals.data_ptr(),
        cols_win.data_ptr(), window_base.data_ptr(), x.data_ptr(),
        out.data_ptr(), out_rows, P, R, group_tiles, int(fold), window_grain,
        x.shape[0], sr.KERNEL_CODE[semiring], shape.lanes_per_thread,
        shape.rows_per_cta)
    return out


def sell_window_f64_plain(vals, cols_win, window_base, x, *,
                          group_tiles: int, window_grain: int,
                          fold: bool) -> torch.Tensor:
    """Plain PyTorch version of kernel K: the hi/lo slab joined into
    float64 values, then kernel B's plain version under plus_times."""
    return sell_window_plain(df64.join_channels(vals), cols_win, window_base,
                             x, group_tiles=group_tiles,
                             window_grain=window_grain, fold=fold,
                             semiring="plus_times")


def sell_window_f64_kernel(vals, cols_win, window_base, x, *,
                           group_tiles: int, window_grain: int,
                           fold: bool) -> torch.Tensor:
    """Kernel K on CUDA tensors; the plain version on CPU tensors.
    ``vals``: a double plan's (T, 2P, R) float32 hi/lo slab; ``x`` and
    the partials, (T or T/wg, R): float64."""
    _check_window(vals, cols_win, window_base, x, group_tiles, double=True)
    if not platform.is_cuda(x):
        return sell_window_f64_plain(vals, cols_win, window_base, x,
                                     group_tiles=group_tiles,
                                     window_grain=window_grain, fold=fold)
    T, P2, R = vals.shape
    out_rows = T // group_tiles if fold else T
    out = torch.empty((out_rows, R), dtype=torch.float64, device=x.device)
    _kernels.launch(
        "spmv_sell_window_f64", x.get_device(), vals.data_ptr(),
        cols_win.data_ptr(), window_base.data_ptr(), x.data_ptr(),
        out.data_ptr(), out_rows, P2 // 2, R, group_tiles, int(fold),
        window_grain, x.shape[0])
    return out


def folds_groups(plan: SellPlan) -> bool:
    """Whether the window and resident routes fold each group's slices
    into one output row: the plan asks for it and a grid step holds a
    multiple of 8 groups (the reference's rule)."""
    st = plan.stats
    NG = TILES_PER_STEP * st.groups_per_step // st.group_tiles
    return st.group_fold and NG % 8 == 0


def _require_window(plan: SellPlan) -> None:
    if plan.stats.window_blocks <= 0:
        raise ValueError(
            "window strategy infeasible for this plan "
            "(stats.window_blocks == 0); rebuild with stripe_width")


def _window_partials(plan: SellPlan, x: torch.Tensor, semiring: str):
    """Run the window kernel, returning (per-tile or per-group partial
    rows, fold) before any slice/row reduction."""
    _require_window(plan)
    st = plan.stats
    fold = folds_groups(plan)
    out = sell_window_kernel(
        plan.vals, plan.cols_win, plan.window_base,
        sr.as_x(x, plan.vals.dtype),
        group_tiles=st.group_tiles,
        window_grain=st.window_grain, fold=fold, semiring=semiring)
    return out, fold


def _spmv_window(plan: SellPlan, x: torch.Tensor,
                 semiring: str = "plus_times") -> torch.Tensor:
    out, fold = _window_partials(plan, x, semiring)
    return _reduce_partials(plan, out, semiring, per_group=fold)


# ---------------------------------------------------------------------------
# resident, deep and stream strategies: kernel G
# ---------------------------------------------------------------------------

def row_parts(plan: SellPlan) -> int:
    """What kernels G and H write for ``plan``: y's (Y's) rows through the
    lane fold of ``parts`` sub-rows (1 for the identity map, p for a
    uniform-parts plan), or, at 0, the slice sums for the ``row_map``
    reduce of :func:`_fixup_rows`."""
    return 1 if plan.identity_map else plan.stats.uniform_parts


def _tile_sums(vals, cols, x, semiring: str) -> torch.Tensor:
    """(T, R) per-tile sums (+)_p vals (x) x[cols], in
    :func:`~.semiring.widen`'s types; a column past x reads as 0."""
    mul, axis_reduce = sr.kernel_ops(semiring, vals.dtype)
    vals, x = sr.widen(vals, semiring), sr.widen(x, semiring)
    n = x.shape[0]
    c = cols.long()
    c = torch.where((c >= 0) & (c < n), c, n)  # out of range reads 0
    return axis_reduce(mul(vals, torch.cat([x, x.new_zeros(1)])[c]), 1)


def sell_global_plain(vals, cols, tile_slice, x, *, num_slices: int,
                      parts: int, rows: int, semiring: str) -> torch.Tensor:
    """Plain PyTorch version of kernel G (same inputs, same output): the
    per-tile sums, their semiring reduce over ``tile_slice`` to
    (num_slices, R) slice sums, then, for ``parts`` >= 1, the lane fold
    to y's ``rows`` rows."""
    y2d = sr.get(semiring).segment_reduce(
        sr.narrow(_tile_sums(vals, cols, x, semiring), x.dtype), tile_slice,
        num_segments=num_slices)
    return fold_lanes(y2d, parts, rows, semiring) if parts else y2d


def _check_global(vals, cols, x, double=False):
    _check_slab(vals, cols, x, "cols", double)
    if cols.dtype != torch.int32:
        raise ValueError(f"cols must be int32, got {cols.dtype}")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    for t in (cols, x):
        if t.device != vals.device:
            raise ValueError(f"operands on {vals.device} and {t.device}")
    if not all(t.is_contiguous() for t in (vals, cols, x)):
        raise ValueError("global-column operands must be contiguous")


def _check_slices(tile_slice, T, device, num_slices, parts, rows, R):
    """Kernels G and L: one int32 slice per tile, and a fold that
    covers ``rows``."""
    if tile_slice.dtype != torch.int32 or tile_slice.shape != (T,) or \
            tile_slice.device != device or num_slices < 1:
        raise ValueError("tile_slice must hold one int32 slice per tile, on "
                         "the plan's device")
    if parts < 0 or (parts and R % parts):
        raise ValueError(f"parts={parts} must divide the {R} lanes")
    if parts and rows > num_slices * (R // parts):
        raise ValueError(f"{num_slices} slices do not cover {rows} rows")


def _launch_global(entry, vals, cols, tile_slice, work, x, positions,
                   num_slices, parts, rows, semiring, *code):
    """Launch kernel G or L (C entry point ``entry``, then ``code``) on
    the work list of ``tile_slice`` (a placed plan's ``work``); their
    output, in x's type, starts as the semiring's init where split slices
    combine into it."""
    work = placed(work, "the work list of kernels G and L")
    R = vals.shape[2]
    shape = (rows,) if parts else (num_slices, R)
    out = torch.full(shape, sr.init_value(semiring, x.dtype),
                     dtype=x.dtype, device=x.device) if work.split else \
        torch.empty(shape, dtype=x.dtype, device=x.device)
    _kernels.launch(
        entry, x.get_device(), vals.data_ptr(), cols.data_ptr(),
        tile_slice.data_ptr(), work.runs.data_ptr(), x.data_ptr(),
        out.data_ptr(), work.runs.shape[0], positions, R, x.shape[0], parts,
        rows, work.max_tiles, work.max_slices, *code)
    return out


def sell_global_kernel(vals, cols, tile_slice, x, *, num_slices: int,
                       parts: int, rows: int, semiring: str,
                       work=None) -> torch.Tensor:
    """Kernel G on CUDA tensors; the plain version on CPU tensors.

    ``vals``/``cols``: (T, P, R) float32 / int32 global column ids;
    ``tile_slice`` (T,) int32 nondecreasing.  Returns y's first ``rows``
    rows for ``parts`` >= 1 (see :func:`row_parts`), else the
    (num_slices, R) slice sums.  On the card ``work`` is the work list of
    ``tile_slice`` (a placed plan's ``work``); x is gathered through L1
    and L2."""
    _check_global(vals, cols, x)
    sr.check_integer(semiring, vals.dtype)
    T, P, R = vals.shape
    _check_slices(tile_slice, T, vals.device, num_slices, parts, rows, R)
    if not platform.is_cuda(x):
        return sell_global_plain(vals, cols, tile_slice, x,
                                 num_slices=num_slices, parts=parts,
                                 rows=rows, semiring=semiring)
    out = _launch_global(_kernels.entry("spmv_sell_global_f32", vals.dtype),
                         vals, cols, tile_slice, work, x,
                         P, num_slices, parts, rows, semiring,
                         sr.KERNEL_CODE[semiring])
    return out


def sell_global_f64_plain(vals, cols, tile_slice, x, *, num_slices: int,
                          parts: int, rows: int) -> torch.Tensor:
    """Plain PyTorch version of kernel L (same inputs, same output): the
    hi/lo slab joined into float64 values, then kernel G's plain version
    under plus_times (per-tile sums, slice sums, lane fold)."""
    return sell_global_plain(df64.join_channels(vals), cols, tile_slice, x,
                             num_slices=num_slices, parts=parts, rows=rows,
                             semiring="plus_times")


def sell_global_f64_kernel(vals, cols, tile_slice, x, *, num_slices: int,
                           parts: int, rows: int,
                           work=None) -> torch.Tensor:
    """Kernel L on CUDA tensors; the plain version on CPU tensors.
    ``vals``: a double plan's (T, 2P, R) float32 hi/lo slab; ``cols``:
    (T, P, R) int32; ``x`` and the output: float64.  As kernel G
    (:func:`sell_global_kernel`), plus_times: y's first ``rows`` rows for
    ``parts`` >= 1, else the (num_slices, R) slice sums; on the card
    ``work`` is the work list of ``tile_slice``."""
    _check_global(vals, cols, x, double=True)
    T, P2, R = vals.shape
    _check_slices(tile_slice, T, vals.device, num_slices, parts, rows, R)
    if not platform.is_cuda(x):
        return sell_global_f64_plain(vals, cols, tile_slice, x,
                                     num_slices=num_slices, parts=parts,
                                     rows=rows)
    out = _launch_global("spmv_sell_global_f64", vals, cols, tile_slice,
                         work, x, P2 // 2, num_slices, parts, rows,
                         "plus_times")
    return out


def _x_blocks(plan: SellPlan) -> int:
    return -(-plan.shape[1] // 128)


#: the reference's x-width cap of each kernel-G route, in 128-lane blocks,
#: with its advice; v5e limits, kept only for parity (stream has none)
_GLOBAL_CAPS = {
    "resident": ("RESIDENT_MAX_BLOCKS", RESIDENT_MAX_BLOCKS,
                 "the resident strategy's per-block select chain would "
                 "dominate — use 'stream' or restructure"),
    "deep": ("DEEP_MAX_BLOCKS", DEEP_MAX_BLOCKS,
             "build a CachedPlan (hot/cold column split) for matrices this "
             "wide with no locality"),
}


def _spmv_global(plan: SellPlan, x: torch.Tensor, semiring: str,
                 strategy: str) -> torch.Tensor:
    """The reference's resident, deep and stream routes, all on kernel
    G, which sums each slice's tiles and writes y's rows itself (identity
    map, uniform parts); only a general ``row_map`` plan takes the
    segment reduce of :func:`_fixup_rows` after it.  Every route gathers
    x through L1 and L2 (a copy of x per CTA and a cluster's distributed
    shared memory both lost on the H100, PERF.md): stream builds no
    pre-gathered x."""
    if strategy in _GLOBAL_CAPS:
        name, cap, advice = _GLOBAL_CAPS[strategy]
        NB = _x_blocks(plan)
        if NB > cap:
            raise ValueError(f"x spans {NB} 128-lane blocks > {name} "
                             f"({cap}); {advice}")
    parts = row_parts(plan)
    out = sell_global_kernel(plan.vals, plan.cols, plan.tile_slice,
                             sr.as_x(x, plan.vals.dtype),
                             num_slices=plan.num_slices, parts=parts,
                             rows=plan.shape[0], semiring=semiring,
                             work=plan.work)
    return out if parts else _fixup_rows(plan, out, semiring)


def warn_stream(plan) -> None:
    """Never let the 'stream' route be picked silently: it serves a plan
    wider than DEEP_MAX_BLOCKS blocks with no column locality and no
    popularity split, where every x read is a random device-memory
    access."""
    warnings.warn(
        f"SpMV falling back to the 'stream' strategy for a "
        f"{plan.shape[0]}x{plan.shape[1]} matrix: no window, cache tier or "
        f"packed plan was built, so every x read lands at a random column "
        f"(the global-column kernel that 'stream' shares with 'deep' "
        f"reached about a third of its bytes bound on uniform columns on "
        f"an H100, PERF.md).  Build the plan with auto_plan (CachedPlan "
        f"hot/cold split) or restructure.",
        RuntimeWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# double plans: kernels K and L
# ---------------------------------------------------------------------------

def spmv_sell_double(plan: SellPlan, x: torch.Tensor, *,
                     strategy: str = "auto") -> torch.Tensor:
    """``y = A @ x`` from a double SellPlan on ``x.device``: float64 x (a
    float32 x is widened exactly) in, float64 y out.

    'window' runs kernel K, folding groups where kernel B would;
    'stream', and the 'resident' and 'deep' that the operator's
    ``select_strategy`` gives a windowless plan, run kernel L, which
    reads x at any width and writes y's rows (a general ``row_map``
    plan: its slice sums, then the row_map reduce); 'auto' is window when
    feasible, else stream.
    The reference knows only 'window' and 'stream' here and raises on
    the others."""
    st = plan.stats
    if not st.double:
        raise ValueError("plan was not built with value_dtype=np.float64")
    x = x.to(torch.float64).contiguous()
    if strategy == "auto":
        strategy = "window" if st.window_blocks > 0 else "stream"
    if strategy == "window":
        _require_window(plan)
        fold = folds_groups(plan)
        out = sell_window_f64_kernel(
            plan.vals, plan.cols_win, plan.window_base, x,
            group_tiles=st.group_tiles, window_grain=st.window_grain,
            fold=fold)
        return _reduce_partials(plan, out, per_group=fold)
    if strategy in ("resident", "deep", "stream"):
        parts = row_parts(plan)
        out = sell_global_f64_kernel(plan.vals, plan.cols, plan.tile_slice,
                                     x, num_slices=plan.num_slices,
                                     parts=parts, rows=plan.shape[0],
                                     work=plan.work)
        return out if parts else _fixup_rows(plan, out, "plus_times")
    raise ValueError(f"unknown strategy {strategy!r}")


def spmv_sell_double_pair(plan: SellPlan, xh: torch.Tensor,
                          xl: torch.Tensor, *,
                          strategy: str = "auto") -> tuple:
    """The reference's pair API: (xh, xl) float32 in, (yh, yl) float32
    out on ``xh.device``, with ``yh + yl`` the float64 y.  A shim over
    :func:`spmv_sell_double`: the pair is joined into one float64 x and
    y split again, all on the device."""
    return df64.split(spmv_sell_double(plan, df64.join(xh, xl),
                                       strategy=strategy))


def _spmv_coo(plan: CooTail, x: torch.Tensor, semiring: str) -> torch.Tensor:
    """COO tail: element gather + segment reduce (torch ops, as the
    reference runs it in XLA), in x's type as the reference computes it
    (the values cast to it); an integer or narrow plan's x first as its
    kernels read it (:func:`~.semiring.as_x`)."""
    s = sr.get(semiring)
    mul, _ = sr.kernel_ops(semiring, plan.vals.dtype)
    sr.check_integer(semiring, plan.vals.dtype)
    if plan.vals.dtype in sr.NARROW or not plan.vals.dtype.is_floating_point:
        x = sr.as_x(x, plan.vals.dtype)
    prod = mul(sr.widen(plan.vals.to(x.dtype), semiring),
               sr.widen(x, semiring)[plan.cols.long()])
    rows = plan.shape[0]
    y = s.segment_reduce(sr.narrow(prod, x.dtype), plan.rows_idx,
                         num_segments=rows + 1)
    return y[:rows]


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def plan_vals_dtype(plan) -> torch.dtype:
    """The torch type of ``plan``'s value slab (a double plan's is its
    float32 pairs'; a host plan's numpy slab read as torch's)."""
    if isinstance(plan, HybridPlan):
        return plan_vals_dtype(plan.dia)
    if isinstance(plan, CachedPlan):       # its hot tier may be any plan
        return plan_vals_dtype(plan.hot)
    if isinstance(plan, ChunkPlan):
        parts = (*plan.buckets, *plan.hbuckets, plan.residue)
        part = next((p for p in parts if p is not None), None)
        if part is None:
            raise ValueError("the ChunkPlan has no bucket and no residue: "
                             "it holds no values")
        return plan_vals_dtype(part)
    vals = plan.vals
    if not isinstance(vals, torch.Tensor):
        vals = torch.from_numpy(np.asarray(vals).reshape(-1)[:0])
    return vals.dtype


def _double(plan) -> bool:
    if isinstance(plan, HybridPlan):
        plan = plan.dia
    return (isinstance(plan, DiaPlan) and plan.double) or (
        isinstance(plan, SellPlan) and plan.stats.double)


def plan_x_dtype(plan) -> torch.dtype:
    """The type an apply of ``plan`` sums in, and its kernels read x (B)
    in: float64 for a double plan, float32 for a float32, bfloat16 or
    float16 plan, int32 for an int8, uint8, int16 or uint16 plan, the
    value type of any other integer plan."""
    if _double(plan):
        return torch.float64
    return sr.x_dtype(plan_vals_dtype(plan))


def plan_as_x(plan, x: torch.Tensor) -> torch.Tensor:
    """x (or B) as ``plan``'s kernels read it: float64 for a double
    plan, else :func:`~.semiring.as_x` (a narrow plan's x rounded or
    wrapped to its value type first)."""
    if _double(plan):
        return x.to(torch.float64).contiguous()
    return sr.as_x(x, plan_vals_dtype(plan))


def check_x_length(x, cols: int) -> None:
    """Raise ``ValueError`` unless x (a tensor or an array) is 1-D with
    the plan's ``cols`` entries.  The reference raises too, when it
    writes x into its padded x image; its CachedPlan and CooTail, whose
    gathers clamp, return a y instead (ROADMAP.md queue 3)."""
    shape = tuple(np.shape(x))
    if shape != (cols,):
        raise ValueError(f"x has shape {shape}; the plan has {cols} "
                         f"columns")


def spmv_plan(plan, x: torch.Tensor, *, strategy: str = "auto",
              semiring: str = "plus_times") -> torch.Tensor:
    """Run SpMV ``y = A (+).(x) x`` from a prebuilt plan on ``x.device``.

    Dispatches on plan type: DiaPlan runs kernel A, HybridPlan adds its
    residual pass, a SellPlan runs the 'window' strategy on kernel B or
    the 'resident', 'deep' and 'stream' strategies on kernel G (a double
    plan's DIA part runs kernel J and its SELL plans kernels K and L,
    float64 y from any x, plus_times only), a
    CachedPlan its hot tier on ``x[hot_cols]`` and its cold part on x, a
    ChunkPlan the chunk light route and kernels C and D, a PackedPlan
    kernels E and F, a CooTail
    the gather + segment reduce.  DIA and packed plans support
    plus_times only; SELL and chunk plans must have been built with
    ``pad_value`` = the semiring's zero (``auto_plan(semiring=...)``
    does this).  x must have the plan's column count (``ValueError``).
    y comes back in :func:`~.semiring.y_dtype`: a narrow plan (float16,
    int8, uint8, int16, uint16) sums in 32 bits and narrows y once, here.
    """
    semiring = sr.get(semiring).name
    check_x_length(x, plan.shape[1])
    return sr.finish_y(_spmv_sums(plan, x, strategy, semiring),
                       plan_vals_dtype(plan), semiring)


def _spmv_sums(plan, x: torch.Tensor, strategy: str,
               semiring: str) -> torch.Tensor:
    """:func:`spmv_plan`'s dispatch, y in the plan's sum type
    (:func:`plan_x_dtype`)."""
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
    if isinstance(plan, CachedPlan):
        if strategy not in ("auto", "cached"):
            raise ValueError(f"CachedPlan supports only the 'cached' "
                             f"strategy, got {strategy!r}")
        # each nonzero lives in exactly one part, so the join is one
        # semiring add
        s = sr.get(semiring)
        y = _spmv_sums(plan.hot, sr.take(x, plan.hot_cols), "auto",
                       semiring)
        if plan.cold is not None:
            y = s.combine(y, _spmv_sums(plan.cold, x, "auto", semiring))
        return y
    if isinstance(plan, (DiaPlan, HybridPlan)) and semiring != "plus_times":
        raise ValueError("DIA plans encode absence as 0 and support only "
                         "plus_times; build a SELL plan via "
                         "auto_plan(semiring=...)")
    if isinstance(plan, DiaPlan):
        if strategy not in ("auto", "dia"):
            raise ValueError(f"DiaPlan supports only the 'dia' strategy, "
                             f"got {strategy!r}")
        return spmv_dia_double(plan, x) if plan.double else \
            spmv_dia(plan, x)
    if isinstance(plan, HybridPlan):
        # 'dia' (what select_strategy gives a HybridPlan) names the DIA
        # part; the residual then picks its own strategy.  The reference
        # passes 'dia' on to a SELL residual, which rejects it.
        rest_strategy = "auto" if strategy == "dia" else strategy
        dia = spmv_dia_double if plan.dia.double else spmv_dia
        return sr.PLUS_TIMES.combine(
            dia(plan.dia, x), _spmv_sums(plan.rest, x, rest_strategy,
                                         semiring))
    if not isinstance(plan, SellPlan):
        raise NotImplementedError(f"{type(plan).__name__}: the port runs "
                                  f"no such plan")
    if plan.stats.double:
        if semiring != "plus_times":
            raise ValueError(
                f"double-float plans run plus_times only (as in the "
                f"reference); got {semiring!r}")
        return spmv_sell_double(plan, x, strategy=strategy)
    if strategy == "auto":
        nb = _x_blocks(plan)
        if plan.stats.window_blocks > 0:
            strategy = "window"
        elif nb <= RESIDENT_MAX_BLOCKS:
            strategy = "resident"
        elif nb <= DEEP_MAX_BLOCKS:
            strategy = "deep"
        else:
            warn_stream(plan)
            strategy = "stream"
    if strategy == "window":
        return _spmv_window(plan, x, semiring)
    if strategy in ("resident", "deep", "stream"):
        return _spmv_global(plan, x, semiring, strategy)
    raise ValueError(f"unknown strategy {strategy!r}")
