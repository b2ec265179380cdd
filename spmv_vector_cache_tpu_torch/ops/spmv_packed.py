"""Packed two-pass SpMV (counterpart of
``spmv_vector_cache_tpu/ops/spmv_packed.py``).

:func:`packed_scan_kernel` wraps kernel E (pass A: gather, multiply,
segmented scan along each 128-slot row) and :func:`packed_rows_kernel`
kernel F (pass B: sum each row of y from a list of what it sums, its
pieces' sums, read at their end slots of the scan, then its overflow
products), both in ``csrc/spmv_packed.cu``; beside each is its plain
PyTorch version.  So the apply is kernel E then kernel F: F also does
what the reference computes in XLA after its extract kernel (the window
mask, the overflow COO), from the list that placement compacts from the
plan's dense extraction index (the plan's ``tables``,
``formats/tables.py``).  :func:`packed_extract_kernel` is F over
whole windows with no overflow, the reference's extract kernel alone.
See ``formats/packed.py`` for the layout.

Kernel E's launch shape (slots a thread, threads a CTA) comes from
:func:`scan_launch_shape`, kept per shape; an int8, uint8, int16 or
uint16 plan's scan is written in its value type (:func:`scan_dtype`),
which F reads widened.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..formats.packed import PACKED_WINDOW_BLOCKS, PackedPlan
from ..formats.tables import (ExtractTables, compact_tables, piece_slots,
                              placed)
from ..utils import platform
from . import _kernels
from . import semiring as sr


def _check_same_device(ref, *ts):
    dev = ref.get_device()          # an int: no torch.device object a call
    for t in (ref, *ts):
        if t.get_device() != dev:
            raise ValueError(f"operands on {ref.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("packed operands must be contiguous")


# ---------------------------------------------------------------------------
# pass A: kernel E
# ---------------------------------------------------------------------------

#: the value types whose scan kernel E writes in the value type itself:
#: a piece sum narrowed to 8 or 16 bits is all of it that y keeps (F's
#: wrapping sums, narrowed once by ``finish_y``, commute with narrowing),
#: and it is the reference's own scan type (``_compute_dtype``)
NARROW_SCAN = (torch.int8, torch.uint8, torch.int16, torch.uint16)

#: kernel E's launch: 8 slots a thread (16 threads a row, two rows a
#: warp) and 512 threads a CTA (32 rows, four tiles), the fastest shape
#: of every build on both PackedPlans ``probes_torch/scan_shapes.py``
#: times, on an H100; mirrored by ``csrc/spmv_packed.cu``
SCAN_SLOTS = 8
SCAN_THREADS = 512


def scan_dtype(vals_dtype: torch.dtype) -> torch.dtype:
    """The type of the scan S of a plan with ``vals_dtype`` values: the
    value type for :data:`NARROW_SCAN`, else the sum type
    (:func:`~.semiring.x_dtype`)."""
    return vals_dtype if vals_dtype in NARROW_SCAN else sr.x_dtype(
        vals_dtype)


@dataclasses.dataclass(frozen=True)
class ScanShape:
    """Kernel E's launch: ``slots_per_thread`` consecutive slots of a
    128-slot row a thread (128 / it threads a row), ``threads`` a CTA,
    ``ctas`` CTAs."""
    slots_per_thread: int
    threads: int
    ctas: int


@functools.lru_cache(maxsize=256)
def scan_launch_shape(rows: int) -> ScanShape:
    """Kernel E's launch for ``rows`` 128-slot rows, the same at every
    value width: :data:`SCAN_SLOTS` a thread, :data:`SCAN_THREADS` a
    CTA."""
    return ScanShape(SCAN_SLOTS, SCAN_THREADS,
                     -(-rows * 128 // (SCAN_THREADS * SCAN_SLOTS)))


def packed_scan_plain(vals, cols, cstep, x, *, chunk_blocks: int,
                      step_tiles: int) -> torch.Tensor:
    """Plain PyTorch version of kernel E: the reference's Hillis-Steele
    segmented scan over lane shifts, in the reference's order, in
    :func:`~.semiring.widen`'s types; the scan in :func:`scan_dtype`."""
    out_dtype = scan_dtype(vals.dtype)
    vals, x = sr.widen(vals), sr.widen(x)
    T = vals.shape[0]
    N = T * 8
    craw = cols.reshape(N, 128).to(torch.int32)
    c = craw & 16383
    f = (craw >> 14) & 1
    chunk = cstep.long().repeat_interleave(step_tiles * 8)[:, None]
    g = (chunk * (chunk_blocks * 128) + c).clamp_(max=x.shape[0])
    xz = torch.cat([x, x.new_zeros(1)])        # past the last column: 0
    S = vals.reshape(N, 128) * xz[g]
    lane = torch.arange(128, device=vals.device)
    zero = S.new_zeros(())
    for d in (1, 2, 4, 8, 16, 32, 64):
        vs = torch.where(lane >= d, torch.roll(S, d, 1), zero)
        fs = torch.where(lane >= d, torch.roll(f, d, 1), 0)
        S = S + torch.where(f == 1, zero, vs)
        f = f | fs
    return sr.narrow(S.reshape(T, 8, 128), out_dtype)


def _check_scan(vals, cols, cstep, x, step_tiles):
    if vals.dim() != 3 or tuple(vals.shape[1:]) != (8, 128) or \
            cols.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols "
                         f"{tuple(cols.shape)} must be equal (T, 8, 128)")
    if vals.shape[0] != cstep.shape[0] * step_tiles:
        raise ValueError(f"{vals.shape[0]} tiles, but cstep has "
                         f"{cstep.shape[0]} steps of {step_tiles}")
    if vals.dtype not in _kernels.BUILDS or \
            x.dtype != sr.x_dtype(vals.dtype):
        raise NotImplementedError(
            f"packed SpMV runs float32, bfloat16, float16 and 8-, 16- and "
            f"32-bit integer values with an x of their sum type (vals "
            f"{vals.dtype}, x {x.dtype})")
    if cols.dtype != torch.int16 or cstep.dtype != torch.int32:
        raise ValueError("cols must be int16 and cstep int32")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    _check_same_device(vals, cols, cstep, x)
    if vals.data_ptr() % 16 or cols.data_ptr() % 16:
        raise ValueError("kernel E reads vals and cols up to 16 B at a "
                         "time: both must be aligned to 16 B")


def kernel_scan_shape(vals: torch.Tensor) -> ScanShape:
    """The launch shape kernel E takes for the slab ``vals`` (T, 8,
    128)."""
    return scan_launch_shape(vals.shape[0] * 8)


def packed_scan_kernel(vals, cols, cstep, x, *, chunk_blocks: int,
                       step_tiles: int,
                       shape: ScanShape | None = None) -> torch.Tensor:
    """Kernel E on CUDA tensors; the plain version on CPU tensors.
    Returns the scan S, (T, 8, 128) in :func:`scan_dtype`.  ``shape``:
    the launch (:class:`ScanShape`), else :func:`kernel_scan_shape`'s."""
    _check_scan(vals, cols, cstep, x, step_tiles)
    if not platform.is_cuda(x):
        return packed_scan_plain(vals, cols, cstep, x,
                                 chunk_blocks=chunk_blocks,
                                 step_tiles=step_tiles)
    shape = shape or kernel_scan_shape(vals)
    out = torch.empty(vals.shape, dtype=scan_dtype(vals.dtype),
                      device=x.device)
    _kernels.launch(
        _kernels.entry("packed_scan_f32", vals.dtype), x.get_device(),
        vals.data_ptr(), cols.data_ptr(),
        cstep.data_ptr(), x.data_ptr(), out.data_ptr(), vals.shape[0] * 8,
        step_tiles * 8, chunk_blocks * 128, x.shape[0],
        shape.slots_per_thread, shape.threads)
    return out


# ---------------------------------------------------------------------------
# pass B: kernel F
# ---------------------------------------------------------------------------

def packed_extract_plain(scan, sblock, wstep, esrc, *, num_windows: int,
                         step_tiles: int) -> torch.Tensor:
    """Plain PyTorch version of kernel F over whole windows, from the
    plan's dense ``esrc``: each visit's piece sums, added into their
    window in visit order; unvisited windows are 0.  The sums in the
    scan's sum type (a narrow scan widened)."""
    out_dtype = sr.x_dtype(scan.dtype)
    scan = sr.widen(scan)
    e = esrc.long()
    src = sblock.long()[:, None, None] * (step_tiles * 1024) + e.clamp(min=0)
    contrib = torch.where(e >= 0, scan.reshape(-1)[src], scan.new_zeros(()))
    out = scan.new_zeros((num_windows, PACKED_WINDOW_BLOCKS, 128))
    return sr.narrow(out.index_add_(0, wstep, contrib).reshape(-1, 128),
                     out_dtype)


def _check_extract(scan, sblock, wstep, esrc, num_windows):
    steps_b = sblock.shape[0]
    if tuple(esrc.shape) != (steps_b, PACKED_WINDOW_BLOCKS, 128):
        raise ValueError(f"esrc {tuple(esrc.shape)} must be (steps_b, 64, "
                         f"128) with steps_b = {steps_b} visits")
    if scan.dtype not in (torch.float32, torch.int32, torch.uint32,
                          *NARROW_SCAN):
        raise NotImplementedError(f"packed SpMV scans in float32, int32, "
                                  f"uint32 or a narrow integer type (scan "
                                  f"{scan.dtype})")
    if esrc.dtype != torch.int16 or sblock.dtype != torch.int32:
        raise ValueError("esrc must be int16 and sblock int32")
    if not 0 < num_windows < 65536:
        raise ValueError(f"num_windows {num_windows} out of [1, 65535]")
    if wstep.shape != sblock.shape or wstep.dtype != torch.int32:
        raise ValueError(f"wstep must be int32 of sblock's shape "
                         f"{tuple(sblock.shape)}")
    _check_same_device(scan, sblock, wstep, esrc)


def packed_rows_plain(scan, x, tables: ExtractTables, *,
                      rows: int) -> torch.Tensor:
    """Plain PyTorch version of kernel F: each row's entries of the
    compacted list added one after another in list order
    (``index_add_``), its pieces' sums in visit order, then its overflow
    products in the plan's order; y of length ``rows`` in x's type.
    (Kernel F adds the same terms in another fixed order: see
    ``csrc/spmv_packed.cu``.)"""
    scan_w, x_w = sr.widen(scan).reshape(-1), sr.widen(x)
    ent = tables.entries.long()
    piece = ent >= 0
    term = torch.empty(ent.shape, dtype=x_w.dtype, device=x.device)
    term[piece] = scan_w[ent[piece]].to(x_w.dtype)
    ov = -1 - ent[~piece]
    term[~piece] = sr.widen(tables.ov_vals)[ov] * \
        x_w[tables.ov_cols.long()[ov]]
    row = torch.repeat_interleave(
        torch.arange(rows, device=x.device),
        (tables.row_off[1:] - tables.row_off[:-1]).long())
    y = torch.zeros(rows, dtype=x_w.dtype, device=x.device)
    return sr.narrow(y.index_add_(0, row, term), x.dtype)


def _check_rows(scan, x, tables, rows):
    # extract_tables puts every table on one device, contiguous
    if tables.row_off.shape != (rows + 1,):
        raise ValueError(f"row_off {tuple(tables.row_off.shape)}: the "
                         f"tables are not those of a plan of {rows} rows")
    if scan.dtype not in (torch.float32, torch.int32, torch.uint32,
                          *NARROW_SCAN) or scan.numel() != tables.slots:
        raise ValueError(f"a scan of {scan.numel()} {scan.dtype} slots; the "
                         f"tables index a scan of {tables.slots}")
    if x.dim() != 1 or tables.ov_vals.dtype not in _kernels.BUILDS or \
            scan_dtype(tables.ov_vals.dtype) != scan.dtype or \
            sr.x_dtype(tables.ov_vals.dtype) != x.dtype:
        raise ValueError(f"the scan ({scan.dtype}) and x ({x.dtype}, "
                         f"{tuple(x.shape)}) must be the scan and the 1-D "
                         f"sum type of a plan of the overflow values' "
                         f"type {tables.ov_vals.dtype}")
    if x.shape[0] < tables.ncols:
        raise ValueError(f"x has {x.shape[0]} entries; the plan has "
                         f"{tables.ncols} columns")
    _check_same_device(scan, x, tables.row_off)


def packed_rows_kernel(scan, x, tables: ExtractTables, *,
                       rows: int) -> torch.Tensor:
    """Kernel F on CUDA tensors; the plain version on CPU tensors.
    Returns y, (rows,) in x's type (the plan's sum type): each row's
    pieces, then its overflow, from the compacted list ``tables``."""
    _check_rows(scan, x, tables, rows)
    if not platform.is_cuda(scan):
        return packed_rows_plain(scan, x, tables, rows=rows)
    y = torch.empty(rows, dtype=x.dtype, device=scan.device)
    _launch_f(scan, tables, x, y)
    return y


def _launch_f(scan, tables, x, y):
    """One launch of kernel F into ``y``, the build of the tables'
    overflow value type (x is not read where they hold no overflow)."""
    ov = (tables.ov_cols.data_ptr(), tables.ov_vals.data_ptr(),
          x.data_ptr()) if tables.ov_cols.shape[0] else (None,) * 3
    _kernels.launch(
        _kernels.entry("packed_extract_f32", tables.ov_vals.dtype),
        scan.get_device(), scan.data_ptr(), tables.row_off.data_ptr(),
        tables.entries.data_ptr(), tables.units.data_ptr(), *ov,
        y.data_ptr(), tables.units.shape[0], tables.unit)


def packed_extract_kernel(scan, sblock, wstep, esrc, *, num_windows: int,
                          step_tiles: int) -> torch.Tensor:
    """Kernel F over whole windows with no overflow on CUDA tensors (the
    ``packed_extract_*`` entry of the scan's type), from a list it
    compacts from ``esrc`` first; the plain version on CPU tensors.
    Returns (num_windows * 64, 128) in the scan's sum type.  ``wstep``
    must be nondecreasing (``build_packed_plan``'s window-major visit
    order).  Both versions write 0 to
    unvisited windows, so the plan's ``wfirst`` and ``window_mask`` (the
    reference's overwrite flag and mask) are not read."""
    _check_extract(scan, sblock, wstep, esrc, num_windows)
    if not platform.is_cuda(scan):
        return packed_extract_plain(scan, sblock, wstep, esrc,
                                    num_windows=num_windows,
                                    step_tiles=step_tiles)
    rows = num_windows * PACKED_WINDOW_BLOCKS * 128
    prow, pslot = piece_slots(sblock, wstep, esrc, step_tiles)
    none = torch.zeros(0, dtype=torch.int64, device=scan.device)
    tables = compact_tables(prow, pslot, none, none, none.to(scan.dtype),
                            rows=rows, ncols=0, slots=scan.numel(),
                            dense_entries=esrc.numel())
    out = torch.empty((rows // 128, 128), dtype=sr.x_dtype(scan.dtype),
                      device=scan.device)
    _launch_f(scan, tables, None, out.reshape(-1))
    return out


# ---------------------------------------------------------------------------
# the PackedPlan apply
# ---------------------------------------------------------------------------

def spmv_packed(plan: PackedPlan, x: torch.Tensor, *,
                semiring: str = "plus_times") -> torch.Tensor:
    """``y = A @ x`` from a packed plan (any structure, any width).

    plus_times only: the piece extraction rides a segmented prefix sum,
    which assumes the additive monoid of a ring."""
    if semiring != "plus_times":
        raise ValueError(
            f"packed plans run plus_times only (piece extraction rides a "
            f"segmented prefix sum); got {semiring!r}")
    st = plan.stats
    tables = placed(plan.tables, "the tables of kernel F")
    x = sr.as_x(x, plan.vals.dtype)
    scan = packed_scan_kernel(plan.vals, plan.cols, plan.cstep, x,
                              chunk_blocks=st.chunk_blocks,
                              step_tiles=st.step_tiles)
    return packed_rows_kernel(scan, x, tables, rows=plan.shape[0])
