"""DIA SpMV (counterpart of ``spmv_vector_cache_tpu/ops/spmv_dia.py``).

``y[r] = sum_k vals[k, r] * x[r + off_k]``: the column of a diagonal
nonzero is its row plus a constant, so there is no index stream.
:func:`spmv_dia_kernel` wraps kernel A (``csrc/spmv_dia.cu``), which
replaces the reference's resident and windowed Pallas kernels;
:func:`spmv_dia_plain` is its plain PyTorch version.
:func:`spmv_dia_halo_kernel` wraps kernel M, A with an x origin, which
replaces the reference's sharded DIA kernel (one shard's rows over an x
carrying both neighbours' halos, ``parallel/dia_sharded.py``);
:func:`spmv_dia_halo_plain` is its plain version.  On a double plan
(``value_dtype=np.float64``, hi/lo float32 pairs) :func:`spmv_dia_double`
(float64 in and out) and :func:`spmv_dia_df` (the reference's pair API)
run kernel J, the float64 build of A (:func:`spmv_dia_f64_kernel`),
which replaces the reference's double-float kernels.  A and M have a
build for each value type of ``ops/semiring.py``'s policy: bfloat16
and float16 values summed in float32 with a float32 x and y, int32 and
uint32 summed exactly in their own type, int8, uint8, int16 and uint16
in int32.  :func:`dia_launch_shape` picks A's and M's launch shape (rows
a thread, threads a CTA, x staged in shared memory or read through L1)
from the rows, the slot width, the offsets' span and the card's SM
count; :func:`kernel_shape` is the shape a wrapper launches a slab with.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..formats.dia import DiaPlan
from ..utils import platform
from . import _kernels, df64
from . import semiring as sr


def _check(vals: torch.Tensor, offsets, x: torch.Tensor,
           double: bool = False) -> None:
    if vals.dim() != 4 or vals.shape[3] != 128:
        raise ValueError(f"DIA vals must be (T, D, S, 128), got "
                         f"{tuple(vals.shape)}")
    channels = 2 if double else 1       # a double slab: hi and lo halves
    if channels * len(offsets) != vals.shape[1]:
        raise ValueError(f"{len(offsets)} offsets for {vals.shape[1]} "
                         f"diagonal channels")
    if double:
        ok = vals.dtype == torch.float32 and x.dtype == torch.float64
    else:
        ok = vals.dtype in _kernels.BUILDS and \
            x.dtype == sr.x_dtype(vals.dtype)
    if not ok:
        raise NotImplementedError(
            f"DIA SpMV runs float32, bfloat16, float16 and 8-, 16- and "
            f"32-bit integer values with an x of their sum type, or a double "
            f"plan's pairs with a float64 x (vals {vals.dtype}, x "
            f"{x.dtype})")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if vals.device != x.device:
        raise ValueError(f"vals on {vals.device}, x on {x.device}")
    if not (vals.is_contiguous() and x.is_contiguous()):
        raise ValueError("DIA operands must be contiguous")


def spmv_dia_halo_plain(vals: torch.Tensor, offsets, x: torch.Tensor,
                        rows: int, origin: int) -> torch.Tensor:
    """Plain PyTorch version of kernel M: row r reads
    ``x[origin + r + off_k]``, and 0 outside ``[0, len(x))``; the sums
    in :func:`~.semiring.widen`'s types, y in x's."""
    out_dtype = x.dtype
    vals, x = sr.widen(vals), sr.widen(x)
    T, D, S, L = vals.shape
    tail = (1,) * (x.dim() - 1)            # broadcast over B's RHS axis
    v = vals.permute(1, 0, 2, 3).reshape(D, T * S * L)[:, :rows]
    r = torch.arange(rows, device=x.device) + int(origin)
    cols = x.shape[0]
    acc = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    for k, off in enumerate(offsets):
        c = r + int(off)
        ok = (c >= 0) & (c < cols)
        xv = torch.where(ok.view(-1, *tail), x[c.clamp(0, max(cols - 1, 0))],
                         torch.zeros((), dtype=x.dtype, device=x.device))
        acc = acc + v[k].view(-1, *tail) * xv
    return sr.narrow(acc, out_dtype)


def spmv_dia_plain(vals: torch.Tensor, offsets, x: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """Plain PyTorch version of kernel A: the same sum, in the same
    diagonal order, with out-of-range columns reading 0.  An x with a
    trailing RHS axis, B of shape (cols, k), gives Y (rows, k): kernel
    I's plain version (``ops/spmm_dia.py``)."""
    return spmv_dia_halo_plain(vals, offsets, x, rows, 0)


@functools.lru_cache(maxsize=64)
def _offsets_on(offsets: tuple, device: torch.device) -> torch.Tensor:
    """The plan's static offsets as an int32 device array, uploaded once
    per (offset pattern, device) rather than once per apply."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=64)
def _offsets_host(offsets: tuple):
    """The same offsets as a C int array on the host, which kernels A and
    M copy into their launch's parameters (kept alive by the cache)."""
    return (ctypes.c_int * max(1, len(offsets)))(*offsets)


#: the most threads a CTA of kernels A and M has, and the shared memory
#: a CTA may stage its x window in (``csrc/spmv_dia.cu`` kMaxThreads,
#: kStageBytes: the 48 KB a kernel gets without opting in)
MAX_THREADS = 256
STAGE_BYTES = 48 * 1024
#: the slot bytes a thread loads a diagonal (one 16-byte vector), and the
#: most rows it takes (``csrc/spmv_dia.cu`` builds R = 1, 2, 4 and 8)
VECTOR_BYTES = 16
MAX_ROWS = 8
#: threads a CTA of A or M has, and the threads a launch keeps on each SM
#: before a thread takes more rows: ``probes_torch/dia_shapes.py`` on an
#: H100 found each build fastest at the largest R (up to 8) that still
#: launches about 65,536 threads (2^18 rows at R = 4, 65,536 at R = 1),
#: and 128 threads a CTA within 2 % of the best CTA size
THREADS = 128
FILL_THREADS_PER_SM = 448
#: the H100 SXM's SMs: the shape of a launch planned without a card
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class DiaShape:
    """A launch of kernel A or M: R rows a thread (consecutive rows of one
    step), threads a CTA, CTAs, and whether each CTA stages its x window
    in shared memory (``smem_bytes`` of it) or reads x through L1."""

    rows_per_thread: int
    threads: int
    ctas: int
    staged: bool
    smem_bytes: int


def stage_words(threads: int, rows_per_thread: int, span: int) -> int:
    """Words of a staged CTA's x window: thread i of a diagonal at
    ``c = off - min(offsets)`` reads the group ``i + c // R``, and group g
    holds window entries ``[g R, g R + 2R - 1)`` (see
    :func:`stage_address`)."""
    R = rows_per_thread
    return (threads + span // R) * (2 * R - 1)


def stage_address(thread: int, c: int, j: int, rows_per_thread: int) -> int:
    """The shared-memory word that holds x for row j of ``thread`` on the
    diagonal at ``c = off - min(offsets)``, as kernels A and M read it:
    window entry ``thread * R + c + j`` in the overlapping groups of
    ``2R - 1`` words (an odd stride between a warp's threads)."""
    R = rows_per_thread
    return (thread + c // R) * (2 * R - 1) + c % R + j


def stage_entry(word: int, rows_per_thread: int) -> int:
    """The x window entry that staging writes into ``word``."""
    R = rows_per_thread
    g, o = divmod(word, 2 * R - 1)
    return g * R + o


@functools.lru_cache(maxsize=256)
def dia_launch_shape(rows: int, rows_per_step: int, slot_bytes: int,
                     offsets: tuple, *, sm_count: int = H100_SMS,
                     align: int = VECTOR_BYTES) -> DiaShape:
    """Kernel A's or M's launch for ``rows`` rows of a slab with
    ``rows_per_step`` rows a step, ``slot_bytes`` a slot and diagonals
    at ``offsets`` (a tuple: the shape is kept per pattern).

    R starts at one 16-byte vector of slots a diagonal and at most
    :data:`MAX_ROWS` (4 rows of 4-byte slots, 8 of 2- and 1-byte ones;
    fewer where the slab's address is aligned to less, ``align``) and
    halves while the launch would give the card's ``sm_count`` SMs fewer
    than :data:`FILL_THREADS_PER_SM` threads each; a CTA has
    :data:`THREADS` threads, and stages its x window (x read 4 bytes an
    entry) where that fits :data:`STAGE_BYTES`."""
    span = max(offsets) - min(offsets) if offsets else 0
    R = max(1, min(MAX_ROWS, min(VECTOR_BYTES, align) // slot_bytes))
    while R > 1 and (rows_per_step % R
                     or -(-rows // R) < sm_count * FILL_THREADS_PER_SM):
        R //= 2
    smem = 4 * stage_words(THREADS, R, span)
    staged = smem <= STAGE_BYTES
    return DiaShape(rows_per_thread=R, threads=THREADS,
                    ctas=-(-rows // (R * THREADS)), staged=staged,
                    smem_bytes=smem if staged else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _align(ptr: int) -> int:
    """The power of two (at most 16) that a slab's address is aligned to."""
    return min(VECTOR_BYTES, ptr & -ptr) if ptr else VECTOR_BYTES


def kernel_shape(vals: torch.Tensor, offsets, rows: int) -> DiaShape:
    """The launch shape kernel A or M takes for ``rows`` rows of ``vals``
    (T, D, S, 128): :func:`dia_launch_shape` with the SM count of the
    slab's card (the H100's for a slab on the host) and the alignment of
    its address."""
    sms = _sm_count(vals.get_device()) if vals.is_cuda else H100_SMS
    return dia_launch_shape(
        rows, vals.shape[2] * vals.shape[3], vals.element_size(),
        tuple(offsets), sm_count=sms, align=_align(vals.data_ptr()))


@functools.lru_cache(maxsize=256)
def _launch_consts(offsets: tuple, device: torch.device, rows: int,
                   rows_per_step: int, slot_bytes: int, align: int):
    """The launch shape of kernel A or M for this offset pattern and row
    count on ``device``, and the addresses of the offsets on the card and
    on the host (with the objects that hold them): worked out once, not
    on every apply."""
    shape = dia_launch_shape(rows, rows_per_step, slot_bytes, offsets,
                             sm_count=_sm_count(device.index), align=align)
    on_card, on_host = _offsets_on(offsets, device), _offsets_host(offsets)
    return (shape, on_card.data_ptr(), ctypes.addressof(on_host), on_card,
            on_host)


def _launch(name: str, vals: torch.Tensor, offsets, x: torch.Tensor,
            rows: int, origin, shape) -> torch.Tensor:
    """Kernel A (``origin`` None) or M on the card, at ``shape`` or the
    one :func:`dia_launch_shape` picks."""
    T, D, S, L = vals.shape
    if rows > T * S * L:
        raise ValueError(f"rows={rows} exceeds the plan's {T * S * L}")
    ptr = vals.data_ptr()
    picked, on_card, on_host, *_ = _launch_consts(
        tuple(offsets), x.device, rows, S * L, vals.element_size(),
        _align(ptr))
    shape = shape or picked
    y = torch.empty(rows, dtype=x.dtype, device=x.device)
    _kernels.launch(
        _kernels.entry(name, vals.dtype), x.get_device(), ptr, x.data_ptr(),
        on_card, on_host, y.data_ptr(), rows, x.shape[0],
        *(() if origin is None else (int(origin),)), D, S * L,
        shape.rows_per_thread, shape.threads, int(shape.staged))
    return y


def spmv_dia_kernel(vals: torch.Tensor, offsets, x: torch.Tensor,
                    rows: int, shape: DiaShape | None = None
                    ) -> torch.Tensor:
    """Kernel A on a CUDA tensor; the plain version on a CPU tensor.
    ``shape``: the launch (:class:`DiaShape`), else :func:`kernel_shape`'s."""
    _check(vals, offsets, x)
    if not platform.is_cuda(x):
        return spmv_dia_plain(vals, offsets, x, rows)
    return _launch("spmv_dia_f32", vals, offsets, x, rows, None, shape)


def spmv_dia_halo_kernel(vals: torch.Tensor, offsets, x_ext: torch.Tensor,
                         rows: int, origin: int,
                         shape: DiaShape | None = None) -> torch.Tensor:
    """Kernel M on a CUDA tensor; the plain version on a CPU tensor.
    One shard's DIA SpMV (``parallel/dia_sharded.py``): ``x_ext`` is the
    left halo, the shard's x and the right halo, and ``origin`` the left
    halo's width, so row r reads ``x_ext[origin + r + off_k]``.
    ``shape`` as for :func:`spmv_dia_kernel`."""
    _check(vals, offsets, x_ext)
    if not platform.is_cuda(x_ext):
        return spmv_dia_halo_plain(vals, offsets, x_ext, rows, origin)
    return _launch("spmv_dia_halo_f32", vals, offsets, x_ext, rows, origin,
                   shape)


def spmv_dia_f64_plain(vals: torch.Tensor, offsets, x: torch.Tensor,
                       rows: int) -> torch.Tensor:
    """Plain PyTorch version of kernel J: the hi/lo slab joined into
    float64 values, then kernel A's plain version in float64."""
    return spmv_dia_plain(df64.join_channels(vals), offsets, x, rows)


def spmv_dia_f64_kernel(vals: torch.Tensor, offsets, x: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """Kernel J on a CUDA tensor; the plain version on a CPU tensor.
    ``vals``: a double plan's (T, 2D, S, 128) float32 hi/lo slab; ``x``
    and the result: float64."""
    _check(vals, offsets, x, double=True)
    if not platform.is_cuda(x):
        return spmv_dia_f64_plain(vals, offsets, x, rows)
    T, D2, S, L = vals.shape
    if rows > T * S * L:
        raise ValueError(f"rows={rows} exceeds the plan's {T * S * L}")
    offs = _offsets_on(tuple(int(o) for o in offsets), x.device)
    y = torch.empty(rows, dtype=torch.float64, device=x.device)
    _kernels.launch(
        "spmv_dia_f64", x.get_device(), vals.data_ptr(), x.data_ptr(),
        offs.data_ptr(), y.data_ptr(), rows, x.shape[0], D2 // 2, S * L)
    return y


def _check_x(plan: DiaPlan, x: torch.Tensor) -> None:
    if x.shape != (plan.shape[1],):
        raise ValueError(f"x has shape {tuple(x.shape)}, the plan needs "
                         f"({plan.shape[1]},)")


def spmv_dia(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` from a prebuilt :class:`DiaPlan` of any value type
    but float64 on ``x.device`` (x cast to the plan's sum type as the
    reference casts it, :func:`~.semiring.as_x`), y in the sum type
    (``spmv_plan`` narrows a narrow plan's y).

    The reference's ``resident`` argument is dropped: it chose between
    keeping the x image in VMEM and streaming sliding blocks, a capacity
    question the card does not have — the kernel reads x from device
    memory through L1/L2 at any size.
    """
    if plan.double:
        raise ValueError("double-float plan: use spmv_dia_double (float64 "
                         "x and y) or spmv_dia_df (hi/lo float32 pairs)")
    _check_x(plan, x)
    return spmv_dia_kernel(plan.vals, plan.offsets,
                           sr.as_x(x, plan.vals.dtype),
                           plan.shape[0])


def spmv_dia_double(plan: DiaPlan, x: torch.Tensor) -> torch.Tensor:
    """``y = A @ x`` from a double :class:`DiaPlan` on ``x.device``:
    float64 x (a float32 x is widened exactly) in, float64 y out, on
    kernel J.  The reference joins y on the host; here it stays on
    ``x.device``.  No ``resident`` argument, as for :func:`spmv_dia`."""
    if not plan.double:
        raise ValueError("plan was not built with value_dtype=np.float64")
    _check_x(plan, x)
    return spmv_dia_f64_kernel(plan.vals, plan.offsets,
                               x.to(torch.float64).contiguous(),
                               plan.shape[0])


def spmv_dia_df(plan: DiaPlan, xh: torch.Tensor,
                xl: torch.Tensor) -> tuple:
    """The reference's pair API: (xh, xl) float32 in, (yh, yl) float32
    out on ``xh.device``, with ``yh + yl`` the float64 y.  A shim over
    :func:`spmv_dia_double`: the pair is joined into one float64 x and y
    split again."""
    return df64.split(spmv_dia_double(plan, df64.join(xh, xl)))
