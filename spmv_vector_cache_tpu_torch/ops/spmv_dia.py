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
in int32.
"""

from __future__ import annotations

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


def spmv_dia_kernel(vals: torch.Tensor, offsets, x: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """Kernel A on a CUDA tensor; the plain version on a CPU tensor."""
    _check(vals, offsets, x)
    if not platform.is_cuda(x):
        return spmv_dia_plain(vals, offsets, x, rows)
    T, D, S, L = vals.shape
    if rows > T * S * L:
        raise ValueError(f"rows={rows} exceeds the plan's {T * S * L}")
    offs = _offsets_on(tuple(int(o) for o in offsets), x.device)
    y = torch.empty(rows, dtype=x.dtype, device=x.device)
    _kernels.launch(
        _kernels.entry("spmv_dia_f32", vals.dtype), x.get_device(),
        vals.data_ptr(), x.data_ptr(),
        offs.data_ptr(), y.data_ptr(), rows, x.shape[0], D, S * L)
    return y


def spmv_dia_halo_kernel(vals: torch.Tensor, offsets, x_ext: torch.Tensor,
                         rows: int, origin: int) -> torch.Tensor:
    """Kernel M on a CUDA tensor; the plain version on a CPU tensor.
    One shard's DIA SpMV (``parallel/dia_sharded.py``): ``x_ext`` is the
    left halo, the shard's x and the right halo, and ``origin`` the left
    halo's width, so row r reads ``x_ext[origin + r + off_k]``."""
    _check(vals, offsets, x_ext)
    if not platform.is_cuda(x_ext):
        return spmv_dia_halo_plain(vals, offsets, x_ext, rows, origin)
    T, D, S, L = vals.shape
    if rows > T * S * L:
        raise ValueError(f"rows={rows} exceeds the plan's {T * S * L}")
    offs = _offsets_on(tuple(int(o) for o in offsets), x_ext.device)
    y = torch.empty(rows, dtype=x_ext.dtype, device=x_ext.device)
    _kernels.launch(
        _kernels.entry("spmv_dia_halo_f32", vals.dtype), x_ext.get_device(),
        vals.data_ptr(),
        x_ext.data_ptr(), offs.data_ptr(), y.data_ptr(), rows, x_ext.shape[0],
        int(origin), D, S * L)
    return y


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
