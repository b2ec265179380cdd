"""Packed two-pass SpMV (counterpart of
``spmv_vector_cache_tpu/ops/spmv_packed.py``).

:func:`packed_scan_kernel` wraps kernel E (pass A: gather, multiply,
segmented scan along each 128-slot row) and :func:`packed_extract_kernel`
kernel F (pass B: read each piece's sum at its end slot and sum it into
its y window), both in ``csrc/spmv_packed.cu``; beside each is its plain
PyTorch version.  The overflow COO is a torch gather plus a segment sum,
as the reference computes it in XLA outside Pallas.  See
``formats/packed.py`` for the layout.
"""

from __future__ import annotations

import torch

from ..formats.packed import PACKED_WINDOW_BLOCKS, PackedPlan
from ..utils import platform
from . import _kernels
from . import semiring as sr


def _check_same_device(ref, *ts):
    for t in ts:
        if t.device != ref.device:
            raise ValueError(f"operands on {ref.device} and {t.device}")
    if not all(t.is_contiguous() for t in (ref, *ts)):
        raise ValueError("packed operands must be contiguous")


# ---------------------------------------------------------------------------
# pass A: kernel E
# ---------------------------------------------------------------------------

def packed_scan_plain(vals, cols, cstep, x, *, chunk_blocks: int,
                      step_tiles: int) -> torch.Tensor:
    """Plain PyTorch version of kernel E: the reference's Hillis-Steele
    segmented scan over lane shifts, in the reference's order."""
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
    return S.reshape(T, 8, 128)


def _check_scan(vals, cols, cstep, x, step_tiles):
    if vals.dim() != 3 or tuple(vals.shape[1:]) != (8, 128) or \
            cols.shape != vals.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols "
                         f"{tuple(cols.shape)} must be equal (T, 8, 128)")
    if vals.shape[0] != cstep.shape[0] * step_tiles:
        raise ValueError(f"{vals.shape[0]} tiles, but cstep has "
                         f"{cstep.shape[0]} steps of {step_tiles}")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise NotImplementedError(f"packed SpMV runs float32 only (vals "
                                  f"{vals.dtype}, x {x.dtype})")
    if cols.dtype != torch.int16 or cstep.dtype != torch.int32:
        raise ValueError("cols must be int16 and cstep int32")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    _check_same_device(vals, cols, cstep, x)
    if vals.data_ptr() % 16 or cols.data_ptr() % 8:
        raise ValueError("kernel E reads vals 16 B and cols 8 B at a "
                         "time: both must be aligned to that")


def packed_scan_kernel(vals, cols, cstep, x, *, chunk_blocks: int,
                       step_tiles: int) -> torch.Tensor:
    """Kernel E on CUDA tensors; the plain version on CPU tensors.
    Returns the scan S, (T, 8, 128) float32."""
    _check_scan(vals, cols, cstep, x, step_tiles)
    if not platform.is_cuda(x):
        return packed_scan_plain(vals, cols, cstep, x,
                                 chunk_blocks=chunk_blocks,
                                 step_tiles=step_tiles)
    out = torch.empty_like(vals)
    _kernels.launch(
        "packed_scan_f32", x.get_device(), vals.data_ptr(), cols.data_ptr(),
        cstep.data_ptr(), x.data_ptr(), out.data_ptr(), vals.shape[0] * 8,
        step_tiles * 8, chunk_blocks * 128, x.shape[0])
    packed_scan_kernel.launches += 1
    return out


packed_scan_kernel.launches = 0


# ---------------------------------------------------------------------------
# pass B: kernel F
# ---------------------------------------------------------------------------

def packed_extract_plain(scan, sblock, wstep, esrc, *, num_windows: int,
                         step_tiles: int) -> torch.Tensor:
    """Plain PyTorch version of kernel F: each visit's piece sums, added
    into their windows in visit order; unvisited windows are 0."""
    e = esrc.long()
    src = sblock.long()[:, None, None] * (step_tiles * 1024) + e.clamp(min=0)
    contrib = torch.where(e >= 0, scan.reshape(-1)[src], scan.new_zeros(()))
    out = scan.new_zeros((num_windows, PACKED_WINDOW_BLOCKS, 128))
    return out.index_add_(0, wstep, contrib).reshape(-1, 128)


def _check_extract(scan, sblock, wstep, esrc, num_windows):
    steps_b = sblock.shape[0]
    if tuple(esrc.shape) != (steps_b, PACKED_WINDOW_BLOCKS, 128) or \
            wstep.shape != sblock.shape:
        raise ValueError(f"esrc {tuple(esrc.shape)} must be (steps_b, 64, "
                         f"128) with steps_b = {steps_b} visits")
    if scan.dtype != torch.float32:
        raise NotImplementedError(f"packed SpMV runs float32 only (scan "
                                  f"{scan.dtype})")
    if esrc.dtype != torch.int16 or sblock.dtype != torch.int32 or \
            wstep.dtype != torch.int32:
        raise ValueError("esrc must be int16, sblock and wstep int32")
    if not 0 < num_windows < 65536:
        raise ValueError(f"num_windows {num_windows} out of [1, 65535]")
    _check_same_device(scan, sblock, wstep, esrc)


def packed_extract_kernel(scan, sblock, wstep, esrc, *, num_windows: int,
                          step_tiles: int) -> torch.Tensor:
    """Kernel F on CUDA tensors; the plain version on CPU tensors.
    Returns (num_windows * 64, 128) float32.  ``wstep`` must be
    nondecreasing (``build_packed_plan``'s window-major visit order).  Both
    versions write 0 to unvisited windows, so the plan's ``wfirst`` and
    ``window_mask`` (the reference's overwrite flag and mask) are not
    read."""
    _check_extract(scan, sblock, wstep, esrc, num_windows)
    if not platform.is_cuda(scan):
        return packed_extract_plain(scan, sblock, wstep, esrc,
                                    num_windows=num_windows,
                                    step_tiles=step_tiles)
    out = torch.empty((num_windows * PACKED_WINDOW_BLOCKS, 128),
                      dtype=torch.float32, device=scan.device)
    _kernels.launch(
        "packed_extract_f32", scan.get_device(), scan.data_ptr(),
        sblock.data_ptr(), wstep.data_ptr(), esrc.data_ptr(), out.data_ptr(),
        num_windows, sblock.shape[0], step_tiles * 1024)
    packed_extract_kernel.launches += 1
    return out


packed_extract_kernel.launches = 0


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
    rows = plan.shape[0]
    x = x.to(plan.vals.dtype).contiguous()
    scan = packed_scan_kernel(plan.vals, plan.cols, plan.cstep, x,
                              chunk_blocks=st.chunk_blocks,
                              step_tiles=st.step_tiles)
    out = packed_extract_kernel(scan, plan.sblock, plan.wstep, plan.esrc,
                                num_windows=st.num_windows,
                                step_tiles=st.step_tiles)
    y = out.reshape(-1)[:rows]
    if plan.ov_vals.shape[0]:
        prod = plan.ov_vals * x[plan.ov_cols.long()]
        y = y + sr.PLUS_TIMES.segment_reduce(prod, plan.ov_rows,
                                             num_segments=rows)
    return y
