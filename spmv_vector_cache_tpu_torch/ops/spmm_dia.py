"""DIA SpMM (counterpart of ``spmv_vector_cache_tpu/ops/spmm_dia.py``).

``Y[r, j] = sum_d vals[d, r] * B[r + off_d, j]`` with B of shape
(cols, k): the multi-RHS form of :mod:`.spmv_dia`, reading each value
slab once for all k right-hand sides.  :func:`spmm_dia_kernel` wraps
kernel I (``csrc/spmm_dia.cu``), which replaces the reference's
``_make_dia_spmm_kernel``; :func:`spmm_dia_plain` is its plain PyTorch
version.  Kernel I stages the span of B that a run of rows reads, and
the run's values, in shared memory, band by band: :func:`spmm_dia_tiling`
picks the run, the columns a thread holds and the bands
(:func:`dia_bands`) on the host, once per (offset pattern, k).  Kernel
I has a build for each value type of ``ops/semiring.py``'s policy: a
bfloat16 plan sums in float32 with a float32 B and Y, where the
reference rounds B to bfloat16, sums in bfloat16 and returns a bfloat16
Y (ROADMAP.md queue 3); a float16 plan likewise sums in float32 (its Y
rounded once, by ``spmm_plan``); the integers sum exactly, the 8- and
16-bit ones in int32 (Y narrowed once).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..formats.dia import DiaPlan
from ..utils import platform
from . import _kernels
from . import semiring as sr
from .spmv_dia import _offsets_on, spmv_dia_plain

#: most threads of one CTA of kernel I: small CTAs, many to an SM,
#: overlap one CTA's staging with another's sums (128 beat 512, 256 and
#: 64 on the H100 at k = 16 and 64, PERF.md)
SPMM_DIA_THREADS = 128
#: most shared memory one CTA of kernel I stages B and the values in
SPMM_DIA_SMEM = 110 * 1024
#: most columns of Y one CTA holds; wider B runs over several CTAs
SPMM_DIA_COLS = 128
#: most diagonals of one band when the plan needs several
SPMM_DIA_BAND_DIAGS = 8


def dia_bands(offsets, max_spread: int, max_diags: int | None = None
              ) -> tuple:
    """The diagonals grouped into bands of consecutive diagonals, each as
    (first, end) indices, whose offsets spread over at most
    ``max_spread`` rows and which hold at most ``max_diags`` diagonals,
    greedily in plan order: a CTA of kernel I stages one band's rows of B
    and values at a time.  ``offsets`` must be nondecreasing, as a
    DiaPlan's are; a diagonal is a band of its own at any spread."""
    offs = [int(o) for o in offsets]
    if any(b < a for a, b in zip(offs, offs[1:])):
        raise ValueError(f"DIA offsets must be nondecreasing, got {offs}")
    if max_spread < 0:
        raise ValueError(f"max_spread must be >= 0, got {max_spread}")
    cap = max_diags or max(1, len(offs))
    bands, d0 = [], 0
    for d in range(1, len(offs) + 1):
        if d == len(offs) or offs[d] - offs[d0] > max_spread or \
                d - d0 >= cap:
            bands.append((d0, d))
            d0 = d
    return tuple(bands)


@dataclasses.dataclass(frozen=True)
class DiaSpmmTiling:
    """How kernel I covers Y (rows, k) for one offset pattern and k."""

    cols_per_thread: int      # KC: 4, 8, 16 or 32 sums in registers
    threads_per_row: int      # threads sharing a row (k > 32)
    rows_per_cta: int         # R consecutive rows of one DIA step
    stride: int               # floats per staged B row in shared memory
    buf_rows: int             # staged rows of B a buffer holds
    band_diags: int           # runs of R values a buffer holds
    buffers: int              # 1 for one band, 2 (double buffered) else
    bands: tuple              # dia_bands(offsets, ...)

    @property
    def smem_bytes(self) -> int:
        per = self.buf_rows * self.stride + self.band_diags * self.rows_per_cta
        return self.buffers * -(-per // 4) * 16


def spmm_dia_tiling(offsets, k: int) -> DiaSpmmTiling:
    """Kernel I's tiling: a thread holds KC = the power of two >= k (4 to
    32) of a row's columns, and at k > 32 up to 4 threads share a row
    (128 columns a CTA); R <= SPMM_DIA_THREADS / (threads per row)
    rows a CTA.  A
    staged row is padded to a stride whose quarter-warp float4 reads hit
    32 distinct banks.  All diagonals form one band, single buffered, at
    the largest R (down to a quarter of the most) whose R + spread rows
    of B and R values a diagonal fit SPMM_DIA_SMEM; else two buffers of
    half of it each, and bands of at most SPMM_DIA_BAND_DIAGS diagonals
    whose rows fit one (R halved until a diagonal's fit)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    offs = tuple(int(o) for o in offsets)
    width = min(k, SPMM_DIA_COLS)
    kc = 4
    while kc < min(width, 32):
        kc *= 2
    tpr = 1
    while tpr * kc < width:
        tpr *= 2
    cols = tpr * kc
    # quarter-warp float4 reads of 8 / tpr rows: the row stride is an odd
    # multiple of 4 * tpr floats
    stride = cols if (cols // (4 * tpr)) % 2 else cols + 4 * tpr
    row_bytes = 4 * stride
    most = SPMM_DIA_THREADS // tpr
    spread = offs[-1] - offs[0] if offs else 0
    nd = len(offs)
    rpc = most
    while rpc >= max(1, most // 4):
        if (rpc + spread) * row_bytes + 4 * nd * rpc <= SPMM_DIA_SMEM:
            return DiaSpmmTiling(kc, tpr, rpc, stride, rpc + spread, nd, 1,
                                 dia_bands(offs, spread))
        rpc //= 2
    half, nd = SPMM_DIA_SMEM // 2, min(nd, SPMM_DIA_BAND_DIAGS)
    rpc = most
    while rpc > 1 and rpc * (row_bytes + 4 * nd) > half:
        rpc //= 2
    bands = dia_bands(offs, (half - 4 * nd * rpc) // row_bytes - rpc, nd)
    buf_rows = rpc + max(offs[e - 1] - offs[s] for s, e in bands)
    return DiaSpmmTiling(kc, tpr, rpc, stride, buf_rows,
                         max(e - s for s, e in bands), 2, bands)


#: the tiling of each (offset pattern, k), worked out once
_tiling = functools.lru_cache(maxsize=64)(spmm_dia_tiling)


@functools.lru_cache(maxsize=64)
def _bands_on(bands: tuple, device: torch.device) -> torch.Tensor:
    """A tiling's bands as an int32 (nbands, 2) device array, uploaded
    once per (bands, device) rather than once per apply."""
    return torch.tensor(bands, dtype=torch.int32,
                        device=device).reshape(-1, 2)


def _check(vals: torch.Tensor, offsets, b: torch.Tensor) -> None:
    if vals.dim() != 4 or vals.shape[3] != 128:
        raise ValueError(f"DIA vals must be (T, D, S, 128), got "
                         f"{tuple(vals.shape)}")
    if len(offsets) != vals.shape[1]:
        raise ValueError(f"{len(offsets)} offsets for {vals.shape[1]} "
                         f"diagonals")
    if vals.dtype not in _kernels.BUILDS or \
            b.dtype != sr.x_dtype(vals.dtype):
        raise NotImplementedError(
            f"DIA SpMM runs float32, bfloat16, float16 and 8-, 16- and "
            f"32-bit integer values with a B of their sum type (vals "
            f"{vals.dtype}, B {b.dtype})")
    if b.dim() != 2 or b.shape[1] < 1:
        raise ValueError(f"B must be (cols, k) with k >= 1, got shape "
                         f"{tuple(b.shape)}")
    if vals.device != b.device:
        raise ValueError(f"vals on {vals.device}, B on {b.device}")
    if not (vals.is_contiguous() and b.is_contiguous()):
        raise ValueError("DIA SpMM operands must be contiguous")


#: plain PyTorch version of kernel I: kernel A's plain version, whose
#: per-diagonal loop runs over B's trailing k axis
spmm_dia_plain = spmv_dia_plain


def spmm_dia_kernel(vals: torch.Tensor, offsets, b: torch.Tensor,
                    rows: int) -> torch.Tensor:
    """Kernel I on a CUDA tensor; the plain version on a CPU tensor.
    Returns Y of shape (rows, k), tiled by :func:`spmm_dia_tiling`."""
    _check(vals, offsets, b)
    if not platform.is_cuda(b):
        return spmm_dia_plain(vals, offsets, b, rows)
    T, D, S, L = vals.shape
    if rows > T * S * L:
        raise ValueError(f"rows={rows} exceeds the plan's {T * S * L}")
    offsets = tuple(int(o) for o in offsets)
    k = b.shape[1]
    offs = _offsets_on(offsets, b.device)
    t = _tiling(offsets, k)
    bands = _bands_on(t.bands, b.device)
    y = torch.empty((rows, k), dtype=b.dtype, device=b.device)
    _kernels.launch(
        _kernels.entry("spmm_dia_f32", vals.dtype), b.get_device(),
        vals.data_ptr(), b.data_ptr(),
        offs.data_ptr(), bands.data_ptr(), y.data_ptr(), rows, b.shape[0], k,
        D, S * L, len(t.bands), t.rows_per_cta, t.cols_per_thread,
        t.threads_per_row, t.stride, t.buf_rows, t.band_diags, t.buffers)
    return y


def spmm_dia(plan: DiaPlan, b: torch.Tensor) -> torch.Tensor:
    """Fused DIA SpMM ``Y = A @ B`` (B: (cols, k)) on ``b.device``.

    The reference's ``spmm_dia_feasible`` is dropped: it refused the
    kernel when 8 RHS columns of the zero-padded x image outgrew 0.6 of
    the TPU's VMEM (so the bench.py headline matrix never reached it), a
    capacity question the card does not have — kernel I stages B's rows
    band by band, and its columns in chunks of 128, at any width.
    """
    if plan.double:
        raise NotImplementedError("double-float DIA plans have no SpMM "
                                  "kernel (ROADMAP.md queue 3)")
    if b.dim() != 2 or b.shape[0] != plan.shape[1]:
        raise ValueError(f"B has shape {tuple(b.shape)}, the plan needs "
                         f"({plan.shape[1]}, k)")
    return spmm_dia_kernel(plan.vals, plan.offsets,
                           sr.as_x(b, plan.vals.dtype),
                           plan.shape[0])
