"""DIA (diagonal) format: container, hybrid split and the tile plan
(counterpart of ``spmv_vector_cache_tpu/formats/dia.py``).

For matrices whose nonzeros concentrate on a few diagonals, ``x[col]``
is ``x[row + offset]``: no per-element index stream, so the value stream
is the only one left (4 B/nnz instead of 8).

Layout built here (consumed by ``ops/spmv_dia.py``), the same bytes as
the reference's:

* ``vals``: (T, D, S, 128) — step t covers ``S*128`` consecutive rows;
  ``vals[t, k, i, l]`` is A[r, r + offsets[k]] for r = t*S*128 + i*128 + l.
* ``pad_left`` and ``x_rows`` describe the reference kernel's padded x
  image; the CUDA kernel reads x directly and masks out-of-range columns,
  but the plan keeps both fields so that plans stay byte-equal.

``split_diagonal`` is the hybrid splitter: diagonals dense enough to pay
for their padded storage go to DIA, the rest stays CSR for the SELL path;
``y = y_dia + y_sell``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from .containers import COO, CSC, CSR

Array = Any

#: sublanes of 128 rows per DIA step (8192 rows)
DIA_SUBLANES = 64


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal container: ``data[k, r] = A[r, r + offsets[k]]``.
    Slots outside the matrix carry 0."""

    data: Array                  # (D, rows)
    offsets: Array               # (D,) int64, strictly increasing
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int((np.asarray(self.data) != 0).sum())


def _csr_fields(a: CSR):
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64) & 0x3FFFFFFF
    data = np.asarray(a.data)
    rows, cols = a.shape
    nz_row = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
    return rows, cols, nz_row, indices, data


def csr_to_dia(a: CSR, *, max_diags: int = 512) -> DIA:
    """Exact conversion (every nonzero lands on a stored diagonal)."""
    rows, cols, nz_row, indices, data = _csr_fields(a)
    d = indices - nz_row
    offsets = np.unique(d)
    if offsets.size > max_diags:
        raise ValueError(
            f"matrix has {offsets.size} distinct diagonals "
            f"(max_diags={max_diags}); use split_diagonal for a hybrid")
    vd = np.zeros((offsets.size, rows), data.dtype)
    k = np.searchsorted(offsets, d)
    vd[k, nz_row] = data
    return DIA(data=vd, offsets=offsets, shape=a.shape)


def dia_to_csr(a: DIA) -> CSR:
    """The stored nonzeros of a DIA container as a CSR with sorted
    columns (a slot holding 0 is dropped)."""
    data = np.asarray(a.data)
    offsets = np.asarray(a.offsets)
    rows, cols = a.shape
    rr, kk = [], []
    for k, off in enumerate(offsets):
        r = np.arange(max(0, -off), min(rows, cols - off), dtype=np.int64)
        r = r[data[k, r] != 0]
        rr.append(r)
        kk.append(np.full(r.shape, k, np.int64))
    r = np.concatenate(rr) if rr else np.zeros(0, np.int64)
    k = np.concatenate(kk) if kk else np.zeros(0, np.int64)
    c = r + offsets[k] if r.size else r
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    v = data[k[order], r]
    indptr = np.zeros(rows + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(data=v, indices=c.astype(np.int32), indptr=indptr,
               shape=a.shape)


def from_scipy_dia(m) -> DIA:
    """scipy.sparse.dia_matrix -> row-major DIA (offsets sorted)."""
    offsets = np.asarray(m.offsets, dtype=np.int64)
    order = np.argsort(offsets)
    offsets = offsets[order]
    rows, cols = m.shape
    vd = np.zeros((offsets.size, rows), m.data.dtype)
    for k, off in enumerate(offsets):
        r0, r1 = max(0, -off), min(rows, cols - off)
        if r1 > r0:
            r = np.arange(r0, r1)
            vd[k, r] = m.data[order[k], r + off]
    return DIA(data=vd, offsets=offsets, shape=m.shape)


def split_diagonal(a: CSR, *, min_diag_fill: float = 0.5,
                   max_diags: int = 96
                   ) -> Tuple[Optional[DIA], Optional[CSR], float]:
    """Hybrid split: (dense-diagonal part, residual CSR, coverage).

    A diagonal is extracted when its population is at least
    ``min_diag_fill`` of its in-matrix length, keeping at most the
    ``max_diags`` densest.  Returns (None, a, 0.0) when nothing qualifies
    and (dia, None, 1.0) when everything does.
    """
    rows, cols, nz_row, indices, data = _csr_fields(a)
    if data.size == 0:
        return None, a, 0.0
    d = indices - nz_row
    offsets, counts = np.unique(d, return_counts=True)
    diag_len = np.minimum(rows, cols - offsets)
    diag_len = np.minimum(diag_len, rows + offsets)
    keep = counts >= np.maximum(1.0, min_diag_fill * diag_len)
    if keep.sum() > max_diags:
        order = np.argsort(counts[keep])[::-1][:max_diags]
        kept_offs = offsets[keep][order]
        keep = np.isin(offsets, kept_offs)
    if not keep.any():
        return None, a, 0.0
    sel_offs = offsets[keep]
    on_dia = np.isin(d, sel_offs)
    coverage = float(on_dia.sum()) / float(data.size)

    vd = np.zeros((sel_offs.size, rows), data.dtype)
    k = np.searchsorted(sel_offs, d[on_dia])
    vd[k, nz_row[on_dia]] = data[on_dia]
    dia = DIA(data=vd, offsets=sel_offs, shape=a.shape)

    if on_dia.all():
        return dia, None, 1.0
    rest_mask = ~on_dia
    rest_indptr = np.zeros(rows + 1, np.int64)
    np.add.at(rest_indptr, nz_row[rest_mask] + 1, 1)
    rest = CSR(data=data[rest_mask],
               indices=indices[rest_mask].astype(np.int32),
               indptr=np.cumsum(rest_indptr), shape=a.shape)
    return dia, rest, coverage


# ---------------------------------------------------------------------------
# device plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiaStats:
    nnz: int                 # populated slots
    ndiag: int
    num_steps: int
    fill: float              # nnz / (D * padded rows)
    bytes_per_nnz: float     # streamed value bytes per populated slot
    x_rows: int              # the reference kernel's x image height

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Tiled DIA layout (see module docstring); ``offsets`` is a static
    tuple, increasing."""

    vals: Array                       # (T, D, S, 128)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    sublanes: int                     # S
    pad_left: int                     # reference x image left pad
    x_rows: int                       # reference x image height
    stats: DiaStats
    #: double-float layout: vals channels [0:D] hold f32 value highs and
    #: [D:2D] the f32 lows (hi + lo == the f64 value)
    double: bool = False

    @property
    def num_steps(self) -> int:
        return int(self.vals.shape[0])


def build_dia_plan(a, *, sublanes: int = DIA_SUBLANES,
                   value_dtype=np.float32) -> DiaPlan:
    """Build the (T, D, S, 128) tile plan from a DIA/CSR/CSC/COO
    container.  ``value_dtype=np.float64`` builds a double plan: each
    value as a (hi, lo) float32 pair, highs and lows stacked along the
    diagonal axis, (T, 2D, S, 128)."""
    from .plan import _require_f32_or_f64

    double = _require_f32_or_f64(value_dtype)
    if not isinstance(a, DIA):
        if isinstance(a, (CSC, COO)):
            from .convert import coo_to_csr, csc_to_csr
            a = csc_to_csr(a) if isinstance(a, CSC) else coo_to_csr(a)
        a = csr_to_dia(a)
    rows, cols = a.shape
    S = sublanes
    RS = S * 128
    offsets = tuple(int(o) for o in np.asarray(a.offsets))
    D = len(offsets)
    nr = rows + ((-rows) % RS)
    T = nr // RS
    vd = np.zeros((D, nr), value_dtype)
    vd[:, :rows] = np.asarray(a.data, value_dtype)
    store = vd
    if double:
        from ..ops.df64 import split_f64

        hi, lo = split_f64(vd)
        store = np.concatenate([hi, lo], axis=0)       # (2D, nr) f32
    vals = np.ascontiguousarray(
        store.reshape(store.shape[0], T, S, 128).transpose(1, 0, 2, 3))

    omin = min(offsets) if offsets else 0
    pad_left = ((max(0, -omin)) + 127) // 128 * 128
    max_rowq = max((8 * ((pad_left + o) // 1024) for o in offsets), default=0)
    x_rows = T * S + max_rowq + S + 8
    x_rows = max(x_rows, (pad_left + cols + 127) // 128)

    nnz = int((vd != 0).sum())
    streamed = store.shape[0] * nr * store.itemsize
    stats = DiaStats(
        nnz=nnz, ndiag=D, num_steps=T,
        fill=float(nnz) / float(D * nr) if D else 0.0,
        bytes_per_nnz=streamed / nnz if nnz else 0.0,
        x_rows=x_rows)
    return DiaPlan(vals=vals, offsets=offsets, shape=(rows, cols),
                   sublanes=S, pad_left=pad_left, x_rows=x_rows, stats=stats,
                   double=double)


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """DIA part + SELL (or COO tail) residual: ``y = dia(x) + rest(x)``."""

    dia: DiaPlan
    rest: Any                         # SellPlan or CooTail

    @property
    def shape(self):
        return self.dia.shape
