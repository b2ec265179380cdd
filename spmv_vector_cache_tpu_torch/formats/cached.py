"""Cached plans: the hot/cold column split for locality-poor matrices
(counterpart of ``spmv_vector_cache_tpu/formats/cached.py``).

The planner measures column popularity up front and splits the matrix by
it:

* **hot** nonzeros — those in the most-referenced columns — are remapped
  onto a compact column domain of at most ``max_hot`` entries, so the
  window or resident SELL kernels apply whatever the original matrix's
  locality.  One ``x[hot_cols]`` gather per apply feeds them.
* **cold** nonzeros — the popularity tail — run on the original column
  domain: another cache level, a full-cover compact tier, a
  :class:`CooTail`, a packed plan or a windowless SELL plan.

The plan functions are the reference's host-side numpy code, carried
over so that both packages build byte-equal plans; the throughput model
that sizes the hot set keeps the reference's v5e rates for that reason
only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from .containers import CSR

Array = Any


@dataclasses.dataclass(frozen=True)
class CachedPlan:
    """Hot/cold split of one matrix: ``y = hot(x[hot_cols]) + cold(x)``.

    ``hot`` is a :class:`~.plan.SellPlan` over the compact remapped
    column domain (shape ``(rows, hot_size)``); ``cold`` covers the
    residual nonzeros on the original column domain (a SellPlan,
    CooTail, PackedPlan or nested CachedPlan), or is ``None`` when the
    hot set covers everything.  ``hot_cols`` holds the original column
    ids of the hot set in ascending order."""

    hot: Any
    cold: Optional[Any]
    hot_cols: Array                    # (hot_size,) int32, ascending
    shape: Tuple[int, int]
    coverage: float                    # hot nnz / total nnz (hit rate)


@dataclasses.dataclass(frozen=True)
class CooTail:
    """Tiny-residue COO: ``y[rows_idx[i]] (+)= vals[i] (x) x[cols[i]]``."""

    vals: Array               # (nnz,) value dtype
    cols: Array               # (nnz,) int32
    rows_idx: Array           # (nnz,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])


#: residues below this many nonzeros run as CooTail
COO_TAIL_MAX = 65536


def coo_tail_from_csr(csr: CSR, value_dtype=np.float32) -> CooTail:
    lens = np.diff(np.asarray(csr.indptr, dtype=np.int64))
    rows_idx = np.repeat(np.arange(csr.shape[0], dtype=np.int32),
                         lens.astype(np.int64))
    from .plan import finish_values, host_values

    return CooTail(
        vals=finish_values(host_values(csr.data, value_dtype), value_dtype),
        cols=(np.asarray(csr.indices, dtype=np.int64)
              & 0x3FFFFFFF).astype(np.int32),
        rows_idx=rows_idx, shape=csr.shape)


def column_frequency(csr: CSR) -> np.ndarray:
    """Per-column nonzero counts (the popularity analysis)."""
    indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    return np.bincount(indices, minlength=csr.shape[1])


def hot_set_coverage(csr: CSR, sizes=(256, 512, 1024, 2048, 4096)
                     ) -> dict:
    """Fraction of nnz covered by the top-k columns, for each k."""
    counts = column_frequency(csr)
    nnz = max(1, int(counts.sum()))
    srt = np.sort(counts)[::-1]
    cum = np.cumsum(srt)
    return {int(k): float(cum[min(k, len(cum)) - 1]) / nnz for k in sizes}


#: the reference's hot-set sizing model (v5e rates, Gnnz/s), kept only so
#: that the port decides as the reference does
_RATE_PEAK = 90.0
_RATE_C = 200.0
_RATE_COLD = 2.0


def build_cached_plan(a, *, max_hot: int = 16384,
                      min_coverage: float = 0.5,
                      value_dtype=np.float32,
                      max_window_blocks: int = 16,
                      lane_rows: int = 128, positions: int = 8,
                      pad_value: float = 0.0,
                      allow_packed: bool = True,
                      levels: int = 3) -> Optional[CachedPlan]:
    """Split by column popularity; None when the split would not pay.

    The hot set is a power-of-two prefix of the popularity order (capped
    at ``max_hot``) picked by the throughput model; the cold tail
    recurses into up to ``levels - 1`` further cache levels, ending in a
    packed plan or a windowless SELL plan (:func:`_cold_plan`)."""
    from .plan import _as_csr, _auto_sell_plan

    csr = _as_csr(a)
    rows, cols = csr.shape
    if csr.nnz == 0 or cols <= max_hot:
        return None
    counts = column_frequency(csr)
    order = np.argsort(counts, kind="stable")[::-1]
    cum = np.cumsum(counts[order])
    nnz = int(cum[-1])
    sizes = [h for h in (128, 256, 512, 1024, 2048, 4096, 8192, 16384)
             if h <= max_hot and h <= cols]
    cov = {h: float(cum[h - 1]) / nnz for h in sizes}
    if cov[sizes[-1]] < min_coverage:
        return None

    def est_time(h):
        rate = min(_RATE_PEAK, _RATE_C / max(1, h // 128))
        return cov[h] / rate + (1.0 - cov[h]) / _RATE_COLD

    hot_size = min(sizes, key=est_time)
    # caching must pay: with no working set (uniform popularity) the
    # caller's packed or deep path is the plan
    if est_time(hot_size) >= 0.6 / _RATE_COLD:
        return None
    hot_ids = np.sort(order[:hot_size]).astype(np.int64)

    # split nonzeros by membership; remap hot columns ascending so CSR
    # indices stay sorted within rows
    remap = np.full(cols, -1, np.int64)
    remap[hot_ids] = np.arange(hot_size)
    indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    data = np.asarray(csr.data)
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    m = remap[indices]
    is_hot = m >= 0
    lens = np.diff(indptr)
    nz_row = np.repeat(np.arange(rows, dtype=np.int64), lens)
    hot_lens = np.bincount(nz_row[is_hot], minlength=rows)
    hot_csr = CSR(
        data=data[is_hot], indices=m[is_hot].astype(np.int32),
        indptr=np.concatenate(([0], np.cumsum(hot_lens))).astype(np.int32),
        shape=(rows, hot_size))
    cold_nnz = int((~is_hot).sum())
    kw = dict(value_dtype=value_dtype, lane_rows=lane_rows,
              positions=positions, max_window_blocks=max_window_blocks,
              pad_value=pad_value)
    # the compact domain makes the window or resident kernel apply by
    # construction
    hot_plan = _auto_sell_plan(hot_csr, allow_cached=False,
                               allow_packed=False, **kw)
    cold_plan = None
    if cold_nnz:
        cold_csr = CSR(
            data=data[~is_hot], indices=indices[~is_hot].astype(np.int32),
            indptr=np.concatenate(([0], np.cumsum(lens - hot_lens))
                                  ).astype(np.int32),
            shape=(rows, cols))
        cold_plan = _cold_plan(cold_csr, kw, allow_packed, levels)
    return CachedPlan(hot=hot_plan, cold=cold_plan,
                      hot_cols=hot_ids.astype(np.int32),
                      shape=(rows, cols),
                      coverage=float(nnz - cold_nnz) / nnz)


#: distinct-column cap of the full-cover compact tier (the resident
#: strategy's range, 64 blocks of 128)
FULL_COVER_MAX = 8192


def _compact_full_cover(csr: CSR, kw: dict) -> Optional[CachedPlan]:
    """One tier covering 100%: remap every nonzero column into a compact
    domain; None when there is nothing to compact or too much."""
    from .plan import _auto_sell_plan

    nz_cols = np.flatnonzero(column_frequency(csr))
    if (nz_cols.shape[0] == 0 or nz_cols.shape[0] > FULL_COVER_MAX
            or nz_cols.shape[0] == csr.shape[1]):
        return None
    rows, cols = csr.shape
    remap = np.full(cols, -1, np.int64)
    remap[nz_cols] = np.arange(nz_cols.shape[0])
    indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    hot_csr = CSR(data=np.asarray(csr.data),
                  indices=remap[indices].astype(np.int32),
                  indptr=np.asarray(csr.indptr),
                  shape=(rows, int(nz_cols.shape[0])))
    hot_plan = _auto_sell_plan(hot_csr, allow_cached=False,
                               allow_packed=False, **kw)
    return CachedPlan(hot=hot_plan, cold=None,
                      hot_cols=nz_cols.astype(np.int32),
                      shape=(rows, cols), coverage=1.0)


def _cold_plan(cold_csr: CSR, kw: dict, allow_packed: bool, levels: int):
    """Plan the popularity tail: a full-cover compact tier when its
    distinct columns fit one, a CooTail when tiny, another cache level
    while levels remain, else a packed plan when its volume amortizes the
    packed kernels' per-cell sweep, else a windowless SELL plan."""
    from .plan import _auto_sell_plan, _cdiv

    if cold_csr.nnz <= (1 << 20):
        fc = _compact_full_cover(cold_csr, kw)
        if fc is not None:
            return fc
    if cold_csr.nnz <= COO_TAIL_MAX:
        return coo_tail_from_csr(cold_csr, value_dtype=kw["value_dtype"])
    if levels > 1:
        cp = build_cached_plan(cold_csr, min_coverage=0.3,
                               allow_packed=allow_packed,
                               levels=levels - 1, **kw)
        if cp is not None:
            return cp
    rows, cols = cold_csr.shape
    if allow_packed:
        nwin = max(1, _cdiv(rows, 8192))
        nch = max(1, _cdiv(cols, 128 * 128))
        if cold_csr.nnz >= 100 * nwin * nch:
            from .packed import build_packed_plan

            return build_packed_plan(cold_csr,
                                     value_dtype=kw["value_dtype"])
    return _auto_sell_plan(cold_csr, allow_cached=False,
                           allow_packed=False, **kw)
