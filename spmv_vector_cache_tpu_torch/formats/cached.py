"""COO tail plans (part of the counterpart of
``spmv_vector_cache_tpu/formats/cached.py``).

:class:`CooTail` is what the planner's COO backstop builds for tiny
residues; its executor is a torch gather plus a segment reduce
(``ops/spmv_sell.py``), as the JAX package runs it in XLA outside Pallas.
The CachedPlan hot/cold split is not ported yet: the two entry points the
planner calls decide, as the reference does, whether it would build one,
and raise ``NotImplementedError`` when it would.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from .containers import CSR

Array = Any


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
    return CooTail(
        vals=np.asarray(csr.data).astype(value_dtype),
        cols=(np.asarray(csr.indices, dtype=np.int64)
              & 0x3FFFFFFF).astype(np.int32),
        rows_idx=rows_idx, shape=csr.shape)


def column_frequency(csr: CSR) -> np.ndarray:
    """Per-column nonzero counts (the popularity analysis)."""
    indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    return np.bincount(indices, minlength=csr.shape[1])


def _not_ported():
    return NotImplementedError(
        "the reference planner would build a CachedPlan here; that plan "
        "family is not ported yet (ROADMAP.md queue 1, item 6)")


#: the reference's hot-set sizing model (v5e rates, Gnnz/s), kept only so
#: that the port decides as the reference does
_RATE_PEAK = 90.0
_RATE_C = 200.0
_RATE_COLD = 2.0


def build_cached_plan(a, *, max_hot: int = 16384,
                      min_coverage: float = 0.5, **_) -> Optional[Any]:
    """None where the reference's ``build_cached_plan`` returns None (no
    popularity split pays); raises where it would build a CachedPlan."""
    from .plan import _as_csr

    csr = _as_csr(a)
    cols = csr.shape[1]
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

    if est_time(min(sizes, key=est_time)) >= 0.6 / _RATE_COLD:
        return None
    raise _not_ported()


#: distinct-column cap of the reference's full-cover compact tier
FULL_COVER_MAX = 8192


def _compact_full_cover(csr: CSR, kw: dict) -> Optional[Any]:
    """None where the reference's ``_compact_full_cover`` returns None
    (nothing to compact); raises where it would build a CachedPlan."""
    nz_cols = np.flatnonzero(column_frequency(csr))
    if (nz_cols.shape[0] == 0 or nz_cols.shape[0] > FULL_COVER_MAX
            or nz_cols.shape[0] == csr.shape[1]):
        return None
    raise _not_ported()
