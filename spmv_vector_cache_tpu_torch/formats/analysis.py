"""Matrix-structure analyses that drive plan selection (counterpart of
``spmv_vector_cache_tpu/formats/analysis.py``).  Vectorized numpy,
host-side.

* ``mark_row_starts`` / ``clear_row_markings`` — tag the first (or last)
  nonzero of every row with a high bit of its row index, and strip it;
* ``max_alive`` — peak number of simultaneously live rows in nonzero
  order (a lower bound on the y working set);
* ``max_col_span`` — max row-index spread within one column;
* ``row_spans`` / ``column_working_set`` — their CSR duals over x;
* ``row_length_histogram`` / ``longest_row_first_permutation`` /
  ``permute_rows`` — load-balance analyses;
* ``bandwidth`` — max |row - col| (the sharded plans' halo width);
* ``summarize`` — all of them in one dict.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .containers import COO, CSC, CSR
from .convert import coo_to_csr, csc_to_coo, csr_to_coo

ROW_START_BIT = 31   # bit 31 marks a row's first nonzero
ROW_END_BIT = 30     # bit 30 marks a row's last nonzero
INDEX_MASK = 0x3FFFFFFF


def _nz_rows(a) -> np.ndarray:
    """Row index of every nonzero, in storage (nz) order."""
    if isinstance(a, CSC):
        return np.asarray(a.indices)
    if isinstance(a, CSR):
        return np.asarray(csr_to_coo(a).row)
    if isinstance(a, COO):
        return np.asarray(a.row)
    raise TypeError(f"unsupported container {type(a)}")


def first_touch_mask(row_ids: np.ndarray, reverse: bool = False) -> np.ndarray:
    """Boolean mask: is this entry the first occurrence of its id (or the
    last, if ``reverse``) in storage order?"""
    rows = np.asarray(row_ids, dtype=np.int64) & INDEX_MASK
    n = rows.shape[0]
    if reverse:
        rows = rows[::-1]
    order = np.argsort(rows, kind="stable")
    sorted_rows = rows[order]
    is_first_sorted = np.ones(n, dtype=bool)
    is_first_sorted[1:] = sorted_rows[1:] != sorted_rows[:-1]
    mask = np.zeros(n, dtype=bool)
    mask[order] = is_first_sorted
    if reverse:
        mask = mask[::-1]
    return mask


def mark_row_starts(indices: np.ndarray, reverse: bool = False,
                    shift: int = ROW_START_BIT) -> np.ndarray:
    """A copy of ``indices`` with bit ``shift`` set on the first
    (``reverse=False``) or last (``reverse=True``) nonzero of each row."""
    idx = np.asarray(indices).astype(np.uint32).copy()
    mask = first_touch_mask(idx, reverse=reverse)
    idx[mask] |= np.uint32(1 << shift)
    return idx


def clear_row_markings(indices: np.ndarray) -> np.ndarray:
    """Strip the start/end marker bits."""
    return (np.asarray(indices).astype(np.uint32) & np.uint32(INDEX_MASK))


def max_alive(a) -> int:
    """Peak simultaneously-live row count over the nz stream: +1 at each
    row's first nonzero, -1 at its last."""
    return _peak_alive(np.asarray(_nz_rows(a), dtype=np.int64) & INDEX_MASK)


def _peak_alive(ids: np.ndarray) -> int:
    """Peak count of ids live at once in storage order: each id is live
    from its first entry to its last."""
    if ids.shape[0] == 0:
        return 0
    # +start and -end of the same entry apply in one step, and the max is
    # taken after both: a cumsum of the net delta
    alive = np.cumsum(first_touch_mask(ids).astype(np.int64)
                      - first_touch_mask(ids, reverse=True).astype(np.int64))
    return int(alive.max())


def max_col_span(a: CSC) -> int:
    """Max (last - first) row index within any column, indices sorted."""
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64) & INDEX_MASK
    starts, ends = indptr[:-1], indptr[1:]
    nonempty = ends > starts
    if not nonempty.any():
        return 0
    first = indices[starts[nonempty]]
    last = indices[ends[nonempty] - 1]
    return int((last - first).max())


def _row_lengths(a) -> np.ndarray:
    if isinstance(a, CSR):
        return np.diff(np.asarray(a.indptr))
    return np.bincount(np.asarray(_nz_rows(a), dtype=np.int64) & INDEX_MASK,
                       minlength=a.shape[0])


def row_length_histogram(a) -> Dict[int, int]:
    """Histogram of nonzeros per row."""
    vals, counts = np.unique(_row_lengths(a), return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def longest_row_first_permutation(a) -> np.ndarray:
    """Row permutation sorting rows by descending nonzero count (stable
    in row order for ties); apply with :func:`permute_rows`."""
    return np.argsort(-_row_lengths(a).astype(np.int64), kind="stable")


def permute_rows(a: CSR, perm: np.ndarray) -> CSR:
    """Apply a row permutation: new row i = old row perm[i]."""
    coo = csr_to_coo(a)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return coo_to_csr(COO(data=np.asarray(coo.data),
                          row=inv[np.asarray(coo.row)].astype(np.int32),
                          col=np.asarray(coo.col), shape=a.shape))


def row_spans(a: CSR) -> np.ndarray:
    """Per-row (last - first) column index, sorted indices; empty rows
    report 0."""
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64) & INDEX_MASK
    starts, ends = indptr[:-1], indptr[1:]
    spans = np.zeros(a.shape[0], np.int64)
    nonempty = ends > starts
    spans[nonempty] = (indices[ends[nonempty] - 1]
                       - indices[starts[nonempty]])
    return spans


def column_working_set(a: CSR) -> int:
    """Peak simultaneously-live column count over the row-major nonzero
    stream: how many x entries are in flight while a kernel sweeps rows."""
    return _peak_alive(np.asarray(a.indices, dtype=np.int64) & INDEX_MASK)


def bandwidth(a) -> int:
    """Matrix bandwidth: max |row - col| over nonzeros."""
    if isinstance(a, CSC):
        coo = csc_to_coo(a)
    elif isinstance(a, CSR):
        coo = csr_to_coo(a)
    else:
        coo = a
    if coo.data.shape[0] == 0:
        return 0
    return int(np.abs(np.asarray(coo.row, dtype=np.int64)
                      - np.asarray(coo.col, dtype=np.int64)).max())


def summarize(a) -> Dict[str, int]:
    """All the features in one dict, under the reference's stat keys."""
    out = {
        "rows": a.shape[0],
        "cols": a.shape[1],
        "nnz": int(np.asarray(_nz_rows(a)).shape[0]),
        "maxAlive": max_alive(a),
        "bandwidth": bandwidth(a),
    }
    if isinstance(a, CSC):
        out["maxColSpan"] = max_col_span(a)
    if isinstance(a, CSR):
        spans = row_spans(a)
        out["maxRowSpan"] = int(spans.max()) if spans.size else 0
        out["columnWorkingSet"] = column_working_set(a)
    return out
