"""Matrix-structure analyses that drive plan selection (counterpart of
``spmv_vector_cache_tpu/formats/analysis.py``; the two that
``_auto_sell_plan`` reads).  Vectorized numpy, host-side."""

from __future__ import annotations

import numpy as np

from .containers import CSR

INDEX_MASK = 0x3FFFFFFF


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
    indices = np.asarray(a.indices, dtype=np.int64) & INDEX_MASK
    if indices.shape[0] == 0:
        return 0
    alive = np.cumsum(
        first_touch_mask(indices).astype(np.int64)
        - first_touch_mask(indices, reverse=True).astype(np.int64))
    return int(alive.max())
