"""Format conversions between CSR / CSC / COO (counterpart of
``spmv_vector_cache_tpu/formats/convert.py``; BSR and ELL come later).

All conversions run host-side in numpy and preserve the value dtype.
"""

from __future__ import annotations

import numpy as np

from .containers import COO, CSC, CSR

INDEX_DTYPE = np.int32


def _counting_transpose(indptr, indices, data, n_from: int, n_to: int):
    """Counting-sort transpose of a compressed (indptr/indices/data)
    triple; stability keeps minor indices sorted in the result."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data)

    counts = np.bincount(indices, minlength=n_to).astype(np.int64)
    out_indptr = np.zeros(n_to + 1, dtype=np.int64)
    np.cumsum(counts, out=out_indptr[1:])

    major = np.repeat(np.arange(n_from, dtype=INDEX_DTYPE),
                      np.diff(indptr).astype(np.int64))
    order = np.argsort(indices, kind="stable")
    out_indices = major[order]
    out_data = data[order]
    return out_indptr.astype(INDEX_DTYPE), out_indices.astype(INDEX_DTYPE), out_data


def csc_to_csr(a: CSC) -> CSR:
    indptr, indices, data = _counting_transpose(
        a.indptr, a.indices, a.data, a.shape[1], a.shape[0])
    return CSR(data=data, indices=indices, indptr=indptr, shape=a.shape)


def csr_to_coo(a: CSR) -> COO:
    row = np.repeat(np.arange(a.shape[0], dtype=INDEX_DTYPE),
                    np.diff(np.asarray(a.indptr)).astype(np.int64))
    return COO(data=np.asarray(a.data), row=row,
               col=np.asarray(a.indices).astype(INDEX_DTYPE), shape=a.shape)


def csc_to_coo(a: CSC) -> COO:
    col = np.repeat(np.arange(a.shape[1], dtype=INDEX_DTYPE),
                    np.diff(np.asarray(a.indptr)).astype(np.int64))
    return COO(data=np.asarray(a.data), row=np.asarray(a.indices).astype(INDEX_DTYPE),
               col=col, shape=a.shape)


def coo_to_csr(a: COO) -> CSR:
    order = np.lexsort((np.asarray(a.col), np.asarray(a.row)))
    row = np.asarray(a.row)[order]
    col = np.asarray(a.col)[order].astype(INDEX_DTYPE)
    data = np.asarray(a.data)[order]
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=a.shape[0]), out=indptr[1:])
    return CSR(data=data, indices=col, indptr=indptr.astype(INDEX_DTYPE),
               shape=a.shape)


def to_dense(a) -> np.ndarray:
    if isinstance(a, CSR):
        a = csr_to_coo(a)
    elif isinstance(a, CSC):
        a = csc_to_coo(a)
    out = np.zeros(a.shape, dtype=np.asarray(a.data).dtype)
    np.add.at(out, (np.asarray(a.row), np.asarray(a.col)), np.asarray(a.data))
    return out


def from_scipy(sp) -> CSR | CSC | COO:
    """Wrap a scipy.sparse matrix without copying its value buffer."""
    fmt = sp.format
    if fmt == "csr":
        return CSR(data=sp.data, indices=sp.indices.astype(INDEX_DTYPE),
                   indptr=sp.indptr.astype(INDEX_DTYPE), shape=tuple(sp.shape))
    if fmt == "csc":
        return CSC(data=sp.data, indices=sp.indices.astype(INDEX_DTYPE),
                   indptr=sp.indptr.astype(INDEX_DTYPE), shape=tuple(sp.shape))
    if fmt == "coo":
        return COO(data=sp.data, row=sp.row.astype(INDEX_DTYPE),
                   col=sp.col.astype(INDEX_DTYPE), shape=tuple(sp.shape))
    return from_scipy(sp.tocsr())
