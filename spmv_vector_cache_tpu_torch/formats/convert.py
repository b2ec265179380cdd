"""Format conversions between CSR / CSC / COO / BSR / ELL (counterpart of
``spmv_vector_cache_tpu/formats/convert.py``).

All conversions run host-side in numpy and preserve the value dtype;
each gives the same arrays, byte for byte, as the reference's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .containers import BSR, COO, CSC, CSR, ELL

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


def csr_to_csc(a: CSR) -> CSC:
    indptr, indices, data = _counting_transpose(
        a.indptr, a.indices, a.data, a.shape[0], a.shape[1])
    return CSC(data=data, indices=indices, indptr=indptr, shape=a.shape)


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


def _compress(major, minor, data, n_major: int):
    """COO triples -> (indptr, minor indices, data), sorted by (major,
    minor)."""
    order = np.lexsort((np.asarray(minor), np.asarray(major)))
    major = np.asarray(major)[order]
    out_minor = np.asarray(minor)[order].astype(INDEX_DTYPE)
    out_data = np.asarray(data)[order]
    indptr = np.zeros(n_major + 1, dtype=np.int64)
    np.cumsum(np.bincount(major, minlength=n_major), out=indptr[1:])
    return indptr.astype(INDEX_DTYPE), out_minor, out_data


def coo_to_csr(a: COO) -> CSR:
    indptr, col, data = _compress(a.row, a.col, a.data, a.shape[0])
    return CSR(data=data, indices=col, indptr=indptr, shape=a.shape)


def coo_to_csc(a: COO) -> CSC:
    indptr, row, data = _compress(a.col, a.row, a.data, a.shape[1])
    return CSC(data=data, indices=row, indptr=indptr, shape=a.shape)


def csr_to_ell(a: CSR, width: int | None = None) -> ELL:
    """Pad each row to a fixed width (ELLPACK); padding slots get value
    0 and column 0."""
    indptr = np.asarray(a.indptr).astype(np.int64)
    lens = np.diff(indptr)
    w = int(width if width is not None else (lens.max() if lens.size else 0))
    if lens.size and lens.max() > w:
        raise ValueError(f"ELL width {w} < max row length {int(lens.max())}")
    rows = a.shape[0]
    data = np.zeros((rows, w), dtype=np.asarray(a.data).dtype)
    idx = np.zeros((rows, w), dtype=INDEX_DTYPE)
    within = np.arange(indptr[-1], dtype=np.int64) - np.repeat(indptr[:-1], lens)
    rr = np.repeat(np.arange(rows, dtype=np.int64), lens)
    data[rr, within] = np.asarray(a.data)
    idx[rr, within] = np.asarray(a.indices)
    return ELL(data=data, indices=idx, shape=a.shape)


def ell_to_csr(a: ELL) -> CSR:
    """Inverse of :func:`csr_to_ell`: drops the (value 0, column 0)
    padding slots, and with them any stored explicit zero at column 0."""
    data = np.asarray(a.data)
    idx = np.asarray(a.indices)
    keep = ~((data == 0) & (idx == 0))
    rows_id = np.broadcast_to(np.arange(a.shape[0])[:, None], data.shape)[keep]
    coo = COO(data=data[keep], row=rows_id.astype(INDEX_DTYPE),
              col=idx[keep].astype(INDEX_DTYPE), shape=a.shape)
    return coo_to_csr(coo)


def csr_to_bsr(a: CSR, blocksize: Tuple[int, int]) -> BSR:
    """Gather nonzeros into dense (br, bc) blocks on a block-CSR skeleton."""
    br, bc = blocksize
    rows, cols = a.shape
    if rows % br or cols % bc:
        raise ValueError(f"shape {a.shape} not divisible by blocksize {blocksize}")
    coo = csr_to_coo(a)
    brow = np.asarray(coo.row) // br
    bcol = np.asarray(coo.col) // bc
    # unique (brow, bcol) pairs in row-major block order
    key = brow.astype(np.int64) * (cols // bc) + bcol
    uniq, inverse = np.unique(key, return_inverse=True)
    data = np.zeros((uniq.shape[0], br, bc), dtype=np.asarray(a.data).dtype)
    data[inverse, np.asarray(coo.row) % br, np.asarray(coo.col) % bc] = \
        np.asarray(coo.data)
    block_rows = (uniq // (cols // bc)).astype(np.int64)
    indices = (uniq % (cols // bc)).astype(INDEX_DTYPE)
    indptr = np.zeros(rows // br + 1, dtype=np.int64)
    np.cumsum(np.bincount(block_rows, minlength=rows // br), out=indptr[1:])
    return BSR(data=data, indices=indices, indptr=indptr.astype(INDEX_DTYPE),
               shape=a.shape, blocksize=(br, bc))


def bsr_to_csr(a: BSR) -> CSR:
    """Blocks back to CSR, dropping the zeros stored inside blocks."""
    br, bc = a.blocksize
    data = np.asarray(a.data)
    lens = np.diff(np.asarray(a.indptr).astype(np.int64))
    block_row = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    r = (block_row[:, None, None] * br
         + np.arange(br)[None, :, None]).astype(np.int64)
    c = (np.asarray(a.indices).astype(np.int64)[:, None, None] * bc
         + np.arange(bc)[None, None, :])
    r = np.broadcast_to(r, data.shape).reshape(-1)
    c = np.broadcast_to(c, data.shape).reshape(-1)
    v = data.reshape(-1)
    keep = v != 0
    coo = COO(data=v[keep], row=r[keep].astype(INDEX_DTYPE),
              col=c[keep].astype(INDEX_DTYPE), shape=a.shape)
    return coo_to_csr(coo)


def to_dense(a) -> np.ndarray:
    if isinstance(a, CSR):
        a = csr_to_coo(a)
    elif isinstance(a, CSC):
        a = csc_to_coo(a)
    elif isinstance(a, BSR):
        a = csr_to_coo(bsr_to_csr(a))
    elif isinstance(a, ELL):
        a = csr_to_coo(ell_to_csr(a))
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
