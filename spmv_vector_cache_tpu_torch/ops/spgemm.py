"""SpGEMM: sparse x sparse matrix multiply (CSR x CSR -> CSR); counterpart
of ``spmv_vector_cache_tpu/ops/spgemm.py``.

A host-side **symbolic phase** (numpy, the reference's own, giving the
same arrays byte for byte) computes C's sparsity pattern and, for every
output nonzero, the list of (A-nz, B-nz) product pairs that feed it; the
**numeric phase** is two flat gathers and one sorted segment sum on the
plan's device, re-run for new values on the same pattern
(re-factorizations, graph contractions, AMG setup reuse).

The segment sum is ``index_add_`` into C.  On the card its atomics add
the products of one output nonzero in no fixed order, so an entry fed
by three or more products may differ in its last bits from run to run
(two products commute exactly; the CPU adds in product order).  The
deterministic alternative, ``torch.segment_reduce`` over the sorted
``out_id``, reduces one segment a CTA: on an H100 80GB HBM3 at 700 W it
took about 5 ms of device time on the suite's A @ A (4.2M products into
4.2M entries), 250 times its byte bound and 4 times cuSPARSE's whole
SpGEMM, where ``index_add_`` took 90 us with its gathers
(``chip_smoke.py``'s ``spgemm`` phase times both, PERF.md).  Neither phase reaches a Pallas
kernel in the reference, so both are torch ops here.  Unlike the reference, which truncates float64 A and B
to float32 when JAX runs without x64, C keeps the dtype of A's and B's
values (ROADMAP.md queue 3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..formats.containers import CSR

Array = Any


@dataclasses.dataclass(frozen=True)
class SpGemmPlan:
    """Symbolic product structure for C = A @ B on fixed patterns.

    ``a_src``/``b_src``: (nflops,) indices into A.data / B.data whose
    pairwise products feed C; ``out_id``: (nflops,) the C-nz each product
    accumulates into (sorted);  ``c_indptr``/``c_indices`` give C's CSR
    skeleton.  Arrays are numpy on the host and tensors once placed
    (``formats.plan.place``).
    """

    a_src: Array
    b_src: Array
    out_id: Array
    c_indptr: Array
    c_indices: Array
    c_shape: Tuple[int, int]
    c_nnz: int


def spgemm_symbolic(a: CSR, b: CSR) -> SpGemmPlan:
    """Host symbolic phase: expand all products, dedupe into C's pattern."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    a_indptr = np.asarray(a.indptr, dtype=np.int64)
    a_cols = np.asarray(a.indices, dtype=np.int64)
    b_indptr = np.asarray(b.indptr, dtype=np.int64)
    b_cols = np.asarray(b.indices, dtype=np.int64)

    # per A-nz: number of B-nz in row a_cols[e]
    b_rowlen = np.diff(b_indptr)
    counts = b_rowlen[a_cols]                       # (a_nnz,)
    nflops = int(counts.sum())
    a_src = np.repeat(np.arange(a_cols.shape[0], dtype=np.int64), counts)
    # position within the B row for each product
    within = np.arange(nflops, dtype=np.int64) - \
        np.repeat(np.cumsum(counts) - counts, counts)
    b_src = b_indptr[a_cols[a_src]] + within
    # output coordinate of each product
    a_rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                       np.diff(a_indptr))
    out_row = a_rows[a_src]
    out_col = b_cols[b_src]
    key = out_row * b.shape[1] + out_col
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_mask = np.ones(nflops, dtype=bool)
    if nflops:
        uniq_mask[1:] = key_s[1:] != key_s[:-1]
    out_id_s = np.cumsum(uniq_mask) - 1
    c_nnz = int(out_id_s[-1]) + 1 if nflops else 0

    c_keys = key_s[uniq_mask]
    c_rows = (c_keys // b.shape[1]) if nflops else np.zeros(0, np.int64)
    c_cols = (c_keys % b.shape[1]) if nflops else np.zeros(0, np.int64)
    c_indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(c_rows, minlength=a.shape[0]), out=c_indptr[1:])

    return SpGemmPlan(
        a_src=a_src[order].astype(np.int32),
        b_src=b_src[order].astype(np.int32),
        out_id=out_id_s.astype(np.int32),
        c_indptr=c_indptr.astype(np.int32),
        c_indices=c_cols.astype(np.int32),
        c_shape=(a.shape[0], b.shape[1]), c_nnz=c_nnz)


def spgemm_numeric(plan: SpGemmPlan, a_data, b_data) -> torch.Tensor:
    """Numeric phase on the placed plan's device: C.data for new values
    on the fixed pattern, in the dtype of ``a_data * b_data``.  Five
    launches and no host sync: the two gathers, the product, C's zeros
    and the segment sum."""
    dev = plan.out_id.device
    a_data = torch.as_tensor(a_data, device=dev)
    b_data = torch.as_tensor(b_data, device=dev)
    prods = a_data.index_select(0, plan.a_src) * \
        b_data.index_select(0, plan.b_src)
    # the reference sums into max(c_nnz, 1) segments and slices: the same
    # C, also when no product exists
    return prods.new_zeros(max(plan.c_nnz, 1)).index_add_(
        0, plan.out_id, prods)[:plan.c_nnz]


def spgemm(a: CSR, b: CSR, *, plan: SpGemmPlan | None = None,
           device="cuda") -> Tuple[CSR, SpGemmPlan]:
    """C = A @ B.  Returns (C, plan), C's arrays and the plan on
    ``device`` (the card unless the caller asks for ``"cpu"``); pass
    ``plan`` back in to reuse the symbolic phase on a matching pattern
    (a host plan is placed on ``device`` first)."""
    from ..formats.plan import place

    if plan is None:
        plan = spgemm_symbolic(a, b)
    if not isinstance(plan.out_id, torch.Tensor):
        plan = place(plan, torch.device(device))
    data = spgemm_numeric(plan, a.data, b.data)
    c = CSR(data=data, indices=plan.c_indices, indptr=plan.c_indptr,
            shape=plan.c_shape)
    return c, plan


def spgemm_host(a: CSR, b: CSR) -> CSR:
    """One-shot host SpGEMM (scipy-backed) — the CPU reference path."""
    import scipy.sparse as sp

    am = sp.csr_matrix((np.asarray(a.data), np.asarray(a.indices),
                        np.asarray(a.indptr)), shape=a.shape)
    bm = sp.csr_matrix((np.asarray(b.data), np.asarray(b.indices),
                        np.asarray(b.indptr)), shape=b.shape)
    cm = (am @ bm).tocsr()
    cm.sort_indices()
    return CSR(data=cm.data, indices=cm.indices.astype(np.int32),
               indptr=cm.indptr.astype(np.int32), shape=tuple(cm.shape))
