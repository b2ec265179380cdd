"""Degree-calibrated stand-ins for the reference's evaluation suite
(counterpart of ``spmv_vector_cache_tpu/tools/realistic.py``).

Five generators reproduce the structural features behind SpMV plan selection
-- dimensions, nnz, row-degree distribution, bandwidth locality, block
structure -- of five SuiteSparse matrices of the Williams SpMV suite
(Davis & Hu, TOMS 2011; Williams et al., SC'07).  They are the JAX
package's generators on the port's containers: the same seeds give the
same CSR arrays byte for byte (``tests/test_torch_realistic.py``), so
the GPU machine, which has no JAX, builds the same matrices.
"""

from __future__ import annotations

import numpy as np

from ..formats.containers import COO
from ..formats.convert import coo_to_csr


def _to_csr(rows, cols, shape, rng, sym_diag=True):
    rows = np.asarray(rows, np.int64)
    cols = np.clip(np.asarray(cols, np.int64), 0, shape[1] - 1)
    if sym_diag:
        d = np.arange(shape[0], dtype=np.int64)
        rows = np.concatenate([rows, d])
        cols = np.concatenate([cols, d])
    key = rows * shape[1] + cols
    key = np.unique(key)
    rows = (key // shape[1]).astype(np.int32)
    cols = (key % shape[1]).astype(np.int32)
    data = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return coo_to_csr(COO(data=data, row=rows, col=cols, shape=shape))


def scircuit_like():
    """Hamm/scircuit: 170,998^2, ~959K nnz (~5.6/row) circuit matrix —
    strong diagonal, short power-law rows, a handful of near-dense
    rail/clock rows and columns, off-diagonals clustered near the
    diagonal with a long-range tail."""
    n = 170_998
    rng = np.random.default_rng(42)
    lens = np.minimum(rng.zipf(2.2, n) + 1, 353)      # mean ~2.1 + diag
    hubs = rng.choice(n, 24, replace=False)           # rail/clock nets
    lens[hubs] = rng.integers(2_000, 25_000, 24)
    r = np.repeat(np.arange(n), lens)
    near = rng.random(r.shape[0]) < 0.8
    off = np.where(near,
                   (rng.standard_normal(r.shape[0]) * 900).astype(np.int64),
                   rng.integers(-n, n, r.shape[0]))
    return _to_csr(r, r + off, (n, n), rng)


def webbase_like():
    """Williams/webbase-1M: 1,000,005^2, ~3.1M nnz (~3.1/row) web link
    graph — power-law out-degree rows AND in-degree columns (zipf column
    popularity), weak locality, a few huge hub rows."""
    n = 1_000_005
    rng = np.random.default_rng(43)
    lens = np.minimum(rng.zipf(2.1, n), 4700)
    hubs = rng.choice(n, 60, replace=False)           # directory pages
    lens[hubs] = rng.integers(1_000, 4_700, 60)
    r = np.repeat(np.arange(n), lens)
    # zipf-popular columns, shuffled so popularity carries no locality;
    # hub rows link widely (uniform targets) like real directory pages
    ranks = rng.zipf(1.9, r.shape[0]).astype(np.int64)
    cperm = rng.permutation(n)
    c = cperm[np.minimum(ranks - 1, n - 1)]
    wide = np.isin(r, hubs)
    c[wide] = rng.integers(0, n, int(wide.sum()))
    return _to_csr(r, c, (n, n), rng)


def mac_econ_like():
    """Williams/mac_econ_fwd500: 206,500^2, ~1.27M nnz (~6.2/row)
    macroeconomic model — near-uniform short rows, moderate banded
    locality from the variable ordering."""
    n = 206_500
    rng = np.random.default_rng(44)
    lens = rng.integers(1, 11, n)
    r = np.repeat(np.arange(n), lens)
    off = (rng.standard_normal(r.shape[0]) * 12_000).astype(np.int64)
    return _to_csr(r, r + off, (n, n), rng)


def cant_like():
    """Williams/cant: 62,451^2, ~4.01M nnz (~64/row) FEM cantilever —
    3-DOF nodal blocks (rows come in 3s with identical sparsity),
    ~21 neighbor nodes within a narrow band."""
    n = 62_451
    rng = np.random.default_rng(45)
    nodes = n // 3
    nbr = 21
    node_r = np.repeat(np.arange(nodes), nbr)
    node_c = node_r + (rng.standard_normal(node_r.shape[0])
                       * 220).astype(np.int64)
    node_c = np.clip(node_c, 0, nodes - 1)
    # expand each (node, node) pair to a dense 3x3 block
    br = np.repeat(node_r * 3, 9) + np.tile(np.repeat(np.arange(3), 3),
                                            node_r.shape[0])
    bc = np.repeat(node_c * 3, 9) + np.tile(np.tile(np.arange(3), 3),
                                            node_r.shape[0])
    return _to_csr(br, bc, (n, n), rng)


def qcd_like():
    """QCD/conf5_4-8x8-05: 49,152^2, 1.92M nnz (exactly 39/row) lattice
    gauge theory — perfectly regular rows, neighbors at fixed 4-D
    lattice strides (the structured end of the suite)."""
    n = 49_152                     # 8*8*8*8 sites x 12 spin-color
    rng = np.random.default_rng(46)
    sites = n // 12
    # 8 lattice neighbors per site at strides +-1, +-8, +-64, +-512
    strides = np.array([1, -1, 8, -8, 64, -64, 512, -512])
    site = np.arange(sites)
    nbrs = (site[:, None] + strides[None, :]) % sites
    # each (site, nbr) couples 12x12/38ths — sample 38 nnz/row + diag
    r = np.repeat(np.arange(n), 38)
    k = rng.integers(0, 8, r.shape[0])
    c = nbrs[(r // 12), k] * 12 + rng.integers(0, 12, r.shape[0])
    return _to_csr(r, c, (n, n), rng)


#: name -> (generator, published dims/nnz note)
MATRICES = {
    "scircuit_like": (scircuit_like, "Hamm/scircuit 171K^2 ~959K nnz"),
    "webbase_like": (webbase_like, "Williams/webbase-1M 1M^2 ~3.1M nnz"),
    "mac_econ_like": (mac_econ_like,
                      "Williams/mac_econ_fwd500 206K^2 ~1.27M nnz"),
    "cant_like": (cant_like, "Williams/cant 62K^2 ~4.0M nnz"),
    "qcd_like": (qcd_like, "QCD/conf5_4-8x8-05 49K^2 1.92M nnz"),
}


def generate(name: str):
    gen, _ = MATRICES[name]
    return gen()
