"""A placed plan carries its kernels' tables (``formats/tables.py``).

For a plan of each family whose apply reads a table (a windowless
SellPlan, a ChunkPlan, a PackedPlan, a CachedPlan, a HybridPlan and a
TriSolvePlan):

* placement fills every table of the plan and of the plans in it, and a
  host plan has none;
* ``dataclasses.replace`` of a placed plan carries its tables, and the
  copy applies bit for bit as the plan does;
* the layout layer stays below the kernels: no module under ``formats/``
  imports from ``ops/`` but its value helpers ``semiring`` and ``df64``
  (a scan of their sources).
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu_torch.formats import cached as pcached
from spmv_vector_cache_tpu_torch.formats import chunk as pchunk
from spmv_vector_cache_tpu_torch.formats import packed as ppacked
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.formats.convert import from_scipy
from spmv_vector_cache_tpu_torch.formats.dia import (HybridPlan,
                                                     build_dia_plan)
from spmv_vector_cache_tpu_torch.ops import sptrsv
from spmv_vector_cache_tpu_torch.ops.spmv_sell import spmv_plan

PORT = pathlib.Path(__file__).resolve().parents[1] / \
    "spmv_vector_cache_tpu_torch"
#: what ``formats/`` may import from ``ops/``: value helpers, no kernel
OPS_ALLOWED = {"ops.semiring", "ops.df64"}


def _csr(m):
    m = sp.csr_matrix(m, dtype=np.float32)
    m.sum_duplicates()
    m.sort_indices()
    return m


def _random(rows, cols, density, seed):
    rng = np.random.default_rng(seed)
    flat = rng.choice(rows * cols, int(rows * cols * density), replace=False)
    return _csr(sp.csr_matrix((rng.standard_normal(flat.shape[0]),
                               (flat // cols, flat % cols)),
                              shape=(rows, cols)))


def _windowless():
    plan = pplan.build_sell_plan(from_scipy(_random(300, 5000, 0.02, 4)),
                                 max_window_blocks=2)
    assert plan.stats.window_blocks == 0
    return plan, 5000


def _chunk(n=20000):
    # one dense heavy row (kernel D's slab), one sparse heavy row and a
    # light diagonal (the light route's records)
    rng = np.random.default_rng(5)
    r = np.concatenate([np.zeros(3000), np.full(2000, 7), np.arange(n)])
    c = np.concatenate([np.arange(5000, 8000),
                        np.sort(rng.choice(n, 2000, replace=False)),
                        np.arange(n)])
    m = sp.csr_matrix((rng.standard_normal(r.shape[0]), (r, c)),
                      shape=(n, n))
    return pchunk.build_chunk_plan(from_scipy(_csr(m))), n


def _packed():
    plan = ppacked.build_packed_plan(from_scipy(_random(50, 3000, 0.3, 1)),
                                     chunk_blocks=4)
    assert plan.stats.overflow_nnz > 0
    return plan, 3000


def _cached(rows=8192, cols=65536, per_row=32):
    # power-law column popularity: a window tier and a resident tier
    rng = np.random.default_rng(0)
    ranks = np.minimum(rng.zipf(1.6, size=rows * per_row) - 1, cols - 1)
    c = rng.permutation(cols)[ranks]
    m = sp.coo_matrix((rng.standard_normal(rows * per_row),
                       (np.repeat(np.arange(rows), per_row), c)),
                      shape=(rows, cols))
    return pcached.build_cached_plan(from_scipy(_csr(m))), cols


def _hybrid(n=2048):
    band = sp.diags([np.ones(n - 1), np.full(n, 2.0), np.ones(n - 1)],
                    [-1, 0, 1])
    return HybridPlan(dia=build_dia_plan(from_scipy(_csr(band)), sublanes=8),
                      rest=pplan.build_sell_plan(from_scipy(
                          _random(n, n, 0.01, 2)))), n


def _trisolve(n=300):
    rng = np.random.default_rng(3)
    m = sp.tril(sp.random(n, n, density=0.05, random_state=4), -1) + \
        sp.diags(rng.uniform(1.0, 2.0, n))
    return sptrsv.build_trisolve_plan(from_scipy(_csr(m)), lower=True), n


#: family -> (host plan and x's length, the tables its placement fills)
FAMILIES = {
    "sell_windowless": (_windowless, ["work"]),
    "chunk": (_chunk, ["light", "heavy"]),
    "packed": (_packed, ["tables"]),
    "cached": (_cached, ["hot.work", "cold.hot.work"]),
    "hybrid": (_hybrid, ["rest.work"]),
    "trisolve": (_trisolve, ["sweep"]),
}


def _get(plan, path):
    for name in path.split("."):
        plan = getattr(plan, name)
    return plan


def _apply(plan, x):
    if isinstance(plan, sptrsv.TriSolvePlan):
        return sptrsv.trisolve(plan, x)
    return spmv_plan(plan, x)


def _ops_imports(path: pathlib.Path) -> set:
    """What the source at ``path`` (a module of the port's ``formats/``)
    imports from ``ops/``, at any depth of its code: ``ops.<module>``,
    or ``ops`` itself and ``ops.<name>`` for the package's own names."""
    pkg = ["spmv_vector_cache_tpu_torch", "formats"]
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names = [f"{mod}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        for name in names:
            parts = name.split(".")
            if parts[:2] == ["spmv_vector_cache_tpu_torch", "ops"]:
                found.add(".".join(parts[1:3]))
    return found


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_placed_plans_carry_their_tables(family):
    make, paths = FAMILIES[family]
    host, ncols = make()
    placed = pplan.place(host, "cpu")
    for path in paths:
        assert _get(placed, path) is not None, path
        assert _get(host, path) is None, path
    # replace carries the tables: the copy reads the same ones, bit for bit
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        ncols).astype(np.float32))
    copy = dataclasses.replace(placed)
    for path in paths:
        assert _get(copy, path) is _get(placed, path), path
    y = _apply(placed, x)
    assert torch.equal(_apply(copy, x), y)
    assert torch.equal(_apply(placed, x), y)
    # formats/ holds layouts: of ops/ it imports only the value helpers
    for src in sorted((PORT / "formats").glob("*.py")):
        assert _ops_imports(src) <= OPS_ALLOWED, src.name
