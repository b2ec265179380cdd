"""Port parity: the port's plan builders against the JAX package's.

The same matrix, made from a seed with numpy, goes through both
packages' planners; the plans must be equal byte for byte (arrays, dtypes,
shapes and stats).  These helpers are shared by the other
``tests/test_torch_*.py`` files.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_vector_cache_tpu.formats import convert as jconvert
from spmv_vector_cache_tpu.formats import dia as jdia
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu_torch.formats import convert as pconvert
from spmv_vector_cache_tpu_torch.formats import dia as pdia
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.interop import (plan_from_reference,
                                                 plan_to_numpy)


# ---------------------------------------------------------------------------
# shared matrices: scipy CSR (float32, sorted) from a seed
# ---------------------------------------------------------------------------

def banded(n, offs, seed=0, cols=None):
    rng = np.random.default_rng(seed)
    cols = cols or n
    m = sp.spdiags(rng.standard_normal((len(offs), max(n, cols))).astype(
        np.float32), offs, n, cols).tocsr()
    m.sort_indices()
    return m.astype(np.float32)


def shuffled_band(n, seed=0, per_row=27, blk=128):
    """bench.py's shuffled band: ``per_row`` nonzeros per row at random
    columns inside the row's ``blk``-column block."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n, dtype=np.int64), per_row)
    c = (r // blk) * blk + rng.integers(0, blk, r.shape[0])
    m = sp.coo_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=(n, n)).tocsr()
    m.sort_indices()
    return m


def hybrid(n, seed=0, width=512):
    """27-diagonal band plus ~2 nonzeros per row within +-width of the
    diagonal: a HybridPlan with a window SellPlan residual."""
    rng = np.random.default_rng(seed)
    band = sp.spdiags(rng.standard_normal((27, n)).astype(np.float32),
                      list(range(-13, 14)), n, n).tocsr()
    r = np.repeat(np.arange(n, dtype=np.int64), 2)
    c = np.clip(r + rng.integers(-width, width + 1, r.shape[0]), 0, n - 1)
    res = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                         (r, c)), shape=(n, n))
    m = (band + res).tocsr().astype(np.float32)
    m.sort_indices()
    return m


def random_sparse(rows, cols, density, seed=0, nonneg=False):
    rng = np.random.default_rng(seed)
    m = sp.random(rows, cols, density=density, format="csr",
                  random_state=np.random.RandomState(seed),
                  dtype=np.float64)
    if not nonneg:
        m.data = rng.standard_normal(m.data.shape[0])
    m = m.astype(np.float32)
    m.sort_indices()
    return m


def both(m):
    """(JAX-package container, port container) of one scipy matrix."""
    return jconvert.from_scipy(m), pconvert.from_scipy(m)


# ---------------------------------------------------------------------------
# plan equality
# ---------------------------------------------------------------------------

def assert_plans_equal(port_plan, ref_plan, path="plan"):
    """Byte equality of a port plan with a JAX-package plan."""
    ref = plan_to_numpy(plan_from_reference(ref_plan, "cpu"))
    port = plan_to_numpy(port_plan)
    _assert_same(port, ref, path)


def _assert_same(port, ref, path):
    assert type(port).__name__ == type(ref).__name__, path
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        where = f"{path}.{f.name}"
        if f.name == "stats":
            assert a.as_dict() == b.as_dict(), where
        elif dataclasses.is_dataclass(b):
            _assert_same(a, b, where)
        elif isinstance(b, tuple) and b and dataclasses.is_dataclass(b[0]):
            assert isinstance(a, tuple) and len(a) == len(b), where
            for i, (pa, pb) in enumerate(zip(a, b)):
                _assert_same(pa, pb, f"{where}[{i}]")
        elif isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), where
            assert (a.dtype, a.shape) == (b.dtype, b.shape), where
            assert a.tobytes() == b.tobytes(), where
        else:
            assert a == b, where


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

SELL_CASES = {
    "plain": (lambda: random_sparse(300, 200, 0.05, seed=1), {}),
    "split_sigma": (lambda: random_sparse(400, 300, 0.05, seed=2),
                    dict(split=8, sigma=512)),
    "uniform_split": (lambda: shuffled_band(2048, seed=3),
                      dict(split=16, uniform_split=True,
                           window_group_tiles=2)),
    "stripe_width": (lambda: random_sparse(300, 5000, 0.02, seed=4),
                     dict(stripe_width=512, max_window_blocks=4)),
    "grain32": (lambda: banded(1500, [-60, -3, 0, 5, 70], seed=5),
                dict(window_grain=32)),
    "grain64": (lambda: banded(1500, [-60, -3, 0, 5, 70], seed=5),
                dict(window_grain=64)),
    "grain128": (lambda: banded(1500, [-60, -3, 0, 5, 70], seed=5),
                 dict(window_grain=128)),
}


@pytest.mark.parametrize("case", sorted(SELL_CASES))
def test_build_sell_plan_byte_equal(case):
    make, kw = SELL_CASES[case]
    ja, pa = both(make())
    port = pplan.build_sell_plan(pa, **kw)
    assert_plans_equal(port, jplan.build_sell_plan(ja, **kw))
    assert port.stats.window_blocks > 0
    pplan.validate_plan(port, pa)


def test_split_diagonal_byte_equal():
    ja, pa = both(hybrid(4096, seed=6))
    jd, jr, jcov = jdia.split_diagonal(ja)
    pd, pr, pcov = pdia.split_diagonal(pa)
    assert pcov == jcov and 0 < pcov < 1
    assert np.asarray(pd.offsets).tobytes() == \
        np.asarray(jd.offsets).tobytes()
    assert pd.data.tobytes() == np.asarray(jd.data).tobytes()
    for f in ("data", "indices", "indptr"):
        a, b = getattr(pr, f), np.asarray(getattr(jr, f))
        assert (a.dtype, a.tobytes()) == (b.dtype, b.tobytes()), f


@pytest.mark.parametrize("offs,rows,cols", [
    ([-1, 0, 1], 700, 700),
    ([-130, -7, 0, 3, 200], 700, 700),
    ([-1025, 0, 1300], 3000, 3000),
    ([0, 200], 300, 520),
])
def test_build_dia_plan_byte_equal(offs, rows, cols):
    ja, pa = both(banded(rows, offs, seed=7, cols=cols))
    assert_plans_equal(pdia.build_dia_plan(pa, sublanes=8),
                       jdia.build_dia_plan(ja, sublanes=8))


AUTO_CASES = {
    "banded": (lambda: banded(4096, list(range(-13, 14)), seed=8),
               "DiaPlan"),
    "shuffled_band": (lambda: shuffled_band(4096, seed=9), "SellPlan"),
    "hybrid": (lambda: hybrid(32768, seed=10), "HybridPlan"),
}


@pytest.mark.parametrize("case", sorted(AUTO_CASES))
def test_auto_plan_same_plan(case):
    make, kind = AUTO_CASES[case]
    ja, pa = both(make())
    port = pplan.auto_plan(pa)
    assert type(port).__name__ == kind
    assert_plans_equal(port, jplan.auto_plan(ja))


def test_auto_plan_skewed_rows_raise_not_ported():
    # skewed row lengths enter the reference's ChunkPlan branch; the port
    # no longer raises there but builds the reference's ChunkPlan, array
    # for array
    n, cols = 4096, 1024
    lens = np.where(np.arange(n) % 100 == 0, cols, 2)
    r = np.repeat(np.arange(n, dtype=np.int64), lens)
    c = np.random.default_rng(11).integers(0, cols, r.shape[0])
    m = sp.csr_matrix((np.ones(r.shape[0], np.float32), (r, c)),
                      shape=(n, cols))
    m.sort_indices()
    ja, pa = both(m)
    port = pplan.auto_plan(pa)
    assert type(port).__name__ == "ChunkPlan"
    assert_plans_equal(port, jplan.auto_plan(ja))
