"""Port parity: every ``formats/analysis.py`` function of the port against
the JAX package's, on random CSR, CSC and COO matrices made from numpy
seeds.  The functions are host numpy on both sides: results must be
equal (arrays byte for byte, counts and dicts exactly)."""

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_vector_cache_tpu.formats import analysis as janalysis
from spmv_vector_cache_tpu.formats import convert as jconvert
from spmv_vector_cache_tpu_torch.formats import analysis as panalysis
from spmv_vector_cache_tpu_torch.formats import convert as pconvert
from tests.test_torch_plan import banded, random_sparse


def _skewed_rows(seed):
    """Row lengths from 0 to 40, with ties, so that orderings matter."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 41, 300)
    r = np.repeat(np.arange(300), lens)
    c = rng.integers(0, 500, r.shape[0])
    m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=(300, 500))
    m.sum_duplicates()
    m.sort_indices()
    return m


MATRICES = {
    "random": lambda: random_sparse(400, 300, 0.03, seed=1),
    "banded": lambda: banded(512, [-40, -1, 0, 2, 77], seed=2),
    "skewed": lambda: _skewed_rows(3),
    "empty": lambda: sp.csr_matrix((64, 32), dtype=np.float32),
}
FORMATS = {
    "csr": lambda m: m.tocsr(),
    "csc": lambda m: m.tocsc(),
    "coo": lambda m: m.tocoo(),
}


def _both(name, fmt):
    m = FORMATS[fmt](MATRICES[name]())
    if fmt != "coo":
        m.sort_indices()
    return jconvert.from_scipy(m), pconvert.from_scipy(m)


def _equal(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b


CASES = [(m, f) for m in sorted(MATRICES) for f in sorted(FORMATS)]


@pytest.mark.parametrize("name,fmt", CASES)
@pytest.mark.parametrize("fn", ["max_alive", "bandwidth", "summarize",
                                "row_length_histogram",
                                "longest_row_first_permutation"])
def test_feature_matches_jax(fn, name, fmt):
    ja, pa = _both(name, fmt)
    _equal(getattr(panalysis, fn)(pa), getattr(janalysis, fn)(ja))


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("fn", ["row_spans", "column_working_set"])
def test_csr_feature_matches_jax(fn, name):
    ja, pa = _both(name, "csr")
    _equal(getattr(panalysis, fn)(pa), getattr(janalysis, fn)(ja))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_max_col_span_matches_jax(name):
    ja, pa = _both(name, "csc")
    _equal(panalysis.max_col_span(pa), janalysis.max_col_span(ja))


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("reverse", [False, True])
def test_row_markings_match_jax(name, reverse):
    ja, pa = _both(name, "coo")
    rows = np.asarray(pa.row)
    got = panalysis.mark_row_starts(rows, reverse=reverse)
    _equal(got, janalysis.mark_row_starts(np.asarray(ja.row),
                                          reverse=reverse))
    _equal(panalysis.mark_row_starts(rows, reverse=reverse,
                                     shift=panalysis.ROW_END_BIT),
           janalysis.mark_row_starts(rows, reverse=reverse,
                                     shift=janalysis.ROW_END_BIT))
    cleared = panalysis.clear_row_markings(got)
    _equal(cleared, janalysis.clear_row_markings(got))
    assert (cleared == rows.astype(np.uint32)).all()
    _equal(panalysis.first_touch_mask(rows, reverse=reverse),
           janalysis.first_touch_mask(rows, reverse=reverse))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_permute_rows_matches_jax(name):
    ja, pa = _both(name, "csr")
    perm = panalysis.longest_row_first_permutation(pa)
    got, want = panalysis.permute_rows(pa, perm), janalysis.permute_rows(
        ja, perm)
    for f in ("data", "indices", "indptr"):
        _equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)))
    assert tuple(got.shape) == tuple(want.shape)


def test_nz_rows_rejects_other_containers():
    with pytest.raises(TypeError, match="unsupported container"):
        panalysis._nz_rows(np.zeros((3, 3)))
