"""Port parity: the BSR and ELL containers, the format conversions and the
torch reference executors against the JAX package's.

* every conversion gives the same arrays, byte for byte (dtype, shape,
  bytes), as ``spmv_vector_cache_tpu.formats.convert``;
* ``reference.spmv`` on CSC, COO, ELL and BSR, for each of the five
  semirings the reference defines there, matches JAX ``reference.spmv``
  to rtol = atol = 2e-5 (the reference's own SpMM tolerance), with the
  same infinities; where the reference has no executor (or_and on ELL
  and BSR) the port raises;
* ``reference.spmm`` on BSR, CSR, CSC and COO matches JAX
  ``reference.spmm`` to 2e-5, and raises for any semiring but
  plus_times.
"""

import numpy as np
import pytest
import torch

from spmv_vector_cache_tpu.formats import convert as jconvert
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu_torch.formats import convert as pconvert
from spmv_vector_cache_tpu_torch.ops import reference as pref
from tests.test_torch_plan import random_sparse

SEMIRINGS = ("plus_times", "min_plus", "max_plus", "max_times", "or_and")
TOL = dict(rtol=2e-5, atol=2e-5)


def _csr_pair(seed=1, rows=96, cols=64, density=0.08, nonneg=False):
    m = random_sparse(rows, cols, density, seed=seed, nonneg=nonneg)
    return jconvert.from_scipy(m), pconvert.from_scipy(m)


def _assert_same_arrays(got, want):
    assert type(got).__name__ == type(want).__name__
    for name in ("data", "indices", "indptr", "row", "col"):
        if not hasattr(want, name):
            continue
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert isinstance(a, np.ndarray), name
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        assert a.tobytes() == b.tobytes(), name
    assert tuple(got.shape) == tuple(want.shape)
    if hasattr(want, "blocksize"):
        assert tuple(got.blocksize) == tuple(want.blocksize)


#: name -> conversion of the CSR pair, applied in each package
CONVERSIONS = {
    "csr_to_csc": lambda c, a: c.csr_to_csc(a),
    "coo_to_csc": lambda c, a: c.coo_to_csc(c.csr_to_coo(a)),
    "csr_to_ell": lambda c, a: c.csr_to_ell(a),
    "csr_to_ell_width": lambda c, a: c.csr_to_ell(a, width=20),
    "ell_to_csr": lambda c, a: c.ell_to_csr(c.csr_to_ell(a)),
    "csr_to_bsr_8x8": lambda c, a: c.csr_to_bsr(a, (8, 8)),
    "csr_to_bsr_4x2": lambda c, a: c.csr_to_bsr(a, (4, 2)),
    "bsr_to_csr": lambda c, a: c.bsr_to_csr(c.csr_to_bsr(a, (8, 4))),
}


@pytest.mark.parametrize("name", sorted(CONVERSIONS))
def test_conversion_byte_equal(name):
    ja, pa = _csr_pair()
    conv = CONVERSIONS[name]
    _assert_same_arrays(conv(pconvert, pa), conv(jconvert, ja))


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "bsr", "ell"])
def test_to_dense_byte_equal(fmt):
    ja, pa = _csr_pair(seed=2)
    make = {"csr": lambda c, a: a, "csc": lambda c, a: c.csr_to_csc(a),
            "coo": lambda c, a: c.csr_to_coo(a),
            "bsr": lambda c, a: c.csr_to_bsr(a, (8, 8)),
            "ell": lambda c, a: c.csr_to_ell(a)}[fmt]
    got = pconvert.to_dense(make(pconvert, pa))
    want = jconvert.to_dense(make(jconvert, ja))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_conversions_reject_what_the_reference_rejects():
    ja, pa = _csr_pair(seed=3)
    for c, a in ((jconvert, ja), (pconvert, pa)):
        with pytest.raises(ValueError, match="not divisible"):
            c.csr_to_bsr(a, (5, 8))
        with pytest.raises(ValueError, match="ELL width"):
            c.csr_to_ell(a, width=1)


def _container(c, a, fmt):
    return {"csr": lambda: a, "csc": lambda: c.csr_to_csc(a),
            "coo": lambda: c.csr_to_coo(a),
            "ell": lambda: c.csr_to_ell(a),
            "bsr": lambda: c.csr_to_bsr(a, (8, 8))}[fmt]()


def _semiring_data(semiring, seed):
    """A matrix pair and x for a semiring: non-negative for max_times,
    {0, 1} for or_and, as the reference's semiring tests draw them."""
    m = random_sparse(96, 64, 0.08, seed=seed,
                      nonneg=semiring in ("max_times", "or_and"))
    x = np.random.default_rng(seed + 1).standard_normal(64).astype(
        np.float32)
    if semiring in ("max_times", "or_and"):
        x = np.abs(x)
    if semiring == "or_and":
        m.data = (m.data > 0.5).astype(np.float32)
        x = (x > 0.7).astype(np.float32)
    return jconvert.from_scipy(m), pconvert.from_scipy(m), x


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("fmt", ["csc", "coo", "ell", "bsr"])
def test_spmv_matches_jax(fmt, semiring):
    ja, pa, x = _semiring_data(semiring, seed=4)
    jm, pm = _container(jconvert, ja, fmt), _container(pconvert, pa, fmt)
    if fmt in ("ell", "bsr") and semiring == "or_and":
        # the reference has no such executor: its ELL branch raises
        # NotImplementedError, its BSR branch fails inside lax.reduce
        with pytest.raises((NotImplementedError, TypeError)):
            jref.spmv(jm, x, semiring=semiring)
        with pytest.raises(NotImplementedError):
            pref.spmv(pm, torch.from_numpy(x), semiring)
        return
    want = np.asarray(jref.spmv(jm, x, semiring=semiring))
    got = pref.spmv(pm, torch.from_numpy(x), semiring).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == np.bool_:
        assert np.array_equal(got, want)
    else:
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_spmv_accumulates_into_y(semiring):
    ja, pa, x = _semiring_data(semiring, seed=5)
    y0 = np.random.default_rng(6).standard_normal(96).astype(np.float32)
    want = np.asarray(jref.spmv(jconvert.csr_to_coo(ja), x,
                                semiring=semiring, y=y0))
    got = pref.spmv(pconvert.csr_to_coo(pa), torch.from_numpy(x), semiring,
                    y=torch.from_numpy(y0)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k", [1, 7, 16])
@pytest.mark.parametrize("fmt", ["bsr", "csr", "csc", "coo"])
def test_spmm_matches_jax(fmt, k):
    ja, pa = _csr_pair(seed=7)
    b = np.random.default_rng(k).standard_normal((64, k)).astype(np.float32)
    jm, pm = _container(jconvert, ja, fmt), _container(pconvert, pa, fmt)
    want = np.asarray(jref.spmm(jm, b))
    got = pref.spmm(pm, torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (96, k)
    np.testing.assert_allclose(got, want, **TOL)
    dense = jconvert.to_dense(ja).astype(np.float64)
    np.testing.assert_allclose(got, dense @ b.astype(np.float64), **TOL)


@pytest.mark.parametrize("fmt", ["bsr", "csr", "csc", "coo"])
def test_spmm_raises_for_other_semirings(fmt):
    _, pa = _csr_pair(seed=8)
    b = torch.ones((64, 3))
    # the reference raises on CSR, CSC and COO; on BSR it returns a
    # plus-times product whatever it is asked, which the port refuses
    with pytest.raises(NotImplementedError, match="plus_times"):
        pref.spmm(_container(pconvert, pa, fmt), b, semiring="min_plus")
    with pytest.raises(ValueError, match="B has shape"):
        pref.spmm(_container(pconvert, pa, fmt), torch.ones((63, 3)))


def test_executors_take_tensor_containers():
    # a container whose arrays are already tensors stays where it is
    ja, pa = _csr_pair(seed=9)
    coo = pconvert.csr_to_coo(pa)
    coo_t = type(coo)(data=torch.from_numpy(coo.data),
                      row=torch.from_numpy(coo.row),
                      col=torch.from_numpy(coo.col), shape=coo.shape)
    b = np.random.default_rng(10).standard_normal((64, 4)).astype(np.float32)
    np.testing.assert_allclose(pref.spmm(coo_t, torch.from_numpy(b)).numpy(),
                               np.asarray(jref.spmm(ja, b)), **TOL)
