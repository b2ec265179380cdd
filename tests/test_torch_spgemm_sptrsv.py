"""Port parity for SpGEMM (``ops/spgemm``), the blocked triangular solve
and ILU(0) (``ops/sptrsv``), on the CPU.

* SpGEMM: byte-equal symbolic plans; numeric values to 1e-6 relative of
  the JAX numeric phase (both sum the same float32 products, in another
  order) and to 1e-5 of float64 scipy; pattern reuse; the shape
  mismatch; float64 values stay float64 in the port (the JAX package
  truncates them to float32 without x64, ROADMAP.md queue 3).
* trisolve: lower, upper and unit-diagonal plans byte-equal to the JAX
  package's, x to 1e-4 relative of the JAX solve (the port multiplies
  by ``D^-1 N`` precomputed where the reference multiplies by ``D^-1``
  after subtracting ``N x``: the same arithmetic, rounded elsewhere);
  the two refusals.
* ILU(0): factor values to 1e-12 of the JAX numpy Doolittle (the same
  code; 1e-12 leaves room for nothing but the last bits), L and U
  byte-equal.
"""

import unittest.mock as mock

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu import native_lib
from spmv_vector_cache_tpu.formats import convert as jconvert
from spmv_vector_cache_tpu.ops import spgemm as jsg
from spmv_vector_cache_tpu.ops import sptrsv as jtri
from spmv_vector_cache_tpu_torch.formats import convert as pconvert
from spmv_vector_cache_tpu_torch.formats.containers import CSR
from spmv_vector_cache_tpu_torch.formats.plan import place
from spmv_vector_cache_tpu_torch.interop import (plan_from_reference,
                                                 plan_to_numpy)
from spmv_vector_cache_tpu_torch.ops import spgemm as psg
from spmv_vector_cache_tpu_torch.ops import sptrsv as ptri

CPU = torch.device("cpu")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _csr(m):
    m = m.tocsr()
    m.sort_indices()
    return pconvert.from_scipy(m)


def _random(rows, cols, density, seed, dtype=np.float32):
    return sp.random(rows, cols, density=density, format="csr",
                     random_state=np.random.RandomState(seed),
                     dtype=np.float64).astype(dtype)


# ---------------------------------------------------------------------------
# SpGEMM
# ---------------------------------------------------------------------------

SPGEMM_CASES = {
    "rect": ((80, 60, 0.08, 1), (60, 70, 0.08, 2)),
    "square": ((200, 200, 0.03, 3), (200, 200, 0.03, 4)),
    "empty_rows": ((64, 64, 0.01, 5), (64, 64, 0.01, 6)),
    "no_product": ((16, 16, 0.0, 7), (16, 16, 0.2, 8)),
}


def _spgemm_pair(case):
    (ra, ca, da, sa), (rb, cb, db, sb) = SPGEMM_CASES[case]
    return _random(ra, ca, da, sa), _random(rb, cb, db, sb)


@pytest.mark.parametrize("case", sorted(SPGEMM_CASES))
def test_spgemm_symbolic_byte_equal(case):
    ma, mb = _spgemm_pair(case)
    jp = jsg.spgemm_symbolic(jconvert.from_scipy(ma), jconvert.from_scipy(mb))
    pp = psg.spgemm_symbolic(_csr(ma), _csr(mb))
    for f in ("a_src", "b_src", "out_id", "c_indptr", "c_indices"):
        _same(getattr(pp, f), getattr(jp, f))
    assert (pp.c_shape, pp.c_nnz) == (jp.c_shape, jp.c_nnz)
    # and carried across, placed
    got = plan_to_numpy(plan_from_reference(jp, "cpu"))
    for f in ("a_src", "b_src", "out_id", "c_indptr", "c_indices"):
        _same(getattr(got, f), getattr(jp, f))
    assert (got.c_shape, got.c_nnz) == (jp.c_shape, jp.c_nnz)


@pytest.mark.parametrize("case", sorted(SPGEMM_CASES))
def test_spgemm_numeric_matches_jax_and_scipy(case):
    ma, mb = _spgemm_pair(case)
    jc, jp = jsg.spgemm(jconvert.from_scipy(ma), jconvert.from_scipy(mb))
    pc, pp = psg.spgemm(_csr(ma), _csr(mb), device="cpu")
    assert pc.data.device.type == "cpu" and pc.data.dtype == torch.float32
    got, want = pc.data.numpy(), np.asarray(jc.data)
    assert got.shape == want.shape == (jp.c_nnz,)
    scale = max(1.0, float(np.abs(want).max(initial=0)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)
    # float64 scipy on C's pattern
    c = sp.csr_matrix((got, pc.indices.numpy(), pc.indptr.numpy()),
                      shape=pc.shape)
    host = psg.spgemm_host(_csr(ma.astype(np.float64)),
                           _csr(mb.astype(np.float64)))
    ref = sp.csr_matrix((host.data, host.indices, host.indptr),
                        shape=host.shape).toarray()
    np.testing.assert_allclose(c.toarray(), ref, rtol=1e-5,
                               atol=1e-5 * scale)


def test_spgemm_pattern_reuse():
    ma, mb = _spgemm_pair("square")
    a, b = _csr(ma), _csr(mb)
    c1, plan = psg.spgemm(a, b, device="cpu")
    a2 = CSR(data=np.asarray(a.data) * 2.0, indices=a.indices,
             indptr=a.indptr, shape=a.shape)
    c2, plan2 = psg.spgemm(a2, b, plan=plan)
    assert plan2 is plan
    torch.testing.assert_close(c2.data, 2.0 * c1.data, rtol=1e-6, atol=0)
    # a host plan handed back is placed on the device asked for
    jp = jsg.spgemm_symbolic(jconvert.from_scipy(ma), jconvert.from_scipy(mb))
    c3, _ = psg.spgemm(a2, b, plan=psg.spgemm_symbolic(a, b), device="cpu")
    want = np.asarray(jsg.spgemm_numeric(jp, np.asarray(a2.data),
                                         np.asarray(b.data)))
    np.testing.assert_allclose(c3.data.numpy(), want, rtol=1e-6, atol=1e-6)


def test_spgemm_numeric_on_the_cpu_is_the_same_every_run():
    ma, mb = _spgemm_pair("square")
    plan = place(psg.spgemm_symbolic(_csr(ma), _csr(mb)), CPU)
    runs = [psg.spgemm_numeric(plan, ma.data, mb.data) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs)


def test_spgemm_keeps_float64():
    ma, mb = _spgemm_pair("rect")
    a, b = _csr(ma.astype(np.float64)), _csr(mb.astype(np.float64))
    c, _ = psg.spgemm(a, b, device="cpu")
    assert c.data.dtype == torch.float64
    host = psg.spgemm_host(a, b)
    np.testing.assert_allclose(c.data.numpy(), host.data, rtol=1e-14,
                               atol=1e-14)
    _same(c.indices.numpy(), host.indices)
    _same(c.indptr.numpy(), host.indptr)


def test_spgemm_shape_mismatch():
    a = CSR(data=np.ones(1), indices=np.zeros(1, np.int32),
            indptr=np.array([0, 1], np.int32), shape=(1, 1))
    b = CSR(data=np.ones(1), indices=np.zeros(1, np.int32),
            indptr=np.array([0, 1, 1], np.int32), shape=(2, 1))
    for symbolic in (psg.spgemm_symbolic, jsg.spgemm_symbolic):
        with pytest.raises(ValueError, match="shape mismatch"):
            symbolic(a, b)


# ---------------------------------------------------------------------------
# triangular solve
# ---------------------------------------------------------------------------

def banded_lower(rng, n, band=5, scale=1.0):
    """``tests/test_spgemm_sptrsv.py``'s well-conditioned lower band."""
    m = sp.spdiags(rng.standard_normal((band + 1, n)) * scale,
                   list(range(-band, 1)), n, n).tocsr()
    m = m + sp.eye(n) * (band + 2)
    m = sp.tril(m).tocsr()
    m.sort_indices()
    return m.astype(np.float32)


#: name: (n, band, off-diagonal scale, lower, unit_diag)
TRI_CASES = {
    "lower": (500, 5, 1.0, True, False),
    "upper": (300, 5, 1.0, False, False),
    "lower_unit": (260, 4, 0.3, True, True),
    "upper_unit": (130, 3, 0.3, False, True),
    "lower_two_neighbours": (1000, 200, 0.02, True, False),
    "upper_two_neighbours": (700, 150, 0.02, False, False),
    "diagonal_only": (100, 0, 1.0, True, False),
}


def _tri_case(case, rng):
    n, band, scale, lower, unit = TRI_CASES[case]
    m = banded_lower(rng, n, band, scale)
    if not lower:
        m = m.T.tocsr()
        m.sort_indices()
    return m, lower, unit


@pytest.mark.parametrize("case", sorted(TRI_CASES))
def test_trisolve_matches_jax(case):
    rng = np.random.default_rng(11)
    m, lower, unit = _tri_case(case, rng)
    b = rng.standard_normal(m.shape[0]).astype(np.float32)
    jp = jtri.build_trisolve_plan(jconvert.from_scipy(m), lower=lower,
                                  unit_diag=unit)
    pp = ptri.build_trisolve_plan(_csr(m), lower=lower, unit_diag=unit)
    _same(pp.diag_blocks, jp.diag_blocks)
    _same(pp.off_blocks, jp.off_blocks)
    assert (pp.n, pp.lower, pp.unit_diag) == (jp.n, jp.lower, jp.unit_diag)
    want = np.asarray(jtri.trisolve(jp, b))
    for placed in (place(pp, CPU), plan_from_reference(jp, "cpu")):
        x = ptri.trisolve(placed, b)
        assert x.dtype == torch.float32 and x.shape == (m.shape[0],)
        np.testing.assert_allclose(x.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    # the system itself, in float64 (unit_diag solves with ones there)
    t = m.astype(np.float64).tolil()
    if unit:
        t.setdiag(1.0)
    r = b - t.tocsr() @ x.numpy().astype(np.float64)
    assert np.linalg.norm(r) < 1e-4 * np.linalg.norm(b)


def test_trisolve_repeats_on_a_placed_plan():
    rng = np.random.default_rng(12)
    m, lower, unit = _tri_case("lower_two_neighbours", rng)
    plan = place(ptri.build_trisolve_plan(_csr(m), lower=True), CPU)
    b = torch.from_numpy(rng.standard_normal(m.shape[0]).astype(np.float32))
    first = ptri.trisolve(plan, b)
    assert ptri.sweep_on(plan) is ptri.sweep_on(plan)
    assert torch.equal(ptri.trisolve(plan, b), first)


def test_trisolve_needs_a_placed_plan():
    rng = np.random.default_rng(13)
    m, _, _ = _tri_case("lower", rng)
    plan = ptri.build_trisolve_plan(_csr(m), lower=True)
    with pytest.raises(TypeError, match="placed"):
        ptri.trisolve(plan, np.ones(m.shape[0], np.float32))


def test_trisolve_zero_diag_raises():
    n = 64
    m = sp.eye(n).tocsr()
    m[3, 3] = 0.0
    m = sp.tril(m.tocsr()).tocsr()
    m.sort_indices()
    for build, conv in ((ptri.build_trisolve_plan, pconvert.from_scipy),
                        (jtri.build_trisolve_plan, jconvert.from_scipy)):
        with pytest.raises(ValueError, match="zero diagonal"):
            build(conv(m.astype(np.float32)), lower=True)


def test_trisolve_too_wide_to_densify_raises():
    # block bandwidth W = nb - 1 with nb = 200 blocks: W * nb * 128^2 *
    # 4 bytes passes 2^31 (the check runs before anything is densified)
    n = 200 * 128
    rows = np.array([0, n - 1], np.int32)
    m = sp.csr_matrix((np.ones(2, np.float32), (rows[::-1], rows)),
                      shape=(n, n))
    m = sp.tril(m + sp.eye(n, dtype=np.float32)).tocsr()
    m.sort_indices()
    for build, conv in ((ptri.build_trisolve_plan, pconvert.from_scipy),
                        (jtri.build_trisolve_plan, jconvert.from_scipy)):
        with pytest.raises(ValueError, match="too wide to densify"):
            build(conv(m), lower=True)


# ---------------------------------------------------------------------------
# ILU(0)
# ---------------------------------------------------------------------------

def spd_banded(rng, n, band=3):
    """``tests/test_spgemm_sptrsv.py``'s ``_spd_banded`` (float64)."""
    m = sp.spdiags(rng.standard_normal((2 * band + 1, n)),
                   list(range(-band, band + 1)), n, n).tocsr()
    m = (m + m.T) * 0.1 + sp.eye(n) * (2 * band + 2)
    m = m.tocsr()
    m.sort_indices()
    return m


def _jax_ilu0_values(a):
    """The JAX package's numpy Doolittle (its native route switched off)."""
    with mock.patch.object(native_lib, "available", lambda: False):
        return jtri._ilu0_values(a)


@pytest.mark.parametrize("n,band", [(200, 2), (400, 5), (300, 3)])
def test_ilu0_matches_jax(n, band):
    m = spd_banded(np.random.default_rng(n + band), n, band)
    ja, pa = jconvert.from_scipy(m), _csr(m)
    got = ptri._ilu0_values(pa)
    want = _jax_ilu0_values(ja)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with mock.patch.object(native_lib, "available", lambda: False):
        jl, ju = jtri.ilu0(ja)
    pl, pu = ptri.ilu0(pa)
    for p, j in ((pl, jl), (pu, ju)):
        for f in ("data", "indices", "indptr"):
            _same(getattr(p, f), getattr(j, f))


def test_ilu0_exact_on_full_band():
    m = spd_banded(np.random.default_rng(14), 200, band=2)
    L, U = ptri.ilu0(_csr(m))
    lu = sp.csr_matrix((L.data, L.indices, L.indptr), shape=L.shape) @ \
        sp.csr_matrix((U.data, U.indices, U.indptr), shape=U.shape)
    np.testing.assert_allclose(lu.toarray(), m.toarray(), rtol=1e-8,
                               atol=1e-8)


def test_ilu0_missing_diagonal_raises():
    m = sp.csr_matrix(np.array([[1.0, 2.0], [3.0, 0.0]]))
    m.eliminate_zeros()
    for a, ilu in ((_csr(m), ptri.ilu0),
                   (jconvert.from_scipy(m), jtri._ilu0_values)):
        with mock.patch.object(native_lib, "available", lambda: False):
            with pytest.raises(ValueError, match="missing diagonal"):
                ilu(a)


def test_ilu0_scales_past_python_loop_sizes():
    # as tests/test_spgemm_sptrsv.py: a 100k-row band in well under 30 s
    import time

    n = 100_000
    m = spd_banded(np.random.default_rng(15), n, band=3)
    t0 = time.monotonic()
    L, U = ptri.ilu0(_csr(m))
    dt = time.monotonic() - t0
    assert dt < 30.0, f"ILU(0) took {dt:.1f}s at n={n}"
    k = 512
    lu = (sp.csr_matrix((L.data, L.indices, L.indptr), shape=L.shape)
          @ sp.csr_matrix((U.data, U.indices, U.indptr), shape=U.shape)
          ).tocsr()[:k, :k]
    np.testing.assert_allclose(lu.toarray(), m.tocsr()[:k, :k].toarray(),
                               rtol=1e-8, atol=1e-8)
