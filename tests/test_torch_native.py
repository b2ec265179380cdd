"""The port's native C++ runtime (``spmv_vector_cache_tpu_torch/native/``
through ``native_lib``) against the port's Python versions and the JAX
package's ``native_lib``.

The tests skip only when no C++ compiler is on PATH; a build that fails
fails them.  The JAX package's library is built from its own sources
with its own Makefile into a temporary directory, so that no test writes
into the JAX package (where ``tests/test_native.py`` builds it).
"""

import os
import subprocess
from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_vector_cache_tpu import native_lib as jnative
from spmv_vector_cache_tpu.ops import sptrsv as jtri
from spmv_vector_cache_tpu_torch import native_lib
from spmv_vector_cache_tpu_torch.formats import analysis, convert, refio
from spmv_vector_cache_tpu_torch.formats.containers import CSC, CSR
from spmv_vector_cache_tpu_torch.ops import reference, sptrsv
from spmv_vector_cache_tpu_torch.tools import matrixtools
from tests.test_torch_spgemm_sptrsv import spd_banded


@pytest.fixture(scope="module")
def native():
    if native_lib.compiler() is None:
        pytest.skip("no C++ compiler (c++ or g++) on PATH")
    assert native_lib.build()
    assert native_lib.available()
    return native_lib


@pytest.fixture(scope="module")
def jax_native(native, tmp_path_factory):
    """The JAX package's native_lib, its library built by its Makefile
    into a temporary directory."""
    out = tmp_path_factory.mktemp("jax_native")
    subprocess.run(["make", "-C", jnative._NATIVE_DIR, "all",
                    f"BUILDDIR={out}"], check=True, capture_output=True,
                   timeout=300)
    with mock.patch.object(jnative, "_LIB_PATH", str(out / "libspmvref.so")), \
            mock.patch.object(jnative, "_CLI_PATH", str(out / "spmv_bench")), \
            mock.patch.object(jnative, "_lib", None):
        yield jnative


def random_csr(seed, rows, cols, density, dtype=np.float64):
    m = sp.random(rows, cols, density=density, format="csr",
                  random_state=np.random.RandomState(seed), dtype=np.float64)
    m.sort_indices()
    m = m.astype(dtype)
    return CSR(data=m.data, indices=m.indices.astype(np.int32),
               indptr=m.indptr.astype(np.int32), shape=m.shape)


@pytest.mark.parametrize("shape,density", [((100, 80), 0.1),
                                           ((3000, 2000), 0.004),
                                           ((1, 50), 0.5)])
def test_spmv_csc_bit_equal(native, jax_native, shape, density):
    a = random_csr(shape[0] + shape[1], *shape, density)
    csc = convert.csr_to_csc(a)
    x = np.random.default_rng(1).standard_normal(shape[1])
    want = reference.spmv_numpy(csc, x)
    got = native.spmv_csc(csc, x)
    assert got.dtype == np.float64
    assert got.tobytes() == want.tobytes()     # the same accumulation order
    assert got.tobytes() == jax_native.spmv_csc(csc, x).tobytes()
    np.testing.assert_allclose(native.spmv_csr(a, x), want, rtol=1e-12,
                               atol=1e-12)
    y0 = np.arange(shape[0], dtype=np.float64)
    np.testing.assert_allclose(native.spmv_csc(csc, x, y0), want + y0,
                               rtol=1e-12, atol=1e-12)


def test_spmv_csc_uint64_matches_jax(native, jax_native):
    a = convert.csr_to_csc(random_csr(5, 64, 70, 0.2))
    u = matrixtools.to_uint64_matrix(a)
    x = np.arange(70, dtype=np.uint64)
    got = native.spmv_csc(u, x)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, jax_native.spmv_csc(u, x))
    dense = sp.csc_matrix((np.ones(a.indices.shape[0]), a.indices,
                           a.indptr), shape=a.shape) @ x.astype(np.float64)
    np.testing.assert_array_equal(got, dense.astype(np.uint64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyses_match_python(native, seed):
    a = random_csr(seed, 64 + seed * 40, 64, 0.12)
    csc = convert.csr_to_csc(a)
    assert native.max_alive(csc) == analysis.max_alive(csc)
    assert native.max_col_span(csc) == analysis.max_col_span(csc)
    inds = np.asarray(csc.indices)
    for reverse, shift in ((False, 31), (True, 30)):
        np.testing.assert_array_equal(
            native.mark_row_starts(inds, csc.shape[0], reverse=reverse,
                                   shift=shift),
            analysis.mark_row_starts(inds, reverse=reverse, shift=shift))


@pytest.mark.parametrize("shape", [(50, 60), (400, 100), (7, 7)])
def test_csr_to_csc_matches_python(native, shape):
    a = random_csr(sum(shape), *shape, 0.1)
    ours = convert.csr_to_csc(a)
    theirs = native.csr_to_csc(a)
    assert theirs.shape == ours.shape
    for f in ("indptr", "indices"):
        np.testing.assert_array_equal(getattr(theirs, f), getattr(ours, f))
    np.testing.assert_array_equal(theirs.data, np.asarray(ours.data))


def test_refuses_mismatched_arrays(native):
    a = convert.csr_to_csc(random_csr(3, 20, 30, 0.2))
    with pytest.raises(ValueError, match="x has shape"):
        native.spmv_csc(a, np.ones(29))
    bad = CSC(data=a.data[:-1], indices=a.indices, indptr=a.indptr,
              shape=a.shape)
    with pytest.raises(ValueError, match="disagree"):
        native.spmv_csc(bad, np.ones(30))


@pytest.mark.parametrize("n,band", [(200, 2), (1000, 5), (300, 3)])
def test_ilu0_matches_doolittle_and_jax(native, n, band):
    m = spd_banded(np.random.default_rng(n + band), n, band)
    a = CSR(data=m.data, indices=m.indices.astype(np.int32),
            indptr=m.indptr.astype(np.int32), shape=m.shape)
    got = native.ilu0_inplace(a.indptr, a.indices, a.data)
    np.testing.assert_allclose(got, sptrsv._ilu0_numpy(a), rtol=1e-12,
                               atol=1e-12)
    with mock.patch.object(jnative, "available", lambda: False):
        want = jtri._ilu0_values(a)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_ilu0_takes_the_native_path(native):
    m = spd_banded(np.random.default_rng(3), 500, 2)
    a = CSR(data=m.data, indices=m.indices.astype(np.int32),
            indptr=m.indptr.astype(np.int32), shape=m.shape)
    before = sptrsv._ilu0_values.native_calls
    L, U = sptrsv.ilu0(a)
    assert sptrsv._ilu0_values.native_calls == before + 1
    lu = sp.csr_matrix((L.data, L.indices, L.indptr), shape=L.shape) @ \
        sp.csr_matrix((U.data, U.indices, U.indptr), shape=U.shape)
    # ILU(0) of a full band is its exact LU
    np.testing.assert_allclose(lu.toarray(), m.toarray(), rtol=1e-8,
                               atol=1e-8)


def test_ilu0_errors(native):
    m = sp.csr_matrix(np.array([[1.0, 2.0], [3.0, 0.0]]))
    m.eliminate_zeros()
    with pytest.raises(ValueError, match="missing diagonal in row 1"):
        native.ilu0_inplace(m.indptr, m.indices, m.data)
    zc = sp.csr_matrix((np.array([0.0, 1.0, 1.0, 1.0]),
                        np.array([0, 1, 0, 1]), np.array([0, 2, 4])),
                       shape=(2, 2))
    with pytest.raises(ZeroDivisionError, match="zero pivot at row 0"):
        native.ilu0_inplace(zc.indptr, zc.indices, zc.data)


def _write_dirs(base, seeds):
    dirs = []
    for seed in seeds:
        csc = convert.csr_to_csc(random_csr(seed, 300 + seed, 250, 0.03))
        d = os.path.join(base, f"m{seed}")
        matrixtools.convert_matrix(csc, d, name=f"m{seed}")
        matrixtools.make_golden_result(csc, d)
        dirs.append((d, csc))
    return dirs


def test_cli_golden_check_and_csv(native, tmp_path):
    dirs = _write_dirs(str(tmp_path), (1, 2, 3))
    out = subprocess.run([native.cli_path(), "-n", "3", "-p"] +
                         [d for d, _ in dirs], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    header = lines[0].split(",")
    assert header[:4] == ["matrix", "rows", "cols", "nz"]
    rows = [dict(zip(header, line.split(","))) for line in lines[1:]]
    assert len(rows) == 3
    for r, (d, csc) in zip(rows, dirs):
        assert r["matrix"] == os.path.basename(d)
        assert r["diffFromGolden"] == "0"    # memcmp-clean vs golden.bin
        assert int(r["nz"]) == csc.indices.shape[0]
        assert int(r["maxAlive"]) == analysis.max_alive(csc)
        assert int(r["maxColSpan"]) == analysis.max_col_span(csc)


def test_cli_counts_a_wrong_golden(native, tmp_path):
    (d, csc), = _write_dirs(str(tmp_path), (4,))
    gold = refio.load_golden(d)
    gold[:2] += 1.0
    refio.save_golden(gold, d)
    out = subprocess.run([native.cli_path(), d], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 1
    row = dict(zip(*[line.split(",") for line in
                     out.stdout.strip().splitlines()]))
    assert row["diffFromGolden"] == "2"


def test_cli_uint64_variant(native, tmp_path):
    csc = matrixtools.to_uint64_matrix(
        convert.csr_to_csc(random_csr(6, 64, 64, 0.1)))
    d = str(tmp_path / "u64-uint64")
    matrixtools.convert_matrix(csc, d)
    out = subprocess.run([native.cli_path(), "-x", d], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[1].startswith("u64-uint64,64,64,")


def test_cli_bad_dir_errors(native):
    out = subprocess.run([native.cli_path(), "/nonexistent/matrix"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 1
    assert "cannot load" in out.stderr


def test_failed_build_raises_with_the_compilers_output(native, tmp_path):
    with mock.patch.object(native_lib, "BUILD", tmp_path / "build"), \
            mock.patch.object(native_lib, "CXXFLAGS",
                              native_lib.CXXFLAGS + ["-DSPMV_BROKEN",
                                                     "-include", "missing.h"]):
        with pytest.raises(RuntimeError, match="native build failed"
                           "(.|\\n)*missing.h"):
            native_lib.build()
    assert not list((tmp_path / "build").glob("*/libspmvref.so"))


def test_no_compiler_means_unavailable(monkeypatch):
    monkeypatch.setattr(native_lib, "compiler", lambda: None)
    assert native_lib.build() is False
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_lib.cli_path()
