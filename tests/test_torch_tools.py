"""Port parity for the tools (``spmv_vector_cache_tpu_torch/tools/``):
matrixtools, vecdiff and benchapp against the JAX package's, and the
suite, the weak-scaling harness and the report on the CPU.

The JAX side runs as its own tests run it (Pallas interpret mode).  The
matrix directories are written here, from a seed, with the port's
``matrixtools``; the tests of the reference's bundled matrices stay in
``tests/test_tools.py``.
"""

import io
import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from spmv_vector_cache_tpu.tools import benchapp as jbenchapp
from spmv_vector_cache_tpu.tools import matrixtools as jmatrixtools
from spmv_vector_cache_tpu.tools import vecdiff as jvecdiff
from spmv_vector_cache_tpu_torch.formats import refio
from spmv_vector_cache_tpu_torch.formats.containers import CSC
from spmv_vector_cache_tpu_torch.parallel import make_mesh
from spmv_vector_cache_tpu_torch.tools import (benchapp, matrixtools, report,
                                               scaling, suite, vecdiff)
from spmv_vector_cache_tpu_torch.utils import roofline


def _mtx(path, seed=0, rows=300, cols=280, density=0.03):
    m = sp.random(rows, cols, density=density, format="coo",
                  random_state=np.random.RandomState(seed))
    scipy.io.mmwrite(str(path), m)
    return str(path)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("seed", [0, 1])
def test_matrixtools_files_byte_identical_to_jax(tmp_path, seed):
    mtx = _mtx(tmp_path / f"mat{seed}.mtx", seed=seed)
    ours = matrixtools.prepare_mtx(mtx, str(tmp_path / "port"))
    theirs = jmatrixtools.prepare_mtx(mtx, str(tmp_path / "jax"))
    assert os.path.basename(ours) == os.path.basename(theirs) == f"mat{seed}"
    got, want = _files(ours), _files(theirs)
    assert sorted(got) == sorted(want) == sorted(
        [f"mat{seed}-{p}.bin" for p in ("meta", "indptr", "inds", "data")]
        + ["golden.bin", "upload.tcl"])
    # upload.tcl names each file by its path
    want["upload.tcl"] = want["upload.tcl"].replace(theirs.encode(),
                                                    ours.encode())
    assert got == want


def test_matrixtools_analyze_matches_jax(tmp_path):
    mtx = _mtx(tmp_path / "a.mtx", seed=3)
    assert matrixtools.analyze(matrixtools.load_mtx(mtx)) == \
        jmatrixtools.analyze(jmatrixtools.load_mtx(mtx))


def test_matrixtools_uint64_variant(tmp_path):
    a = matrixtools.load_mtx(_mtx(tmp_path / "b.mtx", seed=4))
    u = matrixtools.to_uint64_matrix(a)
    assert np.asarray(u.data).dtype == np.uint64
    assert (np.asarray(u.data) == 1).all()
    np.testing.assert_array_equal(u.indices, a.indices)
    matrixtools.convert_matrix(u, str(tmp_path / "u"), name="u")
    assert np.fromfile(tmp_path / "u" / "u-data.bin", "<u8").sum() == \
        a.indices.shape[0]


def test_matrixtools_suitesparse_offline_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="network download disabled"):
        matrixtools.prepare_suitesparse("Fake/matrix", str(tmp_path))


def test_matrixtools_cli(tmp_path, capsys):
    mtx = _mtx(tmp_path / "c.mtx", seed=5)
    assert matrixtools._main(["convert", mtx, str(tmp_path / "out")]) == 0
    assert matrixtools._main(["analyze", str(tmp_path / "out" / "c")]) == 0
    assert "nnz:" in capsys.readouterr().out
    assert matrixtools._main([]) == 2


def _vec(path, values):
    np.asarray(values, "<f8").tofile(path)
    return str(path)


def test_vecdiff_codes_and_text_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    base = rng.standard_normal(200)
    bumped = base.copy()
    bumped[3] += 1e-9
    a = _vec(tmp_path / "a.bin", base)
    b = _vec(tmp_path / "b.bin", bumped)
    c = _vec(tmp_path / "c.bin", base[:150])
    for args, kw, code in (((a, a), {}, 0), ((a, b), {}, 1),
                           ((a, b), dict(rtol=1e-6, atol=1e-6), 0),
                           ((a, c), {}, 1),
                           ((a, b), dict(dtype="f32"), 1)):
        got, want = io.StringIO(), io.StringIO()
        assert vecdiff.diff(*args, out=got, **kw) == code
        assert jvecdiff.diff(*args, out=want, **kw) == code
        assert got.getvalue() == want.getvalue()
    assert vecdiff.main([a, b, "--rtol", "1e-6", "--atol", "1e-6"]) == 0


@pytest.fixture(scope="module")
def matrix_dirs(tmp_path_factory):
    """Two wire-format directories with goldens, written by the port's
    matrixtools from seeded matrices."""
    base = tmp_path_factory.mktemp("dirs")
    out = []
    for seed, (rows, band) in enumerate(((1024, 3), (768, 5))):
        m = sp.spdiags(np.random.default_rng(seed).standard_normal(
            (2 * band + 1, rows)), list(range(-band, band + 1)), rows,
            rows).tocsc()
        m.sort_indices()
        d = str(base / f"band{seed}")
        csc = CSC(data=m.data, indices=m.indices.astype(
            np.int32), indptr=m.indptr.astype(np.int32), shape=m.shape)
        matrixtools.convert_matrix(csc, d)
        matrixtools.make_golden_result(csc, d)
        out.append(d)
    return out


def _rows(text):
    lines = text.strip().splitlines()
    header = lines[0].split(",")
    return header, [dict(zip(header, line.split(","))) for line in lines[1:]]


def test_benchapp_sweep_matches_jax_header(matrix_dirs):
    got, want = io.StringIO(), io.StringIO()
    assert benchapp.run_sweep(matrix_dirs, ["auto"], iters=1, out=got,
                              device="cpu") == 0
    assert jbenchapp.run_sweep(matrix_dirs, ["auto"], iters=1,
                               out=want) == 0
    header, rows = _rows(got.getvalue())
    jheader, jrows = _rows(want.getvalue())
    assert header == jheader
    assert header[:3] == ["matrix", "strategy", "status"]
    assert len(rows) == len(jrows) == 2
    for r, j in zip(rows, jrows):
        assert r["status"] == j["status"] == "ok"
        assert r["diffFromSW"] == r["diffFromGolden"] == "0"
        assert r["plan"] == j["plan"]
        assert float(r["gnnz_per_s"]) > 0
        for k in ("nnz", "bytes_per_apply", "grid_steps", "gather_passes"):
            assert r[k] == j[k], k


def test_benchapp_strategies_and_bad_dir(matrix_dirs, capsys):
    buf = io.StringIO()
    rc = benchapp.run_sweep([matrix_dirs[0], "/nonexistent"],
                            ["auto", "window", "stream"], iters=1, out=buf,
                            device="cpu")
    assert rc == 1
    assert "cannot load /nonexistent" in capsys.readouterr().err
    _, rows = _rows(buf.getvalue())
    assert [(r["strategy"], r["status"]) for r in rows] == [
        ("auto", "ok"), ("window", "infeasible"), ("stream", "infeasible")]


def test_benchapp_cli_on_the_cpu(matrix_dirs, capsys):
    assert benchapp.main(["--cpu", "--iters", "1", matrix_dirs[1]]) == 0
    assert capsys.readouterr().out.startswith("matrix,strategy,status")


def _floor_marginal(make, i1=30, i2=90, repeats=3):
    return roofline.TIMING_FLOOR


def test_a_row_at_the_timing_floor_is_not_ok(matrix_dirs, monkeypatch,
                                             capsys):
    assert roofline.at_floor(roofline.TIMING_FLOOR)
    assert not roofline.at_floor(1e-9)
    monkeypatch.setattr(roofline, "time_marginal", _floor_marginal)
    buf = io.StringIO()
    assert benchapp.run_sweep(matrix_dirs[:1], ["auto"], iters=1, out=buf,
                              device="cpu") == 0
    _, (row,) = _rows(buf.getvalue())
    assert row["status"] == "timing_floor"
    assert row["gnnz_per_s"] == row["spmvtime"] == ""
    assert row["achieved_gb_per_s"] == ""
    res = scaling.weak_scaling(rows_per_device=1024, iters=1,
                               device_counts=(1,), device="cpu",
                               log=io.StringIO())
    assert res[0]["ok"] is False and res[0]["gnnz_per_s"] is None
    assert res[0]["weak_scaling_efficiency"] is None


SMALL = dict(BANDED_ROWS=4096, POWERLAW_ROWS=4096, BSR_ROWS=1024,
             SPMM_DIA_ROWS=2048, SPGEMM_ROWS=512, TRISOLVE_ROWS=1024)


def test_suite_small_sizes_every_row_ok(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(suite, k, v)
    log = io.StringIO()
    rows = suite.run_suite(iters=2, log=log)
    assert [r["config"] for r in rows] == [
        "spmv_banded", "spmv_banded_sell", "spmv_powerlaw", "spmm_bsr",
        "spmm_fused", "spmm_dia", "spgemm_numeric", "trisolve"]
    for r in rows:
        assert r["ok"], r
        assert r["rate"] > 0 and r["device"].startswith("cpu")
    assert log.getvalue().count("ok=True") == 8


def test_suite_row_at_the_floor_has_no_rate(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setattr(suite, k, v)
    monkeypatch.setattr(roofline, "time_marginal", _floor_marginal)
    log = io.StringIO()
    rows = suite.run_suite(iters=2, log=log)
    assert all(r["ok"] is False and r["rate"] is None for r in rows)
    assert "Gnnz/s" not in log.getvalue()
    assert log.getvalue().count("no rate: timing floor") == 8


@pytest.mark.parametrize("mode", ["sell", "dia"])
def test_weak_scaling_on_a_cpu_mesh(mode):
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and {d.type for d in mesh.devices} == {"cpu"}
    log = io.StringIO()
    res = scaling.weak_scaling(rows_per_device=2048, iters=2,
                               device_counts=(1, 8), mode=mode,
                               device="cpu", log=log)
    assert [r["devices"] for r in res] == [1, 8]
    for r in res:
        assert r["ok"] and r["hardware"] == "cpu"
        assert r["rows"] == 2048 * r["devices"] and r["gnnz_per_s"] > 0
    assert res[0]["weak_scaling_efficiency"] == 1.0
    assert "tpu" not in log.getvalue()


def test_report_refuses_the_repository_root_and_a_missing_card(tmp_path):
    with pytest.raises(ValueError, match="repository"):
        report.write_report(report.REPO_ROOT, quick=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        report.write_report(str(tmp_path), quick=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        report.large_matrix_rows(quick=True)
    with pytest.raises(SystemExit):
        report.main([])                    # --out is required


def test_report_matrix_dirs_round_trip(tmp_path, monkeypatch):
    from spmv_vector_cache_tpu_torch.tools import realistic

    def small():
        m = sp.random(500, 500, density=0.01, format="csr",
                      random_state=np.random.RandomState(2),
                      dtype=np.float32)
        m.sort_indices()
        return realistic.coo_to_csr(realistic.COO(
            data=m.tocoo().data, row=m.tocoo().row.astype(np.int32),
            col=m.tocoo().col.astype(np.int32), shape=m.shape))

    monkeypatch.setitem(realistic.MATRICES, "tiny", (small, "a test"))
    (d,) = report.write_matrix_dirs(str(tmp_path), ["tiny"])
    a = refio.load_reference_matrix(d)
    assert np.asarray(a.data).dtype == np.float64
    gold = refio.load_golden(d)
    m = small()
    want = sp.csr_matrix((np.asarray(m.data, np.float64), m.indices,
                          m.indptr), shape=m.shape) @ np.ones(500)
    np.testing.assert_allclose(gold, want, rtol=1e-12, atol=1e-12)
    buf = io.StringIO()
    assert benchapp.run_sweep([d], ["auto"], iters=1, out=buf,
                              device="cpu") == 0
    _, (row,) = _rows(buf.getvalue())
    assert row["diffFromGolden"] == "0" and row["status"] == "ok"
