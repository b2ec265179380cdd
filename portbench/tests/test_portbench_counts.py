"""The work counts the rooflines divide, checked against
the matrices the harness builds and against hand counts."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run, work

HERE = Path(__file__).resolve().parents[1]


def _hpcg(**over):
    cfg = json.loads((HERE / "configs" / "hpcg_27pt_f64.json").read_text())
    cfg.update(over)
    mod = run.load_module(HERE / "configs" / "hpcg_27pt_f64.py", "t_hpcg")
    return cfg, mod


@pytest.mark.parametrize("grid", [(4, 4, 4), (8, 8, 8), (8, 16, 24)])
def test_stencil_nonzeros_match_the_closed_form(grid):
    nx, ny, nz = grid
    cfg, mod = _hpcg(nx=nx, ny=ny, nz=nz)
    indptr, indices, data, shape = mod.make_csr(cfg)
    assert shape == (nx * ny * nz,) * 2
    assert indices.shape[0] == work.stencil27_nnz(nx, ny, nz) \
        == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    assert indptr[-1] == indices.shape[0] == data.shape[0]
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    assert np.all(np.diff(indices)[np.diff(rows) == 0] > 0)  # ascending
    assert np.all(data[indices == rows] == 26.0)
    assert np.all(data[indices != rows] == -1.0)


def test_stencil_csr_agrees_with_the_grid_reference():
    cfg, mod = _hpcg(nx=8, ny=12, nz=16)
    indptr, indices, data, shape = mod.make_csr(cfg)
    x = np.random.default_rng(3).standard_normal(shape[1])
    y = np.add.reduceat(data * x[indices], indptr[:-1])
    ref = mod.reference_matvec(cfg, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-12)
    b = mod.rhs(cfg, "cpu", torch.float64).numpy()
    np.testing.assert_allclose(b, np.add.reduceat(data, indptr[:-1]))


def test_hpcg_128_cube_work():
    nnz = work.stencil27_nnz(128, 128, 128)
    assert nnz == 55_742_968
    n = 128 ** 3
    nbytes = work.spmv_bytes(nnz, n, n, value_bytes=8, index_bytes=0)
    assert nbytes == 479_498_176
    assert nbytes / 3.35e12 * 1e6 == pytest.approx(143.13, abs=0.01)
