"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file
imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the suite's conftest imports jax.)  Kernel and plain
version sum the same float32 products in another order, so they agree
to rtol = atol = 1e-5 relative to the output's largest magnitude.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu_torch.formats.convert import from_scipy
from spmv_vector_cache_tpu_torch.formats.dia import build_dia_plan
from spmv_vector_cache_tpu_torch.formats.plan import build_sell_plan, place
from spmv_vector_cache_tpu_torch.ops import spmv_dia, spmv_sell
from spmv_vector_cache_tpu_torch.ops.semiring import REGISTRY

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = max(1.0, float(ref.abs().nan_to_num(posinf=0, neginf=0).max()))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("offs,rows,cols", [
    ([0], 700, 700),
    ([-130, -7, 0, 3, 200], 700, 700),
    ([-1025, 0, 1300], 3000, 3000),      # offsets past either end
    ([0, 200], 300, 520),                # rectangular
])
def test_dia_kernel_matches_plain(cuda, offs, rows, cols):
    rng = np.random.default_rng(1)
    m = sp.spdiags(rng.standard_normal((len(offs), max(rows, cols))).astype(
        np.float32), offs, rows, cols).tocsr()
    plan = place(build_dia_plan(from_scipy(m), sublanes=8), cuda)
    x = torch.from_numpy(rng.standard_normal(cols).astype(np.float32)).to(
        cuda)
    before = spmv_dia.spmv_dia_kernel.launches
    got = spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets, x, rows)
    assert spmv_dia.spmv_dia_kernel.launches == before + 1
    _close(got, spmv_dia.spmv_dia_plain(plan.vals, plan.offsets, x, rows))


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("semiring", sorted(REGISTRY))
def test_window_kernel_matches_plain(cuda, semiring, fold):
    rng = np.random.default_rng(2)
    n = 2048
    r = np.repeat(np.arange(n), 20)
    c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
    v = np.abs(rng.standard_normal(r.shape[0])).astype(np.float32)
    if semiring == "or_and":
        v = (v > 0.5).astype(np.float32)
    m = sp.csr_matrix((v, (r, c)), shape=(n, n + 300))
    m.sort_indices()
    kw = dict(split=16, uniform_split=True, window_group_tiles=2) if fold \
        else {}
    plan = place(build_sell_plan(from_scipy(m), window_grain=32,
                                 pad_value=REGISTRY[semiring].zero, **kw),
                 cuda)
    x = torch.from_numpy(np.abs(rng.standard_normal(n + 300)).astype(
        np.float32)).to(cuda)
    st = plan.stats
    args = (plan.vals, plan.cols_win, plan.window_base, x)
    kwargs = dict(group_tiles=st.group_tiles, window_grain=st.window_grain,
                  fold=fold, semiring=semiring)
    got = spmv_sell.sell_window_kernel(*args, **kwargs)
    _close(got, spmv_sell.sell_window_plain(*args, **kwargs))
