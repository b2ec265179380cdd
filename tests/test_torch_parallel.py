"""Port parity: the sharded SpMV and SpMM of ``parallel/`` against the JAX
package's.

The JAX side runs on its 8-device virtual CPU mesh (``tests/conftest.py``),
its window kernels in Pallas interpret mode; the port runs on
``make_mesh(8, device="cpu")``, eight shards of the CPU, where kernels B,
H and M take their plain PyTorch versions.  Plans must be equal byte for
byte; y and Y agree within rtol = atol = 2e-5 (float32, the JAX
package's own sharded tests' bound).  The JAX SpMM runs its einsum route
(``use_pallas=False``): its interpreted window kernel takes tens of
seconds; the port's kernel-H route (its plain version on the CPU) is held
against that.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_vector_cache_tpu_torch.interop import (plan_from_reference,
                                                 plan_to_numpy)
from spmv_vector_cache_tpu_torch.parallel import (
    Mesh, ShardedDiaPlan, ShardedPlan, build_sharded_dia_plan,
    build_sharded_plan, make_mesh, place_on_mesh, spmm_sharded,
    spmv_dia_sharded, spmv_sharded)
from tests.test_torch_plan import (_assert_same, banded, both,
                                   random_sparse, shuffled_band)

# the modules (each package re-exports a function of the module's name)
jsh = importlib.import_module("spmv_vector_cache_tpu.parallel.spmv_sharded")
jdia_sh = importlib.import_module("spmv_vector_cache_tpu.parallel.dia_sharded")
psh = importlib.import_module(
    "spmv_vector_cache_tpu_torch.parallel.spmv_sharded")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

TOL = dict(rtol=2e-5, atol=2e-5)


def _skewed(n, seed):
    """Rows of 1-60 nonzeros within +-100 of the diagonal, lengths drawn
    so that the shards fill unequal tile counts."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    lens = np.where(np.arange(n) < n // 3, 60, rng.integers(1, 6, n))
    r = np.repeat(np.arange(n), lens)
    c = np.clip(r + rng.integers(-100, 101, r.shape[0]), 0, n - 1)
    m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=(n, n))
    m.sum_duplicates()
    m.sort_indices()
    return m


SELL_CASES = {
    "random": (lambda: random_sparse(1000, 1000, 0.01, seed=1), {}),
    "banded": (lambda: banded(1024, [-2, -1, 0, 1, 2], seed=2), {}),
    "shuffled_band": (lambda: shuffled_band(2048, seed=3), {}),
    "skewed": (lambda: _skewed(1500, seed=4), {}),
    "split_sigma": (lambda: random_sparse(900, 700, 0.03, seed=5),
                    dict(split=8, sigma=256)),
    "no_window": (lambda: random_sparse(1024, 1024, 0.05, seed=6),
                  dict(max_window_blocks=1)),
}


@pytest.fixture(scope="module")
def jmesh():
    return jsh.make_mesh(8)


@pytest.fixture(scope="module")
def pmesh():
    return make_mesh(8, device="cpu")


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("case", sorted(SELL_CASES))
def test_build_sharded_plan_byte_equal(case):
    make, kw = SELL_CASES[case]
    ja, pa = both(make())
    ref = jsh.build_sharded_plan(ja, 8, **kw)
    port = build_sharded_plan(pa, 8, **kw)
    assert isinstance(port, ShardedPlan)
    _assert_same(port, ref, "sharded")
    if case == "no_window":
        assert port.window_blocks == 0
    if case == "banded":
        assert 0 < port.halo <= port.rows_per_shard


#: (case, mode, whether the JAX side runs its interpreted Pallas window
#: route; else its XLA route, ``use_pallas=False``, which computes the
#: same y in a fraction of the time)
SPMV_CASES = [("random", "all_gather", False), ("banded", "halo", True),
              ("banded", "all_gather", False),
              ("shuffled_band", "halo", False),
              ("shuffled_band", "all_gather", True),
              ("skewed", "halo", False), ("skewed", "all_gather", False),
              ("split_sigma", "all_gather", False),
              ("no_window", "all_gather", False)]


@pytest.mark.parametrize("case,mode,jax_pallas", SPMV_CASES)
def test_spmv_sharded_matches_jax(case, mode, jax_pallas, jmesh, pmesh):
    make, kw = SELL_CASES[case]
    m = make()
    ja, pa = both(m)
    jp = jsh.build_sharded_plan(ja, 8, **kw)
    x = _x(m.shape[1], seed=7)
    want_jax = np.asarray(jsh.spmv_sharded(jp, x, jmesh, mode=mode,
                                           use_pallas=jax_pallas))
    pp = build_sharded_plan(pa, 8, **kw)
    y = spmv_sharded(pp, torch.from_numpy(x), pmesh, mode=mode).numpy()
    assert y.dtype == np.float32 and y.shape == (m.shape[0],)
    np.testing.assert_allclose(y, want_jax, **TOL)
    np.testing.assert_allclose(y, m.astype(np.float64) @ x, **TOL)


@pytest.mark.parametrize("mode", ["all_gather", "halo"])
def test_spmv_sharded_plain_route_matches_jax(mode, jmesh, pmesh):
    """A banded plan with no window (``max_window_blocks=1``) takes the
    reference's non-kernel route on both sides, in both exchange modes;
    the windowed plan of the same matrix, kernel B's route, agrees."""
    m = banded(1024, [-70, -1, 0, 1, 90], seed=8)
    ja, pa = both(m)
    x = _x(1024, seed=9)
    jp = jsh.build_sharded_plan(ja, 8, max_window_blocks=1)
    want = np.asarray(jsh.spmv_sharded(jp, x, jmesh, mode=mode,
                                       use_pallas=False))
    pp = build_sharded_plan(pa, 8, max_window_blocks=1)
    assert pp.window_blocks == 0 and 0 < pp.halo <= pp.rows_per_shard
    y_plain = spmv_sharded(pp, x, pmesh, mode=mode)
    y_kernel = spmv_sharded(build_sharded_plan(pa, 8), x, pmesh, mode=mode)
    np.testing.assert_allclose(y_plain.numpy(), want, **TOL)
    np.testing.assert_allclose(y_kernel.numpy(), want, **TOL)


def test_spmv_sharded_auto_picks_halo(pmesh):
    m = banded(512, [-1, 0, 1], seed=10)
    _, pa = both(m)
    pp = build_sharded_plan(pa, 8)
    assert psh.exchange_mode(pp, "auto") == "halo"
    x = _x(512, seed=11)
    y_auto = spmv_sharded(pp, x, pmesh, mode="auto")
    assert torch.equal(y_auto, spmv_sharded(pp, x, pmesh, mode="halo"))
    np.testing.assert_allclose(y_auto.numpy(), m.astype(np.float64) @ x,
                               **TOL)


def test_spmv_sharded_auto_picks_all_gather_and_halo_refuses():
    _, pa = both(random_sparse(1000, 1000, 0.01, seed=12))
    pp = build_sharded_plan(pa, 8)
    assert pp.halo == 0
    assert psh.exchange_mode(pp, "auto") == "all_gather"
    with pytest.raises(ValueError, match="halo mode"):
        psh.exchange_mode(pp, "halo")
    with pytest.raises(ValueError, match="mode must be"):
        psh.exchange_mode(pp, "ring")


def test_spmv_sharded_placed_plan_stays_on_mesh(pmesh):
    m = shuffled_band(1024, seed=13)
    _, pa = both(m)
    pp = place_on_mesh(build_sharded_plan(pa, 8), pmesh)
    assert all(isinstance(v, tuple) and len(v) == 8
               for v in (pp.vals, pp.cols, pp.row_map))
    assert place_on_mesh(pp, pmesh) is pp
    x = _x(1024, seed=14)
    np.testing.assert_allclose(spmv_sharded(pp, x, pmesh).numpy(),
                               m.astype(np.float64) @ x, **TOL)
    with pytest.raises(ValueError, match="mesh of 4"):
        place_on_mesh(pp, make_mesh(4, device="cpu"))


def test_sharded_plans_refuse_other_value_dtypes():
    _, pa = both(banded(1024, [0, 1], seed=15))
    for build in (build_sharded_plan, build_sharded_dia_plan):
        with pytest.raises(NotImplementedError,
                           match="no double sharded plan"):
            build(pa, 8, value_dtype=np.float64)


def test_spmv_sharded_rejects_wide_x():
    _, pa = both(random_sparse(256, 2000, 0.02, seed=16))
    pp = build_sharded_plan(pa, 2)
    with pytest.raises(ValueError, match="exceed the sharded x capacity"):
        spmv_sharded(pp, np.zeros(2000, np.float32),
                     make_mesh(2, device="cpu"))


def test_local_plan_stats_match_reference():
    """The reassembled shard plan carries the reference's stats: no group
    fold, so the window route reduces tile partials, then the row map."""
    from spmv_vector_cache_tpu_torch.ops.spmv_sell import folds_groups
    _, pa = both(_skewed(1500, seed=4))
    pp = place_on_mesh(build_sharded_plan(pa, 8), make_mesh(8, device="cpu"))
    lp = psh._local_plan(pp, 3, pp.cols[3], pp.window_base[3],
                         8 * pp.rows_per_shard, pp.max_window_base)
    st = lp.stats
    assert not folds_groups(lp) and not st.group_fold
    assert (st.group_tiles, st.window_grain, st.uniform_parts) == (4, 128, 0)
    assert lp.num_slices == pp.num_slices and lp.shape[0] == \
        pp.rows_per_shard


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,k", [("random", 16), ("skewed", 3),
                                    ("no_window", 8)])
def test_spmm_sharded_matches_jax(case, k, jmesh, pmesh):
    make, kw = SELL_CASES[case]
    m = make()
    ja, pa = both(m)
    b = np.random.default_rng(17).standard_normal(
        (m.shape[1], k)).astype(np.float32)
    jp = jsh.build_sharded_plan(ja, 8, **kw)
    want = np.asarray(jsh.spmm_sharded(jp, b, jmesh, use_pallas=False))
    pp = build_sharded_plan(pa, 8, **kw)
    assert (pp.window_blocks == 0) == (case == "no_window")
    y = spmm_sharded(pp, torch.from_numpy(b), pmesh)
    assert y.shape == (m.shape[0], k)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(y.numpy(), m.astype(np.float64) @ b, **TOL)


def test_spmm_sharded_rectangular_matches_jax(jmesh, pmesh):
    m = random_sparse(512, 256, 0.02, seed=18)
    ja, pa = both(m)
    b = np.random.default_rng(19).standard_normal((256, 16)).astype(
        np.float32)
    want = np.asarray(jsh.spmm_sharded(jsh.build_sharded_plan(ja, 8), b,
                                       jmesh, use_pallas=False))
    y = spmm_sharded(build_sharded_plan(pa, 8), b, pmesh)
    np.testing.assert_allclose(y.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# sharded DIA
# ---------------------------------------------------------------------------

DIA_CASES = {
    "halo256": (8 * 1024, 8, [-130, -1, 0, 1, 130], 8),
    "wraparound": (4 * 1024, 4, [-128, 128], 8),
    "diagonal": (3000, 8, [0], 8),
    "ragged": (5000, 3, list(range(-13, 14)), 8),
}


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_build_sharded_dia_plan_byte_equal(case):
    n, D, offs, sub = DIA_CASES[case]
    ja, pa = both(banded(n, offs, seed=20))
    port = build_sharded_dia_plan(pa, D, sublanes=sub)
    assert isinstance(port, ShardedDiaPlan)
    _assert_same(port, jdia_sh.build_sharded_dia_plan(ja, D, sublanes=sub),
                 "sharded_dia")


@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_spmv_dia_sharded_matches_jax(case):
    n, D, offs, sub = DIA_CASES[case]
    m = banded(n, offs, seed=21)
    ja, pa = both(m)
    # the wrap-around case: a uniform x, so wrapped halo entries that were
    # not multiplied by zero would show
    x = np.full(n, 7.0, np.float32) if case == "wraparound" else _x(n, 22)
    jp = jax.tree.map(jnp.asarray,
                      jdia_sh.build_sharded_dia_plan(ja, D, sublanes=sub))
    want = np.asarray(jdia_sh.spmv_dia_sharded(jp, x, jsh.make_mesh(D)))
    y = spmv_dia_sharded(build_sharded_dia_plan(pa, D, sublanes=sub), x,
                         make_mesh(D, device="cpu")).numpy()
    assert y.shape == (n,)
    np.testing.assert_allclose(y, want, **TOL)
    np.testing.assert_allclose(y, m.astype(np.float64) @ x, **TOL)


def test_sharded_dia_edge_wraparound_is_zero():
    """Ring halos wrap the far end's x into the edge shards; zero values
    must kill it (the reference's own test, on the port)."""
    n, D = 4 * 1024, 4
    m = banded(n, [-128, 128], seed=23)
    _, pa = both(m)
    sp_plan = build_sharded_dia_plan(pa, D, sublanes=8)
    x = np.full(n, 7.0, np.float32)
    y = spmv_dia_sharded(sp_plan, x, make_mesh(D, device="cpu")).numpy()
    np.testing.assert_allclose(y, m.astype(np.float64) @ x, **TOL)
    # the edge shards' wrapped halo columns carry zero values
    vals = sp_plan.vals
    assert not vals[0, 0, 0, 0].any()                 # row 0..127, off -128
    assert not vals[-1, -1, 1, -1].any()              # last rows, off +128


def test_sharded_dia_rejects_wide_band_and_rectangles():
    _, pa = both(banded(2048, [0, 1500], seed=24))
    with pytest.raises(ValueError, match="span"):
        build_sharded_dia_plan(pa, 8, sublanes=2)
    _, pr = both(banded(300, [0, 1], seed=25, cols=400))
    with pytest.raises(ValueError, match="square"):
        build_sharded_dia_plan(pr, 2, sublanes=2)


def test_dia_shard_is_kernel_m_with_origin_at_the_halo():
    """Each shard's rows of y are kernel M's over that shard's halo'd x,
    its origin at the left halo."""
    from spmv_vector_cache_tpu_torch.ops.spmv_dia import spmv_dia_halo_plain
    from spmv_vector_cache_tpu_torch.parallel.mesh import (shard_vector,
                                                           with_halos)
    n, D = 8 * 1024, 8
    _, pa = both(banded(n, [-130, 0, 130], seed=26))
    sp_plan = build_sharded_dia_plan(pa, D, sublanes=8)
    halo, rps = sp_plan.halo, sp_plan.rows_per_shard
    mesh = make_mesh(D, device="cpu")
    x = _x(n, 27)
    y = spmv_dia_sharded(sp_plan, x, mesh)
    xs = shard_vector(x, torch.float32, D, rps, mesh)
    for d in (0, 2, D - 1):
        x_ext = with_halos(xs, d, halo, mesh.devices[d])
        assert x_ext.shape == (rps + 2 * halo,)
        want = spmv_dia_halo_plain(torch.from_numpy(sp_plan.vals[d]),
                                   sp_plan.offsets, x_ext, rps, halo)
        assert torch.equal(y[d * rps:(d + 1) * rps], want)


# ---------------------------------------------------------------------------
# plans carried across from the JAX package
# ---------------------------------------------------------------------------

def test_plan_from_reference_sharded_plan(jmesh):
    m = shuffled_band(2048, seed=28)
    ja, _ = both(m)
    jp = jsh.build_sharded_plan(ja, 8)
    pp = plan_from_reference(jp, "cpu")
    assert isinstance(pp, ShardedPlan) and len(pp.vals) == 8
    _assert_same(plan_to_numpy(pp), jp, "carried")
    x = _x(2048, seed=29)
    want = np.asarray(jsh.spmv_sharded(jp, x, jmesh))
    y = spmv_sharded(pp, x, make_mesh(8, device="cpu"))
    np.testing.assert_allclose(y.numpy(), want, **TOL)


def test_plan_from_reference_sharded_dia_plan():
    n, D = 4 * 1024, 4
    m = banded(n, [-200, -3, 0, 5, 129], seed=30)
    ja, _ = both(m)
    jp = jdia_sh.build_sharded_dia_plan(ja, D, sublanes=8)
    mesh = make_mesh(D, device="cpu")
    pp = plan_from_reference(jp, mesh=mesh)
    assert isinstance(pp, ShardedDiaPlan) and isinstance(mesh, Mesh)
    assert all(t.device == dev for t, dev in zip(pp.vals, mesh.devices))
    _assert_same(plan_to_numpy(pp), jp, "carried_dia")
    x = _x(n, seed=31)
    want = np.asarray(jdia_sh.spmv_dia_sharded(
        jax.tree.map(jnp.asarray, jp), x, jsh.make_mesh(D)))
    np.testing.assert_allclose(spmv_dia_sharded(pp, x, mesh).numpy(), want,
                               **TOL)


def test_make_mesh_shapes():
    mesh = make_mesh(3, axis="rows", device="cpu")
    assert mesh.size == 3 and mesh.axis_names == ("rows",)
    assert all(d.type == "cpu" for d in mesh.devices)
    assert make_mesh(device="cpu").size == 1
