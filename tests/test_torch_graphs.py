"""The Kronecker graph generator (``tools/graphs.py``) on the CPU: the
draw is a function of its seed, the graph is simple and undirected, P
is column-stochastic, and the degree skew grows with the scale as the
Graph500 initiator makes it."""

import numpy as np
import pytest
import scipy.sparse as sp

from spmv_vector_cache_tpu_torch.tools import graphs


def _scipy(csr):
    return sp.csr_matrix((csr.data, csr.indices, csr.indptr),
                         shape=csr.shape)


@pytest.mark.parametrize("scale", [6, 9])
def test_the_same_seed_gives_the_same_arrays(scale):
    a = graphs.kron(scale, seed=2**31 + 17)
    b = graphs.kron(scale, seed=2**31 + 17)
    c = graphs.kron(scale, seed=2**31 + 18)
    for name in ("indptr", "indices", "data"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert graphs.fingerprint(a) == graphs.fingerprint(b)
    assert graphs.fingerprint(a) != graphs.fingerprint(c)
    assert (a.indptr.dtype, a.indices.dtype, a.data.dtype) == \
        (np.int64, np.int32, np.float32)


@pytest.mark.parametrize("scale", [7, 10])
def test_the_graph_is_symmetric_with_no_loops_or_duplicates(scale):
    p = graphs.kron(scale, seed=5)
    n = 1 << scale
    assert p.shape == (n, n)
    m = _scipy(p)
    pattern = (m != 0).astype(np.int8)
    assert (pattern != pattern.T).nnz == 0
    assert not m.diagonal().any()
    # columns strictly ascending within each row: no duplicate edge
    rows = np.repeat(np.arange(n), np.diff(p.indptr))
    step = np.diff(p.indices.astype(np.int64))
    assert (step[rows[1:] == rows[:-1]] > 0).all()
    # isolated vertices stay, as empty rows
    assert p.indptr.shape == (n + 1,) and (np.diff(p.indptr) == 0).any()


@pytest.mark.parametrize("scale", [7, 10])
def test_each_column_with_edges_sums_to_one(scale):
    p = graphs.kron(scale, seed=9)
    m = _scipy(p).astype(np.float64)
    deg = np.diff(m.tocsc().indptr)
    sums = np.asarray(m.sum(axis=0)).ravel()
    # each value is 1/deg rounded once to float32
    assert np.all(np.abs(sums[deg > 0] - 1.0) <= deg[deg > 0] * 2.0**-24)
    assert not sums[deg == 0].any()
    want = (1.0 / deg[p.indices].astype(np.float64)).astype(np.float32)
    assert p.data.tobytes() == want.tobytes()


@pytest.mark.parametrize("scale,edge_factor", [(5, 16), (8, 16), (8, 4)])
def test_the_draw_has_edge_factor_times_vertices_edges(scale, edge_factor):
    src, dst = graphs.kron_edges(scale, edge_factor, seed=3)
    n = 1 << scale
    assert src.shape == dst.shape == (edge_factor * n,)
    assert int(src.min()) >= 0 and int(src.max()) < n
    assert int(dst.min()) >= 0 and int(dst.max()) < n
    # the undirected graph has at most twice the drawn edges as entries
    p = graphs.pull_matrix(src, dst, n)
    assert p.nnz <= 2 * edge_factor * n


def test_a_draw_in_chunks_is_seeded_too(monkeypatch):
    # blocks of edges take their uniforms from one generator in turn: a
    # draw over several blocks is the same one for the same seed
    monkeypatch.setattr(graphs, "_DRAW_BLOCK", 300)
    parts = graphs.kron_edges(7, seed=4)
    again = graphs.kron_edges(7, seed=4)
    assert all(p.shape == (16 << 7,) for p in parts)
    assert all(bool((p == q).all()) for p, q in zip(parts, again))


def _skew(scale, abc):
    deg = np.diff(graphs.kron(scale, abc=abc, seed=11).indptr)
    return deg.max() / deg.mean()


def test_the_degree_skew_grows_with_the_scale_as_rmat_makes_it():
    # the all-zero vertex expects (A+B)^s + (A+C)^s of the 16 * 2^s
    # drawn edges' ends, so max/mean grows about 2 (A+B) = 1.52 times a
    # level under Graph500's initiator, and not at all under a uniform one
    rmat = [_skew(s, graphs.GRAPH500_ABC) for s in (6, 8, 10)]
    assert rmat[0] > 3 and rmat[1] > 1.8 * rmat[0] and \
        rmat[2] > 1.8 * rmat[1]
    flat = [_skew(s, (0.25, 0.25, 0.25)) for s in (6, 8, 10)]
    assert max(flat) < 3 and max(flat) < rmat[0]


def test_bad_parameters_are_refused():
    with pytest.raises(ValueError):
        graphs.kron_edges(0)
    with pytest.raises(ValueError):
        graphs.kron_edges(4, abc=(0.5, 0.3, 0.3))
