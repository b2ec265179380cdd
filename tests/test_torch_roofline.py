"""Port parity: the stream checksum and the roofline audit against the JAX
package's.

``checksum_stream_plain`` (kernel N's plain version) is held against the
JAX ``_checksum_stream`` (Pallas, interpret mode on the CPU) with that
harness's own tolerances: rtol 1e-6 on the closed-form ramp, rtol = atol
= 1e-3 on random data.  ``audit`` must return the reference's dict for
the same numbers, and ``SparseOperator.audit`` the reference's audit keys
and the same bytes per apply as the JAX operator on the same plan.
Timings here are CPU wall times: they only have to be positive.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_vector_cache_tpu.ops.operator import \
    SparseOperator as JSparseOperator
from spmv_vector_cache_tpu.utils import roofline as jroofline
from spmv_vector_cache_tpu.utils.stats import StatRegistry as JStats
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from spmv_vector_cache_tpu_torch.utils import roofline
from spmv_vector_cache_tpu_torch.utils.stats import StatRegistry
from spmv_vector_cache_tpu_torch.utils.stream import (checksum_stream,
                                                      checksum_stream_plain)
from tests.test_backend_stream import _checksum_stream
from tests.test_torch_plan import banded, both, shuffled_band


def _ramp(T, P=8, R=128):
    tile_vals = np.arange(T, dtype=np.float32)
    return np.broadcast_to(tile_vals[:, None, None], (T, P, R)).copy()


@pytest.mark.parametrize("T,B", [(64, 8), (64, 1), (32, 32)])
def test_checksum_ramp_matches_jax_and_closed_form(T, B):
    data = _ramp(T)
    want = np.add.reduceat(np.arange(T, dtype=np.float32),
                           np.arange(0, T, B)) * 8 * 128
    jax_sums = np.asarray(_checksum_stream(jnp.asarray(data), B)).ravel()
    got = checksum_stream_plain(torch.from_numpy(data), B).numpy()
    assert got.shape == (T // B,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, jax_sums, rtol=1e-6)


@pytest.mark.parametrize("T,P,R,B", [(32, 8, 128, 8), (16, 4, 64, 2)])
def test_checksum_random_matches_jax(T, P, R, B):
    data = np.random.default_rng(7).standard_normal((T, P, R)).astype(
        np.float32)
    jax_sums = np.asarray(_checksum_stream(jnp.asarray(data), B)).ravel()
    got = checksum_stream(torch.from_numpy(data), B).numpy()
    np.testing.assert_allclose(got, jax_sums, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, data.reshape(T // B, -1).sum(1),
                               rtol=1e-3, atol=1e-3)


def test_checksum_stream_rejects_bad_blocks():
    data = torch.zeros((10, 8, 128))
    with pytest.raises(ValueError, match="multiple of block"):
        checksum_stream(data, 4)
    with pytest.raises(ValueError, match=r"\(T, P, R\)"):
        checksum_stream(torch.zeros(1024), 1)
    with pytest.raises(NotImplementedError, match="float32"):
        checksum_stream(data.double(), 2)


@pytest.mark.parametrize("stream_bw", [None, 2.5e12])
def test_audit_dict_matches_jax(stream_bw):
    kw = dict(nnz=28_311_370, seconds=4.87e-5, bytes_moved=121_634_816,
              stream_bw=stream_bw)
    got = roofline.audit(StatRegistry({"nnz": 1}), **kw)
    want = jroofline.audit(JStats({"nnz": 1}), **kw)
    assert got == want
    assert ("roofline_fraction" in got) == bool(stream_bw)


def test_roofline_helpers_match_jax():
    assert roofline.spmv_roofline_nnz_per_s(3.35e12) == \
        jroofline.spmv_roofline_nnz_per_s(3.35e12)
    assert roofline.spmv_roofline_nnz_per_s(2e12, 6.0) == \
        jroofline.spmv_roofline_nnz_per_s(2e12, 6.0)
    assert roofline.sync(torch.tensor([[2.5, 1.0]])) == 2.5
    assert roofline.sync(np.array([3.0])) == 3.0


def test_time_marginal_counts_steps(monkeypatch):
    """A chain whose calls each cost 2^-5 s and whose steps each cost 2^-9
    s, on a fake clock that only the chain moves: the marginal is exactly
    the step's cost, free of the chain's fixed cost (the times are exact
    in binary, so no rounding enters)."""
    import types

    now = [0.0]
    monkeypatch.setattr(roofline, "time", types.SimpleNamespace(
        perf_counter=lambda: now[0]))

    def make(n):
        def go():
            now[0] += 2.0 ** -5                  # fixed cost per call
            for _ in range(n):
                now[0] += 2.0 ** -9
            return torch.zeros(1)
        return go

    assert roofline.time_marginal(make, i1=2, i2=6, repeats=2) == 2.0 ** -9


@pytest.mark.parametrize("mode", ["read", "readwrite"])
def test_measure_stream_bandwidth_on_cpu(mode):
    bw = roofline.measure_stream_bandwidth(64 << 10, mode=mode,
                                           device="cpu")
    assert np.isfinite(bw) and bw > 0
    with pytest.raises(ValueError, match="mode"):
        roofline.measure_stream_bandwidth(4096, mode="write", device="cpu")


OPERATORS = {
    "dia": lambda: banded(2048, [-3, 0, 1, 5], seed=1),
    "window": lambda: shuffled_band(1024, seed=2),
}


@pytest.mark.parametrize("kind", sorted(OPERATORS))
def test_operator_audit_matches_jax(kind):
    m = OPERATORS[kind]()
    ja, pa = both(m)
    jop = JSparseOperator.from_matrix(ja)
    op = SparseOperator.from_matrix(pa, device="cpu")
    assert op.strategy == jop.strategy
    want = jop.audit(iters=2, stream_bw=1e11)
    got = op.audit(iters=2, stream_bw=1e11)
    audit_keys = {"seconds", "gnnz_per_s", "achieved_gb_per_s",
                  "peak_gb_per_s", "roofline_fraction"}
    assert audit_keys <= set(want) and audit_keys <= set(got)
    assert set(want) <= set(got)
    assert got["seconds"] > 0 and got["peak_gb_per_s"] == 100.0
    # the byte model: achieved GB/s times seconds is bytes_per_apply
    bytes_moved = got["achieved_gb_per_s"] * 1e9 * got["seconds"]
    want_bytes = want["achieved_gb_per_s"] * 1e9 * want["seconds"]
    assert op.stats["bytes_per_apply"] == jop.stats["bytes_per_apply"]
    np.testing.assert_allclose(bytes_moved, want_bytes, rtol=1e-9)
    np.testing.assert_allclose(bytes_moved, op.stats["bytes_per_apply"],
                               rtol=1e-9)
    np.testing.assert_allclose(got["gnnz_per_s"] * 1e9 * got["seconds"],
                               op.stats["nnz"], rtol=1e-9)


def test_operator_audit_rectangular_on_cpu():
    _, pa = both(banded(300, [0, 100], seed=3, cols=520))
    op = SparseOperator.from_matrix(pa, device="cpu")
    out = op.audit(iters=2)
    assert out["seconds"] > 0 and "roofline_fraction" not in out
