"""Port parity for the sharded plans of float16, int8, uint8, int16,
uint16 and uint64 values: ``build_sharded_plan`` and
``build_sharded_dia_plan`` against the JAX package's (uint64 values as
uint32), and ``spmv_sharded``, ``spmm_sharded`` and ``spmv_dia_sharded``
on ``make_mesh(8 or 4, device="cpu")`` against the exact product (the
integers, exactly) and the one float16 rounding bound.  Needs the 8
virtual JAX devices of ``tests/conftest.py``.
"""

import importlib

import jax
import numpy as np
import pytest

from spmv_vector_cache_tpu_torch.parallel import (
    build_sharded_dia_plan, build_sharded_plan, make_mesh, spmm_sharded,
    spmv_dia_sharded, spmv_sharded)
from spmv_vector_cache_tpu_torch.parallel.mesh import stacked_numpy
from tests.test_torch_dtypes_narrow import (KINDS, Y_DTYPE, exact,
                                            f16_bound_ok, ref_array, typed,
                                            typed_x)
from tests.test_torch_plan import banded, both, random_sparse, shuffled_band

jsh = importlib.import_module("spmv_vector_cache_tpu.parallel.spmv_sharded")
jdia_sh = importlib.import_module("spmv_vector_cache_tpu.parallel.dia_sharded")

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")


def _check(y, m, x, kind):
    assert y.dtype == Y_DTYPE[kind]
    if kind == "f16":
        assert f16_bound_ok(y.numpy(), m, x)
    else:
        np.testing.assert_array_equal(y.numpy(), exact(m, x, kind))


def _assert_stacks_equal(port, ref):
    got = stacked_numpy(port)
    for name in port._array_fields:
        a, b = getattr(got, name), ref_array(getattr(ref, name), name)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("case", ["window", "no_window"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_sharded_sell(kind, case):
    m = typed(shuffled_band(2048, seed=3) if case == "window" else
              random_sparse(1024, 1024, 0.05, seed=6), kind)
    kw = {} if case == "window" else dict(max_window_blocks=1)
    ja, pa = both(m)
    port = build_sharded_plan(pa, 8, value_dtype=KINDS[kind], **kw)
    _assert_stacks_equal(port, jsh.build_sharded_plan(
        ja, 8, value_dtype=KINDS[kind], **kw))
    assert (port.window_blocks > 0) == (case == "window")
    mesh = make_mesh(8, device="cpu")
    x = typed_x(kind, m.shape[1])
    for mode in ("all_gather", "halo") if case == "window" else \
            ("all_gather",):
        _check(spmv_sharded(port, x, mesh, mode=mode), m, x, kind)
    b = np.stack([typed_x(kind, m.shape[1], seed=s) for s in (4, 5)], 1)
    Y = spmm_sharded(port, b, mesh)
    assert Y.dtype == Y_DTYPE[kind]
    for j in range(2):
        _check(Y[:, j].contiguous(), m, b[:, j], kind)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_sharded_dia(kind):
    n, D = 4096, 4
    m = typed(banded(n, [-130, -1, 0, 1, 130], seed=20), kind)
    ja, pa = both(m)
    port = build_sharded_dia_plan(pa, D, sublanes=8, value_dtype=KINDS[kind])
    _assert_stacks_equal(port, jdia_sh.build_sharded_dia_plan(
        ja, D, sublanes=8, value_dtype=KINDS[kind]))
    x = typed_x(kind, n)
    _check(spmv_dia_sharded(port, x, make_mesh(D, device="cpu")), m, x, kind)
