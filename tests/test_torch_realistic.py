"""Port parity: the port's matrix generators equal the JAX package's.

``chip_smoke.py`` builds the ``scircuit_like`` and ``mac_econ_like``
matrices on a machine without JAX, from the port's copy of
``tools/realistic.py``; both copies must give the same CSR arrays byte
for byte (``indptr``, ``indices``, ``data``, dtypes and shape).
"""

import pytest

from spmv_vector_cache_tpu.tools import realistic as jrealistic
from spmv_vector_cache_tpu_torch.tools import realistic as prealistic


@pytest.mark.parametrize("name", sorted(jrealistic.MATRICES))
def test_generator_byte_equal(name):
    want = jrealistic.generate(name)
    got = prealistic.generate(name)
    assert tuple(got.shape) == tuple(want.shape)
    for f in ("indptr", "indices", "data"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f
        assert a.tobytes() == b.tobytes(), f


def test_generators_listed_alike():
    assert sorted(prealistic.MATRICES) == sorted(jrealistic.MATRICES)
    for name, (_, note) in jrealistic.MATRICES.items():
        assert prealistic.MATRICES[name][1] == note
