"""x of the wrong length: the port refuses it on every plan family.

``spmv_plan``, ``spmv_sharded`` and ``spmv_dia_sharded`` raise
``ValueError`` when x does not have the plan's column count, here five
entries short and five long.  The JAX package raises ``ValueError`` too,
when it writes x into its padded x image, on every family checked here
but two, which the port refuses on purpose (ROADMAP.md queue 3): a
CachedPlan and a bare CooTail, whose gathers clamp and return a y.  The
SpMM row count is checked the same way: the port's ``op @ B`` refuses a
B five rows short or long, where the reference returns a Y.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from spmv_vector_cache_tpu.formats import cached as jcached
from spmv_vector_cache_tpu.formats import chunk as jchunk
from spmv_vector_cache_tpu.formats import dia as jdia
from spmv_vector_cache_tpu.formats import packed as jpacked
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import operator as joperator
from spmv_vector_cache_tpu.ops import spmv_pallas as jsell
from spmv_vector_cache_tpu_torch.formats import cached as pcached
from spmv_vector_cache_tpu_torch.formats import chunk as pchunk
from spmv_vector_cache_tpu_torch.formats import dia as pdia
from spmv_vector_cache_tpu_torch.formats import packed as ppacked
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from spmv_vector_cache_tpu_torch.parallel import (build_sharded_dia_plan,
                                                  build_sharded_plan,
                                                  make_mesh,
                                                  spmv_dia_sharded,
                                                  spmv_sharded)
from tests.test_torch_cached import few_columns
from tests.test_torch_chunk import pareto_banded
from tests.test_torch_plan import (banded, both, hybrid, random_sparse,
                                   shuffled_band)

# the modules (each package re-exports a function of the module's name)
jsh = importlib.import_module("spmv_vector_cache_tpu.parallel.spmv_sharded")
jdia_sh = importlib.import_module("spmv_vector_cache_tpu.parallel.dia_sharded")

#: family -> (matrix, maker of (JAX plan, port plan) from both
#: containers, strategy, whether the reference raises too)
FAMILIES = {
    "dia": (lambda: banded(1024, [-2, 0, 3], seed=1),
            lambda ja, pa: (jdia.build_dia_plan(ja),
                            pdia.build_dia_plan(pa)), "auto", True),
    "hybrid": (lambda: hybrid(4096, seed=6),
               lambda ja, pa: (jplan.auto_plan(ja), pplan.auto_plan(pa)),
               "auto", True),
    "sell_window": (lambda: shuffled_band(1024, seed=3),
                    lambda ja, pa: (jplan.build_sell_plan(ja),
                                    pplan.build_sell_plan(pa)),
                    "window", True),
    "sell_window_f64": (lambda: shuffled_band(1024, seed=3),
                        lambda ja, pa: (
                            jplan.build_sell_plan(ja, value_dtype=np.float64),
                            pplan.build_sell_plan(pa,
                                                  value_dtype=np.float64)),
                        "window", True),
    "sell_resident": (lambda: random_sparse(300, 1500, 0.02, seed=1),
                      lambda ja, pa: (
                          jplan.build_sell_plan(ja, max_window_blocks=4),
                          pplan.build_sell_plan(pa, max_window_blocks=4)),
                      "resident", True),
    "chunk": (lambda: pareto_banded(n=2048, seed=3, cap=512),
              lambda ja, pa: (jchunk.build_chunk_plan(ja),
                              pchunk.build_chunk_plan(pa)), "auto", True),
    "packed": (lambda: random_sparse(2048, 2048, 0.01, seed=4),
               lambda ja, pa: (jpacked.build_packed_plan(ja),
                               ppacked.build_packed_plan(pa)), "auto", True),
    # the reference's gathers clamp: it returns a y; the port refuses
    "cached": (few_columns,
               lambda ja, pa: (jcached.build_cached_plan(ja),
                               pcached.build_cached_plan(pa)),
               "auto", False),
    "coo_tail": (lambda: random_sparse(300, 500, 0.02, seed=5),
                 lambda ja, pa: (jcached.coo_tail_from_csr(ja),
                                 pcached.coo_tail_from_csr(pa)),
                 "auto", False),
}


@pytest.mark.parametrize("delta", [-5, 5])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spmv_plan_refuses_x_of_another_length(family, delta):
    make, build, strategy, ref_raises = FAMILIES[family]
    m = make()
    ja, pa = both(m)
    jp, pp = build(ja, pa)
    assert jp is not None and type(jp).__name__ == type(pp).__name__
    plan = pplan.place(pp, "cpu")
    cols = m.shape[1]
    x = np.random.default_rng(7).standard_normal(cols + delta).astype(
        np.float32)
    with pytest.raises(ValueError, match=f"{cols} columns"):
        psell.spmv_plan(plan, torch.from_numpy(x), strategy=strategy)
    # the right length still runs
    y = psell.spmv_plan(plan, torch.from_numpy(x[:cols] if delta > 0 else
                                               np.pad(x, (0, -delta))),
                        strategy=strategy)
    assert y.shape == (m.shape[0],)
    jplan_dev = jp.to_device() if hasattr(jp, "to_device") else jp
    if ref_raises:
        with pytest.raises(ValueError):
            jsell.spmv_plan(jplan_dev, x, strategy=strategy, interpret=True)
    else:
        want = np.asarray(jsell.spmv_plan(jplan_dev, x, strategy=strategy,
                                          interpret=True))
        assert want.shape == (m.shape[0],)


@pytest.mark.parametrize("delta", [-5, 5])
def test_operator_refuses_x_of_another_length(delta):
    # the operator's apply goes through spmv_plan
    ja, pa = both(shuffled_band(1024, seed=8))
    op = SparseOperator.from_matrix(pa, device="cpu")
    with pytest.raises(ValueError, match="1024 columns"):
        op @ np.ones(1024 + delta, np.float32)
    with pytest.raises(ValueError):
        joperator.SparseOperator.from_matrix(ja) @ np.ones(1024 + delta,
                                                           np.float32)


@pytest.fixture
def jax8():
    """The JAX package's sharded applies need its 8 virtual CPU devices
    (``tests/conftest.py``)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")


@pytest.mark.parametrize("delta", [-5, 5])
@pytest.mark.parametrize("mode", ["halo", "all_gather"])
def test_spmv_sharded_refuses_x_of_another_length(jax8, mode, delta):
    m = banded(1024, [-1, 0, 1], seed=9)
    ja, pa = both(m)
    x = np.ones(1024 + delta, np.float32)
    with pytest.raises(ValueError, match="1024 columns"):
        spmv_sharded(build_sharded_plan(pa, 8), x,
                     make_mesh(8, device="cpu"), mode=mode)
    with pytest.raises(ValueError):
        jsh.spmv_sharded(jsh.build_sharded_plan(ja, 8), x, jsh.make_mesh(8),
                         mode=mode, use_pallas=False)


@pytest.mark.parametrize("delta", [-5, 5])
def test_spmv_dia_sharded_refuses_x_of_another_length(jax8, delta):
    m = banded(1024, [-1, 0, 1], seed=10)
    ja, pa = both(m)
    x = np.ones(1024 + delta, np.float32)
    with pytest.raises(ValueError, match="1024 columns"):
        spmv_dia_sharded(build_sharded_dia_plan(pa, 4), x,
                         make_mesh(4, device="cpu"))
    with pytest.raises(ValueError):
        jdia_sh.spmv_dia_sharded(
            jax.tree.map(jax.numpy.asarray,
                         jdia_sh.build_sharded_dia_plan(ja, 4)),
            x, jsh.make_mesh(4))


@pytest.mark.parametrize("delta", [-5, 5])
@pytest.mark.parametrize("kind", ["dia", "sell_window", "packed"])
def test_spmm_refuses_b_of_another_row_count(kind, delta):
    make = {"dia": lambda: banded(1024, [-2, 0, 3], seed=11),
            "sell_window": lambda: shuffled_band(1024, seed=12),
            "packed": lambda: random_sparse(2048, 2048, 0.01, seed=13)}[kind]
    m = make()
    ja, pa = both(m)
    b = np.random.default_rng(14).standard_normal(
        (m.shape[1] + delta, 4)).astype(np.float32)
    op = SparseOperator.from_matrix(pa, device="cpu")
    with pytest.raises(ValueError):
        op @ b
    # the reference returns a Y of the operator's rows
    want = np.asarray(joperator.SparseOperator.from_matrix(ja) @ b)
    assert want.shape == (m.shape[0], 4)
