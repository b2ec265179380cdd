"""Port parity: the SELL window path against the JAX package's.

The raw partials of the port's ``_window_partials`` (kernel B's plain
PyTorch version on CPU tensors) against the JAX ``_window_partials``
(its Pallas window kernel in interpret mode), folded and unfolded, for
all five semirings; then ``spmv_plan(strategy="window")`` y for the
three sub-row fixups (identity map, uniform parts, row_map segment
reduce).  Plans are carried over with ``plan_from_reference``.
Tolerances: rtol = atol = 2e-5 against JAX (float32, the JAX plan tests'
own bound); y against the float64 host loop below 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops import semiring as jsr
from spmv_vector_cache_tpu.ops import spmv_pallas as jsell
from spmv_vector_cache_tpu_torch.interop import plan_from_reference
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from tests.test_torch_plan import both, random_sparse, shuffled_band

SEMIRINGS = ("plus_times", "min_plus", "max_plus", "max_times", "or_and")


def _matrix_and_x(semiring, make, seed):
    """Matrix and x for a semiring: min_plus and max_times run on
    non-negative data (auto_plan requires it of max_times and or_and),
    or_and on {0, 1}."""
    m = make()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(m.shape[1]).astype(np.float32)
    if semiring in ("min_plus", "max_times"):
        m.data = np.abs(m.data)
        x = np.abs(x)
    elif semiring == "or_and":
        m.data = (np.abs(m.data) > 0.5).astype(np.float32)
        x = (x > 0).astype(np.float32)
    return m, x


# fold: the uniform-split layout folds each 2-tile group to one row;
# the plain layout (2 tiles per slice, 4-tile groups) cannot.  Eight
# groups per grid step keep the interpreted Pallas kernel small.
LAYOUTS = {
    True: (lambda: shuffled_band(2048, seed=1, per_row=20),
           dict(split=16, uniform_split=True, window_group_tiles=2,
                groups_per_step=8)),
    False: (lambda: random_sparse(700, 600, 0.02, seed=2),
            dict(groups_per_step=8)),
}


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_window_partials_match_jax(semiring, fold):
    make, kw = LAYOUTS[fold]
    m, x = _matrix_and_x(semiring, make, seed=3)
    ja, _ = both(m)
    jp = jplan.build_sell_plan(ja, pad_value=float(jsr.get(semiring).zero),
                               **kw)
    want, jfold = jsell._window_partials(jp.to_device(), x, True, semiring)
    assert jfold == fold
    got, pfold = psell._window_partials(plan_from_reference(jp, "cpu"),
                                        torch.from_numpy(x), semiring)
    assert pfold == fold
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


FIXUPS = {
    "identity": (lambda: random_sparse(500, 400, 0.03, seed=4),
                 dict(groups_per_step=8)),
    "uniform_parts": (lambda: shuffled_band(2048, seed=5),
                      dict(split=16, uniform_split=True,
                           window_group_tiles=2, groups_per_step=8)),
    "row_map": (lambda: random_sparse(400, 300, 0.05, seed=6),
                dict(split=8, sigma=512, groups_per_step=8)),
}


def _fixup_plan(fixup, semiring):
    make, kw = FIXUPS[fixup]
    m, x = _matrix_and_x(semiring, make, seed=7)
    ja, _ = both(m)
    jp = jplan.build_sell_plan(ja, pad_value=float(jsr.get(semiring).zero),
                               **kw)
    st = jp.stats
    assert jp.identity_map == (fixup == "identity")
    assert bool(st.uniform_parts) == (fixup == "uniform_parts")
    return ja, jp, x


@pytest.mark.parametrize("fixup", sorted(FIXUPS))
def test_spmv_window_matches_jax_and_host(fixup):
    ja, jp, x = _fixup_plan(fixup, "plus_times")
    want = np.asarray(jsell.spmv_plan(jp.to_device(), x, strategy="window"))
    y = psell.spmv_plan(plan_from_reference(jp, "cpu"), torch.from_numpy(x),
                        strategy="window").numpy()
    np.testing.assert_allclose(y, want, rtol=2e-5, atol=2e-5)
    want64 = jref.spmv_numpy(ja, x.astype(np.float64))
    assert np.abs(y - want64).max() / max(1.0, np.abs(want64).max()) < 1e-4


@pytest.mark.parametrize("fixup", ["uniform_parts", "row_map"])
@pytest.mark.parametrize("semiring", SEMIRINGS[1:])
def test_spmv_window_semirings_match_jax(fixup, semiring):
    _, jp, x = _fixup_plan(fixup, semiring)
    want = np.asarray(jsell.spmv_plan(jp.to_device(), x, strategy="window",
                                      semiring=semiring))
    y = psell.spmv_plan(plan_from_reference(jp, "cpu"), torch.from_numpy(x),
                        strategy="window", semiring=semiring).numpy()
    np.testing.assert_allclose(y, want, rtol=2e-5, atol=2e-5)


def test_unported_strategies_raise():
    # once unported, the resident, deep and stream strategies now run a
    # window plan's global columns on kernel G's plain version, as the
    # reference runs them
    ja, jp, x = _fixup_plan("identity", "plus_times")
    plan = plan_from_reference(jp, "cpu")
    for strategy in ("resident", "deep", "stream"):
        want = np.asarray(jsell.spmv_plan(jp.to_device(), x,
                                          strategy=strategy))
        y = psell.spmv_plan(plan, torch.from_numpy(x),
                            strategy=strategy).numpy()
        np.testing.assert_allclose(y, want, rtol=2e-5, atol=2e-5)


# kernel B's launch shape on the main path's window plans, by output
# rows: the shuffled band (16,384 tiles folded in groups of 2), a shard
# of sharded_sell (4,096 tiles, per tile), the Hybrid's rest (8,192
# tiles, per tile), its 2^18-row cut (2,048), the cut band under
# max_times (8,192 tiles folded) and the cached tier 1 (16,384 tiles
# folded); then a few output rows
WINDOW_CASES = {"band": 8192, "shard": 4096, "hybrid": 8192,
                "hybrid_cut": 2048, "band_cut_max": 4096, "cached": 8192,
                "few": 19, "one": 1}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_launch_shape(case):
    out_rows = WINDOW_CASES[case]
    shape = psell.window_launch_shape(out_rows, 128)
    L, n = shape.lanes_per_thread, shape.rows_per_cta
    # 4 lanes a thread, 4 output rows a CTA of 128 threads (whole warps)
    assert (L, n, shape.threads) == (4, 4, 128)
    assert shape.threads == n * 128 // L and shape.threads % 32 == 0
    # every output row once: CTA c holds rows [cn, (c + 1)n)
    assert shape.ctas == -(-out_rows // n) and (shape.ctas - 1) * n < out_rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.uint32,
                                   torch.int8, torch.uint8, torch.int16,
                                   torch.uint16])
@pytest.mark.parametrize("fold", [True, False])
def test_kernel_window_shape_of_every_build(fold, dtype):
    # one shape at every value width: the shuffled band's slab (16,384
    # tiles, groups of 2), folded or per tile
    vals = torch.zeros((16384, 8, 128), dtype=dtype)
    rows = 8192 if fold else 16384
    assert psell.kernel_window_shape(vals, 2, fold) == \
        psell.window_launch_shape(rows, 128) == \
        psell.WindowShape(4, 4, 128, rows // 4)
