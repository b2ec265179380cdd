"""Port parity for the float16, int8, uint8, int16, uint16 and uint64
value plans under every semiring they take: the SELL strategies
(window, resident, deep, stream) under plus_times, max_times and
or_and, and the ChunkPlan and CachedPlan under max_times, against the
JAX package's apply of its own plan (Pallas in interpret mode) and the
exact product (``tests/test_torch_dtypes_narrow.py`` ``check_y``).
Under max_times each product wraps to the value type before the max, as
in the reference, and the padding's 0 takes part wherever the
reference's layout has padding: rows whose every product wraps negative
read 0 on both sides.
"""

import numpy as np
import pytest

from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import semiring as jsr
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from tests.test_torch_dtypes import jax_y
from tests.test_torch_dtypes_apply import FAMILIES, STRATEGIES
from tests.test_torch_dtypes_narrow import KINDS, check_y, typed, typed_x
from tests.test_torch_dtypes_narrow_apply import _apply
from tests.test_torch_plan import both


@pytest.mark.parametrize("semiring,strategy", [
    (s, t) for s in ("plus_times", "max_times") for t in sorted(STRATEGIES)]
    + [("or_and", "window"), ("or_and", "deep")])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_sell_strategies_match_jax(kind, strategy, semiring):
    nonneg = semiring != "plus_times"
    m = typed(STRATEGIES[strategy](), kind, nonneg=nonneg)
    x = typed_x(kind, m.shape[1], nonneg=nonneg)
    if semiring == "or_and":
        m.data = (m.data > 0.5).astype(np.float64)
        x = (x > 0.5).astype(x.dtype)
    ja, pa = both(m)
    pad = float(jsr.get(semiring).zero)
    jp = jplan.build_sell_plan(ja, value_dtype=KINDS[kind], pad_value=pad)
    pp = pplan.build_sell_plan(pa, value_dtype=KINDS[kind], pad_value=pad)
    assert (pp.stats.window_blocks > 0) == (strategy == "window")
    y = _apply(pp, x, semiring=semiring, strategy=strategy)
    want = jax_y(jp, x, semiring, strategy)
    if semiring == "or_and":
        np.testing.assert_array_equal(y.numpy(), want.astype(
            y.numpy().dtype))
        assert set(np.unique(want)) <= {0, 1}
    else:
        check_y(y, want, m, x, kind, semiring)


@pytest.mark.parametrize("family", ["chunk", "cached"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_max_times_matches_jax(kind, family):
    m = typed(FAMILIES[family][0](), kind, nonneg=True)
    x = typed_x(kind, m.shape[1], nonneg=True)
    ja, pa = both(m)
    jp = jplan.auto_plan(ja, value_dtype=KINDS[kind], semiring="max_times")
    pp = pplan.auto_plan(pa, value_dtype=KINDS[kind], semiring="max_times")
    assert type(pp).__name__ == type(jp).__name__ == FAMILIES[family][1]
    check_y(_apply(pp, x, semiring="max_times"),
            jax_y(jp, x, "max_times"), m, x, kind, "max_times")


@pytest.mark.parametrize("family", ["window", "chunk", "cached"])
@pytest.mark.parametrize("kind", ["i8", "i16"])
def test_wrapped_negative_products_meet_the_padding(kind, family):
    # every product wraps negative (15 * 15 = 225 is -31 in int8; 255 *
    # 255 is -511 in int16): the reference's max takes its padding's 0
    # in every row, and so does each route of the port, the chunk light
    # route (which reads no padding slot) included
    v = 15 if kind == "i8" else 255
    m = typed(FAMILIES[family][0](), kind)
    m.data[:] = v
    x = np.full(m.shape[1], v, KINDS[kind])
    ja, pa = both(m)
    jp = jplan.auto_plan(ja, value_dtype=KINDS[kind], semiring="max_times")
    pp = pplan.auto_plan(pa, value_dtype=KINDS[kind], semiring="max_times")
    want = jax_y(jp, x, "max_times")
    y = _apply(pp, x, semiring="max_times")
    assert np.all(want == 0)
    np.testing.assert_array_equal(y.numpy(), want)
