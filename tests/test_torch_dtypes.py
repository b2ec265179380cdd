"""Port parity for the bfloat16, int32, uint32 and int64 value plans: the
value policy, the host plans byte for byte, the byte accounting, and the
reference's faults that the port does not copy.

* ``formats.plan.value_kind`` and its refusals; bfloat16 rounding (torch,
  to nearest even) against ``ml_dtypes``' (the JAX package's);
* every plan family's slabs against the JAX package's: a bfloat16 slab
  equal to the JAX plan's as uint16 bits, int32 and uint32 slabs byte for
  byte, an int64 plan's values equal as int32 (the reference's host plan
  keeps int64 and narrows on the device); every other array and the
  stats equal;
* ``plan_bytes_per_apply`` counts x, y and the partials of a bfloat16
  plan at float32's 4 bytes;
* reference faults: an integer plan under min_plus or max_plus (the
  reference pads with INT_MIN: y off by about 2^31) and an int64 value
  past int32 (the reference wraps it) raise in the port.

The applies and the SpMM of these plans are in
``tests/test_torch_dtypes_apply.py`` and ``tests/test_torch_dtypes_spmm.py``,
which share the helpers below.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
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
from spmv_vector_cache_tpu_torch.interop import plan_to_numpy
from spmv_vector_cache_tpu_torch.ops import strategy as pstrategy
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from spmv_vector_cache_tpu_torch.tools import realistic
from tests.test_torch_cached import zipf_cols
from tests.test_torch_packed import mac_econ_small
from tests.test_torch_plan import banded, both, shuffled_band

#: the value types ported, by the short names the tests use
KINDS = {"bf16": jnp.bfloat16, "i32": np.int32, "u32": np.uint32,
         "i64": np.int64}
#: the type of y (and of x as the tests hand it over) for each kind
Y_DTYPE = {"bf16": torch.float32, "i32": torch.int32, "u32": torch.uint32,
           "i64": torch.int32}
#: the bound for a bfloat16 plan's y: float32 sums of the same rounded
#: products in another order, relative to max(1, max|y|)
BF16_RTOL = 1e-5
#: the fields of a plan that hold matrix values
VALUE_FIELDS = ("vals", "ov_vals", "window_mask")


# ---------------------------------------------------------------------------
# helpers shared by the dtype tests
# ---------------------------------------------------------------------------

def typed(m, kind, seed=0, nonneg=False):
    """``m`` (scipy) with values for ``kind``: N(0, 1) for bfloat16 (its
    absolute value for the max semirings), integers in [-9, 9] for int32
    and int64 ([0, 9] when ``nonneg``) and in [0, 9] for uint32; float64,
    as the reference's builders take it, and sorted."""
    m = sp.csr_matrix(m, dtype=np.float64)
    m.sum_duplicates()
    m.sort_indices()
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        v = rng.standard_normal(m.nnz)
        m.data = np.abs(v) if nonneg else v
    else:
        lo = 0 if nonneg or kind == "u32" else -9
        m.data = rng.integers(lo, 10, m.nnz).astype(np.float64)
    return m


def typed_x(kind, n, seed=1, nonneg=False) -> np.ndarray:
    """x in the type a plan of ``kind`` reads it in (int32 for int64)."""
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        x = rng.standard_normal(n).astype(np.float32)
        return np.abs(x) if nonneg else x
    lo = 0 if nonneg or kind == "u32" else -9
    return rng.integers(lo, 10, n).astype(
        np.uint32 if kind == "u32" else np.int32)


def rounded(m):
    """``m`` with its values rounded to bfloat16 (held in float64)."""
    m = m.copy()
    m.data = m.data.astype(ml_dtypes.bfloat16).astype(np.float64)
    return m


def exact_product(m, x, kind, semiring="plus_times") -> np.ndarray:
    """What an integer plan's y must be: the int64 product wrapped mod
    2^32 into the y type; under max_times (non-negative values) each
    row's largest product, 0 for an empty row (the padding's 0)."""
    mi, xi = m.astype(np.int64), x.astype(np.int64)
    if semiring == "max_times":
        y = np.asarray(mi.multiply(xi[None, :]).max(axis=1).todense()) \
            .reshape(-1)
    else:
        y = mi @ xi
    y = (y & 0xFFFFFFFF).astype(np.uint32)
    return y if kind == "u32" else y.view(np.int32)


def check_y(y, want_jax, m, x, kind, semiring="plus_times"):
    """The port's y against the JAX package's y and the exact product:
    its type, and equality for the integers, or 1e-5 relative for
    bfloat16 (against JAX, and against float64 over the rounded values
    under plus_times)."""
    assert isinstance(y, torch.Tensor) and y.dtype == Y_DTYPE[kind]
    got = y.numpy()
    want_jax = np.asarray(want_jax)
    if kind == "bf16":
        assert want_jax.dtype == np.float32
        scale = max(1.0, float(np.abs(want_jax).max()))
        assert np.abs(got - want_jax).max() / scale <= BF16_RTOL
        if semiring == "plus_times":
            want64 = rounded(m) @ x.astype(np.float64)
            assert np.abs(got - want64).max() / max(
                1.0, float(np.abs(want64).max())) <= BF16_RTOL
        return
    assert want_jax.dtype == got.dtype
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, exact_product(m, x, kind, semiring))


def small(plan):
    """A JAX plan with one 8-tile group per grid step in every SELL part
    (the step sets only how the interpreted kernel is blocked, and a
    small one keeps it quick to compile); arrays unchanged."""
    name = type(plan).__name__
    if name == "SellPlan":
        return dataclasses.replace(plan, stats=dataclasses.replace(
            plan.stats, groups_per_step=1))
    if name == "HybridPlan":
        return dataclasses.replace(plan, rest=small(plan.rest))
    if name == "CachedPlan":
        return dataclasses.replace(
            plan, hot=small(plan.hot),
            cold=None if plan.cold is None else small(plan.cold))
    if name == "ChunkPlan":
        return dataclasses.replace(
            plan, buckets=tuple(small(b) for b in plan.buckets),
            hbuckets=tuple(dataclasses.replace(h, groups_per_step=1)
                           for h in plan.hbuckets))
    return plan


def jax_y(plan, x, semiring="plus_times", strategy="auto"):
    """The JAX package's apply of its host plan, in interpret mode."""
    return np.asarray(jsell.spmv_plan(small(plan), x, interpret=True,
                                      semiring=semiring, strategy=strategy))


def ref_array(v, field: str) -> np.ndarray:
    """A JAX-package plan array as the port stores it: bfloat16 as its
    uint16 bits, an int64 plan's values as int32."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.int64 and field in VALUE_FIELDS:
        assert np.all(a.astype(np.int32) == a)
        return a.astype(np.int32)
    return a


def assert_slabs_equal(port, ref, path="plan"):
    """The port's host plan against the JAX package's, field by field:
    arrays (bfloat16 as bits, int64 values as int32) by dtype, shape and
    bytes, stats and scalars by value (a DIA plan of int64 values streams
    4 bytes a slot in the port, 8 in the reference's host plan)."""
    _same(plan_to_numpy(port), ref, path)


def _stats(plan, int64: bool) -> dict:
    d = plan.stats.as_dict()
    if int64 and "bytes_per_nnz" in d:
        d["bytes_per_nnz"] /= 2
    return d


def _same(port, ref, path):
    assert type(port).__name__ == type(ref).__name__, path
    int64 = getattr(getattr(ref, "vals", None), "dtype", None) == np.int64
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        where = f"{path}.{f.name}"
        if f.name == "stats":
            assert _stats(port, False) == _stats(ref, int64), where
        elif dataclasses.is_dataclass(b):
            _same(a, b, where)
        elif isinstance(b, tuple) and b and dataclasses.is_dataclass(b[0]):
            assert len(a) == len(b), where
            for i, (pa, pb) in enumerate(zip(a, b)):
                _same(pa, pb, f"{where}[{i}]")
        elif isinstance(b, np.ndarray):
            want = ref_array(b, f.name)
            assert (a.dtype, a.shape) == (want.dtype, want.shape), where
            assert a.tobytes() == want.tobytes(), where
        else:
            assert a == b, where


def scircuit_small(n=16384):
    """``tools/realistic.scircuit_like()``'s leading n x n block: power-law
    rows and some of its dense rail rows (a ChunkPlan with heavy rows)."""
    a = realistic.scircuit_like()
    m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)[:n, :n]
    m.sort_indices()
    return m


def zipf_small():
    """The report's zipf-column recipe at 8192 rows: a CachedPlan whose
    cold part is a CooTail."""
    return zipf_cols(8192, 1 << 18, 24, 2.0, 300, 3)


# ---------------------------------------------------------------------------
# the value policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,kind", [
    (np.float32, "f32"), (np.float64, "f64"), (jnp.bfloat16, "bf16"),
    ("bfloat16", "bf16"), (torch.bfloat16, "bf16"), (np.int32, "i32"),
    (np.int64, "i32"), (torch.int32, "i32"), (np.uint32, "u32"),
    (torch.uint32, "u32")])
def test_value_kind(dtype, kind):
    assert pplan.value_kind(dtype) == kind


@pytest.mark.parametrize("dtype,why", [
    (np.bool_, "wrong y"), (torch.bool, "wrong y"),
    (torch.float8_e4m3fn, "in float8"), (jnp.float8_e5m2, "in float8"),
    (np.complex64, "raises"), (torch.complex128, "raises")])
def test_other_value_dtypes_refused(dtype, why):
    # the types the reference half-takes are refused, with the reason
    m = banded(512, [-1, 0, 1], seed=0)
    _, pa = both(m)
    for build in (pplan.auto_plan, pdia.build_dia_plan):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build(pa, value_dtype=dtype)
        with pytest.raises(NotImplementedError, match=why):
            build(pa, value_dtype=dtype)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SparseOperator.from_matrix(pa, value_dtype=dtype, device="cpu")


def test_bf16_rounding_equals_ml_dtypes():
    # torch rounds float64 to bfloat16 through float32, to nearest even,
    # as ml_dtypes does: the same bits, ties and subnormals included
    rng = np.random.default_rng(0)
    mids = (np.arange(1, 2000, dtype=np.float32).view(np.uint32) << 16 |
            0x8000).view(np.float32).astype(np.float64)
    v = np.concatenate([rng.standard_normal(100000) * 10.0 ** rng.integers(
        -40, 38, 100000), mids, -mids, [0.0, -0.0, np.inf, -np.inf,
                                        1e-45, 3.3895e38]])
    got = torch.from_numpy(pplan.host_values(v, "bfloat16")).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    want = v.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# host plans byte for byte
# ---------------------------------------------------------------------------

SELL_CASES = {
    # a window plan, and one windowless (random columns over 40,000)
    "window": (lambda: shuffled_band(2048, seed=3), {}),
    "windowless": (lambda: sp.random(2048, 40000, density=0.003,
                                     random_state=4, format="csr"), {}),
    "split_sigma": (lambda: shuffled_band(2048, seed=5),
                    dict(split=8, sigma=512)),
}


@pytest.mark.parametrize("semiring", ["plus_times", "max_times"])
@pytest.mark.parametrize("case", sorted(SELL_CASES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sell_plan_byte_equal(kind, case, semiring):
    make, kw = SELL_CASES[case]
    m = typed(make(), kind, nonneg=semiring != "plus_times")
    ja, pa = both(m)
    pad = 0.0
    jp = jplan.build_sell_plan(ja, value_dtype=KINDS[kind], pad_value=pad,
                               **kw)
    pp = pplan.build_sell_plan(pa, value_dtype=KINDS[kind], pad_value=pad,
                               **kw)
    assert_slabs_equal(pp, jp)
    assert_slabs_equal(pplan.auto_plan(pa, value_dtype=KINDS[kind],
                                       semiring=semiring),
                       jplan.auto_plan(ja, value_dtype=KINDS[kind],
                                       semiring=semiring))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bf16_sell_plan_with_infinite_padding_byte_equal(kind):
    # min_plus pads with +inf: bfloat16 0x7f80; the integer kinds refuse
    m = typed(shuffled_band(1024, seed=6), kind, nonneg=True)
    ja, pa = both(m)
    if kind != "bf16":
        with pytest.raises(ValueError, match="integer plans"):
            pplan.build_sell_plan(pa, value_dtype=KINDS[kind],
                                  pad_value=float("inf"))
        return
    jp = jplan.auto_plan(ja, value_dtype=KINDS[kind], semiring="min_plus")
    pp = pplan.auto_plan(pa, value_dtype=KINDS[kind], semiring="min_plus")
    assert_slabs_equal(pp, jp)
    assert (plan_to_numpy(pp).vals == 0x7F80).any()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dia_and_hybrid_plans_byte_equal(kind):
    m = typed(banded(4096, list(range(-13, 14)), seed=1), kind)
    ja, pa = both(m)
    jp = jdia.build_dia_plan(ja, value_dtype=KINDS[kind])
    pp = pdia.build_dia_plan(pa, value_dtype=KINDS[kind])
    assert_slabs_equal(pp, jp)
    if kind == "bf16":
        assert pp.vals.dtype == torch.bfloat16
        assert pp.stats.bytes_per_nnz == jp.stats.bytes_per_nnz
    assert_slabs_equal(pplan.auto_plan(pa, value_dtype=KINDS[kind]),
                       jplan.auto_plan(ja, value_dtype=KINDS[kind]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_packed_plan_byte_equal(kind):
    m = typed(mac_econ_small(20000), kind)
    ja, pa = both(m)
    jp = jplan.auto_plan(ja, value_dtype=KINDS[kind])
    pp = pplan.auto_plan(pa, value_dtype=KINDS[kind])
    assert isinstance(pp, ppacked.PackedPlan)
    assert_slabs_equal(pp, jp)
    assert_slabs_equal(
        ppacked.build_packed_plan(pa, chunk_blocks=4, value_dtype=KINDS[kind]),
        jpacked.build_packed_plan(ja, chunk_blocks=4, value_dtype=KINDS[kind]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_packed_extract_tables_keep_the_value_type(kind):
    # kernel F's overflow values, regrouped by row at placement, stay in
    # the plan's value type (a bfloat16 plan's 2 bytes each) and bits
    _, pa = both(typed(mac_econ_small(20000), kind))
    host = ppacked.build_packed_plan(pa, chunk_blocks=4,
                                     value_dtype=KINDS[kind])
    assert host.ov_vals.shape[0] > 0
    tables = pplan.place(host, "cpu").tables
    want = torch.as_tensor(host.ov_vals)
    assert tables.ov_vals.dtype == want.dtype == (
        torch.bfloat16 if kind == "bf16" else Y_DTYPE[kind])
    order = torch.from_numpy(np.argsort(np.asarray(host.ov_rows),
                                        kind="stable"))
    width = torch.int16 if kind == "bf16" else torch.int32
    assert torch.equal(tables.ov_vals.view(width),
                       want.view(width)[order])


def test_plan_vals_dtype_of_a_chunk_plan_without_buckets():
    # a ChunkPlan's value type comes from its first part: a bucket, else
    # the heavy rows, else the residue; with none it holds no values
    from spmv_vector_cache_tpu_torch.ops.spmv_sell import plan_vals_dtype

    _, pa = both(typed(scircuit_small(), "i32"))
    pp = pchunk.build_chunk_plan(pa, value_dtype=np.int32)
    assert plan_vals_dtype(pp) == torch.int32
    bare = dataclasses.replace(pp, buckets=(), hbuckets=(),
                               residue=pcached.coo_tail_from_csr(pa, np.int32))
    assert plan_vals_dtype(bare) == torch.int32
    with pytest.raises(ValueError, match="no bucket and no residue"):
        plan_vals_dtype(dataclasses.replace(bare, residue=None))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_chunk_plan_byte_equal(kind):
    m = typed(scircuit_small(), kind)
    ja, pa = both(m)
    jp = jchunk.build_chunk_plan(ja, value_dtype=KINDS[kind])
    pp = pchunk.build_chunk_plan(pa, value_dtype=KINDS[kind])
    assert pp.buckets and pp.hbuckets       # light buckets and heavy rows
    assert_slabs_equal(pp, jp)
    auto = pplan.auto_plan(pa, value_dtype=KINDS[kind])
    assert isinstance(auto, pchunk.ChunkPlan)
    assert_slabs_equal(auto, jplan.auto_plan(ja, value_dtype=KINDS[kind]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cached_plan_and_coo_tail_byte_equal(kind):
    m = typed(zipf_small(), kind)
    ja, pa = both(m)
    jp = jplan.auto_plan(ja, value_dtype=KINDS[kind])
    pp = pplan.auto_plan(pa, value_dtype=KINDS[kind])
    assert isinstance(pp, pcached.CachedPlan)
    assert isinstance(pp.cold, pcached.CooTail)
    assert_slabs_equal(pp, jp)
    assert_slabs_equal(pcached.coo_tail_from_csr(pa, KINDS[kind]),
                       jcached.coo_tail_from_csr(ja, KINDS[kind]))


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["sell", "dia"])
def test_bytes_per_apply_counts_bf16_sums_as_float32(family):
    # the value stream halves; x, y and the partials stay 4 bytes
    m = shuffled_band(2048, seed=3) if family == "sell" else \
        banded(4096, list(range(-13, 14)), seed=1)
    _, pa = both(typed(m, "bf16"))
    build = pplan.build_sell_plan if family == "sell" else \
        pdia.build_dia_plan
    p32, p16 = build(pa), build(pa, value_dtype="bfloat16")
    assert p16.vals.element_size() == 2
    b32 = pstrategy.plan_bytes_per_apply(p32)
    b16 = pstrategy.plan_bytes_per_apply(p16)
    assert b32 - b16 == 2 * int(np.prod(tuple(p16.vals.shape)))
    rows, cols = p16.shape
    if family == "dia":
        assert b16 == 2 * p16.vals.numel() + 4 * (rows + cols)
    else:
        T, P, R = p16.vals.shape
        assert b16 > 2 * T * P * R + 2 * T * P * R + 4 * (rows + cols)


# ---------------------------------------------------------------------------
# reference faults the port does not copy
# ---------------------------------------------------------------------------

#: the integer types of every width, for the refusals below
INTEGER_KINDS = {**{k: KINDS[k] for k in ("i32", "u32", "i64")},
                 "i8": np.int8, "u8": np.uint8, "i16": np.int16,
                 "u16": np.uint16, "u64": np.uint64}


@pytest.mark.parametrize("semiring", ["min_plus", "max_plus"])
@pytest.mark.parametrize("kind", list(INTEGER_KINDS))
def test_integer_plans_refuse_infinite_zero_semirings(kind, semiring):
    n = 4096
    m = typed(banded(n, [-1, 0, 1], seed=2), kind, nonneg=True)
    ja, pa = both(m)
    x = typed_x(kind, n, nonneg=True)
    with pytest.raises(ValueError, match="integer plans"):
        SparseOperator.from_matrix(pa, value_dtype=INTEGER_KINDS[kind],
                                   semiring=semiring, device="cpu")
    with pytest.raises(ValueError, match="integer plans"):
        pplan.build_sell_plan(pa, value_dtype=INTEGER_KINDS[kind],
                              pad_value=float("inf"))
    if kind in ("i8", "i16") and semiring == "min_plus":
        # the reference pads with +inf cast to the narrow type: its y
        # falls below the true minimum in a tenth of the rows or more
        # (the int32 plan's below, by about 2^31, in every row)
        op = joperator.SparseOperator.from_matrix(
            ja, value_dtype=INTEGER_KINDS[kind], semiring="min_plus")
        y = np.asarray(op @ x.astype(INTEGER_KINDS[kind]))
        coo = m.tocoo()
        true = np.full(n, np.iinfo(np.int64).max)
        np.minimum.at(true, coo.row, coo.data.astype(np.int64)
                      + x[coo.col].astype(np.int64))
        wrong = y.astype(np.int64) != true
        assert wrong.sum() > n // 10
        assert np.all(y[wrong] < true[wrong])
        return
    if kind != "i32" or semiring != "min_plus":
        return
    # the reference casts the +inf padding to INT_MIN: every row of the
    # band sums INT_MIN + x somewhere, and y is off by about 2^31
    op = joperator.SparseOperator.from_matrix(ja, value_dtype=np.int32,
                                              semiring="min_plus")
    y = np.asarray(op @ x).astype(np.int64)
    coo = m.tocoo()
    true = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(true, coo.row, coo.data.astype(np.int64)
                  + x[coo.col].astype(np.int64))
    assert np.all(true - y > 2 ** 30)


@pytest.mark.parametrize("value", [3e9, -2.2e9])
def test_int64_values_outside_int32_raise(value):
    n = 4096
    m = typed(banded(n, [-1, 0, 1], seed=3), "i64")
    m.data[0] = value
    ja, pa = both(m)
    with pytest.raises(ValueError, match="does not fit int32"):
        SparseOperator.from_matrix(pa, value_dtype=np.int64, device="cpu")
    with pytest.raises(ValueError, match="does not fit int32"):
        pplan.build_sell_plan(pa, value_dtype=np.int64)
    # the reference keeps int64 on the host, narrows on the device and
    # returns a y wrapped mod 2^32 in row 0
    x = typed_x("i64", n)
    x[0] = 1
    op = joperator.SparseOperator.from_matrix(ja, value_dtype=np.int64)
    y = np.asarray(op @ x)
    want = m.astype(np.int64) @ x.astype(np.int64)
    assert y.dtype == np.int32
    assert y[0] != want[0] and (int(y[0]) - int(want[0])) % (1 << 32) == 0
    np.testing.assert_array_equal(y[2:], want[2:])
