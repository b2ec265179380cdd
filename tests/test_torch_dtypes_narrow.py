"""Port parity for the float16, int8, uint8, int16, uint16 and uint64
value plans: the value policy, the host plans byte for byte, the narrow
epilogues, and the reference's faults that the port does not copy.

* ``formats.plan.value_kind`` for the new types (the refusal of bool,
  float8 and complex, with its reason, is in
  ``tests/test_torch_dtypes.py``);
* float16 values rounded once, straight from float64, as the
  reference's ``astype`` rounds them (never through float32);
* every plan family's slabs against the JAX package's: float16, int8,
  uint8, int16 and uint16 slabs byte for byte in their own width, a
  uint64 plan's values equal as uint32 (the reference's host plan keeps
  uint64 and narrows on the device); every other array and the stats
  equal;
* ``ops/semiring.py``'s narrow policy: x rounded or wrapped to the value
  type, products wrapped before a max, y narrowed once;
* reference faults: float16 summed in float16 (its y breaks the one
  rounding bound the port keeps), the narrow integer plans under
  min_plus and max_plus (refused, as int32 plans are:
  ``tests/test_torch_dtypes.py``), and a uint64 value past 2^32 - 1
  (the reference wraps it; the port raises).

The applies are in ``tests/test_torch_dtypes_narrow_apply.py``, the
SpMM, sweeps and interop in ``tests/test_torch_dtypes_narrow_spmm.py``
and the sharded plans in ``tests/test_torch_dtypes_narrow_parallel.py``,
which share the helpers below.
"""

import dataclasses

import jax.numpy as jnp
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
from spmv_vector_cache_tpu_torch.formats import cached as pcached
from spmv_vector_cache_tpu_torch.formats import chunk as pchunk
from spmv_vector_cache_tpu_torch.formats import dia as pdia
from spmv_vector_cache_tpu_torch.formats import packed as ppacked
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.interop import plan_to_numpy
from spmv_vector_cache_tpu_torch.ops import semiring as psr
from spmv_vector_cache_tpu_torch.ops import strategy as pstrategy
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_dtypes import (SELL_CASES, VALUE_FIELDS,
                                     scircuit_small, zipf_small)
from tests.test_torch_packed import mac_econ_small
from tests.test_torch_plan import banded, both

#: the value types of this slice, by the short names the tests use
KINDS = {"f16": np.float16, "i8": np.int8, "u8": np.uint8, "i16": np.int16,
         "u16": np.uint16, "u64": np.uint64}
#: the type of y for each kind (uint64 plans run as uint32)
Y_DTYPE = {"f16": torch.float16, "i8": torch.int8, "u8": torch.uint8,
           "i16": torch.int16, "u16": torch.uint16, "u64": torch.uint32}
#: the integers each kind draws (products wrap: 8 bits from [0, 15],
#: 16 bits from [0, 255], uint64 past 2^32 from [0, 2^16))
RANGE = {"i8": (-15, 16), "u8": (0, 16), "i16": (-255, 256),
         "u16": (0, 256), "u64": (0, 1 << 16)}
#: float16 against JAX, relative to max(1, max|y|): the reference's own
#: error here is 2.5e-4 to 1.7e-3 (it sums in float16)
F16_JAX_RTOL = 4e-3


# ---------------------------------------------------------------------------
# helpers shared by the narrow dtype tests
# ---------------------------------------------------------------------------

def typed(m, kind, seed=0, nonneg=False):
    """``m`` (scipy) with values for ``kind``: N(0, 1) for float16 (its
    absolute value when ``nonneg``), else integers of :data:`RANGE`
    (from 0 when ``nonneg``); float64, sorted, as the builders take it."""
    m = sp.csr_matrix(m, dtype=np.float64)
    m.sum_duplicates()
    m.sort_indices()
    rng = np.random.default_rng(seed)
    if kind == "f16":
        v = rng.standard_normal(m.nnz)
        m.data = np.abs(v) if nonneg else v
    else:
        lo, hi = RANGE[kind]
        m.data = rng.integers(0 if nonneg else lo, hi, m.nnz).astype(
            np.float64)
    return m


def typed_x(kind, n, seed=1, nonneg=False) -> np.ndarray:
    """x as a caller hands it over: float32 for float16 (the apply rounds
    it), else the value type itself."""
    rng = np.random.default_rng(seed)
    if kind == "f16":
        x = rng.standard_normal(n).astype(np.float32)
        return np.abs(x) if nonneg else x
    lo, hi = RANGE[kind]
    return rng.integers(0 if nonneg else lo, hi, n).astype(KINDS[kind])


def rounded(m):
    """``m`` with its values rounded to float16 (held in float64)."""
    m = m.copy()
    m.data = m.data.astype(np.float16).astype(np.float64)
    return m


def exact(m, x, kind, semiring="plus_times") -> np.ndarray:
    """What an integer plan's y must be: the int64 product narrowed to
    the y type; under max_times (an unsigned kind) each row's largest
    product wrapped to the value type, 0 for an empty row."""
    mi, xi = m.astype(np.int64), x.astype(np.int64)
    yt = np.uint32 if kind == "u64" else KINDS[kind]
    if semiring == "max_times":
        p = mi.multiply(xi[None, :]).tocsr()
        p.data = p.data.astype(KINDS[kind]).astype(np.int64)
        assert p.data.min(initial=0) >= 0
        y = np.asarray(p.max(axis=1).todense()).reshape(-1)
    else:
        y = mi @ xi
    return y.astype(yt)


def f16_bound_ok(got, m, x) -> bool:
    """float16 y within one float16 rounding of the float64 product over
    the rounded values (2^-11 |y|), plus 1e-6 of max(1, max|y|) for the
    float32 sums under it, element by element."""
    want = rounded(m) @ x.astype(np.float16).astype(np.float64)
    err = np.abs(np.asarray(got, np.float64) - want)
    tol = 2.0 ** -11 * np.abs(want) + 1e-6 * max(1.0, np.abs(want).max())
    return bool(np.all(err <= tol))


def check_y(y, want_jax, m, x, kind, semiring="plus_times"):
    """The port's y against the JAX package's y and the exact product:
    its type; the integers equal to both (under max_times, the exact
    product for an unsigned kind only); float16 within
    :data:`F16_JAX_RTOL` of JAX and, under plus_times, within
    :func:`f16_bound_ok`."""
    assert isinstance(y, torch.Tensor) and y.dtype == Y_DTYPE[kind]
    got = y.numpy()
    want_jax = np.asarray(want_jax)
    if kind == "f16":
        ref = want_jax.astype(np.float64)
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(got.astype(np.float64) - ref).max() / scale <= \
            F16_JAX_RTOL
        if semiring == "plus_times":
            assert f16_bound_ok(got, m, x)
        return
    np.testing.assert_array_equal(got, want_jax.astype(got.dtype))
    assert want_jax.dtype == got.dtype
    if semiring == "plus_times" or not kind.startswith("i"):
        np.testing.assert_array_equal(got, exact(m, x, kind, semiring))


def ref_array(v, field: str) -> np.ndarray:
    """A JAX-package plan array as the port stores it: a uint64 plan's
    values as uint32."""
    a = np.asarray(v)
    if a.dtype == np.uint64 and field in VALUE_FIELDS:
        assert np.all(a.astype(np.uint32) == a)
        return a.astype(np.uint32)
    return a


def assert_slabs_equal(port, ref, path="plan"):
    """The port's host plan against the JAX package's, field by field:
    arrays (uint64 values as uint32) by dtype, shape and bytes, stats and
    scalars by value (a DIA plan of uint64 values streams 4 bytes a slot
    in the port, 8 in the reference's host plan)."""
    _same(plan_to_numpy(port), ref, path)


def _same(port, ref, path):
    assert type(port).__name__ == type(ref).__name__, path
    wide = getattr(getattr(ref, "vals", None), "dtype", None) == np.uint64
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        where = f"{path}.{f.name}"
        if f.name == "stats":
            want = b.as_dict()
            if wide and "bytes_per_nnz" in want:
                want["bytes_per_nnz"] /= 2
            assert a.as_dict() == want, where
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


# ---------------------------------------------------------------------------
# the value policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,kind", [
    (np.float16, "f16"), (torch.float16, "f16"), (jnp.float16, "f16"),
    (np.int8, "i8"), (torch.int8, "i8"), (np.uint8, "u8"),
    (torch.uint8, "u8"), (np.int16, "i16"), (torch.int16, "i16"),
    (np.uint16, "u16"), (torch.uint16, "u16"), (np.uint64, "u32"),
    (torch.uint64, "u32")])
def test_narrow_value_kind(dtype, kind):
    assert pplan.value_kind(dtype) == kind


def test_f16_rounding_is_the_reference_cast():
    # float64 rounded straight to float16, ties and subnormals included;
    # a round through float32 gives other bits on some values
    rng = np.random.default_rng(0)
    ulp = np.float64(2.0 ** -11)
    ties = np.arange(1, 2000) * 2 * ulp + ulp          # halfway in [1, 2)
    near = ties + 2.0 ** -40                           # just past a tie
    v = np.concatenate([rng.standard_normal(100000) * 10.0 ** rng.integers(
        -9, 5, 100000), ties, -ties, near, [0.0, -0.0, np.inf, -np.inf,
                                            6e-8, 65520.0, 7e4]])
    got = pplan.host_values(v, np.float16)
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got.view(np.uint16),
                                  v.astype(np.float16).view(np.uint16))
    twice = v.astype(np.float32).astype(np.float16)
    assert (twice.view(np.uint16) != got.view(np.uint16)).any()


# ---------------------------------------------------------------------------
# host plans byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("semiring", ["plus_times", "max_times"])
@pytest.mark.parametrize("case", sorted(SELL_CASES))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_sell_plan_byte_equal(kind, case, semiring):
    make, kw = SELL_CASES[case]
    m = typed(make(), kind, nonneg=semiring != "plus_times")
    ja, pa = both(m)
    jp = jplan.build_sell_plan(ja, value_dtype=KINDS[kind], pad_value=0.0,
                               **kw)
    pp = pplan.build_sell_plan(pa, value_dtype=KINDS[kind], pad_value=0.0,
                               **kw)
    assert pp.vals.dtype == (np.uint32 if kind == "u64" else KINDS[kind])
    assert_slabs_equal(pp, jp)
    assert_slabs_equal(pplan.auto_plan(pa, value_dtype=KINDS[kind],
                                       semiring=semiring),
                       jplan.auto_plan(ja, value_dtype=KINDS[kind],
                                       semiring=semiring))


def test_f16_sell_plan_with_infinite_padding_byte_equal():
    # min_plus pads with +inf: float16 0x7c00
    m = typed(SELL_CASES["window"][0](), "f16", nonneg=True)
    ja, pa = both(m)
    pp = pplan.auto_plan(pa, value_dtype=np.float16, semiring="min_plus")
    assert_slabs_equal(pp, jplan.auto_plan(ja, value_dtype=np.float16,
                                           semiring="min_plus"))
    assert (plan_to_numpy(pp).vals.view(np.uint16) == 0x7C00).any()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_dia_and_hybrid_plans_byte_equal(kind):
    m = typed(banded(4096, list(range(-13, 14)), seed=1), kind)
    ja, pa = both(m)
    jp = jdia.build_dia_plan(ja, value_dtype=KINDS[kind])
    pp = pdia.build_dia_plan(pa, value_dtype=KINDS[kind])
    assert_slabs_equal(pp, jp)
    assert pp.stats.bytes_per_nnz * pp.stats.nnz == pytest.approx(
        np.dtype(pp.vals.dtype).itemsize * pp.vals.size)
    assert_slabs_equal(pplan.auto_plan(pa, value_dtype=KINDS[kind]),
                       jplan.auto_plan(ja, value_dtype=KINDS[kind]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_packed_plan_byte_equal(kind):
    m = typed(mac_econ_small(20000), kind)
    ja, pa = both(m)
    pp = pplan.auto_plan(pa, value_dtype=KINDS[kind])
    assert isinstance(pp, ppacked.PackedPlan)
    assert_slabs_equal(pp, jplan.auto_plan(ja, value_dtype=KINDS[kind]))
    assert_slabs_equal(
        ppacked.build_packed_plan(pa, chunk_blocks=4, value_dtype=KINDS[kind]),
        jpacked.build_packed_plan(ja, chunk_blocks=4, value_dtype=KINDS[kind]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_packed_extract_tables_keep_the_value_type(kind):
    # kernel F's overflow values, regrouped by row at placement, keep the
    # slab's width and bits
    _, pa = both(typed(mac_econ_small(20000), kind))
    host = ppacked.build_packed_plan(pa, chunk_blocks=4,
                                     value_dtype=KINDS[kind])
    assert host.ov_vals.shape[0] > 0
    tables = pplan.place(host, "cpu").tables
    want = torch.from_numpy(host.ov_vals)
    assert tables.ov_vals.dtype == want.dtype == (
        torch.uint32 if kind == "u64" else Y_DTYPE[kind])
    order = torch.from_numpy(np.argsort(host.ov_rows, kind="stable"))
    assert torch.equal(psr.signed(tables.ov_vals),
                       psr.signed(want)[order])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_chunk_plan_byte_equal(kind):
    m = typed(scircuit_small(), kind)
    ja, pa = both(m)
    pp = pchunk.build_chunk_plan(pa, value_dtype=KINDS[kind])
    assert pp.buckets and pp.hbuckets       # light buckets and heavy rows
    assert_slabs_equal(pp, jchunk.build_chunk_plan(ja,
                                                   value_dtype=KINDS[kind]))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_narrow_cached_plan_and_coo_tail_byte_equal(kind):
    m = typed(zipf_small(), kind)
    ja, pa = both(m)
    pp = pplan.auto_plan(pa, value_dtype=KINDS[kind])
    assert isinstance(pp, pcached.CachedPlan)
    assert isinstance(pp.cold, pcached.CooTail)
    assert_slabs_equal(pp, jplan.auto_plan(ja, value_dtype=KINDS[kind]))
    assert_slabs_equal(pcached.coo_tail_from_csr(pa, KINDS[kind]),
                       jcached.coo_tail_from_csr(ja, KINDS[kind]))


@pytest.mark.parametrize("kind", ["f16", "i8", "u16"])
def test_bytes_per_apply_counts_narrow_sums_at_4_bytes(kind):
    # the value stream narrows; x and y stay 4 bytes (the sums' type)
    m = typed(banded(4096, list(range(-13, 14)), seed=1), kind)
    _, pa = both(m)
    p = pdia.build_dia_plan(pa, value_dtype=KINDS[kind])
    rows, cols = p.shape
    assert pstrategy.plan_bytes_per_apply(p) == \
        p.vals.size * p.vals.itemsize + 4 * (rows + cols)


# ---------------------------------------------------------------------------
# the narrow policy of ops/semiring.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["i8", "u8", "i16", "u16"])
def test_narrow_integer_policy(kind):
    dt = Y_DTYPE[kind]
    bits = 8 * dt.itemsize
    big = torch.tensor([3, 200, 70000, -5, -(1 << 31), (1 << 31) - 1],
                       dtype=torch.int64)
    # x wraps to the value type and is read as int32
    x = psr.as_x(big, dt)
    assert x.dtype == torch.int32 == psr.x_dtype(dt)
    want = big.numpy().astype(KINDS[kind]).astype(np.int64)
    assert x.tolist() == want.tolist()
    # a product wraps before the max (kernel_ops), as in the reference
    mul, red = psr.kernel_ops("max_times", dt)
    p = mul(torch.tensor([[15], [16]], dtype=torch.int32),
            torch.tensor([[15], [15]], dtype=torch.int32))
    top = red(p, 0).item()
    want_p = np.array([225, 240]).astype(KINDS[kind]).astype(np.int64)
    assert top == want_p.max()
    # y narrowed once, by one cast, mod 2^bits; an empty max (INT_MIN)
    # rises to the type's least value
    y = torch.tensor([1 << bits, (1 << bits) + 7, -(1 << 31)],
                     dtype=torch.int32)
    out = psr.finish_y(y, dt, "max_times")
    assert out.dtype == dt
    assert out.to(torch.int64).tolist() == [
        0, 7, int(np.iinfo(KINDS[kind]).min)]
    sums = torch.from_numpy(np.random.default_rng(0).integers(
        -(1 << 31), 1 << 31, 100000).astype(np.int32))
    sums[:4] = torch.tensor([-1, -(1 << 31), (1 << 31) - 1, 1 << (bits - 1)])
    got = psr.finish_y(sums, dt)
    assert got.dtype == dt
    np.testing.assert_array_equal(got.to(torch.int64).numpy(),
                                  sums.numpy().astype(KINDS[kind]))
    assert psr.y_dtype(dt) == dt


def test_f16_policy_rounds_x_and_y_once():
    x = torch.tensor([1.0 + 2.0 ** -12, 1e5, 3.0], dtype=torch.float64)
    xs = psr.as_x(x, torch.float16)
    assert xs.dtype == torch.float32
    assert xs.tolist() == x.to(torch.float16).float().tolist()
    y = torch.tensor([1.0 + 2.0 ** -11 + 2.0 ** -20, 70000.0])
    out = psr.finish_y(y, torch.float16)
    assert out.dtype == torch.float16
    assert out.tolist() == [1.0 + 2.0 ** -10, float("inf")]


# ---------------------------------------------------------------------------
# reference faults the port does not copy
# ---------------------------------------------------------------------------

def test_f16_reference_sums_in_float16():
    # the reference's float16 plans sum in float16: on a 27-diagonal band
    # its y breaks the one-rounding bound in many rows; the port's float32
    # sums, rounded once, keep it in every row
    m = typed(banded(4096, list(range(-13, 14)), seed=11), "f16")
    ja, pa = both(m)
    x = typed_x("f16", m.shape[1], seed=12)
    jy = np.asarray(joperator.SparseOperator.from_matrix(
        ja, value_dtype=np.float16) @ x)
    assert jy.dtype == np.float16
    assert not f16_bound_ok(jy, m, x)
    y = SparseOperator.from_matrix(pa, value_dtype=np.float16,
                                   device="cpu") @ x
    assert y.dtype == torch.float16
    assert f16_bound_ok(y.numpy(), m, x)


@pytest.mark.parametrize("value", [2.0 ** 32, 2.0 ** 40 + 3])
def test_uint64_values_outside_uint32_raise(value):
    n = 4096
    m = typed(banded(n, [-1, 0, 1], seed=3), "u64")
    m.data[0] = value
    ja, pa = both(m)
    with pytest.raises(ValueError, match="does not fit uint32"):
        SparseOperator.from_matrix(pa, value_dtype=np.uint64, device="cpu")
    with pytest.raises(ValueError, match="does not fit uint32"):
        pplan.build_sell_plan(pa, value_dtype=np.uint64)
    # the reference keeps uint64 on the host, narrows on the device and
    # returns a y wrapped mod 2^32 in row 0
    x = typed_x("u64", n)
    x[0] = 1
    y = np.asarray(joperator.SparseOperator.from_matrix(
        ja, value_dtype=np.uint64) @ x)
    want = m.astype(np.uint64) @ x.astype(np.uint64)
    assert y.dtype == np.uint32
    assert int(y[0]) != int(want[0])
    assert (int(y[0]) - int(want[0])) % (1 << 32) == 0
