"""Port parity: the PackedPlan family against the JAX package's.

The matrices of the JAX package's ``tests/test_packed.py`` (random at
several ``chunk_blocks``, dense rows with overflow, empty matrices and
unvisited windows), made from a seed with numpy, go through both
packages:

* ``build_packed_plan`` and ``auto_plan`` give byte-equal plans;
* pass A (kernel E's plain version) and ``spmv_packed`` (kernels E and F)
  agree with the JAX Pallas kernels in interpret mode to a max abs error
  <= 1e-5 * max(1, max|ref|): float32 sums in another order (the
  plain scan runs the reference's Hillis-Steele order, so it is usually
  exact);
* y agrees with the float64 host loop to 1e-4 * max(1, max|y|), the
  JAX package's own bound for these matrices;
* the tables placement builds for kernel F (each row's pieces, compacted
  from the dense extraction index, then its overflow, and F's work list)
  hold the plan's visits and overflow, in the plan's order within a row,
  and give the dense index's y bit for bit.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spmv_vector_cache_tpu.formats import packed as jpacked
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import operator as joperator
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops import spmv_packed as jspmv_packed
from spmv_vector_cache_tpu_torch.formats import packed as ppacked
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.formats import tables as ptables
from spmv_vector_cache_tpu_torch.interop import plan_from_reference
from spmv_vector_cache_tpu_torch.ops import semiring as psr
from spmv_vector_cache_tpu_torch.ops import spmv_packed as pspmv_packed
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops import strategy as pstrategy
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from spmv_vector_cache_tpu_torch.tools import graphs, realistic
from spmv_vector_cache_tpu_torch.utils import stats as pstats
from tests.test_torch_chunk import _assert_close
from tests.test_torch_plan import assert_plans_equal, both


def random_csr(rows, cols, density, seed=7):
    """Uniformly random positions (no repeats), N(0, 1) values."""
    rng = np.random.default_rng(seed)
    flat = rng.choice(rows * cols, int(rows * cols * density), replace=False)
    a = sp.csr_matrix((rng.standard_normal(flat.shape[0]).astype(
        np.float32), (flat // cols, flat % cols)), shape=(rows, cols))
    a.sort_indices()
    return a


def mac_econ_small(n=30000, seed=44):
    """``tools/realistic.mac_econ_like``'s recipe (1-10 nonzeros a row at
    N(0, 12000^2) column offsets, clipped, plus the diagonal) at n rows."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), rng.integers(1, 11, n))
    c = np.clip(r + (rng.standard_normal(r.shape[0]) * 12_000).astype(
        np.int64), 0, n - 1)
    key = np.unique(np.concatenate([r * n + c, np.arange(n) * (n + 1)]))
    a = sp.csr_matrix((rng.standard_normal(key.shape[0]).astype(np.float32),
                       (key // n, key % n)), shape=(n, n))
    a.sort_indices()
    return a


def one_per_row(rows, cols, seed=2):
    """One nonzero a row at a random column: no run crosses a 128-slot
    boundary, so the plan has no overflow."""
    rng = np.random.default_rng(seed)
    return sp.csr_matrix((rng.standard_normal(rows).astype(np.float32),
                          (np.arange(rows), rng.integers(0, cols, rows))),
                         shape=(rows, cols))


#: name -> (matrix, chunk_blocks)
CASES = {
    "narrow_cb8": (lambda: random_csr(300, 5000, 0.01), 8),
    "wide_cb64": (lambda: random_csr(1000, 40000, 0.002), 64),
    "dense_cb1": (lambda: random_csr(64, 64, 0.5), 1),
    "very_wide_cb32": (lambda: random_csr(500, 100000, 0.0005), 32),
    "many_windows_cb16": (lambda: random_csr(20000, 9000, 0.001), 16),
    "dense_rows_overflow": (lambda: random_csr(50, 3000, 0.3, seed=1), 4),
    "empty": (lambda: sp.csr_matrix((100, 200), dtype=np.float32), 32),
    "empty_windows": (lambda: sp.csr_matrix(
        (np.ones(3, np.float32), ([0, 1, 2], [5, 6, 7])),
        shape=(40000, 1000)), 2),
    "no_overflow": (lambda: one_per_row(20000, 7000), 4),
    "partial_last_window": (lambda: random_csr(2 * 8192 + 1700, 5000, 0.002,
                                               seed=4), 8),
    "mac_econ_small": (mac_econ_small, 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_packed_plan_byte_equal(case):
    make, cb = CASES[case]
    ja, pa = both(make())
    port = ppacked.build_packed_plan(pa, chunk_blocks=cb)
    assert_plans_equal(port, jpacked.build_packed_plan(ja, chunk_blocks=cb))
    if case in ("dense_rows_overflow", "mac_econ_small"):
        assert port.stats.overflow_nnz > 0
    if case == "no_overflow":
        assert port.stats.overflow_nnz == 0
    if case in ("partial_last_window", "mac_econ_small"):
        # the last window holds fewer than 8192 rows, and is visited
        assert port.shape[0] % 8192 and \
            port.wstep[-1] == port.stats.num_windows - 1
    assert np.all(np.diff(port.wstep) >= 0)     # kernel F's precondition


@pytest.mark.parametrize("case", sorted(CASES))
def test_spmv_packed_matches_jax_and_host(case):
    make, cb = CASES[case]
    m = make()
    ja, _ = both(m)
    x = np.random.default_rng(3).standard_normal(m.shape[1]).astype(
        np.float32)
    jp = jpacked.build_packed_plan(ja, chunk_blocks=cb)
    want = jspmv_packed.spmv_packed(jp, x, interpret=True)
    y = pspmv_packed.spmv_packed(plan_from_reference(jp, "cpu"),
                                 torch.from_numpy(x)).numpy()
    _assert_close(y, want)
    want64 = jref.spmv_numpy(ja, x.astype(np.float64))
    scale = max(1.0, float(np.abs(want64).max()))
    assert np.abs(y - want64).max() <= 1e-4 * scale
    if case == "empty_windows":
        assert np.all(y[3:] == 0)


def _with_overflow(jp, rows, cols, vals):
    """A JAX PackedPlan with COO entries appended to its overflow list."""
    return dataclasses.replace(
        jp, ov_rows=np.concatenate([np.asarray(jp.ov_rows),
                                    np.asarray(rows, np.int32)]),
        ov_cols=np.concatenate([np.asarray(jp.ov_cols),
                                np.asarray(cols, np.int32)]),
        ov_vals=np.concatenate([np.asarray(jp.ov_vals),
                                np.asarray(vals, np.float32)]))


def test_spmv_packed_unvisited_window_gives_its_overflow():
    """A window with no visit but with overflow rows: its rows are 0 plus
    their overflow (the reference masks the window, then adds the COO).
    build_packed_plan never makes one (a row with overflow has a primary
    piece), so the entries are appended to a plan by hand, two of them
    on one row to keep their order."""
    make, cb = CASES["empty_windows"]
    m = make()
    ja, _ = both(m)
    jp = jpacked.build_packed_plan(ja, chunk_blocks=cb)
    assert set(np.asarray(jp.wstep).tolist()) == {0}
    rows, cols = [17000, 17000, 20000, 39999], [3, 999, 500, 0]
    vals = [1.5, -2.0, 0.25, 4.0]
    jp = _with_overflow(jp, rows, cols, vals)
    x = np.random.default_rng(5).standard_normal(m.shape[1]).astype(
        np.float32)
    want = jspmv_packed.spmv_packed(jp, x, interpret=True)
    y = pspmv_packed.spmv_packed(plan_from_reference(jp, "cpu"),
                                 torch.from_numpy(x)).numpy()
    _assert_close(y, want)
    want64 = jref.spmv_numpy(ja, x.astype(np.float64))
    np.add.at(want64, rows, np.asarray(vals) * x[cols].astype(np.float64))
    scale = max(1.0, float(np.abs(want64).max()))
    assert np.abs(y - want64).max() <= 1e-4 * scale
    assert np.count_nonzero(y[8192:]) == 3


def _dense_rows(plan):
    """Each row's pieces read from the dense ``esrc``, in visit order:
    {row: [scan slot, ...]}."""
    st = plan.stats
    esrc = plan.esrc.reshape(plan.esrc.shape[0], -1).numpy()
    vi, lane = np.nonzero(esrc >= 0)
    rows = plan.wstep.numpy()[vi].astype(np.int64) * 8192 + lane
    slots = plan.sblock.numpy()[vi].astype(np.int64) * \
        (st.step_tiles * 1024) + esrc[vi, lane]
    got = {}
    for r, s in zip(rows.tolist(), slots.tolist()):
        got.setdefault(r, []).append(s)
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_tables_hold_the_visits_and_overflow(case):
    """Kernel F's tables: row r's entries are the scan slots of its
    pieces in visit order, as the dense ``esrc`` holds them, then its
    overflow entries, sorted by row with the plan's order kept within a
    row; the work list covers every row once, each CTA within F's unit
    or one row, the hubs first."""
    make, cb = CASES[case]
    _, pa = both(make())
    plan = pplan.place(ppacked.build_packed_plan(pa, chunk_blocks=cb),
                       "cpu")
    t = plan.tables
    rows = plan.shape[0]
    assert t.ncols == plan.shape[1] and t.slots == plan.vals.numel()
    assert t.pieces == plan.stats.num_pieces
    assert t.dense_entries == plan.esrc.numel()
    off = t.row_off.numpy().astype(np.int64)
    assert off.shape == (rows + 1,) and off[0] == 0
    assert np.all(np.diff(off) >= 0)
    ent = t.entries.numpy()
    assert off[-1] == ent.shape[0] == t.pieces + plan.stats.overflow_nnz
    pieces = _dense_rows(plan)
    ov_rows = plan.ov_rows.numpy()
    order = np.argsort(ov_rows, kind="stable")
    for r in range(rows):
        mine = ent[off[r]:off[r + 1]]
        want = pieces.get(r, [])
        assert mine[:len(want)].tolist() == want
        ov = -1 - mine[len(want):]
        assert np.all(ov >= 0)
        assert np.array_equal(order[ov], np.flatnonzero(ov_rows == r))
    for got, want in ((t.ov_cols, plan.ov_cols), (t.ov_vals, plan.ov_vals)):
        assert np.array_equal(got.numpy(), want.numpy()[order])
    units = t.units.numpy().astype(np.int64)
    assert np.array_equal(np.sort(units[:, 0]),
                          np.concatenate(([0], np.sort(units[:, 1])))[:-1])
    assert units[:, 1].max(initial=0) == rows
    size = (units[:, 1] - units[:, 0]) + off[units[:, 1]] - off[units[:, 0]]
    hub = size > t.unit
    assert np.all(units[hub, 1] - units[hub, 0] == 1)
    # the hubs first, then the rest in row order
    assert np.all(np.flatnonzero(hub) < np.flatnonzero(~hub).min(
        initial=hub.shape[0]))
    assert np.all(np.diff(units[~hub, 0]) > 0)


def test_packed_apply_needs_a_placed_plan():
    # kernel F's tables are built at placement; a plan whose arrays became
    # tensors some other way is refused before any apply
    _, pa = both(random_csr(50, 3000, 0.3, seed=1))
    host = ppacked.build_packed_plan(pa, chunk_blocks=4)
    unplaced = pplan.map_arrays(host, torch.from_numpy)
    assert unplaced.tables is None
    with pytest.raises(ValueError, match="placed"):
        pspmv_packed.spmv_packed(unplaced, torch.ones(3000))
    bad = dataclasses.replace(host, ov_cols=host.ov_cols + 3000)
    with pytest.raises(ValueError, match="outside"):
        ptables.extract_tables(bad)
    placed = pplan.place(host, "cpu")
    assert placed.tables.ov_vals.shape == \
        (host.stats.overflow_nnz,)


def test_extract_block_rows_is_kernel_fs():
    # placement cuts kernel F's work list by the merge steps a CTA of F
    # takes, constants of the CUDA source that the launch checks
    src = (Path(pspmv_packed.__file__).parent.parent / "csrc" /
           "spmv_packed.cu").read_text()
    threads = re.search(r"#define PACKED_F_THREADS (\d+)", src)
    items = re.search(r"#define PACKED_F_ITEMS (\d+)", src)
    assert threads and items
    assert int(threads.group(1)) * int(items.group(1)) == ptables.F_UNIT


def test_packed_apply_refuses_a_short_x():
    # kernel F reads x at the overflow columns unmasked, so x must be as
    # long as the plan is wide; the check runs before any launch
    make, cb = CASES["dense_rows_overflow"]
    _, pa = both(make())
    plan = pplan.place(ppacked.build_packed_plan(pa, chunk_blocks=cb),
                       "cpu")
    assert plan.stats.overflow_nnz > 0
    ncols = plan.shape[1]
    with pytest.raises(ValueError, match=f"{ncols} columns"):
        pspmv_packed.spmv_packed(plan, torch.ones(ncols - 1))
    assert pspmv_packed.spmv_packed(plan, torch.ones(ncols)).shape == \
        (plan.shape[0],)


def test_packed_rows_plain_adds_overflow_after_the_visits():
    """Kernel F's plain version on hand-made tables: the visits of row 0
    (window 0) and a row of window 2, then the overflow of rows 0, 9 and
    of a row in window 1, which no visit reaches."""
    scan = torch.arange(2 * 8 * 1024, dtype=torch.float32).reshape(
        2 * 8, 8, 128)
    esrc = torch.full((3, 64, 128), -1, dtype=torch.int16)
    esrc[0, 0, 0], esrc[1, 0, 0] = 5, 7
    esrc[2, 63, 127] = 1
    rows = 2 * 8192 + 8192
    ov_rows = np.array([9, 0, 8200, 0])
    order = np.argsort(ov_rows, kind="stable")
    i32 = torch.int32
    prow, pslot = ptables.piece_slots(torch.tensor([0, 1, 1], dtype=i32),
                                      torch.tensor([0, 0, 2], dtype=i32),
                                      esrc, 8)
    assert prow.tolist() == [0, 0, 3 * 8192 - 1]
    assert pslot.tolist() == [5, 8192 + 7, 8192 + 1]
    tables = ptables.compact_tables(
        prow, pslot, torch.tensor(ov_rows[order]),
        torch.tensor(np.array([1, 2, 3, 4])[order], dtype=i32),
        torch.tensor(np.array([10., 20., 30., 40.])[order],
                     dtype=torch.float32),
        rows=rows, ncols=5, slots=scan.numel(), dense_entries=esrc.numel())
    assert tables.entries[:int(tables.row_off[1])].tolist() == \
        [5, 8192 + 7, -1 - 0, -1 - 1]
    x = torch.tensor([0., 1., 2., 3., 4.])
    y = pspmv_packed.packed_rows_kernel(scan, x, tables, rows=rows)
    assert y.shape == (rows,)
    assert y[0].item() == 5 + (8192 + 7) + 20 * 2 + 40 * 4
    assert y[9].item() == 10 * 1
    assert y[8200].item() == 30 * 3
    assert y[2 * 8192 + 8191].item() == 8192 + 1
    assert int((y != 0).sum()) == 4
    with pytest.raises(ValueError, match="slots"):
        pspmv_packed.packed_rows_kernel(scan[:8], x, tables, rows=rows)


def _dense_y(plan, scan, x):
    """y the way kernel F's plain version summed it from the dense
    ``esrc`` before the list: each window's visits added in visit order
    (``packed_extract_plain``), then each row's overflow in the plan's
    order."""
    st = plan.stats
    y = pspmv_packed.packed_extract_plain(
        scan, plan.sblock, plan.wstep, plan.esrc,
        num_windows=st.num_windows, step_tiles=st.step_tiles
    ).reshape(-1)[:plan.shape[0]]
    y = psr.widen(y.contiguous())
    order = torch.from_numpy(np.argsort(plan.ov_rows.numpy(), kind="stable"))
    prod = psr.widen(plan.ov_vals)[order] * \
        psr.widen(x)[plan.ov_cols.long()[order]]
    return psr.narrow(y.index_add_(0, plan.ov_rows.long()[order], prod),
                      x.dtype)


#: PackedPlans of power-law and FEM-like matrices: kron draws (hub rows
#: of thousands of entries at scale 14) and the smoke's mac_econ_like
LIST_CASES = {
    "kron10": lambda: graphs.kron(10, seed=10),
    "kron12": lambda: graphs.kron(12, seed=12),
    "kron14": lambda: graphs.kron(14, seed=14),
    "mac_econ_like": realistic.mac_econ_like,
}


@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_compacted_list_gives_the_dense_y(case):
    # the plain version over the compacted list sums each row's terms in
    # the dense table's order (its pieces by visit, then its overflow), so
    # y is the same bit for bit; and the counters placement records are
    # the list's pieces and the dense table's entries
    host = ppacked.build_packed_plan(LIST_CASES[case]())
    before = dict(pstats.counters)
    plan = pplan.place(host, "cpu")
    st = plan.stats
    assert pstats.counters["packed.f_entries"] - \
        before.get("packed.f_entries", 0) == st.num_pieces
    assert pstats.counters["packed.f_dense_entries"] - \
        before.get("packed.f_dense_entries", 0) == st.num_steps_b * 8192
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        plan.shape[1]).astype(np.float32))
    scan = pspmv_packed.packed_scan_plain(plan.vals, plan.cols, plan.cstep,
                                          x, chunk_blocks=st.chunk_blocks,
                                          step_tiles=st.step_tiles)
    tables = plan.tables
    assert tables.pieces < tables.dense_entries / 2   # the list is smaller
    y = pspmv_packed.packed_rows_kernel(scan, x, tables, rows=plan.shape[0])
    assert torch.equal(y, _dense_y(plan, scan, x))
    assert torch.equal(pspmv_packed.spmv_packed(plan, x), y)


def test_f_units_split_hub_rows():
    # a row of more merge steps than the unit is a CTA alone, first, the
    # longest first; the other CTAs take the most whole rows that fit, in
    # row order
    lens = np.array([3, 0, 0, 5000, 2, 1, 2046, 2047, 0, 9000, 1])
    off = np.concatenate(([0], np.cumsum(lens)))
    units = ptables.f_units(off, 2048)
    assert units.dtype == np.int32
    # row 7: 2,047 entries and its end, 2,048 steps, fits
    assert units.tolist() == [[9, 10], [3, 4], [0, 3], [4, 6], [6, 7],
                              [7, 8], [8, 9], [10, 11]]
    assert ptables.f_units(np.zeros(1, np.int64)).shape == (0, 2)


#: the value types of the pass-A parity tests: float32 and the narrow
#: integers whose scan is in the value type
SCAN_TYPES = {"float32": (np.float32, jnp.float32),
              "int8": (np.int8, jnp.int8), "uint8": (np.uint8, jnp.uint8),
              "int16": (np.int16, jnp.int16)}


def _typed_case(dtype):
    """``dense_rows_overflow``'s matrix, with integer values for the
    integer types (from [-15, 16), [0, 16) or [-255, 256): products and
    sums that wrap), and an x of the same range."""
    make, cb = CASES["dense_rows_overflow"]
    m = make()
    rng = np.random.default_rng(8)
    x = rng.standard_normal(m.shape[1]).astype(np.float32)
    if dtype != np.float32:
        lo, hi = {np.int8: (-15, 16), np.uint8: (0, 16),
                  np.int16: (-255, 256)}[dtype]
        m.data = rng.integers(lo, hi, m.nnz).astype(np.float32)
        x = rng.integers(lo, hi, m.shape[1]).astype(dtype)
    return m, x, cb


@pytest.mark.parametrize("kind", sorted(SCAN_TYPES))
def test_packed_scan_matches_jax(kind):
    """Pass A alone: the plain scan against the Pallas scan kernel, on
    the grid the JAX package's ``_spmv_packed`` gives it: float32 to the
    module's tolerance, the 8- and 16-bit integers byte for byte (both
    scans in the value type: the reference's ``_compute_dtype``)."""
    dtype, jdt = SCAN_TYPES[kind]
    m, x, cb = _typed_case(dtype)
    ja, _ = both(m)
    jp = jpacked.build_packed_plan(ja, chunk_blocks=cb, value_dtype=dtype)
    st = jp.stats
    nchunks = -(-ja.shape[1] // (cb * 128))
    x2d = np.zeros(nchunks * cb * 128, dtype)
    x2d[:ja.shape[1]] = x
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(st.num_steps_a,),
        in_specs=[pl.BlockSpec((st.step_tiles, 8, 128),
                               lambda i, cs: (i, 0, 0))] * 2 +
        [pl.BlockSpec((cb, 128), lambda i, cs: (cs[i], 0))],
        out_specs=pl.BlockSpec((st.step_tiles, 8, 128),
                               lambda i, cs: (i, 0, 0)))
    want = pl.pallas_call(
        jspmv_packed._make_scan_kernel(cb, st.step_tiles, True, jdt),
        grid_spec=spec, interpret=True,
        out_shape=jax.ShapeDtypeStruct(jp.vals.shape, jdt))(
        jp.cstep, jp.vals, jp.cols, x2d.reshape(-1, 128))
    p = plan_from_reference(jp, "cpu")
    got = pspmv_packed.packed_scan_kernel(
        p.vals, p.cols, p.cstep, psr.as_x(torch.from_numpy(x), p.vals.dtype),
        chunk_blocks=cb, step_tiles=st.step_tiles)
    if dtype == np.float32:
        _assert_close(got.numpy(), want)
    else:
        assert got.dtype == p.vals.dtype
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("kind", ["int8", "uint8", "int16"])
def test_narrow_spmv_packed_matches_jax_exactly(kind):
    # the whole apply, E's narrow scan then F: y equal to the JAX
    # package's (interpret mode), which sums in the value type
    dtype, _ = SCAN_TYPES[kind]
    m, x, cb = _typed_case(dtype)
    ja, pa = both(m)
    jp = jpacked.build_packed_plan(ja, chunk_blocks=cb, value_dtype=dtype)
    want = np.asarray(jspmv_packed._spmv_packed(jp.to_device(), x,
                                                interpret=True))
    plan = pplan.place(ppacked.build_packed_plan(pa, chunk_blocks=cb,
                                                 value_dtype=dtype), "cpu")
    got = psell.spmv_plan(plan, torch.from_numpy(x))
    assert got.dtype == plan.vals.dtype and want.dtype == dtype
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", ["int8", "uint8", "int16"])
def test_packed_rows_plain_reads_a_narrow_scan(kind):
    # kernel F's plain version on the narrow scan equals it on that scan
    # widened, and, narrowed once, equals y from the 32-bit scan of the
    # same values (narrowing commutes with the wrapping sums)
    dtype, _ = SCAN_TYPES[kind]
    m, x, cb = _typed_case(dtype)
    _, pa = both(m)
    plan = pplan.place(ppacked.build_packed_plan(pa, chunk_blocks=cb,
                                                 value_dtype=dtype), "cpu")
    st = plan.stats
    tables = plan.tables
    xk = psr.as_x(torch.from_numpy(x), plan.vals.dtype)
    kw = dict(chunk_blocks=cb, step_tiles=st.step_tiles)
    scan = pspmv_packed.packed_scan_plain(plan.vals, plan.cols, plan.cstep,
                                          xk, **kw)
    assert scan.dtype == plan.vals.dtype
    scan32 = pspmv_packed.packed_scan_plain(
        plan.vals.to(torch.int32), plan.cols, plan.cstep, xk, **kw)
    assert scan32.dtype == torch.int32
    assert torch.equal(scan32.to(plan.vals.dtype), scan)
    rows = dict(rows=plan.shape[0])
    y = pspmv_packed.packed_rows_kernel(scan, xk, tables, **rows)
    assert y.dtype == torch.int32
    assert torch.equal(y, pspmv_packed.packed_rows_plain(
        psr.widen(scan), xk, tables, **rows))
    wide = dataclasses.replace(tables, ov_vals=tables.ov_vals.to(
        torch.int32))
    y32 = pspmv_packed.packed_rows_plain(scan32, xk, wide, **rows)
    assert torch.equal(psr.finish_y(y, plan.vals.dtype),
                       psr.finish_y(y32, plan.vals.dtype))
    with pytest.raises(ValueError, match="scan"):
        # a 32-bit scan with the narrow plan's tables: F's narrow build
        # would read it as 1- or 2-byte slots
        pspmv_packed.packed_rows_kernel(scan32, xk, tables, **rows)


# kernel E's launch shape: the rows of mac_econ_like's PackedPlan (1,576
# tiles), of the `deep` draw's (4,344 tiles, the uncut row), of a small
# plan and of one step
@pytest.mark.parametrize("rows", [8 * 8, 8 * 264, 12608, 34752, 1 << 20])
def test_scan_launch_shape(rows):
    shape = pspmv_packed.scan_launch_shape(rows)
    sl, threads = shape.slots_per_thread, shape.threads
    # 8 slots a thread (16 threads a row, two rows a warp), 512 threads
    assert (sl, threads) == (8, 512)
    per_cta = threads * sl // 128
    # every row once: CTA c holds rows [c * 32, (c + 1) * 32)
    assert shape.ctas == -(-rows // per_cta)
    assert (shape.ctas - 1) * per_cta < rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.uint32,
                                   torch.int8, torch.uint8, torch.int16,
                                   torch.uint16])
def test_kernel_scan_shape_of_every_build(dtype):
    # one shape at every value width: mac_econ_like's 1,576 tiles
    vals = torch.zeros((1576, 8, 128), dtype=dtype)
    assert pspmv_packed.kernel_scan_shape(vals) == \
        pspmv_packed.scan_launch_shape(12608) == \
        pspmv_packed.ScanShape(8, 512, 394)


def test_scan_dtype_of_every_value_type():
    narrow = {torch.int8, torch.uint8, torch.int16, torch.uint16}
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
               torch.uint32, *narrow):
        want = dt if dt in narrow else psr.x_dtype(dt)
        assert pspmv_packed.scan_dtype(dt) == want


def test_packed_extract_plain_sums_visits_in_order():
    """Pass B alone, on a hand-made visit list: two visits to window 0,
    none to window 1, one to window 2."""
    scan = torch.arange(2 * 8 * 1024, dtype=torch.float32).reshape(
        2 * 8, 8, 128)                         # two S blocks of 8 tiles
    esrc = torch.full((3, 64, 128), -1, dtype=torch.int16)
    esrc[0, 0, 0], esrc[1, 0, 0] = 5, 7        # window 0, row 0
    esrc[2, 63, 127] = 1                       # window 2, its last row
    out = pspmv_packed.packed_extract_kernel(
        scan, torch.tensor([0, 1, 1], dtype=torch.int32),
        torch.tensor([0, 0, 2], dtype=torch.int32), esrc, num_windows=3,
        step_tiles=8)
    assert out.shape == (3 * 64, 128)
    flat = out.reshape(-1)
    assert flat[0].item() == 5 + (8192 + 7)
    assert flat[2 * 8192 + 8191].item() == 8192 + 1
    assert int((flat != 0).sum()) == 2


def test_auto_plan_routes_locality_poor_to_packed():
    # the first recipe of the JAX package's
    # test_auto_plan_routes_locality_poor_to_packed_or_cached
    rng = np.random.RandomState(11)
    n = 1 << 17
    rows = np.repeat(np.arange(n, dtype=np.int64), 4)
    cols = rng.randint(0, n, rows.shape[0])
    m = sp.csr_matrix((rng.standard_normal(rows.shape[0]).astype(
        np.float32), (rows, cols)), shape=(n, n))
    m.sort_indices()
    ja, pa = both(m)
    port = pplan.auto_plan(pa)
    assert isinstance(port, ppacked.PackedPlan)
    assert pstrategy.select_strategy(port) == "packed"
    assert_plans_equal(port, jplan.auto_plan(ja))


def test_auto_plan_column_skew_still_raises_for_cached():
    # the second recipe: skewed columns make the reference build a
    # CachedPlan (a 2,048-column window tier, K=16, with a packed cold
    # part); the port no longer raises there but builds the same plan,
    # array for array
    rng = np.random.RandomState(11)
    n = 1 << 17
    rows = np.repeat(np.arange(n, dtype=np.int64), 4)
    u = rng.random_sample(rows.shape[0])
    cols = np.minimum((n * u ** 8).astype(np.int64), n - 1)
    m = sp.csr_matrix((rng.standard_normal(rows.shape[0]).astype(
        np.float32), (rows, cols)), shape=(n, n))
    m.sort_indices()
    ja, pa = both(m)
    port = pplan.auto_plan(pa)
    assert type(port).__name__ == "CachedPlan"
    assert isinstance(port.cold, ppacked.PackedPlan)
    assert port.hot_cols.shape == (2048,)
    assert port.hot.stats.window_blocks == 16
    assert pstrategy.select_strategy(port) == "cached"
    assert_plans_equal(port, jplan.auto_plan(ja))


def test_operator_on_packed_plan_matches_jax():
    m = random_csr(20000, 9000, 0.001)
    ja, pa = both(m)
    x = np.random.default_rng(9).standard_normal(m.shape[1]).astype(
        np.float32)
    # a packed plan through the operator: build it in both packages
    jop = joperator.SparseOperator(jpacked.build_packed_plan(ja))
    op = SparseOperator(pplan.place(ppacked.build_packed_plan(pa), "cpu"))
    assert op.strategy == jop.strategy == "packed"
    assert op.stats.as_dict() == jop.stats.as_dict()
    _assert_close((op @ x).numpy(), jop @ x)


def test_packed_counters_and_bytes_match_jax():
    from spmv_vector_cache_tpu.ops import strategy as jstrategy

    ja, pa = both(random_csr(2000, 50000, 0.001, seed=5))
    jp = jpacked.build_packed_plan(ja, chunk_blocks=32)
    pp = ppacked.build_packed_plan(pa, chunk_blocks=32)
    assert pstrategy.plan_nnz(pp) == jstrategy.plan_nnz(jp)
    assert pstrategy.execution_counters(pp) == \
        jstrategy.execution_counters(jp)
    assert pstrategy.plan_bytes_per_apply(pp) == \
        jstrategy.plan_bytes_per_apply(jp)


def test_packed_rejects_non_ring_semirings():
    _, pa = both(sp.eye(64, format="csr", dtype=np.float32))
    plan = pplan.place(ppacked.build_packed_plan(pa), "cpu")
    with pytest.raises(ValueError, match="plus_times"):
        psell.spmv_plan(plan, torch.ones(64), semiring="min_plus")
    with pytest.raises(ValueError, match="packed"):
        psell.spmv_plan(plan, torch.ones(64), strategy="window")
