"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file
imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the suite's conftest imports jax.)  Kernel and plain
version sum the same float32 products in another order, so they agree
to rtol = atol = 1e-5 relative to the output's largest magnitude.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu_torch.formats.chunk import build_chunk_plan
from spmv_vector_cache_tpu_torch.formats.convert import from_scipy
from spmv_vector_cache_tpu_torch.formats.dia import build_dia_plan
from spmv_vector_cache_tpu_torch.formats.packed import build_packed_plan
from spmv_vector_cache_tpu_torch.formats.plan import build_sell_plan, place
from spmv_vector_cache_tpu_torch.ops import (_kernels, lane_perm, spmv_chunk,
                                             spmv_dia, spmv_packed, spmv_sell)
from spmv_vector_cache_tpu_torch.ops import runs as pruns
from spmv_vector_cache_tpu_torch.ops.semiring import REGISTRY

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = max(1.0, float(ref.abs().nan_to_num(posinf=0, neginf=0).max()))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("offs,rows,cols", [
    ([0], 700, 700),
    ([-130, -7, 0, 3, 200], 700, 700),
    ([-1025, 0, 1300], 3000, 3000),      # offsets past either end
    ([0, 200], 300, 520),                # rectangular
])
def test_dia_kernel_matches_plain(cuda, offs, rows, cols):
    rng = np.random.default_rng(1)
    m = sp.spdiags(rng.standard_normal((len(offs), max(rows, cols))).astype(
        np.float32), offs, rows, cols).tocsr()
    plan = place(build_dia_plan(from_scipy(m), sublanes=8), cuda)
    x = torch.from_numpy(rng.standard_normal(cols).astype(np.float32)).to(
        cuda)
    before = spmv_dia.spmv_dia_kernel.launches
    got = spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets, x, rows)
    assert spmv_dia.spmv_dia_kernel.launches == before + 1
    _close(got, spmv_dia.spmv_dia_plain(plan.vals, plan.offsets, x, rows))


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("semiring", sorted(REGISTRY))
def test_window_kernel_matches_plain(cuda, semiring, fold):
    rng = np.random.default_rng(2)
    n = 2048
    r = np.repeat(np.arange(n), 20)
    c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
    v = np.abs(rng.standard_normal(r.shape[0])).astype(np.float32)
    if semiring == "or_and":
        v = (v > 0.5).astype(np.float32)
    m = sp.csr_matrix((v, (r, c)), shape=(n, n + 300))
    m.sort_indices()
    kw = dict(split=16, uniform_split=True, window_group_tiles=2) if fold \
        else {}
    plan = place(build_sell_plan(from_scipy(m), window_grain=32,
                                 pad_value=REGISTRY[semiring].zero, **kw),
                 cuda)
    x = torch.from_numpy(np.abs(rng.standard_normal(n + 300)).astype(
        np.float32)).to(cuda)
    st = plan.stats
    args = (plan.vals, plan.cols_win, plan.window_base, x)
    kwargs = dict(group_tiles=st.group_tiles, window_grain=st.window_grain,
                  fold=fold, semiring=semiring)
    got = spmv_sell.sell_window_kernel(*args, **kwargs)
    _close(got, spmv_sell.sell_window_plain(*args, **kwargs))


def _heavy_rows_matrix(semiring, long_row=False):
    """A light diagonal plus a dense heavy row (subwindow tiles) and a
    sparse one, values non-negative ({0, 1} for or_and); ``long_row``
    adds row 11, 40,000 consecutive columns: 39 subwindow tiles, past
    RUN_CAP, split over records that kernel D combines atomically."""
    n = 60000 if long_row else 20000
    rng = np.random.default_rng(5)
    r = np.concatenate([np.zeros(3000), np.full(2000, 7), np.arange(n)] +
                       [np.full(40000, 11)] * long_row)
    c = np.concatenate([np.arange(5000, 8000),
                        np.sort(rng.choice(n, 2000, replace=False)),
                        np.arange(n)] + [10000 + np.arange(40000)] * long_row)
    v = np.abs(rng.standard_normal(r.shape[0])).astype(np.float32)
    if semiring == "or_and":
        v = (v > 0.5).astype(np.float32)
    m = sp.csr_matrix((v, (r, c)), shape=(n, n))
    m.sort_indices()
    return m


def test_lane_unpermute_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    S = 64
    perm = np.arange(S * 128)
    for w0 in range(0, S * 128, 1024):
        perm[w0:w0 + 1024] = w0 + rng.permutation(1024)
    idx = torch.from_numpy((perm - (np.arange(S * 128) // 1024) * 1024)
                           .astype(np.int16).reshape(S, 128)).to(cuda)
    y2d = torch.from_numpy(rng.standard_normal((S, 128)).astype(
        np.float32)).to(cuda)
    before = lane_perm.lane_unpermute.launches
    got = lane_perm.lane_unpermute(y2d, idx)
    assert lane_perm.lane_unpermute.launches == before + 1
    # a permutation moves values: exact
    assert torch.equal(got, lane_perm.lane_unpermute_plain(y2d, idx))
    # on a caller's stream, the launch goes into that stream
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        assert _kernels.current_stream(cuda.index or 0) == side.cuda_stream
        assert _kernels.current_stream(cuda.index or 0) != \
            torch.cuda.default_stream(cuda).cuda_stream
        on_side = lane_perm.lane_unpermute(y2d, idx)
    side.synchronize()
    assert torch.equal(on_side, got)


def _long_light_rows_matrix(semiring):
    """Power-law light rows, up to 256 nonzeros a row within +-3000 of
    the diagonal, so that a segment of 128 lane rows holds thousands of
    records (several CTAs, or several staged chunks of one), plus
    ``_heavy_rows_matrix``'s sparse heavy row; non-negative values ({0,
    1} for or_and)."""
    n = 8192
    rng = np.random.default_rng(12)
    lens = np.minimum((rng.pareto(1.0, n) * 12).astype(np.int64) + 1, 256)
    r = np.concatenate([np.repeat(np.arange(n), lens), np.full(2000, 7)])
    c = np.concatenate([np.clip(np.repeat(np.arange(n), lens)
                                + rng.integers(-3000, 3000, lens.sum()),
                                0, n - 1),
                        np.sort(rng.choice(n, 2000, replace=False))])
    v = np.abs(rng.standard_normal(r.shape[0])).astype(np.float32)
    if semiring == "or_and":
        v = (v > 0.5).astype(np.float32)
    m = sp.csr_matrix((v, (r, c)), shape=(n, n))
    m.sum_duplicates()
    return m


@pytest.mark.parametrize("unit_records", [16, pruns.LIGHT_UNIT_RECORDS,
                                          1 << 30])
@pytest.mark.parametrize("semiring", sorted(REGISTRY))
def test_light_kernel_matches_plain(cuda, semiring, unit_records):
    # the chunk light route over a placed ChunkPlan's light records: one
    # launch, every lane row as the plain version writes it; a segment
    # split over many CTAs, over a few, or whole (several staged chunks)
    m = _long_light_rows_matrix(semiring)
    kw = dict(pad_value=REGISTRY[semiring].zero, merge_duplicates=False)
    plan = place(build_chunk_plan(from_scipy(m), **kw), cuda)
    light = pruns.light_on(plan)
    units = pruns.light_units(light.row_off.cpu().numpy(), unit_records)
    light = dataclasses.replace(light, units=torch.from_numpy(units).to(cuda))
    per_unit = np.diff(units[:, 1])
    assert per_unit.max() > 1024 if unit_records > 1024 else \
        (np.diff(units[:, 0]) < 128).any()
    x = torch.from_numpy(np.abs(np.random.default_rng(4).standard_normal(
        m.shape[1])).astype(np.float32)).to(cuda)
    if semiring == "or_and":
        x = (x > 0.5).float()
    before = spmv_chunk.light_kernel.launches
    got = spmv_chunk.light_kernel(light, x, semiring=semiring)
    assert spmv_chunk.light_kernel.launches == before + 1
    ref = spmv_chunk.light_plain(light, x, semiring=semiring)
    if semiring == "plus_times":
        _close(got, ref)
    else:
        # order-free min and max of the same float32 products
        assert torch.equal(got, ref)
    # the whole apply: one launch of the light route, y as on the CPU
    cpu = place(build_chunk_plan(from_scipy(m), **kw), "cpu")
    before = spmv_chunk.light_kernel.launches
    y = spmv_sell.spmv_plan(plan, x, semiring=semiring)
    torch.cuda.synchronize()
    assert spmv_chunk.light_kernel.launches == before + 1
    want = spmv_sell.spmv_plan(cpu, x.cpu(), semiring=semiring)
    if semiring == "plus_times":
        _close(y.cpu(), want)
    else:
        assert torch.equal(y.cpu(), want)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("semiring", sorted(REGISTRY))
def test_subwin_kernel_matches_plain(cuda, semiring, split):
    # kernel D over a ChunkPlan's heavy slab, then the whole apply: one D
    # launch, y as on the CPU
    m = _heavy_rows_matrix(semiring, long_row=split)
    kw = dict(pad_value=REGISTRY[semiring].zero, merge_duplicates=False)
    plan = place(build_chunk_plan(from_scipy(m), **kw), cuda)
    assert plan.hbuckets
    heavy = pruns.heavy_on(plan)
    assert pruns.runs_on(heavy.tile_row,
                         heavy.rows.shape[0]).split == split
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.abs(rng.standard_normal(m.shape[1])).astype(
        np.float32)).to(cuda)
    y0 = torch.from_numpy(rng.standard_normal(m.shape[0]).astype(
        np.float32)).to(cuda)
    if semiring == "or_and":
        x, y0 = (x > 0.5).float(), (y0 > 0).float()
    args = (heavy.vals, heavy.cols_win, heavy.bases, heavy.tile_row,
            heavy.rows, x)
    before = spmv_chunk.heavy_kernel.launches
    got = spmv_chunk.heavy_kernel(*args, y0.clone(), semiring=semiring)
    assert spmv_chunk.heavy_kernel.launches == before + 1
    ref = spmv_chunk.heavy_plain(*args, y0.clone(), semiring=semiring)
    if semiring == "plus_times":
        _close(got, ref)
    else:
        # order-free min and max of the same float32 products
        assert torch.equal(got, ref)
    cpu = place(build_chunk_plan(from_scipy(m), **kw), "cpu")
    before = spmv_chunk.heavy_kernel.launches
    y = spmv_sell.spmv_plan(plan, x, semiring=semiring)
    torch.cuda.synchronize()
    assert spmv_chunk.heavy_kernel.launches == before + 1
    want = spmv_sell.spmv_plan(cpu, x.cpu(), semiring=semiring)
    if semiring == "plus_times":
        _close(y.cpu(), want)
    else:
        assert torch.equal(y.cpu(), want)


@pytest.mark.parametrize("chunk_blocks", [1, 4, 32])
def test_packed_kernels_match_plain(cuda, chunk_blocks):
    rng = np.random.default_rng(6)
    rows, cols = 20000, 9000
    flat = rng.choice(rows * cols, 180000, replace=False)
    m = sp.csr_matrix((rng.standard_normal(flat.shape[0]).astype(
        np.float32), (flat // cols, flat % cols)), shape=(rows, cols))
    m.sort_indices()
    plan = place(build_packed_plan(from_scipy(m),
                                   chunk_blocks=chunk_blocks), cuda)
    st = plan.stats
    x = torch.from_numpy(rng.standard_normal(cols).astype(np.float32)).to(
        cuda)
    scan_args = (plan.vals, plan.cols, plan.cstep, x)
    scan_kw = dict(chunk_blocks=chunk_blocks, step_tiles=st.step_tiles)
    scan = spmv_packed.packed_scan_kernel(*scan_args, **scan_kw)
    _close(scan, spmv_packed.packed_scan_plain(*scan_args, **scan_kw))
    ext_args = (scan, plan.sblock, plan.wstep, plan.esrc)
    ext_kw = dict(num_windows=st.num_windows, step_tiles=st.step_tiles)
    _close(spmv_packed.packed_extract_kernel(*ext_args, **ext_kw),
           spmv_packed.packed_extract_plain(*ext_args, **ext_kw))


def _packed_matrix(overflow, rows=20003, cols=9000):
    """Random nonzeros over rows that end mid-window and mid-CTA (20,003 =
    2 windows + 3,619 rows, not a multiple of 8); with overflow, one
    full row and 9 rows of 2,000, whose runs cross many 128-slot
    boundaries (the full row's 8,000-odd overflow entries take a CTA of
    kernel F several rounds); without, one nonzero a row (no run is
    split)."""
    rng = np.random.default_rng(6)
    if not overflow:
        return sp.csr_matrix((rng.standard_normal(rows).astype(np.float32),
                              (np.arange(rows), rng.integers(0, cols, rows))),
                             shape=(rows, cols))
    flat = rng.choice(rows * cols, 180000, replace=False)
    r, c = flat // cols, flat % cols
    dense = np.arange(1000, rows, 2000)[:9]
    r = np.concatenate([r, np.full(cols, 5), np.repeat(dense, 2000)])
    c = np.concatenate([c, np.arange(cols), rng.integers(0, cols, 18000)])
    m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=(rows, cols))
    m.sum_duplicates()
    m.sort_indices()
    return m


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("chunk_blocks", [1, 4, 32])
def test_packed_rows_kernel_matches_plain(cuda, chunk_blocks, overflow):
    # kernel F, visits then overflow, against its plain version on the
    # same scan.  F's thread groups sum interleaved batches of a window's
    # visits and add their sums in group order, where the plain version
    # adds visit by visit: the same float32 terms in another order, so
    # 1e-5 of max|y|
    m = _packed_matrix(overflow)
    plan = place(build_packed_plan(from_scipy(m), chunk_blocks=chunk_blocks),
                 cuda)
    st = plan.stats
    assert (st.overflow_nnz > 0) == overflow
    tables = pruns.extract_on(plan)
    if overflow:
        # more entries than the 1,024 threads a CTA has at most
        assert int((tables.ov_off[1:] - tables.ov_off[:-1]).max()) > 1024
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        m.shape[1]).astype(np.float32)).to(cuda)
    scan = spmv_packed.packed_scan_plain(plan.vals, plan.cols, plan.cstep, x,
                                         chunk_blocks=chunk_blocks,
                                         step_tiles=st.step_tiles)
    args = (scan, plan.sblock, plan.esrc, x, tables)
    kw = dict(rows=m.shape[0], step_tiles=st.step_tiles)
    before = spmv_packed.packed_rows_kernel.launches
    got = spmv_packed.packed_rows_kernel(*args, **kw)
    assert spmv_packed.packed_rows_kernel.launches == before + 1
    _close(got, spmv_packed.packed_rows_plain(*args, **kw))


def _packed_operator(cuda):
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator

    m = _packed_matrix(True)
    op = SparseOperator(place(build_packed_plan(from_scipy(m)), cuda))
    assert op.strategy == "packed"
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        m.shape[1]).astype(np.float32)).to(cuda)
    return op, x


def test_packed_apply_launches_e_and_f_alone(cuda):
    # op @ x on a PackedPlan: kernel E, then kernel F, and no other
    # kernel, copy or fill on the card (the overflow COO is summed in F)
    from torch.profiler import ProfilerActivity, profile

    op, x = _packed_operator(cuda)
    op @ x                                      # builds the kernels
    torch.cuda.synchronize()
    counts = (spmv_packed.packed_scan_kernel.launches,
              spmv_packed.packed_rows_kernel.launches)
    names, applies = [], 0
    while not names and applies < 3:    # a session now and then records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # nothing
            op @ x
            torch.cuda.synchronize()
        applies += 1
        names = sorted(e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    assert len(names) == 2, names
    assert any("packed_scan_kernel" in n for n in names) and \
        any("packed_rows_kernel" in n for n in names), names
    assert (spmv_packed.packed_scan_kernel.launches - counts[0],
            spmv_packed.packed_rows_kernel.launches - counts[1]) == \
        (applies, applies)


def test_packed_apply_is_the_same_every_run(cuda):
    # kernel F writes each row once, with no atomic: bit-equal applies,
    # and y as on the CPU to rounding
    op, x = _packed_operator(cuda)
    y1 = op @ x
    y2 = op @ x
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    cpu = place(build_packed_plan(from_scipy(_packed_matrix(True))), "cpu")
    _close(y1.cpu(), spmv_packed.spmv_packed(cpu, x.cpu()))


def _global_args(plan, x, semiring):
    return ((plan.vals, plan.cols, plan.tile_slice, x),
            dict(num_slices=plan.num_slices, parts=spmv_sell.row_parts(plan),
                 rows=plan.shape[0], semiring=semiring))


def _check_global(got, ref, semiring):
    if semiring == "plus_times":
        _close(got, ref)
    else:
        # order-free reductions of one float32 operation per product
        assert torch.equal(got, ref)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("semiring", sorted(REGISTRY))
def test_global_kernel_matches_plain(cuda, semiring, fold):
    # fold: a uniform-parts plan, whose lanes G folds into y's rows; else
    # the identity map
    rng = np.random.default_rng(7)
    n, cols = 2048, 40000
    r = np.repeat(np.arange(n), 24)
    c = rng.integers(0, cols, r.shape[0])
    v = np.abs(rng.standard_normal(r.shape[0])).astype(np.float32)
    if semiring == "or_and":
        v = (v > 0.5).astype(np.float32)
    m = sp.csr_matrix((v, (r, c)), shape=(n, cols))
    m.sort_indices()
    kw = dict(split=16, uniform_split=True, window_group_tiles=2) if fold \
        else {}
    plan = place(build_sell_plan(from_scipy(m),
                                 pad_value=REGISTRY[semiring].zero, **kw),
                 cuda)
    assert spmv_sell.row_parts(plan) == (2 if fold else 1)
    # x one column short: the last column reads as 0 in both versions
    x = torch.from_numpy(np.abs(rng.standard_normal(cols - 1)).astype(
        np.float32)).to(cuda)
    if semiring == "or_and":
        x = (x > 0.5).float()
    args, kwargs = _global_args(plan, x, semiring)
    before = spmv_sell.sell_global_kernel.launches
    got = spmv_sell.sell_global_kernel(*args, **kwargs)
    assert spmv_sell.sell_global_kernel.launches == before + 1
    _check_global(got, spmv_sell.sell_global_plain(*args, **kwargs),
                  semiring)


def _uniform(rng, rows, cols, per_row, semiring):
    r = np.repeat(np.arange(rows), per_row)
    c = rng.integers(0, cols, r.shape[0])
    v = np.abs(rng.standard_normal(r.shape[0])).astype(np.float32)
    if semiring == "or_and":
        v = (v > 0.5).astype(np.float32)
    m = sp.csr_matrix((v, (r, c)), shape=(rows, cols))
    m.sum_duplicates()
    m.sort_indices()
    return m


def _x_for(rng, cols, semiring):
    x = np.abs(rng.standard_normal(cols)).astype(np.float32)
    return (x > 0.5).astype(np.float32) if semiring == "or_and" else x


#: x widths on either side of what one CTA's shared memory (48 KB) and a
#: cluster of 16 CTAs (2 MB) would hold, from the cached tier 2's 5,001
#: columns to 2 MB + 4 bytes; kernel G gathers x through L2 at each
G_WIDTHS = [5001, 12288, 1 << 18, 1 << 19, (1 << 19) + 1]


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
@pytest.mark.parametrize("ncols", G_WIDTHS)
def test_global_kernel_x_widths_match_plain(cuda, ncols, semiring):
    rng = np.random.default_rng(13)
    m = _uniform(rng, 4096, ncols, 12, semiring)
    plan = place(build_sell_plan(from_scipy(m),
                                 pad_value=REGISTRY[semiring].zero), cuda)
    x = torch.from_numpy(_x_for(rng, ncols, semiring)).to(cuda)
    args, kwargs = _global_args(plan, x, semiring)
    got = spmv_sell.sell_global_kernel(*args, **kwargs)
    _check_global(got, spmv_sell.sell_global_plain(*args, **kwargs),
                  semiring)


#: kernel G's row layouts: build_sell_plan arguments, what G writes
#: (row_parts) and whether a slice is split over records that combine
#: atomically
G_LAYOUTS = {
    "identity": (dict(groups_per_step=1), 1, False),
    "uniform_parts": (dict(split=16, uniform_split=True,
                           window_group_tiles=2, groups_per_step=1), 2,
                      False),
    "row_map": (dict(split=8, sigma=512, groups_per_step=1), 0, False),
    # a 600-nonzero row: its slice holds 75+ tiles, past RUN_CAP
    "long_run": (dict(groups_per_step=1), 1, True),
}


@pytest.mark.parametrize("semiring", sorted(REGISTRY))
@pytest.mark.parametrize("layout", sorted(G_LAYOUTS))
def test_global_kernel_layouts_match_plain(cuda, layout, semiring):
    kw, parts, split = G_LAYOUTS[layout]
    rng = np.random.default_rng(15)
    n, cols = 2048, 70000
    m = _uniform(rng, n, cols, 20, semiring)
    if layout == "long_run":
        long = _uniform(rng, 1, cols, 600, semiring)
        m = sp.vstack([m[:5], long, m[6:]]).tocsr()
        m.sort_indices()
    plan = place(build_sell_plan(from_scipy(m),
                                 pad_value=REGISTRY[semiring].zero, **kw),
                 cuda)
    assert spmv_sell.row_parts(plan) == parts
    runs = pruns.tile_runs(plan.tile_slice, plan.num_slices)
    assert bool((runs[:, 3] & pruns.RUN_ATOMIC).any()) == split
    x = torch.from_numpy(_x_for(rng, cols, semiring)).to(cuda)
    args, kwargs = _global_args(plan, x, semiring)
    got = spmv_sell.sell_global_kernel(*args, **kwargs)
    _check_global(got, spmv_sell.sell_global_plain(*args, **kwargs),
                  semiring)
    if not split:
        # one group writes each output, in a fixed order: bit for bit
        assert torch.equal(got, spmv_sell.sell_global_kernel(*args,
                                                             **kwargs))


def test_global_kernel_needs_a_placed_plan(cuda):
    m = _uniform(np.random.default_rng(16), 1024, 50000, 8, "plus_times")
    plan = place(build_sell_plan(from_scipy(m)), cuda)
    x = torch.ones(50000, device=cuda)
    args, kwargs = _global_args(plan, x, "plus_times")
    before = spmv_sell.sell_global_kernel.launches
    with pytest.raises(ValueError, match="placed"):
        spmv_sell.sell_global_kernel(args[0], args[1], args[2].clone(), x,
                                     **kwargs)
    assert spmv_sell.sell_global_kernel.launches == before


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_cached_operator_on_the_card_matches_cpu(cuda, semiring):
    from spmv_vector_cache_tpu_torch.formats.cached import CachedPlan
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator

    rng = np.random.default_rng(8)
    rows, cols = 16384, 65536
    ranks = np.minimum(rng.zipf(1.6, size=rows * 32) - 1, cols - 1)
    c = rng.permutation(cols)[ranks]
    m = sp.coo_matrix((np.abs(rng.standard_normal(rows * 32)).astype(
        np.float32), (np.repeat(np.arange(rows), 32), c)),
        shape=(rows, cols)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    a = from_scipy(m.astype(np.float32))
    op = SparseOperator.from_matrix(a, semiring=semiring)   # the card
    cpu = SparseOperator.from_matrix(a, semiring=semiring, device="cpu")
    assert isinstance(op.plan, CachedPlan) and op.strategy == "cached"
    assert op.device.type == "cuda"
    x = np.abs(rng.standard_normal(cols)).astype(np.float32)
    before = spmv_sell.sell_global_kernel.launches
    y = op @ x
    torch.cuda.synchronize()
    assert spmv_sell.sell_global_kernel.launches > before
    want = cpu @ x
    if semiring == "plus_times":
        _close(y.cpu(), want)
    else:
        assert torch.equal(y.cpu(), want)


# ---------------------------------------------------------------------------
# SpMM: kernels H and I
# ---------------------------------------------------------------------------

RHS = [1, 5, 8, 16, 64]


@pytest.mark.parametrize("k", RHS)
@pytest.mark.parametrize("offs,rows,cols", [
    ([-130, -1, 0, 3, 200], 900, 900),
    ([-1025, 0, 1300], 3000, 3000),      # offsets past either end
    ([0, 200], 300, 520),                # rectangular
])
def test_spmm_dia_kernel_matches_plain(cuda, offs, rows, cols, k):
    from spmv_vector_cache_tpu_torch.ops import spmm_dia

    rng = np.random.default_rng(9)
    m = sp.spdiags(rng.standard_normal((len(offs), max(rows, cols))).astype(
        np.float32), offs, rows, cols).tocsr()
    plan = place(build_dia_plan(from_scipy(m), sublanes=8), cuda)
    b = torch.from_numpy(rng.standard_normal((cols, k)).astype(
        np.float32)).to(cuda)
    before = spmm_dia.spmm_dia_kernel.launches
    got = spmm_dia.spmm_dia_kernel(plan.vals, plan.offsets, b, rows)
    assert spmm_dia.spmm_dia_kernel.launches == before + 1
    _close(got, spmm_dia.spmm_dia_plain(plan.vals, plan.offsets, b, rows))
    _close(got.cpu(), torch.from_numpy((m.astype(np.float64) @ b.cpu()
                                        .double().numpy()).astype(
                                            np.float32)))


#: kernel I's cases: offsets, rows, cols; rows not a multiple of the
#: CTA's run of rows (512 / threads per row)
I_CASES = {
    "one_band": (list(range(-13, 14)), 3000, 3000),      # bench.py's
    "bands": ([-1025, 0, 1300], 3000, 3000),             # three at k > 4
    "unaligned": (list(range(-13, 14)), 1500, 1500),     # B at 4 mod 16
    "rectangular": ([0, 200], 300, 520),
}
I_RHS = [1, 3, 5, 8, 16, 17, 64, 128]


@pytest.mark.parametrize("k", I_RHS)
@pytest.mark.parametrize("case", sorted(I_CASES))
def test_spmm_dia_kernel_tails_match_plain(cuda, case, k):
    from spmv_vector_cache_tpu_torch.ops import spmm_dia

    offs, rows, cols = I_CASES[case]
    rng = np.random.default_rng(17)
    m = sp.spdiags(rng.standard_normal((len(offs), max(rows, cols))).astype(
        np.float32), offs, rows, cols).tocsr()
    plan = place(build_dia_plan(from_scipy(m), sublanes=8), cuda)
    tiling = spmm_dia.spmm_dia_tiling(plan.offsets, k)
    assert rows % tiling.rows_per_cta
    if case == "one_band":
        assert len(tiling.bands) == 1
    if case == "bands":
        assert len(tiling.bands) == (3 if k > 4 else 1)
    b_host = torch.from_numpy(rng.standard_normal((cols, k)).astype(
        np.float32))
    if case == "unaligned":
        # a contiguous B one float past a 16-byte boundary
        store = torch.empty(cols * k + 1, device=cuda)
        b = store[1:].view(cols, k)
        b.copy_(b_host)
        assert b.is_contiguous() and b.data_ptr() % 16 == 4
    else:
        b = b_host.to(cuda)
    before = spmm_dia.spmm_dia_kernel.launches
    got = spmm_dia.spmm_dia_kernel(plan.vals, plan.offsets, b, rows)
    assert spmm_dia.spmm_dia_kernel.launches == before + 1
    _close(got, spmm_dia.spmm_dia_plain(plan.vals, plan.offsets, b, rows))


#: kernel H's layouts: build_sell_plan arguments, what H writes
#: (spmv_sell.row_parts) and whether a slice is split over CTAs that
#: add atomically; one 8-tile step per grid step keeps the padding tiles
#: on the last slice under the per-CTA cap, except where said
H_LAYOUTS = {
    "identity": (dict(groups_per_step=1), 1, False),
    "uniform_parts": (dict(split=16, uniform_split=True,
                           window_group_tiles=2, groups_per_step=1), 2,
                      False),
    "row_map": (dict(split=8, sigma=512, groups_per_step=1), 0, False),
    # a 600-nonzero row: its slice holds 75+ tiles, past the cap
    "long_run": (dict(groups_per_step=1), 1, True),
    # the default grid step pads the last slice with 400+ zero tiles
    "padded": (dict(split=16, uniform_split=True, window_group_tiles=2),
               2, True),
}
H_RHS = [1, 3, 8, 16, 20, 64]


@pytest.mark.parametrize("k", H_RHS)
@pytest.mark.parametrize("layout", sorted(H_LAYOUTS))
def test_spmm_window_kernel_matches_plain(cuda, layout, k):
    from spmv_vector_cache_tpu_torch.ops import spmm_sell

    kw, parts, split = H_LAYOUTS[layout]
    rng = np.random.default_rng(10)
    n = 2048
    r = np.repeat(np.arange(n), 20)
    c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
    if layout == "long_run":
        r = np.concatenate([r, np.full(600, 5)])
        c = np.concatenate([c, rng.choice(np.arange(128, 1700), 600,
                                          replace=False)])
    m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=(n, n + 300))
    m.sum_duplicates()
    m.sort_indices()
    plan = place(build_sell_plan(from_scipy(m), window_grain=32, **kw), cuda)
    st = plan.stats
    assert st.window_blocks > 0 and spmv_sell.row_parts(plan) == parts
    runs = pruns.tile_runs(plan.tile_slice, plan.num_slices)
    assert bool((runs[:, 3] & pruns.RUN_ATOMIC).any()) == split
    # B 200 rows short of the plan's columns: the slots of the last rows,
    # nonzeros and (but in the sorted row_map layout) padding alike, name
    # columns past B and read 0 in both versions
    b = torch.from_numpy(rng.standard_normal((n - 200, k)).astype(
        np.float32)).to(cuda)
    base = plan.window_base.long().repeat_interleave(st.group_tiles)
    slot_cols = base[:, None, None] * st.window_grain + plan.cols_win.long()
    past = slot_cols >= b.shape[0]
    assert bool((past & (plan.vals == 0)).any()) == (layout != "row_map")
    assert bool((past & (plan.vals != 0)).any())      # nonzeros
    args = (plan.vals, plan.cols_win, plan.window_base, plan.tile_slice, b)
    kwargs = dict(num_slices=plan.num_slices, group_tiles=st.group_tiles,
                  window_grain=st.window_grain, parts=parts,
                  rows=plan.shape[0])
    before = spmm_sell.spmm_window_kernel.launches
    got = spmm_sell.spmm_window_kernel(*args, **kwargs)
    assert spmm_sell.spmm_window_kernel.launches == before + 1
    _close(got, spmm_sell.spmm_window_plain(*args, **kwargs))
    if not split:
        # one CTA writes each output, in a fixed order: bit for bit again
        assert torch.equal(got, spmm_sell.spmm_window_kernel(*args,
                                                             **kwargs))


def test_spmm_window_kernel_needs_a_placed_plan(cuda):
    # kernel H's work list is built at placement: a tile_slice that no
    # placement saw is refused before anything launches
    from spmv_vector_cache_tpu_torch.ops import spmm_sell

    m = sp.random(1024, 1024, density=0.02, format="csr", dtype=np.float32,
                  random_state=np.random.default_rng(12))
    m.sort_indices()
    plan = place(build_sell_plan(from_scipy(m), window_grain=32), cuda)
    assert plan.stats.window_blocks > 0
    b = torch.ones((1024, 4), device=cuda)
    kwargs = dict(num_slices=plan.num_slices,
                  group_tiles=plan.stats.group_tiles,
                  window_grain=plan.stats.window_grain,
                  parts=spmv_sell.row_parts(plan), rows=1024)
    before = spmm_sell.spmm_window_kernel.launches
    with pytest.raises(ValueError, match="placed"):
        spmm_sell.spmm_window_kernel(plan.vals, plan.cols_win,
                                     plan.window_base,
                                     plan.tile_slice.clone(), b, **kwargs)
    assert spmm_sell.spmm_window_kernel.launches == before


@pytest.mark.parametrize("kind", ["dia", "window", "hybrid", "packed"])
def test_spmm_operator_on_the_card_matches_cpu(cuda, kind):
    from spmv_vector_cache_tpu_torch.ops import spmm_dia, spmm_sell
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator

    rng = np.random.default_rng(11)
    n = 32768 if kind == "hybrid" else 4096
    if kind == "packed":
        flat = rng.choice(20000 * 9000, 180000, replace=False)
        m = sp.csr_matrix((rng.standard_normal(flat.shape[0]).astype(
            np.float32), (flat // 9000, flat % 9000)), shape=(20000, 9000))
    elif kind == "window":
        r = np.repeat(np.arange(n), 27)
        c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
        m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(
            np.float32), (r, c)), shape=(n, n))
    else:
        m = sp.spdiags(rng.standard_normal((27, n)).astype(np.float32),
                       list(range(-13, 14)), n, n).tocsr()
        if kind == "hybrid":
            rr = np.repeat(np.arange(n), 2)
            cc = np.clip(rr + rng.integers(-512, 513, rr.shape[0]), 0,
                         n - 1)
            m = (m + sp.csr_matrix((rng.standard_normal(rr.shape[0]).astype(
                np.float32), (rr, cc)), shape=(n, n))).tocsr()
    m = m.astype(np.float32)
    m.sort_indices()
    a = from_scipy(m)
    op = SparseOperator.from_matrix(a)                      # the card
    cpu = SparseOperator.from_matrix(a, device="cpu")
    b = rng.standard_normal((m.shape[1], 16)).astype(np.float32)
    counts = (spmm_dia.spmm_dia_kernel.launches,
              spmm_sell.spmm_window_kernel.launches)
    y = op @ b
    torch.cuda.synchronize()
    launched = (spmm_dia.spmm_dia_kernel.launches - counts[0],
                spmm_sell.spmm_window_kernel.launches - counts[1])
    assert launched == {"dia": (1, 0), "window": (0, 1), "hybrid": (1, 1),
                        "packed": (0, 0)}[kind], (type(op.plan), launched)
    assert y.device.type == "cuda" and y.shape == (m.shape[0], 16)
    _close(y.cpu(), cpu @ b)


# ---------------------------------------------------------------------------
# double plans: kernels J, K and L (float64 sums of the same products as
# their plain versions, in another order: rtol 1e-13 of max|y|)
# ---------------------------------------------------------------------------

def _close64(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.float64
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, rtol=1e-13, atol=1e-13 * scale)


def _f64_values(m, rng):
    m = m.astype(np.float64)
    m.data = rng.standard_normal(m.data.shape[0])
    return m


@pytest.mark.parametrize("offs,rows,cols", [
    ([-13, -1, 0, 1, 13], 9000, 9000),
    ([-1025, 0, 1300], 3000, 3000),      # offsets past either end
    ([0, 200], 300, 520),                # rectangular
])
def test_dia_f64_kernel_matches_plain(cuda, offs, rows, cols):
    rng = np.random.default_rng(12)
    m = _f64_values(sp.spdiags(np.ones((len(offs), max(rows, cols))), offs,
                               rows, cols).tocsr(), rng)
    plan = place(build_dia_plan(from_scipy(m), sublanes=8,
                                value_dtype=np.float64), cuda)
    assert plan.double
    x = torch.from_numpy(rng.standard_normal(cols)).to(cuda)
    before = spmv_dia.spmv_dia_f64_kernel.launches
    got = spmv_dia.spmv_dia_f64_kernel(plan.vals, plan.offsets, x, rows)
    assert spmv_dia.spmv_dia_f64_kernel.launches == before + 1
    _close64(got, spmv_dia.spmv_dia_f64_plain(plan.vals, plan.offsets, x,
                                              rows))
    _close64(got.cpu(), torch.from_numpy(m @ x.cpu().numpy()))


@pytest.mark.parametrize("layout", ["fold", "unfolded", "row_map"])
def test_window_f64_kernel_matches_plain(cuda, layout):
    rng = np.random.default_rng(13)
    n = 2048
    r = np.repeat(np.arange(n), 20)
    c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
    m = sp.csr_matrix((np.ones(r.shape[0]), (r, c)), shape=(n, n + 300))
    m.sum_duplicates()
    m = _f64_values(m, rng)
    m.sort_indices()
    kw = {"fold": dict(split=16, uniform_split=True, window_group_tiles=2),
          "unfolded": {}, "row_map": dict(split=8, sigma=512)}[layout]
    plan = place(build_sell_plan(from_scipy(m), window_grain=32,
                                 value_dtype=np.float64, **kw), cuda)
    st = plan.stats
    fold = spmv_sell.folds_groups(plan)
    assert fold == (layout == "fold") and st.window_blocks > 0
    # x 100 columns short: columns past it read 0 in both versions
    x = torch.from_numpy(rng.standard_normal(n + 200)).to(cuda)
    args = (plan.vals, plan.cols_win, plan.window_base, x)
    kwargs = dict(group_tiles=st.group_tiles, window_grain=st.window_grain,
                  fold=fold)
    before = spmv_sell.sell_window_f64_kernel.launches
    got = spmv_sell.sell_window_f64_kernel(*args, **kwargs)
    assert spmv_sell.sell_window_f64_kernel.launches == before + 1
    _close64(got, spmv_sell.sell_window_f64_plain(*args, **kwargs))
    # through the dispatch: y against float64 scipy over the full x
    xf = rng.standard_normal(n + 300)
    y = spmv_sell.spmv_sell_double(plan, torch.from_numpy(xf).to(cuda))
    _close64(y.cpu(), torch.from_numpy(m @ xf))


@pytest.mark.parametrize("layout", sorted(G_LAYOUTS))
@pytest.mark.parametrize("strategy", ["stream", "resident", "deep"])
def test_global_f64_kernel_matches_plain(cuda, strategy, layout):
    # kernel L on kernel G's row layouts (a split slice combines with a
    # float64 atomicAdd), then each windowless route: one L launch, y
    # against float64 scipy
    kw, parts, split = G_LAYOUTS[layout]
    rng = np.random.default_rng(14)
    n, cols = 2048, 40000
    m = _uniform(rng, n, cols, 20, "plus_times")
    if layout == "long_run":
        long = _uniform(rng, 1, cols, 600, "plus_times")
        m = sp.vstack([m[:5], long, m[6:]]).tocsr()
    m = _f64_values(m, rng)
    m.sort_indices()
    plan = place(build_sell_plan(from_scipy(m), value_dtype=np.float64,
                                 **kw), cuda)
    assert plan.stats.window_blocks == 0
    assert spmv_sell.row_parts(plan) == parts
    assert pruns.runs_on(plan.tile_slice, plan.num_slices).split == split
    # x one column short: the last column reads as 0 in both versions
    x = torch.from_numpy(rng.standard_normal(cols - 1)).to(cuda)
    args = (plan.vals, plan.cols, plan.tile_slice, x)
    kwargs = dict(num_slices=plan.num_slices, parts=parts,
                  rows=plan.shape[0])
    before = spmv_sell.sell_global_f64_kernel.launches
    got = spmv_sell.sell_global_f64_kernel(*args, **kwargs)
    assert spmv_sell.sell_global_f64_kernel.launches == before + 1
    _close64(got, spmv_sell.sell_global_f64_plain(*args, **kwargs))
    xf = rng.standard_normal(cols)
    before = spmv_sell.sell_global_f64_kernel.launches
    y = spmv_sell.spmv_sell_double(plan, torch.from_numpy(xf).to(cuda),
                                   strategy=strategy)
    assert spmv_sell.sell_global_f64_kernel.launches == before + 1
    _close64(y.cpu(), torch.from_numpy(m @ xf))


@pytest.mark.parametrize("kind", ["dia", "hybrid", "window", "windowless"])
def test_f64_operator_on_the_card_matches_cpu(cuda, kind):
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator

    rng = np.random.default_rng(15)
    n = 8192
    if kind == "windowless":
        r = np.repeat(np.arange(2048), 16)
        m = sp.csr_matrix((np.ones(r.shape[0]),
                           (r, rng.integers(0, 40000, r.shape[0]))),
                          shape=(2048, 40000))
        m.sum_duplicates()
    elif kind == "window":
        r = np.repeat(np.arange(n), 27)
        c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
        m = sp.csr_matrix((np.ones(r.shape[0]), (r, c)), shape=(n, n))
        m.sum_duplicates()
    else:
        m = sp.spdiags(np.ones((27, n)), list(range(-13, 14)), n, n).tocsr()
        if kind == "hybrid":
            rr = np.repeat(np.arange(n), 2)
            cc = np.clip(rr + rng.integers(-512, 513, rr.shape[0]), 0, n - 1)
            m = (m + sp.csr_matrix((np.ones(rr.shape[0]), (rr, cc)),
                                   shape=(n, n))).tocsr()
    m = _f64_values(m, rng)
    m.sort_indices()
    a = from_scipy(m)
    op = SparseOperator.from_matrix(a, value_dtype=np.float64)   # the card
    cpu = SparseOperator.from_matrix(a, value_dtype=np.float64,
                                     device="cpu")
    assert type(op.plan).__name__ == {"dia": "DiaPlan",
                                      "hybrid": "HybridPlan"}.get(
                                          kind, "SellPlan")
    x = rng.standard_normal(m.shape[1])
    kernels = (spmv_dia.spmv_dia_f64_kernel, spmv_sell.sell_window_f64_kernel,
               spmv_sell.sell_global_f64_kernel)
    counts = [k.launches for k in kernels]
    y = op @ x
    torch.cuda.synchronize()
    launched = tuple(k.launches - c for k, c in zip(kernels, counts))
    assert launched == {"dia": (1, 0, 0), "hybrid": (1, 1, 0),
                        "window": (0, 1, 0), "windowless": (0, 0, 1)}[kind]
    assert y.device.type == "cuda" and y.dtype == torch.float64
    _close64(y.cpu(), cpu @ x)
    _close64(y.cpu(), torch.from_numpy(m @ x))


# ---------------------------------------------------------------------------
# kernel M (halo DIA), kernel N (stream checksum), the sharded paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offs,rows", [
    ([0], 700),
    ([-130, -7, 0, 3, 200], 3000),
    (list(range(-13, 14)), 5000),
])
def test_dia_halo_kernel_origin_zero_is_kernel_a(cuda, offs, rows):
    """Origin 0 over x_len = cols: kernel M is kernel A, bit for bit."""
    rng = np.random.default_rng(16)
    m = sp.spdiags(rng.standard_normal((len(offs), rows)).astype(
        np.float32), offs, rows, rows).tocsr()
    plan = place(build_dia_plan(from_scipy(m), sublanes=8), cuda)
    x = torch.from_numpy(rng.standard_normal(rows).astype(np.float32)).to(
        cuda)
    before = spmv_dia.spmv_dia_halo_kernel.launches
    got = spmv_dia.spmv_dia_halo_kernel(plan.vals, plan.offsets, x, rows, 0)
    assert spmv_dia.spmv_dia_halo_kernel.launches == before + 1
    assert torch.equal(got, spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets,
                                                     x, rows))
    _close(got, spmv_dia.spmv_dia_halo_plain(plan.vals, plan.offsets, x,
                                             rows, 0))


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_dia_halo_kernel_matches_plain_on_shards(cuda, shard):
    """One shard of a 4-shard plan over a halo'd x: both ring edges (the
    wrapped halo entries meet zero values) and an inner shard."""
    from spmv_vector_cache_tpu_torch.parallel import build_sharded_dia_plan

    rng = np.random.default_rng(17)
    n = 4 * 1024
    m = sp.spdiags(rng.standard_normal((5, n)).astype(np.float32),
                   [-130, -1, 0, 1, 130], n, n).tocsr()
    sp_plan = build_sharded_dia_plan(from_scipy(m), 4, sublanes=8)
    halo, rps = sp_plan.halo, sp_plan.rows_per_shard
    vals = torch.from_numpy(sp_plan.vals[shard]).to(cuda)
    x_ext = torch.from_numpy(rng.standard_normal(rps + 2 * halo).astype(
        np.float32)).to(cuda)
    got = spmv_dia.spmv_dia_halo_kernel(vals, sp_plan.offsets, x_ext, rps,
                                        halo)
    _close(got, spmv_dia.spmv_dia_halo_plain(vals, sp_plan.offsets, x_ext,
                                             rps, halo))


@pytest.mark.parametrize("T,block", [(64, 8), (256, 128), (96, 96),
                                     (4, 1)])
def test_stream_checksum_kernel_ramp_closed_form(cuda, T, block):
    """Tile t holds t: each block's sum is exact in float32 here, so the
    kernel (one CTA per block, looping over blocks of up to 131072
    floats here) must give it exactly."""
    from spmv_vector_cache_tpu_torch.utils import stream

    tile_vals = torch.arange(T, dtype=torch.float32, device=cuda)
    data = tile_vals[:, None, None].expand(T, 8, 128).contiguous()
    before = stream.checksum_stream.launches
    got = stream.checksum_stream(data, block)
    assert stream.checksum_stream.launches == before + 1
    want = tile_vals.reshape(T // block, block).sum(1) * 1024
    assert torch.equal(got, want)


@pytest.mark.parametrize("T,P,R,block", [(512, 8, 128, 64),
                                         (300, 8, 128, 100),
                                         (64, 4, 33, 16)])
def test_stream_checksum_kernel_matches_plain(cuda, T, P, R, block):
    from spmv_vector_cache_tpu_torch.utils import stream

    g = torch.Generator(device=cuda).manual_seed(18)
    data = torch.randn((T, P, R), generator=g, device=cuda)
    _close(stream.checksum_stream(data, block),
           stream.checksum_stream_plain(data, block))


def test_measured_read_bandwidth_in_the_cards_range(cuda):
    """The read probe on the default 256 MiB buffer: at least 1.0e12
    bytes/s and at most 5 % above the H100's 3.35e12."""
    from spmv_vector_cache_tpu_torch.utils import roofline

    bw = roofline.measure_stream_bandwidth()
    assert 1.0e12 < bw < 1.05 * 3.35e12, bw


SHARDED_KINDS = ["dia", "halo", "all_gather", "spmm"]


@pytest.mark.parametrize("kind", SHARDED_KINDS)
def test_sharded_on_the_card_matches_cpu(cuda, kind):
    """Four shards on one card against four on the CPU; the kernels
    launch once per shard."""
    from spmv_vector_cache_tpu_torch.parallel import make_mesh

    _sharded_matches_cpu(kind, make_mesh(4, device="cuda:0"))


@pytest.mark.parametrize("shards_per_card", [1, 2])
@pytest.mark.parametrize("kind", SHARDED_KINDS)
def test_sharded_over_several_cards_matches_cpu(cuda, kind,
                                                shards_per_card):
    """One or two shards on each visible card (each shard's kernels
    launch into its own card's stream) against the same shards on the
    CPU."""
    from spmv_vector_cache_tpu_torch.parallel import make_mesh

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = make_mesh(shards_per_card * cards)
    assert len(set(mesh.devices)) == cards
    _sharded_matches_cpu(kind, mesh)


def _sharded_matches_cpu(kind, mesh):
    from spmv_vector_cache_tpu_torch.ops import spmm_sell
    from spmv_vector_cache_tpu_torch.parallel import (
        build_sharded_dia_plan, build_sharded_plan, make_mesh,
        spmm_sharded, spmv_dia_sharded, spmv_sharded)

    D = mesh.size
    rng = np.random.default_rng(19)
    n = 8192
    if kind == "dia":
        m = sp.spdiags(rng.standard_normal((27, n)).astype(np.float32),
                       list(range(-13, 14)), n, n).tocsr()
    else:
        r = np.repeat(np.arange(n), 27)
        c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
        m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(
            np.float32), (r, c)), shape=(n, n))
        m.sum_duplicates()
    m.sort_indices()
    a = from_scipy(m)
    x = rng.standard_normal((n, 16) if kind == "spmm" else n).astype(
        np.float32)
    cpu = make_mesh(D, device="cpu")
    assert all(d.type == "cuda" for d in mesh.devices)
    if kind == "dia":
        plan = build_sharded_dia_plan(a, D, sublanes=8)
        kernel, run = spmv_dia.spmv_dia_halo_kernel, spmv_dia_sharded
        kw = {}
    elif kind == "spmm":
        plan = build_sharded_plan(a, D)
        kernel, run = spmm_sell.spmm_window_kernel, spmm_sharded
        kw = {}
    else:
        plan = build_sharded_plan(a, D)
        kernel, run = spmv_sell.sell_window_kernel, spmv_sharded
        kw = dict(mode=kind)
    before = kernel.launches
    y = run(plan, torch.from_numpy(x).to(mesh.devices[0]), mesh, **kw)
    for dev in set(mesh.devices):
        torch.cuda.synchronize(dev)
    assert kernel.launches == before + D
    assert y.device == mesh.devices[0]
    _close(y.cpu(), run(plan, torch.from_numpy(x), cpu, **kw))
    want = torch.from_numpy((m.astype(np.float64) @ x).astype(np.float32))
    _close(y.cpu(), want)


# ---------------------------------------------------------------------------
# the solver layer on the card: torch ops (SpGEMM's numeric phase, the
# triangular sweep) and the CG step over kernel A, against the same calls
# on the CPU
# ---------------------------------------------------------------------------

def test_spgemm_numeric_on_the_card_matches_cpu(cuda):
    from spmv_vector_cache_tpu_torch.ops import spgemm

    n = 4096
    m = sp.random(n, n, density=16 / n, format="csr",
                  random_state=np.random.RandomState(0),
                  dtype=np.float64).astype(np.float32)
    m.sort_indices()
    a = from_scipy(m)
    host = spgemm.spgemm_symbolic(a, a)
    got = spgemm.spgemm_numeric(place(host, cuda), a.data, a.data)
    want = spgemm.spgemm_numeric(place(host, torch.device("cpu")), a.data,
                                 a.data)
    assert got.device.type == "cuda" and got.shape == (host.c_nnz,)
    # index_add_'s atomics sum an entry's products in no fixed order
    _close(got.cpu(), want)


@pytest.mark.parametrize("lower", [True, False])
def test_trisolve_on_the_card_matches_cpu(cuda, lower):
    from spmv_vector_cache_tpu_torch.ops import sptrsv

    rng = np.random.default_rng(20)
    n = 3000
    m = sp.spdiags(rng.standard_normal((5, n)).astype(np.float32),
                   [-4, -3, -2, -1, 0], n, n).tocsr()
    m = sp.tril(m + sp.eye(n, dtype=np.float32) * 8).tocsr()
    if not lower:
        m = m.T.tocsr()
    m.sort_indices()
    plan = sptrsv.build_trisolve_plan(from_scipy(m), lower=lower)
    b = rng.standard_normal(n).astype(np.float32)
    got = sptrsv.trisolve(place(plan, cuda), torch.from_numpy(b).to(cuda))
    want = sptrsv.trisolve(place(plan, torch.device("cpu")), b)
    assert got.device.type == "cuda"
    _close(got.cpu(), want)


def test_cg_step_on_the_card_matches_cpu(cuda):
    from spmv_vector_cache_tpu_torch.models import solvers
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator

    rng = np.random.default_rng(0)
    n, band = 1 << 14, 3
    m = sp.spdiags(rng.standard_normal((2 * band + 1, n)).astype(
        np.float32) * 0.1, list(range(-band, band + 1)), n, n)
    m = (m + m.T + sp.eye(n) * (2 * band + 2)).tocsr().astype(np.float32)
    m.sort_indices()
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    states = {}
    for dev in ("cpu", "cuda"):
        op = SparseOperator.from_matrix(from_scipy(m), device=dev)
        bt = torch.from_numpy(b).to(dev)
        before = spmv_dia.spmv_dia_kernel.launches
        states[dev] = solvers.cg_step(op.matvec, (torch.zeros_like(bt), bt,
                                                  bt, torch.vdot(bt, bt)))
        assert spmv_dia.spmv_dia_kernel.launches == before + (dev == "cuda")
    for got, want in zip(states["cuda"], states["cpu"]):
        _close(got.cpu(), want)
