"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  This file
imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the suite's conftest imports jax.)  Kernel and plain
version sum the same float32 products in another order, so they agree
to rtol = atol = 1e-5 relative to the output's largest magnitude.
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu_torch.formats.chunk import build_chunk_plan
from spmv_vector_cache_tpu_torch.formats.convert import from_scipy
from spmv_vector_cache_tpu_torch.formats.dia import build_dia_plan
from spmv_vector_cache_tpu_torch.formats.packed import build_packed_plan
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.formats.plan import build_sell_plan, place
from spmv_vector_cache_tpu_torch.formats import tables as ptables
from spmv_vector_cache_tpu_torch.ops import (_kernels, lane_perm, spmv_chunk,
                                             spmv_dia, spmv_packed, spmv_sell)
from spmv_vector_cache_tpu_torch.ops.semiring import REGISTRY
from spmv_vector_cache_tpu_torch.utils.stats import device_us_by_kernel

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
    before = _kernels.launches["spmv_dia_f32"]
    got = spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets, x, rows)
    assert _kernels.launches["spmv_dia_f32"] == before + 1
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
    before = _kernels.launches["lane_unpermute_f32"]
    got = lane_perm.lane_unpermute(y2d, idx)
    assert _kernels.launches["lane_unpermute_f32"] == before + 1
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


@pytest.mark.parametrize("unit_records", [16, ptables.LIGHT_UNIT_RECORDS,
                                          1 << 30])
@pytest.mark.parametrize("semiring", sorted(REGISTRY))
def test_light_kernel_matches_plain(cuda, semiring, unit_records):
    # the chunk light route over a placed ChunkPlan's light records: one
    # launch, every lane row as the plain version writes it; a segment
    # split over many CTAs, over a few, or whole (several staged chunks)
    m = _long_light_rows_matrix(semiring)
    kw = dict(pad_value=REGISTRY[semiring].zero, merge_duplicates=False)
    plan = place(build_chunk_plan(from_scipy(m), **kw), cuda)
    light = plan.light
    units = ptables.light_units(light.row_off.cpu().numpy(), unit_records)
    light = dataclasses.replace(light, units=torch.from_numpy(units).to(cuda))
    per_unit = np.diff(units[:, 1])
    assert per_unit.max() > 1024 if unit_records > 1024 else \
        (np.diff(units[:, 0]) < 128).any()
    x = torch.from_numpy(np.abs(np.random.default_rng(4).standard_normal(
        m.shape[1])).astype(np.float32)).to(cuda)
    if semiring == "or_and":
        x = (x > 0.5).float()
    before = _kernels.launches["spmv_chunk_light_f32"]
    got = spmv_chunk.light_kernel(light, x, semiring=semiring)
    assert _kernels.launches["spmv_chunk_light_f32"] == before + 1
    ref = spmv_chunk.light_plain(light, x, semiring=semiring)
    if semiring == "plus_times":
        _close(got, ref)
    else:
        # order-free min and max of the same float32 products
        assert torch.equal(got, ref)
    # the whole apply: one launch of the light route, y as on the CPU
    cpu = place(build_chunk_plan(from_scipy(m), **kw), "cpu")
    before = _kernels.launches["spmv_chunk_light_f32"]
    y = spmv_sell.spmv_plan(plan, x, semiring=semiring)
    torch.cuda.synchronize()
    assert _kernels.launches["spmv_chunk_light_f32"] == before + 1
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
    heavy = plan.heavy
    assert heavy.work.split == split
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.abs(rng.standard_normal(m.shape[1])).astype(
        np.float32)).to(cuda)
    y0 = torch.from_numpy(rng.standard_normal(m.shape[0]).astype(
        np.float32)).to(cuda)
    if semiring == "or_and":
        x, y0 = (x > 0.5).float(), (y0 > 0).float()
    args = (heavy.vals, heavy.cols_win, heavy.bases, heavy.tile_row,
            heavy.rows, x)
    before = _kernels.launches["spmv_subwin_f32"]
    got = spmv_chunk.heavy_kernel(heavy, x, y0.clone(), semiring=semiring)
    assert _kernels.launches["spmv_subwin_f32"] == before + 1
    ref = spmv_chunk.heavy_plain(*args, y0.clone(), semiring=semiring)
    if semiring == "plus_times":
        _close(got, ref)
    else:
        # order-free min and max of the same float32 products
        assert torch.equal(got, ref)
    cpu = place(build_chunk_plan(from_scipy(m), **kw), "cpu")
    before = _kernels.launches["spmv_subwin_f32"]
    y = spmv_sell.spmv_plan(plan, x, semiring=semiring)
    torch.cuda.synchronize()
    assert _kernels.launches["spmv_subwin_f32"] == before + 1
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
    2 windows + 3,619 rows, not a multiple of 8).  ``overflow``: True adds
    one full row and 9 rows of 2,000, whose runs cross many 128-slot
    boundaries (the full row has 8,000-odd overflow entries); False gives
    one nonzero a row (no run is split); "hub" makes the matrix 40,000
    wide with two full rows (7,777 and 12,345), each of over 10,000
    overflow entries at every chunk_blocks, so kernel F splits them
    across a CTA; "every_chunk" adds a row with a nonzero every 128
    columns, so a primary piece in every chunk of any width; "no_piece"
    leaves windows 1 and 3 of five (8,192 rows each) and two rows in
    three elsewhere empty."""
    rng = np.random.default_rng(6)
    if overflow is False:
        return sp.csr_matrix((rng.standard_normal(rows).astype(np.float32),
                              (np.arange(rows), rng.integers(0, cols, rows))),
                             shape=(rows, cols))
    if overflow == "hub":
        cols = 40000
    if overflow == "no_piece":
        rows = 5 * 8192
        r = np.arange(0, rows, 3)
        r = np.repeat(r[(r // 8192) % 2 == 0], 4)
        c = rng.integers(0, cols, r.shape[0])
    else:
        flat = rng.choice(rows * cols, 180000, replace=False)
        r, c = flat // cols, flat % cols
    if overflow is True:
        dense = np.arange(1000, rows, 2000)[:9]
        r = np.concatenate([r, np.full(cols, 5), np.repeat(dense, 2000)])
        c = np.concatenate([c, np.arange(cols), rng.integers(0, cols, 18000)])
    elif overflow == "hub":
        r = np.concatenate([r, np.full(cols, 7777), np.full(cols, 12345)])
        c = np.concatenate([c, np.arange(cols), np.arange(cols)])
    elif overflow == "every_chunk":
        r = np.concatenate([r, np.full(cols // 128, 77)])
        c = np.concatenate([c, np.arange(0, cols - 127, 128)])
    m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=(rows, cols))
    m.sum_duplicates()
    m.sort_indices()
    return m


def _row_counts(plan, tables):
    """Each row's pieces and overflow entries in kernel F's list."""
    off = tables.row_off.long().cpu()
    n = off[1:] - off[:-1]
    ov = torch.bincount(plan.ov_rows.long().cpu(), minlength=n.shape[0])
    return n - ov, ov


@pytest.mark.parametrize("overflow", [False, True, "hub", "every_chunk",
                                      "no_piece"])
@pytest.mark.parametrize("chunk_blocks", [1, 4, 32])
def test_packed_rows_kernel_matches_plain(cuda, chunk_blocks, overflow):
    # kernel F, each row's pieces then its overflow, against its plain
    # version on the same scan.  F's threads take even runs of the list
    # and join a row's partial sums by a scan, where the plain version
    # adds a row's terms one after another: the same float32 terms in
    # another order, so 1e-5 of max|y|
    m = _packed_matrix(overflow)
    plan = place(build_packed_plan(from_scipy(m), chunk_blocks=chunk_blocks),
                 cuda)
    st = plan.stats
    if overflow in (False, True, "hub"):
        assert (st.overflow_nnz > 0) == (overflow is not False)
    tables = plan.tables
    pieces, ov = _row_counts(plan, tables)
    unit = tables.units.long().cpu()
    steps = (unit[:, 1] - unit[:, 0]) + tables.row_off.long().cpu()[
        unit[:, 1]] - tables.row_off.long().cpu()[unit[:, 0]]
    if overflow is True:
        # more entries in one row than a CTA's unit: a hub row
        assert int(steps.max()) > tables.unit
    if overflow == "hub":
        assert int(ov[7777]) >= 10000 and int(ov[12345]) >= 10000
        assert int((steps > tables.unit).sum()) >= 2
    if overflow == "every_chunk":
        # a piece in every chunk of the columns up to 8,960 (70 x 128)
        assert int(pieces[77]) == np.unique(
            m.getrow(77).indices // (chunk_blocks * 128)).shape[0] == \
            -(-(m.shape[1] // 128 * 128) // (chunk_blocks * 128))
    if overflow == "no_piece":
        assert int(pieces[8192:2 * 8192].sum()) == 0
        assert int((pieces == 0).sum()) > m.shape[0] // 2
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        m.shape[1]).astype(np.float32)).to(cuda)
    scan = spmv_packed.packed_scan_plain(plan.vals, plan.cols, plan.cstep, x,
                                         chunk_blocks=chunk_blocks,
                                         step_tiles=st.step_tiles)
    args = (scan, x, tables)
    kw = dict(rows=m.shape[0])
    before = _kernels.launches["packed_extract_f32"]
    got = spmv_packed.packed_rows_kernel(*args, **kw)
    assert _kernels.launches["packed_extract_f32"] == before + 1
    _close(got, spmv_packed.packed_rows_plain(*args, **kw))
    if overflow == "no_piece":
        assert int((got != 0).sum()) == int(((pieces + ov) > 0).sum())


def _packed_operator(cuda, overflow=True):
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator

    m = _packed_matrix(overflow)
    op = SparseOperator(place(build_packed_plan(from_scipy(m)), cuda))
    assert op.strategy == "packed"
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        m.shape[1]).astype(np.float32)).to(cuda)
    return op, x


def test_packed_apply_launches_e_and_f_alone(cuda):
    # op @ x on a PackedPlan: kernel E, then kernel F, and no other
    # kernel, copy or fill on the card (the overflow COO is summed in F)
    op, x = _packed_operator(cuda)
    op @ x                                      # builds the kernels
    torch.cuda.synchronize()
    counts = (_kernels.launches["packed_scan_f32"],
              _kernels.launches["packed_extract_f32"])
    names, applies = [], 0
    while not names and applies < 6:    # a trace now and then records nothing
        names = sorted(device_us_by_kernel(lambda: op @ x, iters=1))
        applies += 2                    # the helper's untraced call too
    assert len(names) == 2, names
    assert any("packed_scan_kernel" in n for n in names) and \
        any("packed_rows_kernel" in n for n in names), names
    assert (_kernels.launches["packed_scan_f32"] - counts[0],
            _kernels.launches["packed_extract_f32"] - counts[1]) == \
        (applies, applies)


@pytest.mark.parametrize("overflow", [True, "hub"])
def test_packed_apply_is_the_same_every_run(cuda, overflow):
    # kernel F writes each row once, with no atomic: bit-equal applies,
    # hub rows split across a CTA included, and y as on the CPU to
    # rounding
    op, x = _packed_operator(cuda, overflow)
    y1 = op @ x
    y2 = op @ x
    y3 = op @ x
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(y1, y3)
    cpu = place(build_packed_plan(from_scipy(_packed_matrix(overflow))),
                "cpu")
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
    before = _kernels.launches["spmv_sell_global_f32"]
    got = spmv_sell.sell_global_kernel(*args, **kwargs, work=plan.work)
    assert _kernels.launches["spmv_sell_global_f32"] == before + 1
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
    got = spmv_sell.sell_global_kernel(*args, **kwargs, work=plan.work)
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
    runs = ptables.tile_runs(plan.tile_slice, plan.num_slices)
    assert bool((runs[:, 3] & ptables.RUN_ATOMIC).any()) == split
    x = torch.from_numpy(_x_for(rng, cols, semiring)).to(cuda)
    args, kwargs = _global_args(plan, x, semiring)
    got = spmv_sell.sell_global_kernel(*args, **kwargs, work=plan.work)
    _check_global(got, spmv_sell.sell_global_plain(*args, **kwargs),
                  semiring)
    if not split:
        # one group writes each output, in a fixed order: bit for bit
        assert torch.equal(got, spmv_sell.sell_global_kernel(
            *args, **kwargs, work=plan.work))


def test_global_kernel_needs_a_placed_plan(cuda):
    m = _uniform(np.random.default_rng(16), 1024, 50000, 8, "plus_times")
    plan = place(build_sell_plan(from_scipy(m)), cuda)
    x = torch.ones(50000, device=cuda)
    args, kwargs = _global_args(plan, x, "plus_times")
    before = _kernels.launches["spmv_sell_global_f32"]
    with pytest.raises(ValueError, match="placed"):
        spmv_sell.sell_global_kernel(*args, **kwargs)
    assert _kernels.launches["spmv_sell_global_f32"] == before


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
    before = _kernels.launches["spmv_sell_global_f32"]
    y = op @ x
    torch.cuda.synchronize()
    assert _kernels.launches["spmv_sell_global_f32"] > before
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
    before = _kernels.launches["spmm_dia_f32"]
    got = spmm_dia.spmm_dia_kernel(plan.vals, plan.offsets, b, rows)
    assert _kernels.launches["spmm_dia_f32"] == before + 1
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
    before = _kernels.launches["spmm_dia_f32"]
    got = spmm_dia.spmm_dia_kernel(plan.vals, plan.offsets, b, rows)
    assert _kernels.launches["spmm_dia_f32"] == before + 1
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
    runs = ptables.tile_runs(plan.tile_slice, plan.num_slices)
    assert bool((runs[:, 3] & ptables.RUN_ATOMIC).any()) == split
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
    before = _kernels.launches["spmm_sell_window_f32"]
    got = spmm_sell.spmm_window_kernel(*args, **kwargs, work=plan.work)
    assert _kernels.launches["spmm_sell_window_f32"] == before + 1
    _close(got, spmm_sell.spmm_window_plain(*args, **kwargs))
    if not split:
        # one CTA writes each output, in a fixed order: bit for bit again
        assert torch.equal(got, spmm_sell.spmm_window_kernel(
            *args, **kwargs, work=plan.work))


def test_spmm_window_kernel_needs_a_placed_plan(cuda):
    # kernel H's work list is built at placement: a launch without it is
    # refused before anything launches
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
    before = _kernels.launches["spmm_sell_window_f32"]
    with pytest.raises(ValueError, match="placed"):
        spmm_sell.spmm_window_kernel(plan.vals, plan.cols_win,
                                     plan.window_base, plan.tile_slice, b,
                                     **kwargs)
    assert _kernels.launches["spmm_sell_window_f32"] == before


@pytest.mark.parametrize("kind", ["dia", "window", "hybrid", "packed"])
def test_spmm_operator_on_the_card_matches_cpu(cuda, kind):
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
    counts = (_kernels.launches["spmm_dia_f32"],
              _kernels.launches["spmm_sell_window_f32"])
    y = op @ b
    torch.cuda.synchronize()
    launched = (_kernels.launches["spmm_dia_f32"] - counts[0],
                _kernels.launches["spmm_sell_window_f32"] - counts[1])
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
    before = _kernels.launches["spmv_dia_f64"]
    got = spmv_dia.spmv_dia_f64_kernel(plan.vals, plan.offsets, x, rows)
    assert _kernels.launches["spmv_dia_f64"] == before + 1
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
    before = _kernels.launches["spmv_sell_window_f64"]
    got = spmv_sell.sell_window_f64_kernel(*args, **kwargs)
    assert _kernels.launches["spmv_sell_window_f64"] == before + 1
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
    assert plan.work.split == split
    # x one column short: the last column reads as 0 in both versions
    x = torch.from_numpy(rng.standard_normal(cols - 1)).to(cuda)
    args = (plan.vals, plan.cols, plan.tile_slice, x)
    kwargs = dict(num_slices=plan.num_slices, parts=parts,
                  rows=plan.shape[0])
    before = _kernels.launches["spmv_sell_global_f64"]
    got = spmv_sell.sell_global_f64_kernel(*args, **kwargs, work=plan.work)
    assert _kernels.launches["spmv_sell_global_f64"] == before + 1
    _close64(got, spmv_sell.sell_global_f64_plain(*args, **kwargs))
    xf = rng.standard_normal(cols)
    before = _kernels.launches["spmv_sell_global_f64"]
    y = spmv_sell.spmv_sell_double(plan, torch.from_numpy(xf).to(cuda),
                                   strategy=strategy)
    assert _kernels.launches["spmv_sell_global_f64"] == before + 1
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
    kernels = ("spmv_dia_f64", "spmv_sell_window_f64",
               "spmv_sell_global_f64")
    counts = [_kernels.launches[k] for k in kernels]
    y = op @ x
    torch.cuda.synchronize()
    launched = tuple(_kernels.launches[k] - c
                     for k, c in zip(kernels, counts))
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
    before = _kernels.launches["spmv_dia_halo_f32"]
    got = spmv_dia.spmv_dia_halo_kernel(plan.vals, plan.offsets, x, rows, 0)
    assert _kernels.launches["spmv_dia_halo_f32"] == before + 1
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
    before = _kernels.launches["stream_checksum_f32"]
    got = stream.checksum_stream(data, block)
    assert _kernels.launches["stream_checksum_f32"] == before + 1
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
        kernel, run = "spmv_dia_halo_f32", spmv_dia_sharded
        kw = {}
    elif kind == "spmm":
        plan = build_sharded_plan(a, D)
        kernel, run = "spmm_sell_window_f32", spmm_sharded
        kw = {}
    else:
        plan = build_sharded_plan(a, D)
        kernel, run = "spmv_sell_window_f32", spmv_sharded
        kw = dict(mode=kind)
    before = _kernels.launches[kernel]
    y = run(plan, torch.from_numpy(x).to(mesh.devices[0]), mesh, **kw)
    for dev in set(mesh.devices):
        torch.cuda.synchronize(dev)
    assert _kernels.launches[kernel] == before + D
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
        before = _kernels.launches["spmv_dia_f32"]
        states[dev] = solvers.cg_step(op.matvec, (torch.zeros_like(bt), bt,
                                                  bt, torch.vdot(bt, bt)))
        assert _kernels.launches["spmv_dia_f32"] == before + (dev == "cuda")
    for got, want in zip(states["cuda"], states["cpu"]):
        _close(got.cpu(), want)


@pytest.mark.parametrize("tol,maxiter", [(0.0, 12), (1e-8, 400)])
def test_cg_on_the_card_equals_the_synchronous_loop(cuda, tol, maxiter):
    # on a float64 DiaPlan (kernel J), to maxiter and to an early exit,
    # against the synchronous loop that the CPU tests hold it to
    from spmv_vector_cache_tpu_torch.models import solvers
    from cg_reference import assert_same, sync_cg

    op, b = _f64_stencil_operator(cuda)
    before = _kernels.launches["spmv_dia_f64"]
    want = sync_cg(op.matvec, b, tol=tol, maxiter=maxiter)
    assert _kernels.launches["spmv_dia_f64"] == before + want[1] + 1
    assert 10 < want[1] <= maxiter
    for _ in range(2):          # a fresh ring of slots, then a reused one
        assert_same(solvers.cg(op.matvec, b, tol=tol, maxiter=maxiter),
                    want)


def _f64_stencil_operator(cuda):
    from spmv_vector_cache_tpu_torch.formats.dia import DiaPlan
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator

    n = 1 << 16
    m = sp.diags([-1.0, -1.0, 4.2, -1.0, -1.0], [-256, -1, 0, 1, 256],
                 shape=(n, n), dtype=np.float64).tocsr()
    m.sort_indices()
    op = SparseOperator.from_matrix(from_scipy(m), value_dtype=np.float64,
                                    device=cuda)
    assert isinstance(op.plan, DiaPlan)
    b = torch.from_numpy(np.random.default_rng(21).standard_normal(n)).to(
        cuda)
    return op, b


def test_cg_queues_the_next_iteration_before_each_overlapped_read(cuda):
    # host order under the profiler: the copy of r_k . r_k, then the
    # next iteration's kernel J, then the wait for that copy, for every
    # read from r_2 on; the reads of r_0 and r_1 wait before J.  r_0's
    # read is two copies, r_0 . r_0 and atol2, into one slot
    from torch.profiler import ProfilerActivity, profile

    from spmv_vector_cache_tpu_torch.models import solvers

    op, b = _f64_stencil_operator(cuda)
    maxiter = 10
    solvers.cg(op.matvec, b, tol=0.0, maxiter=maxiter)    # warm
    torch.cuda.synchronize()
    marks, tries = [], 0
    while not marks and tries < 3:      # a session now and then records
        with profile(activities=[ProfilerActivity.CPU,      # nothing
                                 ProfilerActivity.CUDA]) as prof:
            solvers.cg(op.matvec, b, tol=0.0, maxiter=maxiter)
            torch.cuda.synchronize()
        tries += 1
        named = {"cudaMemcpyAsync": "copy", "spmv.launch": "J",
                 "spmv.cg.read": "wait"}
        marks = [named[e.name] for e in sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name in named), key=lambda e: e.time_range.start)]
    first = marks.index("copy")
    assert marks[first + 1] == "copy", marks
    del marks[first]
    assert marks.count("copy") == marks.count("wait") == maxiter, marks
    assert marks.count("J") == maxiter + 1, marks
    copies = [i for i, m in enumerate(marks) if m == "copy"]
    waits = [i for i, m in enumerate(marks) if m == "wait"]
    between = [marks[c:w].count("J") for c, w in zip(copies, waits)]
    assert between == [0, 0] + [1] * (maxiter - 2), marks


# ---------------------------------------------------------------------------
# the plan-parameter and strategy sweeps on the card
# ---------------------------------------------------------------------------

def _band(n, offs, seed):
    rng = np.random.default_rng(seed)
    m = sp.spdiags(rng.standard_normal((len(offs), n)).astype(np.float32),
                   offs, n, n).tocsr()
    m.sort_indices()
    return m


@pytest.mark.parametrize("allow_dia", [True, False])
def test_autotune_plan_every_candidate_on_the_card(cuda, allow_dia,
                                                   tmp_path):
    from spmv_vector_cache_tpu_torch.ops import tune

    m = _band(1 << 15, list(range(-6, 7)), seed=30)
    a = from_scipy(m)
    want = m.astype(np.float64) @ np.ones(m.shape[1])
    seen = {}

    def check(name, plan, y):
        assert y.device.type == "cuda"
        err = np.abs(y.cpu().numpy() - want).max() / np.abs(want).max()
        assert err < 1e-4, (name, err)
        seen[name] = type(plan).__name__

    store = str(tmp_path / "tuned.json")
    # without DIA, a SELL-window base: the grid-step and group-tile
    # candidates; the store round trip runs under the same base, so that
    # the winner is one of its candidates whichever the timing picked
    base = contextlib.nullcontext() if allow_dia else mock.patch.object(
        tune, "auto_plan", lambda a, **kw: pplan.auto_plan(
            a, **{**kw, "allow_dia": False}))
    with base:
        res = tune.autotune_plan(a, iters=3, store=store, check=check)
        # the store round trip: the winner again, placed, with no timing
        again = tune.autotune_plan(a, iters=3, store=store)
    assert [e.name for e in res.table] == list(seen)
    assert len(res.table) >= 3 and not res.skipped
    assert all(e.seconds > 0 and e.gnnz_per_s > 0 for e in res.table)
    assert res.plan is not None and res.best in seen
    assert again.best == res.best
    assert [(e.seconds, e.gnnz_per_s) for e in again.table] == [(0.0, 0.0)]
    y = spmv_sell.spmv_plan(again.plan, torch.ones(m.shape[1], device=cuda))
    assert y.device.type == "cuda"
    assert np.abs(y.cpu().numpy() - want).max() / np.abs(want).max() < 1e-4


def test_strategy_sweep_on_the_card_all_four(cuda):
    from spmv_vector_cache_tpu_torch.ops import strategy

    m = _band(4096, list(range(-6, 7)), seed=31)
    plan = place(build_sell_plan(from_scipy(m)), cuda)
    assert strategy.feasible_strategies(plan) == [
        "window", "resident", "deep", "stream"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        4096).astype(np.float32)).to(cuda)
    stats = {}
    res = strategy.autotune(plan, x, iters=5, stats=stats)
    assert list(res) == ["window", "resident", "deep", "stream"]
    assert all(r.seconds > 0 for r in res.values())
    assert len(stats) == 8
    best = strategy.best_strategy(plan, x, iters=5)
    want = m.astype(np.float64) @ x.cpu().numpy().astype(np.float64)
    for s in res:
        y = spmv_sell.spmv_plan(plan, x, strategy=s).cpu().numpy()
        assert np.abs(y - want).max() / np.abs(want).max() < 1e-4, s
    assert best in res


def test_from_matrix_tune_on_the_card(cuda, tmp_path):
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator

    m = _band(1 << 14, list(range(-3, 4)), seed=32)
    store = str(tmp_path / "tuned.json")
    op = SparseOperator.from_matrix(from_scipy(m), tune=True,
                                    tune_store=store)
    assert op.device.type == "cuda"
    assert any(k.startswith("tune_") for k in op.stats.keys())
    x = np.random.default_rng(3).standard_normal(1 << 14).astype(np.float32)
    want = m.astype(np.float64) @ x.astype(np.float64)
    y = (op @ x).cpu().numpy()
    assert np.abs(y - want).max() / np.abs(want).max() < 1e-4
    again = SparseOperator.from_matrix(from_scipy(m), tune=True,
                                       tune_store=store)
    tuned = [k for k in again.stats.keys() if k.startswith("tune_")]
    assert len(tuned) == 1 and again.stats[tuned[0]] == 0.0


# ---------------------------------------------------------------------------
# bfloat16, float16, int8, uint8, int16, uint16, int32 and uint32 plans:
# each typed build of kernels A, M, B, G, D, E, F, H, I and the chunk
# light route against its plain version on the same inputs (bfloat16 and
# float16 sum float32 products in another order: rtol and atol 1e-5 of
# max|y|; the integer sums wrap mod 2^32 in any order: exactly), and the
# operator on the card against the CPU (a float16 y within one float16
# ulp of max(1, max|y|))
# ---------------------------------------------------------------------------

TYPED = {"bf16": "bfloat16", "i32": np.int32, "u32": np.uint32,
         "f16": np.float16, "i8": np.int8, "u8": np.uint8, "i16": np.int16,
         "u16": np.uint16}
#: the integers each kind draws (8 and 16 bits: products that wrap)
TYPED_RANGE = {"i32": (-9, 10), "u32": (0, 10), "i8": (-15, 16),
               "u8": (0, 16), "i16": (-255, 256), "u16": (0, 256)}
#: the torch type of each kind's slab
TYPED_SLAB = {"bf16": torch.bfloat16, "f16": torch.float16,
              "i32": torch.int32, "u32": torch.uint32, "i8": torch.int8,
              "u8": torch.uint8, "i16": torch.int16, "u16": torch.uint16}


def _typed_values(kind, n, rng, nonneg=False):
    """``n`` matrix values (float64, cast by the builders): normal for
    bfloat16 and float16 (its absolute value under the max semirings),
    else integers of :data:`TYPED_RANGE` (from 0 under max_times)."""
    if kind in ("bf16", "f16"):
        v = rng.standard_normal(n)
        return np.abs(v) if nonneg else v
    lo, hi = TYPED_RANGE[kind]
    return rng.integers(0 if nonneg else lo, hi, n).astype(np.float64)


def _typed_x(kind, n, rng, device, nonneg=False):
    """x in the plan's sum type: float32 (a float16 plan's rounded to
    float16 first), int32 (the 8- and 16-bit plans' too) or uint32."""
    if kind in ("bf16", "f16"):
        x = rng.standard_normal(n).astype(np.float32)
        x = np.abs(x) if nonneg else x
        if kind == "f16":
            x = x.astype(np.float16).astype(np.float32)
        return torch.from_numpy(x).to(device)
    lo, hi = TYPED_RANGE[kind]
    x = rng.integers(0 if nonneg else lo, hi, n)
    return torch.from_numpy(x.astype(np.int32)).to(device).to(
        torch.uint32 if kind == "u32" else torch.int32)


def _same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype == torch.float16:
        got, ref = got.cpu().double(), ref.cpu().double()
        ulp = 2.0 ** -10 * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= ulp
    elif got.dtype.is_floating_point:
        _close(got, ref)
    else:
        from spmv_vector_cache_tpu_torch.ops.semiring import signed

        assert torch.equal(signed(got.cpu()), signed(ref.cpu()))


def _typed_semirings(kind):
    return ["plus_times", "max_times"] if kind not in ("bf16", "f16") else \
        ["plus_times", "min_plus", "max_times"]


@pytest.mark.parametrize("kind", ["f16", "i8", "u8", "i16", "u16"])
def test_typed_finish_y_narrows_on_the_card(cuda, kind):
    # y's one cast on the card: float16 rounded once, the integers
    # wrapped mod 2^8 or 2^16, as numpy's casts give them on the host
    from spmv_vector_cache_tpu_torch.ops import semiring as sr

    dt = TYPED_SLAB[kind]
    rng = np.random.default_rng(30)
    if kind == "f16":
        y = rng.standard_normal(100000).astype(np.float32) * 1e3
    else:
        y = rng.integers(-(1 << 31), 1 << 31, 100000).astype(np.int32)
    got = sr.finish_y(torch.from_numpy(y).to(cuda), dt).cpu()
    assert got.dtype == dt
    want = y.astype(TYPED[kind])
    if kind == "f16":
        assert np.array_equal(got.numpy().view(np.uint16),
                              want.view(np.uint16))
    else:
        assert np.array_equal(got.to(torch.int64).numpy(), want)


@pytest.mark.parametrize("kind", sorted(TYPED))
def test_typed_dia_kernels_match_plain(cuda, kind):
    # kernel A and kernel M (a shard's rows over a halo'd x)
    rng = np.random.default_rng(21)
    offs, n = [-130, -7, 0, 3, 200], 3000
    m = sp.spdiags(_typed_values(kind, len(offs) * n, rng).reshape(
        len(offs), n), offs, n, n).tocsr()
    plan = place(build_dia_plan(from_scipy(m), sublanes=8,
                                value_dtype=TYPED[kind]), cuda)
    assert plan.vals.dtype == TYPED_SLAB[kind]
    x = _typed_x(kind, n, rng, cuda)
    before = _kernels.launches["spmv_dia_" + kind]
    got = spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets, x, n)
    assert _kernels.launches["spmv_dia_" + kind] == before + 1
    _same(got, spmv_dia.spmv_dia_plain(plan.vals, plan.offsets, x, n))
    x_ext = _typed_x(kind, n + 256, rng, cuda)
    args = (plan.vals, plan.offsets, x_ext, n - 128, 128)
    _same(spmv_dia.spmv_dia_halo_kernel(*args),
          spmv_dia.spmv_dia_halo_plain(*args))


# kernels A and M at every launch shape: R rows a thread, threads a CTA,
# x staged in shared memory or read through L1; every shape sums a row's
# diagonals in the same order, so all give one y bit for bit

DIA_KINDS = ["f32"] + sorted(TYPED)


def _dia_plan(kind, offs, n, rng, cuda, cols=None):
    cols = n if cols is None else cols
    vals = rng.standard_normal(len(offs) * max(n, cols)) if kind == "f32" \
        else _typed_values(kind, len(offs) * max(n, cols), rng)
    m = sp.spdiags(vals.reshape(len(offs), max(n, cols)), offs, n,
                   cols).tocsr()
    plan = place(build_dia_plan(from_scipy(m), sublanes=8, value_dtype=(
        np.float32 if kind == "f32" else TYPED[kind])), cuda)
    x = torch.from_numpy(rng.standard_normal(cols).astype(np.float32)).to(
        cuda) if kind == "f32" else _typed_x(kind, cols, rng, cuda)
    return plan, x


def _dia_shapes(vals, rows):
    """Every shape the build takes: R up to one 16-byte vector of slots
    and 8 rows, 64 and 256 threads, staged where the window fits."""
    out = []
    r = 1
    while r * vals.element_size() <= 16 and r <= spmv_dia.MAX_ROWS:
        for threads in (64, 256):
            ctas = -(-rows // (r * threads))
            out += [spmv_dia.DiaShape(r, threads, ctas, staged, 0)
                    for staged in (False, True)]
        r *= 2
    return out


def _fits(shape, offsets):
    span = max(offsets) - min(offsets)
    return 4 * spmv_dia.stage_words(shape.threads, shape.rows_per_thread,
                                    span) <= spmv_dia.STAGE_BYTES


@pytest.mark.parametrize("rows", [100, 5037, 20000])
@pytest.mark.parametrize("kind", DIA_KINDS)
def test_dia_kernels_every_shape_match_plain(cuda, kind, rows):
    # rows below one CTA, and rows that are no multiple of R or of a CTA
    rng = np.random.default_rng(40)
    offs = list(range(-13, 14))
    plan, x = _dia_plan(kind, offs, rows, rng, cuda)
    entry = _kernels.entry("spmv_dia_f32", plan.vals.dtype)
    before = _kernels.launches[entry]
    want = spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets, x, rows)
    assert _kernels.launches[entry] == before + 1
    _same(want, spmv_dia.spmv_dia_plain(plan.vals, plan.offsets, x, rows))
    x_ext = torch.cat([x.new_zeros(128), x, x.new_zeros(128)])
    for shape in _dia_shapes(plan.vals, rows):
        if shape.staged and not _fits(shape, offs):
            continue
        got = spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets, x, rows,
                                       shape=shape)
        assert torch.equal(got, want), shape
        # M at origin 128 over x with a 128-entry halo each side: A's y
        got = spmv_dia.spmv_dia_halo_kernel(plan.vals, plan.offsets, x_ext,
                                            rows, 128, shape=shape)
        assert torch.equal(got, want), shape


@pytest.mark.parametrize("kind", DIA_KINDS)
def test_dia_kernels_unstaged_wide_span(cuda, kind):
    # a span no CTA can stage (x through L1), and 70 diagonals (the
    # offsets past the launch's parameters come from the device array)
    rng = np.random.default_rng(41)
    n = 30000
    for offs in ([-9000, -1, 0, 5, 9000], list(range(-40, 30))):
        plan, x = _dia_plan(kind, offs, n, rng, cuda)
        shape = spmv_dia.kernel_shape(plan.vals, plan.offsets, n)
        assert shape.staged == (max(offs) - min(offs) < 100), shape
        got = spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets, x, n)
        _same(got, spmv_dia.spmv_dia_plain(plan.vals, plan.offsets, x, n))
        args = (plan.vals, plan.offsets, x, n - 1000, 700)
        _same(spmv_dia.spmv_dia_halo_kernel(*args),
              spmv_dia.spmv_dia_halo_plain(*args))


@pytest.mark.parametrize("kind", DIA_KINDS)
def test_dia_halo_kernel_every_build_on_shards(cuda, kind):
    """Both ring edges (the wrapped halo entries meet zero values) and an
    inner shard of a 4-shard plan, each build."""
    from spmv_vector_cache_tpu_torch.parallel import build_sharded_dia_plan

    rng = np.random.default_rng(42)
    n = 4 * 2048
    offs = [-130, -1, 0, 1, 130]
    vals = rng.standard_normal(5 * n) if kind == "f32" else \
        _typed_values(kind, 5 * n, rng)
    m = sp.spdiags(vals.reshape(5, n), offs, n, n).tocsr()
    sp_plan = build_sharded_dia_plan(from_scipy(m), 4, sublanes=8,
                                     value_dtype=np.float32 if kind == "f32"
                                     else TYPED[kind])
    halo, rps = sp_plan.halo, sp_plan.rows_per_shard
    for shard in (0, 1, 3):
        v = torch.from_numpy(np.ascontiguousarray(sp_plan.vals[shard])) \
            if isinstance(sp_plan.vals, np.ndarray) else sp_plan.vals[shard]
        v = v.to(cuda)
        x_ext = torch.from_numpy(rng.standard_normal(rps + 2 * halo).astype(
            np.float32)).to(cuda) if kind == "f32" else \
            _typed_x(kind, rps + 2 * halo, rng, cuda)
        args = (v, sp_plan.offsets, x_ext, rps, halo)
        _same(spmv_dia.spmv_dia_halo_kernel(*args),
              spmv_dia.spmv_dia_halo_plain(*args))


@pytest.mark.parametrize("kind", ["f32", "bf16", "f16"])
def test_sharded_dia_equals_kernel_a_bit_for_bit(cuda, kind):
    # M on four shards against A on the whole, at shapes that differ
    # between the two: A's own and every R over the shards
    from spmv_vector_cache_tpu_torch.parallel import (build_sharded_dia_plan,
                                                      make_mesh,
                                                      place_on_mesh,
                                                      spmv_dia_sharded)

    rng = np.random.default_rng(43)
    n = 4 * 16384
    offs = list(range(-13, 14))
    vals = rng.standard_normal(27 * n) if kind == "f32" else \
        _typed_values(kind, 27 * n, rng)
    m = sp.spdiags(vals.reshape(27, n), offs, n, n).tocsr()
    vdt = np.float32 if kind == "f32" else TYPED[kind]
    plan = place(build_dia_plan(from_scipy(m), value_dtype=vdt), cuda)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    if kind == "f16":
        x = x.half().float()
    want = spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets, x, n)
    mesh = make_mesh(4, device="cuda")
    spd = place_on_mesh(build_sharded_dia_plan(from_scipy(m), 4,
                                               value_dtype=vdt), mesh)
    y = spmv_dia_sharded(spd, x, mesh)
    assert torch.equal(y, want.half() if kind == "f16" else want)
    rps = spd.rows_per_shard
    assert spmv_dia.kernel_shape(spd.vals[0], offs, rps) != \
        spmv_dia.kernel_shape(plan.vals, offs, n)
    xs = torch.cat([x.new_zeros(spd.halo), x, x.new_zeros(spd.halo)])
    for shape in _dia_shapes(spd.vals[0], rps):
        if shape.staged and not _fits(shape, offs):
            continue
        for d in range(4):
            x_ext = xs[d * rps:(d + 1) * rps + 2 * spd.halo].contiguous()
            got = spmv_dia.spmv_dia_halo_kernel(spd.vals[d], spd.offsets,
                                                x_ext, rps, spd.halo,
                                                shape=shape)
            assert torch.equal(got, want[d * rps:(d + 1) * rps]), (shape, d)


def test_dia_kernels_refuse_a_shape_the_build_lacks(cuda):
    rng = np.random.default_rng(44)
    plan, x = _dia_plan("f32", [0, 1], 1000, rng, cuda)
    i8, xi = _dia_plan("i8", [0, 1], 1000, rng, cuda)
    with pytest.raises(RuntimeError, match="failed to launch"):
        spmv_dia.spmv_dia_kernel(i8.vals, i8.offsets, xi, 1000,
                                 shape=spmv_dia.DiaShape(16, 128, 1, False,
                                                         0))
    for shape in (spmv_dia.DiaShape(8, 256, 1, False, 0),    # 32 B a load
                  spmv_dia.DiaShape(4, 512, 1, False, 0),    # > 256 threads
                  spmv_dia.DiaShape(3, 256, 1, False, 0)):
        with pytest.raises(RuntimeError, match="failed to launch"):
            spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets, x, 1000,
                                     shape=shape)
    wide = spmv_dia.DiaShape(1, 256, 1, True, 0)
    plan, x = _dia_plan("f32", [-30000, 0, 30000], 40000, rng, cuda)
    with pytest.raises(RuntimeError, match="failed to launch"):
        spmv_dia.spmv_dia_kernel(plan.vals, plan.offsets, x, 40000,
                                 shape=wide)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("kind", sorted(TYPED))
def test_typed_window_kernel_matches_plain(cuda, kind, fold):
    rng = np.random.default_rng(22)
    n = 2048
    r = np.repeat(np.arange(n), 20)
    c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
    for semiring in _typed_semirings(kind):
        nonneg = semiring == "max_times"
        m = sp.csr_matrix((_typed_values(kind, r.shape[0], rng, nonneg),
                           (r, c)), shape=(n, n + 300))
        m.sum_duplicates()
        m.sort_indices()
        kw = dict(split=16, uniform_split=True, window_group_tiles=2) \
            if fold else {}
        plan = place(build_sell_plan(
            from_scipy(m), window_grain=32, value_dtype=TYPED[kind],
            pad_value=REGISTRY[semiring].zero, **kw), cuda)
        x = _typed_x(kind, n + 300, rng, cuda, nonneg)
        st = plan.stats
        args = (plan.vals, plan.cols_win, plan.window_base, x)
        kwargs = dict(group_tiles=st.group_tiles,
                      window_grain=st.window_grain, fold=fold,
                      semiring=semiring)
        got = spmv_sell.sell_window_kernel(*args, **kwargs)
        _same(got, spmv_sell.sell_window_plain(*args, **kwargs))


@pytest.mark.parametrize("layout", ["identity", "fold", "long_row"])
@pytest.mark.parametrize("kind", sorted(TYPED))
def test_typed_global_kernel_matches_plain(cuda, kind, layout):
    # kernel G; a 2,000-nonzero row makes a slice of 250 tiles, split over
    # records that combine with the integer atomics
    rng = np.random.default_rng(23)
    n, cols = 2048, 40000
    r = np.repeat(np.arange(n), 24)
    c = rng.integers(0, cols, r.shape[0])
    if layout == "long_row":
        r = np.concatenate([r, np.full(2000, 9)])
        c = np.concatenate([c, rng.choice(cols, 2000, replace=False)])
    for semiring in _typed_semirings(kind):
        nonneg = semiring == "max_times"
        m = sp.csr_matrix((_typed_values(kind, r.shape[0], rng, nonneg),
                           (r, c)), shape=(n, cols))
        m.sum_duplicates()
        m.sort_indices()
        kw = dict(split=16, uniform_split=True, window_group_tiles=2) \
            if layout == "fold" else {}
        plan = place(build_sell_plan(
            from_scipy(m), value_dtype=TYPED[kind],
            pad_value=REGISTRY[semiring].zero, **kw), cuda)
        if layout == "long_row":
            assert plan.work.split
        x = _typed_x(kind, cols, rng, cuda, nonneg)
        args, kwargs = _global_args(plan, x, semiring)
        before = _kernels.launches["spmv_sell_global_" + kind]
        got = spmv_sell.sell_global_kernel(*args, **kwargs, work=plan.work)
        assert _kernels.launches["spmv_sell_global_" + kind] == before + 1
        _same(got, spmv_sell.sell_global_plain(*args, **kwargs))


@pytest.mark.parametrize("kind", sorted(TYPED))
def test_typed_chunk_kernels_match_plain(cuda, kind):
    # the light route and kernel D over a ChunkPlan with heavy rows, then
    # the whole apply (kernel C moves an integer y as its float32 words)
    for semiring in ("plus_times", "max_times"):
        m = _heavy_rows_matrix(semiring, long_row=True)
        m.data = _typed_values(kind, m.nnz, np.random.default_rng(24),
                               semiring != "plus_times")
        kw = dict(pad_value=REGISTRY[semiring].zero, merge_duplicates=False,
                  value_dtype=TYPED[kind])
        plan = place(build_chunk_plan(from_scipy(m), **kw), cuda)
        light, heavy = plan.light, plan.heavy
        rng = np.random.default_rng(25)
        x = _typed_x(kind, m.shape[1], rng, cuda, semiring != "plus_times")
        _same(spmv_chunk.light_kernel(light, x, semiring=semiring),
              spmv_chunk.light_plain(light, x, semiring=semiring))
        y0 = _typed_x(kind, m.shape[0], rng, cuda, True)
        args = (heavy.vals, heavy.cols_win, heavy.bases, heavy.tile_row,
                heavy.rows, x)
        _same(spmv_chunk.heavy_kernel(heavy, x, y0.clone(),
                                      semiring=semiring),
              spmv_chunk.heavy_plain(*args, y0.clone(), semiring=semiring))
        cpu = place(build_chunk_plan(from_scipy(m), **kw), "cpu")
        _same(spmv_sell.spmv_plan(plan, x, semiring=semiring).cpu(),
              spmv_sell.spmv_plan(cpu, x.cpu(), semiring=semiring))


@pytest.mark.parametrize("overflow", [True, "hub"])
@pytest.mark.parametrize("kind", sorted(TYPED))
def test_typed_packed_kernels_match_plain(cuda, kind, overflow):
    # kernel E, then kernel F with overflow (hub rows of over 10,000
    # entries split across a CTA with "hub"), each the build of the plan's
    # value type (F's bfloat16 build reads the float32 scan and x and the
    # 2-byte overflow values)
    m = _packed_matrix(overflow)
    m.data = _typed_values(kind, m.nnz, np.random.default_rng(26))
    plan = place(build_packed_plan(from_scipy(m), chunk_blocks=4,
                                   value_dtype=TYPED[kind]), cuda)
    st = plan.stats
    x = _typed_x(kind, m.shape[1], np.random.default_rng(27), cuda)
    scan_args = (plan.vals, plan.cols, plan.cstep, x)
    scan_kw = dict(chunk_blocks=4, step_tiles=st.step_tiles)
    scan = spmv_packed.packed_scan_kernel(*scan_args, **scan_kw)
    _same(scan, spmv_packed.packed_scan_plain(*scan_args, **scan_kw))
    tables = plan.tables
    assert tables.ov_vals.dtype == plan.vals.dtype
    assert tables.ov_vals.shape[0] > 0
    rows_args = (scan, x, tables)
    rows_kw = dict(rows=m.shape[0])
    before = _kernels.launches["packed_extract_" + kind]
    got = spmv_packed.packed_rows_kernel(*rows_args, **rows_kw)
    assert _kernels.launches["packed_extract_" + kind] == before + 1
    _same(got, spmv_packed.packed_rows_plain(*rows_args, **rows_kw))


#: every value kind of kernels E and B: float32 and the typed ones
ALL_KINDS = ["f32"] + sorted(TYPED)


def _kind_values(kind, n, rng, nonneg=False):
    if kind == "f32":
        v = rng.standard_normal(n)
        return np.abs(v) if nonneg else v
    return _typed_values(kind, n, rng, nonneg)


def _kind_x(kind, n, rng, device, nonneg=False):
    if kind == "f32":
        x = rng.standard_normal(n).astype(np.float32)
        return torch.from_numpy(np.abs(x) if nonneg else x).to(device)
    return _typed_x(kind, n, rng, device, nonneg)


def _misaligned(t):
    """A tensor of ``t``'s shape and type whose address is not 16-byte
    aligned (its contents unset)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    return buf[1:1 + t.numel()].view(t.shape)


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_scan_kernel_every_shape_matches_plain(cuda, kind):
    # kernel E at every launch shape (4, 8 and 16 slots a thread, 128 to
    # 1024 threads a CTA) over 20,003 rows with overflow, against its
    # plain version: S in the value type for the 8- and 16-bit integers,
    # exactly; a refused shape raises, and so does a misaligned slab
    m = _packed_matrix(True)
    m.data = _kind_values(kind, m.nnz, np.random.default_rng(28))
    vdt = np.float32 if kind == "f32" else TYPED[kind]
    plan = place(build_packed_plan(from_scipy(m), chunk_blocks=4,
                                   value_dtype=vdt), cuda)
    st = plan.stats
    x = _kind_x(kind, m.shape[1], np.random.default_rng(29), cuda)
    args = (plan.vals, plan.cols, plan.cstep, x)
    kw = dict(chunk_blocks=4, step_tiles=st.step_tiles)
    ref = spmv_packed.packed_scan_plain(*args, **kw)
    assert ref.dtype == spmv_packed.scan_dtype(plan.vals.dtype)
    if kind in ("i8", "u8", "i16", "u16"):
        assert ref.dtype == plan.vals.dtype
    rows = plan.vals.shape[0] * 8
    entry = _kernels.entry("packed_scan_f32", plan.vals.dtype)
    for sl in (4, 8, 16):
        for threads in (128, 256, 512, 1024):
            shape = spmv_packed.ScanShape(sl, threads,
                                          -(-rows * 128 // (threads * sl)))
            before = _kernels.launches[entry]
            got = spmv_packed.packed_scan_kernel(*args, **kw, shape=shape)
            assert _kernels.launches[entry] == before + 1
            _same(got, ref)
    for shape in (spmv_packed.ScanShape(32, 256, 1),      # 32 slots
                  spmv_packed.ScanShape(8, 2048, 1),      # > 1024 threads
                  spmv_packed.ScanShape(8, 96 + 8, 1)):   # not whole warps
        with pytest.raises(RuntimeError, match="failed to launch"):
            spmv_packed.packed_scan_kernel(*args, **kw, shape=shape)
    with pytest.raises(ValueError, match="aligned"):
        spmv_packed.packed_scan_kernel(_misaligned(plan.vals), *args[1:],
                                       **kw)
    with pytest.raises(ValueError, match="aligned"):
        spmv_packed.packed_scan_kernel(plan.vals, _misaligned(plan.cols),
                                       *args[2:], **kw)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("kind", ALL_KINDS)
def test_window_kernel_every_shape_matches_plain(cuda, kind, fold):
    # kernel B at 1, 2, 4 and 8 output rows a CTA over the tiles of 19
    # groups (19 output rows when folding, 76 when not: a last CTA part
    # full), under each semiring the build runs, against its plain
    # version (the integers exactly); the wrong lanes a thread for the
    # build is refused, and a misaligned slab raises
    rng = np.random.default_rng(31)
    n = 2048 + 3 * 128
    r = np.repeat(np.arange(n), 20)
    c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
    vdt = np.float32 if kind == "f32" else TYPED[kind]
    semirings = sorted(REGISTRY) if kind == "f32" else _typed_semirings(kind)
    for semiring in semirings:
        nonneg = semiring in ("max_times", "or_and")
        v = _kind_values(kind, r.shape[0], rng, nonneg)
        if semiring == "or_and":
            v = (v > 0.5).astype(np.float64)
        m = sp.csr_matrix((v, (r, c)), shape=(n, n + 300))
        m.sum_duplicates()
        m.sort_indices()
        kw = dict(split=16, uniform_split=True, window_group_tiles=2) \
            if fold else {}
        plan = place(build_sell_plan(
            from_scipy(m), window_grain=32, value_dtype=vdt,
            pad_value=REGISTRY[semiring].zero, **kw), cuda)
        st = plan.stats
        x = _kind_x(kind, n + 300, rng, cuda, nonneg)
        tiles = 19 * st.group_tiles
        args = (plan.vals[:tiles], plan.cols_win[:tiles],
                plan.window_base[:19], x)
        kwargs = dict(group_tiles=st.group_tiles,
                      window_grain=st.window_grain, fold=fold,
                      semiring=semiring)
        ref = spmv_sell.sell_window_plain(*args, **kwargs)
        picked = spmv_sell.kernel_window_shape(args[0], st.group_tiles,
                                               fold)
        L = picked.lanes_per_thread
        tpo = plan.vals.shape[2] // L
        out_rows = ref.shape[0]
        assert out_rows % 8
        entry = _kernels.entry("spmv_sell_window_f32", plan.vals.dtype)
        for n_cta in (1, 2, 4, 8):
            if n_cta * tpo % 32 or n_cta * tpo > 256:
                continue
            shape = spmv_sell.WindowShape(L, n_cta, n_cta * tpo,
                                          -(-out_rows // n_cta))
            before = _kernels.launches[entry]
            got = spmv_sell.sell_window_kernel(*args, **kwargs, shape=shape)
            assert _kernels.launches[entry] == before + 1
            _same(got, ref)
        wrong = dataclasses.replace(picked, lanes_per_thread=2 * L,
                                    threads=picked.threads // 2)
        with pytest.raises(RuntimeError, match="failed to launch"):
            spmv_sell.sell_window_kernel(*args, **kwargs, shape=wrong)
    with pytest.raises(ValueError, match="aligned"):
        spmv_sell.sell_window_kernel(_misaligned(args[0]), *args[1:],
                                     **kwargs)


@pytest.mark.parametrize("kind", sorted(TYPED))
def test_typed_spmm_kernels_match_plain(cuda, kind):
    # kernel I, and kernel H on a plan whose long row splits a slice
    # (the integer builds add its pieces with integer atomics)
    from spmv_vector_cache_tpu_torch.ops import spmm_dia, spmm_sell

    rng = np.random.default_rng(28)
    offs, n, k = [-1025, -1, 0, 3, 1300], 3000, 16
    m = sp.spdiags(_typed_values(kind, len(offs) * n, rng).reshape(
        len(offs), n), offs, n, n).tocsr()
    plan = place(build_dia_plan(from_scipy(m), value_dtype=TYPED[kind]),
                 cuda)
    b = torch.stack([_typed_x(kind, n, rng, cuda) for _ in range(k)], 1) \
        .contiguous()
    args = (plan.vals, plan.offsets, b, n)
    _same(spmm_dia.spmm_dia_kernel(*args), spmm_dia.spmm_dia_plain(*args))
    n = 2048
    r = np.repeat(np.arange(n), 20)
    c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
    r = np.concatenate([r, np.full(600, 5)])
    c = np.concatenate([c, rng.choice(np.arange(128, 1700), 600,
                                      replace=False)])
    m = sp.csr_matrix((_typed_values(kind, r.shape[0], rng), (r, c)),
                      shape=(n, n))
    m.sum_duplicates()
    m.sort_indices()
    plan = place(build_sell_plan(from_scipy(m), window_grain=32,
                                 groups_per_step=1, value_dtype=TYPED[kind]),
                 cuda)
    assert plan.work.split
    st = plan.stats
    b = torch.stack([_typed_x(kind, n, rng, cuda) for _ in range(k)], 1) \
        .contiguous()
    args = (plan.vals, plan.cols_win, plan.window_base, plan.tile_slice, b)
    kwargs = dict(num_slices=plan.num_slices, group_tiles=st.group_tiles,
                  window_grain=st.window_grain,
                  parts=spmv_sell.row_parts(plan), rows=n)
    _same(spmm_sell.spmm_window_kernel(*args, **kwargs, work=plan.work),
          spmm_sell.spmm_window_plain(*args, **kwargs))


@pytest.mark.parametrize("family", ["dia", "window", "hybrid", "deep",
                                    "packed", "cached"])
@pytest.mark.parametrize("kind", sorted(TYPED))
def test_typed_operator_on_the_card_matches_cpu(cuda, kind, family):
    # op @ x (and op @ B where a fused kernel serves the plan) on the card
    # against the same operator on the CPU
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
    from spmv_vector_cache_tpu_torch.tools import realistic

    rng = np.random.default_rng(29)
    n = 4096
    if family in ("dia", "hybrid"):
        m = sp.spdiags(np.ones((27, n)), list(range(-13, 14)), n, n).tocsr()
        if family == "hybrid":
            n = 32768
            m = sp.spdiags(np.ones((27, n)), list(range(-13, 14)), n,
                           n).tocsr()
            rr = np.repeat(np.arange(n), 2)
            cc = np.clip(rr + rng.integers(-512, 513, rr.shape[0]), 0, n - 1)
            m = (m + sp.csr_matrix((np.ones(rr.shape[0]), (rr, cc)),
                                   shape=(n, n))).tocsr()
    elif family == "window":
        r = np.repeat(np.arange(n), 27)
        c = (r // 128) * 128 + rng.integers(0, 128, r.shape[0])
        m = sp.csr_matrix((np.ones(r.shape[0]), (r, c)), shape=(n, n))
    elif family == "deep":
        m = _uniform(rng, n, 40000, 16, "plus_times").astype(np.float64)
    elif family == "packed":
        m = None                          # realistic.mac_econ_like()
    else:
        r = np.repeat(np.arange(1 << 15), 16)
        w = (np.arange(1 << 16) + 10.0) ** -2.5
        c = rng.permutation(1 << 16)[rng.choice(1 << 16, r.shape[0],
                                                p=w / w.sum())]
        m = sp.csr_matrix((np.ones(r.shape[0]), (r, c)),
                          shape=(1 << 15, 1 << 16))
    if m is None:
        a = realistic.mac_econ_like()
    else:
        m.sum_duplicates()
        m.sort_indices()
        a = from_scipy(m)
    a.data[:] = _typed_values(kind, a.data.shape[0], rng)
    op = SparseOperator.from_matrix(a, value_dtype=TYPED[kind])
    cpu = SparseOperator.from_matrix(a, value_dtype=TYPED[kind],
                                     device="cpu")
    assert type(op.plan) is type(cpu.plan)
    x = _typed_x(kind, a.shape[1], rng, "cpu")
    _same((op @ x).cpu(), cpu @ x)
    if family in ("dia", "window", "hybrid"):
        b = torch.stack([_typed_x(kind, a.shape[1], rng, "cpu")
                         for _ in range(16)], 1)
        _same((op @ b).cpu(), cpu @ b)
