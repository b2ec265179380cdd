"""Port parity: the ChunkPlan family against the JAX package's.

The matrices of the JAX package's ``tests/test_chunk.py`` (pareto-banded,
heavy subwindow + window fallback, duplicates, empty rows and tail
padding, min_plus), made from a seed with numpy, go through both
packages:

* ``build_chunk_plan`` and ``auto_plan`` give byte-equal plans;
* ``lane_unpermute`` (kernel C's plain version) equals the JAX Pallas
  kernel in interpret mode exactly (it moves values, it adds nothing);
* kernel D's heavy slab and work list (``formats/tables.py``): every real
  heavy tile once, no padding, each heavy row one run, a long row split;
* the chunk light route's records (``formats/tables.py``): exactly the
  light buckets' real slots, by lane row in the reference's order, and its
  plain version against the reference's per-bucket ``_window_partials``,
  segment reduce and add across buckets (float32 tolerance under
  plus_times, exactly under the other semirings); a non-finite x at a
  column that only padding reads (a deliberate difference);
* ``subwin_plain`` (the reference's ``_subwin_partials``), kernel D's
  plain version and ``spmv_plan`` on a ChunkPlan (kernels B, D, C) agree
  with JAX in interpret mode to a max abs error <= 1e-5 * max(1,
  max|ref|) for plus_times and the float semirings (float32 sums in
  another order), exactly for or_and;
* y agrees with the float64 host loop below 1e-4 relative.

The JAX side runs each plan with one 8-tile group per grid step
(``_small_steps``): the grid step sets only how the interpreted kernel is
blocked, not what it computes, and a smaller step keeps the interpreted
kernels quick to compile.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spmv_vector_cache_tpu.formats import chunk as jchunk
from spmv_vector_cache_tpu.formats import plan as jplan
from spmv_vector_cache_tpu.ops import lane_perm as jlane
from spmv_vector_cache_tpu.ops import operator as joperator
from spmv_vector_cache_tpu.ops import reference as jref
from spmv_vector_cache_tpu.ops import semiring as jsr
from spmv_vector_cache_tpu.ops import spmv_pallas as jsell
from spmv_vector_cache_tpu_torch.formats import chunk as pchunk
from spmv_vector_cache_tpu_torch.formats import plan as pplan
from spmv_vector_cache_tpu_torch.formats import tables as ptables
from spmv_vector_cache_tpu_torch.interop import plan_from_reference
from spmv_vector_cache_tpu_torch.ops import lane_perm as plane
from spmv_vector_cache_tpu_torch.ops import spmv_chunk as pspmv_chunk
from spmv_vector_cache_tpu_torch.ops import spmv_sell as psell
from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
from tests.test_torch_plan import assert_plans_equal, both

SEMIRINGS = ("plus_times", "min_plus", "max_plus", "max_times", "or_and")


# ---------------------------------------------------------------------------
# matrices (scipy CSR, float32, sorted), after tests/test_chunk.py
# ---------------------------------------------------------------------------

def _csr(r, c, v, shape):
    """COO triples -> scipy CSR keeping duplicates (no summing)."""
    r, c = np.asarray(r, np.int64), np.asarray(c, np.int64)
    order = np.lexsort((c, r))
    indptr = np.concatenate(([0], np.cumsum(np.bincount(
        r, minlength=shape[0])))).astype(np.int32)
    return sp.csr_matrix((np.asarray(v, np.float32)[order],
                          c[order].astype(np.int32), indptr), shape=shape)


def pareto_banded(n=4096, seed=0, cap=2048, spread=300):
    rng = np.random.default_rng(seed)
    lens = np.minimum((rng.pareto(1.2, n) * 8).astype(np.int64) + 1, cap)
    r = np.repeat(np.arange(n), lens)
    c = np.clip((np.abs(rng.standard_normal(r.shape[0])) * spread)
                .astype(np.int64) + r - spread // 2, 0, n - 1)
    return _csr(r, c, rng.standard_normal(r.shape[0]), (n, n))


def heavy_subwin(n=20000):
    # one dense heavy row (subwindow tiles), one sparse heavy row (window
    # packer fallback), a light diagonal
    rng = np.random.default_rng(5)
    r = np.concatenate([np.zeros(3000), np.full(2000, 7), np.arange(n)])
    c = np.concatenate([np.arange(5000, 8000),
                        np.sort(rng.choice(n, 2000, replace=False)),
                        np.arange(n)])
    return _csr(r, c, rng.standard_normal(r.shape[0]), (n, n))


def duplicates():
    return _csr([0, 0, 0, 1, 1], [5, 5, 9, 2, 2], [1., 2., 3., 4., 5.],
                (200, 200))


def empty_rows():
    # empty rows and a row count that is not a multiple of 1024
    return _csr([5, 700, 700, 1500], [3, 10, 900, 100], np.ones(4),
                (1543, 1543))


def heavy_two_buckets(n=60000):
    """Row 3: 3072 consecutive columns (W = 1-2 tiles) and 3072 at stride
    4 (W = 8 tiles), one heavy row over two W buckets; row 9: 40,000
    consecutive columns, a heavy row of 39 subwindow tiles, past RUN_CAP;
    a light diagonal."""
    r = np.concatenate([np.full(6144, 3), np.full(40000, 9), np.arange(n)])
    c = np.concatenate([np.arange(3072), 20000 + 4 * np.arange(3072),
                        10000 + np.arange(40000), np.arange(n)])
    v = np.random.default_rng(8).standard_normal(r.shape[0])
    return _csr(r, c, v, (n, n))


def heavy_only():
    # one dense heavy row and nothing else: subwindow tiles and no light
    # bucket, so the apply's light part is all empty segments
    return _csr(np.zeros(3000), np.arange(3000), np.ones(3000), (4, 4096))


CASES = {
    "pareto_banded": lambda: pareto_banded(),
    "heavy_subwin": heavy_subwin,
    "heavy_only": heavy_only,
    "duplicates": duplicates,
    "empty_rows": empty_rows,
}


def _small_steps(plan_ref):
    """The JAX plan with one 8-tile group per grid step (see the module
    docstring); arrays and every other field unchanged."""
    return dataclasses.replace(
        plan_ref,
        buckets=tuple(dataclasses.replace(
            b, stats=dataclasses.replace(b.stats, groups_per_step=1))
            for b in plan_ref.buckets),
        hbuckets=tuple(dataclasses.replace(h, groups_per_step=1)
                       for h in plan_ref.hbuckets))


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    assert np.array_equal(got[~finite], want[~finite])
    scale = max(1.0, float(np.abs(want[finite]).max(initial=0.0)))
    err = float(np.abs(got[finite] - want[finite]).max(initial=0.0))
    assert err <= 1e-5 * scale, (err, scale)


def _semiring_data(m, semiring, seed):
    """Matrix and x for a semiring: non-negative for min_plus and
    max_times, {0, 1} for or_and."""
    x = np.random.default_rng(seed).standard_normal(m.shape[1]).astype(
        np.float32)
    m = m.copy()
    if semiring in ("min_plus", "max_times"):
        m.data, x = np.abs(m.data), np.abs(x)
    elif semiring == "or_and":
        m.data = (np.abs(m.data) > 0.5).astype(np.float32)
        x = (x > 0).astype(np.float32)
    return m, x


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_build_chunk_plan_byte_equal(case):
    ja, pa = both(CASES[case]())
    port = pchunk.build_chunk_plan(pa)
    assert isinstance(port, pchunk.ChunkPlan)
    assert_plans_equal(port, jchunk.build_chunk_plan(ja))
    for b in port.buckets:
        pplan.validate_plan(b)
        assert b.stats.num_slices == port.num_blocks + port.num_heavy


def test_build_chunk_plan_structure():
    _, pa = both(heavy_subwin())
    p = pchunk.build_chunk_plan(pa)
    assert p.num_heavy == 2 and len(p.hbuckets) >= 1
    assert all(isinstance(h, pchunk.SubwinPlan) for h in p.hbuckets)
    _, pa = both(duplicates())
    p = pchunk.build_chunk_plan(pa)
    assert p.stats.nnz == 5                   # counts the original nnz
    assert sum(b.stats.nnz for b in p.buckets) == 3   # merged slots


def test_build_chunk_plan_min_plus_byte_equal():
    m, _ = _semiring_data(pareto_banded(n=1024, seed=11, cap=256),
                          "min_plus", 0)
    ja, pa = both(m)
    kw = dict(pad_value=float("inf"), merge_duplicates=False)
    assert_plans_equal(pchunk.build_chunk_plan(pa, **kw),
                       jchunk.build_chunk_plan(ja, **kw))


def test_auto_plan_routes_powerlaw_to_chunk():
    # the recipe of the JAX package's test of the same name
    ja, pa = both(pareto_banded(n=8192, seed=13, cap=4096))
    port = pplan.auto_plan(pa)
    assert isinstance(port, pchunk.ChunkPlan)
    assert_plans_equal(port, jplan.auto_plan(ja))


def test_build_chunk_plan_rejects_other_sigma():
    _, pa = both(duplicates())
    with pytest.raises(ValueError, match="1024"):
        pchunk.build_chunk_plan(pa, sigma=512)


# ---------------------------------------------------------------------------
# kernels C and D (plain versions) against the Pallas kernels
# ---------------------------------------------------------------------------

def test_lane_unpermute_matches_jax():
    rng = np.random.default_rng(2)
    S = 24
    y2d = rng.standard_normal((S, 128)).astype(np.float32)
    perm = np.arange(S * 128)
    for w0 in range(0, S * 128, 1024):
        perm[w0:w0 + 1024] = w0 + rng.permutation(1024)
    idx = (perm - (np.arange(S * 128) // 1024) * 1024).astype(
        np.int16).reshape(S, 128)
    want = np.asarray(jlane.lane_unpermute(y2d, idx, interpret=True))
    got = plane.lane_unpermute(torch.from_numpy(y2d), torch.from_numpy(idx))
    assert got.numpy().tobytes() == want.tobytes()
    assert np.array_equal(got.numpy().reshape(-1), y2d.reshape(-1)[perm])


@pytest.mark.parametrize("operand", ["y2d", "idx"])
def test_lane_unpermute_refuses_a_misaligned_view(operand):
    # kernel C reads both operands as 16-byte vectors: a contiguous view
    # that starts off a 16-byte boundary is refused on either device
    y2d = torch.zeros(8 * 128 + 4)
    idx = torch.zeros(8 * 128 + 8, dtype=torch.int16)
    ok = (y2d[4:].reshape(8, 128), idx[8:].reshape(8, 128))
    assert torch.equal(plane.lane_unpermute(*ok), ok[0])
    bad = (y2d[1:1025].reshape(8, 128), ok[1]) if operand == "y2d" else \
        (ok[0], idx[1:1025].reshape(8, 128))
    assert bad[0].is_contiguous() and bad[1].is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        plane.lane_unpermute(*bad)


#: a bad perm_idx for placement to refuse: what it changes, the message
BAD_PERM_IDX = {
    "above": (lambda i: np.where(i == 0, 1024, i).astype(np.int16),
              "outside"),
    "below": (lambda i: np.where(i == 0, -1, i).astype(np.int16),
              "outside"),
    "dtype": (lambda i: i.astype(np.int32), "int16"),
    "rows": (lambda i: i[:-1], "8k, 128"),
}


@pytest.mark.parametrize("bad", sorted(BAD_PERM_IDX))
def test_place_checks_perm_idx(bad):
    # kernel C reads a placed plan's perm_idx without a check on each
    # apply: placement refuses one it could not read
    _, pa = both(pareto_banded(n=2048, seed=3, cap=512))
    plan = pchunk.build_chunk_plan(pa)
    pplan.place(plan, "cpu")
    change, match = BAD_PERM_IDX[bad]
    with pytest.raises(ValueError, match=match):
        pplan.place(dataclasses.replace(
            plan, perm_idx=change(plan.perm_idx)), "cpu")


def test_unpermute_plan_rows_is_lane_unpermute():
    rng = np.random.default_rng(4)
    _, pa = both(pareto_banded(n=2048, seed=3, cap=512))
    plan = pplan.place(pchunk.build_chunk_plan(pa), "cpu")
    y2d = torch.from_numpy(rng.standard_normal(
        (plan.num_blocks, 128)).astype(np.float32))
    assert torch.equal(plane.unpermute_plan_rows(y2d, plan.perm_idx),
                       plane.lane_unpermute(y2d, plan.perm_idx))
    with pytest.raises(ValueError, match="perm_idx"):
        plane.unpermute_plan_rows(y2d[:8], plan.perm_idx)
    with pytest.raises(ValueError, match="float32"):
        plane.unpermute_plan_rows(y2d.double(), plan.perm_idx)


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_subwin_partials_match_jax(semiring):
    # the reference's per-tile function, bucket by bucket
    m, x = _semiring_data(heavy_subwin(), semiring, 3)
    ja, _ = both(m)
    jp = jchunk.build_chunk_plan(
        ja, pad_value=float(jsr.get(semiring).zero),
        merge_duplicates=semiring == "plus_times")
    assert jp.hbuckets
    for h in _small_steps(jp).hbuckets:
        want = jsell._subwin_partials(h, x, True, semiring)
        ph = plan_from_reference(h, "cpu")
        got = pspmv_chunk.subwin_plain(ph.vals, ph.cols_win, ph.bases,
                                       torch.from_numpy(x),
                                       semiring=semiring)
        if semiring == "or_and":
            assert got.numpy().tobytes() == np.asarray(want).tobytes()
        else:
            _assert_close(got.numpy(), want)


def _bucket_tiles(plan):
    """(bucket, tile) -> (vals, cols_win, bases, tile_seg) of every tile
    of every heavy bucket, padding included."""
    return {(i, t): (h.vals[t], h.cols_win[t], h.bases[t],
                     int(h.tile_seg[t]))
            for i, h in enumerate(plan.hbuckets)
            for t in range(h.num_tiles)}


def test_heavy_tiles_work_list():
    _, pa = both(heavy_two_buckets())
    plan = pplan.place(pchunk.build_chunk_plan(pa), "cpu")
    nblk, nseg = plan.num_blocks, plan.num_blocks + plan.num_heavy
    # placement built the slab and its work list; the plan is unchanged
    heavy = plan.heavy
    assert heavy is not None and heavy.work is not None
    assert_plans_equal(plan, jchunk.build_chunk_plan(both(
        heavy_two_buckets())[0]))
    # every slab tile is one real tile of one bucket, each real tile once
    tiles = _bucket_tiles(plan)
    pads = {(i, t) for i, h in enumerate(plan.hbuckets)
            for t in range(h.num_tiles - ptables.padding_tiles(h, nseg),
                           h.num_tiles)}
    assert pads and all(tiles[k][3] == nseg - 1 for k in pads)
    assert all(bool((tiles[k][0] == 0).all()) for k in pads)
    seen, src = set(), []
    for t in range(heavy.vals.shape[0]):
        hit = [k for k, (v, c, b, _) in tiles.items()
               if torch.equal(v, heavy.vals[t]) and
               torch.equal(c, heavy.cols_win[t]) and
               torch.equal(b, heavy.bases[t])]
        assert len(hit) == 1 and hit[0] not in seen and hit[0] not in pads
        seen.add(hit[0])
        src.append(hit[0])
    assert seen == set(tiles) - pads
    # the runs follow tile_seg: each tile adds to its own heavy row, rows
    # ascending, each row's tiles one run
    seg = np.array([tiles[k][3] for k in src])
    tile_row = heavy.tile_row.numpy()
    assert np.all(np.diff(tile_row) >= 0) and np.all(np.diff(seg) >= 0)
    rows = heavy.rows.numpy()
    assert np.all(np.diff(rows) > 0)
    assert np.array_equal(rows[tile_row],
                          plan.heavy_rows.numpy()[seg - nblk])
    # row 3 (the rows are 3 and 9) has tiles in two W buckets and forms
    # one run of one record; row 9's 39 tiles are split into atomic pieces
    assert rows.tolist() == [3, 9]
    assert len({src[t][0] for t in np.flatnonzero(tile_row == 0)}) == 2
    work = heavy.work
    recs = work.runs.numpy()
    s1 = recs[:, 3] & ~ptables.RUN_ATOMIC
    atomic = (recs[:, 3] & ptables.RUN_ATOMIC) != 0
    mine = (recs[:, 2] <= 0) & (0 < s1)
    assert mine.sum() == 1 and not atomic[mine].any()
    t0, t1 = recs[mine, 0][0], recs[mine, 1][0]
    assert (t0, t1) == (0, int((tile_row == 0).sum()))
    long_row = (recs[:, 2] <= 1) & (1 < s1)
    assert int((tile_row == 1).sum()) == 39 > ptables.RUN_CAP
    assert long_row.sum() >= 2 and atomic[long_row].all()
    assert work.split and work.max_tiles <= ptables.RUN_CAP


def test_heavy_slab_needs_a_placed_plan():
    # the slab and its work list are built at placement; a plan whose
    # arrays became tensors some other way is refused before any apply
    _, pa = both(heavy_subwin())
    host = pchunk.build_chunk_plan(pa)
    unplaced = pplan.map_arrays(host, torch.from_numpy)
    assert unplaced.heavy is None and unplaced.light is None
    with pytest.raises(ValueError, match="placed"):
        psell.spmv_plan(unplaced, torch.ones(pa.shape[1]))
    placed = pplan.place(host, "cpu")
    assert placed.heavy.vals.shape[1:] == (8, 128)


def _jax_heavy_rows(jp, x, y0, semiring):
    """y0 with the reference's heavy subwindow part added: its per-tile
    partials, segment reduce per bucket, add across buckets, lane fold."""
    import jax.numpy as jnp

    s = jsr.get(semiring)
    _, axis_reduce = jsr.kernel_ops(semiring)
    nseg = jp.num_blocks + jp.num_heavy
    y2d = None
    for h in _small_steps(jp).hbuckets:
        y2b = s.segment_reduce(jsell._subwin_partials(h, x, True, semiring),
                               jnp.asarray(h.tile_seg), num_segments=nseg,
                               indices_are_sorted=True)
        y2d = y2b if y2d is None else s.add(y2d, y2b).astype(y2b.dtype)
    yh = axis_reduce(y2d[jp.num_blocks:], 1)
    rows = np.asarray(jp.heavy_rows)
    want = y0.copy()
    want[rows] = np.asarray(s.add(jnp.asarray(y0[rows]), yh)).astype(
        y0.dtype)
    return want


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("case", ["heavy_subwin", "heavy_two_buckets"])
def test_heavy_plain_matches_jax(case, semiring):
    # kernel D's plain version: each heavy row's subwindow tiles summed
    # into y in place, against the reference's partials and their reduce
    m, x = _semiring_data({"heavy_subwin": heavy_subwin,
                           "heavy_two_buckets": heavy_two_buckets}[case](),
                          semiring, 3)
    ja, pa = both(m)
    kw = dict(pad_value=float(jsr.get(semiring).zero),
              merge_duplicates=semiring == "plus_times")
    jp = jchunk.build_chunk_plan(ja, **kw)
    plan = pplan.place(pchunk.build_chunk_plan(pa, **kw), "cpu")
    y0 = np.random.default_rng(7).standard_normal(m.shape[0]).astype(
        np.float32)
    if semiring == "or_and":
        y0 = (y0 > 0).astype(np.float32)
    heavy = plan.heavy
    y = torch.from_numpy(y0.copy())
    got = pspmv_chunk.heavy_plain(heavy.vals, heavy.cols_win, heavy.bases,
                                  heavy.tile_row, heavy.rows,
                                  torch.from_numpy(x), y, semiring=semiring)
    assert got is y                     # in place
    # the wrapper takes the plain version on CPU tensors
    y2 = torch.from_numpy(y0.copy())
    pspmv_chunk.heavy_kernel(heavy, torch.from_numpy(x), y2,
                             semiring=semiring)
    assert torch.equal(y2, y)
    want = _jax_heavy_rows(jp, x, y0, semiring)
    if semiring == "or_and":
        assert got.numpy().tobytes() == want.tobytes()
    else:
        _assert_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# the chunk light route: placement's records and the plain version
# ---------------------------------------------------------------------------

def _semiring_plans(m, semiring):
    """(JAX plan, placed port plan) of ``m`` under ``semiring``: padded
    with its zero, duplicates merged only under plus_times."""
    ja, pa = both(m)
    kw = dict(pad_value=float(jsr.get(semiring).zero),
              merge_duplicates=semiring == "plus_times")
    return (jchunk.build_chunk_plan(ja, **kw),
            pplan.place(pchunk.build_chunk_plan(pa, **kw), "cpu"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_light_records_are_the_real_slots(case):
    _, plan = _semiring_plans(CASES[case](), "plus_times")
    light = plan.light
    nseg = plan.num_blocks + plan.num_heavy
    row_off = light.row_off.numpy()
    assert row_off.shape == (nseg * 128 + 1,) and row_off[0] == 0
    assert np.all(np.diff(row_off) >= 0)
    assert light.vals.shape[0] == sum(b.stats.nnz for b in plan.buckets)
    # every record is one live slot (those build_chunk_plan counted), in
    # the reference's order within a lane row: bucket, tile, position
    want = []
    for bi, b in enumerate(plan.buckets):
        t, p, lane = np.nonzero(b.vals.numpy() != b.stats.pad_value)
        want += [(int(b.tile_slice[ti]) * 128 + li, bi, ti, pi,
                  int(b.cols[ti, pi, li]), float(b.vals[ti, pi, li]))
                 for ti, pi, li in zip(t, p, lane)]
    want.sort(key=lambda w: w[:4])
    rows = np.repeat(np.arange(nseg * 128), np.diff(row_off))
    got = list(zip(rows.tolist(), light.cols.tolist(),
                   light.vals.tolist()))
    assert got == [(w[0], w[4], w[5]) for w in want]
    # a segment is tiled where some bucket tile, padding included, lands
    tiled = np.zeros(nseg, bool)
    for b in plan.buckets:
        tiled[b.tile_slice.numpy()] = True
    assert np.array_equal(light.tiled.numpy(), tiled)
    # the work list: every segment's rows in order, at most 128 a CTA
    units, first = light.units.numpy().T
    assert np.array_equal(first, row_off[units])
    assert units[0] == 0 and units[-1] == nseg * 128
    assert np.all(np.diff(units) > 0) and np.all(np.diff(units) <= 128)
    assert set(range(0, nseg * 128, 128)) <= set(units.tolist())


def test_light_units_split_long_segments():
    # a segment's rows start a new CTA each time another unit_records
    # records have gone by since the segment's first; a row is never split
    row_off = np.concatenate(([0], np.cumsum([300] + [1] * 127 + [0] * 128
                                             + [10] * 128)))
    units, first = ptables.light_units(row_off, 64).T
    assert np.array_equal(first, row_off[units])
    assert units[:6].tolist() == [0, 1, 21, 85, 128, 256]
    assert units[-1] == 384
    # the segment of 10-record rows: units of 6 or 7 rows, 60-70 records
    per_unit = np.diff(units[5:])
    assert set(per_unit.tolist()) == {6, 7}
    assert ptables.light_units(row_off, 1 << 30)[:, 0].tolist() == \
        [0, 128, 256, 384]
    with pytest.raises(ValueError, match="128"):
        ptables.light_units(row_off[:-1], 64)


def test_light_records_need_a_placed_plan():
    _, pa = both(pareto_banded(n=2048, seed=3, cap=512))
    host = pchunk.build_chunk_plan(pa)
    unplaced = pplan.map_arrays(host, torch.from_numpy)
    assert unplaced.light is None
    with pytest.raises(ValueError, match="placed"):
        psell.spmv_plan(unplaced, torch.ones(pa.shape[1]))
    placed = pplan.place(host, "cpu")
    assert placed.light.vals.shape[0] == \
        sum(b.stats.nnz for b in host.buckets)


def _jax_light(jp, x, semiring):
    """The reference's light part of ``_spmv_chunk``: each bucket's
    ``_window_partials`` (interpret mode), its sorted segment reduce over
    the unified segment space, the add across buckets."""
    import jax.numpy as jnp

    s = jsr.get(semiring)
    nseg = jp.num_blocks + jp.num_heavy
    y2d = s.segment_reduce(jnp.zeros((0, 128), jnp.float32),
                           jnp.zeros(0, jnp.int32), num_segments=nseg)
    for i, b in enumerate(_small_steps(jp).buckets):
        part, fold = jsell._window_partials(b, x, True, semiring)
        ids = jnp.asarray(b.tile_slice)
        if fold:
            ids = ids[::b.stats.group_tiles]
        y2b = s.segment_reduce(part, ids, num_segments=nseg,
                               indices_are_sorted=True)
        y2d = y2b if i == 0 else s.add(y2d, y2b).astype(y2b.dtype)
    return np.asarray(y2d)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_light_plain_matches_jax(case, semiring):
    m, x = _semiring_data(CASES[case](), semiring, 6)
    jp, plan = _semiring_plans(m, semiring)
    want = _jax_light(jp, x, semiring)
    light = plan.light
    got = pspmv_chunk.light_plain(light, torch.from_numpy(x),
                                  semiring=semiring)
    # the wrapper takes the plain version on CPU tensors
    assert torch.equal(pspmv_chunk.light_kernel(
        light, torch.from_numpy(x), semiring=semiring), got)
    if semiring == "plus_times":
        _assert_close(got.numpy(), want)
    else:
        # min, max and or_and of the same float32 products: exact
        assert got.numpy().tobytes() == want.tobytes()


def test_light_route_ignores_x_that_only_padding_reads():
    # x[c] = inf at a column that no nonzero reads but padding slots do
    # (offset 0 of a window based there): the reference multiplies the
    # padding's 0 by it and returns NaN in rows that never read column c;
    # the light route reads no padding and returns A @ x
    n = 1024
    rng = np.random.default_rng(10)
    r = np.repeat(np.arange(n), 3)
    c = (rng.integers(0, 8, r.shape[0]) * 128 + 5) % n
    m = sp.csr_matrix((rng.standard_normal(r.shape[0]).astype(np.float32),
                       (r, c)), shape=(n, n))
    m.sum_duplicates()
    jp, plan = _semiring_plans(m, "plus_times")
    bases = np.concatenate([np.asarray(b.window_base) for b in jp.buckets])
    col = int(bases[0]) * 128
    assert m.getcol(col).nnz == 0
    x = rng.standard_normal(n).astype(np.float32)
    x[col] = np.inf
    want = np.asarray(jsell._spmv_chunk(_small_steps(jp), x, interpret=True))
    assert np.isnan(want).any()
    y = psell.spmv_plan(plan, torch.from_numpy(x)).numpy()
    assert np.isfinite(y).all()
    want64 = m.astype(np.float64) @ np.where(np.isfinite(x), x, 0.0)
    assert np.abs(y - want64).max() / max(1.0, np.abs(want64).max()) < 1e-5


# ---------------------------------------------------------------------------
# the ChunkPlan apply, and the slice end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_spmv_chunk_matches_jax_and_host(case):
    m = CASES[case]()
    ja, _ = both(m)
    x = np.random.default_rng(4).standard_normal(m.shape[1]).astype(
        np.float32)
    jp = jchunk.build_chunk_plan(ja)
    want = jsell.spmv_plan(_small_steps(jp), x, interpret=True)
    y = psell.spmv_plan(plan_from_reference(jp, "cpu"), torch.from_numpy(x))
    _assert_close(y.numpy(), want)
    want64 = jref.spmv_numpy(ja, x.astype(np.float64))
    assert np.abs(y.numpy() - want64).max() / \
        max(1.0, np.abs(want64).max()) < 1e-4


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_spmv_chunk_heavy_semirings_match_jax(semiring):
    # the whole apply on a plan with heavy subwindow tiles (kernels B, C
    # and D), under each semiring, against the JAX package's _spmv_chunk
    m, x = _semiring_data(heavy_subwin(), semiring, 9)
    ja, pa = both(m)
    kw = dict(pad_value=float(jsr.get(semiring).zero),
              merge_duplicates=semiring == "plus_times")
    jp = jchunk.build_chunk_plan(ja, **kw)
    assert jp.hbuckets
    want = np.asarray(jsell._spmv_chunk(_small_steps(jp), x, interpret=True,
                                        semiring=semiring))
    y = psell.spmv_plan(pplan.place(pchunk.build_chunk_plan(pa, **kw),
                                    "cpu"),
                        torch.from_numpy(x), semiring=semiring).numpy()
    if semiring == "or_and":
        assert y.tobytes() == want.tobytes()
    else:
        _assert_close(y, want)


@pytest.mark.parametrize("semiring", ["min_plus", "or_and"])
def test_spmv_chunk_semirings_match_jax(semiring):
    m, x = _semiring_data(pareto_banded(n=1024, seed=11, cap=256),
                          semiring, 5)
    ja, pa = both(m)
    # auto_plan picks the chunk plan with the semiring's padding
    jp = jplan.auto_plan(ja, semiring=semiring)
    assert isinstance(jp, jchunk.ChunkPlan)
    want = np.asarray(jsell.spmv_plan(_small_steps(jp), x, interpret=True,
                                      semiring=semiring))
    port = pplan.auto_plan(pa, semiring=semiring)
    assert_plans_equal(port, jp)
    y = psell.spmv_plan(pplan.place(port, "cpu"), torch.from_numpy(x),
                        semiring=semiring).numpy()
    if semiring == "or_and":
        assert y.tobytes() == want.tobytes()
    else:
        _assert_close(y, want)


def test_operator_on_chunk_plan_matches_jax():
    ja, pa = both(pareto_banded(n=8192, seed=13, cap=4096))
    x = np.random.default_rng(6).standard_normal(ja.shape[1]).astype(
        np.float32)
    jop = joperator.SparseOperator.from_matrix(ja)
    op = SparseOperator.from_matrix(pa, device="cpu")
    assert isinstance(op.plan, pchunk.ChunkPlan)
    assert op.strategy == jop.strategy == "chunk"
    assert_plans_equal(op.plan, jop.plan)
    drop = ("plan_seconds", "detect_seconds", "build_seconds",
            "place_seconds", "discarded_build_seconds")
    assert {k: v for k, v in op.stats.as_dict().items() if k not in drop} \
        == {k: v for k, v in jop.stats.as_dict().items() if k not in drop}
    y = op @ x
    want = jsell.spmv_plan(_small_steps(jop.plan), x, interpret=True)
    _assert_close(y.numpy(), want)


def test_chunk_plan_rejects_other_strategies():
    _, pa = both(duplicates())
    plan = pplan.place(pchunk.build_chunk_plan(pa), "cpu")
    x = torch.ones(200)
    assert psell.spmv_plan(plan, x, strategy="chunk")[0].item() == 6.0
    with pytest.raises(ValueError, match="chunk"):
        psell.spmv_plan(plan, x, strategy="resident")
