"""Chunked SELL plans: skewed rows without a scatter epilogue
(counterpart of ``spmv_vector_cache_tpu/formats/chunk.py``).

The plan is built by the JAX package's host-side numpy code, carried over
unchanged (float32 only) so that both packages build byte-equal plans.

* **light rows** are length-sorted within aligned windows of 1024 rows
  (SELL-sigma) and bound to lanes in 128-row *blocks*; a tile holds up
  to 8 nonzeros per lane of one block, so the row reduction is a sum
  over positions and the merge of a block's tiles is a sorted segment
  reduction.  The row sort is undone by one in-block gather
  (``ops/lane_perm.py``);
* **heavy rows** (more than ``heavy_parts * 8`` nonzeros) pack up to
  1024 column-consecutive nonzeros of one row per tile; each 128-slot
  position row reads x from its own narrow window (``SubwinPlan``), and
  the lanes fold into the row total;
* tiles are greedily packed against column windows of ``bucket_ks``
  blocks; tiles of the same window size form one bucket, a standalone
  window :class:`~.plan.SellPlan` over a unified segment space
  ([0, num_blocks) = light blocks, then heavy rows);
* duplicate (row, col) entries are merged at plan time (plus-times
  only).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .plan import (TILES_PER_STEP, PlanStats, SellPlan, _as_csr, _cdiv,
                   build_dtype, check_pad, compute_window_rows,
                   finish_values, host_values, value_kind)
from .tables import (HeavyTiles, LightRecords, heavy_tiles, light_records,
                     table)

Array = Any

#: aligned row-sort window; the lane-unpermute kernel's one-block reach
#: (ops/lane_perm.py) requires exactly this value
CHUNK_SIGMA = 1024

#: default span buckets, as window block counts K
BUCKET_KS = (4, 16, 64)

#: rows with more than heavy_parts*8 nonzeros take the heavy
#: (row-packed) layout
HEAVY_PARTS = 32

#: rows the light slots' sort and the chunk floor take a pass at a time:
#: the passes bound their temporaries, not their results
ROWS_PER_PASS = 1 << 16

#: packer cost model: ns-per-tile ~ _COST_A + _COST_B * K (stream +
#: fixed vs gather-ladder passes, from the round-5 probes); only the
#: RATIO shapes packing decisions
_COST_A = 15.0
_COST_B = 5.2


@dataclasses.dataclass(frozen=True)
class ChunkStats:
    nnz: int                 # original matrix nnz (incl. duplicates)
    num_tiles: int           # across all buckets
    fill: float              # deduped slots / total slots
    bucket_ks: Tuple[int, ...]       # realized K per bucket
    bucket_tiles: Tuple[int, ...]
    residue_nnz: int         # nonzeros left to the residue plan
    num_blocks: int
    num_heavy: int

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SubwinPlan:
    """Sorted-subwindow tiles for heavy rows.

    Every tile holds up to 1024 *column-consecutive* nonzeros of one
    heavy row, laid rank-major: position row s covers ranks
    [128s, 128s+128) -- 128 consecutive sorted columns, so each position
    row reads x from a narrow window of its own, ``W`` blocks of 128
    from block ``bases[t, s]``.  ``tile_seg`` maps tiles to the plan's
    unified segment space (nondecreasing).
    """

    vals: Array          # (T, 8, 128)
    cols_win: Array      # (T, 8, 128) int16 offsets within sublane window
    bases: Array         # (T, 8) int32 sublane window base blocks
    tile_seg: Array      # (T,) int32 unified segment ids, nondecreasing
    shape: Tuple[int, int]
    window_blocks: int   # W
    groups_per_step: int

    @property
    def num_tiles(self) -> int:
        return int(self.vals.shape[0])


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Span-bucketed chunk layout of one sparse matrix.

    ``buckets`` are complete, standalone :class:`~.plan.SellPlan`\\ s
    over a unified segment space ([0, num_blocks) = light row blocks,
    [num_blocks, num_blocks+num_heavy) = heavy rows; each carries a
    correct ``row_map``, so ``validate_plan`` applies unchanged).  The
    apply sums the per-segment slice reductions, un-permutes the light
    part with ``perm_idx`` (``ops/lane_perm.py``), and lane-folds the
    heavy part.  ``residue`` is None, a :class:`~.cached.CooTail` or a
    :class:`~.packed.PackedPlan`.  Placement builds ``light`` and
    ``heavy`` (None without heavy tiles) for the light route and kernel
    D, and no work list for the buckets, which no apply runs alone.
    """

    buckets: Tuple[SellPlan, ...] = dataclasses.field(
        metadata={"bare": True})
    hbuckets: Tuple[SubwinPlan, ...]
    residue: Any                     # None, CooTail or PackedPlan
    perm_idx: Array                  # (num_blocks, 128) int16 in [0,1024)
    heavy_rows: Array                # (num_heavy,) int32, ascending
    shape: Tuple[int, int]
    stats: ChunkStats
    light: Optional[LightRecords] = table(light_records)
    heavy: Optional[HeavyTiles] = table(heavy_tiles)

    @property
    def num_blocks(self) -> int:
        return int(self.perm_idx.shape[0])

    @property
    def num_heavy(self) -> int:
        return int(self.heavy_rows.shape[0])


def check_perm_idx(perm_idx) -> None:
    """Raise unless ``perm_idx`` (numpy or torch) is what kernel C reads
    without a check on the apply path (``ops/lane_perm.py``): (8k, 128)
    int16 offsets in [0, CHUNK_SIGMA) within each aligned 8-row block.
    ``place`` runs it once per placed ChunkPlan."""
    shape = tuple(perm_idx.shape)
    if len(shape) != 2 or shape[1] != 128 or shape[0] % 8:
        raise ValueError(f"perm_idx must be (8k, 128), got {shape}")
    if perm_idx.dtype not in (np.int16, torch.int16):
        raise ValueError(f"perm_idx must be int16, got {perm_idx.dtype}")
    if shape[0] and not (0 <= int(perm_idx.min()) and
                         int(perm_idx.max()) < CHUNK_SIGMA):
        raise ValueError(f"perm_idx holds offsets outside [0, "
                         f"{CHUNK_SIGMA})")


def _greedy_windows(seg_lo, seg_hi, cols, bucket_ks, lane_cap: int,
                    lanes=None, next_cap=None, R: int = 128):
    """The greedy window partition of many segments at once, one window
    of every unfinished segment a round.

    Segment i holds the column-sorted slots ``[seg_lo[i], seg_hi[i])`` of
    ``cols``.  At each unprocessed slot the packer prices every window
    size K (slots covered / (tiles needed * (A + B*K))) and takes the
    best, the first on a tie.  ``lanes`` fixes each slot's lane (light
    blocks): a window takes every slot it covers, and needs as many
    tiles as its fullest lane has slots per ``lane_cap``; ``next_cap``
    is, for each slot, the smallest position at or after it holding the
    ``lane_cap``-th next slot of some lane in its segment (a suffix
    minimum), so that only a window that overfills a lane is counted
    slot by slot.  Without lanes (heavy rows) a window takes at most
    ``lane_cap * R`` slots into one tile.

    Yields, a round at a time, (segment, first slot, slots taken, tiles,
    window base block, realized K) of each window that round opened."""
    seg_lo = np.asarray(seg_lo, dtype=np.int64)
    seg_hi = np.asarray(seg_hi, dtype=np.int64)
    live = np.flatnonzero(seg_hi > seg_lo)
    if live.size == 0:
        return
    cols = np.asarray(cols, dtype=np.int64)
    assert seg_lo[0] == 0 and seg_hi[-1] == cols.shape[0] and \
        (seg_lo[1:] == seg_hi[:-1]).all(), "segments must lie end to end"
    # one ascending key over every segment: a window's end is one search
    span = int(cols.max(initial=0)) + bucket_ks[-1] * R + 1
    key = np.repeat(np.arange(seg_lo.shape[0], dtype=np.int64) * span,
                    seg_hi - seg_lo) + cols
    seg, pos, end = live, seg_lo[live], seg_hi[live]
    cap = lane_cap * R
    while seg.size:
        w0 = cols[pos] // R * R
        base = seg * span + w0
        best = None
        for K in bucket_ks:
            stop = np.searchsorted(key, base + K * R, side="left")
            cnt = stop - pos
            if lanes is None:
                tiles = -(-cnt // cap)
                take = np.minimum(cnt, cap)
            else:
                tiles = np.ones(cnt.shape[0], dtype=np.int64)
                over = np.flatnonzero(next_cap[pos] < stop)
                if over.size:
                    tiles[over] = np.maximum(1, -(-_fullest_lane(
                        lanes, pos[over], stop[over], R) // lane_cap))
                take = cnt
            eff = cnt / (tiles * (_COST_A + _COST_B * K))
            if best is None:
                best = [eff, take, tiles]
            else:
                up = eff > best[0]
                for slot, v in zip(best, (eff, take, tiles)):
                    slot[up] = v[up]
        _, take, tiles = best
        if lanes is None:
            tiles = -(-take // cap)
        kreal = -(-(cols[pos + take - 1] + 1 - w0) // R)
        yield seg, pos, take, tiles, w0 // R, np.maximum(1, kreal)
        pos = pos + take
        more = pos < end
        seg, pos, end = seg[more], pos[more], end[more]


def _seg_of_slots(seg_lo, seg_hi) -> np.ndarray:
    """Positions of the slots of segments ``[seg_lo[i], seg_hi[i])``,
    segment by segment."""
    n = seg_hi - seg_lo
    return np.repeat(seg_lo - np.cumsum(n) + n, n) + \
        np.arange(int(n.sum()), dtype=np.int64)


def _fullest_lane(lanes, lo, hi, R: int) -> np.ndarray:
    """The most slots any one lane holds in each range ``[lo[i], hi[i])``
    of ``lanes``."""
    n = hi - lo
    at = _seg_of_slots(lo, hi)
    rid = np.repeat(np.arange(lo.shape[0], dtype=np.int64), n)
    counts = np.bincount(rid * R + lanes[at], minlength=lo.shape[0] * R)
    return counts.reshape(lo.shape[0], R).max(axis=1)


def _light_slots(indptr, indices, heavy_mask_r, inv_pos, R: int = 128):
    """The light rows' slots in (block, column, source) order, the order
    of ``np.lexsort((cols, blocks))`` over the slots in source order:
    (src, blk, lane, col) int64 arrays.  Sorted a pass of rows at a time
    as one int64 key a slot (block, column and source bits): a value
    sort, with no index sort of the whole stream."""
    rows = indptr.shape[0] - 1
    colbits = max(1, int(indices.max(initial=0)).bit_length())
    out = ([], [], [], [])
    r0, step = 0, ROWS_PER_PASS
    while r0 < rows:
        r1 = min(rows, r0 + step)
        lens = np.diff(indptr[r0:r1 + 1])
        n = int(indptr[r1] - indptr[r0])
        srcbits = max(1, n.bit_length())
        blkbits = max(1, (-(-(r1 - r0) // R)).bit_length())
        wide = blkbits + colbits + srcbits > 62
        if wide and step > CHUNK_SIGMA:
            step //= 2
            continue
        row_pos = np.repeat(inv_pos[r0:r1], lens)
        at = np.flatnonzero(np.repeat(~heavy_mask_r[r0:r1], lens))
        blk = row_pos[at] // R - r0 // R
        cols = indices[indptr[r0]:indptr[r1]][at]
        if wide:                 # no room in one key: an index sort
            at = at[np.lexsort((cols, blk))]
        else:
            key = (blk << (colbits + srcbits)) | (cols << srcbits) | at
            key.sort()
            at = key & ((1 << srcbits) - 1)
        blk = row_pos[at] // R
        out[0].append(at + indptr[r0])
        out[1].append(blk)
        out[2].append(row_pos[at] % R)
        out[3].append(indices[indptr[r0]:indptr[r1]][at])
        r0, step = r1, ROWS_PER_PASS
    if not out[0]:
        return tuple(np.zeros(0, np.int64) for _ in range(4))
    return tuple(np.concatenate(o) for o in out)


def _rows_in_blocks(indptr, indices, data, rows, merge_duplicates,
                    heavy_parts, sigma, sort_rows):
    """The chunk layout's rows: duplicates merged where asked, the heavy
    rows' mask, and the light rows' sigma sort into 128-row blocks
    (``order``: sorted position -> row, ``inv_pos``: its inverse, over
    the rows padded to whole 8-block steps).  Returns (indptr, indices,
    data, heavy_mask_r, order, inv_pos)."""
    R, P = 128, 8
    nnz_orig = int(indptr[-1])
    if merge_duplicates and nnz_orig > 1:
        # cols are sorted within rows (_as_csr), so duplicates are
        # adjacent; one slot (and one stream byte) per distinct entry
        first = np.ones(nnz_orig, dtype=bool)
        np.not_equal(indices[1:], indices[:-1], out=first[1:])
        first[indptr[:-1][np.diff(indptr) > 0]] = True
        if not first.all():
            nz_row = np.repeat(np.arange(rows, dtype=np.int64),
                               np.diff(indptr))
            gid = np.cumsum(first) - 1
            data = np.bincount(gid, weights=data).astype(data.dtype)
            indices = indices[first]
            new_counts = np.bincount(nz_row[first], minlength=rows)
            indptr = np.concatenate(
                ([0], np.cumsum(new_counts))).astype(np.int64)
    lens_r = np.diff(indptr)
    heavy_mask_r = lens_r > heavy_parts * P

    # --- light part: sigma row sort -----------------------------------
    nblk = _cdiv(_cdiv(rows, R), TILES_PER_STEP) * TILES_PER_STEP
    rows_pad = nblk * R
    lens = np.zeros(rows_pad, dtype=np.int64)
    lens[:rows] = np.where(heavy_mask_r, 0, lens_r)   # heavy: no light part
    order = np.arange(rows_pad, dtype=np.int64)
    if sort_rows:
        for w0 in range(0, rows_pad, sigma):
            w1 = min(w0 + sigma, rows_pad)
            order[w0:w1] = w0 + np.argsort(-lens[w0:w1], kind="stable")
    inv_pos = np.empty(rows_pad, dtype=np.int64)
    inv_pos[order] = np.arange(rows_pad)
    return indptr, indices, data, heavy_mask_r, order, inv_pos


class ChunkRows:
    """The rows of one matrix as the chunk layout sees them, computed
    once and read by :func:`chunk_seconds_floor`, :func:`chunk_price` and
    :func:`build_chunk_plan`: the checked CSR's arrays (duplicates merged
    where asked), the heavy rows, the light rows' sigma sort and, on
    first use, the heavy rows' stretches."""

    def __init__(self, a, *, merge_duplicates: bool = True,
                 heavy_parts: int = HEAVY_PARTS, sigma: int = CHUNK_SIGMA,
                 sort_rows: bool = True):
        csr = _as_csr(a)
        self.shape = csr.shape
        self.key = (merge_duplicates, heavy_parts, sigma, sort_rows)
        indptr = np.asarray(csr.indptr, dtype=np.int64)
        self.nnz_orig = int(indptr[-1])
        self.empty = self.nnz_orig == 0 or self.shape[0] == 0
        if self.empty:
            return
        (self.indptr, self.indices, self.data, self.heavy_mask,
         self.order, self.inv_pos) = _rows_in_blocks(
            indptr, np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF,
            np.asarray(csr.data), self.shape[0], merge_duplicates,
            heavy_parts, sigma, sort_rows)
        self.heavy_rows = np.flatnonzero(self.heavy_mask).astype(np.int64)
        self._stretches = None

    def stretches(self):
        """:func:`_heavy_stretches` of the heavy rows, kept."""
        if self._stretches is None:
            self._stretches = _heavy_stretches(self.indptr, self.indices,
                                               self.heavy_rows)
        return self._stretches

    @classmethod
    def of(cls, a, merge_duplicates, heavy_parts, sigma, sort_rows):
        """``a`` itself where it is the ChunkRows of these settings, else
        the ChunkRows of the matrix ``a``."""
        key = (merge_duplicates, heavy_parts, sigma, sort_rows)
        if isinstance(a, cls):
            if a.key != key:
                raise ValueError(f"ChunkRows built for {a.key}, asked for "
                                 f"{key}")
            return a
        return cls(a, merge_duplicates=merge_duplicates,
                   heavy_parts=heavy_parts, sigma=sigma, sort_rows=sort_rows)


#: a heavy row's stretch of 1024 slots takes the subwin layout when each
#: of its sublane rows reaches at most this many blocks
SUBWIN_MAX_W = 8


def _dense_tiles(indptr, indices, heavy_rows, R: int = 128, P: int = 8):
    """Each heavy row's 1024-slot tiles, and whether each takes the subwin
    layout: every sublane row of the tile (128 consecutive columns of
    the row) spans at most ``SUBWIN_MAX_W`` blocks.  Returns (first tile
    of each row, dense flag of each tile), one pass over the sublane
    rows' first and last entries."""
    start = indptr[heavy_rows]
    hlen = indptr[heavy_rows + 1] - start
    nsr = _cdiv(hlen, R)
    hi_sr = np.repeat(np.arange(heavy_rows.shape[0], dtype=np.int64), nsr)
    k = np.arange(hi_sr.shape[0], dtype=np.int64) - \
        np.repeat(np.cumsum(nsr) - nsr, nsr)
    first = start[hi_sr] + k * R
    last = np.minimum(first + R - 1, start[hi_sr] + hlen[hi_sr] - 1)
    w_sr = indices[last] // R - indices[first] // R + 1
    ntile = _cdiv(hlen, P * R)
    # a tile's sublane rows are consecutive: its widest, by reduceat
    w_tile = np.maximum.reduceat(w_sr, np.flatnonzero(k % P == 0))
    return np.cumsum(ntile) - ntile, w_tile <= SUBWIN_MAX_W


def _heavy_stretches(indptr, indices, heavy_rows, R: int = 128, P: int = 8):
    """The heavy rows' slots, row by row: (source, heavy row ordinal,
    dense) where ``dense`` marks the slots of the tiles that
    :func:`_dense_tiles` gives the subwin layout; the rest go to the
    greedy window packer."""
    tile0, dense_tile = _dense_tiles(indptr, indices, heavy_rows, R, P)
    hlen = indptr[heavy_rows + 1] - indptr[heavy_rows]
    hs = _seg_of_slots(indptr[heavy_rows], indptr[heavy_rows + 1])
    hi_of = np.repeat(np.arange(heavy_rows.shape[0], dtype=np.int64), hlen)
    if not dense_tile.any():
        return hs, hi_of, np.zeros(hs.shape[0], dtype=bool)
    rank = np.arange(hs.shape[0], dtype=np.int64) - \
        np.repeat(np.cumsum(hlen) - hlen, hlen)
    return hs, hi_of, dense_tile[tile0[hi_of] + rank // (P * R)]


def chunk_seconds_floor(a, *, heavy_parts: int = HEAVY_PARTS,
                        sigma: int = CHUNK_SIGMA, sort_rows: bool = True,
                        merge_duplicates: bool = True,
                        heavy_exact: bool = False) -> float:
    """A lower bound on ``estimate_seconds(build_chunk_plan(a, ...))``
    (default buckets), from the columns the greedy windows must cover,
    without packing a window.

    A light block's slots and a heavy row's sparse slots, in column
    order, go into windows of consecutive slots; a window spanning k
    blocks yields at least one tile, and a bucket's tile costs at least
    ``15 + 5.2 k`` ns and 9.4 ns of the fold.  So such a segment whose
    slots lie in blocks b_1 <= ... <= b_m costs at least 29.6 ns plus,
    for each step d = b_(i+1) - b_i, the cheaper of a new window
    (29.6 ns) and widening the open one (5.2 d ns).  Subwin tiles and
    the residue add nothing to the bound; the fixed epilogue and one
    bucket's launch do.  With ``heavy_exact`` the heavy rows' tiles are
    packed and counted instead (each bucket's real tiles at its widest
    heavy K, the subwin buckets and the residue as built): a tighter
    bound, at the heavy rows' share of the price.  The planner prices the
    chunk plan only where these bounds do not already lose."""
    from .costmodel import (_NS_CHUNK_EPILOGUE, _NS_CHUNK_FOLD_TILE,
                            _NS_CHUNK_TILE, _NS_CHUNK_TILE_PER_K, _NS_LAUNCH)

    cr = ChunkRows.of(a, merge_duplicates, heavy_parts, sigma, sort_rows)
    if cr.empty:
        return 0.0
    R = 128
    rows, cols_n = cr.shape
    indptr, indices, heavy, inv_pos = cr.indptr, cr.indices, \
        cr.heavy_mask, cr.inv_pos
    per_window = _NS_CHUNK_TILE + _NS_CHUNK_TILE_PER_K + _NS_CHUNK_FOLD_TILE

    def steps(blocks, same):
        return float(np.minimum(per_window, _NS_CHUNK_TILE_PER_K *
                                np.diff(blocks)[same]).sum())

    ns, windows = 0.0, 0
    # light blocks, a pass of whole sigma windows at a time (each pass's
    # blocks its own): the distinct (block, column block) pairs, sorted
    ncb = _cdiv(cols_n, R)
    step = max(sigma, ROWS_PER_PASS // sigma * sigma)
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        lens = np.diff(indptr[r0:r1 + 1])
        keep = np.repeat(~heavy[r0:r1], lens)
        if not keep.any():
            continue
        lens = np.where(heavy[r0:r1], 0, lens)
        occ = np.repeat(inv_pos[r0:r1] // R - r0 // R, lens) * ncb + \
            indices[indptr[r0]:indptr[r1]][keep] // R
        occ.sort()
        occ = occ[np.concatenate(([True], occ[1:] != occ[:-1]))]
        same = (occ[1:] // ncb) == (occ[:-1] // ncb)
        windows += occ.shape[0] - int(same.sum())
        ns += steps(occ, same)
    if heavy_exact:
        ns += per_window * windows
        heavy = build_chunk_plan(cr, merge_duplicates=merge_duplicates,
                                 heavy_parts=heavy_parts, sigma=sigma,
                                 sort_rows=sort_rows, _price="heavy")
        if heavy is None:
            return (ns + (_NS_LAUNCH if windows else 0.0) +
                    _NS_CHUNK_EPILOGUE) * 1e-9
        from .costmodel import estimate_seconds

        return ns * 1e-9 + estimate_seconds(heavy)
    # heavy rows' sparse stretches, a segment a row
    if cr.heavy_rows.size:
        tile0, dense_tile = _dense_tiles(indptr, indices, cr.heavy_rows)
        mixed = np.add.reduceat(dense_tile, tile0) > 0
        plain = cr.heavy_rows[~mixed]
        if plain.size:
            # a row with no subwin tile: the steps between its neighbours,
            # read in place
            in_plain = np.zeros(rows, dtype=bool)
            in_plain[plain] = True
            pair = np.repeat(in_plain, np.diff(indptr))
            pair[indptr[plain]] = False               # a row's first slot
            windows += plain.shape[0]
            ns += float(np.minimum(per_window, _NS_CHUNK_TILE_PER_K * (
                np.diff(indices // R)[pair[1:]])).sum())
        if mixed.any():
            hs, hi_of, dense = _heavy_stretches(indptr, indices,
                                                cr.heavy_rows[mixed])
            sparse = ~dense
            hi = hi_of[sparse]
            if hi.size:
                same = hi[1:] == hi[:-1]
                windows += hi.shape[0] - int(same.sum())
                ns += steps(indices[hs[sparse]] // R, same)
    ns += per_window * windows + (_NS_LAUNCH if windows else 0.0)
    return (ns + _NS_CHUNK_EPILOGUE) * 1e-9


@dataclasses.dataclass(frozen=True)
class TilesPrice:
    """One bucket of a priced chunk plan: what the cost model reads of a
    bucket's SellPlan (``.stats.num_tiles``, ``.stats.window_blocks``)
    or of a SubwinPlan (``.num_tiles``, ``.window_blocks``)."""

    num_tiles: int
    window_blocks: int

    @property
    def stats(self) -> "TilesPrice":
        return self


@dataclasses.dataclass(frozen=True)
class ChunkPrice:
    """What the cost model reads of a :class:`ChunkPlan`, computed without
    laying out its tiles (:func:`chunk_price`)."""

    buckets: Tuple[TilesPrice, ...]
    hbuckets: Tuple[TilesPrice, ...]
    residue: Any


def chunk_price(a, *, bucket_ks: Tuple[int, ...] = BUCKET_KS,
                heavy_parts: int = HEAVY_PARTS, sigma: int = CHUNK_SIGMA,
                sort_rows: bool = True, merge_duplicates: bool = True,
                value_dtype=np.float32,
                pad_value: float = 0.0) -> Optional[ChunkPrice]:
    """The :class:`ChunkPrice` of ``build_chunk_plan(a, ...)`` with the
    same arguments (None where that returns None): the same greedy
    windows and bucket tile counts, with no tile laid out.  The planner
    prices the chunk candidate so, and builds it only when it wins."""
    return build_chunk_plan(a, value_dtype=value_dtype, pad_value=pad_value,
                            bucket_ks=bucket_ks, heavy_parts=heavy_parts,
                            sigma=sigma, sort_rows=sort_rows,
                            merge_duplicates=merge_duplicates, _price="all")


def _bucket_step(K: int, T0: int) -> int:
    return max(TILES_PER_STEP,
               min(512, (3 << 20) // (4096 + K * 512) // 8 * 8,
                   _cdiv(T0, TILES_PER_STEP) * TILES_PER_STEP))


def _subwin_step(W: int, T0: int) -> int:
    return max(TILES_PER_STEP,
               min(256, (3 << 20) // (6144 + W * 4096) // 8 * 8,
                   _cdiv(T0, TILES_PER_STEP) * TILES_PER_STEP))


class _Windows:
    """The greedy windows of one kind of segment, as the price needs
    them (tiles and the largest realized K of each bucket) or as the
    layout does (every window, in segment order)."""

    def __init__(self, bucket_ks, keep: bool):
        self.ks = np.asarray(bucket_ks)
        self.keep = keep
        self.tiles = np.zeros(len(bucket_ks), dtype=np.int64)
        self.kmax = np.zeros(len(bucket_ks), dtype=np.int64)
        self.parts = []

    def add(self, rounds):
        for w in rounds:
            if self.keep:
                self.parts.append(w)
                continue
            _, _, _, nt, _, k = w
            b = np.searchsorted(self.ks, k, side="left")
            self.tiles += np.bincount(b, weights=nt,
                                      minlength=self.ks.size).astype(np.int64)
            np.maximum.at(self.kmax, b, k)

    def ordered(self):
        """(segment, first slot, taken, tiles, base, K) of every window,
        by first slot."""
        if not self.parts:
            return tuple(np.zeros(0, np.int64) for _ in range(6))
        cols = [np.concatenate(c) for c in zip(*self.parts)]
        o = np.argsort(cols[1], kind="stable")
        return tuple(c[o] for c in cols)


def _rank_in_groups(key: np.ndarray) -> np.ndarray:
    """Each item's rank among the items of its key, in item order."""
    o = np.argsort(key, kind="stable")
    ks = key[o]
    first = np.ones(ks.shape[0], dtype=bool)
    first[1:] = ks[1:] != ks[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(ks.shape[0]), 0))
    rank = np.empty(ks.shape[0], dtype=np.int64)
    rank[o] = np.arange(ks.shape[0]) - start
    return rank


def _residue_plan(rsel, indptr, indices, data, rows, cols_n, value_dtype):
    """The residue plan of the heavy slots ``rsel`` (sources in the
    merged CSR): a CooTail, or a PackedPlan past ``COO_TAIL_MAX``."""
    from .cached import COO_TAIL_MAX, coo_tail_from_csr
    from .containers import COO
    from .convert import coo_to_csr

    nzr = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
    rcsr = coo_to_csr(COO(data=data[rsel],
                          row=nzr[rsel].astype(np.int32),
                          col=indices[rsel].astype(np.int32),
                          shape=(rows, cols_n)))
    if rsel.shape[0] <= COO_TAIL_MAX:
        return coo_tail_from_csr(rcsr, value_dtype=value_dtype)
    from .packed import build_packed_plan

    return build_packed_plan(rcsr, value_dtype=value_dtype)


def build_chunk_plan(a, *, value_dtype=np.float32,
                     pad_value: float = 0.0,
                     bucket_ks: Tuple[int, ...] = BUCKET_KS,
                     heavy_parts: int = HEAVY_PARTS,
                     sigma: int = CHUNK_SIGMA,
                     sort_rows: bool = True,
                     merge_duplicates: bool = True,
                     _price: Optional[str] = None) -> Optional[ChunkPlan]:
    """Build a chunked, span-bucketed plan (host-side, numpy).

    Returns None for empty matrices.  ``bucket_ks`` must be ascending;
    a slot farther than ``bucket_ks[-1]`` blocks from its window's base
    simply starts the next window, so nothing spills.
    ``merge_duplicates`` sums duplicate (row, col) entries at plan time —
    valid only under plus-times (callers building for another semiring
    must pass False; ``auto_plan`` does).  ``a`` may be the matrix's
    :class:`ChunkRows` of the same settings.
    """
    if sigma != CHUNK_SIGMA:
        raise ValueError(f"sigma must be {CHUNK_SIGMA} (the lane-perm "
                         f"kernel's reach); got {sigma}")
    if value_kind(value_dtype) == "f64":
        raise NotImplementedError("chunk plans hold no float64 values (the "
                                  "planner never builds one, as in the "
                                  "reference)")
    check_pad(value_dtype, pad_value)
    cr = ChunkRows.of(a, merge_duplicates, heavy_parts, sigma, sort_rows)
    if cr.empty:
        return None
    rows, cols_n = cr.shape
    nnz_orig = cr.nnz_orig
    R, P = 128, 8
    bucket_ks = tuple(sorted(int(k) for k in bucket_ks))
    if bucket_ks[-1] * R > 32768:
        raise ValueError("bucket_ks[-1] too large for int16 offsets")

    indptr, indices, data, heavy_mask_r, order, inv_pos = (
        cr.indptr, cr.indices, cr.data, cr.heavy_mask, cr.order, cr.inv_pos)
    nnz = int(indptr[-1])
    lens_r = np.diff(indptr)
    heavy_rows_np = cr.heavy_rows
    nheavy = int(heavy_rows_np.shape[0])
    nblk = order.shape[0] // R
    rows_pad = nblk * R
    perm_idx = (inv_pos - (np.arange(rows_pad) // sigma) * sigma)
    assert perm_idx.min() >= 0 and perm_idx.max() < sigma
    perm_idx = perm_idx.astype(np.int16).reshape(nblk, R)

    # --- light part: greedy windows over each block's slots, sorted by
    # (block, col), one window of every block a round ------------------
    light = _Windows(bucket_ks, keep=not _price)
    if _price != "heavy":
        l_src, l_blk, l_lane, l_cols = _light_slots(indptr, indices,
                                                    heavy_mask_r, inv_pos, R)
        l_starts = np.searchsorted(l_blk, np.arange(nblk + 1))
        # the 8th next slot of a lane (a row) is the row's entry 8 further
        at = np.empty(nnz, dtype=np.int64)
        at[l_src] = np.arange(l_src.shape[0])
        row_end = np.repeat(indptr[1:], lens_r)[l_src]
        nxt = np.full(l_src.shape[0], np.iinfo(np.int64).max,
                      dtype=np.int64)
        has = l_src + P < row_end
        nxt[has] = at[l_src[has] + P]
        next_cap = np.minimum.accumulate(nxt[::-1])[::-1]
        del at, row_end, nxt, has
        light.add(_greedy_windows(l_starts[:-1], l_starts[1:], l_cols,
                                  bucket_ks, P, lanes=l_lane,
                                  next_cap=next_cap, R=R))
        del next_cap

    # --- heavy part: sorted-subwindow tiles (SubwinPlan docstring) -----
    # Dense-enough stretches (realized W <= SUBWIN_MAX_W) take the
    # always-full subwin layout; sparser stretches fall back to the same
    # greedy window packer as the light blocks (their x-window bytes,
    # 8*W*512 per tile, would otherwise dwarf the data stream).
    h_slot_tile = h_slot_sub = h_slot_lane = h_src = None
    h_tseg = h_tw = None
    n_htiles = 0
    heavy = _Windows(bucket_ks, keep=not _price)
    if nheavy:
        hs, hi_of, dense_slot = cr.stretches()
        # sparse stretches -> greedy window packer, a heavy row a segment
        sp = np.flatnonzero(~dense_slot)
        s_src, s_hi = hs[sp], hi_of[sp]
        s_cnt = np.bincount(s_hi, minlength=nheavy)
        s_hi_lo = np.cumsum(s_cnt) - s_cnt
        heavy.add(_greedy_windows(s_hi_lo, s_hi_lo + s_cnt, indices[s_src],
                                  bucket_ks, P, R=R))
        # dense stretches -> subwin tiles
        h_src = hs[dense_slot]
        h_hi = hi_of[dense_slot]
        del hs, hi_of, dense_slot
        hlens = np.bincount(h_hi, minlength=nheavy)
        hp = h_hi
        rank = np.arange(h_src.shape[0], dtype=np.int64) - \
            np.repeat(np.cumsum(hlens) - hlens, hlens)
        h_tpr = _cdiv(hlens, P * R)                 # tiles per heavy row
        h_tile0 = np.concatenate(([0], np.cumsum(h_tpr)))
        h_slot_tile = h_tile0[hp] + rank // (P * R)
        h_slot_sub = (rank // R) % P
        h_slot_lane = rank % R
        n_htiles = int(h_tile0[-1])
        h_tseg = nblk + np.repeat(np.arange(nheavy, dtype=np.int64),
                                  h_tpr)
        if n_htiles:
            srow = h_slot_tile * P + h_slot_sub
            hcols = indices[h_src]
            base = np.zeros(n_htiles * P, dtype=np.int64)
            first = np.ones(h_src.shape[0], dtype=bool)
            first[1:] = srow[1:] != srow[:-1]
            base[srow[first]] = hcols[first] // R
            last = np.zeros_like(first)
            last[:-1] = first[1:]
            if last.shape[0]:
                last[-1] = True
            wmax = np.zeros(n_htiles * P, dtype=np.int64)
            wmax[srow[last]] = hcols[last] // R
            h_w_srow = np.maximum(wmax - base + 1, 1)
            h_tw = h_w_srow.reshape(n_htiles, P).max(axis=1)
            h_base = base.reshape(n_htiles, P)

    if _price:
        tiles = light.tiles + heavy.tiles
        if not tiles.any() and n_htiles == 0:
            return None
        kmax = np.maximum(light.kmax, heavy.kmax)
        # the heavy rows' share alone: each bucket's real tiles, unpadded
        # (the whole plan's padding follows from all of its tiles)
        buckets = tuple(
            TilesPrice(int(t) if _price == "heavy" else
                       _cdiv(int(t), _bucket_step(int(k), int(t))) *
                       _bucket_step(int(k), int(t)), int(k))
            for t, k in zip(tiles, kmax) if t)
        hbuckets, residue = (), None
        if n_htiles:
            wq = np.maximum(1, 1 << np.ceil(np.log2(h_tw)).astype(np.int64))
            Ws, T0s = np.unique(wq[wq <= 128], return_counts=True)
            hbuckets = tuple(
                TilesPrice(_cdiv(int(t), _subwin_step(int(w), int(t))) *
                           _subwin_step(int(w), int(t)), int(w))
                for w, t in zip(Ws, T0s))
            if (wq > 128).any():
                residue = _residue_plan(
                    h_src[np.flatnonzero(wq[h_slot_tile] > 128)], indptr,
                    indices, data, rows, cols_n, value_dtype)
        return ChunkPrice(buckets=buckets, hbuckets=hbuckets,
                          residue=residue)

    # every window's tiles and slots, light blocks first, then heavy rows
    tseg, twb, tk, slot_src, slot_tile, slot_sub, slot_lane = \
        [], [], [], [], [], [], []
    tile_base = 0
    for kind, wins in (("light", light), ("heavy", heavy)):
        seg, pos, take, nt, wb, k = wins.ordered()
        if seg.size == 0:
            continue
        t_first = tile_base + np.cumsum(nt) - nt
        tseg.append(np.repeat(seg if kind == "light" else nblk + seg, nt))
        twb.append(np.repeat(wb, nt))
        tk.append(np.repeat(k, nt))
        win = np.repeat(np.arange(seg.shape[0], dtype=np.int64), take)
        q = np.arange(win.shape[0], dtype=np.int64) - \
            np.repeat(np.cumsum(take) - take, take)
        if kind == "light":
            slot_src.append(l_src)
            rk = _rank_in_groups(win * R + l_lane)
            slot_tile.append(t_first[win] + rk // P)
            slot_sub.append(rk % P)
            slot_lane.append(l_lane)
        else:
            slot_src.append(s_src)
            slot_tile.append(t_first[win] + q // (P * R))
            slot_lane.append(q % R)
            slot_sub.append((q // R) % P)
        tile_base += int(nt.sum())

    if tile_base == 0 and n_htiles == 0:
        return None
    if tile_base:
        slot_src = np.concatenate(slot_src)
        slot_tile = np.concatenate(slot_tile)
        slot_sub = np.concatenate(slot_sub)
        slot_lane = np.concatenate(slot_lane)
        tseg = np.concatenate(tseg)
        twb = np.concatenate(twb)
        tk = np.concatenate(tk)
    else:
        slot_src = slot_tile = slot_sub = slot_lane = \
            np.zeros(0, dtype=np.int64)
        tseg = twb = tk = np.zeros(0, dtype=np.int64)

    # --- bucket tiles by realized K, emit one SellPlan per bucket ------
    nseg = nblk + nheavy
    row_map_np = np.concatenate([
        np.where(order < rows, order, rows),
        np.repeat(heavy_rows_np, R)]).astype(np.int32)

    tile_bucket = np.searchsorted(np.asarray(bucket_ks), tk, side="left")
    buckets = []
    realized_ks = []
    bucket_tiles = []
    total_slots = 0
    for bi in range(len(bucket_ks)):
        tids = np.flatnonzero(tile_bucket == bi)
        if tids.size == 0:
            continue
        # keep (segment, emission) order — nondecreasing tile_slice
        T0 = tids.size
        new_tid = np.full(tile_base, -1, dtype=np.int64)
        new_tid[tids] = np.arange(T0)
        K = int(tk[tids].max())

        step = _bucket_step(K, T0)
        T = _cdiv(T0, step) * step
        groups = step // TILES_PER_STEP

        ssel = np.flatnonzero(new_tid[slot_tile] >= 0)
        t_k = new_tid[slot_tile[ssel]]
        p_k = slot_sub[ssel]
        l_k = slot_lane[ssel]
        s_k = slot_src[ssel]

        vals = np.full((T, P, R), pad_value, dtype=build_dtype(value_dtype))
        colsg = np.zeros((T, P, R), dtype=np.int64)
        live = np.zeros((T, P, R), dtype=bool)
        vals[t_k, p_k, l_k] = host_values(data[s_k], value_dtype)
        colsg[t_k, p_k, l_k] = indices[s_k]
        live[t_k, p_k, l_k] = True

        tile_slice = np.full(T, nseg - 1, dtype=np.int32)
        tile_slice[:T0] = tseg[tids].astype(np.int32)
        wb = np.zeros(T, dtype=np.int64)
        wb[:T0] = twb[tids]

        off = colsg - (wb * R)[:, None, None]
        off = np.where(live, off, 0)
        assert off.min() >= 0 and off.max() < K * R
        cols_win = off.astype(np.int16)
        cols_glob = np.where(live, colsg, 0).astype(np.int32)
        kept = int(live.sum())

        st = PlanStats(
            nnz=kept, num_tiles=T, num_slices=nseg,
            num_subrows=T0, num_splits=0, num_stripes=1,
            padded_slots=T * P * R - kept,
            fill=float(kept) / float(T * P * R),
            window_blocks=K, max_window_base=int(wb.max()),
            groups_per_step=groups, pad_value=float(pad_value),
            group_tiles=1, uniform_parts=0, group_fold=False,
            group_slice_identity=False, double=False, window_grain=128)
        window_rows = compute_window_rows(wb, K, cols_n, 128)
        buckets.append(SellPlan(
            vals=finish_values(vals, value_dtype), cols=cols_glob,
            cols_win=cols_win,
            tile_slice=tile_slice, window_base=wb.astype(np.int32),
            row_map=row_map_np, window_rows=window_rows,
            shape=(rows, cols_n), lane_rows=R, positions=P,
            identity_map=False, stats=st))
        realized_ks.append(K)
        bucket_tiles.append(T)
        total_slots += T * P * R

    # --- emit heavy SubwinPlans, bucketed by pow2 W --------------------
    hbuckets = []
    res_src = []
    if nheavy and n_htiles:
        wq = np.maximum(1, 1 << np.ceil(
            np.log2(h_tw)).astype(np.int64))       # pow2 quantized W
        if (wq > 128).any():
            # a sublane row spanning >128 blocks would overflow the
            # int16 offsets: such ultra-sparse heavy stretches go to the
            # COO/packed residue instead (rare by construction)
            bad = np.flatnonzero(wq[h_slot_tile] > 128)
            res_src.append(h_src[bad])
        for W in sorted(set(int(w) for w in wq if w <= 128)):
            tids = np.flatnonzero(wq == W)
            T0 = tids.size
            new_tid = np.full(n_htiles, -1, dtype=np.int64)
            new_tid[tids] = np.arange(T0)
            step = _subwin_step(W, T0)
            T = _cdiv(T0, step) * step
            ssel = np.flatnonzero(new_tid[h_slot_tile] >= 0)
            t_k = new_tid[h_slot_tile[ssel]]
            vals = np.full((T, P, R), pad_value,
                           dtype=build_dtype(value_dtype))
            offs = np.zeros((T, P, R), dtype=np.int64)
            srow_sel = h_slot_sub[ssel]
            vals[t_k, srow_sel, h_slot_lane[ssel]] = \
                host_values(data[h_src[ssel]], value_dtype)
            offs[t_k, srow_sel, h_slot_lane[ssel]] = \
                indices[h_src[ssel]] - \
                h_base[h_slot_tile[ssel], srow_sel] * R
            assert offs.min() >= 0 and offs.max() < W * R
            bases = np.zeros((T, P), dtype=np.int64)
            bases[:T0] = h_base[tids]
            tile_seg = np.full(T, nseg - 1, dtype=np.int32)
            tile_seg[:T0] = h_tseg[tids].astype(np.int32)
            hbuckets.append(SubwinPlan(
                vals=finish_values(vals, value_dtype),
                cols_win=offs.astype(np.int16),
                bases=bases.astype(np.int32), tile_seg=tile_seg,
                shape=(rows, cols_n), window_blocks=W,
                groups_per_step=step // TILES_PER_STEP))
            realized_ks.append(W)
            bucket_tiles.append(T)
            total_slots += T * P * R

    residue = None
    res_nnz = 0
    if res_src:
        rsel = np.concatenate(res_src)
        res_nnz = int(rsel.shape[0])
        residue = _residue_plan(rsel, indptr, indices, data, rows, cols_n,
                                value_dtype)

    stats = ChunkStats(
        nnz=nnz_orig, num_tiles=sum(bucket_tiles),
        fill=float(nnz - res_nnz) / float(max(1, total_slots)),
        bucket_ks=tuple(realized_ks), bucket_tiles=tuple(bucket_tiles),
        residue_nnz=res_nnz, num_blocks=nblk, num_heavy=nheavy)
    return ChunkPlan(buckets=tuple(buckets), hbuckets=tuple(hbuckets),
                     residue=residue, perm_idx=perm_idx,
                     heavy_rows=heavy_rows_np.astype(np.int32),
                     shape=(rows, cols_n), stats=stats)
