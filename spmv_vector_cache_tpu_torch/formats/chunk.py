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

Array = Any

#: aligned row-sort window; the lane-unpermute kernel's one-block reach
#: (ops/lane_perm.py) requires exactly this value
CHUNK_SIGMA = 1024

#: default span buckets, as window block counts K
BUCKET_KS = (4, 16, 64)

#: rows with more than heavy_parts*8 nonzeros take the heavy
#: (row-packed) layout
HEAVY_PARTS = 32

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
    :class:`~.packed.PackedPlan`.
    """

    buckets: Tuple[SellPlan, ...]
    hbuckets: Tuple[SubwinPlan, ...]
    residue: Any                     # None, CooTail or PackedPlan
    perm_idx: Array                  # (num_blocks, 128) int16 in [0,1024)
    heavy_rows: Array                # (num_heavy,) int32, ascending
    shape: Tuple[int, int]
    stats: ChunkStats

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


def _pack_windows(cols: np.ndarray, lanes: np.ndarray,
                  bucket_ks: Tuple[int, ...], lane_cap: int, R: int = 128):
    """Greedy window partition of one segment's column-sorted slots.

    At each unprocessed column, price every window size K (slots
    covered / (tiles needed * (A + B*K))) and take the best.  Returns
    per-slot (tile ordinal within segment, sublane) plus per-tile
    (window base block, K).  ``lanes`` fixes each slot's lane (light
    blocks); slots of a full lane spill to a same-window companion
    tile.  lane_cap = P for light layouts; heavy rows pass lanes=None
    and fill lanes round-robin.
    """
    n = cols.shape[0]
    slot_tile = np.empty(n, dtype=np.int64)
    slot_sub = np.empty(n, dtype=np.int64)
    slot_lane = np.empty(n, dtype=np.int64) if lanes is None else lanes
    tile_wb = []
    tile_k = []
    pos = 0
    ntiles = 0
    while pos < n:
        w0 = (int(cols[pos]) // R) * R
        best = None
        for K in bucket_ks:
            cnt = int(np.searchsorted(cols, w0 + K * R, side="left")) - pos
            if lanes is None:
                tiles_needed = _cdiv(cnt, lane_cap * R)
                take = min(cnt, lane_cap * R)
            else:
                lc = np.bincount(lanes[pos:pos + cnt], minlength=R)
                tiles_needed = max(1, _cdiv(int(lc.max()), lane_cap))
                take = cnt
            eff = cnt / (tiles_needed * (_COST_A + _COST_B * K))
            cand = (eff, K, take, tiles_needed)
            if best is None or cand[0] > best[0]:
                best = cand
        _, K, take, tiles_needed = best
        sl = slice(pos, pos + take)
        if lanes is None:
            q = np.arange(take, dtype=np.int64)
            slot_tile[sl] = ntiles + q // (lane_cap * R)
            slot_lane[sl] = q % R
            slot_sub[sl] = (q // R) % lane_cap
            nt = _cdiv(take, lane_cap * R)
        else:
            ln = lanes[sl]
            order = np.argsort(ln, kind="stable")
            lc = np.bincount(ln, minlength=R)
            starts = np.concatenate(([0], np.cumsum(lc)))[:-1]
            rank = np.empty(take, dtype=np.int64)
            rank[order] = np.arange(take, dtype=np.int64) - starts[ln[order]]
            slot_tile[sl] = ntiles + rank // lane_cap
            slot_sub[sl] = rank % lane_cap
            nt = max(1, _cdiv(int(lc.max(initial=0)), lane_cap))
        kreal = _cdiv(int(cols[pos + take - 1]) + 1 - w0, R) if take else 1
        tile_wb.extend([w0 // R] * nt)
        tile_k.extend([max(1, kreal)] * nt)
        ntiles += nt
        pos += take
    return (slot_tile, slot_sub, slot_lane,
            np.asarray(tile_wb, dtype=np.int64),
            np.asarray(tile_k, dtype=np.int64))


def build_chunk_plan(a, *, value_dtype=np.float32,
                     pad_value: float = 0.0,
                     bucket_ks: Tuple[int, ...] = BUCKET_KS,
                     heavy_parts: int = HEAVY_PARTS,
                     sigma: int = CHUNK_SIGMA,
                     sort_rows: bool = True,
                     merge_duplicates: bool = True) -> Optional[ChunkPlan]:
    """Build a chunked, span-bucketed plan (host-side, numpy).

    Returns None for empty matrices.  ``bucket_ks`` must be ascending;
    a slot farther than ``bucket_ks[-1]`` blocks from its window's base
    simply starts the next window, so nothing spills.
    ``merge_duplicates`` sums duplicate (row, col) entries at plan time —
    valid only under plus-times (callers building for another semiring
    must pass False; ``auto_plan`` does).
    """
    if sigma != CHUNK_SIGMA:
        raise ValueError(f"sigma must be {CHUNK_SIGMA} (the lane-perm "
                         f"kernel's reach); got {sigma}")
    if value_kind(value_dtype) == "f64":
        raise NotImplementedError("chunk plans hold no float64 values (the "
                                  "planner never builds one, as in the "
                                  "reference)")
    check_pad(value_dtype, pad_value)
    csr = _as_csr(a)
    rows, cols_n = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    data = np.asarray(csr.data)
    nnz_orig = int(indptr[-1])
    if nnz_orig == 0 or rows == 0:
        return None
    R, P = 128, 8
    bucket_ks = tuple(sorted(int(k) for k in bucket_ks))
    if bucket_ks[-1] * R > 32768:
        raise ValueError("bucket_ks[-1] too large for int16 offsets")

    if merge_duplicates and nnz_orig > 1:
        # cols are sorted within rows (_as_csr), so duplicates are
        # adjacent; one slot (and one stream byte) per distinct entry
        nz_row = np.repeat(np.arange(rows, dtype=np.int64),
                           np.diff(indptr))
        first = np.ones(nnz_orig, dtype=bool)
        first[1:] = (nz_row[1:] != nz_row[:-1]) | \
                    (indices[1:] != indices[:-1])
        if not first.all():
            gid = np.cumsum(first) - 1
            data = np.bincount(gid, weights=data).astype(data.dtype)
            indices = indices[first]
            new_counts = np.bincount(nz_row[first], minlength=rows)
            indptr = np.concatenate(
                ([0], np.cumsum(new_counts))).astype(np.int64)
    nnz = int(indptr[-1])

    lens_r = np.diff(indptr)
    heavy_mask_r = lens_r > heavy_parts * P
    heavy_rows_np = np.flatnonzero(heavy_mask_r).astype(np.int64)
    nheavy = int(heavy_rows_np.shape[0])

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
    perm_idx = (inv_pos - (np.arange(rows_pad) // sigma) * sigma)
    assert perm_idx.min() >= 0 and perm_idx.max() < sigma
    perm_idx = perm_idx.astype(np.int16).reshape(nblk, R)

    # per-nnz (segment, lane, col, src) for light slots, sorted by
    # (block, col); heavy slots keep their row-native (col-sorted) order
    nz_row = np.repeat(np.arange(rows, dtype=np.int64), lens_r)
    nz_pos = inv_pos[nz_row]                    # sorted position of row
    light_nz = ~heavy_mask_r[nz_row]
    l_src = np.flatnonzero(light_nz)
    l_blk = nz_pos[l_src] // R
    l_lane = nz_pos[l_src] % R
    l_cols = indices[l_src]
    lo = np.lexsort((l_cols, l_blk))
    l_src, l_blk, l_lane, l_cols = l_src[lo], l_blk[lo], l_lane[lo], \
        l_cols[lo]
    l_starts = np.searchsorted(l_blk, np.arange(nblk + 1))

    # --- greedy packing ------------------------------------------------
    # per-slot records across all segments
    all_src = []
    all_tile = []       # global tile ordinal (per segment offsets fixed up)
    all_sub = []
    all_lane = []
    seg_of_tile = []    # per-tile unified segment id
    wb_of_tile = []
    k_of_tile = []
    tile_base = 0
    for b in range(nblk):
        s0, s1 = l_starts[b], l_starts[b + 1]
        if s0 == s1:
            continue
        st_, sb_, ln_, wb_, kk_ = _pack_windows(
            l_cols[s0:s1], l_lane[s0:s1], bucket_ks, P)
        all_src.append(l_src[s0:s1])
        all_tile.append(st_ + tile_base)
        all_sub.append(sb_)
        all_lane.append(ln_)
        seg_of_tile.append(np.full(wb_.shape[0], b, dtype=np.int64))
        wb_of_tile.append(wb_)
        k_of_tile.append(kk_)
        tile_base += wb_.shape[0]
    # --- heavy part: sorted-subwindow tiles (SubwinPlan docstring) -----
    # Dense-enough stretches (realized W <= SUBWIN_MAX_W) take the
    # always-full subwin layout; sparser stretches fall back to the same
    # greedy window packer as the light blocks (their x-window bytes,
    # 8*W*512 per tile, would otherwise dwarf the data stream).
    SUBWIN_MAX_W = 8
    h_slot_tile = h_slot_sub = h_slot_lane = h_src = None
    h_tseg = h_tw = None
    n_htiles = 0
    if nheavy:
        hs_parts = []
        for hi, hr in enumerate(heavy_rows_np):
            s0, s1 = int(indptr[hr]), int(indptr[hr + 1])
            src = np.arange(s0, s1, dtype=np.int64)
            cols_r = indices[s0:s1]
            n_r = src.shape[0]
            rank = np.arange(n_r, dtype=np.int64)
            tile_r = rank // (P * R)
            srow_r = rank // R
            # per-sublane-row realized W
            fr = np.zeros(n_r, dtype=bool)
            fr[::R] = True
            la = np.zeros_like(fr)
            la[R - 1::R] = True
            la[-1] = True
            w_sr = cols_r[la] // R - cols_r[fr] // R + 1
            w_tile = np.zeros(tile_r[-1] + 1, dtype=np.int64)
            np.maximum.at(w_tile, srow_r[fr] // P, w_sr)
            dense_slot = w_tile[tile_r] <= SUBWIN_MAX_W
            hs_parts.append((hi, src, cols_r, dense_slot))
        # sparse stretches -> greedy window packer (same lists as light)
        for hi, src, cols_r, dense_slot in hs_parts:
            sp = np.flatnonzero(~dense_slot)
            if sp.size == 0:
                continue
            st_, sb_, ln_, wb_, kk_ = _pack_windows(
                cols_r[sp], None, bucket_ks, P)
            all_src.append(src[sp])
            all_tile.append(st_ + tile_base)
            all_sub.append(sb_)
            all_lane.append(ln_)
            seg_of_tile.append(np.full(wb_.shape[0], nblk + hi,
                                       dtype=np.int64))
            wb_of_tile.append(wb_)
            k_of_tile.append(kk_)
            tile_base += wb_.shape[0]
        # dense stretches -> subwin tiles
        h_src = np.concatenate(
            [src[dense_slot] for _, src, _, dense_slot in hs_parts]) \
            if hs_parts else np.zeros(0, np.int64)
        h_hi = np.concatenate(
            [np.full(int(d.sum()), hi, dtype=np.int64)
             for hi, _, _, d in hs_parts])
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

    if tile_base == 0 and n_htiles == 0:
        return None
    if tile_base:
        slot_src = np.concatenate(all_src)
        slot_tile = np.concatenate(all_tile)
        slot_sub = np.concatenate(all_sub)
        slot_lane = np.concatenate(all_lane)
        tseg = np.concatenate(seg_of_tile)
        twb = np.concatenate(wb_of_tile)
        tk = np.concatenate(k_of_tile)
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

        step = max(TILES_PER_STEP,
                   min(512, (3 << 20) // (4096 + K * 512) // 8 * 8,
                       _cdiv(T0, TILES_PER_STEP) * TILES_PER_STEP))
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
            step = max(TILES_PER_STEP,
                       min(256, (3 << 20) // (6144 + W * 4096)
                           // 8 * 8,
                           _cdiv(T0, TILES_PER_STEP) * TILES_PER_STEP))
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
        from .cached import COO_TAIL_MAX, coo_tail_from_csr
        from .containers import COO
        from .convert import coo_to_csr

        rsel = np.concatenate(res_src)
        res_nnz = int(rsel.shape[0])
        nzr = np.repeat(np.arange(rows, dtype=np.int64),
                        np.diff(indptr))
        rcsr = coo_to_csr(COO(data=data[rsel],
                              row=nzr[rsel].astype(np.int32),
                              col=indices[rsel].astype(np.int32),
                              shape=(rows, cols_n)))
        if res_nnz <= COO_TAIL_MAX:
            residue = coo_tail_from_csr(rcsr, value_dtype=value_dtype)
        else:
            from .packed import build_packed_plan

            residue = build_packed_plan(rcsr, value_dtype=value_dtype)

    stats = ChunkStats(
        nnz=nnz_orig, num_tiles=sum(bucket_tiles),
        fill=float(nnz - res_nnz) / float(max(1, total_slots)),
        bucket_ks=tuple(realized_ks), bucket_tiles=tuple(bucket_tiles),
        residue_nnz=res_nnz, num_blocks=nblk, num_heavy=nheavy)
    return ChunkPlan(buckets=tuple(buckets), hbuckets=tuple(hbuckets),
                     residue=residue, perm_idx=perm_idx,
                     heavy_rows=heavy_rows_np.astype(np.int32),
                     shape=(rows, cols_n), stats=stats)
