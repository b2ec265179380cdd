"""Packed plans: two streamed passes that serve any matrix (counterpart
of ``spmv_vector_cache_tpu/formats/packed.py``).

The plan is built by the JAX package's host-side numpy code, carried over
unchanged (float32 only) so that both packages build byte-equal plans.

* **Pass A (scan)** -- nonzeros sort by (column chunk, row, col) and pack
  at one slot per nonzero.  Each step of ``step_tiles`` (8, 128) tiles
  reads x from one chunk of ``chunk_blocks`` 128-column blocks
  (``cstep``); the kernel multiplies and runs a segmented inclusive scan
  along each 128-slot row, so every piece's sum lands at its end slot.
* **Pass B (extract)** -- a row's in-chunk run of slots splits at
  128-slot boundaries into pieces; the run's final piece is read out of
  the scan at its end slot (``esrc``) and summed into the row's y
  window of 8192 rows.  Visits are window-major (``wstep``
  nondecreasing).
* The nonzeros of the non-final pieces of a run are duplicated into a
  small **overflow** COO list, summed into y outside the kernels.

The per-nonzero cost depends on ``chunk_blocks`` alone -- no column
locality or row regularity is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from .plan import (_as_csr, _cdiv, _ensure_sorted, build_dtype,
                   finish_values, host_values, value_kind)
from .tables import ExtractTables, placed_extract_tables, table

Array = Any

#: default x-window width in 128-lane blocks (4096 columns).  The select
#: tree costs ~3 vector ops per block per 1024 nonzeros, so halving this
#: nearly halves the pass-A gather cost at the price of more pieces
#: (more boundary splits); autotune sweeps it (cf. the reference's
#: ocmDepth sweep, ``gen-newcache.sh:3-11``).
PACKED_CHUNK_BLOCKS = 32

#: y window height in 128-lane blocks (8192 rows); fixes pass B's
#: resident output block at (64, 128) f32 = 32 KB of VMEM and matches
#: the extraction-index stream to the scanned-slot stream 1:1
PACKED_WINDOW_BLOCKS = 64

#: (8, 128)-slot tiles per pass-A grid step (= slots per x-window visit)
#: and per pass-B S-block visit
PACKED_STEP_TILES = 8


@dataclasses.dataclass(frozen=True)
class PackedStats:
    nnz: int
    num_tiles: int            # pass-A (8, 128)-slot tiles
    num_steps_a: int
    num_steps_b: int          # pass-B visits (cells x spanned S blocks)
    num_windows: int          # row windows (= ceil(rows / 8192))
    num_chunks: int           # column chunks with at least one nonzero
    num_pieces: int           # primary pieces (extracted row sums)
    overflow_nnz: int         # boundary-split leftovers (host epilogue)
    chunk_blocks: int
    step_tiles: int
    fill: float               # nnz / (num_tiles * 1024)

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """Two-pass packed layout (see module docstring).

    Pass A: ``vals``/``cols`` (T, 8, 128) -- slot (t, s, l) holds one
    nonzero; ``cols`` int16 carry the chunk-local column in bits 0-13
    and the piece-start flag in bit 14; ``cstep`` (steps_a,) chunk per
    step.  Pass B: per visit i, ``sblock[i]`` selects the scan block,
    ``wstep[i]`` the y window, ``wfirst[i]`` flags its first visit;
    ``esrc`` (steps_b, 64, 128) int16 holds, at output element (o, j),
    the block-local end slot of row (window*8192 + o*128 + j)'s piece
    (-1 = none).  ``window_mask`` marks the windows visited.  ``ov_*``:
    overflow COO.  Placement builds ``tables``, what kernel F reads in
    place of ``esrc``."""

    vals: Array               # (T, 8, 128) value dtype
    cols: Array               # (T, 8, 128) int16 local col | start << 14
    cstep: Array              # (steps_a,) int32
    sblock: Array             # (steps_b,) int32
    wstep: Array              # (steps_b,) int32
    wfirst: Array             # (steps_b,) int32 (0/1)
    esrc: Array               # (steps_b, 64, 128) int16
    window_mask: Array        # (num_windows,) value dtype (0.0/1.0)
    ov_vals: Array            # (novf,) value dtype
    ov_cols: Array            # (novf,) int32
    ov_rows: Array            # (novf,) int32
    shape: Tuple[int, int]
    stats: PackedStats
    tables: Optional[ExtractTables] = table(placed_extract_tables)


#: entries a block of the pass-A sort (its keys, sources and gathers
#: held in cache)
_SORT_BLOCK = 1 << 21


def _key_dtype(n: int):
    """The narrowest unsigned type that holds keys below ``n``: numpy's
    stable sort of a 1- or 2-byte key is a radix sort."""
    return np.uint8 if n <= 1 << 8 else np.uint16 if n <= 1 << 16 \
        else np.int64


def build_packed_plan(a, *, chunk_blocks: int = PACKED_CHUNK_BLOCKS,
                      step_tiles: int = PACKED_STEP_TILES,
                      value_dtype=np.float32) -> PackedPlan:
    """Lay out ``a`` for the packed kernels.  Always feasible."""
    if not 1 <= chunk_blocks <= 128:
        raise ValueError("chunk_blocks must be in [1, 128] (int16 local "
                         "columns + piece-start flag in bit 14)")
    if step_tiles * 1024 > 32768:
        raise ValueError("step_tiles > 32 would overflow int16 esrc")
    if value_kind(value_dtype) == "f64":
        raise NotImplementedError("packed plans hold no float64 values (the "
                                  "planner never builds one, as in the "
                                  "reference)")
    vdt = build_dtype(value_dtype)
    csr = _ensure_sorted(_as_csr(a))
    rows, ncols = csr.shape
    RW = PACKED_WINDOW_BLOCKS * 128
    C = chunk_blocks * 128
    sps = step_tiles * 8 * 128              # slots per step / S block
    nwin = max(1, _cdiv(rows, RW))

    indices = np.asarray(csr.indices) & 0x3FFFFFFF
    data = np.asarray(csr.data)
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    nnz = int(indices.shape[0])

    if nnz == 0:
        return PackedPlan(
            vals=finish_values(np.zeros((step_tiles, 8, 128), vdt),
                               value_dtype),
            cols=np.zeros((step_tiles, 8, 128), np.int16),
            cstep=np.zeros(1, np.int32), sblock=np.zeros(1, np.int32),
            wstep=np.zeros(1, np.int32), wfirst=np.ones(1, np.int32),
            esrc=np.full((1, 64, 128), -1, np.int16),
            window_mask=finish_values(np.zeros(nwin, vdt), value_dtype),
            ov_vals=finish_values(np.zeros(0, vdt), value_dtype),
            ov_cols=np.zeros(0, np.int32), ov_rows=np.zeros(0, np.int32),
            shape=(rows, ncols),
            stats=PackedStats(nnz=0, num_tiles=step_tiles, num_steps_a=1,
                              num_steps_b=1, num_windows=nwin,
                              num_chunks=0, num_pieces=0, overflow_nnz=0,
                              chunk_blocks=chunk_blocks,
                              step_tiles=step_tiles, fill=0.0))

    # ---- pass-A layout: (chunk, row, col) order, chunks step-padded ----
    lens = np.diff(indptr)
    c_of = indices // C
    nchunks = int(c_of.max()) + 1
    counts = np.bincount(c_of, minlength=nchunks)
    starts = np.concatenate(([0], np.cumsum(counts)))
    # (chunk, row, col): a stable sort by chunk, made a block of rows at
    # a time (each block's sort and gathers stay in cache) and laid out
    # block after block within each chunk
    rows_o = np.empty(nnz, np.int32)
    cols_o = np.empty(nnz, np.int16)
    vals_o = np.empty(nnz, data.dtype)
    key = _key_dtype(nchunks)
    at = starts[:-1].copy()
    bounds = np.unique(np.concatenate((
        [0], np.searchsorted(indptr, np.arange(0, nnz, _SORT_BLOCK),
                             side="right") - 1, [rows])))
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        if e0 == e1:
            continue
        order = np.argsort(c_of[e0:e1].astype(key), kind="stable")
        n_c = np.bincount(c_of[e0:e1], minlength=nchunks)
        dest = np.repeat(at - (np.cumsum(n_c) - n_c), n_c) + \
            np.arange(e1 - e0, dtype=np.int64)
        rows_o[dest] = np.repeat(np.arange(r0, r1, dtype=np.int32),
                                 lens[r0:r1])[order]
        cols_o[dest] = (indices[e0:e1][order] % C).astype(np.int16)
        vals_o[dest] = data[e0:e1][order]
        at += n_c
    del c_of
    vals_o = host_values(vals_o, value_dtype)
    chunks_o = np.repeat(np.arange(nchunks, dtype=np.int64), counts)

    padded = _cdiv(counts, sps) * sps
    offs = np.concatenate(([0], np.cumsum(padded)))
    total_slots = int(offs[-1])
    sdt = np.int32 if total_slots < 1 << 31 else np.int64
    slot = np.arange(nnz, dtype=sdt) + \
        np.repeat((offs[:-1] - starts[:-1]).astype(sdt), counts)
    T = total_slots // 1024
    steps_a = total_slots // sps

    # each chunk's entries in order from its step-padded start
    vals = np.zeros(total_slots, vdt)
    cols16 = np.zeros(total_slots, np.int16)
    for c in np.flatnonzero(counts):
        at, n = int(offs[c]), int(counts[c])
        vals[at:at + n] = vals_o[starts[c]:starts[c] + n]
        cols16[at:at + n] = cols_o[starts[c]:starts[c] + n]
    steps_per_chunk = (padded // sps).astype(np.int64)
    cstep = np.repeat(np.arange(nchunks, dtype=np.int32), steps_per_chunk)

    # ---- pieces ----
    run_end = np.ones(nnz, dtype=bool)
    run_end[:-1] = ((rows_o[1:] != rows_o[:-1]) |
                    (chunks_o[1:] != chunks_o[:-1]))
    is_end = run_end | (slot % 128 == 127)
    ends = slot[is_end]                       # strictly ascending
    p_primary = run_end[is_end]
    # piece-start flags (bit 14 of cols): the scan segment boundaries
    run_start = np.empty(nnz, dtype=bool)
    run_start[0] = True
    run_start[1:] = run_end[:-1]
    is_start = run_start | (slot % 128 == 0)
    cols16[slot[is_start]] |= np.int16(1 << 14)

    pid = np.cumsum(is_end) - is_end          # piece index per nonzero
    ov_mask = (~p_primary)[pid]
    ov_vals = vals_o[ov_mask]
    ov_rows = rows_o[ov_mask].astype(np.int32)
    ov_cols = (cols_o[ov_mask].astype(np.int64)
               + chunks_o[ov_mask] * C).astype(np.int32)

    pe = ends[p_primary]                      # ascending within chunk
    pr = rows_o[is_end][p_primary]
    pw = (pr // RW).astype(np.int64)
    pc = chunks_o[is_end][p_primary]
    npieces = int(pe.shape[0])

    # ---- pass-B visit list: (window, chunk, S block), window-major ----
    # pieces of one (w, c) cell are contiguous; their S blocks form a
    # consecutive run.  Dedup (w, c-ordinal, block) triples into visits.
    # The pieces come in (c, row) order, so each cell is one run of them:
    # the runs taken window-major give the (w, c, block) order
    cell = pc * nwin + pw
    c0 = np.flatnonzero(np.concatenate(([True], cell[1:] != cell[:-1])))
    c_len = np.diff(np.append(c0, npieces))
    corder = np.argsort(cell[c0] % nwin * nchunks + cell[c0] // nwin)
    c0, c_len = c0[corder], c_len[corder]
    vorder = np.repeat(c0 - np.cumsum(c_len) + c_len, c_len) + \
        np.arange(npieces, dtype=np.int64)
    pe, pr, pw, pc = pe[vorder], pr[vorder], pw[vorder], pc[vorder]
    vk_sorted = (pw * nchunks + pc) * steps_a + pe // sps
    first = np.ones(npieces, dtype=bool)
    first[1:] = vk_sorted[1:] != vk_sorted[:-1]
    steps_b = int(first.sum())
    sblock = (vk_sorted[first] % steps_a).astype(np.int32)
    wstep = (vk_sorted[first] // (steps_a * nchunks)).astype(np.int32)
    wfirst = np.ones(steps_b, np.int32)
    wfirst[1:] = (wstep[1:] != wstep[:-1]).astype(np.int32)

    esrc = np.full((steps_b, 64, 128), -1, np.int16)
    # (visit, o, j) of row window*8192 + o*128 + j, as one flat index,
    # written visit by visit
    vstep = np.cumsum(first) - 1
    esrc.reshape(-1)[vstep * RW + pr % RW] = \
        (pe - sblock[vstep].astype(np.int64) * sps).astype(np.int16)

    wmask = np.zeros(nwin, vdt)
    wmask[np.unique(wstep)] = 1

    return PackedPlan(
        vals=finish_values(vals.reshape(T, 8, 128), value_dtype),
        cols=cols16.reshape(T, 8, 128),
        cstep=cstep, sblock=sblock, wstep=wstep, wfirst=wfirst,
        esrc=esrc, window_mask=finish_values(wmask, value_dtype),
        ov_vals=finish_values(ov_vals, value_dtype), ov_cols=ov_cols,
        ov_rows=ov_rows, shape=(rows, ncols),
        stats=PackedStats(
            nnz=nnz, num_tiles=T, num_steps_a=steps_a,
            num_steps_b=steps_b, num_windows=nwin,
            num_chunks=int((counts > 0).sum()), num_pieces=npieces,
            overflow_nnz=int(ov_mask.sum()),
            chunk_blocks=chunk_blocks, step_tiles=step_tiles,
            fill=nnz / max(1, total_slots)))
