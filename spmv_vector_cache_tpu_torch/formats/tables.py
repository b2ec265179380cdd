"""The tables a placed plan carries for its kernels: which CTA sums what.

Each is a layout derived from a plan's arrays, built once by placement
(``formats.plan.place``, ``parallel.place_on_mesh``) into a field of the
plan (:func:`table`); a host plan, or one whose arrays became tensors
some other way (``map_arrays``), has None there, and its apply raises.
A SellPlan's ``work`` (:func:`tile_runs`) is the run of tiles of each
slice that kernels G, H and L (``csrc/spmv_sell_global.cu``,
``csrc/spmm_sell_window.cu``) sum themselves; a ChunkPlan's ``heavy``
(:func:`heavy_tiles`) is kernel D's slab of heavy subwindow tiles with
its own work list, and its ``light`` (:func:`light_records`) the light
route's list of real slots by lane row; a PackedPlan's ``tables``
(:func:`extract_tables`) is kernel F's list by y row, compacted from the
plan's dense extraction index.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def table(build=None):
    """A plan field for a table that placement fills with
    ``build(placed_plan)`` (``build`` None: a placement of its own fills
    it, as ``parallel.place_on_mesh`` does a sharded plan's); None on a
    host plan."""
    return dataclasses.field(default=None, repr=False,
                             metadata={"table": build})


def table_names(plan) -> tuple:
    """The names of ``plan``'s table fields."""
    return tuple(f.name for f in dataclasses.fields(plan)
                 if "table" in f.metadata)


def with_tables(plan):
    """``plan`` (placed) with every table field that names a build
    function filled from it."""
    built = {f.name: f.metadata["table"](plan)
             for f in dataclasses.fields(plan) if f.metadata.get("table")}
    return dataclasses.replace(plan, **built) if built else plan


def placed(table, what: str):
    """``table``, a placed plan's, or the ``ValueError`` that says
    ``what`` is built by placement."""
    if table is None:
        raise ValueError(f"{what} is built when the plan is placed: place "
                         f"it with formats.plan.place "
                         f"(parallel.place_on_mesh for a sharded plan)")
    return table


def _host(t) -> np.ndarray:
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)


def _bits(t: torch.Tensor) -> np.ndarray:
    """The bits of a CPU tensor of 1-, 2-, 4- or 8-byte elements, as
    signed integers of that width (for comparing values bit for bit)."""
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(width[t.element_size()]).numpy()


# ---------------------------------------------------------------------------
# kernels G, H and L: a SellPlan's work list
# ---------------------------------------------------------------------------

#: most tiles one record sums; a longer slice is split over several
#: records that combine atomically into a preset output.  Untuned: no
#: measured plan has a slice this long (PERF.md)
RUN_CAP = 32
#: consecutive short slices one record takes, up to this many tiles in
#: all (kernel H at 2, 4, 8 and 16 on the H100: 4 and 8 tie on the
#: shuffled band, 4 is the fastest on the Hybrid rest; PERF.md)
RUN_PACK = 4
#: and at most this many slices, empty ones included (an empty slice is
#: only written as the semiring's init); untuned: no measured plan has
#: empty slices, and build_sell_plan gives every slice a tile
RUN_SLICES = 16
#: a run record's bit for a piece of a split slice (kAtomic in the sources)
RUN_ATOMIC = 1 << 30


def tile_runs(tile_slice, num_slices: int) -> np.ndarray:
    """The work list: one (t0, t1, s0, s1) int32 record, which sums tiles
    [t0, t1) and writes slices [s0, s1) (``s1 | RUN_ATOMIC`` for one
    piece of a slice of more than ``RUN_CAP`` tiles, split evenly).
    Slice s owns tiles [base[s], base[s+1]), with ``base`` the
    cumulative ``bincount`` of the nondecreasing ``tile_slice``
    (``build_sell_plan``'s ``tile_base``); every slice is written."""
    ts = _host(tile_slice).astype(np.int64)
    if ts.size and (np.any(np.diff(ts) < 0) or ts[0] < 0 or
                    ts[-1] >= num_slices):
        raise ValueError("tile_slice must be nondecreasing in "
                         f"[0, {num_slices})")
    counts = np.bincount(ts, minlength=num_slices)
    base = np.concatenate(([0], np.cumsum(counts)))
    recs = []
    s = 0
    while s < num_slices:
        n = int(counts[s])
        if n > RUN_CAP:
            pieces = -(-n // RUN_CAP)
            edges = base[s] + n * np.arange(pieces + 1) // pieces
            recs += [(a, e, s, (s + 1) | RUN_ATOMIC)
                     for a, e in zip(edges[:-1], edges[1:])]
            s += 1
            continue
        e, tiles = s + 1, n
        while e < num_slices and e - s < RUN_SLICES and \
                tiles + counts[e] <= RUN_PACK:
            tiles += int(counts[e])
            e += 1
        recs.append((base[s], base[e], s, e))
        s = e
    return np.asarray(recs, dtype=np.int32).reshape(-1, 4)


@dataclasses.dataclass(frozen=True)
class WorkList:
    """A work list on its plan's device and what a launch sizes by it."""

    runs: torch.Tensor        # (records, 4) int32
    split: bool               # a record holds one piece of a split slice
    max_tiles: int            # most tiles of one record
    max_slices: int           # most slices one record writes


def work_list(tile_slice: torch.Tensor, num_slices: int) -> WorkList:
    """The work list of ``tile_slice`` on its device."""
    recs = tile_runs(tile_slice, num_slices)
    s1 = recs[:, 3] & ~RUN_ATOMIC
    return WorkList(torch.from_numpy(recs).to(tile_slice.device),
                    bool((recs[:, 3] & RUN_ATOMIC).any()),
                    int((recs[:, 1] - recs[:, 0]).max(initial=0)),
                    int((s1 - recs[:, 2]).max(initial=0)))


def sell_work(plan) -> WorkList:
    """A placed SellPlan's work list (its ``work``)."""
    return work_list(plan.tile_slice, plan.num_slices)


# ---------------------------------------------------------------------------
# kernel D: a ChunkPlan's heavy subwindow tiles as one slab
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeavyTiles:
    """A placed ChunkPlan's heavy subwindow tiles, every W bucket's real
    tiles in one slab on the plan's device, stably ordered by heavy row
    (kernel D reads x at ``bases * 128 + cols_win`` whatever the
    bucket's W, so the buckets differ only in their tiles), and its work
    list over ``tile_row``, each heavy row's tiles one slice."""

    vals: torch.Tensor        # (T, P, R) float32
    cols_win: torch.Tensor    # (T, P, R) int16 offsets from the base
    bases: torch.Tensor       # (T, P) int32 base blocks of 128 columns
    tile_row: torch.Tensor    # (T,) int32 entry of ``rows``, nondecreasing
    rows: torch.Tensor        # (K,) int32 y rows of the heavy rows with tiles
    work: WorkList


def padding_tiles(h, num_segments: int) -> int:
    """How many tiles at the end of SubwinPlan ``h`` are padding: the
    builder rounds a bucket to its grid step with tiles of one value
    (the plan's pad value, the semiring's zero) at offset 0 of base 0,
    mapped to the last segment (``formats/chunk.py``).  A trailing tile
    of the last heavy row that looks the same holds no column but 0
    and one value in all 1024 slots."""
    from ..ops import semiring as sr

    T = h.vals.shape[0]
    flat = sr.signed(h.vals).reshape(T, -1)
    pad = ((flat == flat[:, :1]).all(1) & (h.cols_win.reshape(T, -1) == 0)
           .all(1) & (h.bases == 0).all(1) & (h.tile_seg == num_segments - 1))
    real = np.flatnonzero(~pad.cpu().numpy())
    return T - (int(real[-1]) + 1 if real.size else 0)


def heavy_tiles(plan) -> HeavyTiles | None:
    """The heavy slab of a placed ChunkPlan (its ``heavy``; None without
    heavy tiles): the buckets' tiles less their padding, concatenated and
    stably sorted by ``tile_seg``, so each heavy row's tiles are one run
    in bucket order.  The plan's own arrays are left as they are."""
    from ..ops import semiring as sr

    nblk, nheavy = plan.num_blocks, plan.num_heavy
    keep = [(h, h.num_tiles - padding_tiles(h, nblk + nheavy))
            for h in plan.hbuckets]
    keep = [(h, n) for h, n in keep if n]
    if not keep:
        return None
    seg = np.concatenate([h.tile_seg[:n].cpu().numpy() for h, n in keep])
    if seg.min() < nblk:
        raise ValueError("a heavy subwindow tile maps to a light segment")
    order = np.argsort(seg, kind="stable")
    heavy, tile_row = np.unique(seg[order] - nblk, return_inverse=True)
    dev = plan.hbuckets[0].vals.device
    idx = torch.from_numpy(order).to(dev)

    def slab(field):
        return sr.take(torch.cat([getattr(h, field)[:n] for h, n in keep]),
                       idx).contiguous()

    rows = plan.heavy_rows.cpu().numpy()[heavy]
    tile_row = torch.from_numpy(tile_row.astype(np.int32)).to(dev)
    return HeavyTiles(slab("vals"), slab("cols_win"), slab("bases"),
                      tile_row,
                      torch.from_numpy(rows.astype(np.int32)).to(dev),
                      work_list(tile_row, heavy.shape[0]))


# ---------------------------------------------------------------------------
# the chunk light route: a ChunkPlan's light buckets as records by lane row
# ---------------------------------------------------------------------------

#: records after which the light route's CTA over a segment stops taking
#: rows: a segment of 128 lane rows that holds more is split at row
#: boundaries over several CTAs (on an H100, 256 beat 512, 1024 and whole
#: segments: probes_torch/light_shapes.py, PERF.md)
LIGHT_UNIT_RECORDS = 256


@dataclasses.dataclass(frozen=True)
class LightRecords:
    """A placed ChunkPlan's light buckets as one list of their real slots
    (the slots whose value is not the bucket's ``pad_value``, bit for
    bit), sorted stably by lane row ``seg * 128 + lane`` of the unified
    segment space, so that a row's records keep the order in which the
    reference sums them: bucket, tile, position.  Lane row r owns records
    ``[row_off[r], row_off[r+1])``, each a column of x and a value.
    ``tiled[s]``: a tile of some bucket, padding included, maps to
    segment s, so that the reference sums a padding slot into every lane
    row of s (what matters under max_times, whose zero 0 is not its
    empty sum -inf).  CTA u of the route sums lane rows ``[units[u, 0],
    units[u+1, 0])``, which own records ``[units[u, 1], units[u+1,
    1])``: at most one segment's 128 rows, split where a segment holds
    more than ``LIGHT_UNIT_RECORDS`` records.  Bytes on the device: 8 a
    record, 4 a lane row (plus one), 1 a segment, 8 a CTA."""

    row_off: torch.Tensor     # (segments * 128 + 1,) int32
    cols: torch.Tensor        # (records,) int32 column of x
    vals: torch.Tensor        # (records,) the buckets' value type
    tiled: torch.Tensor       # (segments,) bool
    units: torch.Tensor       # (CTAs + 1, 2) int32 (lane row, record)


def light_units(row_off, unit_records: int = LIGHT_UNIT_RECORDS
                ) -> np.ndarray:
    """The light route's work list over ``row_off`` (numpy): (CTAs + 1,
    2) int32 boundaries, each a lane row and its first record, at every
    segment's first row and wherever a row starts past another
    ``unit_records`` records of its segment."""
    off = np.asarray(row_off, np.int64)
    nrows = off.shape[0] - 1
    if nrows % 128:
        raise ValueError(f"{nrows} lane rows: not whole segments of 128")
    r = np.arange(nrows)
    seg = r // 128
    rel = off[:-1] - off[seg * 128]
    key = seg * (int(off[-1]) // max(1, unit_records) + 2) + \
        rel // max(1, unit_records)
    starts = np.append(np.flatnonzero(np.diff(key, prepend=-1) != 0), nrows)
    return np.stack([starts, off[starts]], 1).astype(np.int32)


def light_records(plan) -> LightRecords:
    """The light route's records of ``plan`` (a host or placed ChunkPlan;
    a placed one's ``light``), on the device of its ``perm_idx``.  The
    plan's own arrays are left as they are."""
    nseg = plan.num_blocks + plan.num_heavy
    rows, vals, cols = [], [], []
    tiled = np.zeros(nseg, bool)
    for b in plan.buckets:
        ts = _host(b.tile_slice).astype(np.int64)
        tiled[ts] = True
        v = torch.as_tensor(b.vals).cpu()
        pad = torch.tensor([b.stats.pad_value]).to(v.dtype)
        # bit for bit: a -0.0 or a NaN is a value when the pad is 0.0
        t, p, l = np.nonzero(_bits(v) != _bits(pad)[0])
        rows.append(ts[t] * 128 + l)
        cols.append(_host(b.window_base).astype(np.int64)[
            t // b.stats.group_tiles] * b.stats.window_grain
            + _host(b.cols_win)[t, p, l])
        vals.append(v[torch.from_numpy(t), torch.from_numpy(p),
                      torch.from_numpy(l)])
    rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    order = np.argsort(rows, kind="stable")
    count = np.bincount(rows, minlength=nseg * 128)
    if rows.size >= 2 ** 31:
        raise ValueError(f"{rows.size} light records: int32 offsets")
    row_off = np.concatenate(([0], np.cumsum(count)))
    device = plan.perm_idx.device if isinstance(plan.perm_idx,
                                                torch.Tensor) else "cpu"

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    vals = torch.cat(vals)[torch.from_numpy(order)] if vals else \
        torch.zeros(0)
    return LightRecords(
        put(row_off, np.int32),
        put(np.concatenate(cols)[order] if cols else [], np.int32),
        vals.contiguous().to(device),
        put(tiled, np.bool_), put(light_units(row_off), np.int32))


# ---------------------------------------------------------------------------
# kernel F: a PackedPlan's piece sums and overflow as one list by row
# ---------------------------------------------------------------------------

#: merge steps (a row's end or one of its entries) a CTA of kernel F
#: takes: ``PACKED_F_THREADS * PACKED_F_ITEMS`` of ``csrc/spmv_packed.cu``
#: (a test checks the two agree), by which placement cuts F's work list
F_UNIT = 2048

#: pieces the compaction places at a time, so that its int64 index
#: temporaries stay about a hundred MB whatever the plan
_PIECES_A_PASS = 1 << 23


@dataclasses.dataclass(frozen=True)
class ExtractTables:
    """What kernel F reads of a placed PackedPlan in place of its dense
    ``esrc``: row r sums ``entries[row_off[r]:row_off[r+1]]``, first the
    scan slot of each of its primary pieces (``sblock[i] * step_tiles *
    1024 + esrc[i, e]``, >= 0) in visit order, then ``-1 - j`` for each
    of its overflow entries j, whose column and value are ``ov_cols[j]``
    and ``ov_vals[j]`` (the plan's overflow sorted stably by row, so a
    row's entries keep the plan's order).  CTA u of F sums rows
    ``[units[u, 0], units[u, 1])``, whose entries are ``[units[u, 2],
    units[u, 3])``: consecutive rows of at most ``unit`` merge steps
    (rows plus entries), or one hub row of more; the hubs first, the
    longest first, then the rest in row order.  ``pieces``
    counts the slots, ``dense_entries`` the entries of the dense
    ``esrc`` (visits x 8192).  ``ncols`` is the plan's width and
    ``slots`` its scan's: F reads x and the scan at the entries
    unmasked, so a shorter x or another scan is refused before a
    launch."""

    ncols: int
    slots: int
    pieces: int
    dense_entries: int
    unit: int
    row_off: torch.Tensor     # (rows + 1,) int32
    entries: torch.Tensor     # (pieces + novf,) int32
    units: torch.Tensor       # (CTAs, 4) int32 rows, then entries
    ov_cols: torch.Tensor     # (novf,) int32 column of x
    ov_vals: torch.Tensor     # (novf,) the plan's value type


def piece_slots(sblock: torch.Tensor, wstep: torch.Tensor,
                esrc: torch.Tensor, step_tiles: int):
    """Every primary piece of a plan's pass-B arrays (tensors on one
    device, the visits window-major: ``wstep`` nondecreasing, as
    ``build_packed_plan`` makes it; ``esrc`` (visits, window's 128-row
    blocks, 128)): its y row and its scan slot, int32, sorted by row, a
    row's pieces in visit order.  A window at a time, its visits'
    extraction indices read row-major, so that no sort is needed."""
    window = math.prod(esrc.shape[1:])
    flat = esrc.reshape(esrc.shape[0], window)
    ws = wstep.long()
    if ws.numel() and bool((ws[1:] < ws[:-1]).any()):
        raise ValueError("wstep must be nondecreasing (window-major "
                         "visits)")
    bounds = torch.unique_consecutive(ws, return_counts=True)
    first = 0
    rows, slots = [], []
    for w, n in zip(bounds[0].tolist(), bounds[1].tolist()):
        e = flat[first:first + n].t()          # (rows of the window, visits)
        lane, vi = torch.nonzero(e >= 0, as_tuple=True)
        vi = vi + first
        rows.append((lane + w * window).to(torch.int32))
        slots.append((sblock[vi].long() * (step_tiles * 1024)
                      + e[lane, vi - first].long()).to(torch.int32))
        first += n
    if not rows:
        none = torch.zeros(0, dtype=torch.int32, device=esrc.device)
        return none, none
    return torch.cat(rows), torch.cat(slots)


def f_units(row_off, unit: int = F_UNIT) -> np.ndarray:
    """Kernel F's work list over ``row_off`` (numpy): (CTAs, 2) int32
    (first row, end row), greedily the most consecutive rows whose merge
    steps (rows plus entries) fit ``unit``, a row that alone exceeds it
    a CTA of its own (a hub); the hubs first, the longest first, then the
    rest in row order."""
    steps = np.asarray(row_off, np.int64)
    nrows = steps.shape[0] - 1
    steps = steps + np.arange(nrows + 1)     # merge steps before each row
    starts, r = [], 0
    while r < nrows:
        starts.append(r)
        end = int(np.searchsorted(steps, steps[r] + unit, side="right")) - 1
        r = max(end, r + 1)
    bounds = np.append(np.asarray(starts, np.int64), nrows)
    units = np.stack([bounds[:-1], bounds[1:]], 1)
    size = steps[units[:, 1]] - steps[units[:, 0]]
    hub = np.flatnonzero(size > unit)
    order = np.concatenate([hub[np.argsort(-size[hub], kind="stable")],
                            np.flatnonzero(size <= unit)])
    return units[order].astype(np.int32).reshape(-1, 2)


def compact_tables(prow, pslot, orow, ov_cols, ov_vals, *, rows: int,
                   ncols: int, slots: int, dense_entries: int,
                   unit: int = F_UNIT) -> ExtractTables:
    """Kernel F's tables from the pieces' rows and slots (sorted by row, a
    row's pieces in visit order: :func:`piece_slots`) and the overflow's
    rows, columns and values (sorted stably by row), all on one device."""
    dev = prow.device
    npc, nov = prow.shape[0], orow.shape[0]
    if max(npc + nov, slots, rows + 1) >= 2 ** 31:
        raise ValueError(f"{npc + nov} entries, {slots} scan slots, {rows} "
                         f"rows: kernel F's tables index in 32 bits")
    if npc and (int(prow[-1]) >= rows or int(pslot.max()) >= slots or
                int(pslot.min()) < 0):
        raise ValueError(f"a piece outside {rows} rows and {slots} slots")
    cp = torch.bincount(prow, minlength=rows)
    co = torch.bincount(orow, minlength=rows)
    row_off = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
    row_off[1:] = torch.cumsum(cp + co, 0)
    entries = torch.empty(npc + nov, dtype=torch.int32, device=dev)
    # a row's pieces first, then its overflow entries
    before = torch.cumsum(co, 0) - co          # overflow of earlier rows
    for k0 in range(0, npc, _PIECES_A_PASS):
        k1 = min(npc, k0 + _PIECES_A_PASS)
        at = torch.arange(k0, k1, device=dev) + before[prow[k0:k1].long()]
        entries[at] = pslot[k0:k1].to(torch.int32)
    del before
    entries[torch.arange(nov, device=dev) + torch.cumsum(cp, 0)[orow]] = \
        -1 - torch.arange(nov, dtype=torch.int32, device=dev)
    off = row_off.cpu().numpy()
    units = f_units(off, unit)
    units = np.concatenate([units, off[units]], 1).astype(np.int32)
    return ExtractTables(
        ncols, slots, npc, dense_entries, unit, row_off.to(torch.int32),
        entries, torch.from_numpy(units).to(dev),
        ov_cols.to(device=dev, dtype=torch.int32).contiguous(),
        ov_vals.to(dev).contiguous())


def extract_tables(plan, unit: int = F_UNIT) -> ExtractTables:
    """Kernel F's tables for a PackedPlan (host or placed), on the device
    of its ``esrc`` (the CPU for a host plan); the plan's own arrays are
    left as they are."""
    from ..ops import semiring as sr

    rows, ncols = plan.shape
    ov_rows = _host(plan.ov_rows).astype(np.int64)
    ov_cols = _host(plan.ov_cols)
    # kernel F reads x at these unchecked
    if ov_rows.size and (ov_rows.min() < 0 or ov_rows.max() >= rows or
                         ov_cols.min() < 0 or ov_cols.max() >= ncols):
        raise ValueError(f"overflow entries outside the plan's "
                         f"{rows} x {ncols}")
    order = np.argsort(ov_rows, kind="stable")
    device = plan.esrc.device if isinstance(plan.esrc, torch.Tensor) \
        else "cpu"

    def put(a):
        return torch.as_tensor(a).to(device)

    prow, pslot = piece_slots(put(plan.sblock), put(plan.wstep),
                              put(plan.esrc), plan.stats.step_tiles)
    return compact_tables(
        prow, pslot, put(ov_rows[order]), put(ov_cols[order]),
        sr.take(torch.as_tensor(plan.ov_vals).cpu(), torch.from_numpy(order)),
        rows=rows, ncols=ncols, slots=plan.vals.shape[0] * 1024,
        dense_entries=math.prod(plan.esrc.shape), unit=unit)


def placed_extract_tables(plan) -> ExtractTables:
    """A placed PackedPlan's kernel-F tables (its ``tables``); counts
    their pieces (``packed.f_entries``) and the entries of the dense
    ``esrc`` they replace (``packed.f_dense_entries``) in
    ``utils.stats.counters``."""
    from ..utils.stats import counters

    tables = extract_tables(plan)
    counters["packed.f_entries"] += tables.pieces
    counters["packed.f_dense_entries"] += tables.dense_entries
    return tables
