"""The work list of kernels G and H: which CTA sums which tiles.

The tiles of one slice of a SellPlan are one contiguous run
(``tile_slice`` is nondecreasing).  Kernel H (``csrc/spmm_sell_window.cu``)
and kernel G (``csrc/spmv_sell_global.cu``) sum each slice's run
themselves, so that no per-tile partials reach device memory, and take
their runs from one work list per placed plan: :func:`tile_runs` builds
it from ``tile_slice``, :func:`place_plan_runs` at placement
(``formats.plan.place``, ``parallel.place_on_mesh``), and
:func:`runs_on` hands it to a launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..formats.cached import CachedPlan
from ..formats.dia import HybridPlan
from ..formats.plan import SellPlan

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
    ts = np.asarray(tile_slice.cpu() if isinstance(tile_slice, torch.Tensor)
                    else tile_slice).astype(np.int64)
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
    """A placed plan's work list and what a launch sizes by it."""

    num_slices: int
    runs: torch.Tensor        # (records, 4) int32 on the plan's device
    split: bool               # a record holds one piece of a split slice
    max_tiles: int            # most tiles of one record
    max_slices: int           # most slices one record writes


#: the work list of each placed plan by its ``tile_slice`` tensor.  A
#: sharded apply rebuilds its shard plans around the same tensors.
_RUNS = WeakIdKeyDictionary()


def place_runs(tile_slice: torch.Tensor, num_slices: int) -> None:
    """Build the work list for a placed plan's ``tile_slice``, once (a
    no-op when it is built), so that no apply waits on it."""
    hit = _RUNS.get(tile_slice)
    if hit is None or hit.num_slices != num_slices:
        recs = tile_runs(tile_slice, num_slices)
        s1 = recs[:, 3] & ~RUN_ATOMIC
        _RUNS[tile_slice] = WorkList(
            num_slices, torch.from_numpy(recs).to(tile_slice.device),
            bool((recs[:, 3] & RUN_ATOMIC).any()),
            int((recs[:, 1] - recs[:, 0]).max(initial=0)),
            int((s1 - recs[:, 2]).max(initial=0)))


def place_plan_runs(plan) -> None:
    """:func:`place_runs` for every float32 SellPlan of a placed plan —
    the plan itself, a HybridPlan's rest, a CachedPlan's tiers — which
    kernel G (any strategy but 'window') or kernel H (``op @ B`` on a
    window plan) may run.  A double SellPlan gets none: kernel L writes
    per-tile partials."""
    if isinstance(plan, HybridPlan):
        place_plan_runs(plan.rest)
    elif isinstance(plan, CachedPlan):
        place_plan_runs(plan.hot)
        if plan.cold is not None:
            place_plan_runs(plan.cold)
    elif isinstance(plan, SellPlan) and not plan.stats.double:
        place_runs(plan.tile_slice, plan.num_slices)


def runs_on(tile_slice: torch.Tensor, num_slices: int) -> WorkList:
    """The work list of a placed plan's ``tile_slice``; raises for one
    no placement saw."""
    hit = _RUNS.get(tile_slice)
    if hit is None or hit.num_slices != num_slices:
        raise ValueError("the work list of kernels G and H is built when "
                         "their plan is placed: place the plan with "
                         "formats.plan.place (parallel.place_on_mesh for a "
                         "sharded plan)")
    return hit
