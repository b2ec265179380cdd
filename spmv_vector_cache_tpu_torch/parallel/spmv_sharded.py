"""Sharded SpMV and SpMM: row-partitioned SELL plans over a device mesh
(counterpart of ``spmv_vector_cache_tpu/parallel/spmv_sharded.py``).

* The matrix is partitioned into D contiguous **row blocks**, one per
  shard; each block gets its own SELL plan, and the plans are stacked
  into uniform (D, T, P, R) arrays (padded to the largest shard), byte
  for byte the reference's.
* **x exchange**: x is row-sharded like y; before its local SpMV each
  shard assembles the x entries it needs:
  - ``all_gather`` (general matrices): every shard's x, concatenated;
  - ``halo`` (banded matrices): only its ring neighbours' halos, when the
    plan's bandwidth permits (``halo <= rows_per_shard``).
* Each shard runs the single-device path: its arrays reassemble into a
  :class:`SellPlan` (:func:`_local_plan`) that ``spmv_plan``'s dispatch
  runs on the window strategy, kernel B, and ``op @ B``'s window SpMM,
  kernel H (a narrow plan's y narrowed once, after the join).  A
  plan with no window somewhere (``window_blocks == 0``) runs the
  reference's own non-kernel route in plain torch; that choice is made
  from plan fields before anything runs.  Results concatenate along the
  row axis: rows are uniquely owned.

The mesh is :class:`~.mesh.Mesh`, one torch device per shard, in one
process (see ``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..formats import analysis
from ..formats.containers import CSR
from ..formats.plan import (WINDOW_GROUP_TILES, PlanStats, SellPlan, _as_csr,
                            _round_up, build_dtype, build_sell_plan,
                            compute_cols_win, finish_values, host_numpy,
                            value_kind)
from ..formats.tables import WorkList, table
from ..ops import semiring as sr
from ..ops.spmm_sell import _spmm_window
from ..ops.spmv_sell import _spmv_sums, check_x_length
from .mesh import (Mesh, device_scope, make_mesh, place_on_mesh,
                   shard_vector, with_halos)

__all__ = ["ShardedPlan", "build_sharded_plan", "spmv_sharded",
           "spmm_sharded", "exchange_mode", "make_mesh", "Mesh"]

Array = Any


@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """D row-block SELL plans stacked for execution on D shards.

    All shards share tile count T (zero-padded), so the host arrays are
    (D, T, P, R); once placed (:func:`~.mesh.place_on_mesh`) each array
    field is a tuple of D per-shard tensors, shard d on
    ``mesh.devices[d]``.  ``rows_per_shard`` is the uniform row-block
    height (multiple of 128; last block zero-padded).  ``halo`` is the
    column halo width each side (multiple of 128) for the banded exchange
    mode (0 = not banded: all-gather only).  A window plan placed on a
    mesh holds kernel H's work list of each shard in ``works``.
    """

    vals: Array          # (D, T, P, R)
    cols: Array          # (D, T, P, R) — GLOBAL column indices
    cols_win: Array      # (D, T, P, R) int16 in-window offsets (empty K == 0)
    tile_slice: Array    # (D, T)
    window_base: Array   # (D, T/WINDOW_GROUP_TILES) — global x window base
    row_map: Array       # (D, num_slices*R) — LOCAL row ids (rps = padding)
    shape: Tuple[int, int]
    num_shards: int
    rows_per_shard: int
    identity_map: bool
    halo: int
    window_blocks: int   # merged K (0 = window kernel infeasible somewhere)
    max_window_base: int
    groups_per_step: int
    works: Optional[Tuple[WorkList, ...]] = table()

    _array_fields = ("vals", "cols", "cols_win", "tile_slice", "window_base",
                     "row_map")

    @property
    def num_slices(self) -> int:
        return int(self.row_map[0].shape[-1]) // 128


def build_sharded_plan(a, num_shards: int, *, value_dtype=np.float32,
                       sigma: Optional[int] = None,
                       split: Optional[int] = None,
                       max_window_blocks: int = 16) -> ShardedPlan:
    """Partition rows into ``num_shards`` blocks and plan each (host):
    values of any type of ``formats.plan.value_kind`` but float64."""
    if value_kind(value_dtype) == "f64":
        raise NotImplementedError(
            "value_dtype float64: sharded SELL plans run every value type "
            "but float64; double plans run unsharded, "
            "from_matrix(a, value_dtype=np.float64) (the reference builds "
            "no double sharded plan to hold one against)")
    csr = _as_csr(a)
    rows, cols_n = csr.shape
    rps = _round_up(_round_up(rows, num_shards) // num_shards, 128)
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    indices = np.asarray(csr.indices)
    data = np.asarray(csr.data)

    plans = []
    for d in range(num_shards):
        r0, r1 = min(d * rps, rows), min((d + 1) * rps, rows)
        e0, e1 = indptr[r0], indptr[r1]
        local_indptr = np.concatenate([
            (indptr[r0:r1 + 1] - e0) if r1 > r0 else np.zeros(1, np.int64),
            np.full(rps - (r1 - r0), e1 - e0, np.int64)]).astype(np.int32)
        sub = CSR(data=data[e0:e1], indices=indices[e0:e1],
                  indptr=local_indptr, shape=(rps, cols_n))
        # grain fixed at 128: the halo mode shifts window_base by whole
        # 128-lane blocks (see the cols_win invariance note below)
        plans.append(build_sell_plan(
            sub, value_dtype=value_dtype, sigma=sigma, split=split,
            max_window_blocks=max_window_blocks, window_grain=128))

    wb_feasible_pre = all(p.stats.window_blocks > 0 for p in plans)
    groups = min(p.stats.groups_per_step for p in plans) \
        if wb_feasible_pre else 8
    T = _round_up(max(p.num_tiles for p in plans), 8 * groups)
    S = max(p.num_slices for p in plans)
    D = num_shards
    Pp, R = plans[0].positions, plans[0].lane_rows
    vals = np.zeros((D, T, Pp, R), dtype=build_dtype(value_dtype))
    cols = np.zeros((D, T, Pp, R), dtype=np.int32)
    tile_slice = np.zeros((D, T), dtype=np.int32)
    window_base = np.zeros((D, T // WINDOW_GROUP_TILES), dtype=np.int32)
    row_map = np.full((D, S * R), rps, dtype=np.int32)
    for d, p in enumerate(plans):
        t = p.num_tiles
        vals[d, :t] = host_numpy(p.vals)
        cols[d, :t] = p.cols
        tile_slice[d, :t] = p.tile_slice
        tile_slice[d, t:] = S - 1          # padding tiles: last slice, zeros
        window_base[d, :t // WINDOW_GROUP_TILES] = p.window_base
        row_map[d, :p.row_map.shape[0]] = p.row_map

    identity = all(p.identity_map for p in plans) and \
        all(p.num_slices == S for p in plans)
    window_blocks = max(p.stats.window_blocks for p in plans) \
        if wb_feasible_pre else 0
    max_window_base = max(p.stats.max_window_base for p in plans)

    # in-window offsets are invariant to the halo shift (cols and
    # window_base shift by the same multiple of 128), so one stacked
    # int16 array serves both exchange modes
    if window_blocks:
        cols_win = np.stack([
            compute_cols_win(vals[d] != 0, cols[d], window_base[d],
                             window_blocks)
            for d in range(D)])
    else:
        cols_win = np.zeros((D, 0, Pp, R), np.int16)

    bw = analysis.bandwidth(csr)
    halo = _round_up(int(bw), 128) if 0 < bw <= rps else 0

    return ShardedPlan(vals=finish_values(vals, value_dtype), cols=cols,
                       cols_win=cols_win,
                       tile_slice=tile_slice,
                       window_base=window_base, row_map=row_map,
                       shape=(rows, cols_n), num_shards=D,
                       rows_per_shard=rps, identity_map=identity,
                       halo=halo, window_blocks=window_blocks,
                       max_window_base=max_window_base,
                       groups_per_step=groups)


# ---------------------------------------------------------------------------
# local (per-shard) executors
# ---------------------------------------------------------------------------

def _local_plan(sp: ShardedPlan, d: int, cols, window_base, x_len: int,
                max_wb: int) -> SellPlan:
    """Shard d's arrays reassembled into a single-device SellPlan, with
    the reference's stats (so that ``folds_groups`` and the SpMV epilogue
    read what its kernel route reads: no group fold, the tile segment
    sum, then the row map; kernel H sums the slices and, the map being
    the identity, writes the shard's rows of Y itself)."""
    vals = sp.vals[d]
    T, P, R = vals.shape
    stats = PlanStats(
        nnz=0, num_tiles=T, num_slices=sp.num_slices,
        num_subrows=sp.rows_per_shard, num_splits=0, num_stripes=1,
        padded_slots=0, fill=0.0,
        window_blocks=sp.window_blocks, max_window_base=max_wb,
        groups_per_step=sp.groups_per_step)
    return SellPlan(vals=vals, cols=cols, cols_win=sp.cols_win[d],
                    tile_slice=sp.tile_slice[d],
                    window_base=window_base, row_map=sp.row_map[d],
                    window_rows=torch.zeros(0, dtype=torch.int32,
                                            device=vals.device),
                    shape=(sp.rows_per_shard, x_len), lane_rows=R,
                    positions=P, identity_map=sp.identity_map, stats=stats,
                    work=sp.works[d] if sp.works else None)


def _slices_to_rows(y2d: torch.Tensor, row_map: torch.Tensor, *,
                    rows_local: int, identity: bool) -> torch.Tensor:
    """(num_slices, R[, k]) slice sums -> the shard's (rows_local[, k])."""
    flat = y2d.reshape((-1,) + tuple(y2d.shape[2:]))
    if identity:
        return flat[:rows_local]
    return sr.PLUS_TIMES.segment_reduce(flat, row_map,
                                        num_segments=rows_local + 1)[
        :rows_local]


def _local_spmv_plain(vals, cols, tile_slice, row_map, x_full, *,
                      num_slices: int, rows_local: int,
                      identity: bool) -> torch.Tensor:
    """Per-shard SpMV in plain torch: the reference's non-kernel route,
    taken when the plan has no window (a gather of x per slot), in
    ``ops/semiring.widen``'s types."""
    partial_t = (sr.widen(vals) * sr.widen(x_full)[cols.long()]).sum(1)
    y2d = sr.PLUS_TIMES.segment_reduce(sr.narrow(partial_t, x_full.dtype),
                                       tile_slice, num_segments=num_slices)
    return _slices_to_rows(y2d, row_map, rows_local=rows_local,
                           identity=identity)


def exchange_mode(sp: ShardedPlan, mode: str) -> str:
    """The x exchange :func:`spmv_sharded` runs for ``mode``: 'auto' is
    'halo' when the plan's bandwidth permits, else 'all_gather'."""
    if mode == "auto":
        return "halo" if 0 < sp.halo <= sp.rows_per_shard else "all_gather"
    if mode == "halo" and not 0 < sp.halo <= sp.rows_per_shard:
        raise ValueError(f"halo mode needs 0 < halo <= rows_per_shard "
                         f"(halo {sp.halo}, rows_per_shard "
                         f"{sp.rows_per_shard}): use all_gather")
    if mode not in ("halo", "all_gather"):
        raise ValueError(f"mode must be 'all_gather', 'halo' or 'auto', "
                         f"got {mode!r}")
    return mode


def _check_cols(sp: ShardedPlan) -> None:
    if sp.shape[1] > sp.num_shards * sp.rows_per_shard:
        raise ValueError(
            f"cols ({sp.shape[1]}) exceed the sharded x capacity "
            f"({sp.num_shards} shards x {sp.rows_per_shard}); "
            "row-partitioning assumes cols <= rows padded — transpose or "
            "pad the matrix")


def _replicated(parts: list, mesh: Mesh) -> list:
    """The concatenation of ``parts`` on every shard's device, built once
    per distinct device (every shard receives the same array)."""
    on = {}
    for dev in mesh.devices:
        if dev not in on:
            on[dev] = parts[0].to(dev) if len(parts) == 1 else \
                torch.cat([p.to(dev) for p in parts])
    return [on[dev] for dev in mesh.devices]


def spmv_sharded(sp: ShardedPlan, x: Array, mesh: Mesh, *,
                 axis: str = "x", mode: str = "auto") -> torch.Tensor:
    """Distributed ``y = A @ x`` with x and y row-sharded over the mesh.

    ``mode``: 'all_gather' | 'halo' | 'auto' (halo when the plan's
    bandwidth permits).  Each shard runs the window kernel B when the
    plan has a window, else the reference's plain route.  A plan not yet
    on ``mesh`` is placed there first (place it once with
    :func:`~.mesh.place_on_mesh` to apply it many times).  ``axis`` is
    accepted for the reference's signature.  Returns y on
    ``mesh.devices[0]``.  x must have the plan's column count
    (``ValueError``).
    """
    mode = exchange_mode(sp, mode)
    _check_cols(sp)
    check_x_length(x, sp.shape[1])
    sp = place_on_mesh(sp, mesh)
    D, rps = sp.num_shards, sp.rows_per_shard
    vdt = sp.vals[0].dtype
    xs = shard_vector(sr.as_x(torch.as_tensor(x), vdt), sr.x_dtype(vdt), D,
                      rps, mesh)
    gathered = None
    if mode == "all_gather":
        gathered = _replicated(xs, mesh)
        x_len, max_wb = D * rps, sp.max_window_base
    else:
        # local wb = global wb - (d*rps - halo)/128 (the clip only moves
        # all-zero padding tiles)
        x_len = rps + 2 * sp.halo
        max_wb = x_len // 128
    ys = []
    for d, dev in enumerate(mesh.devices):
        with device_scope(dev):
            ys.append(_shard_spmv(sp, d, dev, xs, gathered, mode, x_len,
                                  max_wb).to(mesh.devices[0]))
    return sr.finish_y(torch.cat(ys)[:sp.shape[0]], vdt)


def _shard_spmv(sp: ShardedPlan, d: int, dev, xs: list, gathered, mode: str,
                x_len: int, max_wb: int) -> torch.Tensor:
    """Shard d's rows of y: its x assembled for ``mode``, then kernel B
    (the plan has a window) or the plain route."""
    cols, wb = sp.cols[d], sp.window_base[d]
    if mode == "all_gather":
        x_full = gathered[d]
    else:
        x_full = with_halos(xs, d, sp.halo, dev)
        shift = d * sp.rows_per_shard - sp.halo           # multiple of 128
        wb = (wb - shift // 128).clamp_(0, max_wb)
        if not sp.window_blocks:
            # kernel B reads only cols_win and window_base, so only the
            # plain route needs the shifted column ids
            cols = (cols - shift).clamp_(0, x_len - 1)
    if sp.window_blocks:
        return _spmv_sums(_local_plan(sp, d, cols, wb, x_len, max_wb),
                          x_full, "window", "plus_times")
    return _local_spmv_plain(sp.vals[d], cols, sp.tile_slice[d],
                             sp.row_map[d], x_full,
                             num_slices=sp.num_slices,
                             rows_local=sp.rows_per_shard,
                             identity=sp.identity_map)


def spmm_sharded(sp: ShardedPlan, b: Array, mesh: Mesh, *,
                 axis: str = "x") -> torch.Tensor:
    """Distributed ``Y = A @ B`` (B replicated to every shard's device, Y
    row-sharded).  When the plan has a window, each shard runs the window
    SpMM kernel H; otherwise the reference's einsum route in plain
    torch.  Returns Y on ``mesh.devices[0]``."""
    _check_cols(sp)
    sp = place_on_mesh(sp, mesh)
    D, rps = sp.num_shards, sp.rows_per_shard
    vdt = sp.vals[0].dtype
    b = sr.as_x(torch.as_tensor(b), vdt)
    k = b.shape[1]
    bp = b.new_zeros((D * rps, k))
    bp[:b.shape[0]] = b
    ys = []
    for d, b_full in enumerate(_replicated([bp], mesh)):
        with device_scope(mesh.devices[d]):
            ys.append(_shard_spmm(sp, d, b_full).to(mesh.devices[0]))
    return sr.finish_y(torch.cat(ys)[:sp.shape[0]], vdt)


def _shard_spmm(sp: ShardedPlan, d: int, b_full) -> torch.Tensor:
    """Shard d's rows of Y: kernel H, or the reference's einsum route."""
    if sp.window_blocks:
        lp = _local_plan(sp, d, sp.cols[d], sp.window_base[d],
                         b_full.shape[0], sp.max_window_base)
        return _spmm_window(lp, b_full)
    bg = sr.widen(b_full)[sp.cols[d].long()]                 # (T, P, R, k)
    vals = sr.widen(sp.vals[d])
    if vals.is_floating_point():
        contrib = torch.einsum("tpr,tprk->trk", vals, bg)
    else:                       # torch multiplies no integer matrices
        contrib = (vals[..., None] * bg).sum(1)
    y3d = sr.PLUS_TIMES.segment_reduce(sr.narrow(contrib, b_full.dtype),
                                       sp.tile_slice[d],
                                       num_segments=sp.num_slices)
    return _slices_to_rows(y3d, sp.row_map[d], rows_local=sp.rows_per_shard,
                           identity=sp.identity_map)
