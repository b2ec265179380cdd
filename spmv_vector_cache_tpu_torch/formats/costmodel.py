"""Plan cost model (counterpart of
``spmv_vector_cache_tpu/formats/costmodel.py``; Sell, Dia, Hybrid,
Cached, CooTail, Chunk and Packed plans, and SELL and Chunk plans priced
from their statistics alone, ``plan.SellPrice`` and ``chunk.ChunkPrice``).

A closed-form per-apply time estimate per plan family, which the planner
uses to veto mis-selections.  The constants are the reference's, measured
on a TPU v5e: they are kept unchanged only so that the port picks the
same plans as the reference.  They do not describe the H100;
re-measuring them there is a later ROADMAP item.
"""

from __future__ import annotations

from typing import Any

import numpy as np

# --- v5e constants, unchanged from the reference ---------------------------
#: streamed ns per (8,128)-tile slot at the 6 B/nnz window stream
_NS_PER_SLOT_BASE = 0.0117
#: extra ns/slot per window block past K=2
_NS_PER_SLOT_PER_K = 0.00207
#: fixed cost of one Pallas grid step
_NS_PER_GRID_STEP = 1000.0
#: fixed per-kernel-launch cost inside a chained jit
_NS_LAUNCH = 5000.0
#: unsorted 1-D segment-scatter fixup: ns/slot + floor
_NS_PER_SEGSUM_SLOT = 7.0
_NS_SEGSUM_FLOOR = 30000.0
#: element gather+scatter COO path: ns/nnz + floor
_NS_PER_COO_NNZ = 16.0
_NS_COO_FLOOR = 3000.0
#: HBM read bandwidth (bytes/ns)
_BYTES_PER_NS = 700.0
#: packed pass-B extraction cost per visit
_NS_PER_PACKED_VISIT = 2600.0
#: chunk plans: ns per window tile (+ per window block K), per subwin
#: tile (+ per window block W), per tile of the sorted partials fold,
#: and the fixed lane-perm/heavy epilogue
_NS_CHUNK_TILE = 15.0
_NS_CHUNK_TILE_PER_K = 5.2
_NS_SUBWIN_TILE_PER_W = 26.0
_NS_CHUNK_FOLD_TILE = 9.4
_NS_CHUNK_EPILOGUE = 20e3


def estimate_seconds(plan: Any) -> float:
    """The reference's predicted seconds per apply (a v5e estimate)."""
    name = type(plan).__name__
    if name in ("SellPlan", "SellPrice"):
        return _sell_seconds(plan)
    if name == "DiaPlan":
        return _dia_seconds(plan)
    if name == "HybridPlan":
        return (estimate_seconds(plan.dia) + estimate_seconds(plan.rest)
                + 10e-6)
    if name == "CachedPlan":
        t = estimate_seconds(plan.hot) + 10e-6
        if plan.cold is not None:
            t += estimate_seconds(plan.cold)
        return t
    if name == "CooTail":
        return (_NS_COO_FLOOR + _NS_PER_COO_NNZ * plan.nnz) * 1e-9
    if name == "PackedPlan":
        return _packed_seconds(plan)
    if name in ("ChunkPlan", "ChunkPrice"):
        return _chunk_seconds(plan)
    raise ValueError(f"no cost model for plan type {name}")


def _sell_seconds(plan) -> float:
    st = plan.stats
    slots = st.num_tiles * plan.positions * plan.lane_rows
    k = st.window_blocks
    if k > 0:
        per_slot = _NS_PER_SLOT_BASE + _NS_PER_SLOT_PER_K * max(k - 2, 0)
    else:
        # resident/deep select ladder: ~one pass per 128-lane x block,
        # bounded by the deep sweep's linear-in-blocks cost
        nb = -(-plan.shape[1] // 128)
        per_slot = _NS_PER_SLOT_BASE + _NS_PER_SLOT_PER_K * min(nb, 2048)
    steps = max(1, st.num_tiles // (8 * max(1, st.groups_per_step)))
    t = _NS_LAUNCH + slots * per_slot + steps * _NS_PER_GRID_STEP
    # epilogue
    if plan.identity_map or st.uniform_parts or st.group_slice_identity:
        t += 10e3
    else:
        slots_y = plan.slots_y if hasattr(plan, "slots_y") else \
            plan.row_map.shape[0]
        t += _NS_SEGSUM_FLOOR + _NS_PER_SEGSUM_SLOT * slots_y
    if st.double:
        t *= 2.5
    return t * 1e-9


def _dia_seconds(plan) -> float:
    vals = plan.vals
    # a bfloat16 slab is a torch tensor (numpy has no bfloat16 here)
    size = vals.element_size() if hasattr(vals, "element_size") \
        else np.dtype(vals.dtype).itemsize
    nbytes = int(np.prod(tuple(vals.shape))) * size
    steps = max(1, vals.shape[0])
    return (_NS_LAUNCH + nbytes / _BYTES_PER_NS
            + steps * _NS_PER_GRID_STEP) * 1e-9


def _chunk_seconds(plan) -> float:
    """ChunkPlan: per-tile cost ~ 15 + 5.2*K ns for window buckets,
    ~ 15 + 26*W ns for subwin buckets, plus the sorted partials fold
    (~9.4 ns/tile) and the fixed lane-perm/heavy epilogue (v5e)."""
    t = 0.0
    ttot = 0
    for b in plan.buckets:
        st = b.stats
        t += _NS_LAUNCH + st.num_tiles * (
            _NS_CHUNK_TILE + _NS_CHUNK_TILE_PER_K * st.window_blocks)
        ttot += st.num_tiles
    for h in plan.hbuckets:
        W = h.window_blocks
        t += _NS_LAUNCH + h.num_tiles * (
            _NS_CHUNK_TILE + _NS_SUBWIN_TILE_PER_W * W)
        ttot += h.num_tiles
    t += ttot * _NS_CHUNK_FOLD_TILE + _NS_CHUNK_EPILOGUE
    if plan.residue is not None:
        t += estimate_seconds(plan.residue) * 1e9
    return t * 1e-9


def _packed_seconds(plan) -> float:
    slots_a = int(np.prod(tuple(plan.vals.shape)))
    visits = int(plan.sblock.shape[0])
    t = (_NS_LAUNCH * 2 + slots_a * _NS_PER_SLOT_BASE * 2
         + visits * _NS_PER_PACKED_VISIT)
    novf = int(plan.ov_vals.shape[0])
    if novf:
        t += _NS_COO_FLOOR + _NS_PER_COO_NNZ * novf
    return t * 1e-9
