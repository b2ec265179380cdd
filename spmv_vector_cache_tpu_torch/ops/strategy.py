"""Strategy selection and plan-derived counters (counterpart of
``spmv_vector_cache_tpu/ops/strategy.py``; Sell, Dia, Hybrid, Cached,
CooTail, Chunk and Packed plans — the timing sweep ``autotune`` comes
with ``ops/tune.py``)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..formats.cached import CachedPlan, CooTail
from ..formats.chunk import ChunkPlan
from ..formats.dia import DiaPlan, HybridPlan
from ..formats.packed import PackedPlan
from ..formats.plan import DEEP_MAX_BLOCKS, RESIDENT_MAX_BLOCKS, SellPlan
from .spmv_sell import warn_stream


def _itemsize(arr) -> int:
    """Bytes per element of a numpy array or a torch tensor."""
    return arr.element_size() if hasattr(arr, "element_size") \
        else np.dtype(arr.dtype).itemsize


def select_strategy(plan) -> str:
    """Pick the execution strategy from plan structure counters (the
    reference's rule); picking 'stream' warns."""
    if isinstance(plan, ChunkPlan):
        return "chunk"
    if isinstance(plan, (DiaPlan, HybridPlan)):
        return "dia"
    if isinstance(plan, CachedPlan):
        return "cached"
    if isinstance(plan, PackedPlan):
        return "packed"
    if isinstance(plan, CooTail):
        return "coo"
    if not isinstance(plan, SellPlan):
        raise NotImplementedError(
            f"{type(plan).__name__} is not ported yet (ROADMAP.md queue 1)")
    if plan.stats.window_blocks > 0:
        return "window"
    nb = -(-plan.shape[1] // 128)
    if nb <= RESIDENT_MAX_BLOCKS:
        return "resident"
    if nb <= DEEP_MAX_BLOCKS:
        return "deep"
    warn_stream(plan)
    return "stream"


def plan_nnz(plan) -> int:
    """Populated nonzeros of any ported plan type."""
    if isinstance(plan, ChunkPlan):
        return plan.stats.nnz
    if isinstance(plan, HybridPlan):
        return plan_nnz(plan.dia) + plan_nnz(plan.rest)
    if isinstance(plan, CachedPlan):
        return plan_nnz(plan.hot) + (
            plan_nnz(plan.cold) if plan.cold is not None else 0)
    if isinstance(plan, CooTail):
        return plan.nnz
    return plan.stats.nnz


def plan_bytes_per_apply(plan, strategy: str = "auto") -> int:
    """Device-memory bytes one SpMV moves, as the reference counts them:
    the streamed plan arrays, the dense vector and the result."""
    if isinstance(plan, ChunkPlan):
        b = sum(plan_bytes_per_apply(bk, "window") for bk in plan.buckets)
        for h in plan.hbuckets:
            T = h.num_tiles
            it = _itemsize(h.vals)
            b += T * 1024 * (it + 2) + 3 * T * 8 * h.window_blocks * 128 * 4
        if plan.residue is not None:
            b += plan_bytes_per_apply(plan.residue)
        return b + (plan.shape[0] + plan.shape[1]) * 4
    if isinstance(plan, HybridPlan):
        return (plan_bytes_per_apply(plan.dia) +
                plan_bytes_per_apply(plan.rest, strategy))
    if isinstance(plan, CachedPlan):
        b = plan_bytes_per_apply(plan.hot)
        if plan.cold is not None:
            b += plan_bytes_per_apply(plan.cold)
        return b
    itemsize = _itemsize(plan.vals)
    rows, cols = plan.shape
    vec = (rows + cols) * itemsize
    if isinstance(plan, CooTail):
        return plan.nnz * (itemsize + 8) + vec
    if isinstance(plan, PackedPlan):
        st = plan.stats
        slots = st.num_tiles * 1024
        sps = st.step_tiles * 1024
        return (slots * (itemsize + 2)           # vals + cols|flag
                + slots * 4                      # scan S write
                + st.num_steps_b * sps * 4       # S re-read per visit
                + st.num_steps_b * 8192 * 2      # esrc tiles
                + st.num_steps_a * st.chunk_blocks * 128 * 4  # x windows
                + st.num_windows * 8192 * 4      # y write-back
                + st.overflow_nnz * 12 + vec)
    if isinstance(plan, DiaPlan):
        return int(np.prod(tuple(plan.vals.shape))) * itemsize + vec
    T, P, R = plan.vals.shape
    vals_b = T * P * R * itemsize
    if strategy == "auto":
        strategy = select_strategy(plan)
    st = plan.stats
    xw_b = 0
    if strategy == "window":
        idx_b = T * P * R * 2                    # int16 in-window offsets
        # the reference's xw prologue: x2d read + xw write + kernel read
        xw_b = 3 * (T // st.group_tiles) * st.window_blocks * 128 * 4
    elif strategy in ("resident", "deep"):
        idx_b = T * P * R * 4                    # global int32 cols
    else:
        idx_b = T * P * R * 4 * 3                # cols + gathered x (r+w)
    if st.group_fold and strategy in ("window", "resident"):
        partials_b = (T // st.group_tiles) * R * itemsize
        if not st.group_slice_identity:
            partials_b *= 3                      # + segment fold r/w
    else:
        partials_b = T * R * itemsize * 3        # kernel write + fold r/w
    return vals_b + idx_b + xw_b + partials_b + vec


def execution_counters(plan, strategy: str = "auto") -> Dict[str, int]:
    """Plan-derived work counters for one apply, as the reference counts
    them: grid steps, window switches, gather passes, select-merge ops,
    shift ops and the epilogue kind."""
    if isinstance(plan, ChunkPlan):
        out = {"grid_steps": 0, "window_switches": 0, "gather_passes": 0,
               "select_ops": 0, "shift_ops": 0, "epilogue_segsum": 1}
        for bk in plan.buckets:
            c = execution_counters(bk, "window")
            for k in out:
                out[k] += c.get(k, 0)
        for h in plan.hbuckets:
            T = h.num_tiles
            out["grid_steps"] += T // (8 * h.groups_per_step)
            out["gather_passes"] += T * h.window_blocks
            out["select_ops"] += T * max(0, h.window_blocks - 1)
            out["window_switches"] += T * 8
        return out
    if isinstance(plan, HybridPlan):
        c1 = execution_counters(plan.dia)
        c2 = execution_counters(plan.rest, strategy)
        return {k: c1.get(k, 0) + c2.get(k, 0)
                for k in set(c1) | set(c2)}
    if isinstance(plan, CachedPlan):
        c1 = execution_counters(plan.hot)
        c2 = execution_counters(plan.cold) if plan.cold is not None else {}
        out = {k: c1.get(k, 0) + c2.get(k, 0) for k in set(c1) | set(c2)}
        # the predicted hit and miss volumes of the hot set
        out["hot_hits"] = plan_nnz(plan.hot)
        out["cold_misses"] = plan_nnz(plan.cold) if plan.cold else 0
        return out
    if strategy == "auto":
        strategy = select_strategy(plan)
    if isinstance(plan, DiaPlan):
        return {
            "grid_steps": int(plan.vals.shape[0]),
            "gather_passes": 0,
            "shift_ops": int(plan.vals.shape[0] * plan.vals.shape[1]),
            "window_switches": 0,
            "select_ops": 0,
            "epilogue_segsum": 0,
        }
    if isinstance(plan, CooTail):
        return {
            "grid_steps": 0, "window_switches": 0,
            "gather_passes": plan.nnz, "select_ops": 0, "shift_ops": 0,
            "epilogue_segsum": 1,
        }
    if isinstance(plan, PackedPlan):
        st = plan.stats
        vregs_a = st.num_tiles                   # one (8,128) tile each
        vregs_b = st.num_steps_b * 8             # (64,128) output/visit
        return {
            "grid_steps": st.num_steps_a + st.num_steps_b,
            "window_switches": st.num_chunks,
            "gather_passes": vregs_a * st.chunk_blocks
            + vregs_b * st.step_tiles * 8,
            "select_ops": vregs_a * max(0, st.chunk_blocks - 1)
            + vregs_b * max(0, st.step_tiles * 8 - 1),
            "shift_ops": vregs_a * 7,            # segmented-scan stages
            "epilogue_segsum": int(st.overflow_nnz > 0),
        }
    st = plan.stats
    T = st.num_tiles
    ngroups = T // st.group_tiles
    vregs = T * plan.positions // 8              # (8,128) value tiles
    if strategy == "window":
        K = max(1, st.window_blocks)
        gathers = vregs * K
        selects = vregs * (K - 1)
        switches = ngroups
    elif strategy in ("resident", "deep"):
        nb = -(-plan.shape[1] // 128)
        gathers = vregs * nb
        selects = vregs * max(0, nb - 1)
        switches = 0
    else:                                        # stream: pre-gather
        gathers = st.nnz
        selects = 0
        switches = 0
    fold = st.group_fold and strategy in ("window", "resident")
    return {
        "grid_steps": T // (8 * st.groups_per_step),
        "window_switches": switches,
        "gather_passes": gathers,
        "select_ops": selects,
        "shift_ops": 0,
        "epilogue_segsum": int(not (fold and st.group_slice_identity)) +
        int(not plan.identity_map and not st.uniform_parts),
    }
