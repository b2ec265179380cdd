"""Strategy selection and plan-derived counters (counterpart of
``spmv_vector_cache_tpu/ops/strategy.py``; Sell, Dia, Hybrid and CooTail
plans — the timing sweep ``autotune`` comes with ``ops/tune.py``)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..formats.cached import CooTail
from ..formats.dia import DiaPlan, HybridPlan
from ..formats.plan import DEEP_MAX_BLOCKS, RESIDENT_MAX_BLOCKS, SellPlan


def _itemsize(arr) -> int:
    """Bytes per element of a numpy array or a torch tensor."""
    return arr.element_size() if hasattr(arr, "element_size") \
        else np.dtype(arr.dtype).itemsize


def select_strategy(plan) -> str:
    """Pick the execution strategy from plan structure counters (the
    reference's rule; only 'window', 'dia' and 'coo' run in the port)."""
    if isinstance(plan, (DiaPlan, HybridPlan)):
        return "dia"
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
    return "stream"


def plan_nnz(plan) -> int:
    """Populated nonzeros of any ported plan type."""
    if isinstance(plan, HybridPlan):
        return plan_nnz(plan.dia) + plan_nnz(plan.rest)
    if isinstance(plan, CooTail):
        return plan.nnz
    return plan.stats.nnz


def plan_bytes_per_apply(plan, strategy: str = "auto") -> int:
    """Device-memory bytes one SpMV moves, as the reference counts them:
    the streamed plan arrays, the dense vector and the result."""
    if isinstance(plan, HybridPlan):
        return (plan_bytes_per_apply(plan.dia) +
                plan_bytes_per_apply(plan.rest, strategy))
    itemsize = _itemsize(plan.vals)
    rows, cols = plan.shape
    vec = (rows + cols) * itemsize
    if isinstance(plan, CooTail):
        return plan.nnz * (itemsize + 8) + vec
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
    if isinstance(plan, HybridPlan):
        c1 = execution_counters(plan.dia)
        c2 = execution_counters(plan.rest, strategy)
        return {k: c1.get(k, 0) + c2.get(k, 0)
                for k in set(c1) | set(c2)}
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
