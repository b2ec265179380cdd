"""Strategy selection, plan-derived counters and the strategy sweep
(counterpart of ``spmv_vector_cache_tpu/ops/strategy.py``; Sell, Dia,
Hybrid, Cached, CooTail, Chunk and Packed plans).

:func:`autotune` times every strategy the reference deems feasible for a
plan and :func:`best_strategy` picks the fastest; on a card each apply
is timed by CUDA events (:func:`_time_device`), each strategy in two
rounds (:func:`_time_rounds`)."""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..formats.cached import CachedPlan, CooTail
from ..formats.chunk import ChunkPlan
from ..formats.dia import DiaPlan, HybridPlan
from ..formats.packed import PackedPlan
from ..formats.plan import DEEP_MAX_BLOCKS, RESIDENT_MAX_BLOCKS, SellPlan
from ..utils.stats import StatRegistry
from .spmv_sell import spmv_plan, warn_stream

Array = Any


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
        raise NotImplementedError(f"{type(plan).__name__}: the port runs "
                                  f"no such plan")
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
    the streamed plan arrays, the dense vector and the result.  The
    streamed values count at the slab's itemsize; x, y, the partials and
    the scan at the sum type's (``sum_size``: 4 bytes for a bfloat16,
    float16 or 8- or 16-bit integer plan, whose value stream alone
    narrows)."""
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
    sum_size = max(itemsize, 4)
    rows, cols = plan.shape
    vec = (rows + cols) * sum_size
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
        partials_b = (T // st.group_tiles) * R * sum_size
        if not st.group_slice_identity:
            partials_b *= 3                      # + segment fold r/w
    else:
        partials_b = T * R * sum_size * 3        # kernel write + fold r/w
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


@dataclasses.dataclass
class SweepResult:
    strategy: str
    seconds: float
    gnnz_per_s: float


#: applies run before the timed ones (the first carries the kernel build
#: and the placement's one-time work lists)
TIME_WARMUP = 3


def _time_device(fn: Callable[..., Any], *args, iters: int = 10) -> float:
    """Seconds per call of ``fn(*args)``.

    On a card: ``TIME_WARMUP`` calls, then ``iters`` calls, each between
    two CUDA events on the result's card, and the median of those
    times; only the calls are timed (a placed plan's work lists are built
    once, by ``place``, before any of them).  On the CPU: the reference's
    wall time over ``iters`` calls, synchronised by a host read of one
    element of the result."""
    y = fn(*args)
    if isinstance(y, torch.Tensor) and y.is_cuda:
        with torch.cuda.device(y.device):
            for _ in range(TIME_WARMUP):
                fn(*args)
            marks = []
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                marks.append((start, end))
            torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in marks) / 1e3
    float(y.reshape(-1)[0])                 # warm + sync
    t0 = time.perf_counter()
    for _ in range(iters):
        y = fn(*args)
    float(y.reshape(-1)[0])
    return (time.perf_counter() - t0) / iters


def _time_rounds(fns: Dict[str, Callable[[], Any]],
                 iters: int) -> Dict[str, float]:
    """Seconds per call of each of ``fns`` (name -> nullary callable):
    :func:`_time_device` in two rounds, the callables in order and then
    in reverse, each keeping the lower of its two medians, so that a
    drift of the card's clocks or of the host's state over a sweep
    favours no position."""
    items = list(fns.items())
    rounds: Dict[str, list] = {name: [] for name, _ in items}
    for order in (items, items[::-1]):
        for name, fn in order:
            rounds[name].append(_time_device(fn, iters=iters))
    return {name: min(t) for name, t in rounds.items()}


def feasible_strategies(plan) -> list:
    """The strategies :func:`autotune` times: the reference's rule, which
    lists the windowless ones under the v5e caps ``RESIDENT_MAX_BLOCKS``
    and ``DEEP_MAX_BLOCKS``.  A ChunkPlan, which the reference's rule
    omits (it reads a window width a ChunkPlan's stats lack), runs its
    one route, as the other plan types do."""
    if isinstance(plan, (DiaPlan, HybridPlan, CachedPlan, PackedPlan,
                         CooTail, ChunkPlan)):
        return ["dia" if isinstance(plan, DiaPlan) else "auto"]
    nb = -(-plan.shape[1] // 128)
    feasible = ["stream"]                # the explicit sweep measures it too
    if nb <= DEEP_MAX_BLOCKS:
        feasible.insert(0, "deep")
    if nb <= RESIDENT_MAX_BLOCKS:
        feasible.insert(0, "resident")
    if plan.stats.window_blocks > 0:
        feasible.insert(0, "window")
    return feasible


def autotune(plan, x: Array, *, iters: int = 10,
             stats: Optional[StatRegistry] = None,
             semiring: str = "plus_times") -> Dict[str, SweepResult]:
    """Measure every feasible strategy of a placed plan on ``x``'s device
    (:func:`_time_rounds`) and return the timings (fastest first is not
    implied).

    A strategy that the dispatcher refuses for this plan
    (``ValueError`` or ``NotImplementedError``, raised before any
    launch) is left out; anything else, a CUDA error included,
    propagates."""
    runs = {}
    for name in feasible_strategies(plan):
        def run(n=name):
            return spmv_plan(plan, x, strategy=n, semiring=semiring)
        try:
            run()
        except (ValueError, NotImplementedError):
            continue                     # refused before any launch
        runs[name] = run
    nnz = plan_nnz(plan)
    results: Dict[str, SweepResult] = {}
    for name, dt in _time_rounds(runs, iters).items():
        results[name] = SweepResult(
            strategy=name, seconds=dt,
            gnnz_per_s=nnz / dt / 1e9 if dt > 0 else 0.0)
    if stats is not None:
        for name, r in results.items():
            stats[f"{name}_seconds"] = r.seconds
            stats[f"{name}_gnnz_per_s"] = r.gnnz_per_s
    return results


def best_strategy(plan: SellPlan, x: Array, **kw) -> str:
    results = autotune(plan, x, **kw)
    if not results:
        return select_strategy(plan)
    return min(results.values(), key=lambda r: r.seconds).strategy
