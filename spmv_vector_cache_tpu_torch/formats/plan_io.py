"""Plan serialization: save/load SELL plans (and their config identity);
counterpart of ``spmv_vector_cache_tpu/formats/plan_io.py``.

The reference encodes each built variant's configuration into artifact
names — ``suffix = [cms-][nb<maxMiss>-]<ocmDepth>-<issueWindow>``
(``chisel/spmv-common/spmv-common.scala:36-40``) — and reuses synthesized
bitfiles across runs.  The analog here: a plan is the expensive
preprocessing artifact; it serializes to one ``.npz`` with a config
suffix in its metadata, so repeated runs skip planning.  The files are
the JAX package's: a plan saved by either package loads in the other.
:func:`save_plan` takes a host plan or a placed one (its tensors are
copied back to numpy); :func:`load_plan` returns a host plan, which
``formats.plan.place`` or ``SparseOperator(plan)`` puts on a device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .plan import PlanStats, SellPlan, compute_cols_win, compute_window_rows

# v3: + window_rows array, double (T, 2P, R) vals layout
_FORMAT_VERSION = 3

#: the arrays of a SellPlan, in the order of the reference's pytree
_ARRAY_FIELDS = ("vals", "cols", "cols_win", "tile_slice", "window_base",
                 "row_map", "window_rows")


def config_suffix(plan) -> str:
    """Human-readable config identity (the artifact-suffix role).  As in
    the reference, a ChunkPlan or a sharded plan has none
    (``AttributeError``)."""
    name = type(plan).__name__
    if name == "CooTail":
        return f"coo{plan.nnz}"
    if name == "DiaPlan":
        return f"dia{len(plan.offsets)}"
    if name == "HybridPlan":
        return f"hybrid-{config_suffix(plan.dia)}-{config_suffix(plan.rest)}"
    if name == "CachedPlan":
        suffix = f"hot{plan.hot_cols.shape[0]}"
        return suffix if plan.cold is None else \
            f"{suffix}-{config_suffix(plan.cold)}"
    if name == "PackedPlan":
        return f"packed{plan.sblock.shape[0]}"
    s = plan.stats
    parts = [f"k{s.window_blocks}" if s.window_blocks else "stream",
             f"g{s.groups_per_step}",
             f"{plan.positions}x{plan.lane_rows}"]
    if s.num_stripes > 1:
        parts.insert(0, f"stripe{s.num_stripes}")
    if s.num_splits:
        parts.insert(0, f"split{s.num_splits}")
    return "-".join(parts)


def _numpy(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_plan(plan: SellPlan, path: str) -> str:
    """Write a SellPlan (host or placed) to ``path`` (``.npz``); any
    other plan raises ``ValueError``, as in the reference."""
    if not isinstance(plan, SellPlan):
        raise ValueError(f"save_plan writes SellPlans, not "
                         f"{type(plan).__name__}")
    meta = {
        "version": _FORMAT_VERSION,
        "shape": list(plan.shape),
        "lane_rows": plan.lane_rows,
        "positions": plan.positions,
        "identity_map": bool(plan.identity_map),
        "stats": plan.stats.as_dict(),
        "suffix": config_suffix(plan),
    }
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{name: _numpy(getattr(plan, name)) for name in _ARRAY_FIELDS})
    return path


def load_plan(path: str) -> SellPlan:
    """Read a SellPlan of format version 1, 2 or 3 as a host plan (numpy
    arrays); older versions get their ``cols_win`` and ``window_rows``
    computed as the reference computes them."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["version"] not in (1, 2, _FORMAT_VERSION):
            raise ValueError(f"unsupported plan version {meta['version']}")
        arrays = {name: z[name] for name in _ARRAY_FIELDS if name in z}
    stats = PlanStats(**meta["stats"])
    if "cols_win" not in arrays:        # version-1 plans predate cols_win
        arrays["cols_win"] = compute_cols_win(
            arrays["vals"] != stats.pad_value, arrays["cols"],
            arrays["window_base"], stats.window_blocks, stats.group_tiles,
            stats.window_grain)
    if "window_rows" not in arrays:     # version <=2 plans predate these
        arrays["window_rows"] = compute_window_rows(
            arrays["window_base"], stats.window_blocks, meta["shape"][1],
            stats.window_grain)
    return SellPlan(shape=tuple(meta["shape"]), lane_rows=meta["lane_rows"],
                    positions=meta["positions"],
                    identity_map=meta["identity_map"], stats=stats,
                    **arrays)
