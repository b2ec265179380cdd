"""Carry plans across from the JAX package and back to numpy.

:func:`plan_from_reference` reads a ``spmv_vector_cache_tpu`` plan's
arrays with ``np.asarray`` — it never imports jax or the JAX package, it
only reads the object it is given — and returns the port's plan with its
arrays on ``device``.  :func:`plan_to_numpy` turns a port plan's tensors
back into numpy arrays, for byte-for-byte comparisons in tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .formats.cached import CooTail
from .formats.dia import DiaPlan, DiaStats, HybridPlan
from .formats.plan import PlanStats, SellPlan, place


def _host(plan_ref):
    """The reference plan as a port plan with numpy arrays."""
    kind = type(plan_ref).__name__
    if kind == "HybridPlan":
        return HybridPlan(dia=_host(plan_ref.dia), rest=_host(plan_ref.rest))
    if kind == "SellPlan":
        return SellPlan(
            **{f: np.asarray(getattr(plan_ref, f))
               for f in ("vals", "cols", "cols_win", "tile_slice",
                         "window_base", "row_map", "window_rows")},
            shape=tuple(plan_ref.shape), lane_rows=plan_ref.lane_rows,
            positions=plan_ref.positions,
            identity_map=plan_ref.identity_map,
            stats=PlanStats(**plan_ref.stats.as_dict()))
    if kind == "DiaPlan":
        return DiaPlan(vals=np.asarray(plan_ref.vals),
                       offsets=tuple(int(o) for o in plan_ref.offsets),
                       shape=tuple(plan_ref.shape),
                       sublanes=plan_ref.sublanes,
                       pad_left=plan_ref.pad_left, x_rows=plan_ref.x_rows,
                       stats=DiaStats(**plan_ref.stats.as_dict()),
                       double=plan_ref.double)
    if kind == "CooTail":
        return CooTail(vals=np.asarray(plan_ref.vals),
                       cols=np.asarray(plan_ref.cols),
                       rows_idx=np.asarray(plan_ref.rows_idx),
                       shape=tuple(plan_ref.shape))
    raise NotImplementedError(f"{kind} is not ported yet (ROADMAP.md "
                              f"queue 1)")


def plan_from_reference(plan_ref, device="cpu"):
    """A SellPlan, DiaPlan, HybridPlan or CooTail of the JAX package as
    the port's plan, its arrays on ``device``."""
    return place(_host(plan_ref), torch.device(device))


def plan_to_numpy(plan):
    """The port plan with every tensor field as a host numpy array."""
    changes = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.cpu().numpy()
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            changes[f.name] = plan_to_numpy(v)
    return dataclasses.replace(plan, **changes)
