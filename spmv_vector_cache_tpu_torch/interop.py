"""Carry plans and parameters across from the JAX package and back to
numpy.

:func:`plan_from_reference` reads a ``spmv_vector_cache_tpu`` plan's
arrays with ``np.asarray`` — it never imports jax or the JAX package, it
only reads the object it is given — and returns the port's plan with its
arrays on ``device``.  :func:`gcn_params_from_reference` does the same
for the GCN parameters of the reference's ``init_gcn_params``.
:func:`plan_to_numpy` turns a port plan's tensors back into numpy
arrays, for byte-for-byte comparisons in tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .formats.cached import CachedPlan, CooTail
from .formats.chunk import ChunkPlan, ChunkStats, SubwinPlan
from .formats.dia import DiaPlan, DiaStats, HybridPlan
from .formats.packed import PackedPlan, PackedStats
from .formats.plan import PlanStats, SellPlan, map_arrays, place
from .ops.spgemm import SpGemmPlan
from .ops.sptrsv import TriSolvePlan
from .parallel.dia_sharded import ShardedDiaPlan
from .parallel.mesh import make_mesh, place_on_mesh, stacked_numpy
from .parallel.spmv_sharded import ShardedPlan

#: port plan classes by the reference's class name, and their stats class
_PLANS = {cls.__name__: cls for cls in
          (SellPlan, DiaPlan, CooTail, SubwinPlan, PackedPlan, ShardedPlan,
           ShardedDiaPlan, SpGemmPlan, TriSolvePlan)}
_SHARDED = (ShardedPlan, ShardedDiaPlan)
_STATS = {"SellPlan": PlanStats, "DiaPlan": DiaStats,
          "PackedPlan": PackedStats}


def _host(plan_ref):
    """The reference plan as a port plan with numpy arrays."""
    kind = type(plan_ref).__name__
    if kind == "HybridPlan":
        return HybridPlan(dia=_host(plan_ref.dia), rest=_host(plan_ref.rest))
    if kind == "CachedPlan":
        return CachedPlan(
            hot=_host(plan_ref.hot),
            cold=None if plan_ref.cold is None else _host(plan_ref.cold),
            hot_cols=np.asarray(plan_ref.hot_cols),
            shape=tuple(plan_ref.shape), coverage=float(plan_ref.coverage))
    if kind == "ChunkPlan":
        return ChunkPlan(
            buckets=tuple(_host(b) for b in plan_ref.buckets),
            hbuckets=tuple(_host(h) for h in plan_ref.hbuckets),
            residue=(None if plan_ref.residue is None
                     else _host(plan_ref.residue)),
            perm_idx=np.asarray(plan_ref.perm_idx),
            heavy_rows=np.asarray(plan_ref.heavy_rows),
            shape=tuple(plan_ref.shape),
            stats=ChunkStats(**plan_ref.stats.as_dict()))
    if kind not in _PLANS:
        raise NotImplementedError(f"{kind} is not ported yet (ROADMAP.md "
                                  f"queue 1)")
    cls = _PLANS[kind]
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(plan_ref, f.name)
        if f.name == "stats":
            v = _STATS[kind](**v.as_dict())
        elif f.name in ("shape", "c_shape"):
            v = tuple(v)
        elif f.name == "offsets":
            v = tuple(int(o) for o in v)
        elif getattr(v, "ndim", 0) >= 1:        # a numpy or JAX array
            v = np.asarray(v)
        kw[f.name] = v
    return cls(**kw)


def plan_from_reference(plan_ref, device="cuda", *, mesh=None):
    """A SellPlan, DiaPlan, HybridPlan, CachedPlan, CooTail, ChunkPlan,
    PackedPlan, SpGemmPlan or TriSolvePlan of the JAX package as the
    port's plan, its arrays on
    ``device`` (the card unless the caller asks for ``"cpu"``; without a
    card, torch's placement raises).  A ShardedPlan or ShardedDiaPlan
    comes across with shard d on ``mesh.devices[d]`` (default: one shard
    per entry of ``make_mesh(num_shards, device=device)``)."""
    host = _host(plan_ref)
    if isinstance(host, _SHARDED):
        mesh = mesh or make_mesh(host.num_shards, device=device)
        return place_on_mesh(host, mesh)
    return place(host, torch.device(device))


def plan_to_numpy(plan):
    """The port plan with every tensor field as a host numpy array (a
    sharded plan's per-shard tensors stacked back into one array)."""
    if isinstance(plan, _SHARDED):
        return stacked_numpy(plan)
    return map_arrays(plan, lambda v: v.cpu().numpy()
                      if isinstance(v, torch.Tensor) else v)


def gcn_params_from_reference(params_ref, device="cuda"):
    """The reference's GCN parameters, a list of ``(W, b)`` arrays (from
    its ``init_gcn_params``, as JAX or numpy arrays), as the port's list
    of ``(W, b)`` tensors on ``device`` (the card unless the caller asks
    for ``"cpu"``): the same values, so both packages compute the same
    forward."""
    return [tuple(torch.from_numpy(np.array(v)).to(device) for v in layer)
            for layer in params_ref]
