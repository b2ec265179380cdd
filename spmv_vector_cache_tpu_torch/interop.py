"""Carry plans and parameters across from the JAX package and back to
numpy.

:func:`plan_from_reference` reads a ``spmv_vector_cache_tpu`` plan's
arrays with ``np.asarray`` — it never imports jax or the JAX package, it
only reads the object it is given — and returns the port's plan with its
arrays on ``device``.  :func:`gcn_params_from_reference` does the same
for the GCN parameters of the reference's ``init_gcn_params``.
:func:`plan_to_numpy` turns a port plan's tensors back into numpy
arrays, for byte-for-byte comparisons in tests.

Value arrays cross as the port holds them: a JAX bfloat16 array (an
``ml_dtypes`` array on the host) by its bits, viewed as uint16 and then
as a ``torch.bfloat16`` tensor, so neither side needs ``ml_dtypes``; an
int64 or uint64 plan's values (the reference's host plan keeps 64 bits,
its device plan 32) as int32 or uint32 after a range check
(``formats.plan.host_values``); the float16 and narrow integer slabs as
they are; and a bfloat16 tensor back to numpy as its uint16 bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .formats.cached import CachedPlan, CooTail
from .formats.chunk import ChunkPlan, ChunkStats, SubwinPlan
from .formats.dia import DiaPlan, DiaStats, HybridPlan
from .formats.packed import PackedPlan, PackedStats
from .formats.plan import (PlanStats, SellPlan, host_values, map_arrays,
                           place)
from .formats.tables import table_names
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
#: the fields of a plan that hold matrix values
_VALUE_FIELDS = ("vals", "ov_vals", "window_mask")


def _array(v, field: str):
    """A reference array as the port holds it on the host."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)) \
            .view(torch.bfloat16)
    if a.dtype in (np.int64, np.uint64) and field in _VALUE_FIELDS:
        return host_values(a, a.dtype)
    return a


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
        raise NotImplementedError(f"{kind}: the port has no such plan "
                                  f"(MergeSellPlan is not ported by design)")
    cls = _PLANS[kind]
    kw = {}
    tables = table_names(cls)           # the port's own, built on placing
    for f in dataclasses.fields(cls):
        if f.name in tables:
            continue
        v = getattr(plan_ref, f.name)
        if f.name == "stats":
            v = _STATS[kind](**v.as_dict())
        elif f.name in ("shape", "c_shape"):
            v = tuple(v)
        elif f.name == "offsets":
            v = tuple(int(o) for o in v)
        elif getattr(v, "ndim", 0) >= 1:        # a numpy or JAX array
            v = _array(v, f.name)
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
    return map_arrays(plan, _numpy)


def _numpy(v):
    """A plan field as numpy: a bfloat16 tensor as its uint16 bits (numpy
    has no bfloat16 here, and ``.numpy()`` of one raises)."""
    if not isinstance(v, torch.Tensor):
        return v
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy().view(np.uint16)
    return v.numpy()


def gcn_params_from_reference(params_ref, device="cuda"):
    """The reference's GCN parameters, a list of ``(W, b)`` arrays (from
    its ``init_gcn_params``, as JAX or numpy arrays), as the port's list
    of ``(W, b)`` tensors on ``device`` (the card unless the caller asks
    for ``"cpu"``): the same values, so both packages compute the same
    forward."""
    return [tuple(torch.from_numpy(np.array(v)).to(device) for v in layer)
            for layer in params_ref]
