"""A device mesh for the sharded plans, and their placement on it.

The JAX package runs its sharded SpMV as one controller over a
``jax.sharding.Mesh`` (``jax.shard_map``): shard d's arrays live on
device d, and ``ppermute`` and ``all_gather`` move x between them.  The
port keeps that model in one process.  A :class:`Mesh` is an explicit
tuple of torch devices, one per shard, repeats allowed: four shards on
one card is ``make_mesh(4, device="cuda")``, eight on the CPU (as the
tests run) ``make_mesh(8, device="cpu")``.  The collectives become tensor
copies between shards (``.to(device)``, a no-op between shards of one
device), so nothing here assumes one shard per device.  A shard's
kernels launch with its card made current (:func:`device_scope`): the
kernels go into the current device's stream, which must be the card
that holds the shard's tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.plan import _to_tensor
from ..formats.tables import table_names, work_list


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device per shard (``devices[d]`` holds shard d)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("x",)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = "x",
              device="cuda") -> Mesh:
    """``n_devices`` shards (default: one per visible device of
    ``device``'s type) dealt round-robin over the visible CUDA devices,
    over one CUDA device if ``device`` names its index, or all on the
    CPU.  Without a card, ``device="cuda"`` raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device: torch.cuda.device_count() "
                               "is 0 (pass device='cpu' to shard on the CPU)")
        avail = [torch.device("cuda", i) for i in range(count)]
    else:
        avail = [dev]
    n = n_devices or len(avail)
    return Mesh(tuple(avail[d % len(avail)] for d in range(n)), (axis,))


def device_scope(dev: torch.device):
    """A context that makes the CUDA device ``dev`` current, for the
    launches of one shard; nothing for a CPU shard."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def place_on_mesh(plan, mesh: Mesh):
    """The sharded plan with each array field as a tuple of per-shard
    tensors, shard d on ``mesh.devices[d]``; a plan already placed there
    comes back as it is.  A window ShardedPlan's shards get kernel H's
    work list here, once (its ``works``)."""
    from .spmv_sharded import ShardedPlan

    if mesh.size != plan.num_shards:
        raise ValueError(f"mesh of {mesh.size} devices for a plan of "
                         f"{plan.num_shards} shards")
    if not _on_mesh(plan, mesh):
        changes = dict.fromkeys(table_names(plan))
        for name in plan._array_fields:
            v = getattr(plan, name)
            changes[name] = tuple(_to_tensor(v[d], dev)
                                  for d, dev in enumerate(mesh.devices))
        plan = dataclasses.replace(plan, **changes)
    if isinstance(plan, ShardedPlan) and plan.window_blocks and \
            plan.works is None:
        plan = dataclasses.replace(plan, works=tuple(
            work_list(ts, plan.num_slices) for ts in plan.tile_slice))
    return plan


def _on_mesh(plan, mesh: Mesh) -> bool:
    for name in plan._array_fields:
        v = getattr(plan, name)
        if not isinstance(v, tuple) or any(
                t.device != dev for t, dev in zip(v, mesh.devices)):
            return False
    return True


def stacked_numpy(plan):
    """The sharded plan with each array field stacked back into one
    (num_shards, ...) host numpy array, as ``build_sharded_plan`` and
    ``build_sharded_dia_plan`` return it, and no tables."""
    changes = dict.fromkeys(table_names(plan))
    for name in plan._array_fields:
        v = getattr(plan, name)
        if isinstance(v, tuple):
            v = torch.stack([t.cpu() for t in v])
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            # numpy has no bfloat16 here: the bits, as plan_to_numpy
            v = v.view(torch.int16).numpy().view(np.uint16)
        changes[name] = np.asarray(v)
    return dataclasses.replace(plan, **changes)


def shard_vector(x, dtype: torch.dtype, num_shards: int, rows_per_shard: int,
                 mesh: Mesh) -> list:
    """x zero-padded to ``num_shards * rows_per_shard`` entries, row
    block d on ``mesh.devices[d]`` (a view, where it already lies there)."""
    x = torch.as_tensor(x)
    xp = x.new_zeros((num_shards * rows_per_shard,) + tuple(x.shape[1:]),
                     dtype=dtype)
    xp[:x.shape[0]] = x
    return [xp[d * rows_per_shard:(d + 1) * rows_per_shard].to(dev)
            for d, dev in enumerate(mesh.devices)]


def with_halos(xs: list, d: int, halo: int, device) -> torch.Tensor:
    """Shard d's x with both ring neighbours' halos attached: the last
    ``halo`` entries of shard d-1, shard d's own, the first ``halo`` of
    shard d+1 (the reference's two ``ppermute`` shifts; the edge shards
    receive the far end's entries, which only zero values read)."""
    D = len(xs)
    return torch.cat([xs[(d - 1) % D][-halo:].to(device), xs[d],
                      xs[(d + 1) % D][:halo].to(device)])
