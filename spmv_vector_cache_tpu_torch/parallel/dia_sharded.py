"""Sharded DIA SpMV: row-partitioned diagonal plans with halo exchange
(counterpart of ``spmv_vector_cache_tpu/parallel/dia_sharded.py``).

A row block [d*rps, (d+1)*rps) only needs x entries within the diagonal
span of its own rows, so each shard takes one left and one right halo of
``halo = round128(max |offset|)`` entries from its ring neighbours:
O(band) bytes moved between shards instead of the O(n) all-gather of
the general SELL path (``spmv_sharded.py``).  Each shard then runs
kernel M (``ops/spmv_dia.py``, :func:`spmv_dia_halo_kernel`), the DIA
kernel with its x origin at the left halo: its build for the plan's
value type (``ops/semiring.py``'s policy; bfloat16 summed in float32, y
float32, where the reference rounds x to bfloat16 and sums in bfloat16,
ROADMAP.md queue 3).  A narrow plan's y (float16, int8, uint8, int16,
uint16) is narrowed once, after the shards' rows are joined.

Ring wrap-around at the edge shards delivers the other end's values into
the halo, but every value slot referencing out-of-matrix columns is zero
by construction, so the wrapped entries multiply to zero.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..formats.dia import DIA, csr_to_dia
from ..formats.plan import (_as_csr, _round_up, build_dtype, finish_values,
                            host_values, value_kind)
from ..ops import semiring as sr
from ..ops.spmv_dia import spmv_dia_halo_kernel
from ..ops.spmv_sell import check_x_length
from .mesh import (Mesh, device_scope, place_on_mesh, shard_vector,
                   with_halos)

Array = Any


@dataclasses.dataclass(frozen=True)
class ShardedDiaPlan:
    """D-shard stack of DIA tile plans (uniform shapes).

    ``vals``: (num_shards, T, D, S, 128) on the host; once placed
    (:func:`~.mesh.place_on_mesh`), a tuple of num_shards (T, D, S, 128)
    tensors, shard d on ``mesh.devices[d]``.  ``offsets`` are shared by
    every shard.  ``halo``: per-side x halo width (multiple of 128, >=
    max |offset|).  ``x_rows``: the reference's local x image height
    (kept for byte-equal plans; kernel M reads the halo'd x directly).
    """

    vals: Array
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    num_shards: int
    rows_per_shard: int
    sublanes: int
    halo: int
    x_rows: int

    _array_fields = ("vals",)


def build_sharded_dia_plan(a, num_shards: int, *, sublanes: int = 64,
                           value_dtype=np.float32) -> ShardedDiaPlan:
    """Partition rows into ``num_shards`` blocks, one DIA plan each.

    Requires a square matrix (row-partitioned x) whose diagonal span fits
    one shard (``halo <= rows_per_shard``), and values of any type of
    ``formats.plan.value_kind`` but float64."""
    if value_kind(value_dtype) == "f64":
        raise NotImplementedError(
            "value_dtype float64: sharded DIA plans run every value type "
            "but float64; double plans run unsharded, "
            "from_matrix(a, value_dtype=np.float64) (the reference builds "
            "no double sharded plan to hold one against)")
    if not isinstance(a, DIA):
        a = csr_to_dia(_as_csr(a))
    rows, cols = a.shape
    if rows != cols:
        raise ValueError("sharded DIA requires a square matrix "
                         "(x is row-partitioned like y)")
    offsets = tuple(int(o) for o in np.asarray(a.offsets))
    span = max((abs(o) for o in offsets), default=0)
    halo = _round_up(span, 128) if span else 0

    RS = sublanes * 128
    rps = _round_up(_round_up(rows, num_shards) // num_shards, RS)
    if halo > rps:
        raise ValueError(
            f"diagonal span {span} exceeds rows_per_shard {rps}; "
            "use fewer shards or the all-gather SELL path")
    data = host_values(a.data, value_dtype)
    T = rps // RS
    D = len(offsets)
    vdt = build_dtype(value_dtype)
    vals = np.zeros((num_shards, T, D, sublanes, 128), vdt)
    for d in range(num_shards):
        r0, r1 = min(d * rps, rows), min((d + 1) * rps, rows)
        if r1 > r0:
            block = np.zeros((D, rps), vdt)
            block[:, :r1 - r0] = data[:, r0:r1]
            vals[d] = block.reshape(D, T, sublanes, 128).transpose(1, 0, 2, 3)

    # the reference's local x image: pad_left = halo, then rps + halo
    # columns, plus its kernel's load overhang
    max_rowq = max((8 * ((halo + o) // 1024) for o in offsets), default=0)
    x_rows = max(T * sublanes + max_rowq + sublanes + 8,
                 (halo + rps + halo + 127) // 128)
    return ShardedDiaPlan(vals=finish_values(vals, value_dtype),
                          offsets=offsets, shape=(rows, cols),
                          num_shards=num_shards, rows_per_shard=rps,
                          sublanes=sublanes, halo=halo, x_rows=x_rows)


def spmv_dia_sharded(sp: ShardedDiaPlan, x: Array, mesh: Mesh, *,
                     axis: str = "x") -> torch.Tensor:
    """Distributed ``y = A @ x``, x and y row-sharded over the mesh.

    The exchange is two halo copies of ``halo`` entries per shard.  A
    plan not yet on ``mesh`` is placed there first (place it once with
    :func:`~.mesh.place_on_mesh` to apply it many times).  ``axis`` is
    accepted for the reference's signature.  Returns y on
    ``mesh.devices[0]``.  x must have the plan's column count
    (``ValueError``)."""
    check_x_length(x, sp.shape[1])
    sp = place_on_mesh(sp, mesh)
    D, rps, halo = sp.num_shards, sp.rows_per_shard, sp.halo
    vdt = sp.vals[0].dtype
    xs = shard_vector(sr.as_x(torch.as_tensor(x), vdt), sr.x_dtype(vdt), D,
                      rps, mesh)
    ys = []
    for d, dev in enumerate(mesh.devices):
        # one shard's SpMV: kernel M, its x origin at the left halo
        with device_scope(dev):
            x_ext = with_halos(xs, d, halo, dev) if halo else xs[d]
            y = spmv_dia_halo_kernel(sp.vals[d], sp.offsets, x_ext, rps,
                                     halo)
            ys.append(y.to(mesh.devices[0]))
    return sr.finish_y(torch.cat(ys)[:sp.shape[0]], vdt)
