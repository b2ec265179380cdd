"""SparseOperator — the user-facing handle (counterpart of
``spmv_vector_cache_tpu/ops/operator.py``).

The operator plans a matrix on the host once, places the plan's arrays
on a torch device once, and then applies it: ``op @ x``.

>>> op = SparseOperator.from_matrix(a)      # plans + places on the card
>>> y = op @ x                             # kernel SpMV
>>> op64 = SparseOperator.from_matrix(a, value_dtype=np.float64)
>>> y64 = op64 @ x                         # float64 y, FP64 kernels
>>> Y = op @ B                             # kernel SpMM, B: (cols, k)
>>> op_cpu = SparseOperator.from_matrix(a, device="cpu")   # plain versions
>>> op.audit(stream_bw=roofline.measure_stream_bandwidth())  # roofline
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from ..formats.cached import CachedPlan, CooTail
from ..formats.chunk import ChunkPlan
from ..formats.dia import HybridPlan
from ..formats.plan import auto_plan, place
from ..utils.stats import StatRegistry
from . import reference
from . import semiring as sr
from .spmm_sell import NoFusedSpmm, has_fused_spmm, is_double, spmm_plan
from .spmv_sell import spmv_plan
from .strategy import (execution_counters, plan_bytes_per_apply, plan_nnz,
                       select_strategy)

Array = Any


def _plan_device(plan) -> torch.device:
    if isinstance(plan, CachedPlan):
        return _plan_device(plan.hot)
    if isinstance(plan, HybridPlan):
        arr = plan.dia.vals
    elif isinstance(plan, ChunkPlan):
        arr = plan.perm_idx
    else:
        arr = plan.vals
    return arr.device if isinstance(arr, torch.Tensor) \
        else torch.device("cpu")


class SparseOperator:
    """A planned sparse matrix on one device, ready for repeated
    application."""

    def __init__(self, plan, strategy: str = "auto", matrix=None,
                 semiring: str = "plus_times"):
        self.plan = plan
        self.device = _plan_device(plan)
        self._matrix = matrix          # the host container, for SpMM
        self._matrix_on_device = None  # placed on the first fallback SpMM
        self.semiring = sr.get(semiring).name
        self.strategy = (select_strategy(plan) if strategy == "auto"
                         else strategy)
        stats_src = plan.dia if isinstance(plan, HybridPlan) else (
            plan.hot if isinstance(plan, CachedPlan) else plan)
        if isinstance(stats_src, CooTail):
            self.stats = StatRegistry({"nnz": stats_src.nnz})
        else:
            self.stats = StatRegistry(
                {k: v for k, v in stats_src.stats.as_dict().items()
                 if isinstance(v, (int, float))})
        for s in ("window", "dia", "resident", "deep", "cached", "packed",
                  "coo", "chunk"):
            self.stats[f"strategy_{s}"] = int(self.strategy == s)
        if isinstance(plan, CachedPlan):
            self.stats["cache_coverage"] = plan.coverage
            self.stats["cache_hot_cols"] = int(plan.hot_cols.shape[0])
        # plan-derived per-execution work counters: what one apply does
        for k, v in execution_counters(plan, self.strategy).items():
            self.stats[k] = v
        self.stats["bytes_per_apply"] = plan_bytes_per_apply(
            plan, self.strategy)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_matrix(cls, a, *, strategy: str = "auto",
                    value_dtype=np.float32, tune: bool = False,
                    semiring: str = "plus_times",
                    device="cuda", **plan_kwargs) -> "SparseOperator":
        """Plan ``a`` (any container) on the host, place the plan on
        ``device`` (the card unless the caller asks for ``"cpu"``; without
        a card, torch's placement raises) and select an execution
        strategy.  ``semiring`` selects the algebra; the plan's padding
        is built to match.  ``value_dtype=np.float64`` builds a double
        plan (plus_times): ``op @ x`` then returns a float64 y."""
        if tune:
            raise NotImplementedError("tune=True needs ops/tune.py, which "
                                      "is not ported yet (ROADMAP.md "
                                      "queue 1, item 13)")
        t0 = time.perf_counter()
        plan = auto_plan(a, value_dtype=value_dtype, semiring=semiring,
                         **plan_kwargs)
        t_plan = time.perf_counter() - t0
        op = cls(place(plan, torch.device(device)), strategy=strategy,
                 matrix=a, semiring=semiring)
        op.stats["plan_seconds"] = t_plan
        return op

    # -- application ------------------------------------------------------
    @property
    def shape(self):
        return self.plan.shape

    def _as_x(self, x) -> torch.Tensor:
        """The operand on the operator's device.  The kernels launch
        through ctypes and have no backward, as the reference's Pallas
        kernels have none (``jax.grad`` through them fails): an operand
        that requires a gradient while autograd records raises here,
        rather than leave a result cut off from the graph."""
        x = torch.as_tensor(x, device=self.device)
        if x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                "SparseOperator has no gradient: its kernels are not "
                "differentiable. Apply it under torch.no_grad(), to a "
                "detached operand, or use ops.reference.spmv / .spmm, "
                "which carry gradients to their dense operand")
        return x

    def matvec(self, x: Array) -> torch.Tensor:
        return spmv_plan(self.plan, self._as_x(x), strategy=self.strategy,
                         semiring=self.semiring)

    def matmat(self, b: Array) -> torch.Tensor:
        """Multi-RHS ``Y = A @ B``, B of shape (cols, k), plus_times only.

        A plan with a fused kernel (DIA, window SELL, Hybrid of those,
        COO tail) runs :func:`.spmm_sell.spmm_plan`; any other runs
        :func:`.reference.spmm` on the matrix the operator was built
        from, placed on the operator's device on first use.  The choice
        is made by plan type before anything runs, so a kernel's failure
        is never caught.  A double plan raises: there is no float64 SpMM.
        """
        if self.semiring != "plus_times":
            # the reference's SpMM ignores the semiring and returns a
            # plus-times product over the semiring's padding
            raise NotImplementedError(f"SpMM runs plus_times only; this "
                                      f"operator's semiring is "
                                      f"{self.semiring}")
        if is_double(self.plan):
            # the reference's SpMM reads a double plan's hi words only and
            # returns a float32 Y (ROADMAP.md queue 3)
            raise NotImplementedError("SpMM on a double-float plan is not "
                                      "ported: the reference has no "
                                      "float64 SpMM kernel (ROADMAP.md "
                                      "queue 3)")
        b = self._as_x(b).to(torch.float32).contiguous()
        if has_fused_spmm(self.plan):
            return spmm_plan(self.plan, b)
        if self._matrix is None:
            raise NoFusedSpmm(f"{type(self.plan).__name__} has no fused "
                              f"SpMM kernel and the operator holds no "
                              f"matrix to run reference.spmm on")
        if self._matrix_on_device is None:
            self._matrix_on_device = place(self._matrix, self.device)
        return reference.spmm(self._matrix_on_device, b)

    def __matmul__(self, x: Array) -> torch.Tensor:
        x = self._as_x(x)
        if x.dim() == 1:
            return self.matvec(x)
        return self.matmat(x)

    def exec(self, x: Array, y: Optional[Array] = None) -> np.ndarray:
        """Timed application with stat recording: returns ``y (+)= A @ x``
        on the host (the copy back synchronises with the device)."""
        t0 = time.perf_counter()
        out_host = self.matvec(x).cpu().numpy()
        dt = time.perf_counter() - t0
        if "first_exec_seconds" not in self.stats:
            # the first call carries the kernel build and load
            self.stats["first_exec_seconds"] = dt
        self.stats["spmvtime"] = dt
        self.stats["gnnz_per_s"] = plan_nnz(self.plan) / dt / 1e9
        if y is not None:
            out_host = out_host + np.asarray(y)
        return out_host

    def audit(self, x: Optional[Array] = None, *, iters: int = 20,
              stream_bw: Optional[float] = None) -> dict:
        """Achieved-against-peak roofline audit.

        Times a chain of dependent applies (each normalised by its norm
        on a square operator; a rectangular one carries the dependency
        through a negligible scalar) with the two-point marginal of
        ``iters`` and ``3 * iters`` applies, models the bytes one apply
        moves (``plan_bytes_per_apply``), and records Gnnz/s, achieved
        GB/s and, given ``stream_bw`` (bytes/s, e.g. from
        ``roofline.measure_stream_bandwidth``), the roofline fraction into
        ``self.stats``.  The marginal is host wall time per apply: the
        device's time where the card is the bottleneck, the host's
        dispatch cost where it is not (``utils/roofline.py``)."""
        from ..utils import roofline

        rows, cols = self.plan.shape
        if x is None:
            x = torch.ones(cols, dtype=torch.float32)
        x = self._as_x(x)
        square = rows == cols

        def make(n):
            def go():
                u = x
                for _ in range(n):
                    w = self.matvec(u)
                    if square:
                        u = w / torch.linalg.vector_norm(w).clamp(min=1e-30)
                    else:
                        u = u * (1 + w.reshape(-1)[0] * 1e-30)
                return u[:1]
            return go

        dt = roofline.time_marginal(make, i1=iters, i2=3 * iters)
        return roofline.audit(
            self.stats, nnz=plan_nnz(self.plan), seconds=dt,
            bytes_moved=plan_bytes_per_apply(self.plan, self.strategy),
            stream_bw=stream_bw)

    # -- verification -----------------------------------------------------
    def compare_golden(self, x: Array, golden: Array,
                       rtol: float = 1e-4, atol: float = 1e-4) -> int:
        """Count of entries outside tolerance vs a golden result."""
        y = self.matvec(x).cpu().numpy().astype(np.float64)
        g = np.asarray(golden, dtype=np.float64)
        bad = int((np.abs(y - g) > atol + rtol * np.abs(g)).sum())
        self.stats["diffFromGolden"] = bad
        return bad

    def __repr__(self):
        return (f"SparseOperator(shape={self.plan.shape}, "
                f"nnz={plan_nnz(self.plan)}, "
                f"strategy={self.strategy!r}, "
                f"plan={type(self.plan).__name__}, device={self.device})")
