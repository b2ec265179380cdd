"""Semirings as torch ops (counterpart of
``spmv_vector_cache_tpu/ops/semiring.py``).

Each semiring is (add, mul, zero) over float tensors; the boolean
semiring runs on a {0.0, 1.0} float encoding (and = *, or = max), so
every semiring lowers to float mul/add/min/max — in the plain versions
here and in the CUDA kernels alike.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

#: kernel codes shared with ``csrc/semiring.cuh``
KERNEL_CODE = {"plus_times": 0, "min_plus": 1, "max_plus": 2,
               "max_times": 3, "or_and": 4}


@dataclasses.dataclass(frozen=True)
class Semiring:
    """(add, mul, zero); ``add`` is associative and commutative, ``zero``
    its identity and the annihilator of ``mul``."""

    name: str
    add: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    zero: float
    #: only a semiring on the non-negative reals (zero must annihilate
    #: under mul); plan builders reject negative matrix values
    requires_nonnegative: bool = False

    def segment_reduce(self, values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
        """Reduce ``values`` along dim 0 by segment with this semiring's
        ``add``.  Empty segments get what ``jax.ops.segment_*`` gives
        them: 0 (sum), -inf (max), +inf (min), and 0 for or_and."""
        shape = (num_segments,) + tuple(values.shape[1:])
        if self.name == "plus_times":
            out = torch.zeros(shape, dtype=values.dtype, device=values.device)
            return out.index_add_(0, segment_ids, values)   # int32 or int64
        ids = segment_ids.long()                # scatter_reduce_ needs int64
        if self.name == "or_and":
            # max over the int32 truncation, then clamp: an empty segment
            # reads as False, as in the JAX package
            v = values.to(torch.int32)
            m = torch.full(shape, torch.iinfo(torch.int32).min,
                           dtype=torch.int32, device=values.device)
            m = m.scatter_reduce_(0, _expand(ids, v), v, "amax")
            return (m > 0).to(values.dtype)
        if self.name in ("max_times", "max_plus"):
            init, how = -torch.inf, "amax"
        elif self.name == "min_plus":
            init, how = torch.inf, "amin"
        else:
            raise NotImplementedError(f"segment reduce for semiring {self.name}")
        out = torch.full(shape, init, dtype=values.dtype, device=values.device)
        return out.scatter_reduce_(0, _expand(ids, values), values, how)


def _expand(ids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return ids.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)


def _sum(a, dim):
    return torch.sum(a, dim=dim)


def _amax(a, dim):
    return torch.amax(a, dim=dim)


def _amin(a, dim):
    return torch.amin(a, dim=dim)


def kernel_ops(name: str):
    """(mul, axis_reduce) float ops of the SELL kernels' plain versions."""
    if name == "plus_times":
        return torch.mul, _sum
    if name == "min_plus":
        return torch.add, _amin
    if name == "max_plus":
        return torch.add, _amax
    if name in ("max_times", "or_and"):
        return torch.mul, _amax
    raise NotImplementedError(f"kernel ops for semiring {name}")


PLUS_TIMES = Semiring("plus_times", add=torch.add, mul=torch.mul, zero=0.0)
# tropical semirings: shortest/longest path relaxations
MIN_PLUS = Semiring("min_plus", add=torch.minimum, mul=torch.add,
                    zero=float("inf"))
MAX_PLUS = Semiring("max_plus", add=torch.maximum, mul=torch.add,
                    zero=float("-inf"))
MAX_TIMES = Semiring("max_times", add=torch.maximum, mul=torch.mul, zero=0.0,
                     requires_nonnegative=True)
# boolean semiring: reachability / graph pattern matching
OR_AND = Semiring("or_and", add=torch.logical_or, mul=torch.logical_and,
                  zero=0.0, requires_nonnegative=True)

REGISTRY = {s.name: s for s in
            (PLUS_TIMES, MIN_PLUS, MAX_PLUS, MAX_TIMES, OR_AND)}


def get(name_or_semiring) -> Semiring:
    if isinstance(name_or_semiring, Semiring):
        return name_or_semiring
    return REGISTRY[name_or_semiring]
