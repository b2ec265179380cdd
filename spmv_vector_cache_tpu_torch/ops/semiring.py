"""Semirings as torch ops (counterpart of
``spmv_vector_cache_tpu/ops/semiring.py``).

Each semiring is (add, mul, zero) over float tensors; the boolean
semiring runs on a {0.0, 1.0} float encoding (and = *, or = max), so
every semiring lowers to float mul/add/min/max — in the plain versions
here and in the CUDA kernels alike.

The value policy of the ported plans, as the reference computes them: a
bfloat16 plan reads x, sums and returns y in float32 (:func:`x_dtype`);
an int32 or uint32 plan sums exactly in its own type, wrapping mod 2^32,
under plus_times, max_times and or_and only (the reference's infinite
zeros of min_plus and max_plus do not exist in an integer type).  The
plain versions and the epilogues compute in :func:`widen`'s types,
because torch has no uint32 add, max or ``index_add_``: uint32 as its
int32 view under plus_times (the same bits mod 2^32) and as int64 under
the max semirings, where :func:`kernel_ops`' product wraps mod 2^32;
:func:`narrow` returns the result to its type.

The narrow plans (:data:`NARROW`) read x rounded or wrapped to the value
type (:func:`as_x`, as the reference's cast does) and sum in 32 bits: a
float16 plan in float32, an int8, uint8, int16 or uint16 plan in int32,
its products wrapped to the value type before a max (:func:`kernel_ops`),
as the reference takes the max of products computed in the value type.
The sums travel in that 32-bit type through every kernel and epilogue;
:func:`finish_y` narrows y once at the end (:func:`y_dtype`): float16
rounded once, where the reference sums in float16 (ROADMAP.md queue 3),
the integers mod 2^8 or 2^16, which commutes with the wrapping sums, so
the integer y is the reference's exactly.
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
        ``add``, in ``values``' type.  Empty segments get what
        ``jax.ops.segment_*`` gives them: 0 (sum), the type's least value
        (max: -inf, INT_MIN, 0 for uint32), +inf (min), and 0 for
        or_and."""
        dtype = values.dtype
        return narrow(self._segment_reduce(widen(values, self.name),
                                           segment_ids, num_segments), dtype)

    def _segment_reduce(self, values, segment_ids, num_segments):
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
            init, how = init_value(self.name, values.dtype), "amax"
        elif self.name == "min_plus":
            init, how = torch.inf, "amin"
        else:
            raise NotImplementedError(f"segment reduce for semiring {self.name}")
        out = torch.full(shape, init, dtype=values.dtype, device=values.device)
        return out.scatter_reduce_(0, _expand(ids, values), values, how)


    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a (+) b`` in ``a``'s type (or_and's logical add yields bool,
        which returns to the {0, 1} encoding)."""
        return narrow(self.add(widen(a, self.name), widen(b, self.name)),
                      a.dtype)


#: the narrow value types: stored in their own width, summed in 32 bits
#: (float32 or int32) and narrowed once at the end
NARROW = {torch.float16: torch.float32, torch.int8: torch.int32,
          torch.uint8: torch.int32, torch.int16: torch.int32,
          torch.uint16: torch.int32}


def x_dtype(vals_dtype: torch.dtype) -> torch.dtype:
    """The type a plan with ``vals_dtype`` values sums in, and the
    kernels read x and write y in: float32 for a bfloat16 or float16
    plan, int32 for an int8, uint8, int16 or uint16 one, else the value
    type."""
    if vals_dtype == torch.bfloat16:
        return torch.float32
    return NARROW.get(vals_dtype, vals_dtype)


def y_dtype(vals_dtype: torch.dtype) -> torch.dtype:
    """The type an apply returns y in: a narrow plan's value type, else
    :func:`x_dtype`."""
    return vals_dtype if vals_dtype in NARROW else x_dtype(vals_dtype)


def as_x(x: torch.Tensor, vals_dtype: torch.dtype) -> torch.Tensor:
    """x as the kernels of a plan with ``vals_dtype`` values read it, in
    :func:`x_dtype`, contiguous: a narrow plan's x first cast to the
    value type (float16 rounded, the integers wrapped, as the
    reference's ``jnp.asarray(x, value_dtype)``), unless it is of that
    type already (one cast then, to the sum type)."""
    if vals_dtype in NARROW and x.dtype != vals_dtype:
        x = x.to(vals_dtype)
    return x.to(x_dtype(vals_dtype)).contiguous()


def finish_y(y: torch.Tensor, vals_dtype: torch.dtype,
             semiring: str = "plus_times") -> torch.Tensor:
    """An apply's sums, in :func:`x_dtype`, as it returns them
    (:func:`y_dtype`), by one cast: a float16 plan's rounded once, an
    integer one's narrowed mod 2^8 or 2^16 (torch's integer casts wrap).
    Under the max semirings an empty row's int32 least value first rises
    to the value type's, what the reference's segment max fills it
    with."""
    if vals_dtype not in NARROW or y.dtype == vals_dtype:
        return y
    if not vals_dtype.is_floating_point and semiring in ("max_times",
                                                         "or_and"):
        y = y.clamp(min=torch.iinfo(vals_dtype).min)
    return y.to(vals_dtype)


def widen(t: torch.Tensor, semiring: str = "plus_times") -> torch.Tensor:
    """``t`` in the type the plain versions compute it in: bfloat16 as
    float32 (exact), a narrow type as :func:`x_dtype`'s (exact), uint32
    as its int32 view under plus_times and as int64 under the max
    semirings; any other type as it is."""
    if t.dtype == torch.bfloat16:
        return t.float()
    if t.dtype in NARROW:
        return t.to(NARROW[t.dtype])
    if t.dtype == torch.uint32:
        return t.view(torch.int32) if semiring == "plus_times" \
            else t.to(torch.int64)
    return t


def narrow(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A result computed in :func:`widen`'s types, back in ``dtype``."""
    if t.dtype == dtype:
        return t
    if dtype == torch.uint32 and t.dtype == torch.int32:
        return t.view(torch.uint32)
    if dtype == torch.uint32 and t.dtype == torch.int64:
        t = t & 0xFFFFFFFF
    return t.to(dtype)


#: the signed type of each unsigned type torch supports only in part
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def signed(t: torch.Tensor) -> torch.Tensor:
    """A uint16, uint32 or uint64 ``t`` as its signed view of the same
    bits (for indexing and comparing them), any other as it is."""
    return t.view(_SIGNED[t.dtype]) if t.dtype in _SIGNED else t


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t.index_select(0, idx)`` for a 1-D ``idx``, else ``t[idx]``; a
    uint16, uint32 or uint64 ``t`` through its signed view (torch has no
    indexing of them on the card, and no ``index_select`` on the host)."""
    if t.dtype in _SIGNED:
        return take(signed(t), idx).view(t.dtype)
    return t.index_select(0, idx) if idx.dim() == 1 else t[idx]


def init_value(name: str, dtype: torch.dtype):
    """The empty sum of semiring ``name`` in ``dtype`` (or_and runs as
    max_times): what a split slice's pieces combine into, and an empty
    segment's max.  int64 stands for a widened uint32 (:func:`widen`)."""
    if name == "plus_times":
        return 0
    if name == "min_plus":
        return float("inf")
    if dtype.is_floating_point:
        return float("-inf")
    return 0 if dtype in (torch.uint32, torch.int64) else \
        torch.iinfo(dtype).min


def check_integer(name: str, dtype: torch.dtype) -> None:
    """An integer plan runs plus_times, max_times and or_and only."""
    if not dtype.is_floating_point and name in ("min_plus", "max_plus"):
        raise ValueError(
            f"integer plans run plus_times, max_times and or_and; got "
            f"{name!r}, whose zero is infinite (the reference casts it to "
            f"INT_MIN, ROADMAP.md queue 3)")


def _mul(a, b):
    p = torch.mul(a, b)
    # int64 holds a widened uint32 (widen): its product wraps mod 2^32
    return p & 0xFFFFFFFF if p.dtype == torch.int64 else p


def _expand(ids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    return ids.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)


def _sum(a, dim):
    return torch.sum(a, dim=dim)


def _amax(a, dim):
    return torch.amax(a, dim=dim)


def _amin(a, dim):
    return torch.amin(a, dim=dim)


def kernel_ops(name: str, vals_dtype: torch.dtype = torch.float32):
    """(mul, axis_reduce) ops of the SELL kernels' plain versions, for a
    plan with ``vals_dtype`` values: a narrow integer plan's products
    wrapped to its value type under the max semirings."""
    if name == "plus_times":
        return _mul, _sum
    if name == "min_plus":
        return torch.add, _amin
    if name == "max_plus":
        return torch.add, _amax
    if name in ("max_times", "or_and"):
        if vals_dtype in NARROW and not vals_dtype.is_floating_point:
            # torch's integer casts wrap; back to int32, sign-extended
            return (lambda a, b: torch.mul(a, b).to(vals_dtype).to(
                torch.int32)), _amax
        return _mul, _amax
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
