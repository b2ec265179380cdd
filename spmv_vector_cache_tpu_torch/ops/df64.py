"""Double-float (df64) pairs: the float64 <-> (hi, lo) float32 conversion
of the double plans (counterpart of ``spmv_vector_cache_tpu/ops/df64.py``).

The reference stores every float64 value as an unevaluated sum ``hi +
lo`` of two float32 numbers and computes with error-free transformations,
because TPU vector units are f32-only.  The H100 has native FP64, so the
port's kernels (J, K and L) read the same hi/lo slabs, join each pair in
registers into one ``double`` — exactly: the two significands span at
most 48 bits — and multiply and accumulate in FP64.  What stays here:

* :func:`split_f64` and :func:`join_f64`, the host-side numpy pair
  conversion the plan builders use, byte-equal to the reference's;
* :func:`split` and :func:`join`, the same on torch tensors (the pair
  API's shim), and :func:`join_channels`, which joins a plan's hi/lo
  slab into float64 values (the kernels' plain versions);
* :func:`two_sum`, :func:`quick_two_sum`, :func:`veltkamp_split`,
  :func:`two_prod`, :func:`add` and :func:`mul` on float32 tensors, for
  API parity with the reference; no kernel of the port uses them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: Veltkamp split constant for f32: 2^12 + 1 (24-bit significand -> 12+12)
_SPLIT = 4097.0

Pair = Tuple[torch.Tensor, torch.Tensor]


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Error-free sum: a + b = s + err exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Error-free sum assuming |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    return s, b - (s - a)


def veltkamp_split(a: torch.Tensor) -> Pair:
    """a = hi + lo with hi/lo each fitting 12 significand bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """Error-free product: a * b = p + err exactly (Dekker, 17 flops)."""
    p = a * b
    ah, al = veltkamp_split(a)
    bh, bl = veltkamp_split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def add(xh, xl, yh, yl) -> Pair:
    """df64 + df64 (accurate variant: both error terms folded)."""
    sh, se = two_sum(xh, yh)
    te, tf = two_sum(xl, yl)
    se = se + te
    sh, se = quick_two_sum(sh, se)
    se = se + tf
    return quick_two_sum(sh, se)


def mul(xh, xl, yh, yl) -> Pair:
    """df64 * df64 (the xl*yl term is below the result's precision)."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return quick_two_sum(ph, pe)


# ---------------------------------------------------------------------------
# float64 <-> (hi, lo) float32 pairs
# ---------------------------------------------------------------------------

def split_f64(a) -> Tuple[np.ndarray, np.ndarray]:
    """numpy float64 -> (hi, lo) float32 with a == hi + lo exactly
    (whenever a is representable as such a sum, i.e. |a| in f32 range)."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def join_f64(hi, lo) -> np.ndarray:
    """(hi, lo) f32 pair -> numpy float64 (host-side exact sum)."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def split(a: torch.Tensor) -> Pair:
    """:func:`split_f64` on a tensor, on its device: float64 -> (hi, lo)
    float32."""
    a = a.to(torch.float64)
    hi = a.to(torch.float32)
    return hi, (a - hi.to(torch.float64)).to(torch.float32)


def join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """:func:`join_f64` on tensors, on their device: (hi, lo) float32 ->
    float64, exact."""
    return hi.to(torch.float64) + lo.to(torch.float64)


def join_channels(vals: torch.Tensor) -> torch.Tensor:
    """A double plan's hi/lo slab, highs in channels [0:C] of axis 1 and
    lows in [C:2C] — SELL (T, 2P, R), DIA (T, 2D, S, 128) — as the
    float64 values (T, C, ...)."""
    c = vals.shape[1] // 2
    return join(vals[:, :c], vals[:, c:])
