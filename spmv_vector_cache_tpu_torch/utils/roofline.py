"""Roofline observatory: measured speed of light and kernel audits
(counterpart of ``spmv_vector_cache_tpu/utils/roofline.py``).

An achieved-against-peak audit where the peak is measured on the spot
(:func:`measure_stream_bandwidth`) rather than read from a data sheet:
cards run at other power limits and clocks.  Timing is synchronised by a
host read of one element of the result, as in the reference.

In eager PyTorch the chained run of :func:`time_marginal` is a Python
loop of launches, not one compiled program, so its per-iteration time is
host wall time: for a kernel longer than its launch the host runs ahead
and the marginal is the device time; for a short apply it is the host's
dispatch cost.  Kernel times in ``chip_smoke.py`` come from CUDA events.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .stats import StatRegistry
from .stream import checksum_stream

Array = Any


def sync(x) -> float:
    """Force completion of everything producing ``x``; returns one value."""
    if isinstance(x, torch.Tensor):
        return float(x.reshape(-1)[0].item())
    return float(np.asarray(x).ravel()[0])


def time_chained(make_fn: Callable[[], Any], *, iters: int,
                 repeats: int = 3) -> float:
    """Time ``make_fn`` (a callable that chains ``iters`` dependent steps
    and returns a small tensor).  Returns seconds/step, best of
    ``repeats``."""
    sync(make_fn())  # build + warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        sync(make_fn())
        best = min(best, time.perf_counter() - t0)
    return best / iters


#: the least time :func:`time_marginal` returns: a marginal lost in the
#: noise even on the longer chains.  A time at this floor is not a
#: measurement, and no rate is computed from it (:func:`at_floor`)
TIMING_FLOOR = 1e-12


def at_floor(seconds: float) -> bool:
    """Whether a time from :func:`time_marginal` is its floor."""
    return seconds <= TIMING_FLOOR


def time_marginal(make_chain: Callable[[int], Callable[[], Any]],
                  i1: int = 30, i2: int = 90, repeats: int = 3) -> float:
    """Per-iteration time free of fixed call and sync costs: the two-point
    difference ``(T(i2) - T(i1)) / (i2 - i1)`` of ``make_chain(iters)``,
    a nullary callable running ``iters`` chained steps.  A marginal lost
    in call-to-call variance is measured again on chains 8x longer; one
    lost there too returns :data:`TIMING_FLOOR`."""
    f1, f2 = make_chain(i1), make_chain(i2)
    t1 = time_chained(lambda: f1(), iters=1, repeats=repeats)
    t2 = time_chained(lambda: f2(), iters=1, repeats=repeats)
    dt = (t2 - t1) / (i2 - i1)
    if dt <= 1e-9:
        f1, f2 = make_chain(8 * i1), make_chain(8 * i2)
        t1 = time_chained(lambda: f1(), iters=1, repeats=repeats)
        t2 = time_chained(lambda: f2(), iters=1, repeats=repeats)
        dt = (t2 - t1) / (8 * (i2 - i1))
    return max(dt, TIMING_FLOOR)


#: tiles one checksum of the read probe covers at most (64 tiles of
#: (8, 128) float32: 256 KiB, one CTA of kernel N)
PROBE_BLOCK_TILES = 64


def measure_stream_bandwidth(nbytes: int = 256 << 20, mode: str = "read",
                             device="cuda") -> float:
    """Measured device-memory streaming bandwidth in bytes/s.

    ``mode='read'``: kernel N's checksum of an ``nbytes`` float32 buffer,
    (T, 8, 128) tiles in blocks of up to 64 tiles: a read-only stream,
    the speed-of-light bound of SpMV, whose hot traffic is reads.
    ``'readwrite'``: an in-place scale (``x.mul_``), which reads and
    writes each element once, 2 bytes moved per byte.  The default 256
    MiB is larger than the H100's 50 MB L2, so the probe measures device
    memory.  Runs on ``device``, the card unless the caller asks for the
    CPU (where kernel N's plain version runs)."""
    if mode not in ("read", "readwrite"):
        raise ValueError(f"mode must be 'read' or 'readwrite', got {mode!r}")
    tiles = max(1, nbytes // 4096)
    n = tiles * 1024
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(n, generator=gen, device=device)

    if mode == "read":
        data = x.view(tiles, 8, 128)
        block = math.gcd(tiles, PROBE_BLOCK_TILES)

        def make(iters):
            def go():
                for _ in range(iters):
                    out = checksum_stream(data, block)
                return out[:1]
            return go
        bytes_per_iter = n * 4
    else:
        def make(iters):
            def go():
                for _ in range(iters):
                    x.mul_(1.0000001)
                return x[:1]
            return go
        bytes_per_iter = 2 * n * 4

    dt = time_marginal(make, i1=50, i2=150)
    return bytes_per_iter / dt


def spmv_roofline_nnz_per_s(stream_bw: float, bytes_per_nnz: float = 8.0
                            ) -> float:
    """Speed-of-light nnz/s for a streaming SpMV (vals + cols per nnz)."""
    return stream_bw / bytes_per_nnz


def audit(stats: StatRegistry, *, nnz: int, seconds: float,
          bytes_moved: float, stream_bw: Optional[float] = None) -> Dict:
    """Record an achieved-vs-peak audit into ``stats`` (CSV-able)."""
    gnnz = nnz / seconds / 1e9
    achieved_bw = bytes_moved / seconds
    stats["seconds"] = seconds
    stats["gnnz_per_s"] = gnnz
    stats["achieved_gb_per_s"] = achieved_bw / 1e9
    if stream_bw:
        stats["peak_gb_per_s"] = stream_bw / 1e9
        stats["roofline_fraction"] = achieved_bw / stream_bw
    return stats.as_dict()
