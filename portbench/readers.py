"""Arithmetic the per-layer metric readers share.  Each reader returns
None where it finds nothing to read: no trace, no span, or a card with no
published peak."""

from __future__ import annotations

from typing import Optional

from portbench import common, work


def value_bytes(cfg) -> int:
    return common.DTYPES[cfg["value_dtype"]][1].itemsize


def span_device_s(ctx, name: str) -> Optional[float]:
    """Mean device seconds launched inside one span of ``name``."""
    tr = ctx.trace
    if tr is None or not tr.spans.get(name) or \
            not tr.device_s_by_span.get(name):
        return None
    return tr.device_s_by_span[name] / tr.spans[name]


def spmv_roofline_pct(ctx, name: str) -> Optional[float]:
    """The least time of one y = A x (each value once, x and y once, at
    the published HBM rate) over the device time of one span."""
    dev = span_device_s(ctx, name)
    if dev is None or ctx.peaks is None:
        return None
    s = ctx.stats
    nbytes = work.spmv_bytes(s["nnz"], s["rows"], s["cols"],
                             value_bytes(ctx.cfg),
                             int(ctx.cfg["index_bytes"]))
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / dev


def idle_pct(ctx) -> Optional[float]:
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * ctx.trace.idle_share

