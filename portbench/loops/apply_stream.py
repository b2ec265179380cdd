"""``y = op @ x`` back to back: one closed loop on one stream, dispatched
ahead of the card, synchronised only when the window ends.

Traffic parameters: ``warmup`` applies in set-up, ``trace_units``
applies in the traced tail, ``sample`` outputs kept for the comparison
(plus the window's last).  x is drawn from the seed and fixed.
"""

from __future__ import annotations

import time

import torch

from portbench import common, spans


def draw_x(ctx: common.Ctx) -> torch.Tensor:
    """x ~ N(0, 1) from the seed, in the configuration's value type."""
    _, dtype = common.DTYPES[ctx.cfg["value_dtype"]]
    return torch.randn(ctx.stats["cols"], generator=common.generator(ctx, 1),
                       dtype=dtype, device=ctx.device)


def setup(ctx: common.Ctx) -> None:
    op = common.build_operator(ctx)
    x = draw_x(ctx)
    for _ in range(int(ctx.traffic["warmup"])):
        op @ x
    common.sync(ctx.device)
    ctx.state.update(op=op, x=x)


def window(ctx: common.Ctx, seconds: float) -> None:
    op, x = ctx.state["op"], ctx.state["x"]
    keep = common.Reservoir(int(ctx.traffic["sample"]), ctx.seed)
    n = 0
    clock = time.perf_counter
    t0 = clock()
    deadline = t0 + seconds
    while clock() < deadline:
        keep.offer(op @ x)
        n += 1
    common.sync(ctx.device)
    ctx.stats.update(units=n, window_s=clock() - t0)
    ctx.state["outputs"] = keep.sample()


def dispatch_us(ctx: common.Ctx) -> float:
    """Host microseconds an ``op @ x`` call takes while the card's launch
    queue has room: 20 bursts of 200 applies, each after a sync.  (In the
    window the queue fills and every call waits for the card.)"""
    op, x = ctx.state["op"], ctx.state["x"]
    bursts, per = 20, 200
    clock, total = time.perf_counter, 0.0
    for _ in range(bursts):
        common.sync(ctx.device)
        t = clock()
        for _ in range(per):
            op @ x
        total += clock() - t
    common.sync(ctx.device)
    return total / (bursts * per) * 1e6


def traced(ctx: common.Ctx) -> None:
    ctx.stats["host_us_per_apply"] = dispatch_us(ctx)
    op, x = ctx.state["op"], ctx.state["x"]
    units = int(ctx.traffic["trace_units"])
    with spans.Traced() as tr:
        for _ in range(units):
            with spans.span("apply", True):
                op @ x
    ctx.trace = tr.summary
    ctx.stats["traced_units"] = units


def end_to_end(ctx: common.Ctx) -> dict:
    s = ctx.stats
    return {"spmv_rate": s["nnz"] * s["units"] / s["window_s"] / 1e9}


def release(ctx: common.Ctx) -> None:
    ctx.state.pop("op", None)


def compare(ctx: common.Ctx, outputs) -> dict:
    """The widest gap of any kept y from the stencil's y, against
    max |A| |x|, over the kept applies."""
    x = ctx.state["x"]
    ref = ctx.problem.reference_matvec(ctx.cfg, x)
    scale = float(ctx.problem.reference_abs_matvec(ctx.cfg, x).max())
    errs = [float((y.to(ref.dtype) - ref).abs().max()) / scale
            for y in outputs]
    return {"y_err": errs}
