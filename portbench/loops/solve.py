"""Solves repeated back to back: the port's ``models.solvers.cg`` on the
operator, each from x0 = 0, each timed from its start to its residual
norm on the host.

Traffic parameters: ``maxiter`` and ``tol`` of each solve (``tol`` 0:
no early exit), ``warmup`` solves in set-up, ``trace_units`` solves in
the traced tail, ``sample`` solves kept for the comparison (plus the
window's last).
"""

from __future__ import annotations

import statistics
import time

from portbench import common, spans
from portbench.plain_cg import plain_cg


def _solve(ctx: common.Ctx, traced: bool):
    from spmv_vector_cache_tpu_torch.models import solvers

    op, b = ctx.state["op"], ctx.state["b"]
    if traced:
        def matvec(v):
            with spans.span("matvec", True):
                return op @ v
    else:
        def matvec(v):
            return op @ v
    with spans.span("solve", traced):
        res = solvers.cg(matvec, b, tol=float(ctx.traffic["tol"]),
                         maxiter=int(ctx.traffic["maxiter"]))
        rnorm = float(res.residual_norm)
    return res.x, rnorm, res.iterations


def setup(ctx: common.Ctx) -> None:
    if float(ctx.traffic["tol"]) != 0.0:
        raise ValueError("the comparison follows fixed-length CG: tol 0")
    op = common.build_operator(ctx)
    _, dtype = common.DTYPES[ctx.cfg["value_dtype"]]
    ctx.state.update(op=op, b=ctx.problem.rhs(ctx.cfg, ctx.device, dtype))
    for _ in range(int(ctx.traffic["warmup"])):
        _solve(ctx, False)
    common.sync(ctx.device)


def window(ctx: common.Ctx, seconds: float) -> None:
    keep = common.Reservoir(int(ctx.traffic["sample"]), ctx.seed)
    times = []
    clock = time.perf_counter
    t0 = clock()
    deadline = t0 + seconds
    while True:
        t = clock()
        out = _solve(ctx, False)
        t1 = clock()
        times.append(t1 - t)
        keep.offer(out)
        if t1 >= deadline:
            break
    ctx.stats.update(units=len(times), window_s=clock() - t0)
    ctx.state["times"] = times
    ctx.state["outputs"] = keep.sample()


def traced(ctx: common.Ctx) -> None:
    units = int(ctx.traffic["trace_units"])
    with spans.Traced() as tr:
        its = [_solve(ctx, True)[2] for _ in range(units)]
    ctx.trace = tr.summary
    ctx.stats.update(traced_units=units, traced_iterations=sum(its))


def end_to_end(ctx: common.Ctx) -> dict:
    s, times = ctx.stats, ctx.state["times"]
    p95 = (statistics.quantiles(times, n=100, method="inclusive")[94]
           if len(times) > 1 else times[0])
    return {"cg_solve_ms": s["window_s"] / s["units"] * 1e3,
            "cg_solve_p95_ms": p95 * 1e3}


def release(ctx: common.Ctx) -> None:
    ctx.state.pop("op", None)


def compare(ctx: common.Ctx, outputs) -> dict:
    """Each kept solve against plain CG on the stencil in the
    configuration's precision: x's widest gap against max |x_ref|, the
    residual norm's gap against the reference's, and the iteration
    count's difference."""
    b = ctx.state["b"]
    iters = int(ctx.traffic["maxiter"])
    x_ref, r_ref = plain_cg(lambda v: ctx.problem.reference_matvec(ctx.cfg, v),
                            b, iters)
    xs = float(x_ref.abs().max())
    return {"x_err": [float((x.to(x_ref.dtype) - x_ref).abs().max()) / xs
                      for x, _, _ in outputs],
            "rnorm_gap": [abs(r - r_ref) / r_ref for _, r, _ in outputs],
            "iterations_gap": [abs(k - iters) for _, _, k in outputs]}
