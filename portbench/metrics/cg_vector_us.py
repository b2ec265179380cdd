"""cg_vector_us: device microseconds an iteration launched inside the
solve spans but outside their ``matvec`` spans: the solver's own vector
and scalar operations."""

from portbench import readers


def read(ctx):
    solve = readers.span_device_s(ctx, "solve")
    its = ctx.stats.get("traced_iterations")
    if solve is None or not its:
        return None
    tr = ctx.trace
    outside = tr.device_s_by_span["solve"] - tr.device_s_by_span.get(
        "matvec", 0.0)
    return outside / its * 1e6
