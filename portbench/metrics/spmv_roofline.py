"""spmv_roofline: the SpMV's least time at the published HBM rate over
the device time of every operation launched inside the span around one
``op @ x``, the traced tail's mean."""

from portbench import readers


def read(ctx):
    return readers.spmv_roofline_pct(ctx, "apply")
