"""cg_spmv_roofline: as spmv_roofline, over the device time inside the
span around each ``matvec`` call that ``cg`` makes."""

from portbench import readers


def read(ctx):
    return readers.spmv_roofline_pct(ctx, "matvec")
