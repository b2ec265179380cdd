"""cg_overlap_share: the share of the port's host reads in
``models.solvers.cg`` made with the next iteration already queued on the
card, ``100 * cg.reads_overlapped / cg.host_syncs`` in
``utils.stats.counters``, over every solve of the run.  None from a port
without the counter."""

from spmv_vector_cache_tpu_torch.utils import stats


def read(ctx):
    counters = getattr(stats, "counters", {})
    syncs = counters.get("cg.host_syncs", 0)
    if "cg.reads_overlapped" not in counters or not syncs:
        return None
    return 100.0 * counters["cg.reads_overlapped"] / syncs
