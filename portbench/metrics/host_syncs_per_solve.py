"""host_syncs_per_solve: the port's count of host reads of the device in
``models.solvers.cg`` over its count of solves (``cg.host_syncs`` /
``cg.solves`` in ``utils.stats.counters``), over every solve of the run.
None from a port without the counters."""

from spmv_vector_cache_tpu_torch.utils import stats


def read(ctx):
    counters = getattr(stats, "counters", {})
    solves = counters.get("cg.solves", 0)
    return counters.get("cg.host_syncs", 0) / solves if solves else None
