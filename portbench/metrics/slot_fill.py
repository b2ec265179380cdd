"""slot_fill: the share of the value slots an apply streams that hold a
stored entry, 100 * ``plan.nnz`` / ``plan.slots`` (the port's counters of
the plans ``auto_plan`` returned in this run; one plan in a run).  None
from a port without the counters."""

from spmv_vector_cache_tpu_torch.utils import stats


def read(ctx):
    counters = getattr(stats, "counters", {})
    slots = counters.get("plan.slots", 0)
    if "plan.nnz" not in counters or not slots:
        return None
    return 100.0 * counters["plan.nnz"] / slots
