"""dispatch_us.<cell kind>: host microseconds of the port's own work in
each apply of the traced tail: the self time of the span ``spmv.apply``
(one ``op @ x``), which leaves out its child ``spmv.launch``, the C call
that waits where the card's launch queue is full.  The port keeps its
span totals only while a profiler records, so they hold the traced tail
alone.  One reader for the family; None from a port without the span."""

from spmv_vector_cache_tpu_torch.utils import stats


def read(ctx):
    row = getattr(stats, "span_totals", {}).get("spmv.apply")
    if row is None or not row.count:
        return None
    return row.self_seconds / row.count * 1e6
