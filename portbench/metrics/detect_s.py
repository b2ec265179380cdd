"""detect_s: host seconds of the planner's first stage inside
``SparseOperator.from_matrix``: the CSR check and the diagonal detection
(``op.stats["detect_seconds"]``, the span ``spmv.plan.detect``).  None
from a port that does not time its stages."""


def read(ctx):
    op = ctx.state.get("op")
    return None if op is None else op.stats.get("detect_seconds")
