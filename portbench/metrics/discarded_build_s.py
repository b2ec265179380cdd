"""discarded_build_s: host seconds the planner spent inside
``SparseOperator.from_matrix`` on candidate plans it built or priced and
did not keep (``op.stats["discarded_build_seconds"]``, the spans
``spmv.plan.build.<family>``).  None from a port that does not record
them."""


def read(ctx):
    op = ctx.state.get("op")
    return None if op is None else op.stats.get("discarded_build_seconds")
