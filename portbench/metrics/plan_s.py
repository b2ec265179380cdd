"""plan_s: host seconds of the port's planning and placement inside
``SparseOperator.from_matrix`` (``op.stats["plan_seconds"]``)."""


def read(ctx):
    return ctx.stats.get("plan_s")
