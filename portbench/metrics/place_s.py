"""place_s: host seconds of the planner's last stage inside
``SparseOperator.from_matrix``: placing the plan on the card
(``op.stats["place_seconds"]``, the span ``spmv.plan.place``).  None
from a port that does not time its stages."""


def read(ctx):
    op = ctx.state.get("op")
    return None if op is None else op.stats.get("place_seconds")
