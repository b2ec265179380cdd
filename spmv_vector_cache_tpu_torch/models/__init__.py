"""The models over the operator: iterative solvers and a GCN
(counterpart of ``spmv_vector_cache_tpu/models``)."""

from . import gnn, solvers  # noqa: F401
from .solvers import SolveResult, bicgstab, cg, cg_step, jacobi  # noqa: F401
from .solvers import pagerank, power_iteration  # noqa: F401
