from . import operator, reference, semiring, spmv_dia, spmv_sell  # noqa: F401
from . import lane_perm, spmv_chunk, spmv_packed, strategy  # noqa: F401
from .operator import SparseOperator  # noqa: F401
from .reference import golden, spmv_csr, spmv_numpy  # noqa: F401
from .semiring import (MAX_PLUS, MAX_TIMES, MIN_PLUS, OR_AND,  # noqa: F401
                       PLUS_TIMES, Semiring)
from .spmv_sell import spmv_plan  # noqa: F401
