from . import operator, reference, semiring, spmv_dia, spmv_sell  # noqa: F401
from . import lane_perm, spmv_chunk, spmv_packed, strategy  # noqa: F401
from . import df64, spmm_dia, spmm_sell  # noqa: F401
from .operator import SparseOperator  # noqa: F401
from .reference import golden, spmm, spmv, spmv_numpy  # noqa: F401
from .semiring import (MAX_PLUS, MAX_TIMES, MIN_PLUS, OR_AND,  # noqa: F401
                       PLUS_TIMES, Semiring)
from .spmm_dia import spmm_dia as spmm_dia_plan  # noqa: F401
from .spmm_sell import spmm_plan  # noqa: F401
from .spmv_dia import spmv_dia_df, spmv_dia_double  # noqa: F401
from .spmv_sell import (spmv_plan, spmv_sell_double,  # noqa: F401
                        spmv_sell_double_pair)
