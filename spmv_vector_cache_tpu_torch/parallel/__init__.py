from . import dia_sharded, mesh, spmv_sharded  # noqa: F401
from .dia_sharded import (ShardedDiaPlan, build_sharded_dia_plan,  # noqa: F401
                          spmv_dia_sharded)
from .mesh import Mesh, place_on_mesh  # noqa: F401
from .spmv_sharded import (ShardedPlan, build_sharded_plan,  # noqa: F401
                           make_mesh, spmm_sharded, spmv_sharded)
