from . import analysis, cached, containers, convert, costmodel, dia, plan  # noqa: F401
from . import chunk, packed, plan_io, refio  # noqa: F401
from .cached import (COO_TAIL_MAX, CachedPlan, CooTail,  # noqa: F401
                     build_cached_plan, column_frequency,
                     coo_tail_from_csr, hot_set_coverage)
from .chunk import ChunkPlan, SubwinPlan, build_chunk_plan  # noqa: F401
from .containers import BSR, COO, CSC, CSR, ELL  # noqa: F401
from .convert import (bsr_to_csr, coo_to_csc, coo_to_csr,  # noqa: F401
                      csc_to_coo, csc_to_csr, csr_to_bsr, csr_to_coo,
                      csr_to_csc, csr_to_ell, ell_to_csr, from_scipy,
                      to_dense)
from .dia import (DIA, DiaPlan, HybridPlan, build_dia_plan,  # noqa: F401
                  csr_to_dia, dia_to_csr, from_scipy_dia, split_diagonal)
from .packed import PackedPlan, build_packed_plan  # noqa: F401
from .plan import (SellPlan, auto_plan, build_sell_plan,  # noqa: F401
                   validate_plan)
from .plan_io import config_suffix, load_plan, save_plan  # noqa: F401
from .refio import (load_golden, load_matrix_market,  # noqa: F401
                    load_reference_matrix, save_golden,
                    save_reference_matrix)
