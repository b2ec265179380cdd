"""spmv_vector_cache_tpu_torch — the PyTorch/CUDA port of
``spmv_vector_cache_tpu``.

The JAX package stays the reference; this package mirrors its layout
module for module and imports ``torch``, never ``jax``:

* :mod:`.formats` — host-side numpy containers, conversions, analyses
  and plan builders (byte-equal plans to the reference's), the
  reference system's matrix files (``refio``) and plan files
  (``plan_io``), both byte-compatible with the JAX package's;
* :mod:`.ops` — the plan dispatch of SpMV and SpMM, the epilogues as
  torch ops, the reference executors, and the wrappers of the
  hand-written CUDA kernels in ``csrc/`` (DIA, SELL window, lane
  un-permute, subwindow, packed scan and extract, the global-column SELL
  kernel of the resident, deep and stream strategies, the DIA and
  SELL-window SpMM kernels, and the float64 builds of the DIA, SELL
  window and global-column kernels), each beside its plain PyTorch
  version; SpGEMM (host symbolic phase, numeric phase as torch ops on
  the device) and the blocked triangular solve with ILU(0) (host
  factorization, the block sweep as torch ops on the device);
* :mod:`.models` — the solvers (CG, BiCGSTAB, Jacobi, power iteration,
  PageRank) over any ``matvec``, and a GCN whose aggregate is the SpMM;
* :mod:`.parallel` — sharded SpMV and SpMM over a mesh of devices (one
  process; several shards may share one card): row-block SELL plans with
  all-gather or halo exchange, and DIA plans with halo exchange on the
  halo DIA kernel;
* :mod:`.interop` — plans and GCN parameters carried across from the
  JAX package;
* :mod:`.tools` — the matrix generators of the evaluation suite;
* :mod:`.utils` — stat registry, device policy, the stream checksum
  kernel and the roofline audit (measured stream bandwidth).

``SparseOperator.from_matrix(a) @ x`` runs DIA, Hybrid, SELL (window,
resident, deep and stream), Chunk, Packed, Cached and COO-tail plans on
the card, and ``op @ B`` (B of shape (cols, k)) runs the fused SpMM of
DIA, Hybrid, SELL-window and COO-tail plans there, every other plan on
the reference SpMM; ``from_matrix(a, value_dtype=np.float64) @ x``
runs the double DIA, Hybrid and SELL plans in FP64 and returns a float64
y; ``from_matrix(a, device="cpu")`` runs the kernels' plain versions, as
the tests do.  ``models.cg(op.matvec, b)`` solves on the operator's
kernels, with one host sync per iteration; ``op @ x`` and ``op @ B``
refuse an operand that requires a gradient while autograd records (the
kernels have no backward), and ``ops.reference.spmm``, the GCN's
default aggregate, carries gradients.
"""

from . import formats, interop, models, ops, parallel, tools  # noqa: F401
from . import utils  # noqa: F401
from .formats.containers import BSR, COO, CSC, CSR, ELL  # noqa: F401
from .formats.plan import auto_plan  # noqa: F401
from .ops import semiring  # noqa: F401
from .ops.operator import SparseOperator  # noqa: F401
from .ops.reference import golden, spmm, spmv, spmv_numpy  # noqa: F401
from .ops.spmm_dia import spmm_dia  # noqa: F401
from .ops.spmm_sell import spmm_plan  # noqa: F401
from .ops.spmv_dia import spmv_dia_df, spmv_dia_double  # noqa: F401
from .ops.spmv_sell import (spmv_plan, spmv_sell_double,  # noqa: F401
                            spmv_sell_double_pair)

__version__ = "0.1.0"
