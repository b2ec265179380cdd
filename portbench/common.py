"""What the loops share: the run's context, seeding, the operator a
matrix configuration is served by, and the sample of outputs kept for
the comparison."""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""
    workload: str
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    device: str
    problem: Any                     # the configuration's module
    peaks: Optional[dict] = None
    state: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Any = None                # spans.TraceSummary of the traced tail
    marks: List[Any] = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note the end of a step of set-up (host clock), for the log."""
        self.marks.append((name, time.perf_counter()))


def torch_seed(seed: int) -> int:
    """A seed any ``torch.Generator`` takes (it wants 0 <= s < 2**64)."""
    return seed % (1 << 63)


def generator(ctx: Ctx, stream: int = 0) -> torch.Generator:
    """A generator on the run's device, one stream a purpose."""
    return torch.Generator(device=ctx.device).manual_seed(
        torch_seed(ctx.seed * 7919 + stream))


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_operator(ctx: Ctx):
    """The matrix configuration's CSR, built by the harness on the host,
    through the port's normal entry ``SparseOperator.from_matrix``."""
    from spmv_vector_cache_tpu_torch import CSR, SparseOperator

    indptr, indices, data, shape = ctx.problem.make_csr(ctx.cfg)
    ctx.mark("csr")
    ctx.stats["nnz"] = int(indices.shape[0])
    ctx.stats["rows"], ctx.stats["cols"] = shape
    csr = CSR(data=data, indices=indices, indptr=indptr, shape=shape)
    np_dtype, _ = DTYPES[ctx.cfg["value_dtype"]]
    op = SparseOperator.from_matrix(csr, value_dtype=np_dtype,
                                    device=ctx.device)
    ctx.stats["plan_s"] = float(op.stats["plan_seconds"])
    ctx.mark("from_matrix")
    return op


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from the seed, plus the stream's last item."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.items: List[Any] = []
        self.seen = 0
        self.last: Any = None

    def offer(self, item) -> None:
        self.seen += 1
        self.last = item
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item

    def sample(self) -> List[Any]:
        return self.items + ([self.last] if self.last is not None else [])

