"""GAP's ``kron`` graph as PageRank's pull operator, and its plain
reference.

The graph is drawn on the card (the CPU where there is none) by the
port's Graph500 generator, ``tools/graphs.py``, from the configuration's
``graph_seed``, and handed to the port as host CSR arrays: row v holds
1 / outdeg(u) in float32 at column u for each neighbour u, so that
``y = P x`` is one PageRank pull step.  A draw on the card at the
configuration's own scale and seed is checked against the entry count
and fingerprint that ``draw`` records, so that a change to the generator
fails loudly instead of moving the cell.

The reference reads nothing but those arrays: plain torch in float64, an
``index_add_`` over the edges, a block of rows at a time.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from spmv_vector_cache_tpu_torch.tools import graphs

#: the draws of this process, by (scale, edge factor, initiator, seed,
#: device): the reference reads the arrays the program was given
_DRAWN: Dict[tuple, object] = {}

#: entries a block of the reference's rows holds at most
BLOCK_ENTRIES = 1 << 24


def _device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _key(cfg) -> tuple:
    return (int(cfg["scale"]), int(cfg["edge_factor"]),
            tuple(float(v) for v in cfg["initiator"]),
            int(cfg["graph_seed"]), _device())


def _draw(cfg):
    key = _key(cfg)
    if key not in _DRAWN:
        scale, ef, abc, seed, device = key
        csr = graphs.kron(scale, ef, abc, seed, device=device)
        rec = cfg.get("draw") or {}
        if device == "cuda" and (rec.get("scale"), rec.get("graph_seed")) \
                == (scale, seed):
            got = (csr.nnz, graphs.fingerprint(csr))
            want = (int(rec["nnz"]), rec["fingerprint"])
            if got != want:
                raise RuntimeError(
                    f"the kron draw at scale {scale}, seed {seed} gave "
                    f"{got[0]} entries, fingerprint {got[1]}; the "
                    f"configuration records {want[0]}, {want[1]}: the "
                    f"generator changed, so the cell would measure "
                    f"another graph")
        _DRAWN[key] = csr
    return _DRAWN[key]


def shape(cfg) -> Tuple[int, int]:
    n = 1 << int(cfg["scale"])
    return n, n


def make_csr(cfg):
    """(indptr int64, indices int32, data float32, shape) of P."""
    csr = _draw(cfg)
    return csr.indptr, csr.indices, csr.data, csr.shape


def _pull(cfg, x: torch.Tensor, absolute: bool, dtype=torch.float64,
          stored=None) -> torch.Tensor:
    csr = _draw(cfg)
    dev = x.device
    xs = (x if stored is None else x.to(stored)).to(dtype)
    xs = xs.abs() if absolute else xs
    indptr = torch.from_numpy(csr.indptr)
    n = csr.shape[0]
    y = torch.zeros(n, dtype=dtype, device=dev)
    r0 = 0
    while r0 < n:
        r1 = int(torch.searchsorted(indptr, indptr[r0] + BLOCK_ENTRIES,
                                    right=True)) - 1
        r1 = min(n, max(r1, r0 + 1))
        lo, hi = int(indptr[r0]), int(indptr[r1])
        cols = torch.from_numpy(csr.indices[lo:hi]).to(dev).long()
        vals = torch.from_numpy(csr.data[lo:hi]).to(dev)
        vals = (vals if stored is None else vals.to(stored)).to(dtype)
        if absolute:
            vals = vals.abs()
        rows = torch.repeat_interleave(
            torch.arange(r0, r1, device=dev),
            (indptr[r0 + 1:r1 + 1] - indptr[r0:r1]).to(dev))
        y.index_add_(0, rows, vals * xs[cols])
        r0 = r1
    return y


def reference_matvec(cfg, x: torch.Tensor, dtype=torch.float64,
                     stored=None) -> torch.Tensor:
    """y = P x on x's device, products and sums in ``dtype`` (float64),
    the values and x first rounded once to ``stored`` where it is given
    (the controls of ``calibrate_f32.py`` ask for narrower types)."""
    return _pull(cfg, x, False, dtype, stored)


def reference_abs_matvec(cfg, x: torch.Tensor) -> torch.Tensor:
    """|P| |x| in float64: the scale each row of y is judged against."""
    return _pull(cfg, x, True)


def rhs(cfg, device, dtype) -> torch.Tensor:
    """PageRank's starting scores, 1/n at every vertex."""
    n = shape(cfg)[0]
    return torch.full((n,), 1.0 / n, dtype=dtype, device=device)
