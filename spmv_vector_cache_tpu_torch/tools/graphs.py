"""Graph generators for graph-analytics workloads, drawn on a torch device.

``kron`` is the Kronecker (R-MAT) graph of the Graph500 specification as
the GAP Benchmark Suite runs it (Beamer, Asanovic, Patterson,
arXiv:1508.03619, graph ``kron``): ``edge_factor * 2**scale`` edges, each
placed by ``scale`` quadrant choices with probabilities A, B, C and
D = 1 - A - B - C, vertex labels scrambled by a seeded permutation, then
made undirected with self-loops and duplicate edges removed.  Isolated
vertices stay, as GAP keeps them.

It returns the graph as PageRank's pull operator P on the host: row v
holds one entry for each neighbour u, of value 1 / outdeg(u) in float32,
so that ``y = P x`` is one pull step, y[v] = sum over u -> v of
x[u] / outdeg(u).  Every column of a vertex with edges sums to 1.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..formats.containers import CSR

#: Graph500's initiator probabilities, which GAP's ``kron`` uses
GRAPH500_ABC = (0.57, 0.19, 0.19)

#: edges drawn a block at a time, one generator in turn: the block fixes
#: which uniform goes to which edge and level, so it is part of the draw
_DRAW_BLOCK = 1 << 24


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def kron_edges(scale: int, edge_factor: int = 16,
               abc: Tuple[float, float, float] = GRAPH500_ABC,
               seed: int = 0,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``edge_factor * 2**scale`` drawn edges (src, dst), int64 on
    ``device``, vertex labels scrambled; self-loops and duplicates are
    still there.  The draw depends only on the arguments: edges take
    their uniforms from one generator a fixed block at a time."""
    a, b, c = (float(v) for v in abc)
    if not (scale >= 1 and edge_factor >= 1 and min(a, b, c) >= 0
            and a + b + c < 1):
        raise ValueError(f"bad kron parameters: scale={scale}, "
                         f"edge_factor={edge_factor}, abc={abc}")
    n, m = 1 << scale, edge_factor << scale
    g = _generator(seed, device)
    src = torch.empty(m, dtype=torch.int64, device=device)
    dst = torch.empty(m, dtype=torch.int64, device=device)
    # one uniform a level: quadrant (0,0) below A, (0,1) below A+B,
    # (1,0) below A+B+C, else (1,1)
    ab, abc_ = a + b, a + b + c
    for lo in range(0, m, _DRAW_BLOCK):
        k = min(_DRAW_BLOCK, m - lo)
        i = torch.zeros(k, dtype=torch.int64, device=device)
        j = torch.zeros(k, dtype=torch.int64, device=device)
        for level in range(scale):
            u = torch.rand(k, generator=g, device=device)
            bit = 1 << level
            i += (u >= ab).long() * bit
            j += (((u >= a) & (u < ab)) | (u >= abc_)).long() * bit
        src[lo:lo + k], dst[lo:lo + k] = i, j
    perm = torch.randperm(n, generator=g, device=device)
    return perm[src], perm[dst]


def pull_matrix(src: torch.Tensor, dst: torch.Tensor, n: int) -> CSR:
    """P of the undirected graph of the edges (src, dst) over ``n``
    vertices, self-loops and duplicates dropped, as host CSR arrays:
    indptr int64, indices int32 ascending within each row, data float32
    (1 / degree of the column, rounded once from float64)."""
    keep = src != dst
    s, d = src[keep], dst[keep]
    key = torch.unique(torch.cat([d * n + s, s * n + d]))
    rows, cols = key // n, key % n
    del key
    deg = torch.bincount(rows, minlength=n)
    vals = (1.0 / deg.clamp(min=1).double())[cols].float()
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(deg, 0, out=indptr[1:])
    return CSR(data=vals.cpu().numpy(),
               indices=cols.to(torch.int32).cpu().numpy(),
               indptr=indptr.cpu().numpy(), shape=(n, n))


def kron(scale: int, edge_factor: int = 16,
         abc: Tuple[float, float, float] = GRAPH500_ABC, seed: int = 0,
         device="cpu") -> CSR:
    """GAP's ``kron`` graph of ``2**scale`` vertices as PageRank's pull
    operator P (module docstring), drawn on ``device``, returned on the
    host.  The same arguments on the same device give the same arrays."""
    src, dst = kron_edges(scale, edge_factor, abc, seed, device)
    return pull_matrix(src, dst, 1 << scale)


def fingerprint(csr: CSR) -> str:
    """A short hex digest of the CSR's structure and values, to tell one
    draw from another."""
    import hashlib

    h = hashlib.sha256()
    for arr in (csr.indptr, csr.indices, csr.data):
        h.update(np.ascontiguousarray(arr).view(np.uint8))
    return h.hexdigest()[:16]
