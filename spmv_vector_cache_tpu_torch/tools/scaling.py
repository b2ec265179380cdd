"""Weak-scaling harness: 1 shard -> N shards (BASELINE.json config 5;
counterpart of ``spmv_vector_cache_tpu/tools/scaling.py``).

Measures row-partitioned sharded SpMV at increasing shard counts with a
problem that grows proportionally (weak scaling), and reports efficiency
= T(1) / T(N) for N times the work.  The shards live on a
``parallel.make_mesh(N, device=...)``: one per card, dealt round-robin,
so N shards on one card share it (the numbers then characterise the
harness on that card, not a multi-card fabric); ``device="cpu"`` runs
the kernels' plain versions.  Each row's ``hardware`` names the card
and how many cards the shards span, or the CPU.

Usage:
  python -m spmv_vector_cache_tpu_torch.tools.scaling \
      [--rows-per-device 65536] [--mode sell|dia] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

import numpy as np
import torch


def _hardware(mesh) -> str:
    """The card's name and how many cards the shards span, or "cpu"."""
    first = mesh.devices[0]
    if first.type != "cuda":
        return "cpu"
    return f"{torch.cuda.get_device_name(first)} x{len(set(mesh.devices))}"


def weak_scaling(rows_per_device: int = 1 << 16, ndiag: int = 17,
                 iters: int = 10, device_counts=None, mode: str = "sell",
                 log=sys.stderr, device="cuda") -> List[Dict[str, Any]]:
    """``mode``: 'sell' (general window kernel + all-gather/halo) or 'dia'
    (diagonal kernel + halo exchange — the banded fast path).  Runs on
    ``device`` (the card unless the caller asks for the CPU)."""
    import scipy.sparse as sp

    from ..formats.convert import from_scipy
    from ..parallel import (build_sharded_dia_plan, build_sharded_plan,
                            make_mesh, place_on_mesh, spmv_dia_sharded,
                            spmv_sharded)
    from ..utils import roofline

    counts = list(device_counts or (1, 2, 4, 8))
    rng = np.random.default_rng(0)
    results = []
    base_time = None
    for nd in counts:
        n = rows_per_device * nd
        m = sp.spdiags(rng.standard_normal((ndiag, n)).astype(np.float32),
                       list(range(-(ndiag // 2), ndiag // 2 + 1)),
                       n, n).tocsr()
        m.sort_indices()
        a = from_scipy(m.astype(np.float32))
        mesh = make_mesh(nd, device=device)
        if mode == "dia":
            spn = build_sharded_dia_plan(a, nd)
            run = spmv_dia_sharded
        else:
            spn = build_sharded_plan(a, nd)

            def run(s, v, mesh):
                return spmv_sharded(s, v, mesh, mode="auto")
        spn = place_on_mesh(spn, mesh)
        x_np = rng.standard_normal(n).astype(np.float32)
        x = torch.from_numpy(x_np).to(mesh.devices[0])

        # correctness gate
        y = run(spn, x, mesh).cpu().numpy()
        ok = np.allclose(y, m.astype(np.float64) @ x_np, rtol=1e-3,
                         atol=1e-3)

        def make(k):
            def chain():
                v = x
                for _ in range(k):
                    w = run(spn, v, mesh)
                    v = w / torch.linalg.vector_norm(w).clamp(min=1e-30)
                return v[:1]
            return chain

        dt = roofline.time_marginal(make, i1=iters, i2=3 * iters)
        floor = roofline.at_floor(dt)
        if base_time is None:
            base_time = dt
        eff = None if floor or roofline.at_floor(base_time) else \
            base_time / dt
        row = {"devices": nd, "rows": n, "nnz": a.nnz,
               "ok": bool(ok) and not floor, "seconds": dt,
               "gnnz_per_s": None if floor else a.nnz / dt / 1e9,
               "weak_scaling_efficiency": eff,
               "hardware": _hardware(mesh)}
        results.append(row)
        rate = "no rate: timing floor" if floor else \
            f"{row['gnnz_per_s']:.2f} Gnnz/s eff={eff:.2f}"
        print(f"devices={nd} ok={row['ok']} {rate} on {row['hardware']}",
              file=log, flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rows-per-device", type=int, default=1 << 16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mode", choices=("sell", "dia"), default="sell")
    ap.add_argument("--cpu", action="store_true",
                    help="shard on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    results = weak_scaling(rows_per_device=args.rows_per_device,
                           iters=args.iters, mode=args.mode,
                           device="cpu" if args.cpu else "cuda")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
