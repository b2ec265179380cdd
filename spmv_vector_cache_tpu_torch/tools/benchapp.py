"""Benchmark application: strategy x matrix sweep with golden checks
(counterpart of ``spmv_vector_cache_tpu/tools/benchapp.py``).

The role of the reference's interactive benchmark REPL
(``software/main.cpp:146-264``): for every (strategy, matrix) pair it
runs a software check pass (the float64 host loop), runs the device,
compares against the check pass and the matrix directory's golden, and
prints one CSV row with the statKeys taxonomy and a roofline audit.

The time is the two-point marginal of a chain of dependent applies
(``utils/roofline.time_marginal``).  A row whose marginal is the timing
floor has status ``timing_floor`` and no time or rate.

Usage:
  python -m spmv_vector_cache_tpu_torch.tools.benchapp \
      [--strategies window,stream] [--iters 10] [--cpu] <matrix-dir>...

Runs on the card; ``--cpu`` asks for the kernels' plain versions on the
CPU instead.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np
import torch


def _chain_marginal(plan, x0: torch.Tensor, strat: str, i1: int = 10,
                    i2: int = 40) -> float:
    """Marginal per-apply time over chained applies (each apply, then a
    division by its largest magnitude), free of fixed per-call costs."""
    from ..ops.spmv_sell import spmv_plan
    from ..utils import roofline

    def make(iters):
        def go():
            v = x0
            for _ in range(iters):
                w = spmv_plan(plan, v, strategy=strat)
                v = w / w.abs().max().clamp(min=1e-30)
            return v[:1]
        return go

    return roofline.time_marginal(make, i1=i1, i2=i2)


def run_sweep(matrix_dirs: List[str], strategies: List[str], iters: int,
              out=None, device="cuda") -> int:
    """One CSV row per (matrix, strategy) on ``device`` (the card unless
    the caller asks for the CPU), written to ``out`` (standard output by
    default).  Returns 1 if a directory failed to load or a result
    disagreed with the software pass, else 0."""
    from ..formats import refio
    from ..formats.plan import auto_plan, place
    from ..ops import reference
    from ..ops.spmv_sell import spmv_plan
    from ..ops.strategy import (execution_counters, plan_bytes_per_apply,
                                plan_nnz)
    from ..utils import roofline
    from ..utils.stats import StatRegistry, csv_rows

    device = torch.device(device)
    registries, extras = [], []
    rc = 0
    for d in matrix_dirs:
        name = os.path.basename(os.path.normpath(d))
        try:
            a = refio.load_reference_matrix(d)
        except (OSError, ValueError) as e:
            print(f"error: cannot load {d}: {e}", file=sys.stderr)
            rc = 1
            continue
        gold = refio.load_golden(d)
        x = np.ones(a.shape[1], dtype=np.float32)
        # software check pass (benchmarkSW role, main.cpp:102-144)
        sw = reference.spmv_numpy(a, x.astype(np.float64))
        plan = place(auto_plan(a), device)
        x_t = torch.from_numpy(x).to(device)

        nnz = plan_nnz(plan)
        for strat in strategies:
            # uniform column set across plan types; plan-type detail goes
            # in `plan`
            stats = StatRegistry({"nnz": nnz})
            try:
                y = spmv_plan(plan, x_t, strategy=strat).cpu().numpy()
            except ValueError:        # infeasible strategy for this plan
                extras.append({"matrix": name, "strategy": strat,
                               "status": "infeasible",
                               "plan": type(plan).__name__})
                registries.append(stats)
                continue
            # diffFromGolden (HardwareSpMV.cpp:54-61): count of mismatched
            # entries vs the software pass / golden file
            tol = 1e-4 * max(1.0, float(np.abs(sw).max()))
            diff_sw = int((np.abs(y - sw) > tol).sum())
            diff_gold = (int((np.abs(y - gold) > tol).sum())
                         if gold is not None else -1)
            if diff_sw:
                rc = 1
            dt = _chain_marginal(plan, x_t, strat, i1=iters, i2=4 * iters)
            floor = roofline.at_floor(dt)
            bpa = plan_bytes_per_apply(plan, strat)
            stats["spmvtime"] = "" if floor else dt
            stats["gnnz_per_s"] = "" if floor else nnz / dt / 1e9
            stats["diffFromSW"] = diff_sw
            stats["diffFromGolden"] = diff_gold
            # per-execution work counters + modelled traffic (the
            # reference CSV's counter columns)
            stats.update(execution_counters(plan, strat))
            stats["bytes_per_apply"] = bpa
            stats["achieved_gb_per_s"] = "" if floor else bpa / dt / 1e9
            registries.append(stats)
            status = "MISMATCH" if diff_sw else (
                "timing_floor" if floor else "ok")
            extras.append({"matrix": name, "strategy": strat,
                           "status": status, "plan": type(plan).__name__})
    (out or sys.stdout).write(csv_rows(registries, extras))
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("matrices", nargs="+", help="matrix directories "
                    "(reference wire format)")
    ap.add_argument("--strategies", default="auto",
                    help="comma list: auto,window,stream")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    args = ap.parse_args(argv)
    if not args.cpu:
        from ..utils.platform import require_cuda

        require_cuda()
    return run_sweep(args.matrices, args.strategies.split(","), args.iters,
                     device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    raise SystemExit(main())
