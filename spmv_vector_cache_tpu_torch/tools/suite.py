"""Benchmark suite over the BASELINE.json configurations (counterpart of
``spmv_vector_cache_tpu/tools/suite.py``: the same eight configs, sizes
and draws).

1. ``spmv_banded``    — banded CSR SpMV, the DIA plan (headline), and
   ``spmv_banded_sell``, the same matrix on the SELL window plan
2. ``spmv_powerlaw``  — skewed row lengths: split + sigma + striping paths
3. ``spmm_bsr``       — BSR SpMM (``reference.spmm``'s batched blocks)
4. ``spmm_fused``     — the fused SELL-window SpMM kernel, and
   ``spmm_dia``, the fused DIA SpMM kernel
5. ``spgemm_numeric`` — SpGEMM numeric phase on a fixed pattern
6. ``trisolve``       — blocked sparse triangular solve

Every entry gates on correctness before timing; results print as lines
and return as dicts.  The time is the two-point marginal of a chain of
dependent steps (``utils/roofline.time_marginal``).  A row whose marginal
is the timing floor is ``ok=False`` with no rate.

The suite runs on the card, and on the kernels' plain versions on the
CPU when no card is present; each row names its device.  The sizes are
the module constants below.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List

import numpy as np
import torch

#: rows and diagonals of the banded matrix (configs 1, 1b and 4)
BANDED_ROWS = 1 << 19
BANDED_DIAGS = 27
#: rows of the power-law matrix (config 2)
POWERLAW_ROWS = 1 << 17
#: rows and diagonals of the BSR band, and its right-hand sides
BSR_ROWS = 1 << 15
BSR_DIAGS = 9
BSR_RHS = 64
#: right-hand sides of the fused SpMM configs, and the DIA SpMM's rows
SPMM_RHS = 16
SPMM_DIA_ROWS = 1 << 17
#: rows of the SpGEMM matrix and of the triangular system
SPGEMM_ROWS = 1 << 14
TRISOLVE_ROWS = 1 << 15


def _chain_time(step_fn, state0, iters: int) -> float:
    from ..utils import roofline

    def make(n):
        def chain():
            s = state0
            for _ in range(n):
                s = step_fn(s)
            return s.reshape(-1)[:1]
        return chain

    dt = roofline.time_marginal(make, i1=iters, i2=3 * iters)
    if dt <= 1e-9:
        # the marginal drowned in call-to-call variance; re-measure with a
        # 4x longer chain so the real work dominates
        dt = roofline.time_marginal(make, i1=4 * iters, i2=12 * iters)
    return dt


def run_suite(iters: int = 20, log=sys.stderr) -> List[Dict[str, Any]]:
    import scipy.sparse as sp

    from ..formats.containers import COO
    from ..formats.convert import coo_to_csr, csr_to_bsr, from_scipy
    from ..formats.dia import build_dia_plan
    from ..formats.plan import auto_plan, place
    from ..ops import reference, spgemm, sptrsv
    from ..ops.spmm_sell import spmm_plan
    from ..ops.spmv_sell import spmv_plan
    from ..ops.strategy import plan_nnz
    from ..utils import roofline

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu (plain versions)"
    rng = np.random.default_rng(0)
    results: List[Dict[str, Any]] = []

    def on(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

    def host(t):
        return t.cpu().numpy()

    def record(name, ok, seconds, work, unit):
        floor = roofline.at_floor(seconds)
        row = {"config": name, "ok": bool(ok) and not floor,
               "seconds": seconds, "rate": None if floor else
               work / seconds / 1e9, "unit": unit, "device": dev_name}
        results.append(row)
        rate = "no rate: timing floor" if floor else \
            f"{row['rate']:.2f} G{unit}/s ({seconds * 1e3:.3f} ms)"
        print(f"{name}: ok={row['ok']} {rate} on {dev_name}", file=log,
              flush=True)

    # --- 1. banded SpMV ---------------------------------------------------
    n = BANDED_ROWS
    nd = BANDED_DIAGS
    m = sp.spdiags(rng.standard_normal((nd, n)).astype(np.float32),
                   list(range(-(nd // 2), nd // 2 + 1)), n, n).tocsr()
    m.sort_indices()
    a = from_scipy(m.astype(np.float32))
    plan = place(auto_plan(a), dev)
    x0_np = rng.standard_normal(n).astype(np.float32)
    x0 = on(x0_np)
    y = host(spmv_plan(plan, x0))
    ok = np.allclose(y, m.astype(np.float64) @ x0_np, rtol=1e-4, atol=1e-4)
    dt = _chain_time(lambda v: spmv_plan(plan, v) / np.float32(nd), x0,
                     iters)
    record("spmv_banded", ok, dt, plan_nnz(plan), "nnz")

    # --- 1b. banded SpMV through the general SELL window kernel ------------
    plan_sell = place(auto_plan(a, allow_dia=False), dev)
    y1b = host(spmv_plan(plan_sell, x0))
    ok1b = np.allclose(y1b, m.astype(np.float64) @ x0_np, rtol=1e-4,
                       atol=1e-4)
    dt1b = _chain_time(lambda v: spmv_plan(plan_sell, v) / np.float32(nd),
                       x0, iters)
    record("spmv_banded_sell", ok1b, dt1b, plan_sell.stats.nnz, "nnz")

    # --- 2. power-law SpMV ------------------------------------------------
    n2 = POWERLAW_ROWS
    lens = np.minimum((rng.pareto(1.2, n2) * 8).astype(np.int64) + 1, 8192)
    rows2 = np.repeat(np.arange(n2), lens)
    cols2 = np.minimum(
        (np.abs(rng.standard_normal(rows2.shape[0])) * 2048).astype(np.int64)
        + rows2 - 1024, n2 - 1)
    cols2 = np.maximum(cols2, 0).astype(np.int32)
    a2 = coo_to_csr(COO(data=rng.standard_normal(rows2.shape[0])
                        .astype(np.float32),
                        row=rows2.astype(np.int32), col=cols2,
                        shape=(n2, n2)))
    plan2 = place(auto_plan(a2), dev)
    x2_np = rng.standard_normal(n2).astype(np.float32)
    x2 = on(x2_np)
    y2 = host(spmv_plan(plan2, x2))
    want2 = reference.spmv_numpy(a2, x2_np.astype(np.float64))
    ok2 = np.allclose(y2, want2, rtol=1e-3, atol=1e-3)
    dt2 = _chain_time(lambda v: spmv_plan(plan2, v) * np.float32(0.125), x2,
                      iters)
    record("spmv_powerlaw", ok2, dt2, plan_nnz(plan2), "nnz")

    # --- 3. BSR SpMM ------------------------------------------------------
    nb = BSR_ROWS
    bandb = BSR_DIAGS
    mb = sp.spdiags(rng.standard_normal((bandb, nb)).astype(np.float32),
                    list(range(-(bandb // 2), bandb // 2 + 1)),
                    nb, nb).tocsr()
    mb.sort_indices()
    ab = place(csr_to_bsr(from_scipy(mb.astype(np.float32)), (8, 8)), dev)
    k = BSR_RHS
    b0_np = rng.standard_normal((nb, k)).astype(np.float32)
    b0 = on(b0_np)
    yb = host(reference.spmm(ab, b0))
    okb = np.allclose(yb, mb.astype(np.float64) @ b0_np, rtol=1e-3,
                      atol=1e-3)
    flops = 2 * ab.nnz * k
    dtb = _chain_time(lambda B: reference.spmm(ab, B) * np.float32(0.1), b0,
                      iters)
    record("spmm_bsr", okb, dtb, flops, "FLOP")

    # --- 4. fused windowed SpMM (SELL path) --------------------------------
    k4 = SPMM_RHS
    b4_np = rng.standard_normal((n, k4)).astype(np.float32)
    b4 = on(b4_np)
    y4 = host(spmm_plan(plan_sell, b4))
    ok4 = np.allclose(y4, m.astype(np.float64) @ b4_np, rtol=1e-3,
                      atol=1e-3)
    dt4 = _chain_time(lambda B: spmm_plan(plan_sell, B) * np.float32(0.19),
                      b4, max(iters // 4, 3))
    record("spmm_fused", ok4, dt4, plan_sell.stats.nnz * k4, "nnzRHS")

    # --- 4b. fused DIA SpMM ------------------------------------------------
    n4b = SPMM_DIA_ROWS
    m4b = sp.spdiags(rng.standard_normal((nd, n4b)).astype(np.float32),
                     list(range(-(nd // 2), nd // 2 + 1)), n4b, n4b).tocsr()
    m4b.sort_indices()
    p4b = place(build_dia_plan(from_scipy(m4b.astype(np.float32))), dev)
    b4b_np = rng.standard_normal((n4b, k4)).astype(np.float32)
    b4b = on(b4b_np)
    y4b = host(spmm_plan(p4b, b4b))
    ok4b = np.allclose(y4b, m4b.astype(np.float64) @ b4b_np, rtol=1e-3,
                       atol=1e-3)
    dt4b = _chain_time(lambda B: spmm_plan(p4b, B) * np.float32(0.19),
                       b4b, max(iters, 10))
    record("spmm_dia", ok4b, dt4b, p4b.stats.nnz * k4, "nnzRHS")

    # --- 5. SpGEMM numeric phase -----------------------------------------
    n5 = SPGEMM_ROWS
    m5 = sp.random(n5, n5, density=16 / n5, format="csr",
                   random_state=np.random.RandomState(0),
                   dtype=np.float64).astype(np.float32)
    m5.sort_indices()
    a5 = from_scipy(m5)
    gplan = spgemm.spgemm_symbolic(a5, a5)
    gplan_d = place(gplan, dev)
    ad = on(np.asarray(a5.data))
    c_data = host(spgemm.spgemm_numeric(gplan_d, ad, ad))
    want5 = (m5.astype(np.float64) @ m5.astype(np.float64)).tocsr()
    want5.sort_indices()
    ok5 = np.allclose(np.sort(c_data), np.sort(want5.data.astype(np.float32)),
                      rtol=1e-2, atol=1e-2)
    nflops5 = int(np.asarray(gplan.a_src).shape[0])
    # the chain carry must keep A's data shape: consume C's data by a
    # reduction folded back into the carry
    dt5 = _chain_time(
        lambda d: d * np.float32(0.999)
        + spgemm.spgemm_numeric(gplan_d, d, ad).sum() * np.float32(1e-30),
        ad, max(iters // 2, 3))
    record("spgemm_numeric", ok5, dt5, 2 * nflops5, "FLOP")

    # --- 6. blocked triangular solve -------------------------------------
    n6 = TRISOLVE_ROWS
    l6 = sp.spdiags(rng.standard_normal((5, n6)).astype(np.float32),
                    [-4, -3, -2, -1, 0], n6, n6).tocsr()
    l6 = (l6 + sp.eye(n6) * 8).tocsr()
    l6 = sp.tril(l6).tocsr()
    l6.sort_indices()
    a6 = from_scipy(l6.astype(np.float32))
    tplan = place(sptrsv.build_trisolve_plan(a6, lower=True), dev)
    b6_np = rng.standard_normal(n6).astype(np.float32)
    b6 = on(b6_np)
    x6 = host(sptrsv.trisolve(tplan, b6))
    r6 = b6_np - l6.astype(np.float64) @ x6
    ok6 = np.linalg.norm(r6) < 1e-2 * np.linalg.norm(b6_np)
    dt6 = _chain_time(lambda v: sptrsv.trisolve(tplan, v) * np.float32(0.2),
                      b6, max(iters // 4, 3))
    record("trisolve", ok6, dt6, 2 * a6.nnz, "FLOP")

    return results
