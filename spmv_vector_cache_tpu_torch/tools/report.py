"""GPU benchmark report (counterpart of
``spmv_vector_cache_tpu/tools/report.py``).

Runs on the card: (1) the benchapp sweep over matrix directories written
from the degree-calibrated generators (``tools/realistic.py``) into a
temporary directory, golden-checked; (2) a large-matrix set spanning the
plan design space (banded DIA/SELL, shuffled band, block random,
power-law rows, zipf columns, uniform random); (3) the generators'
matrices themselves; (4) the BASELINE workload suite.  Writes
``BENCHMARKS.md`` and CSVs under ``benchmarks/`` inside ``--out``, never
into the repository's own root.  The header names the card and its power
limit.  A row whose time is the timing floor carries no rate.

Usage:
  python -m spmv_vector_cache_tpu_torch.tools.report --out DIR [--quick]
"""

from __future__ import annotations

import argparse
import datetime
import io
import os
import subprocess
import sys
import tempfile
from typing import Any, Dict, List

import numpy as np
import torch

#: the repository root, where the report must not write
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _chain_rate(plan, x0: torch.Tensor, i1=10, i2=40) -> float:
    """Marginal time per apply via chained power iterations."""
    from ..ops.spmv_sell import spmv_plan
    from ..utils import roofline

    def make(iters):
        def go():
            v = x0
            for _ in range(iters):
                w = spmv_plan(plan, v)
                v = w / torch.linalg.vector_norm(w).clamp(min=1e-30)
            return v[:1]
        return go

    return roofline.time_marginal(make, i1=i1, i2=i2)


def _plan_chain(plan) -> str:
    from ..formats.cached import CachedPlan, CooTail

    parts = []
    p = plan
    while isinstance(p, CachedPlan):
        parts.append(f"hot{p.hot_cols.shape[0]}")
        p = p.cold
    if p is None:
        parts.append("-")
    elif isinstance(p, CooTail):
        parts.append(f"coo{p.nnz}")
    else:
        parts.append(type(p).__name__)
    return "+".join(parts) if len(parts) > 1 else type(plan).__name__


def _bench(rng, name, a, csr_roof, *, note="", i1=10, i2=40, plan=None):
    """One golden-checked, timed row on the card."""
    from ..formats.plan import auto_plan, place
    from ..ops import reference
    from ..ops.spmv_sell import spmv_plan
    from ..ops.strategy import plan_nnz
    from ..utils import roofline

    plan = auto_plan(a) if plan is None else plan
    pd = place(plan, torch.device("cuda"))
    x_np = rng.standard_normal(a.shape[1]).astype(np.float32)
    x0 = torch.from_numpy(x_np).cuda()
    y = spmv_plan(pd, x0).cpu().numpy()
    want = reference.spmv_numpy(a, x_np.astype(np.float64))
    err = float(np.abs(y - want).max() / max(1.0, np.abs(want).max()))
    if not err < 2e-3:
        raise RuntimeError(f"{name}: relative error {err:.3g} >= 2e-3")
    dt = _chain_rate(pd, x0, i1, i2)
    nnz = plan_nnz(pd)
    floor = roofline.at_floor(dt)
    row = {"matrix": name, "rows": a.shape[0], "cols": a.shape[1],
           "nnz": nnz, "plan": _plan_chain(plan),
           "gnnz_per_s": "" if floor else round(nnz / dt / 1e9, 2),
           "ms_per_apply": "" if floor else round(dt * 1e3, 3),
           "pct_of_csr_roofline": "" if floor else
           round(100 * (nnz / dt) / csr_roof, 1),
           "max_rel_err": f"{err:.1e}",
           "note": "timing floor: no rate; " + note if floor else note}
    log(f"  {name}: {row['gnnz_per_s']} Gnnz/s "
        f"({row['pct_of_csr_roofline']}% CSR roofline) plan={row['plan']}")
    return row


def _roofline():
    from ..utils import roofline

    bw = roofline.measure_stream_bandwidth(mode="read")
    csr_roof = roofline.spmv_roofline_nnz_per_s(bw)
    log(f"measured read BW {bw/1e9:.0f} GB/s -> CSR roofline "
        f"{csr_roof/1e9:.1f} Gnnz/s")
    return csr_roof


def large_matrix_rows(quick: bool = False) -> List[Dict[str, Any]]:
    import scipy.sparse as sp

    from ..formats.containers import COO
    from ..formats.convert import coo_to_csr, from_scipy
    from ..formats.plan import auto_plan
    from ..utils.platform import require_cuda

    require_cuda()
    rng = np.random.default_rng(3)
    rows_out: List[Dict[str, Any]] = []
    csr_roof = _roofline()

    def bench(name, a, **kw):
        rows_out.append(_bench(rng, name, a, csr_roof, **kw))

    n = 1 << 19 if quick else 1 << 20
    nd = 27
    m = sp.spdiags(rng.standard_normal((nd, n)).astype(np.float32),
                   list(range(-(nd // 2), nd // 2 + 1)), n, n).tocsr()
    m.sort_indices()
    a = from_scipy(m.astype(np.float32))
    bench("banded_27diag", a, note="headline structure; DIA plan",
          i1=30, i2=120)
    bench("banded_27diag_sell", a, note="general SELL window path",
          plan=auto_plan(a, allow_dia=False), i1=20, i2=80)

    # shuffled band: the same row structure, diagonals destroyed
    ns = 1 << 19
    blk = 512   # shuffle 512-row blocks; within-block locality survives
    perm = rng.permutation(ns // blk).astype(np.int64)
    ms = sp.spdiags(rng.standard_normal((nd, ns)).astype(np.float32),
                    list(range(-(nd // 2), nd // 2 + 1)), ns, ns).tocsr()
    ms.sort_indices()
    coo = ms.tocoo()
    rowblk = perm[coo.row // blk] * blk + coo.row % blk
    colblk = perm[coo.col // blk] * blk + coo.col % blk
    ash = coo_to_csr(COO(data=coo.data.astype(np.float32),
                         row=rowblk.astype(np.int32),
                         col=colblk.astype(np.int32), shape=(ns, ns)))
    bench("block_shuffled_band", ash,
          note="band with shuffled blocks; hybrid dia+SELL", i1=20, i2=80)

    # block-diagonal with random in-block offsets (community/FEM class)
    rb = np.repeat(np.arange(ns, dtype=np.int64), nd)
    cb = ((rb // 128) * 128
          + rng.integers(0, 128, rb.shape[0])).astype(np.int32)
    abr = coo_to_csr(COO(data=rng.standard_normal(rb.shape[0])
                         .astype(np.float32),
                         row=rb.astype(np.int32), col=cb,
                         shape=(ns, ns)))
    bench("block_random", abr,
          note="non-DIA, bounded spans; general windowed SELL",
          i1=20, i2=80)

    # power-law rows (config 2 structure)
    n2 = 1 << 17
    lens = np.minimum((rng.pareto(1.2, n2) * 8).astype(np.int64) + 1, 8192)
    r2 = np.repeat(np.arange(n2), lens)
    c2 = np.minimum((np.abs(rng.standard_normal(r2.shape[0])) * 2048)
                    .astype(np.int64) + r2 - 1024, n2 - 1)
    c2 = np.maximum(c2, 0).astype(np.int32)
    a2 = coo_to_csr(COO(data=rng.standard_normal(r2.shape[0])
                        .astype(np.float32),
                        row=r2.astype(np.int32), col=c2, shape=(n2, n2)))
    bench("powerlaw_rows", a2, note="skewed row lengths; split+sigma")

    # zipf column popularity, no locality (webbase class) -> cached tiers
    nz = 1 << 18
    for npr, s in ([(64, 2.5)] if quick else [(24, 2.0), (64, 2.5)]):
        rz = np.repeat(np.arange(nz, dtype=np.int64), npr)
        ranks = np.arange(nz, dtype=np.float64) + 10.0
        wz = ranks ** -s
        wz /= wz.sum()
        cz = rng.choice(nz, size=rz.shape[0], p=wz).astype(np.int32)
        cz = rng.permutation(nz).astype(np.int32)[cz]
        az = coo_to_csr(COO(data=rng.standard_normal(rz.shape[0])
                            .astype(np.float32),
                            row=rz.astype(np.int32), col=cz,
                            shape=(nz, nz)))
        bench(f"zipf{s}_cols_{npr}perrow", az,
              note="no locality, striping refused; cached tiers")

    # uniform random, no locality, no skew: the packed floor
    nu = 1 << 18
    ru = np.repeat(np.arange(nu, dtype=np.int64), 16)
    cu = rng.integers(0, nu, ru.shape[0]).astype(np.int32)
    au = coo_to_csr(COO(data=rng.standard_normal(ru.shape[0])
                        .astype(np.float32),
                        row=ru.astype(np.int32), col=cu, shape=(nu, nu)))
    bench("uniform_random", au,
          note="worst case: no structure at all; packed two-pass")
    return rows_out


def _realistic_names(quick: bool) -> List[str]:
    from .realistic import MATRICES

    names = list(MATRICES)
    return names[:2] if quick else names


def realistic_matrix_rows(quick: bool = False):
    """Bench the degree-calibrated stand-ins for the reference's
    SuiteSparse evaluation suite (``tools/realistic.py``)."""
    from ..utils.platform import require_cuda
    from .realistic import MATRICES

    require_cuda()
    rng = np.random.default_rng(9)
    csr_roof = _roofline()
    rows_out = []
    for name in _realistic_names(quick):
        gen, note = MATRICES[name]
        rows_out.append(_bench(rng, name, gen(), csr_roof, note=note))
    return rows_out


def write_matrix_dirs(out_base: str, names: List[str]) -> List[str]:
    """Write each generator's matrix (float64 values) in the reference
    wire format, with its golden, into ``out_base/<name>`` through
    ``matrixtools``; returns the directories."""
    from ..formats.containers import CSC
    from ..formats.convert import csr_to_csc
    from . import matrixtools
    from .realistic import MATRICES

    dirs = []
    for name in names:
        csc = csr_to_csc(MATRICES[name][0]())
        csc = CSC(data=np.asarray(csc.data, np.float64), indices=csc.indices,
                  indptr=csc.indptr, shape=csc.shape)
        d = os.path.join(out_base, name)
        matrixtools.convert_matrix(csc, d, name=name)
        matrixtools.make_golden_result(csc, d)
        dirs.append(d)
    return dirs


def _csv(rows: List[Dict[str, Any]]) -> str:
    keys = list(rows[0].keys())
    return "".join([",".join(keys) + "\n"] +
                   [",".join(str(r[k]) for k in keys) + "\n"
                    for r in rows])


def write_report(out_dir: str, quick: bool = False) -> str:
    from ..utils.platform import require_cuda
    from .benchapp import run_sweep
    from .suite import run_suite

    if os.path.realpath(out_dir) == os.path.realpath(REPO_ROOT):
        raise ValueError("the report writes BENCHMARKS.md and benchmarks/: "
                         "give it a directory other than the repository's "
                         "root")
    require_cuda()
    bench_dir = os.path.join(out_dir, "benchmarks")
    os.makedirs(bench_dir, exist_ok=True)
    card = card_line()
    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M")

    # 1. the generators' matrices in the wire format (golden-checked),
    # written to a temporary directory
    log("== matrix-directory sweep ==")
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = write_matrix_dirs(tmp, _realistic_names(quick))
        rc = run_sweep(dirs, ["auto"], iters=50, out=buf)
    sweep_csv = buf.getvalue()
    with open(os.path.join(bench_dir, "matrix_dir_sweep.csv"), "w") as f:
        f.write(sweep_csv)

    # 2. large synthetic matrices across the plan design space
    log("== large-matrix benches ==")
    large = large_matrix_rows(quick=quick)
    with open(os.path.join(bench_dir, "large_matrices.csv"), "w") as f:
        f.write(_csv(large))

    # 2b. degree-calibrated SuiteSparse-class matrices
    log("== realistic-matrix benches ==")
    real = realistic_matrix_rows(quick=quick)
    with open(os.path.join(bench_dir, "realistic.csv"), "w") as f:
        f.write(_csv(real))

    # 3. BASELINE workload suite
    log("== workload suite ==")
    suite = run_suite(iters=10 if quick else 20)
    with open(os.path.join(bench_dir, "suite.csv"), "w") as f:
        f.write("config,ok,seconds,rate,unit\n")
        for r in suite:
            rate = "" if r["rate"] is None else f"{r['rate']:.3f}"
            f.write(f"{r['config']},{r['ok']},{r['seconds']:.6f},"
                    f"{rate},{r['unit']}\n")

    # 4. markdown
    md = ["# GPU benchmarks\n",
          f"Measured on `{card}` (name, power limit), {stamp}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}.  Every row is "
          f"checked against the float64 host loop before timing; timing "
          f"is the two-point marginal over chained applies "
          f"(`utils/roofline.time_marginal`), host wall time per apply.  "
          f"Regenerate with "
          f"`python -m spmv_vector_cache_tpu_torch.tools.report --out "
          f"DIR`.\n"]

    for title, rows, last in (
            ("## Large matrices (plan design space)\n", large, "note"),
            ("## SuiteSparse-class matrices (degree-calibrated stand-ins, "
             "tools/realistic.py)\n", real, "models")):
        md.append(title)
        md.append("| matrix | rows x cols | nnz | plan | Gnnz/s | ms/apply "
                  f"| % CSR roofline | max rel err | {last} |")
        md.append("|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            md.append(f"| {r['matrix']} | {r['rows']}x{r['cols']} | "
                      f"{r['nnz']} | {r['plan']} | {r['gnnz_per_s']} | "
                      f"{r['ms_per_apply']} | {r['pct_of_csr_roofline']} | "
                      f"{r['max_rel_err']} | {r['note']} |")
        md.append("")

    md.append("## Workload suite (BASELINE configs)\n")
    md.append("| config | ok | ms | rate |")
    md.append("|---|---|---|---|")
    for r in suite:
        rate = "timing floor: no rate" if r["rate"] is None else \
            f"{r['rate']:.2f} G{r['unit']}/s"
        md.append(f"| {r['config']} | {r['ok']} | "
                  f"{r['seconds']*1e3:.3f} | {rate} |")
    md.append("")

    md.append("## Matrix directories (benchapp sweep)\n")
    md.append("The generators' matrices written in the reference's wire "
              "format with their goldens, loaded back and golden-checked "
              "(`diffFromGolden` counts mismatches against `golden.bin`).\n")
    md.append("```")
    md.append(sweep_csv.rstrip())
    md.append("```")
    text = "\n".join(md) + "\n"
    with open(os.path.join(out_dir, "BENCHMARKS.md"), "w") as f:
        f.write(text)
    if rc:
        log("WARNING: benchapp reported a mismatch (rc=1)")
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True,
                    help="output directory (not the repository's root)")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    write_report(args.out, quick=args.quick)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
