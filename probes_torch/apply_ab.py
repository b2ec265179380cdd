#!/usr/bin/env python3
"""The applies of the smoke's SpMV phases, timed in one tree.

    python3 probes_torch/apply_ab.py [--tree DIR] [--rounds N] [--tag T]
        [--phases dia,sharded_dia,...]

Imports the port and ``chip_smoke.py`` from ``DIR`` (default: this
checkout; a ``git archive`` of another commit to compare with), plans
the smoke's float32 draws at their full size (``dia``, ``sell``,
``hybrid``, ``chunk``, ``packed``, ``cached``, ``deep`` and ``stream``,
made as ``chip_smoke.main`` makes them, from the same seeds), the
sharded DIA headline (``sharded_dia``) and the sharded shuffled band
(``sharded_sell``, halo exchange), four shards on the card, the SpMV of
the solver phases' DIA systems (``cg``: the 2^20-row band of
``chip_smoke.banded_system``; ``pcg_ilu0``: ``chip_smoke.spd_banded`` at
2^15 rows), the headline's bfloat16 and float16 plans, whole and
sharded (``dia_bf16``, ``dia_f16``, ``sharded_dia_bf16``,
``sharded_dia_f16``), the headline band's leading 8192 rows
(``dia_small``: a few us on the card, so its events time is the apply's
host dispatch), and the typed applies of kernels B, E and F, values and
x drawn as ``chip_smoke.dtype_phases`` draws them: ``packed_<kind>``
(``mac_econ_like`` in bf16, f16, i8, u8, i16, u16, i32 and u32),
``sell_bf16`` and ``sell_f16`` (the shuffled band), ``hybrid_i8``,
``_u8``, ``_i16`` and ``_u16`` (the Hybrid cut to 2^18 rows) and
``sell_u8_max`` (the cut band under max_times); or only the
``--phases`` named.  Times each apply ``N`` rounds over (default 3): the
CUDA-event median of 30 calls, the profiler's device busy time of 20,
as the smoke's "the apply, end to end" section does, and the device
time within it of kernels A and M (``dia_us``), B (``b_us``), E
(``e_us``) and F (``f_us``).  Prints one JSON line, ``{"tree": ...,
"tag": ..., "card": ..., "phases": {name: {"ev_us": [...], "busy_us":
[...], "dia_us": [...], "b_us": [...], "e_us": [...], "f_us":
[...]}}}``, a value a round.  To compare two trees on one card, run it
in turns in one chip call (parent, change, change, parent) and compare
the rounds' medians.  Needs one CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--tag", default="")
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to time (default: all)")
    args = ap.parse_args()
    picked = set(filter(None, args.phases.split(",")))

    def wanted(name):
        return not picked or name in picked

    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)          # the kernels build into the tree's _build/

    import numpy as np
    import scipy.sparse as sp
    import torch

    import chip_smoke as cs
    from spmv_vector_cache_tpu_torch.formats.convert import (COO, coo_to_csr,
                                                             from_scipy)
    from spmv_vector_cache_tpu_torch.ops import _kernels
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
    from spmv_vector_cache_tpu_torch.parallel import (build_sharded_dia_plan,
                                                      build_sharded_plan,
                                                      make_mesh,
                                                      place_on_mesh,
                                                      spmv_dia_sharded,
                                                      spmv_sharded)
    from spmv_vector_cache_tpu_torch.tools import realistic

    assert torch.cuda.is_available(), "needs a CUDA device"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _kernels.build()
    _kernels.library()
    dev = torch.device("cuda")

    # the draws, as chip_smoke.main makes them (same seeds, same order)
    n, ndiag = 1 << 20, 27
    rng = np.random.default_rng(0)
    offs = list(range(-(ndiag // 2), ndiag // 2 + 1))
    band = sp.spdiags(rng.standard_normal((ndiag, n)).astype(np.float32),
                      offs, n, n).tocsr()
    band.sort_indices()
    x_dia = rng.standard_normal(n).astype(np.float32)
    ns, blk = n >> 1, 128
    rsh = np.repeat(np.arange(ns, dtype=np.int64), ndiag)
    csh = ((rsh // blk) * blk
           + rng.integers(0, blk, rsh.shape[0])).astype(np.int32)
    a_sell = coo_to_csr(COO(
        data=rng.standard_normal(rsh.shape[0]).astype(np.float32),
        row=rsh.astype(np.int32), col=csh, shape=(ns, ns)))
    x_sell = rng.standard_normal(ns).astype(np.float32)
    rng_h = np.random.default_rng(0)
    rr = np.repeat(np.arange(n, dtype=np.int64), 2)
    cc = np.clip(rr + rng_h.integers(-512, 513, rr.shape[0]), 0, n - 1)
    resid = sp.csr_matrix((rng_h.standard_normal(rr.shape[0]).astype(
        np.float32), (rr, cc)), shape=(n, n))
    m_hyb = (band + resid).tocsr().astype(np.float32)
    m_hyb.sort_indices()
    x_hyb = rng_h.standard_normal(n).astype(np.float32)
    a_chunk = realistic.scircuit_like()
    a_packed = realistic.mac_econ_like()
    rng_x = np.random.default_rng(0)
    x_chunk = rng_x.standard_normal(a_chunk.shape[1]).astype(np.float32)
    x_packed = rng_x.standard_normal(a_packed.shape[1]).astype(np.float32)
    rng_z = np.random.default_rng(3)
    a_cached = cs.zipf_cols_matrix(rng_z)
    x_cached = rng_z.standard_normal(a_cached.shape[1]).astype(np.float32)
    rng_u = np.random.default_rng(3)
    a_deep = cs.uniform_matrix(rng_u)
    x_deep = np.abs(rng_u.standard_normal(a_deep.shape[1])).astype(
        np.float32)

    ops = {}
    for name, a, x, semiring in (
            ("dia", from_scipy(band), x_dia, "plus_times"),
            ("sell", a_sell, x_sell, "plus_times"),
            ("hybrid", from_scipy(m_hyb), x_hyb, "plus_times"),
            ("chunk", a_chunk, x_chunk, "plus_times"),
            ("packed", a_packed, x_packed, "plus_times"),
            ("cached", a_cached, x_cached, "plus_times"),
            ("deep", a_deep, x_deep, "min_plus"),
            # the band's leading 8192 rows: one step, a few us on the
            # card, so the apply's time is its host dispatch
            ("dia_small", from_scipy(band[:8192, :8192]), x_dia[:8192],
             "plus_times")):
        if wanted(name) or (name == "deep" and wanted("stream")):
            op = SparseOperator.from_matrix(a, semiring=semiring)
            ops[name] = (op, torch.from_numpy(x).to(dev))
    if wanted("stream"):
        ops["stream"] = (SparseOperator(ops["deep"][0].plan,
                                        strategy="stream",
                                        semiring="min_plus"), ops["deep"][1])
    for name, m in (("cg", lambda: cs.banded_system(n)),
                    ("pcg_ilu0", lambda: cs.spd_banded(
                        np.random.default_rng(0), 1 << 15).astype(
                            np.float32))):
        if wanted(name):
            m = m()
            x = np.random.default_rng(1).standard_normal(m.shape[1])
            ops[name] = (SparseOperator.from_matrix(from_scipy(m)),
                         torch.from_numpy(x.astype(np.float32)).to(dev))
    for kind, vdt in (("bf16", "bfloat16"), ("f16", np.float16)):
        if wanted(f"dia_{kind}"):
            x = torch.from_numpy(x_dia).to(dev)
            ops[f"dia_{kind}"] = (SparseOperator.from_matrix(
                from_scipy(band), value_dtype=vdt),
                x.half() if kind == "f16" else x)
    # the typed applies of kernels B, E and F: mac_econ_like's PackedPlan
    # in every value type but float32 (``packed_<kind>``), the shuffled
    # band in bfloat16 and float16 (``sell_<kind>``), the Hybrid cut to
    # its leading 2^18 rows in the 8- and 16-bit integers
    # (``hybrid_<kind>``), the cut band under max_times in uint8
    # (``sell_u8_max``); values and x as chip_smoke.dtype_phases draws
    # them
    value = {"bf16": "bfloat16", "f16": np.float16, "i8": np.int8,
             "u8": np.uint8, "i16": np.int16, "u16": np.uint16,
             "i32": np.int32, "u32": np.uint32}
    cut = 1 << 18
    typed = [(f"packed_{k}", a_packed, k, "plus_times") for k in
             ("bf16", "f16", "i8", "u8", "i16", "u16", "i32", "u32")]
    typed += [(f"sell_{k}", a_sell, k, "plus_times") for k in ("bf16",
                                                               "f16")]
    typed += [(f"hybrid_{k}", m_hyb[:cut, :cut], k, "plus_times")
              for k in ("i8", "u8", "i16", "u16")]
    typed += [("sell_u8_max", band[:cut, :cut], "u8", "max_times")]
    for name, src, kind, semiring in typed:
        if not wanted(name):
            continue
        rng_t = np.random.default_rng(14)
        nonneg = semiring != "plus_times"
        if not isinstance(src, sp.spmatrix):
            src = sp.csr_matrix((src.data, src.indices, src.indptr),
                                shape=src.shape)
        m = cs.typed_matrix(src, kind, rng_t, nonneg)
        xh = cs.typed_vector(kind, m.shape[1], rng_t, nonneg)
        ops[name] = (SparseOperator.from_matrix(
            from_scipy(m), value_dtype=value[kind], semiring=semiring),
            torch.from_numpy(np.ascontiguousarray(xh)).to(dev))
    runs = {name: (lambda op=op, x=x: op @ x) for name, (op, x) in
            ops.items() if wanted(name)}
    mesh = make_mesh(4, device="cuda")
    if wanted("sharded_sell"):
        # the shuffled band as four shards on the card, halo exchange
        ssp = place_on_mesh(build_sharded_plan(a_sell, 4), mesh)
        xs = torch.from_numpy(x_sell).to(dev)
        runs["sharded_sell"] = lambda: spmv_sharded(ssp, xs, mesh)
    x = torch.from_numpy(x_dia).to(dev)
    for kind, vdt in (("", np.float32), ("_bf16", "bfloat16"),
                      ("_f16", np.float16)):
        if wanted("sharded_dia" + kind):
            spd = place_on_mesh(build_sharded_dia_plan(
                from_scipy(band), 4, value_dtype=vdt), mesh)
            xk = x.half() if kind == "_f16" else x
            runs["sharded_dia" + kind] = (
                lambda spd=spd, xk=xk: spmv_dia_sharded(spd, xk, mesh))

    # the kernels each apply's device time is read for, by a part of
    # their names in this tree or an older one: A and M (dia_rows_kernel,
    # or the older one-row spmv_dia_kernel), B (window_lanes_kernel, or
    # the older one-lane window_kernel), E (packed_scan_kernel) and F
    # (packed_rows_kernel)
    kernels = {"dia_us": ("dia_rows_kernel", "spmv_dia_kernel"),
               "b_us": ("window_lanes_kernel", "window_kernel"),
               "e_us": ("packed_scan_kernel",),
               "f_us": ("packed_rows_kernel",)}
    out = {name: {"ev_us": [], "busy_us": [], **{k: [] for k in kernels}}
           for name in runs}
    for _ in range(args.rounds):
        for name, run in runs.items():
            out[name]["ev_us"].append(cs.time_ms(run) * 1e3)
            by = cs.device_us_by_kernel(run)
            out[name]["busy_us"].append(sum(us for us, _ in by.values()))
            for key, parts in kernels.items():
                out[name][key].append(sum(
                    us for k, (us, _) in by.items()
                    if any(part in k for part in parts)))
    print(json.dumps({"tree": tree, "tag": args.tag, "card": card,
                      "phases": out}), flush=True)


if __name__ == "__main__":
    main()
