#!/usr/bin/env python3
"""Kernel B (``csrc/spmv_sell_window.cu`` ``window_lanes_kernel``) at
every launch shape, on the card.

    python3 probes_torch/window_shapes.py [--parent DIR] [--rounds N]
        [--cases band:f32,hybrid_cut:i8,...]

Plans the smoke's window SellPlans on the host and places them: ``band``
(the shuffled band of ``bench.py``, 2^19 rows: 16,384 tiles, K = 1,
groups of 2 folded), ``band_tiles`` (the same plan unfolded, per-tile
partials as a shard of ``sharded_sell`` writes them), ``hybrid`` (the
Hybrid's SELL rest: 8,192 tiles, K = 12, groups of 4), ``hybrid_cut``
(the rest of the Hybrid cut to its leading 2^18 rows, as the narrow
phases run it: 2,048 tiles), ``band_cut_max`` (the DIA headline cut to
2^18 rows under max_times: 8,192 tiles, K = 1, folded) and ``cached``
(the zipf matrix's window tier: 16,384 tiles, K = 2, folded).  For each
``case:kind`` named, draws the slab in that value type and x in its sum
type on the card from a seeded generator (floats N(0, 1), 8-bit integers
from [0, 16), 16-bit from [0, 256), 32-bit from [0, 10)), and launches B
at every shape: this tree's build (4 lanes a thread, 4 positions in
flight) and the variants built from ``csrc/spmv_sell_window.cu`` alone
with ``-D`` (``SPMV_WINDOW_LANES`` 1, 2, 8 and 16 lanes a thread,
``SPMV_WINDOW_UNROLL`` 2 and 8 positions in flight), at 64, 128 and 256
threads a CTA.  Each is held
against the plain version (floats to 1e-5 of max|y|, integers exactly)
and timed by the profiler (device us, 20 launches) in N rounds (default
3), the shapes in turns within a round.  Beside them: the shape
``window_launch_shape`` picks, a launch over one group, the bound at
3.35 TB/s (x and the partials at the value type's width for the 1- and
2-byte integer and float16 builds), and with ``--parent DIR`` that
tree's kernel B on the same inputs.  Prints one JSON line per case,
then the card's name and power limit.  Needs one CUDA device (about 5
min, the variants' builds included).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from probes_torch.dia_shapes import DTYPE, parent_library  # noqa: E402
from probes_torch.scan_shapes import draw  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import _kernels  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import semiring as sr  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import spmv_sell as ps  # noqa: E402

#: the -D variants: lanes a thread, and positions in flight
VARIANTS = {"L1": "-DSPMV_WINDOW_LANES=1", "L2": "-DSPMV_WINDOW_LANES=2",
            "L8": "-DSPMV_WINDOW_LANES=8", "L16": "-DSPMV_WINDOW_LANES=16",
            "U2": "-DSPMV_WINDOW_UNROLL=2", "U8": "-DSPMV_WINDOW_UNROLL=8"}
CASES = ("band:f32,band:bf16,band:f16,band:i8,band_tiles:f32,hybrid:f32,"
         "hybrid:i32,hybrid_cut:i8,hybrid_cut:i16,hybrid_cut:f32,"
         "band_cut_max:u8,cached:f32")


def lanes_of(name):
    """The lanes a thread of a build: this tree's, or a variant's."""
    return int(name[1:]) if name.startswith("L") else ps.WINDOW_LANES


def variant_libraries():
    """Every variant of ``spmv_sell_window.cu`` built alone (in
    parallel), its B entry points bound as ``_kernels`` binds them."""
    tmp = tempfile.mkdtemp(dir=_kernels.BUILD)
    cmds, paths = [], {}
    for name, defines in VARIANTS.items():
        so = os.path.join(tmp, f"libwindow_{name}.so")
        cmds.append([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                     *defines.split(), "-shared", "-o", so,
                     str(_kernels.CSRC / "spmv_sell_window.cu")])
        paths[name] = so
    _kernels._run_all(cmds)
    libs = {}
    for name, so in paths.items():
        lib = ctypes.CDLL(so)
        for entry, argtypes in _kernels.SIGNATURES.items():
            if entry.startswith("spmv_sell_window_") and \
                    entry != "spmv_sell_window_f64":
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def draws():
    """The host matrices of the cases, as chip_smoke.main makes them."""
    import scipy.sparse as sp

    from spmv_vector_cache_tpu_torch.formats.convert import COO, coo_to_csr

    n, ndiag = 1 << 20, 27
    rng = np.random.default_rng(0)
    offs = list(range(-(ndiag // 2), ndiag // 2 + 1))
    band = sp.spdiags(rng.standard_normal((ndiag, n)).astype(np.float32),
                      offs, n, n).tocsr()
    band.sort_indices()
    rng.standard_normal(n)                               # x_dia
    ns, blk = n >> 1, 128
    rsh = np.repeat(np.arange(ns, dtype=np.int64), ndiag)
    csh = ((rsh // blk) * blk
           + rng.integers(0, blk, rsh.shape[0])).astype(np.int32)
    a_sell = coo_to_csr(COO(
        data=rng.standard_normal(rsh.shape[0]).astype(np.float32),
        row=rsh.astype(np.int32), col=csh, shape=(ns, ns)))
    rng_h = np.random.default_rng(0)
    rr = np.repeat(np.arange(n, dtype=np.int64), 2)
    cc = np.clip(rr + rng_h.integers(-512, 513, rr.shape[0]), 0, n - 1)
    resid = sp.csr_matrix((rng_h.standard_normal(rr.shape[0]).astype(
        np.float32), (rr, cc)), shape=(n, n))
    m_hyb = (band + resid).tocsr().astype(np.float32)
    m_hyb.sort_indices()
    return band, a_sell, m_hyb


def window_plan(case, cache):
    """The case's placed window SellPlan, whether it folds, and its
    semiring."""
    from spmv_vector_cache_tpu_torch.formats.convert import from_scipy
    from spmv_vector_cache_tpu_torch.formats.plan import auto_plan, place

    if "draws" not in cache:
        cache["draws"] = draws()
    band, a_sell, m_hyb = cache["draws"]
    cut = 1 << 18
    semiring = "plus_times"
    if case in ("band", "band_tiles"):
        p = auto_plan(a_sell)
    elif case == "hybrid":
        p = auto_plan(from_scipy(m_hyb)).rest
    elif case == "hybrid_cut":
        p = auto_plan(from_scipy(m_hyb[:cut, :cut])).rest
    elif case == "band_cut_max":
        semiring = "max_times"
        p = auto_plan(from_scipy(abs(band[:cut, :cut])), semiring=semiring)
    else:
        p = auto_plan(cs.zipf_cols_matrix(np.random.default_rng(3))).hot
    assert type(p).__name__ == "SellPlan" and p.stats.window_blocks, case
    p = place(p, torch.device("cuda"))
    fold = ps.folds_groups(p) and case != "band_tiles"
    return p, fold, semiring


def device_us(fn):
    return round(cs.launch_us(fn), 3)


def agree(got, ref):
    if got.dtype.is_floating_point:
        tol = 1e-5 * max(1.0, float(ref.double().abs().max()))
        return cs.max_abs(got, ref) <= tol
    return bool(torch.equal(cs.as_words(got), cs.as_words(ref)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cases", default=CASES)
    args = ap.parse_args()
    assert torch.cuda.is_available(), "needs a CUDA device"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _kernels.library()
    libs = {"this": None, **variant_libraries()}
    old = parent_library(args.parent) if args.parent else None
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    cache, plans = {}, {}
    for item in args.cases.split(","):
        case, kind = item.split(":")
        if case not in plans:
            plans[case] = window_plan(case, cache)
        plan, fold, semiring = plans[case]
        st = plan.stats
        dt = DTYPE[kind]
        vals = draw(dt, tuple(plan.vals.shape), gen, dev)
        xt = sr.x_dtype(dt)
        x = draw(dt if dt in sr.NARROW else xt, (plan.shape[1],), gen,
                 dev).to(xt)
        a = (vals, plan.cols_win, plan.window_base, x)
        kw = dict(group_tiles=st.group_tiles, window_grain=st.window_grain,
                  fold=fold, semiring=semiring)
        T, P, R = vals.shape
        out_rows = T // st.group_tiles if fold else T
        ref = ps.sell_window_plain(*a, **kw)
        picked = ps.kernel_window_shape(vals, st.group_tiles, fold)
        want = ps.sell_window_kernel(*a, **kw)
        assert agree(want, ref), item
        y = torch.empty_like(want)
        stream = _kernels.current_stream(dev.index or 0)
        entry = _kernels.entry("spmv_sell_window_f32", dt)

        def run(lib, L, n, out=y, rows=out_rows, groups=None):
            if lib is None:
                # this tree's wrapper, over the first ``groups`` groups
                t = T if groups is None else groups * st.group_tiles
                g = t // st.group_tiles
                r = g if fold else t
                return ps.sell_window_kernel(
                    vals[:t], plan.cols_win[:t], plan.window_base[:g], x,
                    **kw, shape=ps.WindowShape(L, n, n * (R // L),
                                               -(-r // n)))
            assert getattr(lib, entry)(
                vals.data_ptr(), plan.cols_win.data_ptr(),
                plan.window_base.data_ptr(), x.data_ptr(), out.data_ptr(),
                rows, P, R, st.group_tiles, int(fold), st.window_grain,
                x.shape[0], sr.KERNEL_CODE[semiring], L, n, stream) == 0
            return out

        shapes = {}
        for name, lib in libs.items():
            L = lanes_of(name)
            tpo = R // L
            for threads in (64, 128, 256):
                n = threads // tpo
                if n < 1 or n * tpo != threads or \
                        (name.startswith("U") and threads != 128):
                    continue
                got = run(lib, L, n)
                assert agree(got, ref), (item, name, n)
                shapes[f"{name}:L{L}:n{n}"] = (lib, L, n)
        times = {k: [] for k in shapes}
        out = {"case": case, "kind": kind, "semiring": semiring,
               "tiles": T, "out_rows": out_rows, "K": st.window_blocks,
               "group_tiles": st.group_tiles, "fold": fold,
               "picked": [picked.lanes_per_thread, picked.rows_per_cta,
                          picked.threads, picked.ctas],
               "picked_us": []}
        if old is not None:
            y_old = torch.empty_like(want)

            def old_b():
                assert getattr(old, entry)(
                    vals.data_ptr(), plan.cols_win.data_ptr(),
                    plan.window_base.data_ptr(), x.data_ptr(),
                    y_old.data_ptr(), out_rows, P, R, st.group_tiles,
                    int(fold), st.window_grain, x.shape[0],
                    sr.KERNEL_CODE[semiring], stream) == 0

            old_b()
            torch.cuda.synchronize()
            out["parent_equal"] = agree(y_old, ref)
            out["parent_us"] = []
        for _ in range(args.rounds):
            for k, (lib, L, n) in shapes.items():
                times[k].append(device_us(lambda: run(lib, L, n)))
            out["picked_us"].append(device_us(
                lambda: ps.sell_window_kernel(*a, **kw)))
            if old is not None:
                out["parent_us"].append(device_us(old_b))
        out["one_group_us"] = device_us(
            lambda: run(None, picked.lanes_per_thread, picked.rows_per_cta,
                        groups=1))
        w = dt.itemsize if dt in sr.NARROW else 4
        base = plan.window_base.long().repeat_interleave(
            st.group_tiles) * st.window_grain
        nbyte = (cs.nbytes(vals, plan.cols_win, plan.window_base)
                 + cs.x_bytes_read(x, base[:, None, None]
                                   + plan.cols_win.long(), w)
                 + out_rows * R * w)
        out["bound_us"] = round(nbyte / cs.PEAK_BYTES_PER_S * 1e6, 3)
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        out["best"] = sorted(med.items(), key=lambda kv: kv[1])[:5]
        out["shapes_us"] = times
        print(json.dumps(out), flush=True)
        del vals, x, want, ref, y
        torch.cuda.empty_cache()
    print(card, flush=True)


if __name__ == "__main__":
    main()
