#!/usr/bin/env python3
"""The shapes of kernels G and L on the card, in turns.

    python3 probes_torch/global_shapes.py [--parent DIR]

Times kernel L on the smoke's ``deep_f64`` draw (float64 plus_times,
identity map) and on a uniform-parts float64 plan (2^17 rows of 20
uniform columns, split in two: the lane fold), and kernel G on the
smoke's ``deep`` draw (float32 min_plus) and the ``cached`` phase's
tier 2, in each shape:

* ``auto``: the library as built (``csrc/spmv_sell_global.cu`` picks the
  shape at launch);
* ``runs``: every launch on ``global_runs_kernel`` (shared memory);
* ``rows_bN``: every launch with parts <= 1 on ``global_rows_kernel``, N
  slots' loads before their gathers;
* ``warp_gK``: ``probes_torch/global_shapes.cu``, K thread groups of a
  record in each warp;
* ``parent``: with ``--parent DIR`` (a ``git archive`` of an earlier tree
  whose kernel L writes per-tile partials), that kernel and the
  ``index_add_`` reduce after it.

Each variant is compiled with nvcc from a copy of the source with one
line changed, checked against the plain version, then timed by CUDA
events and by the profiler's device time in turns (the variants forward,
then backward).  Needs one CUDA device; prints the card's name and power
limit last.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from spmv_vector_cache_tpu_torch.formats.plan import (  # noqa: E402
    build_sell_plan, place)
from spmv_vector_cache_tpu_torch.ops import _kernels  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import semiring as sr  # noqa: E402
from spmv_vector_cache_tpu_torch.ops.operator import (  # noqa: E402
    SparseOperator)
from spmv_vector_cache_tpu_torch.ops.spmv_sell import (  # noqa: E402
    _INIT, _reduce_partials, row_parts, sell_global_f64_plain,
    sell_global_plain)

CSRC = os.path.join("spmv_vector_cache_tpu_torch", "csrc")
RULE = "if (parts <= 1 && num_runs > fit) {"
BATCH = "(int)(16 / sizeof(T))"
#: variant: (source lines replaced); None = the library as built
SHAPES = {"auto": None, "runs": [(RULE, "if (false) {")]}
SHAPES.update({f"rows_b{n}": [(RULE, "if (parts <= 1) {"), (BATCH, str(n))]
               for n in (2, 4, 8)})
WARP_GROUPS = (2, 4)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
WARP_SIG = [_P] * 6 + [_L, _I, _I, _L, _I, _L, _I, _P]
PARENT_SIG = [_P] * 4 + [_L, _I, _I, _L, _P]


def nvcc(src, lib, flags=()):
    out = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, *flags,
                          "-shared", "-o", lib, src],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    return ctypes.CDLL(lib)


def shape_lib(tmp, name, subs, csrc=CSRC):
    """The kernel-G/L source with ``subs`` applied, built."""
    d = os.path.join(tmp, name)
    os.makedirs(d)
    for f in ("spmv_sell_global.cu", "values.cuh", "semiring.cuh"):
        shutil.copy(os.path.join(csrc, f), d)
    src = os.path.join(d, "spmv_sell_global.cu")
    text = open(src).read()
    for old, new in subs:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    open(src, "w").write(text)
    lib = nvcc(src, os.path.join(d, "lib.so"))
    for entry in ("spmv_sell_global_f32", "spmv_sell_global_f64"):
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = _kernels.SIGNATURES[entry], ctypes.c_int
    return lib


def cases(dev):
    """name: (plan, x, semiring) on the card."""
    out = {}
    rng = np.random.default_rng(3)
    a = cs.uniform_matrix(rng, dtype=np.float64)
    x = np.abs(rng.standard_normal(a.shape[1]))
    out["L deep_f64"] = (SparseOperator.from_matrix(
        a, value_dtype=np.float64).plan, torch.from_numpy(x).to(dev),
        "plus_times")
    rng = np.random.default_rng(5)
    a = cs.uniform_matrix(rng, n=1 << 17, per_row=20, dtype=np.float64)
    plan = place(build_sell_plan(a, split=16, uniform_split=True,
                                 value_dtype=np.float64), dev)
    assert row_parts(plan) == 2 and plan.stats.window_blocks == 0
    x = np.abs(rng.standard_normal(a.shape[1]))
    out["L fold"] = (plan, torch.from_numpy(x).to(dev), "plus_times")
    rng = np.random.default_rng(3)
    a = cs.uniform_matrix(rng)
    x = np.abs(rng.standard_normal(a.shape[1])).astype(np.float32)
    out["G deep"] = (SparseOperator.from_matrix(a, semiring="min_plus").plan,
                     torch.from_numpy(x).to(dev), "min_plus")
    rng = np.random.default_rng(3)
    a = cs.zipf_cols_matrix(rng)
    x = torch.from_numpy(rng.standard_normal(a.shape[1]).astype(
        np.float32)).to(dev)
    cached = SparseOperator.from_matrix(a).plan
    out["G tier2"] = (cached.cold.hot,
                      x.index_select(0, cached.cold.hot_cols), "plus_times")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked parent tree")
    args = ap.parse_args()
    os.chdir(ROOT)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    stream = _kernels.current_stream(0)
    tmp = tempfile.mkdtemp()
    libs = {n: (_kernels.library() if subs is None else
                shape_lib(tmp, n, subs)) for n, subs in SHAPES.items()}
    warp = {g: nvcc(os.path.join("probes_torch", "global_shapes.cu"),
                    os.path.join(tmp, f"warp{g}.so")) for g in WARP_GROUPS}
    parent = None
    if args.parent:
        parent = shape_lib(tmp, "parent", [], os.path.join(args.parent,
                                                           CSRC))
        parent.spmv_sell_global_f64.argtypes = PARENT_SIG
    for case, (p, x, semiring) in cases(dev).items():
        double = p.stats.double
        w = p.work
        parts = row_parts(p)
        T, P2, R = p.vals.shape
        P = P2 // 2 if double else P2
        shape = (p.shape[0],) if parts else (p.num_slices, R)
        kw = dict(num_slices=p.num_slices, parts=parts, rows=p.shape[0])
        if double:
            ref = sell_global_f64_plain(p.vals, p.cols, p.tile_slice, x, **kw)
        else:
            ref = sell_global_plain(p.vals, p.cols, p.tile_slice, x,
                                    semiring=semiring, **kw)

        def out():
            fill = _INIT[semiring] if w.split else None
            return (torch.empty(shape, dtype=x.dtype, device=dev)
                    if fill is None else
                    torch.full(shape, fill, dtype=x.dtype, device=dev))

        head = (p.vals.data_ptr(), p.cols.data_ptr(),
                p.tile_slice.data_ptr(), w.runs.data_ptr(), x.data_ptr())
        calls = {}
        for name, lib in libs.items():
            if name.startswith("rows") and parts > 1:
                continue                     # the rows shape folds no lanes

            def call(lib=lib):
                o = out()
                tail = (w.runs.shape[0], P, R, x.shape[0], parts, p.shape[0],
                        w.max_tiles, w.max_slices)
                err = (lib.spmv_sell_global_f64(*head, o.data_ptr(), *tail,
                                                stream) if double else
                       lib.spmv_sell_global_f32(*head, o.data_ptr(), *tail,
                                                sr.KERNEL_CODE[semiring],
                                                stream))
                assert err == 0, err
                return o
            calls[name] = call
        entry = "wg_f64" if double else {"min_plus": "wg_f32_minplus",
                                         "plus_times": "wg_f32_plus"}[semiring]
        for g, lib in warp.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = WARP_SIG, ctypes.c_int

            def call(fn=fn, g=g):
                o = out()
                assert fn(*head, o.data_ptr(), w.runs.shape[0], P, R,
                          x.shape[0], parts, p.shape[0], g, stream) == 0
                return o
            calls[f"warp_g{g}"] = call
        if parent is not None and double:
            def call():
                part = torch.empty((T, R), dtype=torch.float64, device=dev)
                assert parent.spmv_sell_global_f64(
                    p.vals.data_ptr(), p.cols.data_ptr(), x.data_ptr(),
                    part.data_ptr(), T, P, R, x.shape[0], stream) == 0
                return _reduce_partials(p, part)
            calls["parent"] = call
        tol = 1e-12 if double else 1e-5
        for name, call in calls.items():
            err = float((call() - ref).abs().max())
            assert err <= tol * max(1.0, float(ref.abs().max())), (case,
                                                                   name, err)
        print(f"{case}: {T} tiles, {w.runs.shape[0]} records of at most "
              f"{w.max_tiles} tiles, parts {parts}, split {w.split}",
              flush=True)
        for name in list(calls) + list(calls)[::-1]:
            ms = cs.time_ms(calls[name])
            by = cs.device_us_by_kernel(calls[name])
            each = ", ".join(f"{k.replace('(anonymous namespace)::', '')[:40]}"
                             f" {us:.2f}" for k, (us, _) in by.items())
            print(f"  {case} {name}: events {ms * 1e3:.2f} us, device "
                  f"{sum(us for us, _ in by.values()):.2f} us ({each})",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
