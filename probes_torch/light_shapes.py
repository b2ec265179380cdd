#!/usr/bin/env python3
"""The work mapping of the chunk light route (``csrc/spmv_chunk_light.cu``)
on the card.

    python3 probes_torch/light_shapes.py

Plans ``tools/realistic.scircuit_like()`` as the smoke's ``chunk`` phase
does (a ChunkPlan placed on the card), then launches the light route on
its light records at every shape: the records a CTA stages through
shared memory at a time (``LIGHT_CHUNK``) and the CTAs an SM must be
able to hold, nvcc's register cap (``LIGHT_MIN_CTAS``), both at compile
time (each build is the same source with them defined, all builds
started together), and the records a CTA takes before its segment is
split (``unit_records`` of ``formats/tables.light_units``, placement
time; the largest keeps every segment whole).  Each is checked against the plain
version (1e-5 of max|y2d|), then timed by CUDA events and by the
profiler's device time, the shapes forward then backward, beside
``torch.sparse.mm`` of the same records as a CSR.  Prints the registers
nvcc gave each build, the bound at 3.35 TB/s, and the card's name and
power limit last.  Needs one CUDA device (about 1 min).
"""

import argparse
import ctypes
import dataclasses
import itertools
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from spmv_vector_cache_tpu_torch.formats.chunk import ChunkPlan  # noqa: E402
from spmv_vector_cache_tpu_torch.formats.plan import (  # noqa: E402
    auto_plan, place)
from spmv_vector_cache_tpu_torch.formats.tables import (  # noqa: E402
    light_units)
from spmv_vector_cache_tpu_torch.ops import _kernels  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import semiring as sr  # noqa: E402
from spmv_vector_cache_tpu_torch.ops.spmv_chunk import (  # noqa: E402
    light_plain)
from spmv_vector_cache_tpu_torch.tools import realistic  # noqa: E402

#: (LIGHT_CHUNK, LIGHT_MIN_CTAS)
BUILDS = list(itertools.product((256, 512, 1024, 2048), (1, 12, 16)))
UNITS = (128, 256, 512, 1024, 1 << 30)
SOURCE = os.path.join(ROOT, "spmv_vector_cache_tpu_torch", "csrc",
                      "spmv_chunk_light.cu")


def build_all(tmp):
    """Each build's library, built concurrently; returns ({(chunk,
    min_ctas): its spmv_chunk_light_f32}, {the same: nvcc's register
    line})."""
    cmds = {c: [_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                f"-DLIGHT_CHUNK={c[0]}", f"-DLIGHT_MIN_CTAS={c[1]}",
                "-shared", "-o", os.path.join(tmp, "light_%d_%d.so" % c),
                SOURCE]
            for c in BUILDS}
    procs = {c: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for c, cmd in cmds.items()}
    fns, regs = {}, {}
    for c, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {c}:\n{out}")
        got = re.search(r"Used \d+ registers[^\n]*",
                        out.split("light_rows_kernel", 1)[-1])
        regs[c] = got.group(0) if got else "?"
        fn = ctypes.CDLL(cmds[c][-2]).spmv_chunk_light_f32
        fn.argtypes = _kernels.SIGNATURES["spmv_chunk_light_f32"]
        fn.restype = ctypes.c_int
        fns[c] = fn
    return fns, regs


def main():
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tmp = tempfile.TemporaryDirectory()
    fns, regs = build_all(tmp.name)
    dev = torch.device("cuda")
    a = realistic.scircuit_like()
    plan = place(auto_plan(a), dev)
    assert isinstance(plan, ChunkPlan), type(plan)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        a.shape[1]).astype(np.float32)).to(dev)
    light = plan.light
    nrec, nrows = light.vals.shape[0], light.row_off.shape[0] - 1
    works = {u: dataclasses.replace(light, units=torch.from_numpy(
        light_units(light.row_off.cpu().numpy(), u)).to(dev))
        for u in UNITS}
    nbyte = (cs.nbytes(light.row_off, light.cols, light.vals, light.tiled,
                       light.units) + cs.x_bytes_read(x, light.cols)
             + nrows * 4)
    print(f"scircuit_like: {nrec} records in {nrows} lane rows; bound "
          f"{nbyte} bytes = {nbyte / cs.PEAK_BYTES_PER_S * 1e6:.3f} us at "
          f"3.35 TB/s; CTAs by unit_records: "
          f"{ {u: w.units.shape[0] - 1 for u, w in works.items()} }")
    ref = light_plain(light, x, semiring="plus_times")
    tol = cs.KERNEL_RTOL * max(1.0, float(ref.abs().max()))
    stream = _kernels.current_stream(0)
    code = sr.KERNEL_CODE["plus_times"]

    def call_for(c, m, u):
        w, fn = works[u], fns[(c, m)]

        def call():
            y = torch.empty_like(ref)
            err = fn(w.row_off.data_ptr(), w.cols.data_ptr(),
                     w.vals.data_ptr(), w.tiled.data_ptr(),
                     w.units.data_ptr(), x.data_ptr(), y.data_ptr(),
                     w.units.shape[0] - 1, x.shape[0], code, stream)
            assert err == 0, ((c, m, u), err)
            return y
        return call

    todo = [(c, m, u) for (c, m), u in itertools.product(BUILDS, UNITS)]
    calls = {}
    for s in todo:
        call = call_for(*s)
        err = cs.max_abs(call(), ref)
        assert err <= tol, (s, err)
        calls[s] = call
    csr = torch.sparse_csr_tensor(light.row_off.long(), light.cols.long(),
                                  light.vals, size=(nrows, a.shape[1]))
    x_col = x.reshape(-1, 1)
    calls["torch.sparse.mm"] = lambda: torch.sparse.mm(csr, x_col)
    todo.append("torch.sparse.mm")
    res = {s: [] for s in todo}
    for order in (todo, todo[::-1]):
        for s in order:
            ms = cs.time_ms(calls[s])
            by_kernel = cs.device_us_by_kernel(calls[s])
            us = sum(t for t, _ in by_kernel.values()) if by_kernel \
                else float("nan")     # the profiler saw nothing
            res[s].append((ms, us))
    for s in sorted(res, key=lambda s: np.nanmin([u for _, u in res[s]]
                                                 + [np.inf])):
        (m1, u1), (m2, u2) = res[s]
        what = s if isinstance(s, str) else \
            f"LIGHT_CHUNK={s[0]:4d} LIGHT_MIN_CTAS={s[1]:2d} " \
            f"unit_records={s[2]:10d}"
        note = "" if isinstance(s, str) else f" ({regs[s[:2]]})"
        print(f"{what}: device {u1:.2f} / {u2:.2f} us, events "
              f"{m1 * 1e3:.2f} / {m2 * 1e3:.2f} us{note}")
    tmp.cleanup()
    print(smi)


if __name__ == "__main__":
    main()
