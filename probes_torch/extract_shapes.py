#!/usr/bin/env python3
"""The launch shapes of kernel F (``csrc/spmv_packed.cu``) on the card.

    python3 probes_torch/extract_shapes.py

Plans ``tools/realistic.mac_econ_like()`` as the smoke's ``packed``
phase does (a PackedPlan placed on the card), runs kernel E once, then
launches kernel F on that scan at every launch shape: the rows a CTA
writes (``PACKED_F_BLOCK_ROWS``, 8 a thread, the overflow regrouped for
it), the thread groups of a CTA that split a window's visits
(``PACKED_F_GROUPS``) and the visits a thread loads before it sums them
(``PACKED_F_BATCH``).  The library builds one shape; each shape here is
the same source built by nvcc with those defined, all builds started
together.  Each is checked against the plain version (1e-5 of max|y|),
then timed by CUDA events and by the profiler's device time, the shapes
forward then backward.  Prints the registers nvcc gave each shape, the
bound at 3.35 TB/s, and the card's name and power limit last.  Needs one
CUDA device (about 2 min).
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
from spmv_vector_cache_tpu_torch.formats.packed import (  # noqa: E402
    build_packed_plan)
from spmv_vector_cache_tpu_torch.formats.plan import place  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import _kernels  # noqa: E402
from spmv_vector_cache_tpu_torch.ops.runs import (  # noqa: E402
    EXTRACT_BLOCK_ROWS, extract_on)
from spmv_vector_cache_tpu_torch.ops.spmv_packed import (  # noqa: E402
    packed_rows_plain, packed_scan_kernel)
from spmv_vector_cache_tpu_torch.tools import realistic  # noqa: E402

#: (block_rows, groups, batch): at most 512 threads a CTA
SHAPES = [(rb, g, u) for rb, g, u in itertools.product(
    (256, 512, 1024, 2048), (1, 2, 4, 8), (1, 2, 4, 8)) if rb // 8 * g <= 512]
SOURCE = os.path.join(ROOT, "spmv_vector_cache_tpu_torch", "csrc",
                      "spmv_packed.cu")


def build_shapes(tmp):
    """Every shape's library, built concurrently; returns ({shape: its
    packed_extract_f32}, {shape: nvcc's register line for kernel F})."""
    cmds = {s: [_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                f"-DPACKED_F_BLOCK_ROWS={s[0]}", f"-DPACKED_F_GROUPS={s[1]}",
                f"-DPACKED_F_BATCH={s[2]}", "-shared", "-o",
                os.path.join(tmp, "f_%d_%d_%d.so" % s), SOURCE]
            for s in SHAPES}
    procs = {s: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for s, c in cmds.items()}
    fns, regs = {}, {}
    for s, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {s}:\n{out}")
        entry = out.split("packed_rows_kernel", 1)[-1]
        got = re.search(r"Used \d+ registers[^\n]*", entry)
        regs[s] = got.group(0) if got else "?"
        fn = ctypes.CDLL(cmds[s][-2]).packed_extract_f32
        fn.argtypes = _kernels.SIGNATURES["packed_extract_f32"]
        fn.restype = ctypes.c_int
        fns[s] = fn
    return fns, regs


def regroup(tables, rows, block_rows):
    """``tables`` with the overflow grouped by ``block_rows`` rows (the
    entries stay in their order: sorted by row, the plan's within one)."""
    per_block = (tables.ov_off[1:] - tables.ov_off[:-1]).long()
    block = torch.repeat_interleave(
        torch.arange(per_block.shape[0], device=per_block.device), per_block)
    row = block * EXTRACT_BLOCK_ROWS + tables.ov_lane.long()
    off = torch.searchsorted(row // block_rows, torch.arange(
        -(-rows // block_rows) + 1, device=row.device))
    return dataclasses.replace(
        tables, ov_off=off.to(torch.int32).contiguous(),
        ov_lane=(row % block_rows).to(torch.int32).contiguous())


def main():
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tmp = tempfile.TemporaryDirectory()
    fns, regs = build_shapes(tmp.name)
    dev = torch.device("cuda")
    a = realistic.mac_econ_like()
    plan = place(build_packed_plan(a), dev)
    st = plan.stats
    rows = plan.shape[0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        a.shape[1]).astype(np.float32)).to(dev)
    scan = packed_scan_kernel(plan.vals, plan.cols, plan.cstep, x,
                              chunk_blocks=st.chunk_blocks,
                              step_tiles=st.step_tiles)
    t = extract_on(plan)
    tabs = {rb: regroup(t, rows, rb) for rb in (256, 512, 1024, 2048)}
    parts = cs.packed_extract_bytes(plan, t, x)
    nbyte = sum(parts.values())
    print(f"mac_econ_like: {rows} rows, {st.num_steps_b} visits, "
          f"{st.num_windows} windows, {parts['picked S entries'] // 4} "
          f"picked entries, {st.overflow_nnz} overflow; bound {nbyte} "
          f"bytes = {nbyte / cs.PEAK_BYTES_PER_S * 1e6:.3f} us at 3.35 TB/s")
    ref = packed_rows_plain(scan, plan.sblock, plan.esrc, x, t, rows=rows,
                            step_tiles=st.step_tiles)
    tol = cs.KERNEL_RTOL * max(1.0, float(ref.abs().max()))
    stream = _kernels.current_stream(0)

    def call_for(rb, g, u):
        tb, fn = tabs[rb], fns[(rb, g, u)]

        def call():
            y = torch.empty(rows, dtype=torch.float32, device=dev)
            err = fn(scan.data_ptr(), plan.sblock.data_ptr(),
                     tb.woff.data_ptr(), plan.esrc.data_ptr(),
                     tb.ov_off.data_ptr(), tb.ov_lane.data_ptr(),
                     tb.ov_cols.data_ptr(), tb.ov_vals.data_ptr(),
                     x.data_ptr(), y.data_ptr(), rows, st.step_tiles * 1024,
                     stream)
            assert err == 0, ((rb, g, u), err)
            return y
        return call

    todo = SHAPES
    calls = {}
    for s in todo:
        call = call_for(*s)
        err = cs.max_abs(call(), ref)
        assert err <= tol, (s, err)
        calls[s] = call
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
        print(f"block_rows={s[0]:5d} groups={s[1]} batch={s[2]}: device "
              f"{u1:.2f} / {u2:.2f} us, events {m1 * 1e3:.2f} / "
              f"{m2 * 1e3:.2f} us ({regs[s]})")
    tmp.cleanup()
    print(smi)


if __name__ == "__main__":
    main()
