#!/usr/bin/env python3
"""The launch shapes of kernel F (``csrc/spmv_packed.cu``) on the card.

    python3 probes_torch/extract_shapes.py [--scale 21] [--parent DIR]
        [--rounds N] [--shapes 512x4,256x8]

Places two PackedPlans built by ``build_packed_plan`` at its defaults:
``mac_econ`` (``tools/realistic.mac_econ_like()``, the smoke's
``packed`` phase) and ``kron`` (GAP's Kronecker graph drawn on the card
by ``tools/graphs.kron`` at ``--scale``, PageRank's pull operator, the
``gap_kron_pull`` cell's matrix at its scale and seed by default), runs
kernel E once on each, then launches kernel F on that scan at every
launch shape: the threads a CTA (``PACKED_F_THREADS``) and the merge
steps a thread takes (``PACKED_F_ITEMS``), whose product is the unit by
which placement cuts F's work list, so each shape gets its own list.
The library builds one shape; each shape here is the same source built
by nvcc with those defined, all builds started together.  Each is
checked against the plain version (1e-5 of max|y|), then timed by the
profiler's device time in N rounds (default 3), the shapes in turns
within a round.  With ``--parent DIR`` (a ``git archive`` of another
commit) it also builds that tree's ``csrc/spmv_packed.cu`` and times its
kernel F, which reads the plan's dense ``esrc`` (the window visit ranges
and the overflow grouped by 256 rows, as its placement built them), on
the same scan.  Prints, for each plan, the list's size against the
dense table's, its hub rows, the bound at 3.35 TB/s, one line a shape
with the registers nvcc gave it, and the card's name and power limit
last.  Needs one CUDA device (about 3 min at scale 21).
"""

import argparse
import ctypes
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
from spmv_vector_cache_tpu_torch.formats.tables import (  # noqa: E402
    F_UNIT, extract_tables)
from spmv_vector_cache_tpu_torch.ops import _kernels  # noqa: E402
from spmv_vector_cache_tpu_torch.ops.spmv_packed import (  # noqa: E402
    packed_rows_kernel, packed_rows_plain, packed_scan_kernel)
from spmv_vector_cache_tpu_torch.tools import graphs, realistic  # noqa: E402

#: (threads, items): a unit's terms and row ends, with a word of padding
#: every 32, in 48 KB of shared memory
SHAPES = [(t, k) for t in (128, 256, 512, 1024) for k in (4, 8, 16)
          if t * k * 33 // 32 * 8 <= 48 * 1024]
SOURCE = os.path.join("spmv_vector_cache_tpu_torch", "csrc",
                      "spmv_packed.cu")
#: the parent's F entry: scan, sblock, woff, esrc, ov_off, ov_lane,
#: ov_cols, ov_vals, x, y, rows, block_slots, stream
_P, _L = ctypes.c_void_p, ctypes.c_longlong
PARENT_ARGS = [_P] * 10 + [_L, _L, _P]
#: rows a CTA of the parent's F writes, by which its overflow is grouped
PARENT_BLOCK_ROWS = 256


def nvcc_all(cmds):
    """Run the nvcc commands together; {key: output}, raising on one
    that fails."""
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, c in cmds.items()}
    outs = {}
    for k, proc in procs.items():
        outs[k] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {k}:\n{outs[k]}")
    return outs


def build_shapes(tmp, shapes, parent=None):
    """Every shape's library, built concurrently (and the parent's
    source, under the key "parent"); returns ({key: its
    packed_extract_f32}, {key: nvcc's register line for kernel F})."""
    def cmd(key, src, defines):
        return [_kernels._nvcc(), *_kernels.NVCC_FLAGS, *defines, "-shared",
                "-o", os.path.join(tmp, f"f_{key}.so"), src]

    cmds = {s: cmd("%d_%d" % s, os.path.join(ROOT, SOURCE),
                   [f"-DPACKED_F_THREADS={s[0]}", f"-DPACKED_F_ITEMS={s[1]}"])
            for s in shapes}
    if parent:
        cmds["parent"] = cmd("parent", os.path.join(parent, SOURCE), [])
    outs = nvcc_all(cmds)
    fns, regs = {}, {}
    for k, out in outs.items():
        entry = out.split("packed_rows_kernel", 1)[-1]
        got = re.search(r"Used \d+ registers[^\n]*", entry)
        regs[k] = got.group(0) if got else "?"
        fn = ctypes.CDLL(cmds[k][-2]).packed_extract_f32
        fn.argtypes = PARENT_ARGS if k == "parent" else \
            _kernels.SIGNATURES["packed_extract_f32"]
        fn.restype = ctypes.c_int
        fns[k] = fn
    return fns, regs


def parent_tables(plan):
    """The parent's kernel-F tables: each window's visit range, the
    overflow sorted by row and grouped by blocks of 256 rows."""
    rows = plan.shape[0]
    dev = plan.esrc.device
    nwin = plan.stats.num_windows
    woff = torch.searchsorted(plan.wstep.long(), torch.arange(
        nwin + 1, device=dev)).to(torch.int32)
    ov_rows = plan.ov_rows.long()
    ov_rows, order = torch.sort(ov_rows, stable=True)
    block = ov_rows // PARENT_BLOCK_ROWS
    ov_off = torch.searchsorted(block, torch.arange(
        -(-rows // PARENT_BLOCK_ROWS) + 1, device=dev)).to(torch.int32)
    return (woff, ov_off,
            (ov_rows % PARENT_BLOCK_ROWS).to(torch.int32).contiguous(),
            plan.ov_cols[order].contiguous(),
            plan.ov_vals[order].contiguous())


def plans(scale):
    dev = torch.device("cuda")
    yield "mac_econ", place(build_packed_plan(realistic.mac_econ_like()),
                            dev)
    csr = graphs.kron(scale, 16, (0.57, 0.19, 0.19), 20150804, device=dev)
    yield f"kron{scale}", place(build_packed_plan(csr), dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--parent", default="")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--shapes", default="",
                    help="threads x items, comma-separated (default: all)")
    args = ap.parse_args()
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.shapes.split(",") if s] or SHAPES
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tmp = tempfile.TemporaryDirectory()
    fns, regs = build_shapes(tmp.name, shapes, os.path.abspath(args.parent)
                             if args.parent else None)
    keys = [k for k in fns if k != "parent"]
    stream = _kernels.current_stream(0)
    for name, plan in plans(args.scale):
        st = plan.stats
        rows = plan.shape[0]
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            plan.shape[1]).astype(np.float32)).to(plan.vals.device)
        scan = packed_scan_kernel(plan.vals, plan.cols, plan.cstep, x,
                                  chunk_blocks=st.chunk_blocks,
                                  step_tiles=st.step_tiles)
        tabs = {}
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for s in keys:
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            unit = s[0] * s[1]
            tabs[s] = next((tb for tb in tabs.values() if tb.unit == unit),
                           None) or extract_tables(plan, unit)
            t1.record()
            torch.cuda.synchronize()
            if s == keys[0]:
                print(f"{name}: the list built in "
                      f"{t0.elapsed_time(t1):.1f} ms, its build's peak "
                      f"{torch.cuda.max_memory_allocated() - held} B over "
                      f"the {held} B held", flush=True)
        t = next((tb for tb in tabs.values() if tb.unit == F_UNIT), None) \
            or plan.tables
        parts = cs.packed_extract_bytes(plan, t, x)
        nbyte = sum(parts.values())
        off = t.row_off.long()
        steps = (t.units[:, 1] - t.units[:, 0]).long() + \
            off[t.units[:, 1].long()] - off[t.units[:, 0].long()]
        print(f"{name}: {rows} rows, {st.num_steps_b} visits, dense esrc "
              f"{t.dense_entries * 2} B, list {t.entries.shape[0]} "
              f"entries ({t.pieces} pieces, "
              f"{100 * t.pieces / max(1, t.dense_entries):.2f} % of the "
              f"dense entries; {st.overflow_nnz} overflow), "
              f"{int((steps > t.unit).sum())} hub rows at unit {t.unit} "
              f"(the longest {int(steps.max())} steps); bound {nbyte} "
              f"bytes = {nbyte / cs.PEAK_BYTES_PER_S * 1e6:.3f} us at "
              f"3.35 TB/s ({parts})", flush=True)
        ref = packed_rows_plain(scan, x, t, rows=rows)
        tol = cs.KERNEL_RTOL * max(1.0, float(ref.abs().max()))

        def call_for(s):
            tb, fn = tabs[s], fns[s]

            def call():
                y = torch.empty(rows, dtype=torch.float32, device=x.device)
                ov = (tb.ov_cols.data_ptr(), tb.ov_vals.data_ptr(),
                      x.data_ptr())
                err = fn(scan.data_ptr(), tb.row_off.data_ptr(),
                         tb.entries.data_ptr(), tb.units.data_ptr(), *ov,
                         y.data_ptr(), tb.units.shape[0], tb.unit, stream)
                assert err == 0, (s, err)
                return y
            return call

        calls = {s: call_for(s) for s in keys}
        calls["library"] = lambda: packed_rows_kernel(scan, x, t, rows=rows)
        if "parent" in fns:
            old = parent_tables(plan)

            def parent_call():
                y = torch.empty(rows, dtype=torch.float32, device=x.device)
                err = fns["parent"](
                    scan.data_ptr(), plan.sblock.data_ptr(),
                    old[0].data_ptr(), plan.esrc.data_ptr(),
                    old[1].data_ptr(), old[2].data_ptr(), old[3].data_ptr(),
                    old[4].data_ptr(), x.data_ptr(), y.data_ptr(), rows,
                    st.step_tiles * 1024, stream)
                assert err == 0, ("parent", err)
                return y
            calls["parent"] = parent_call
        for k, call in calls.items():
            y1, y2 = call(), call()
            err = cs.max_abs(y1, ref)
            assert err <= tol, (name, k, err, tol)
            if k != "parent":
                assert torch.equal(y1, y2), (name, k)   # the same every run
        res = {k: [] for k in calls}
        for r in range(args.rounds):
            order = list(calls) if r % 2 == 0 else list(calls)[::-1]
            for k in order:
                res[k].append(round(cs.launch_us(calls[k]), 2))
        for k in sorted(res, key=lambda k: sorted(res[k])[len(res[k]) // 2]):
            label = k if isinstance(k, str) else \
                f"threads={k[0]} items={k[1]}"
            print(f"{name} {label}: device {res[k]} us "
                  f"({regs.get(k, 'the library build')})", flush=True)
        del tabs, calls, ref, scan, plan
        torch.cuda.empty_cache()
    tmp.cleanup()
    print(smi)


if __name__ == "__main__":
    main()
