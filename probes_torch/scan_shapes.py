#!/usr/bin/env python3
"""Kernel E (``csrc/spmv_packed.cu`` ``packed_scan_kernel``) at every
launch shape, on the card, with kernel F on its scan.

    python3 probes_torch/scan_shapes.py [--parent DIR] [--rounds N]
        [--kinds f32,i8,...] [--plans mac_econ,deep]

Places two PackedPlans as the planner makes them: ``mac_econ``
(``realistic.mac_econ_like()``, the smoke's ``packed`` phase: 1,576
tiles) and ``deep`` (the report's uniform draw, 2^18 x 2^18, 16
nonzeros a row, seed 3: 4,344 tiles, the smoke's uncut row).  For each
value build named, draws the plan's slots and overflow values of that
type and x of its sum type on the card from a seeded generator (floats
N(0, 1); 8-bit integers from [0, 16), 16-bit from [0, 256), 32-bit from
[0, 10)), and launches E at every shape (4, 8 and 16 slots a thread,
128, 256, 512 and 1024 threads a CTA): each held against the plain
version (floats to
1e-5 of max|S|, integers exactly), each timed by the profiler (device
us, 20 launches) in N rounds (default 3), the shapes in turns within a
round.  Beside them: the shape ``scan_launch_shape`` picks, kernel F on
that scan (its device time), a launch of one step (64 rows, the device
time of a launch that does almost nothing), E's bound at 3.35 TB/s (x
and S at the value type's width for the narrow builds; for float16 and
bfloat16 also with the 4-byte S their float32 sums need) and F's, and
with ``--parent DIR`` (a ``git archive`` of another commit, built into
its own ``_build/``) that tree's E on the same inputs (its S in 32
bits; S must equal this tree's, floats to 1e-5, the narrow integers in
their low 8 or 16 bits; F's arguments changed with its compacted list,
so the parent's F is not called).  Prints one JSON
line per (build, plan), then the card's name and power limit.  Needs one
CUDA device (about 3 min).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from probes_torch.dia_shapes import DTYPE, parent_library  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import _kernels  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import semiring as sr  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import spmv_packed as pk  # noqa: E402

SHAPES = [(sl, t) for sl in (4, 8, 16) for t in (128, 256, 512, 1024)]


def draw(dt, shape, gen, dev):
    """Values of ``dt`` on the card: floats N(0, 1), integers from [0,
    16) at 8 bits, [0, 256) at 16, [0, 10) at 32."""
    if dt.is_floating_point:
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    hi = {1: 16, 2: 256}.get(dt.itemsize, 10)
    return torch.randint(0, hi, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(dt)


def plans(names):
    import numpy as np

    from spmv_vector_cache_tpu_torch.formats.plan import auto_plan, place
    from spmv_vector_cache_tpu_torch.tools import realistic

    makers = {"mac_econ": realistic.mac_econ_like,
              "deep": lambda: cs.uniform_matrix(np.random.default_rng(3))}
    for name in names:
        p = auto_plan(makers[name]())
        assert type(p).__name__ == "PackedPlan", name
        yield name, place(p, torch.device("cuda"))


def device_us(fn):
    return round(cs.launch_us(fn), 3)


def agree(got, ref, bytes_=4):
    """Floats within 1e-5 of max|ref|; integers equal in their low
    ``bytes_`` bytes and those of the narrower of the two (a 32-bit scan
    against a narrow one: mod 2^8 or 2^16)."""
    if got.dtype.is_floating_point:
        tol = 1e-5 * max(1.0, float(ref.double().abs().max()))
        return cs.max_abs(got, ref) <= tol
    bits = 8 * min(got.element_size(), ref.element_size(), bytes_)
    g = sr.signed(got.cpu()).long() & ((1 << bits) - 1)
    r = sr.signed(ref.cpu()).long() & ((1 << bits) - 1)
    return bool(torch.equal(g, r))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kinds", default="f32,bf16,f16,i8,u8,i16,u16,i32,u32")
    ap.add_argument("--plans", default="mac_econ,deep")
    args = ap.parse_args()
    assert torch.cuda.is_available(), "needs a CUDA device"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _kernels.library()
    old = parent_library(args.parent) if args.parent else None
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    for pname, plan in plans(args.plans.split(",")):
        st = plan.stats
        tables0 = plan.tables
        rows = plan.vals.shape[0] * 8
        kw = dict(chunk_blocks=st.chunk_blocks, step_tiles=st.step_tiles)
        for kind in args.kinds.split(","):
            dt = DTYPE[kind]
            vals = draw(dt, tuple(plan.vals.shape), gen, dev)
            xt = sr.x_dtype(dt)
            x = draw(dt if dt in sr.NARROW else xt, (plan.shape[1],), gen,
                     dev).to(xt)
            tables = dataclasses.replace(
                tables0, ov_vals=draw(dt, tuple(tables0.ov_vals.shape), gen,
                                      dev))
            a = (vals, plan.cols, plan.cstep, x)
            ref = pk.packed_scan_plain(*a, **kw)
            picked = pk.kernel_scan_shape(vals)
            want = pk.packed_scan_kernel(*a, **kw)
            assert want.dtype == pk.scan_dtype(dt) and agree(want, ref), (
                pname, kind)
            shapes = {}
            for sl, t in SHAPES:
                sh = pk.ScanShape(sl, t, -(-rows * 128 // (t * sl)))
                got = pk.packed_scan_kernel(*a, **kw, shape=sh)
                assert agree(got, ref), (pname, kind, sl, t)
                shapes[f"{sl}x{t}"] = sh
            f_args = (want, x, tables)
            f_kw = dict(rows=plan.shape[0])
            y = pk.packed_rows_kernel(*f_args, **f_kw)
            assert agree(y, pk.packed_rows_plain(*f_args, **f_kw))
            times = {k: [] for k in shapes}
            out = {"kind": kind, "plan": pname, "rows": rows,
                   "picked": [picked.slots_per_thread, picked.threads,
                              picked.ctas],
                   "picked_us": [], "f_us": []}
            if old is not None:
                sfx = _kernels.BUILDS[dt]
                s32 = torch.empty(vals.shape, dtype=xt, device=dev)
                stream = _kernels.current_stream(dev.index or 0)

                def old_e():
                    assert getattr(old, f"packed_scan_{sfx}")(
                        vals.data_ptr(), plan.cols.data_ptr(),
                        plan.cstep.data_ptr(), x.data_ptr(),
                        s32.data_ptr(), rows, st.step_tiles * 8,
                        st.chunk_blocks * 128, x.shape[0], stream) == 0

                old_e()
                torch.cuda.synchronize()
                out["parent_equal"] = agree(want, s32)
                out["parent_e_us"] = []
            for _ in range(args.rounds):
                for k, sh in shapes.items():
                    times[k].append(device_us(
                        lambda sh=sh: pk.packed_scan_kernel(*a, **kw,
                                                            shape=sh)))
                out["picked_us"].append(device_us(
                    lambda: pk.packed_scan_kernel(*a, **kw)))
                out["f_us"].append(device_us(
                    lambda: pk.packed_rows_kernel(*f_args, **f_kw)))
                if old is not None:
                    out["parent_e_us"].append(device_us(old_e))
            one = (vals[:st.step_tiles], plan.cols[:st.step_tiles],
                   plan.cstep[:1], x)
            out["one_step_us"] = device_us(
                lambda: pk.packed_scan_kernel(*one, **kw))
            # bytes: each input once, S once, x's distinct entries; the
            # narrow builds' x and S at the value type's width
            w = dt.itemsize if dt in sr.NARROW else 4
            ccols = (plan.cstep.long().repeat_interleave(
                st.step_tiles)[:, None, None] * (st.chunk_blocks * 128)
                + (plan.cols.long() & 16383))
            e_in = (cs.nbytes(vals, plan.cols, plan.cstep)
                    + cs.x_bytes_read(x, ccols, w))
            out["bound_us"] = round((e_in + vals.numel() * w)
                                    / cs.PEAK_BYTES_PER_S * 1e6, 3)
            if dt in (torch.float16, torch.bfloat16):
                out["bound_s32_us"] = round((e_in + vals.numel() * 4)
                                            / cs.PEAK_BYTES_PER_S * 1e6, 3)
            out["f_bound_us"] = round(sum(cs.packed_extract_bytes(
                plan, tables, x, w).values()) / cs.PEAK_BYTES_PER_S * 1e6,
                3)
            med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
            out["shapes_us"] = times
            out["best"] = sorted(med.items(), key=lambda kv: kv[1])[:3]
            print(json.dumps(out), flush=True)
            del vals, x, tables, want, ref, y
            torch.cuda.empty_cache()
    print(card, flush=True)


if __name__ == "__main__":
    main()
