#!/usr/bin/env python3
"""Kernels A and M (``csrc/spmv_dia.cu``) at every launch shape, on the
card.

    python3 probes_torch/dia_shapes.py [--parent DIR] [--define N=V]
        [--kinds f32,i8,...] [--cases A:1048576,M4:262144,A:32768:7,...]

For each value build named, makes the smoke's DIA slabs on the card from
a seeded generator (27 diagonals, -13..13, or ``:D`` centred diagonals;
steps of 8192 rows): kernel A over the DIA headline's 2^20 rows and the
narrow phases' 2^18-row cut, kernel M over one shard of each (262,144
and 65,536 rows, x with a 128-entry halo each side), and over four full
shards in one call (M4), as the sharded apply launches them.  Launches
each at every shape the build takes (R rows a thread up to one 16-byte
vector of slots and 8 rows, 64, 128 and 256 threads a CTA, x staged in
shared memory where the window fits or read through L1), checks that
every shape gives the default shape's y bit for bit and that the default
matches the plain version (1e-5 of max|y| for the floats, exactly for
the integers), and reads each shape's device time by the profiler (20
launches).  Beside them: the shape ``dia_launch_shape`` picks, a
one-row launch of the same build (the device time of a launch that does
almost nothing), the bound at 3.35 TB/s (x and y at the value type's
width for the narrow builds, as ``PERF.md`` counts them), and with
``--parent DIR`` (a ``git archive`` of another commit, built into its
own ``_build/``) that tree's kernel on the same inputs; with ``--define
NAME=VALUE``, ``csrc/spmv_dia.cu`` of this tree built alone with that
define (``SPMV_DIA_GROUP_DIAGS=16``: the diagonals whose slot loads a
thread has in flight together), timed at every shape beside it.  Prints
one JSON line per (build, size), then the card's name and power limit.
Needs one CUDA device (3-6 min).
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import _kernels  # noqa: E402
from spmv_vector_cache_tpu_torch.ops import spmv_dia  # noqa: E402

DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
         "f16": torch.float16, "i32": torch.int32, "u32": torch.uint32,
         "i8": torch.int8, "u8": torch.uint8, "i16": torch.int16,
         "u16": torch.uint16}
#: (kernel, rows): A on the headline and the cut, M on a shard of each,
#: and four full shards in one call (M4), as the sharded apply runs them
CASES = (("A", 1 << 20), ("A", 1 << 18), ("M", 1 << 18), ("M", 1 << 16),
         ("M4", 1 << 18))
OFFSETS = tuple(range(-13, 14))
STEP, HALO = 8192, 128


def parent_library(tree):
    """The kernel library of the tree at ``tree``, built there."""
    path = os.path.join(tree, "spmv_vector_cache_tpu_torch", "ops",
                        "_kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def variant_library(define):
    """``csrc/spmv_dia.cu`` of this tree built alone with ``-D<define>``,
    its A and M entry points bound as ``_kernels`` binds them."""
    tmp = tempfile.mkdtemp(dir=_kernels.BUILD)
    so = os.path.join(tmp, "libdia_variant.so")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, f"-D{define}",
                    "-shared", "-o", so, str(_kernels.CSRC / "spmv_dia.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for name, argtypes in _kernels.SIGNATURES.items():
        if name.startswith("spmv_dia_") and name != "spmv_dia_f64":
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def slab(kind, rows, gen, dev):
    """(T, 27, 64, 128) values of ``kind`` and x of its sum type; the
    integers from [0, 16) (8 bits), [0, 256) (16 bits) or [-9, 10)."""
    shape = (rows // STEP, len(OFFSETS), STEP // 128, 128)
    dt = DTYPE[kind]
    if dt.is_floating_point:
        vals = torch.randn(shape, generator=gen, device=dev).to(dt)
        x = torch.randn(rows + 2 * HALO, generator=gen, device=dev)
        if kind == "f16":
            x = x.half().float()
        return vals, x
    hi = {1: 16, 2: 256}.get(dt.itemsize, 10)
    lo = -9 if dt.itemsize == 4 and dt.is_signed else 0
    vals = torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(dt)
    x = torch.randint(lo, hi, (rows + 2 * HALO,), generator=gen, device=dev,
                      dtype=torch.int32)
    if kind == "u32":
        x = x.to(torch.uint32)
    return vals, x


def shapes(vals, rows):
    r = 1
    while r * vals.element_size() <= 16 and r <= spmv_dia.MAX_ROWS:
        for threads in (64, 128, 256):
            for staged in (False, True):
                yield spmv_dia.DiaShape(r, threads,
                                        -(-rows // (r * threads)), staged, 0)
        r *= 2


class Job:
    """One launch of the case: A over (vals, x) or M over (vals, x_ext)
    at origin HALO."""

    def __init__(self, kernel, vals, x_ext, rows):
        self.halo = kernel != "A"
        self.vals, self.rows = vals, rows
        self.x = x_ext if self.halo else x_ext[HALO:HALO + rows].contiguous()

    def run(self, shape=None, rows=None):
        rows = self.rows if rows is None else rows
        if self.halo:
            return spmv_dia.spmv_dia_halo_kernel(
                self.vals, OFFSETS, self.x, rows, HALO, shape=shape)
        return spmv_dia.spmv_dia_kernel(self.vals, OFFSETS, self.x, rows,
                                        shape=shape)

    def plain(self):
        if self.halo:
            return spmv_dia.spmv_dia_halo_plain(self.vals, OFFSETS, self.x,
                                                self.rows, HALO)
        return spmv_dia.spmv_dia_plain(self.vals, OFFSETS, self.x,
                                       self.rows)

    def run_with(self, lib, shape, y):
        """This tree's entry point in another build of it (``lib``)."""
        sfx = _kernels.BUILDS[self.vals.dtype]
        fn = getattr(lib, ("spmv_dia_halo_" if self.halo else "spmv_dia_")
                     + sfx)
        dev = self.x.device
        args = [self.vals.data_ptr(), self.x.data_ptr(),
                spmv_dia._offsets_on(OFFSETS, dev).data_ptr(),
                ctypes.addressof(spmv_dia._offsets_host(OFFSETS)),
                y.data_ptr(), self.rows, self.x.shape[0]]
        args += [HALO] if self.halo else []
        args += [len(OFFSETS), STEP, shape.rows_per_thread, shape.threads,
                 int(shape.staged), _kernels.current_stream(dev.index or 0)]
        assert fn(*args) == 0
        return y

    def run_parent(self, lib, y):
        """The parent tree's one-row kernel (its C signature)."""
        sfx = _kernels.BUILDS[self.vals.dtype]
        dev = self.x.device
        head = [self.vals.data_ptr(), self.x.data_ptr(),
                spmv_dia._offsets_on(OFFSETS, dev).data_ptr(), y.data_ptr(),
                self.rows, self.x.shape[0]]
        if self.halo:
            fn, head = getattr(lib, f"spmv_dia_halo_{sfx}"), head + [HALO]
        else:
            fn = getattr(lib, f"spmv_dia_{sfx}")
        assert fn(*head, len(OFFSETS), STEP,
                  _kernels.current_stream(dev.index or 0)) == 0
        return y


def device_us(fn):
    return round(sum(t for t, _ in cs.device_us_by_kernel(fn).values()), 3)


def main():
    global OFFSETS
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--define", default=None,
                    help="NAME=VALUE: also time spmv_dia.cu built with it")
    ap.add_argument("--kinds", default="f32,bf16,f16,i8,i16")
    ap.add_argument("--cases", default=",".join(
        f"{k}:{r}" for k, r in CASES))
    args = ap.parse_args()
    assert torch.cuda.is_available(), "needs a CUDA device"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _kernels.library()
    old = parent_library(args.parent) if args.parent else None
    var = variant_library(args.define) if args.define else None
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    for kind in args.kinds.split(","):
        for case in args.cases.split(","):
            # kernel:rows[:diagonals], the diagonals centred on 0
            kernel, rows, *ndiag = case.split(":")
            rows, half = int(rows), int((ndiag or [27])[0]) // 2
            OFFSETS = tuple(range(-half, half + 1))
            # M4: four shards of ``rows``, one call launching each, as the
            # sharded apply does (their slabs need not fit in L2 together)
            jobs = [Job(kernel, *slab(kind, rows, gen, dev), rows)
                    for _ in range(4 if kernel == "M4" else 1)]
            want = [j.run() for j in jobs]
            for j, w in zip(jobs, want):
                ref = j.plain()
                if w.dtype.is_floating_point:
                    tol = 1e-5 * max(1.0, float(ref.abs().max()))
                    assert cs.max_abs(w, ref) <= tol, (kind, case)
                else:
                    assert torch.equal(cs.as_words(w), cs.as_words(ref))
            words = [cs.as_words(w) for w in want]    # every shape's y
            ys = [torch.empty_like(w) for w in want]
            times, var_times = [], []
            for shape in shapes(jobs[0].vals, rows):
                if shape.staged and 4 * spmv_dia.stage_words(
                        shape.threads, shape.rows_per_thread,
                        OFFSETS[-1] - OFFSETS[0]) > spmv_dia.STAGE_BYTES:
                    continue
                key = (shape.rows_per_thread, shape.threads, shape.staged)
                for j, w in zip(jobs, words):
                    assert torch.equal(cs.as_words(j.run(shape)), w), (
                        kind, case, shape)
                times.append((key, device_us(
                    lambda s=shape: [j.run(s) for j in jobs])))
                if var is not None:
                    for j, y, w in zip(jobs, ys, words):
                        assert torch.equal(cs.as_words(
                            j.run_with(var, shape, y)), w), (kind, case)
                    var_times.append((key, device_us(
                        lambda s=shape: [j.run_with(var, s, y)
                                         for j, y in zip(jobs, ys)])))
            picked = spmv_dia.kernel_shape(jobs[0].vals, OFFSETS, rows)
            out = {"kind": kind, "kernel": kernel, "rows": rows,
                   "diagonals": len(OFFSETS),
                   "picked": [picked.rows_per_thread, picked.threads,
                              picked.staged, picked.ctas],
                   "picked_us": device_us(lambda: [j.run() for j in jobs]),
                   "one_row_us": device_us(lambda: jobs[0].run(rows=1))}
            w = 4 if kind in ("f32", "bf16", "i32", "u32") else \
                jobs[0].vals.element_size()
            out["bound_us"] = round(sum(
                cs.nbytes(j.vals) + (j.x.numel() + rows) * w
                + 4 * len(OFFSETS) for j in jobs)
                / cs.PEAK_BYTES_PER_S * 1e6, 3)
            if old is not None:
                out["parent_equal"] = all(
                    torch.equal(cs.as_words(j.run_parent(old, y)), w)
                    for j, y, w in zip(jobs, ys, words))
                out["parent_us"] = device_us(
                    lambda: [j.run_parent(old, y) for j, y in zip(jobs, ys)])
            times.sort(key=lambda t: t[1])
            out.update(best=times[:5], all=times)
            if var is not None:
                var_times.sort(key=lambda t: t[1])
                out.update(define=args.define, variant_best=var_times[:5],
                           variant_all=var_times)
            print(json.dumps(out), flush=True)
            del jobs, want, words, ys
            torch.cuda.empty_cache()
    print(card, flush=True)


if __name__ == "__main__":
    main()
