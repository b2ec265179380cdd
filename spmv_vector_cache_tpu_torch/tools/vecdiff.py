"""Result-vector diff utility — the ``chisel/vecdiff.sh`` role (counterpart
of ``spmv_vector_cache_tpu/tools/vecdiff.py``; numpy only).

The reference byte-diffs a simulator's output vector against
``golden.bin`` (``chisel/vecdiff.sh:1-14``).  This does the same for any
two binary vectors, with an optional tolerance mode for float paths whose
accumulation order differs.

Usage:
  python -m spmv_vector_cache_tpu_torch.tools.vecdiff a.bin b.bin \
      [--dtype f64|f32|u64] [--rtol 0] [--atol 0]

Exit code 0 = match, 1 = mismatch (count printed).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

DTYPES = {"f64": "<f8", "f32": "<f4", "u64": "<u8", "u32": "<u4"}


def diff(path_a: str, path_b: str, dtype: str = "f64",
         rtol: float = 0.0, atol: float = 0.0, out=sys.stdout) -> int:
    a = np.fromfile(path_a, dtype=DTYPES[dtype])
    b = np.fromfile(path_b, dtype=DTYPES[dtype])
    if a.shape != b.shape:
        out.write(f"length mismatch: {a.shape[0]} vs {b.shape[0]}\n")
        return 1
    if rtol == 0.0 and atol == 0.0:
        # byte-exact mode (the memcmp bar of HardwareSpMV.cpp:37-39)
        mism = np.flatnonzero((a.view((np.uint8, a.itemsize)) !=
                               b.view((np.uint8, b.itemsize))).any(axis=1))
    else:
        mism = np.flatnonzero(~np.isclose(a.astype(np.float64),
                                          b.astype(np.float64),
                                          rtol=rtol, atol=atol))
    if mism.size == 0:
        out.write(f"identical ({a.shape[0]} elements)\n")
        return 0
    out.write(f"{mism.size} mismatched elements "
              f"(first at {int(mism[0])}: {a[mism[0]]} vs {b[mism[0]]})\n")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--dtype", choices=DTYPES, default="f64")
    ap.add_argument("--rtol", type=float, default=0.0)
    ap.add_argument("--atol", type=float, default=0.0)
    ns = ap.parse_args(argv)
    return diff(ns.a, ns.b, ns.dtype, ns.rtol, ns.atol)


if __name__ == "__main__":
    raise SystemExit(main())
