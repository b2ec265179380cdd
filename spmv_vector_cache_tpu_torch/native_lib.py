"""ctypes bindings for the native host runtime (``native/``: a shared
library and the ``spmv_bench`` CLI), the port's counterpart of
``spmv_vector_cache_tpu/native_lib.py``.

The C++ sources are the port's own copy, in ``native/`` beside this
module.  :func:`build` compiles them on first use with the host C++
compiler (``c++`` or ``g++`` on PATH), one command per target, both
started together, into ``_build/native/<hash>/`` inside the package,
keyed by a hash of the sources, the flags and the compiler (an edited
source rebuilds, an unchanged one is reused).  The numpy versions in
:mod:`.formats.analysis`, :mod:`.formats.convert` and :mod:`.ops.reference`
stay the fallback where no compiler is present; a build that fails
raises with the compiler's output.  Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE = Path(__file__).resolve().parent
NATIVE = PACKAGE / "native"
BUILD = PACKAGE / "_build" / "native"

CXXFLAGS = ["-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC"]
LIB_NAME = "libspmvref.so"
CLI_NAME = "spmv_bench"

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def sources():
    return sorted(NATIVE.glob("*.cpp")) + sorted(NATIVE.glob("*.h"))


def compiler() -> Optional[str]:
    """The host C++ compiler on PATH, or None."""
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    return None


def build_dir(cxx: str) -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join([cxx, *CXXFLAGS]).encode())
    return BUILD / h.hexdigest()[:16]


def _compile(cxx: str, out: Path) -> None:
    """Compile the library and the CLI into ``out`` (made atomically: a
    reader never sees half a build); raise with the compiler's output."""
    BUILD.mkdir(parents=True, exist_ok=True)
    lib_src = str(NATIVE / "spmvref.cpp")
    tmp = tempfile.mkdtemp(dir=BUILD)
    try:
        cmds = [[cxx, *CXXFLAGS, "-shared", "-o", f"{tmp}/{LIB_NAME}",
                 lib_src],
                [cxx, *CXXFLAGS, "-o", f"{tmp}/{CLI_NAME}",
                 str(NATIVE / "cli.cpp"), lib_src]]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for cmd, proc, text in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"native build failed "
                                   f"({proc.returncode}):\n{' '.join(cmd)}"
                                   f"\n{text}")
        try:
            os.rename(tmp, out)          # atomic
        except OSError:                  # a concurrent build got there first
            if not (out / LIB_NAME).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build(force: bool = False) -> bool:
    """Compile the native library and CLI unless built for these exact
    sources.  Returns False only when no C++ compiler is on PATH; a
    compiler that fails raises ``RuntimeError`` with its output."""
    global _build_error
    cxx = compiler()
    if cxx is None:
        _build_error = "no C++ compiler (c++ or g++) on PATH"
        return False
    out = build_dir(cxx)
    if force and out.exists():
        shutil.rmtree(out)
    if not (out / LIB_NAME).exists():
        _compile(cxx, out)
    return True


def available() -> bool:
    return _load() is not None


def _paths() -> Path:
    if not build():
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return build_dir(compiler())


def lib_path() -> str:
    """Path to the shared library (built on demand)."""
    return str(_paths() / LIB_NAME)


def cli_path() -> str:
    """Path to the spmv_bench benchmark CLI (built on demand)."""
    return str(_paths() / CLI_NAME)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(lib_path())
    u32, f64 = ctypes.c_uint32, ctypes.c_double
    pu32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    pf64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pu64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")

    lib.spmv_csc_f64.argtypes = [u32, u32, u32, pu32, pu32, pf64, pf64, pf64]
    lib.spmv_csc_f64.restype = None
    lib.spmv_csr_f64.argtypes = [u32, u32, u32, pu32, pu32, pf64, pf64, pf64]
    lib.spmv_csr_f64.restype = None
    lib.spmv_csc_u64.argtypes = [u32, u32, u32, pu32, pu32, pu64, pu64, pu64]
    lib.spmv_csc_u64.restype = None
    lib.spmv_mark_row_starts.argtypes = [u32, u32, pu32, ctypes.c_int,
                                         ctypes.c_int]
    lib.spmv_mark_row_starts.restype = None
    lib.spmv_clear_row_markings.argtypes = [u32, pu32]
    lib.spmv_clear_row_markings.restype = None
    lib.spmv_max_alive.argtypes = [u32, u32, pu32]
    lib.spmv_max_alive.restype = u32
    lib.spmv_max_col_span.argtypes = [u32, pu32, pu32]
    lib.spmv_max_col_span.restype = u32
    lib.spmv_csr_to_csc_f64.argtypes = [u32, u32, u32, pu32, pu32, pf64,
                                        pu32, pu32, pf64]
    lib.spmv_csr_to_csc_f64.restype = None
    lib.spmv_ilu0_f64.argtypes = [u32, pu32, pu32, pf64]
    lib.spmv_ilu0_f64.restype = ctypes.c_int
    lib.spmv_time_seconds.argtypes = []
    lib.spmv_time_seconds.restype = f64
    _lib = lib
    return lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    return lib


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=np.uint32)


def _check_compressed(indptr, inds, data, n_major: int) -> None:
    """Validate what the C loops read unchecked."""
    if indptr.shape[0] != n_major + 1:
        raise ValueError(f"indptr has {indptr.shape[0]} entries, expected "
                         f"{n_major + 1}")
    if inds.shape[0] != data.shape[0] or int(indptr[-1]) > inds.shape[0]:
        raise ValueError("indices, data and indptr disagree on nnz")


def spmv_csc(a, x: np.ndarray, y: Optional[np.ndarray] = None) -> np.ndarray:
    """Native golden CSC SpMV, in storage order (float64, or uint64 for
    a uint64 payload)."""
    lib = _require()
    indptr, inds = _u32(a.indptr), _u32(a.indices)
    data = np.asarray(a.data)
    rows, cols = a.shape
    _check_compressed(indptr, inds, data, cols)
    if np.shape(x) != (cols,):
        raise ValueError(f"x has shape {np.shape(x)}, expected ({cols},)")
    if data.dtype == np.uint64:
        out = np.zeros(rows, np.uint64) if y is None else y.astype(np.uint64)
        lib.spmv_csc_u64(rows, cols, data.shape[0], indptr, inds,
                         np.ascontiguousarray(data),
                         np.ascontiguousarray(x, dtype=np.uint64), out)
        return out
    out = np.zeros(rows, np.float64) if y is None else y.astype(np.float64)
    lib.spmv_csc_f64(rows, cols, data.shape[0], indptr, inds,
                     np.ascontiguousarray(data, dtype=np.float64),
                     np.ascontiguousarray(x, dtype=np.float64), out)
    return out


def spmv_csr(a, x: np.ndarray, y: Optional[np.ndarray] = None) -> np.ndarray:
    lib = _require()
    rows, cols = a.shape
    indptr, inds = _u32(a.indptr), _u32(a.indices)
    data = np.ascontiguousarray(np.asarray(a.data), dtype=np.float64)
    _check_compressed(indptr, inds, data, rows)
    if np.shape(x) != (cols,):
        raise ValueError(f"x has shape {np.shape(x)}, expected ({cols},)")
    out = np.zeros(rows, np.float64) if y is None else y.astype(np.float64)
    lib.spmv_csr_f64(rows, cols, data.shape[0], indptr, inds, data,
                     np.ascontiguousarray(x, dtype=np.float64), out)
    return out


def mark_row_starts(inds, rows: int, reverse: bool = False,
                    shift: int = 31) -> np.ndarray:
    lib = _require()
    out = _u32(inds).copy()
    lib.spmv_mark_row_starts(rows, out.shape[0], out, int(reverse), shift)
    return out


def max_alive(a) -> int:
    lib = _require()
    inds = _u32(a.indices)
    return int(lib.spmv_max_alive(a.shape[0], inds.shape[0], inds))


def max_col_span(a) -> int:
    lib = _require()
    indptr = _u32(a.indptr)
    if indptr.shape[0] != a.shape[1] + 1:
        raise ValueError("max_col_span reads a CSC matrix")
    return int(lib.spmv_max_col_span(a.shape[1], indptr, _u32(a.indices)))


def csr_to_csc(a):
    """Native counting-sort transpose of a CSR matrix (float64 values)."""
    from .formats.containers import CSC

    lib = _require()
    rows, cols = a.shape
    indptr, inds = _u32(a.indptr), _u32(a.indices)
    data = np.ascontiguousarray(np.asarray(a.data), dtype=np.float64)
    _check_compressed(indptr, inds, data, rows)
    nnz = data.shape[0]
    col_ptr = np.zeros(cols + 1, np.uint32)
    row_ind = np.zeros(nnz, np.uint32)
    b = np.zeros(nnz, np.float64)
    lib.spmv_csr_to_csc_f64(rows, cols, nnz, indptr, inds, data, col_ptr,
                            row_ind, b)
    return CSC(data=b, indices=row_ind.astype(np.int32),
               indptr=col_ptr.astype(np.int32), shape=a.shape)


def ilu0_inplace(indptr, indices, data: np.ndarray) -> np.ndarray:
    """Native ILU(0) of CSR values on A's pattern (sorted columns).

    Returns the factored value array (L's strictly lower entries hold
    the multipliers, the diagonal and upper entries hold U).  Raises on
    a missing diagonal or a zero pivot, as the numpy version does."""
    lib = _require()
    indptr, inds = _u32(indptr), _u32(indices)
    out = np.ascontiguousarray(np.asarray(data), dtype=np.float64).copy()
    _check_compressed(indptr, inds, out, indptr.shape[0] - 1)
    rc = lib.spmv_ilu0_f64(indptr.shape[0] - 1, indptr, inds, out)
    if rc > 0:
        raise ValueError(f"ILU(0): missing diagonal in row {rc - 1}")
    if rc < 0:
        raise ZeroDivisionError(f"ILU(0): zero pivot at row {-rc - 1}")
    return out
