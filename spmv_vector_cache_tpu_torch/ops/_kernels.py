"""Build and bind the hand-written CUDA kernels in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` to an object file, one process per
source, all started together, then links them into one shared library
with a plain C interface, loaded with ``ctypes``.  The build runs on
first use, into ``_build/`` inside the package, keyed by a hash of the
sources (so an edited kernel rebuilds and an unchanged one is reused).
A failed build raises with nvcc's output.  Nothing here runs at import
time: the CPU tests import every module of the port.

Every wrapper launches through :func:`launch`, the port's one launch
path: it binds each C entry point once, passes the raw handle of the
current stream of the operands' card (:func:`current_stream`, no Python
``Stream`` object), raises on a launch error, and counts the launch by
entry point in :data:`launches`, the port's one launch count: a test or
the smoke clears it just before the path it checks and reads it just
after.  While a torch profiler records, the C call is the span
``spmv.launch`` (``utils/stats.py``): where the card's launch queue is
full, that call is where the host waits.

Kernels A, B, D, E, F, G, H, I, M and the chunk light route have one
build per value type of a plan (:data:`BUILDS`): the ``_f32`` entry
point, and ``_bf16``, ``_i32``, ``_u32``, ``_f16``, ``_i8``, ``_u8``,
``_i16`` and ``_u16`` entry points with the same arguments; :func:`entry`
names the one for a value slab's type.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..utils.stats import spanned

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C entry points and their argument types (pointers and the stream as
#: c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    # vals, x, offsets, host_offsets, y, rows, cols, ndiag,
    # rows_per_step, rows_per_thread, threads, staged, stream
    "spmv_dia_f32": [_P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _P],
    # vals, cols_win, window_base, x, out, out_rows, positions, lanes,
    # group_tiles, fold, window_grain, cols, semiring, lanes_per_thread,
    # rows_per_cta, stream
    "spmv_sell_window_f32": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                             _L, _I, _I, _I, _P],
    # y2d, idx, out, n, stream
    "lane_unpermute_f32": [_P, _P, _P, _L, _P],
    # vals, cols_win, bases, tile_row, rows, runs, x, y, num_runs,
    # positions, lanes, ncols, max_tiles, max_slices, semiring, stream
    "spmv_subwin_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _I,
                        _I, _I, _P],
    # row_off, cols, vals, tiled, units, x, y2d, num_units, ncols,
    # semiring, stream
    "spmv_chunk_light_f32": [_P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _P],
    # vals, cols, cstep, x, out, rows, rows_per_step, chunk_cols, ncols,
    # slots_per_thread, threads, stream
    "packed_scan_f32": [_P, _P, _P, _P, _P, _L, _I, _L, _L, _I, _I, _P],
    # scan, row_off, entries, units, ov_cols, ov_vals, x, y, num_units,
    # unit, stream
    "packed_extract_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P],
    # vals, cols, tile_slice, runs, x, out, num_runs, positions, lanes,
    # ncols, parts, out_rows, max_tiles, max_slices, semiring, stream
    "spmv_sell_global_f32": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _I, _L,
                             _I, _I, _I, _P],
    # vals (hi/lo pairs), x, offsets, y (float64), rows, cols, ndiag,
    # rows_per_step, stream
    "spmv_dia_f64": [_P, _P, _P, _P, _L, _L, _I, _I, _P],
    # vals (hi/lo pairs), cols_win, window_base, x, out (float64),
    # out_rows, positions, lanes, group_tiles, fold, window_grain, cols,
    # stream
    "spmv_sell_window_f64": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                             _L, _P],
    # vals (hi/lo pairs), cols, tile_slice, runs, x, out (float64),
    # num_runs, positions, lanes, ncols, parts, out_rows, max_tiles,
    # max_slices, stream
    "spmv_sell_global_f64": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _I, _L,
                             _I, _I, _P],
    # vals, b, offsets, bands, y, rows, cols, k, ndiag, rows_per_step,
    # nbands, rows_per_cta, cols_per_thread, threads_per_row, stride,
    # buf_rows, band_diags, buffers, stream
    "spmm_dia_f32": [_P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, _P],
    # vals, cols_win, window_base, tile_slice, runs, b, out, num_runs,
    # positions, lanes, group_tiles, window_grain, cols, k, parts,
    # out_rows, stream
    "spmm_sell_window_f32": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                             _I, _L, _I, _I, _L, _P],
    # vals, x_ext, offsets, host_offsets, y, rows, x_len, x_origin, ndiag,
    # rows_per_step, rows_per_thread, threads, staged, stream
    "spmv_dia_halo_f32": [_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I,
                          _I, _P],
    # data, out, num_blocks, block_elems, stream
    "stream_checksum_f32": [_P, _P, _L, _L, _P],
}

#: the entry-point suffix of each value slab type (a plan's ``vals``
#: dtype; a double plan's hi/lo float32 slab has its own ``_f64``
#: entry points)
BUILDS = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.int32: "i32", torch.uint32: "u32", torch.float16: "f16",
          torch.int8: "i8", torch.uint8: "u8", torch.int16: "i16",
          torch.uint16: "u16"}
#: the kernels with more builds than float32, by their float32 entry,
#: and the value types they are built for
TYPED = {name: tuple(BUILDS.values()) for name in (
    "spmv_dia_f32", "spmv_dia_halo_f32", "spmv_sell_window_f32",
    "spmv_sell_global_f32", "spmv_subwin_f32", "spmv_chunk_light_f32",
    "packed_scan_f32", "packed_extract_f32", "spmm_sell_window_f32",
    "spmm_dia_f32")}
for _name, _sfxs in TYPED.items():
    for _sfx in _sfxs:
        SIGNATURES[_name[:-3] + _sfx] = SIGNATURES[_name]


def entry(name: str, vals_dtype: torch.dtype) -> str:
    """The entry point of kernel ``name`` (its float32 entry, one of
    :data:`TYPED`) for a value slab of ``vals_dtype``; raises
    ``NotImplementedError`` for a type it has no build for."""
    sfx = BUILDS.get(vals_dtype)
    if sfx not in TYPED.get(name, ()):
        raise NotImplementedError(f"{name} has no build for {vals_dtype} "
                                  f"values")
    return name[:-3] + sfx


#: launches of each C entry point, counted by :func:`launch`
launches: collections.Counter = collections.Counter()


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from csrc/ on first use")
    return found


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with the output of the first
    that fails, else return all their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` unless a library for these exact sources
    exists; returns (library path, nvcc output, empty when reused)."""
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD / f"libspmv_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD.mkdir(exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        cus = [p for p in sources() if p.suffix == ".cu"]
        objs = [str(Path(tmp) / f"{p.stem}.o") for p in cus]
        out = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                        for p, o in zip(cus, objs)])
        tmp_lib = str(Path(tmp) / lib.name)
        out += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
                          *objs]])
        os.replace(tmp_lib, lib)   # atomic: a reader never sees half a file
    return lib, out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def current_stream(device_index: int) -> int:
    """The raw ``cudaStream_t`` of the current stream of CUDA device
    ``device_index``, as an int: the stream a ``torch.cuda.stream(s)``
    context made current there, else the default one.  PyTorch's own
    generated code looks it up the same way; ``torch.cuda.current_stream``
    builds a Python ``Stream`` object on every call."""
    return torch._C._cuda_getCurrentRawStream(device_index)


#: C entry points already looked up in the library, by name
_BOUND: dict = {}


@spanned("spmv.launch")
def _call(fn, args, device_index: int) -> int:
    """The C call of :func:`launch`, where a full launch queue blocks."""
    return fn(*args, current_stream(device_index))


def launch(name: str, device_index: int, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current
    stream of CUDA device ``device_index`` (the operands' card, from
    ``tensor.get_device()``); raise if the launch failed."""
    fn = _BOUND.get(name)
    if fn is None:
        fn = _BOUND[name] = getattr(library(), name)
    err = _call(fn, args, device_index)
    if err:             # cudaGetLastError() after the launch, or a refusal
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
    launches[name] += 1
