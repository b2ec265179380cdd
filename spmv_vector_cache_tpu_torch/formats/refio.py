"""IO for the reference's on-disk matrix format (and Matrix Market);
counterpart of ``spmv_vector_cache_tpu/formats/refio.py``, whose files it
writes byte for byte.

The wire format of the whole reference system is five little-endian files per
matrix ``name`` (written by ``matrices/matrixutils.py:187-260``, read
zero-copy by ``software/SparseMatrix.cpp:29-50`` against the C struct
``CompressedSparseMetadata`` at ``software/SparseMatrix.h:8-16``):

* ``name-meta.bin``  — 7 x uint32: rows, cols, nnz, startingRow, then the
  DRAM addresses of the three payload files laid out from a base address with
  64-byte burst alignment (``matrixutils.py:174-179``),
* ``name-indptr.bin`` — CSC column pointers, (cols+1) x uint32,
* ``name-inds.bin``   — row indices, nnz x uint32,
* ``name-data.bin``   — nnz values (float64, or uint64 for the ``*-uint64``
  exactness variants, ``matrixutils.py:100-103``),
* ``golden.bin``      — y = A @ ones as float64 (``matrixutils.py:108-113``).

This module reads and writes that format bit-compatibly, so every matrix
bundled with the reference loads verbatim, and matrices we write can be
consumed by the reference toolchain (including the JTAG ``upload.tcl``
emission, ``matrixutils.py:262-273``).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .containers import CSC

DRAM_BASE = 0x8000100      # matrixutils.py:9 / main.cpp:17
BURST_ALIGN = 64           # matrixutils.py:197
META_BYTES = 28            # matrixutils.py:211


@dataclass(frozen=True)
class RefMeta:
    """Decoded ``-meta.bin`` — mirror of ``CompressedSparseMetadata``."""

    rows: int
    cols: int
    nnz: int
    starting_row: int
    indptr_base: int
    inds_base: int
    data_base: int

    def pack(self) -> bytes:
        return struct.pack(
            "<7I", self.rows, self.cols, self.nnz, self.starting_row,
            self.indptr_base, self.inds_base, self.data_base)

    @classmethod
    def unpack(cls, raw: bytes) -> "RefMeta":
        return cls(*struct.unpack("<7I", raw[:META_BYTES]))


def aligned_increment(base: int, increment: int, align: int = BURST_ALIGN) -> int:
    """Advance ``base`` by ``increment`` and round up to ``align``
    (port of ``matrixutils.py:174-179`` / ``chisel/spmv-common.scala:131-139``)."""
    res = base + increment
    rem = res % align
    if rem:
        res += align - rem
    return res


def _matrix_files(directory: str, name: Optional[str] = None) -> Tuple[str, dict]:
    name = name or os.path.basename(os.path.normpath(directory))
    return name, {
        part: os.path.join(directory, f"{name}-{part}.bin")
        for part in ("meta", "indptr", "inds", "data")
    }


def load_reference_matrix(directory: str, name: Optional[str] = None) -> CSC:
    """Load a reference-format matrix directory into a :class:`CSC`.

    Value dtype is inferred from the data payload size: ``nnz * 8`` bytes is
    float64 unless the directory name carries the ``-uint64`` tag used by the
    exactness variants (``matrixutils.py:100-103``).
    """
    name, files = _matrix_files(directory, name)
    with open(files["meta"], "rb") as f:
        meta = RefMeta.unpack(f.read())
    indptr = np.fromfile(files["indptr"], dtype="<u4")
    inds = np.fromfile(files["inds"], dtype="<u4")
    data_dtype = "<u8" if "uint64" in name else "<f8"
    data = np.fromfile(files["data"], dtype=data_dtype)
    if indptr.shape[0] != meta.cols + 1:
        raise ValueError(
            f"{name}: indptr length {indptr.shape[0]} != cols+1 ({meta.cols + 1})")
    if inds.shape[0] != meta.nnz or data.shape[0] != meta.nnz:
        raise ValueError(f"{name}: payload length mismatch vs meta nnz={meta.nnz}")
    return CSC(data=data, indices=inds.astype(np.int32),
               indptr=indptr.astype(np.int32), shape=(meta.rows, meta.cols))


def load_golden(directory: str) -> Optional[np.ndarray]:
    """Load ``golden.bin`` (y = A @ ones, float64) if present."""
    path = os.path.join(directory, "golden.bin")
    if not os.path.exists(path):
        return None
    return np.fromfile(path, dtype="<f8")


def save_reference_matrix(a: CSC, directory: str, name: Optional[str] = None,
                          start_addr: int = DRAM_BASE,
                          write_upload_script: bool = True) -> List[Tuple[str, int]]:
    """Write a CSC matrix in the reference's binary format.

    Reproduces the 64-byte-aligned address layout of
    ``matrixutils.py:187-260`` and (optionally) the JTAG ``upload.tcl``
    emission of ``matrixutils.py:262-273`` for toolchain compatibility.
    Returns the (relative file, address) command list.
    """
    name = name or os.path.basename(os.path.normpath(directory))
    os.makedirs(directory, exist_ok=True)
    _, files = _matrix_files(directory, name)

    indptr = np.ascontiguousarray(np.asarray(a.indptr), dtype="<u4")
    inds = np.ascontiguousarray(np.asarray(a.indices), dtype="<u4")
    data = np.asarray(a.data)
    if data.dtype.kind == "u":
        data = np.ascontiguousarray(data, dtype="<u8")
    else:
        data = np.ascontiguousarray(data, dtype="<f8")

    commands: List[Tuple[str, int]] = [(files["meta"], start_addr)]
    addr = aligned_increment(start_addr, META_BYTES)

    indptr_base = addr
    indptr.tofile(files["indptr"])
    commands.append((files["indptr"], addr))
    addr = aligned_increment(addr, indptr.nbytes)

    inds_base = addr
    inds.tofile(files["inds"])
    commands.append((files["inds"], addr))
    addr = aligned_increment(addr, inds.nbytes)

    data_base = addr
    data.tofile(files["data"])
    commands.append((files["data"], addr))

    meta = RefMeta(rows=a.shape[0], cols=a.shape[1], nnz=int(inds.shape[0]),
                   starting_row=0, indptr_base=indptr_base,
                   inds_base=inds_base, data_base=data_base)
    with open(files["meta"], "wb") as f:
        f.write(meta.pack())

    if write_upload_script:
        lines = ["connect arm hw"]
        lines += [f"dow -data {path} 0x{a:08X}" for path, a in commands]
        lines.append("disconnect 64\n")
        with open(os.path.join(directory, "upload.tcl"), "wb") as f:
            f.write("\n".join(lines).encode())
    return commands


def save_golden(y: np.ndarray, directory: str) -> str:
    path = os.path.join(directory, "golden.bin")
    np.ascontiguousarray(y, dtype="<f8").tofile(path)
    return path


def load_matrix_market(path: str) -> CSC:
    """Load a Matrix Market ``.mtx`` file as CSC with sorted indices
    (the ``loadMatrix`` role, ``matrixutils.py:163-169``)."""
    from scipy import io as scipy_io

    sp = scipy_io.mmread(path).tocsc()
    sp.sort_indices()
    return CSC(data=np.asarray(sp.data), indices=sp.indices.astype(np.int32),
               indptr=sp.indptr.astype(np.int32), shape=tuple(sp.shape))
