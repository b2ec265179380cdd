"""Matrix preparation pipeline — the ``matrices/matrixutils.py`` role
(counterpart of ``spmv_vector_cache_tpu/tools/matrixtools.py``; numpy
only, its files byte-identical to the JAX tool's).

Ingest SuiteSparse/Matrix-Market matrices, convert them to the binary
wire format, emit goldens and upload scripts, and run the structure
analyses.  Network download is gated: `prepare_suitesparse` works from a
local tarball or .mtx file and only attempts HTTP when explicitly allowed.

CLI:  python -m spmv_vector_cache_tpu_torch.tools.matrixtools convert a.mtx outdir/
"""

from __future__ import annotations

import os
import sys
import tarfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..formats import analysis, refio
from ..formats.containers import CSC
from ..ops import reference

#: the reference's 12-matrix SuiteSparse evaluation suite (matrixutils.py:18-21)
TEST_SUITE = [
    "Williams/pdb1HYS", "Williams/consph", "Williams/cant",
    "Boeing/pwtk", "Bova/rma10", "QCD/conf5_4-8x8-05", "DNVS/shipsec1",
    "Williams/mac_econ_fwd500", "Williams/cop20k_A",
    "Williams/webbase-1M", "Williams/mc2depi", "Hamm/scircuit",
]

SUITESPARSE_URL = "https://suitesparse-collection-website.herokuapp.com/MM/{}.tar.gz"


def load_mtx(path: str) -> CSC:
    """``loadMatrix`` role (matrixutils.py:163-169)."""
    return refio.load_matrix_market(path)


def convert_matrix(a: CSC, out_dir: str, name: Optional[str] = None,
                   start_addr: int = refio.DRAM_BASE) -> List[Tuple[str, int]]:
    """``convertMatrix`` role (matrixutils.py:187-260): write the binary
    wire format with aligned layout + upload.tcl; returns command list."""
    return refio.save_reference_matrix(a, out_dir, name=name,
                                       start_addr=start_addr)


def make_golden_result(a: CSC, out_dir: str) -> str:
    """``makeGoldenResult`` role (matrixutils.py:108-113): y = A @ ones."""
    y = reference.golden(a)
    return refio.save_golden(np.asarray(y, dtype=np.float64), out_dir)


def to_uint64_matrix(a: CSC) -> CSC:
    """``toUInt64Matrix`` role (matrixutils.py:100-103): all-ones uint64
    payload for order-independent exactness testing."""
    return CSC(data=np.ones_like(np.asarray(a.data), dtype=np.uint64),
               indices=a.indices, indptr=a.indptr, shape=a.shape)


def prepare_mtx(mtx_path: str, out_base: str,
                name: Optional[str] = None) -> str:
    """Convert one .mtx file into a wire-format directory + golden."""
    name = name or os.path.splitext(os.path.basename(mtx_path))[0]
    a = load_mtx(mtx_path)
    out_dir = os.path.join(out_base, name)
    convert_matrix(a, out_dir, name=name)
    make_golden_result(a, out_dir)
    return out_dir


def prepare_suitesparse(full_name: str, out_base: str,
                        download_dir: Optional[str] = None,
                        allow_network: bool = False) -> str:
    """``prepareUFLMatrix`` role (matrixutils.py:73-97): fetch + extract +
    convert one SuiteSparse matrix.  Works offline from an existing tarball
    or .mtx in ``download_dir``; only downloads when ``allow_network``."""
    name = full_name.split("/")[-1]
    download_dir = download_dir or os.path.join(out_base, "download")
    mtx_path = os.path.join(download_dir, f"{name}.mtx")
    tar_path = os.path.join(download_dir, f"{name}.tar.gz")
    if not os.path.exists(mtx_path):
        if not os.path.exists(tar_path):
            if not allow_network:
                raise FileNotFoundError(
                    f"{mtx_path} / {tar_path} not present and network "
                    "download disabled (allow_network=False)")
            import urllib.request
            os.makedirs(download_dir, exist_ok=True)
            urllib.request.urlretrieve(
                SUITESPARSE_URL.format(full_name), tar_path)
        with tarfile.open(tar_path) as tar:
            for item in tar:
                if item.name.endswith(f"{name}.mtx"):
                    item.name = f"{name}.mtx"
                    tar.extract(item, download_dir)
                    break
    return prepare_mtx(mtx_path, out_base, name=name)


def analyze(a: CSC) -> Dict[str, int]:
    """All structure analyses for one matrix (getMaxAliveRows /
    getMaxColSpan / histogram roles, matrixutils.py:38-64, 116-137)."""
    out = analysis.summarize(a)
    hist = analysis.row_length_histogram(a)
    out["rowLenMin"] = min(hist) if hist else 0
    out["rowLenMax"] = max(hist) if hist else 0
    return out


def _main(argv: List[str]) -> int:
    if len(argv) >= 3 and argv[0] == "convert":
        out = prepare_mtx(argv[1], argv[2])
        print(f"wrote {out}")
        return 0
    if len(argv) >= 2 and argv[0] == "analyze":
        a = (refio.load_reference_matrix(argv[1])
             if os.path.isdir(argv[1]) else load_mtx(argv[1]))
        for k, v in analyze(a).items():
            print(f"{k}: {v}")
        return 0
    print("usage: matrixtools convert <file.mtx> <out_base> | "
          "analyze <file.mtx|matrix-dir>", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(_main(sys.argv[1:]))
