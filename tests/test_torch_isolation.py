"""The port stands alone: importing it pulls in neither jax nor the JAX
package (the machine with the GPU has no JAX), and its sources import
neither."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "spmv_vector_cache_tpu_torch"


def test_import_pulls_in_no_jax():
    code = ("import spmv_vector_cache_tpu_torch, sys; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert 'spmv_vector_cache_tpu' not in sys.modules, 'pkg'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|spmv_vector_cache_tpu)(\.|\s|$)", re.M)
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 10
    bad = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not bad, bad


def test_native_sources_and_build_lie_in_the_port():
    from spmv_vector_cache_tpu_torch import native_lib

    paths = [native_lib.NATIVE, native_lib.BUILD,
             native_lib.build_dir("c++"), *native_lib.sources()]
    for path in paths:
        assert PORT in pathlib.Path(path).resolve().parents, path
    assert {p.name for p in native_lib.sources()} == {
        "cli.cpp", "spmvref.cpp", "spmvref.h"}


def test_default_tune_store_is_the_ports_own():
    from spmv_vector_cache_tpu.ops import tune as jtune
    from spmv_vector_cache_tpu_torch.ops import tune as ptune

    assert ptune.DEFAULT_STORE != jtune.DEFAULT_STORE
    assert ptune.DEFAULT_STORE.endswith(".json")
