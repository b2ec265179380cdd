"""Package build for spmv_vector_cache_tpu (incl. the native runtime)."""

import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py


class BuildNative(build_py):
    """Compile the C++ reference runtime alongside the Python package."""

    def run(self):
        native = Path(__file__).parent / "spmv_vector_cache_tpu" / "native"
        try:
            subprocess.run(["make", "-C", str(native), "all"], check=True)
        except (subprocess.SubprocessError, OSError) as e:
            print(f"warning: native build skipped ({e}); "
                  "numpy fallbacks remain available")
        super().run()


setup(
    name="spmv_vector_cache_tpu",
    version="0.1.0",
    description=("TPU-native sparse linear-algebra library "
                 "(SpMV/SpMM/SpGEMM/trisolve with Pallas kernels, "
                 "shard_map scaling, and a native host runtime)"),
    packages=find_packages(include=["spmv_vector_cache_tpu*"]),
    package_data={"spmv_vector_cache_tpu.native": ["*.cpp", "*.h",
                                                   "Makefile"],
                  "spmv_vector_cache_tpu_torch": ["csrc/*.cu",
                                                  "csrc/*.cuh",
                                                  "native/*.cpp",
                                                  "native/*.h"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
    cmdclass={"build_py": BuildNative},
)
