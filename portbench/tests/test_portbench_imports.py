"""Neither the harness nor the port it runs imports JAX or the JAX
package.  Names are compared by their whole top-level part: the port's
name, spmv_vector_cache_tpu_torch, begins with the JAX package's."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from portbench import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["spmv_vector_cache_tpu_torch",
                                  "spmv_vector_cache_tpu_torch.ops",
                                  "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["spmv_vector_cache_tpu.ops",
                                  "jaxlib.xla_client", "jax", "flax.nnx"]) \
        == ["flax", "jax", "jaxlib", "spmv_vector_cache_tpu"]


def test_no_harness_source_imports_jax_or_the_jax_package():
    for path in sorted(HERE.rglob("*.py")):
        found = set(_top_level_imports(path)) & run.FORBIDDEN
        assert not found, (path, found)


SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench import run
for cell in ("hpcg_spmv", "hpcg_cg50"):
    cfg = {"nx": 8, "ny": 8, "nz": 8}
    run.run_cell(cell, 7, 0.05, False, device="cpu", cfg_overrides=cfg,
                 traffic_overrides={"maxiter": 3, "warmup": 1})
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_of_every_cell_loads_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "spmv_vector_cache_tpu_torch" in loaded and "torch" in loaded
    assert run.forbidden_modules(loaded) == []
