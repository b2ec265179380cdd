"""The command refuses to run without a card, and the rest of a run
works on the CPU at small sizes (what the tests can reach)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SMALL = {"hpcg_spmv": ({"nx": 8, "ny": 8, "nz": 16}, {}),
         "hpcg_cg50": ({"nx": 16, "ny": 16, "nz": 16}, {"maxiter": 8})}


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hpcg_spmv",
         "--seed", str(2**31 + 99), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_cannot_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = ("import sys; sys.path.insert(0, '.'); from portbench import "
              "run; run.run_cell('hpcg_spmv', 1, 0.1, False, device='cpu', "
              "cfg_overrides={'nx': 4, 'ny': 4, 'nz': 4})")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "spmv_vector_cache_tpu_torch" in out.stderr
    assert _command(tmp_path).returncode != 0


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_small_run_of_each_cell_on_the_cpu_is_correct(cell):
    cfg, traffic = SMALL[cell]
    line = run.run_cell(cell, 2**31 + 5, 0.2, False, device="cpu",
                        cfg_overrides=cfg, traffic_overrides=traffic)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    _, e2e, _ = run.resolve(cell)
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "check"
    json.dumps(line, allow_nan=False)


def test_judge_fails_a_number_over_its_limit_or_not_a_number():
    ok, failed, table = run.judge({"a": [1e-9, 2e-9], "b": [0, 0]},
                                  {"a": 1e-8, "b": 0})
    assert ok and failed == 0 and table["a"]["value"] == 2e-9
    ok, failed, _ = run.judge({"a": [1e-9, 2e-7]}, {"a": 1e-8})
    assert not ok and failed == 1
    ok, _, table = run.judge({"a": [float("nan")]}, {"a": 1e-8})
    assert not ok and table["a"]["value"] == "nan"
    with pytest.raises(KeyError):
        run.judge({"a": [0.0]}, {"b": 1.0})


@pytest.mark.cuda
def test_a_small_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU "
                    "mode)")
    line = run.run_cell("hpcg_spmv", 2**31 + 7, 0.5, True, device="cuda",
                        cfg_overrides={"nx": 32, "ny": 32, "nz": 32})
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert 0 < line["metrics"]["spmv_roofline"]["value"] <= 105
