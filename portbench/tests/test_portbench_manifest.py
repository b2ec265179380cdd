"""BENCHMARK.json against the rules for its fields, and every name it
gives found as a file of the harness."""

import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert M["command"] == ["python3", "portbench/run.py"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_names_and_units_use_only_the_allowed_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    names += [w[k] for w in M["workloads"] for k in ("config", "traffic")]
    names += [r for c in M["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [x["unit"] for k in ("end_to_end", "per_layer") for x in M[k]]
    assert all(UNIT.match(u) for u in units), units
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in M[k]}) == len(M[k])


def test_metrics_follow_the_rules_for_their_fields():
    e2e = {x["name"]: x for x in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in M["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in M["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in e2e and x["better"] in ("lower", "higher")
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
        for w in x.get("workloads", []):
            moved = e2e[x["moves"]]
            assert w in moved.get("workloads", [w])
    layers = {x["layer"] for x in M["per_layer"]}
    assert layers == {"Planner", "Dispatch", "Solver", "Kernels", "Device"}


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    from portbench import run

    c, e2e, layer = run.resolve(cell, M)
    assert c["chips"] == 1 and len(c["why"]) <= 200
    names = {x["name"] for x in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    assert (HERE / "limits" / f"{cell}.json").exists()
    traffic = json.loads((HERE / "traffic" / f"{c['traffic']}.json")
                         .read_text())
    assert (HERE / "loops" / f"{traffic['loop']}.py").exists()
    for x in layer:
        assert run.reader_path(x["name"]).exists(), x["name"]


@pytest.mark.parametrize("conf", M["configs"], ids=lambda c: c["name"])
def test_config_files_state_source_reduced_and_assumed(conf):
    assert conf["file"] == f"portbench/configs/{conf['name']}.json"
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["source"]
    assert cfg["reduced"] == conf["reduced"]
    assert all(k in cfg for k in cfg["reduced"])
    assert isinstance(cfg["assumed"], dict) and cfg["assumed"]
    assert (ROOT / conf["file"]).with_suffix(".py").exists()
    assert any(w["config"] == conf["name"] for w in M["workloads"])


def test_a_full_check_of_24_cells_fits_its_time():
    cells = 24
    total = (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
