"""The gap_kron_pull cell on the CPU at small scales: a run through the
port's normal path agrees with the plain reference, the control (the
reference below float32) and the faults planted underneath the timed path
that y_err can see fail the committed limit, and a traced run reports
the cell's new per-layer metrics that a CPU run can read."""

import json
import math
from pathlib import Path

import pytest
import torch

from portbench import calibrate, calibrate_f32, run
from spmv_vector_cache_tpu_torch.utils import stats

HERE = Path(__file__).resolve().parents[1]
CELL = "gap_kron_pull"
SEEDS = [2**31 + 11, 2**31 + 18, 2**31 + 25]
LIMITS = json.loads((HERE / "limits" / f"{CELL}.json").read_text())


def _fails(rec):
    return any(not (rec[k] <= v) for k, v in LIMITS.items())


@pytest.mark.parametrize("scale", [10, 12])
def test_a_small_run_is_correct(scale):
    line = run.run_cell(CELL, SEEDS[0], 0.2, False, device="cpu",
                        cfg_overrides={"scale": scale})
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"spmv_rate", "setup_s"}
    json.dumps(line, allow_nan=False)


def test_the_program_passes_and_the_bfloat16_control_fails():
    recs = calibrate_f32.readings(CELL, SEEDS, 0.05, device="cpu",
                                  cfg={"scale": 11}, faults=(), out=None)
    prog = [r for r in recs if r["who"] == "program"]
    ctrl = [r for r in recs if r["who"].startswith("control")]
    # bfloat16 throughout, and bfloat16 or float16 values summed in float32
    assert len(prog) == 3 and len(ctrl) == 3 * len(calibrate_f32.CONTROLS)
    assert not any(_fails(r) for r in prog)
    assert all(_fails(r) for r in ctrl)


# calibrate.py's third fault, one entry of y altered by 1e-6 of max |y|,
# reads 0.7e-7 to 2.0e-7 here against the program's own 1.4e-8 to 1.2e-7
# (scales 9-12): in y_err's norm, max |y - y_ref| / max |P| |x|, it lies
# inside float32's rounding of the hub rows' long sums, so no limit above
# the program's readings catches it (PERF.md, section 2)
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_run_broken_underneath_is_not_correct(fault):
    with calibrate.matvec_fault(fault, SEEDS[0]):
        line = run.run_cell(CELL, SEEDS[1], 0.05, False, device="cpu",
                            cfg_overrides={"scale": 11})
    assert line["correct"] is False and line["failed"] >= 1


def test_a_traced_run_reports_the_planner_and_fill_metrics():
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **k: None
    stats.counters.clear()
    stats.span_totals.clear()
    try:
        line = run.run_cell(CELL, SEEDS[2], 0.05, True, device="cpu",
                            cfg_overrides={"scale": 10},
                            traffic_overrides={"trace_units": 5})
    finally:
        torch.cuda.synchronize = sync
    m = line["metrics"]
    assert line["correct"] is True
    assert 0 < m["slot_fill"]["value"] <= 100
    assert math.isfinite(m["discarded_build_s"]["value"]) and \
        m["discarded_build_s"]["value"] >= 0
    for name in ("plan_s", "detect_s", "place_s", "host_us_per_apply",
                 "dispatch_us.pull"):
        assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0, name
    # no card: no published peak and no device time to read
    assert "spmv_roofline.pull" not in m and "idle_share.pull" not in m


def test_the_new_readers_find_nothing_in_a_port_without_them(monkeypatch):
    from types import SimpleNamespace

    monkeypatch.delattr(stats, "counters")
    ctx = SimpleNamespace(state={"op": SimpleNamespace(stats={})})
    for name in ("slot_fill", "discarded_build_s"):
        reader = run.load_module(run.reader_path(name),
                                 f"portbench_metric_{name}")
        assert reader.read(ctx) is None, name
