"""The comparison that decides ``correct``, at sizes a test run holds:
sound runs of the program pass the committed limits, the control (the
plain reference one precision lower in the program's place) fails one
of them, and a run with its timed path broken underneath comes out not
correct, once for each fault the cell can have."""

import json
from pathlib import Path

import pytest

from portbench import calibrate, run

HERE = Path(__file__).resolve().parents[1]
SEEDS = [2**31 + 11, 2**31 + 18, 2**31 + 25]
MATRIX = {"hpcg_spmv": ({"nx": 8, "ny": 8, "nz": 16}, {}),
          "hpcg_cg50": ({"nx": 16, "ny": 16, "nz": 16}, {"maxiter": 8})}


def _limits(cell):
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def _fails(rec, limits):
    return any(not (rec[k] <= v) for k, v in limits.items())


@pytest.mark.parametrize("cell", sorted(MATRIX))
def test_matrix_program_passes_and_control_fails(cell):
    cfg, traffic = MATRIX[cell]
    recs = calibrate.matrix_readings(cell, SEEDS, 0.05, device="cpu",
                                     cfg=cfg, traffic=traffic, faults=(),
                                     out=None)
    lim = _limits(cell)
    prog = [r for r in recs if r["who"] == "program"]
    ctrl = [r for r in recs if r["who"] == "control"]
    assert len(prog) == 3 and len(ctrl) == 3
    assert not any(_fails(r, lim) for r in prog)
    assert all(_fails(r, lim) for r in ctrl)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(MATRIX))
def test_a_matrix_run_broken_underneath_is_not_correct(cell, fault):
    cfg, traffic = MATRIX[cell]
    with calibrate.matvec_fault(fault, SEEDS[0]):
        line = run.run_cell(cell, SEEDS[1], 0.05, False, device="cpu",
                            cfg_overrides=cfg, traffic_overrides=traffic)
    assert line["correct"] is False and line["failed"] >= 1
