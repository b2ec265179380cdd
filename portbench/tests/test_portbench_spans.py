"""The readers of the port's own spans and counters, on traced runs of
both cells on the CPU at small sizes: each new metric is present and
finite, the solve counts ``maxiter`` host reads, and the planner's
stages fit inside ``plan_s``."""

import math

import pytest
import torch

from portbench import run
from spmv_vector_cache_tpu_torch.utils import stats

SMALL = {"hpcg_spmv": ({"nx": 8, "ny": 8, "nz": 16}, {"trace_units": 20}),
         "hpcg_cg50": ({"nx": 16, "ny": 16, "nz": 16},
                       {"maxiter": 8, "trace_units": 3})}
NEW = {"hpcg_spmv": ("detect_s", "place_s", "dispatch_us.spmv"),
       "hpcg_cg50": ("detect_s", "place_s", "dispatch_us.cg",
                     "host_syncs_per_solve")}


@pytest.fixture(scope="module")
def lines():
    """One traced run of each cell; the card's synchronisation, which the
    traced tail calls around the profiler, is a no-op on the CPU."""
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a, **k: None
    try:
        out = {}
        for cell, (cfg, traffic) in SMALL.items():
            stats.span_totals.clear()
            stats.counters.clear()
            out[cell] = run.run_cell(cell, 2**31 + 41, 0.1, True,
                                     device="cpu", cfg_overrides=cfg,
                                     traffic_overrides=traffic)
        return out
    finally:
        torch.cuda.synchronize = sync


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_each_new_metric_is_present_and_finite(lines, cell):
    line = lines[cell]
    assert line["correct"] is True
    for name in NEW[cell]:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, name


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_planner_stages_fit_inside_plan_s(lines, cell):
    m = lines[cell]["metrics"]
    assert m["detect_s"]["value"] + m["place_s"]["value"] <= \
        m["plan_s"]["value"]


def test_each_solve_reads_the_host_maxiter_times(lines):
    m = lines["hpcg_cg50"]["metrics"]
    assert m["host_syncs_per_solve"]["value"] == \
        SMALL["hpcg_cg50"][1]["maxiter"]


def test_the_readers_find_nothing_in_a_port_without_them(monkeypatch):
    """The parent's port has neither the stage times, nor the span
    totals, nor the counters: each reader returns None and raises
    nothing."""
    from types import SimpleNamespace

    monkeypatch.delattr(stats, "span_totals")
    monkeypatch.delattr(stats, "counters")
    ctx = SimpleNamespace(state={"op": SimpleNamespace(stats={})})
    for name in sorted({n for names in NEW.values() for n in names}):
        reader = run.load_module(run.reader_path(name),
                                 f"portbench_metric_{name}")
        assert reader.read(ctx) is None, name
