"""The reader of ``cg_overlap_share`` on a traced run of ``hpcg_cg50``
on the CPU at a small size: at ``tol = 0`` the reads of r_2 to
r_(maxiter-1) have the next iteration queued, so the share is
``100 * (maxiter - 2) / maxiter``, beside ``maxiter`` host reads a
solve; a port without the counter gives None."""

from types import SimpleNamespace

import torch

from portbench import run
from spmv_vector_cache_tpu_torch.utils import stats

CFG, TRAFFIC = {"nx": 16, "ny": 16, "nz": 16}, {"maxiter": 8,
                                                "trace_units": 3}


def test_the_share_of_reads_overlapped_in_hpcg_cg50():
    sync = torch.cuda.synchronize     # the traced tail's card syncs
    torch.cuda.synchronize = lambda *a, **k: None
    try:
        stats.span_totals.clear()
        stats.counters.clear()
        line = run.run_cell("hpcg_cg50", 2**31 + 43, 0.1, True,
                            device="cpu", cfg_overrides=CFG,
                            traffic_overrides=TRAFFIC)
    finally:
        torch.cuda.synchronize = sync
    m, maxiter = line["metrics"], TRAFFIC["maxiter"]
    assert line["correct"] is True
    assert m["cg_overlap_share"] == {"value": 100 * (maxiter - 2) / maxiter,
                                     "unit": "%"}
    assert m["host_syncs_per_solve"]["value"] == maxiter
    assert stats.counters["cg.spec_discarded"] == 0


def test_the_reader_finds_nothing_in_a_port_without_the_counter(
        monkeypatch):
    reader = run.load_module(run.reader_path("cg_overlap_share"),
                             "portbench_metric_cg_overlap_share")
    ctx = SimpleNamespace(state={})
    monkeypatch.setattr(stats, "counters", {"cg.solves": 2,
                                            "cg.host_syncs": 100})
    assert reader.read(ctx) is None
    monkeypatch.delattr(stats, "counters")
    assert reader.read(ctx) is None
