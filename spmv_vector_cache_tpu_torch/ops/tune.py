"""Plan-parameter autotune: the design-space sweep, persisted (counterpart
of ``spmv_vector_cache_tpu/ops/tune.py``).

:func:`autotune_plan` builds a small candidate grid around the heuristic
plan (grid-step width, window group tiles, uniform-split factor, stripe
width, DIA sublanes, packed chunk width, cache tier cap), places every
candidate on the device, applies each once, then times each with CUDA
events (``strategy._time_rounds``: two rounds, in order and in reverse)
and persists the winner keyed by a structural signature, so that a later
call skips the sweep.

The store's JSON format and the signatures are the reference's, so a
store written by either package keys the same entries; the port's
default store is a file of its own (:data:`DEFAULT_STORE`): a TPU's
winner is no GPU's.

Only a candidate whose host plan builder refuses the matrix
(``ValueError`` or ``NotImplementedError``) is skipped, and recorded
with its message in :attr:`TuneResult.skipped`; an error raised while
placing, applying or timing a candidate propagates.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..formats.cached import CachedPlan, build_cached_plan
from ..formats.dia import DiaPlan, HybridPlan, build_dia_plan
from ..formats.packed import PackedPlan, build_packed_plan
from ..formats.plan import (SellPlan, _as_csr, auto_plan, build_sell_plan,
                            place)
from . import semiring as sr
from .spmv_sell import plan_x_dtype, spmv_plan
from .strategy import _time_rounds, plan_nnz

#: default on-disk store of the port's tuned configurations (the
#: reference keeps its TPU winners in ``~/.spmv_tpu_tuned.json``)
DEFAULT_STORE = os.path.expanduser("~/.spmv_cuda_tuned.json")


def plan_signature(a) -> str:
    """Structural fingerprint: matrices with the same signature share a
    winning configuration (numpy only; the reference's string)."""
    csr = _as_csr(a)
    lens = np.diff(np.asarray(csr.indptr, dtype=np.int64))
    indices = np.asarray(csr.indices, dtype=np.int64) & 0x3FFFFFFF
    rows, cols = csr.shape
    nnz = max(1, int(indices.shape[0]))
    mean = float(lens.mean()) if lens.size else 0.0
    mx = int(lens.max()) if lens.size else 0
    # coarse popularity + locality features
    top = 0.0
    span = 0
    if nnz > 1:
        counts = np.bincount(indices, minlength=cols)
        top = float(np.sort(counts)[::-1][:2048].sum()) / nnz
        nz_row = np.repeat(np.arange(rows, dtype=np.int64), lens)
        first = np.searchsorted(nz_row, np.arange(rows))
        last = np.searchsorted(nz_row, np.arange(rows), side="right") - 1
        ok = last >= first
        if ok.any():
            span = int(np.median((indices[last[ok]]
                                  - indices[first[ok]])))
    key = (rows, cols, nnz, round(mean, 1), mx, round(top, 2),
           span // 128)
    return "sig_" + "_".join(str(k) for k in key)


@dataclasses.dataclass
class TuneEntry:
    name: str
    seconds: float
    gnnz_per_s: float
    params: Dict[str, Any]


@dataclasses.dataclass
class TuneResult:
    signature: str
    best: str
    #: the winner, placed on the sweep's device
    plan: Any
    table: List[TuneEntry]
    #: (name, message) of each candidate its host plan builder refused
    skipped: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    def as_rows(self) -> List[Dict[str, Any]]:
        return [{"candidate": e.name, "seconds": e.seconds,
                 "gnnz_per_s": round(e.gnnz_per_s, 3),
                 "best": e.name == self.best, **e.params}
                for e in self.table]


def _candidates(a, base_plan, value_dtype, semiring
                ) -> List[Tuple[str, Dict[str, Any], Callable[[], Any]]]:
    """(name, params, builder) triples around the heuristic choice: the
    reference's names and parameters.  SELL and cache-tier candidates pad
    with the semiring's zero (the reference pads them with 0 under every
    semiring, which breaks a min-plus candidate's result)."""
    pad = float(sr.get(semiring).zero)
    cands: List[Tuple[str, Dict[str, Any], Callable[[], Any]]] = [
        ("auto", {}, lambda: base_plan)]

    if isinstance(base_plan, (DiaPlan, HybridPlan)):
        dia_src = base_plan.dia if isinstance(base_plan, HybridPlan) \
            else base_plan
        for s in (16, 32, 64):
            if s != dia_src.sublanes:
                cands.append((f"dia_sublanes{s}", {"sublanes": s},
                              lambda s=s: build_dia_plan(
                                  a, sublanes=s,
                                  value_dtype=value_dtype)))
        cands.append(("sell", {},
                      lambda: auto_plan(a, value_dtype=value_dtype,
                                        allow_dia=False,
                                        semiring=semiring)))
    elif isinstance(base_plan, SellPlan):
        st = base_plan.stats
        for gps in {max(1, st.groups_per_step // 2),
                    st.groups_per_step * 2} - {st.groups_per_step}:
            cands.append((f"groups_per_step{gps}",
                          {"groups_per_step": gps},
                          lambda g=gps: build_sell_plan(
                              a, value_dtype=value_dtype, pad_value=pad,
                              groups_per_step=g)))
        for wgt in (1, 2, 4):
            if wgt != st.group_tiles and not st.uniform_parts:
                cands.append((f"window_group_tiles{wgt}",
                              {"window_group_tiles": wgt},
                              lambda w=wgt: build_sell_plan(
                                  a, value_dtype=value_dtype, pad_value=pad,
                                  window_group_tiles=w)))
        if st.uniform_parts:
            for sp in (8, 16, 32):
                cands.append((f"uniform_split{sp}", {"split": sp},
                              lambda s=sp: build_sell_plan(
                                  a, value_dtype=value_dtype, pad_value=pad,
                                  split=s, uniform_split=True,
                                  window_group_tiles=max(
                                      1, -(-s // base_plan.positions)))))
        if st.num_stripes > 1:
            sw = st.window_blocks * 128 if st.window_blocks else 2048
            for f in (2, 4):
                cands.append((f"stripe_width{sw * f}",
                              {"stripe_width": sw * f},
                              lambda w=sw * f: build_sell_plan(
                                  a, value_dtype=value_dtype, pad_value=pad,
                                  stripe_width=w)))
    elif isinstance(base_plan, PackedPlan):
        for cb in (32, 64, 128):
            if cb != base_plan.stats.chunk_blocks:
                cands.append((f"chunk_blocks{cb}", {"chunk_blocks": cb},
                              lambda c=cb: build_packed_plan(
                                  a, chunk_blocks=c,
                                  value_dtype=value_dtype)))
    elif isinstance(base_plan, CachedPlan):
        for mh in (512, 2048, 8192):
            if mh != base_plan.hot_cols.shape[0]:
                cands.append((f"max_hot{mh}", {"max_hot": mh},
                              lambda m=mh: build_cached_plan(
                                  a, max_hot=m, pad_value=pad,
                                  value_dtype=value_dtype) or base_plan))
        cands.append(("levels1", {"levels": 1},
                      lambda: build_cached_plan(
                          a, levels=1, pad_value=pad,
                          value_dtype=value_dtype) or base_plan))
    return cands


def _read_store(store: Optional[str]) -> dict:
    if not (store and os.path.exists(store)):
        return {}
    with open(store) as f:
        try:
            return json.load(f)
        except ValueError:
            return {}


def autotune_plan(a, *, value_dtype=np.float32,
                  semiring: str = "plus_times", iters: int = 10,
                  store: Optional[str] = None, force: bool = False,
                  device="cuda",
                  check: Optional[Callable[[str, Any, torch.Tensor], None]]
                  = None) -> TuneResult:
    """Sweep plan-parameter candidates on ``device`` (the card unless the
    caller asks for the CPU); persist the winner.

    ``store``: JSON path ({signature: {best, table}}); when the signature
    is present and ``force`` is False, the stored winner is rebuilt and
    placed with no timing (a table of one entry at 0.0 s).  Otherwise
    every candidate is built on the host, placed and applied once to x
    = ones in the plan's value dtype; ``check(name, placed_plan, y)``,
    when given, sees each first y before any candidate is timed; then
    each is timed over ``iters`` applies in two rounds, the candidates in
    order and then in reverse, and keeps the lower of its two medians."""
    device = torch.device(device)
    sig = plan_signature(a)
    base = auto_plan(a, value_dtype=value_dtype, semiring=semiring)
    stored = _read_store(store)
    cands = _candidates(a, base, value_dtype, semiring)
    if not force and sig in stored:
        want = stored[sig]["best"]
        for name, params, build in cands:
            if name == want:
                return TuneResult(
                    signature=sig, best=want, plan=place(build(), device),
                    table=[TuneEntry(name=want, seconds=0.0,
                                     gnnz_per_s=0.0, params=params)])
    # ones in the plan's x type, as the reference's np.ones(cols,
    # value_dtype)
    x = torch.ones(a.shape[1], dtype=plan_x_dtype(base), device=device)
    built, skipped = [], []
    for name, params, build in cands:
        try:
            plan = build()
        except (ValueError, NotImplementedError) as e:   # infeasible
            skipped.append((name, f"{type(e).__name__}: {e}"))
            continue
        placed = place(plan, device)
        y = spmv_plan(placed, x, semiring=semiring)
        if check is not None:
            check(name, placed, y)
        built.append((name, params, placed))
    times = _time_rounds(
        {name: (lambda p=placed: spmv_plan(p, x, semiring=semiring))
         for name, _, placed in built}, iters)
    table: List[TuneEntry] = []
    best_plan, best_name, best_dt = None, "auto", float("inf")
    for name, params, placed in built:
        dt = times[name]
        nnz = plan_nnz(placed)
        table.append(TuneEntry(name=name, seconds=dt,
                               gnnz_per_s=nnz / dt / 1e9 if dt else 0.0,
                               params=params))
        if dt < best_dt:
            best_plan, best_name, best_dt = placed, name, dt
    res = TuneResult(signature=sig, best=best_name, plan=best_plan,
                     table=table, skipped=skipped)
    if store:
        stored[sig] = {"best": best_name,
                       "table": [{"name": e.name,
                                  "seconds": e.seconds,
                                  "gnnz_per_s": e.gnnz_per_s}
                                 for e in table]}
        with open(store, "w") as f:
            json.dump(stored, f, indent=1, sort_keys=True)
    return res
