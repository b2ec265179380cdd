#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU, at full size.

    python3 chip_smoke.py

Builds the CUDA kernels of ``spmv_vector_cache_tpu_torch/csrc/`` and
runs ``SparseOperator.from_matrix(a, device="cuda") @ x`` on five
matrices, one per plan type of the main path:

1. DIA — bench.py's headline matrix: 2^20 rows, 27 diagonals (-13..13),
   standard-normal values, seed 0 (~28.3M nonzeros);
2. SELL window — bench.py's shuffled band: 2^19 rows, 27 nonzeros per
   row at random columns inside the row's 128-column block;
3. Hybrid — the headline band plus ~2 nonzeros per row at random
   columns within +-512 of the diagonal;
4. Chunk — ``tools/realistic.scircuit_like()``: 170,998^2, 926,915
   nonzeros, power-law rows with 24 dense rail rows (a ChunkPlan with
   heavy subwindow buckets);
5. Packed — ``tools/realistic.mac_econ_like()``: 206,500^2, 1,316,368
   nonzeros, short rows spread +-12,000 columns (a PackedPlan).

Each phase checks y against scipy in float64 (relative error below
1e-4, bench.py's gate), checks the plan the planner picked, and checks
that its run of the main path launched the phase's kernels (their
launch counters, set to 0 just before the phase's apply and read just
after).  Each kernel is then compared with its plain PyTorch version on
the same inputs on the card, and both are timed with CUDA events.
Every check raises; nothing is caught.  Needs one CUDA device; exits
non-zero without one.

Standard output, last three lines: the card's name and power limit as
nvidia-smi reports them, one JSON line with the kernels' measurements,
and one JSON line ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: kernel vs plain version on identical inputs: both sum the same float32
#: products, in a different order (fma, summation tree), so they agree
#: to a few float32 ulps of the largest partial sum
KERNEL_RTOL = 1e-5
#: y vs float64 scipy, bench.py's correctness gate
Y_RTOL = 1e-4


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=30, warmup=3):
    """Median milliseconds per call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def device_us_by_kernel(fn, iters=20):
    """Device microseconds per call of ``fn``, by kernel name, from a
    torch.profiler trace of ``iters`` calls (empty if the profiler saw
    no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue                   # host ops: their kernels count below
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            out[ev.key] = us / iters
    return out


def rel_err(y, want):
    y = y.detach().cpu().numpy().astype(np.float64)
    return float(np.abs(y - want).max() / max(1.0, np.abs(want).max()))


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max().item())


def main():
    import scipy.sparse as sp

    from spmv_vector_cache_tpu_torch.formats.chunk import ChunkPlan
    from spmv_vector_cache_tpu_torch.formats.containers import COO
    from spmv_vector_cache_tpu_torch.formats.convert import (coo_to_csr,
                                                              from_scipy)
    from spmv_vector_cache_tpu_torch.formats.dia import DiaPlan, HybridPlan
    from spmv_vector_cache_tpu_torch.formats.packed import PackedPlan
    from spmv_vector_cache_tpu_torch.formats.plan import SellPlan
    from spmv_vector_cache_tpu_torch.ops import _kernels
    from spmv_vector_cache_tpu_torch.ops.lane_perm import (
        lane_unpermute, lane_unpermute_plain)
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
    from spmv_vector_cache_tpu_torch.ops.spmv_chunk import (subwin_kernel,
                                                            subwin_plain)
    from spmv_vector_cache_tpu_torch.ops.spmv_dia import (spmv_dia_kernel,
                                                          spmv_dia_plain)
    from spmv_vector_cache_tpu_torch.ops.spmv_packed import (
        packed_extract_kernel, packed_extract_plain, packed_scan_kernel,
        packed_scan_plain)
    from spmv_vector_cache_tpu_torch.ops.spmv_sell import (
        TILES_PER_STEP, sell_window_kernel, sell_window_plain)
    from spmv_vector_cache_tpu_torch.ops.strategy import plan_nnz
    from spmv_vector_cache_tpu_torch.tools import realistic
    from spmv_vector_cache_tpu_torch.utils.platform import require_cuda

    require_cuda()                     # no CPU fallback: fail without a card

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib_path, nvcc_out = _kernels.build()
    _kernels.library()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s -> "
        f"{lib_path.name}")
    print(nvcc_out, file=sys.stderr, flush=True)
    dev = torch.device("cuda")

    # --- the three matrices (bench.py's draws, in bench.py's order) --------
    n, ndiag = 1 << 20, 27
    rng = np.random.default_rng(0)
    offs = list(range(-(ndiag // 2), ndiag // 2 + 1))
    band = sp.spdiags(rng.standard_normal((ndiag, n)).astype(np.float32),
                      offs, n, n).tocsr()
    band.sort_indices()
    x_dia = rng.standard_normal(n).astype(np.float32)

    ns, blk = n >> 1, 128
    rsh = np.repeat(np.arange(ns, dtype=np.int64), ndiag)
    csh = ((rsh // blk) * blk
           + rng.integers(0, blk, rsh.shape[0])).astype(np.int32)
    a_sell = coo_to_csr(COO(
        data=rng.standard_normal(rsh.shape[0]).astype(np.float32),
        row=rsh.astype(np.int32), col=csh, shape=(ns, ns)))
    x_sell = rng.standard_normal(ns).astype(np.float32)
    m_sell = sp.csr_matrix((a_sell.data, a_sell.indices, a_sell.indptr),
                           shape=(ns, ns))

    rng_h = np.random.default_rng(0)
    rr = np.repeat(np.arange(n, dtype=np.int64), 2)
    cc = np.clip(rr + rng_h.integers(-512, 513, rr.shape[0]), 0, n - 1)
    resid = sp.csr_matrix(
        (rng_h.standard_normal(rr.shape[0]).astype(np.float32), (rr, cc)),
        shape=(n, n))
    m_hyb = (band + resid).tocsr().astype(np.float32)
    m_hyb.sort_indices()
    x_hyb = rng_h.standard_normal(n).astype(np.float32)

    a_chunk = realistic.scircuit_like()
    a_packed = realistic.mac_econ_like()
    rng_x = np.random.default_rng(0)
    x_chunk = rng_x.standard_normal(a_chunk.shape[1]).astype(np.float32)
    x_packed = rng_x.standard_normal(a_packed.shape[1]).astype(np.float32)

    def scipy_of(a):
        return sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)

    # --- plan on the host, place on the card --------------------------------
    ops = {}
    for name, a, x in (("dia", from_scipy(band.astype(np.float32)), x_dia),
                       ("sell", a_sell, x_sell),
                       ("hybrid", from_scipy(m_hyb), x_hyb),
                       ("chunk", a_chunk, x_chunk),
                       ("packed", a_packed, x_packed)):
        op = SparseOperator.from_matrix(a, device=dev)
        ops[name] = (op, torch.from_numpy(x).to(dev))
        fill = (op.plan.dia if isinstance(op.plan, HybridPlan)
                else op.plan).stats.fill
        log(f"[{name}] {op!r} plan_seconds={op.stats['plan_seconds']:.3f} "
            f"bytes_per_apply={op.stats['bytes_per_apply']} fill={fill:.4f}")

    p_dia = ops["dia"][0].plan
    assert isinstance(p_dia, DiaPlan) and ops["dia"][0].strategy == "dia"
    assert p_dia.stats.ndiag == 27 and p_dia.stats.num_steps == 128
    p_sell = ops["sell"][0].plan
    st = p_sell.stats
    assert isinstance(p_sell, SellPlan) and ops["sell"][0].strategy == "window"
    assert tuple(p_sell.vals.shape) == (16384, 8, 128), p_sell.vals.shape
    assert (st.window_blocks, st.group_tiles, st.window_grain,
            st.uniform_parts) == (1, 2, 128, 2), st
    assert st.group_fold and st.group_slice_identity, st
    p_hyb = ops["hybrid"][0].plan
    assert isinstance(p_hyb, HybridPlan) and isinstance(p_hyb.rest, SellPlan)
    assert p_hyb.dia.stats.ndiag == 27
    assert p_hyb.rest.stats.window_blocks == 12, p_hyb.rest.stats
    log(f"[hybrid] rest K={p_hyb.rest.stats.window_blocks} "
        f"tiles={p_hyb.rest.stats.num_tiles} "
        f"fold={p_hyb.rest.stats.group_fold}")
    p_chunk = ops["chunk"][0].plan
    assert isinstance(p_chunk, ChunkPlan) and \
        ops["chunk"][0].strategy == "chunk"
    assert p_chunk.hbuckets and p_chunk.buckets, p_chunk.stats
    assert all(b.stats.window_blocks <= 64 for b in p_chunk.buckets)
    log(f"[chunk] window buckets (K, tiles) "
        f"{[(b.stats.window_blocks, b.num_tiles) for b in p_chunk.buckets]}"
        f", subwindow buckets (W, tiles) "
        f"{[(h.window_blocks, h.num_tiles) for h in p_chunk.hbuckets]}, "
        f"{p_chunk.num_blocks} light blocks, {p_chunk.num_heavy} heavy rows, "
        f"residue {type(p_chunk.residue).__name__}")
    p_packed = ops["packed"][0].plan
    assert isinstance(p_packed, PackedPlan) and \
        ops["packed"][0].strategy == "packed"
    assert p_packed.stats.overflow_nnz > 0, p_packed.stats
    log(f"[packed] {p_packed.stats}")

    # --- the main path, once per phase, counting the launches ---------------
    kernels = {"spmv_dia_f32": spmv_dia_kernel,
               "spmv_sell_window_f32": sell_window_kernel,
               "lane_unpermute_f32": lane_unpermute,
               "spmv_subwin_f32": subwin_kernel,
               "packed_scan_f32": packed_scan_kernel,
               "packed_extract_f32": packed_extract_kernel}
    path_kernels = {"dia": ["spmv_dia_f32"],
                    "sell": ["spmv_sell_window_f32"],
                    "hybrid": ["spmv_dia_f32", "spmv_sell_window_f32"],
                    "chunk": ["spmv_sell_window_f32", "lane_unpermute_f32",
                              "spmv_subwin_f32"],
                    "packed": ["packed_scan_f32", "packed_extract_f32"]}
    launches = dict.fromkeys(kernels, 0)
    ys = {}
    for name, (op, x) in ops.items():
        for k in kernels.values():
            k.launches = 0
        ys[name] = op @ x
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in kernels.items()}
        log(f"[{name}] main-path launches: {counts}")
        assert all(counts[k] > 0 for k in path_kernels[name]), (name, counts)
        for k, c in counts.items():
            launches[k] += c

    # --- y against float64 scipy --------------------------------------------
    ref64 = {"dia": (band, x_dia), "sell": (m_sell, x_sell),
             "hybrid": (m_hyb, x_hyb), "chunk": (scipy_of(a_chunk), x_chunk),
             "packed": (scipy_of(a_packed), x_packed)}
    for name, (m, x) in ref64.items():
        y = ys[name]
        assert y.shape == (m.shape[0],) and bool(torch.isfinite(y).all())
        want = m.astype(np.float64) @ x.astype(np.float64)
        err = rel_err(y, want)
        log(f"[{name}] y vs float64 scipy: rel err {err:.3g} "
            f"(limit {Y_RTOL:g})")
        assert err < Y_RTOL, (name, err)

    # --- each kernel against its plain version, at the main path's shapes ---
    def window_args(plan):
        st = plan.stats
        ng = TILES_PER_STEP * st.groups_per_step // st.group_tiles
        return dict(group_tiles=st.group_tiles,
                    window_grain=st.window_grain,
                    fold=st.group_fold and ng % 8 == 0,
                    semiring="plus_times")

    def dia_pair(plan, x):
        args = (plan.vals, plan.offsets, x, plan.shape[0])
        return (lambda: spmv_dia_kernel(*args),
                lambda: spmv_dia_plain(*args))

    def sell_pair(plan, x):
        args = (plan.vals, plan.cols_win, plan.window_base, x)
        kw = window_args(plan)
        return (lambda: sell_window_kernel(*args, **kw),
                lambda: sell_window_plain(*args, **kw))

    def subwin_pair(h, x):
        args = (h.vals, h.cols_win, h.bases, x)
        return (lambda: subwin_kernel(*args, semiring="plus_times"),
                lambda: subwin_plain(*args, semiring="plus_times"))

    # kernel C at the chunk phase's shape: (light blocks, 128) sums
    y2d = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (p_chunk.num_blocks, 128)).astype(np.float32)).to(dev)
    lane_args = (y2d, p_chunk.perm_idx)
    pst = p_packed.stats
    x_pk = ops["packed"][1]
    scan_args = (p_packed.vals, p_packed.cols, p_packed.cstep, x_pk)
    scan_kw = dict(chunk_blocks=pst.chunk_blocks, step_tiles=pst.step_tiles)
    # kernel F reads the plain scan, so both versions see the same input
    ext_args = (packed_scan_plain(*scan_args, **scan_kw), p_packed.sblock,
                p_packed.wstep, p_packed.esrc)
    ext_kw = dict(num_windows=pst.num_windows, step_tiles=pst.step_tiles)

    # (kernel, phase, what, (kernel call, plain call)); a kernel's JSON row
    # sums its calls in its headline phase
    cases = [("spmv_dia_f32", "dia", "", dia_pair(p_dia, ops["dia"][1])),
             ("spmv_sell_window_f32", "sell", "",
              sell_pair(p_sell, ops["sell"][1])),
             ("spmv_dia_f32", "hybrid", "", dia_pair(p_hyb.dia,
                                                     ops["hybrid"][1])),
             ("spmv_sell_window_f32", "hybrid", "",
              sell_pair(p_hyb.rest, ops["hybrid"][1]))]
    cases += [("spmv_sell_window_f32", "chunk", f" K={b.stats.window_blocks}",
               sell_pair(b, ops["chunk"][1])) for b in p_chunk.buckets]
    cases += [("spmv_subwin_f32", "chunk", f" W={h.window_blocks}",
               subwin_pair(h, ops["chunk"][1])) for h in p_chunk.hbuckets]
    cases += [("lane_unpermute_f32", "chunk", "",
               (lambda: lane_unpermute(*lane_args),
                lambda: lane_unpermute_plain(*lane_args))),
              ("packed_scan_f32", "packed", "",
               (lambda: packed_scan_kernel(*scan_args, **scan_kw),
                lambda: packed_scan_plain(*scan_args, **scan_kw))),
              ("packed_extract_f32", "packed", "",
               (lambda: packed_extract_kernel(*ext_args, **ext_kw),
                lambda: packed_extract_plain(*ext_args, **ext_kw)))]
    headline = {"spmv_dia_f32": "dia", "spmv_sell_window_f32": "sell",
                "lane_unpermute_f32": "chunk", "spmv_subwin_f32": "chunk",
                "packed_scan_f32": "packed", "packed_extract_f32": "packed"}
    rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0) for k in kernels}
    for kname, phase, what, (kern, plain) in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs(got, ref)
        tol = KERNEL_RTOL * max(1.0, float(ref.abs().max().item()))
        log(f"[{phase}] {kname}{what} vs plain: max abs err {err:.3g} "
            f"(limit {tol:.3g}), shape {tuple(got.shape)}")
        assert got.shape == ref.shape and err <= tol, (kname, phase, err)
        rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], err)
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        log(f"[{phase}] {kname}{what}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms on {card}")
        if phase == headline[kname]:
            rows[kname]["ms"] += min(k1, k2)
            rows[kname]["plain_ms"] += min(p1, p2)

    # --- the apply, end to end ----------------------------------------------
    for name, (op, x) in ops.items():
        ms = time_ms(lambda: op @ x)
        nnz = plan_nnz(op.plan)
        log(f"[{name}] apply: {ms:.4f} ms -> {nnz / ms / 1e6:.2f} Gnnz/s "
            f"(nnz={nnz}) on {card}")
        by_kernel = device_us_by_kernel(lambda: op @ x)
        if not by_kernel:
            log(f"[{name}] device time by kernel: not measured (the "
                f"profiler saw no device activity)")
            continue
        busy = sum(by_kernel.values())
        log(f"[{name}] device busy {busy:.2f} us of a {ms * 1e3:.2f} us "
            f"apply -> idle share {1 - busy / (ms * 1e3):.3f}")
        for k, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
            log(f"[{name}]   {us:9.2f} us  {k[:90]}")
    for kname in ("spmv_dia_f32", "spmv_sell_window_f32"):
        r = rows[kname]
        nnz = plan_nnz(p_dia if kname == "spmv_dia_f32" else p_sell)
        log(f"{kname}: kernel {nnz / r['ms'] / 1e6:.2f} Gnnz/s, plain "
            f"{nnz / r['plain_ms'] / 1e6:.2f} Gnnz/s on {card}")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} bytes")

    csrc = "spmv_vector_cache_tpu_torch/csrc/"
    meta = {
        "spmv_dia_f32": ("spmv_dia.cu", "spmv_vector_cache_tpu/ops/"
                         "spmv_dia.py:63"),
        "spmv_sell_window_f32": ("spmv_sell_window.cu",
                                 "spmv_vector_cache_tpu/ops/"
                                 "spmv_pallas.py:162"),
        "lane_unpermute_f32": ("lane_perm.cu", "spmv_vector_cache_tpu/ops/"
                               "lane_perm.py:26"),
        "spmv_subwin_f32": ("spmv_subwin.cu", "spmv_vector_cache_tpu/ops/"
                            "spmv_pallas.py:282"),
        "packed_scan_f32": ("spmv_packed.cu", "spmv_vector_cache_tpu/ops/"
                            "spmv_packed.py:44"),
        "packed_extract_f32": ("spmv_packed.cu", "spmv_vector_cache_tpu/ops/"
                               "spmv_packed.py:91"),
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": csrc + meta[k][0],
         "replaces": meta[k][1], "launches": launches[k], **r}
        for k, r in rows.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
