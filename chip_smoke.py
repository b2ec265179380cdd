#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU, at full size.

    python3 chip_smoke.py

Builds the CUDA kernels of ``spmv_vector_cache_tpu_torch/csrc/`` and
runs ``SparseOperator.from_matrix(a) @ x`` (the plan placed on the card
by default) on seven matrices, one per plan type of the main path, then
the multi-RHS product ``op @ B`` (SpMM) on four of them, then the
double-precision SpMV ``from_matrix(a, value_dtype=np.float64) @ x`` on
four, then the stream checksum, the sharded SpMV and SpMM, and the
roofline audit:

1. DIA — bench.py's headline matrix: 2^20 rows, 27 diagonals (-13..13),
   standard-normal values, seed 0 (~28.3M nonzeros);
2. SELL window — bench.py's shuffled band: 2^19 rows, 27 nonzeros per
   row at random columns inside the row's 128-column block;
3. Hybrid — the headline band plus ~2 nonzeros per row at random
   columns within +-512 of the diagonal;
4. Chunk — ``tools/realistic.scircuit_like()``: 170,998^2, 926,915
   nonzeros, power-law rows with 24 dense rail rows (a ChunkPlan whose
   light buckets' real slots placement lists by lane row for the chunk
   light route, and whose heavy subwindow buckets it gathers into kernel
   D's slab);
5. Packed — ``tools/realistic.mac_econ_like()``: 206,500^2, 1,316,368
   nonzeros, short rows spread +-12,000 columns (a PackedPlan);
6. Cached — the zipf-column matrix of the reference's report
   (``tools/report.py``, webbase-class popularity): 2^18 rows, 64
   nonzeros per row at columns drawn with weight (rank + 10)^-2.5 and
   permuted, seed 3 (a CachedPlan: a 256-column window tier, then a
   full-cover resident tier);
7. Deep — the report's uniform-random matrix: 2^18 rows, 16 nonzeros per
   row at uniform columns, |N(0, 1)| values and x, seed 3, under
   ``semiring="min_plus"`` (one Bellman-Ford relaxation; a windowless
   SellPlan on the 'deep' strategy), then the same plan on the 'stream'
   strategy, which must give the same y exactly; then the same draw over
   2^19 columns, past the reference's deep cap of 2048 blocks, where the
   planner picks 'stream' itself (with its RuntimeWarning);
8. SpMM, ``op @ B`` with B of shape (cols, 16), N(0, 1) from a seeded
   generator: ``spmm_dia`` (the DIA operator of phase 1, kernel I),
   ``spmm_sell`` (phase 2's window plan, kernel H), ``spmm_hybrid``
   (phase 3's, kernels I and H) and ``spmm_packed`` (phase 5's
   PackedPlan, which has no fused kernel: the reference SpMM runs on the
   card and neither H nor I launches).  Then fused SpMM against k
   looped SpMVs and against ``torch.sparse.mm`` at k = 8, 32 and 64 on
   the DIA and shuffled-band matrices;
9. float64, the same seeded draws kept in float64 and a float64 x:
   ``dia_f64`` (the DIA headline: a double DiaPlan, kernel J),
   ``sell_f64`` (the shuffled band: a double window SellPlan, kernel K),
   ``hybrid_f64`` (the Hybrid: kernels J and K) and ``deep_f64`` (the
   uniform matrix under plus_times: a windowless double SellPlan on the
   'deep' strategy, kernel L writing y's rows); then the pair API (``spmv_dia_df``,
   ``spmv_sell_double_pair``) on the first two;
10. ``stream_checksum``: kernel N's per-block sums of a 256 MiB float32
    ramp of (8, 128) tiles, 64 tiles (256 KiB) per checksum, against
    their closed form; then ``measure_stream_bandwidth`` read (kernel N)
    and readwrite, the measured bandwidth every bound is also given at,
    beside ``torch.sum``'s rate on a buffer of the same size;
11. the sharded paths, on ``make_mesh(4, device="cuda")``: four shards on
    one card: ``sharded_dia`` (the DIA headline as
    ``build_sharded_dia_plan(a, 4)``, halo 128, kernel M four times; y
    equal to phase 1's kernel-A y bit for bit), ``sharded_sell`` and
    ``sharded_sell_ag`` (the shuffled band as ``build_sharded_plan(a,
    4)``, halo and all_gather exchange, kernel B four times each; 'auto'
    picks halo) and ``sharded_spmm`` (the same plan ``@ B``, k = 16,
    kernel H four times, each shard's rows of Y written by H itself);
12. ``marginal``: ``roofline.time_marginal`` of a chain of DIA applies
    beside the CUDA-event time of one; ``audit``:
    ``SparseOperator.audit`` of the DIA and shuffled-band operators at
    the measured read bandwidth (a roofline fraction above 1.05 fails);
13. the solver layer (``solver_phases``), each phase against float64 on
    the host: ``cg`` (the flagship: ``__graft_entry__``'s banded SPD
    system at 2^20 rows, a DiaPlan on kernel A, one ``cg_step`` against
    a float64 numpy step, then ``cg`` to 1e-6), ``cg_fem``
    (``realistic.cant_like()`` made SPD, ``cg`` on the plan the planner
    picks), ``pcg_ilu0`` (ILU(0) of an SPD band at 2^15 rows on the
    host, its L and U swept on the card as the preconditioner, against
    plain CG), ``trisolve`` (``tools/suite.py``'s lower band at 2^15
    rows), ``spgemm`` (the suite's A @ A at 2^14 rows, symbolic on the
    host, numeric on the card, and again with new values) and ``gcn``
    (ogbn-arxiv's widths on a synthetic graph: forward, cross entropy and
    ``backward()`` over ``reference.spmm``, then the forward over
    ``op.matmat`` under ``torch.no_grad()``).  Each prints its CUDA
    event time, device busy time and idle share by the profiler,
    launches per call, bound and the library call beside it
    (``torch.sparse.mm``, or ``torch.triangular_solve`` of the CSR
    factors); the kernel launches of each counted run add to the
    kernels' JSON line.

Each phase checks y against a float64 host reference (scipy, or a
min-plus reduce over the CSR rows; relative error below 1e-4, bench.py's
gate, and below 1e-11 in the float64 phases), checks the plan the
planner picked, and checks that its run of the main path launched the
phase's kernels (their launch counters, set to 0 just before the phase's
apply and read just after; the chunk, SpMM and float64 phases must
launch exactly their kernels, the light route, kernel C and kernel D
once each in the chunk phase, and no other).  Each kernel is then
compared with its plain PyTorch version on the same inputs on the card,
and both are timed with CUDA events beside the kernel's bound: the bytes
it must move at 3.35 TB/s (and at the measured read bandwidth) or its
operations at 67 TFLOP/s (float32) or 34 TFLOP/s (float64), whichever
takes longer (kernel H also on each shard of ``sharded_spmm``; kernel
C through the public wrapper beside ``torch.gather``, both allocating,
and by the apply's in-place call beside ``torch.gather`` into a
buffer).  ``host_cost`` then times each piece of kernel C's launch path
by the host clock.  One PyTorch call of the same function is timed
beside kernels A, B, H, I, J, K, L and N, beside G on the cached tier 2
(``torch.sparse.mm`` of the tier's matrix over ``x[hot_cols]``), beside
D (``torch.sparse.mm`` of the heavy rows' CSR, the slab's nonzeros),
beside the chunk light route (the light records as a CSR over the lane
rows), beside the packed apply (the matrix's CSR) and beside M (each
shard's rows over its halo'd x), each checked against the float64
reference; the library calls beside A, B, D, G, J, K, L, the light route
and the packed apply, and the light route itself, also by the
profiler's device time.  The profiler's
by-kernel lists of ``spmm_sell``, ``spmm_hybrid`` and ``sharded_spmm``
must hold kernel H and no ``index_add_``, those of ``deep``, ``stream``
and ``wide`` kernel G and no ``scatter_reduce`` nor ``index_add_``, that
of ``deep_f64`` kernel L alone, that of ``packed`` kernels E and F
alone, once each, and that of ``chunk`` one launch each of the light
route and kernel D and one ``index_add_``, the heavy merge's: none of
the light buckets.  Every
check raises; nothing is caught.  Needs one CUDA device; exits non-zero
without one.

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
#: the float64 kernels against their plain versions: float64 sums of the
#: same products in another order
KERNEL_RTOL_F64 = 1e-13
#: y vs float64 scipy, bench.py's correctness gate
Y_RTOL = 1e-4
#: the float64 phases' y vs float64 scipy: the reference's df64 gate
Y_RTOL_F64 = 1e-11
#: the pair API's (yh, yl) joined vs the float64 apply's y: the low word
#: rounds to float32, which leaves 2^-48 of |y| (4e-15 bounds it)
PAIR_RTOL = 4e-15
#: the H100 SXM's published peaks (NVIDIA data sheet): device memory
#: bytes/s, and float32 and float64 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12


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
    """(device microseconds, launches) per call of ``fn``, by kernel
    name, from a torch.profiler trace of ``iters`` calls (empty if the
    profiler saw no device activity).  The time is per recorded launch
    times the launches a call makes: a profiler session that follows
    another in the process may leave the first launch unrecorded (19
    of 20), which would otherwise read as a 5 % shorter kernel."""
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
            per_call = round(ev.count / iters) or ev.count / iters
            out[ev.key] = (us / ev.count * per_call, per_call)
    return out


def rel_err(y, want):
    y = y.detach().cpu().numpy().astype(np.float64)
    return float(np.abs(y - want).max() / max(1.0, np.abs(want).max()))


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max().item())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def x_bytes_read(x, cols):
    """Bytes of x (or of the rows of a row-major B) that a gather at
    column ids ``cols`` must read: each distinct in-range column once
    (out of range reads 0, no memory)."""
    c = cols.reshape(-1)
    c = c[(c >= 0) & (c < x.shape[0])]
    return int(torch.unique(c).numel()) * x.stride(0) * x.element_size()


def packed_extract_bytes(plan, tables, x):
    """Bytes kernel F must move on a placed PackedPlan, by part: ``esrc``
    over the rows of each visit's window that y has (2 B each: the last
    window is partial), the S entries those rows pick, y, and sblock, the
    tables, the overflow triples and the x they read."""
    window = plan.esrc.shape[1] * plan.esrc.shape[2]
    in_y = (plan.shape[0] - plan.wstep.long() * window).clamp(max=window)
    lanes = torch.arange(window, device=in_y.device)
    picked = int(((plan.esrc.reshape(-1, window) >= 0)
                  & (lanes[None, :] < in_y[:, None])).sum().item())
    rest = (nbytes(plan.sblock, tables.woff, tables.ov_off, tables.ov_lane,
                   tables.ov_cols, tables.ov_vals)
            + x_bytes_read(x, tables.ov_cols))
    return {"esrc": 2 * int(in_y.sum().item()), "picked S entries":
            picked * 4, "y": plan.shape[0] * 4,
            "sblock, the tables and the overflow with its x": rest}


def zipf_cols_matrix(rng, n=1 << 18, per_row=64, s=2.5):
    """The reference report's zipf-column recipe (tools/report.py)."""
    from spmv_vector_cache_tpu_torch.formats.containers import COO
    from spmv_vector_cache_tpu_torch.formats.convert import coo_to_csr

    rz = np.repeat(np.arange(n, dtype=np.int64), per_row)
    wz = (np.arange(n, dtype=np.float64) + 10.0) ** -s
    wz /= wz.sum()
    cz = rng.choice(n, size=rz.shape[0], p=wz).astype(np.int32)
    cz = rng.permutation(n).astype(np.int32)[cz]
    return coo_to_csr(COO(data=rng.standard_normal(rz.shape[0]).astype(
        np.float32), row=rz.astype(np.int32), col=cz, shape=(n, n)))


def uniform_matrix(rng, n=1 << 18, per_row=16, cols=None,
                   dtype=np.float32):
    """The reference report's uniform-random recipe, |N(0, 1)| values,
    over ``cols`` columns (default n)."""
    from spmv_vector_cache_tpu_torch.formats.containers import COO
    from spmv_vector_cache_tpu_torch.formats.convert import coo_to_csr

    ru = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = cols or n
    cu = rng.integers(0, cols, ru.shape[0]).astype(np.int32)
    return coo_to_csr(COO(data=np.abs(rng.standard_normal(
        ru.shape[0])).astype(dtype), row=ru.astype(np.int32), col=cu,
        shape=(n, cols)))


def min_plus_host(a, x):
    """float64 min-plus y over CSR rows (every row non-empty)."""
    indptr = np.asarray(a.indptr, dtype=np.int64)
    assert (np.diff(indptr) > 0).all()
    prod = np.asarray(a.data, np.float64) + x.astype(np.float64)[
        np.asarray(a.indices)]
    return np.minimum.reduceat(prod, indptr[:-1])


def plan_csr(plan):
    """The matrix a float32 SellPlan stores, as a scipy CSR: each slot
    with a nonzero value at (the original row of its sub-row, its
    column)."""
    import scipy.sparse as sp

    R = plan.lane_rows
    rows = plan.row_map.long().cpu().reshape(-1, R)[
        plan.tile_slice.long().cpu()][:, None, :].expand(plan.vals.shape)
    v, c = plan.vals.cpu(), plan.cols.cpu()
    keep = (v != 0) & (rows < plan.shape[0])
    return sp.csr_matrix((v[keep].numpy(), (rows[keep].numpy(),
                                             c[keep].long().numpy())),
                         shape=plan.shape)


def host_cost(y2d, idx, img, gidx, card, n=10_000):
    """Host microseconds per call of each piece of kernel C's launch path
    (``ops/lane_perm.py``, ``ops/_kernels.py``), ``n`` calls each by the
    host clock with no launch in between, then of the whole wrappers and
    of ``torch.gather`` (the calls launch; the card keeps up)."""
    from spmv_vector_cache_tpu_torch.ops import _kernels, lane_perm

    dev = y2d.device
    fn = _kernels.library().lane_unpermute_f32
    out, work, buf = torch.empty_like(y2d), y2d.clone(), torch.empty_like(img)
    ptrs = (y2d.data_ptr(), idx.data_ptr(), out.data_ptr())
    stream = _kernels.current_stream(dev.index)
    pieces = {
        "_check (the public wrapper's checks)":
            lambda: lane_perm._check(y2d, idx),
        "torch.empty_like": lambda: torch.empty_like(y2d),
        "stream: torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream: _kernels.current_stream (raw handle)":
            lambda: _kernels.current_stream(dev.index),
        "library lookup: _kernels.library().lane_unpermute_f32":
            lambda: _kernels.library().lane_unpermute_f32,
        "ctypes call of a no-op (n = 0)": lambda: fn(*ptrs, 0, stream),
        "data_ptr()": lambda: y2d.data_ptr(),
        "get_device()": lambda: y2d.get_device(),
        "t.device.type == 'cuda' (a torch.device object a call)":
            lambda: y2d.device.type == "cuda",
        "t.is_cuda": lambda: y2d.is_cuda,
    }
    whole = {
        "lane_unpermute (public, with launch)":
            lambda: lane_perm.lane_unpermute(y2d, idx),
        "unpermute_plan_rows (the apply's, in place, with launch)":
            lambda: lane_perm.unpermute_plan_rows(work, idx),
        "torch.gather (one ATen dispatch)":
            lambda: torch.gather(img, 1, gidx),
        "torch.gather(out=) into a buffer":
            lambda: torch.gather(img, 1, gidx, out=buf),
    }
    for group, calls in (("piece", pieces), ("whole", whole)):
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()
            log(f"[host_cost] {group}: {name}: {dt / n * 1e6:.3f} us per "
                f"call ({n} calls, host clock) on {card}")


# ---------------------------------------------------------------------------
# the solver layer: CG, the ILU(0)-preconditioned CG with its triangular
# sweeps, SpGEMM and a GCN, each against a float64 host computation
# ---------------------------------------------------------------------------

def banded_system(n, band=3, dtype=np.float32):
    """``__graft_entry__._banded_system``'s SPD banded matrix (scipy CSR):
    diagonally dominant, ``default_rng(0)``."""
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    diags = [rng.standard_normal(n).astype(dtype) * 0.1
             for _ in range(2 * band + 1)]
    m = sp.spdiags(np.stack(diags), list(range(-band, band + 1)), n, n)
    m = (m + m.T + sp.eye(n) * (2 * band + 2)).tocsr()
    m.sort_indices()
    return m.astype(dtype)


def spd_banded(rng, n, band=3):
    """``tests/test_spgemm_sptrsv.py``'s ``_spd_banded`` (float64)."""
    import scipy.sparse as sp

    m = sp.spdiags(rng.standard_normal((2 * band + 1, n)),
                   list(range(-band, band + 1)), n, n).tocsr()
    m = ((m + m.T) * 0.1 + sp.eye(n) * (2 * band + 2)).tocsr()
    m.sort_indices()
    return m


def fem_spd(a):
    """S = A + A^T of a container, its diagonal set to each row's sum of
    absolute off-diagonal values plus 1: strictly diagonally dominant
    and symmetric, so SPD (float64 scipy CSR)."""
    import scipy.sparse as sp

    m = sp.csr_matrix((a.data.astype(np.float64), a.indices, a.indptr),
                      shape=a.shape)
    s = (m + m.T).tocsr()
    s.setdiag(0)
    s.eliminate_zeros()
    d = np.asarray(abs(s).sum(axis=1)).ravel() + 1.0
    s = (s + sp.diags(d)).tocsr()
    s.sort_indices()
    return s


def arxiv_like(seed=7, nodes=169_343, edges=1_166_243):
    """A seeded graph with ogbn-arxiv's published node and edge counts
    (Hu et al., OGB 2020): ``edges`` distinct directed pairs without
    self loops at uniform endpoints, symmetrised to a 0/1 adjacency."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    src = rng.integers(0, nodes, int(edges * 1.05))
    dst = rng.integers(0, nodes, src.shape[0])
    keep = src != dst
    key = rng.permutation(np.unique(src[keep] * nodes + dst[keep]))[:edges]
    assert key.shape[0] == edges
    s, d = key // nodes, key % nodes
    adj = sp.csr_matrix((np.ones(2 * edges, np.float32),
                         (np.concatenate([s, d]), np.concatenate([d, s]))),
                        shape=(nodes, nodes))
    adj.data[:] = 1.0             # an edge and its reverse drawn both: 1
    adj.sort_indices()
    return adj


def csr_tensor(m, dev, dtype=np.float32):
    """A scipy CSR as a torch CSR tensor on ``dev`` (for the library
    calls timed beside a phase; the port never calls them)."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(m.indptr.astype(np.int64)).to(dev),
        torch.from_numpy(m.indices.astype(np.int64)).to(dev),
        torch.from_numpy(m.data.astype(dtype)).to(dev), size=m.shape)


def vec_rel(got, want):
    """max |got - want| / max |want| (float64 host)."""
    got = got.detach().cpu().numpy().astype(np.float64) \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def solver_phases(card, dev, kernels, launches, bw_read):
    """The phases of the solver layer (``cg``, ``cg_fem``, ``pcg_ilu0``,
    ``trisolve``, ``spgemm``, ``gcn``).  Each checks its result against a
    float64 host computation and prints, for each timed call, its CUDA
    event time (median of 30 after warm-ups), its device busy time and
    idle share by the profiler, its launches per call, its bound in bytes
    and microseconds at 3.35 TB/s and at the measured read bandwidth, and
    the library call's time where there is one.  The launches of the
    operator's kernels in each phase's counted run add to ``launches``."""
    import scipy.sparse as sp

    from spmv_vector_cache_tpu_torch.formats.convert import from_scipy
    from spmv_vector_cache_tpu_torch.formats.dia import DiaPlan
    from spmv_vector_cache_tpu_torch.formats.plan import place
    from spmv_vector_cache_tpu_torch.models import gnn, solvers
    from spmv_vector_cache_tpu_torch.ops import reference, spgemm, sptrsv
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
    from spmv_vector_cache_tpu_torch.tools import realistic

    # full float32 products in every matmul (no TF32), as on the host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def counted(name, run):
        """One run of a phase's main path, its kernel launches counted
        (set to 0 just before, read just after)."""
        for k in kernels.values():
            k.launches = 0
        out = run()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in kernels.items() if w.launches}
        log(f"[{name}] main-path launches: {counts}")
        for k, c in counts.items():
            launches[k] += c
        return out, counts

    def measure(phase, what, fn, nbyte, library=None, nops=0):
        """Event time, profiler busy time and idle share, launches per
        call, bound (the larger of ``nbyte`` at the memory rate and
        ``nops`` float32 operations at 67 TFLOP/s), and (name, call) of a
        library call timed beside."""
        ev_ms = time_ms(fn)
        by_kernel = device_us_by_kernel(fn)
        busy = sum(us for us, _ in by_kernel.values())
        nlaunch = sum(n for _, n in by_kernel.values())
        idle = 1.0 - busy / (ev_ms * 1e3)
        ops_us = nops / PEAK_F32_PER_S * 1e6
        bound_us = max(nbyte / PEAK_BYTES_PER_S * 1e6, ops_us)
        log(f"[{phase}] {what}: events {ev_ms * 1e3:.2f} us (median of "
            f"30), device busy {busy:.2f} us, idle share {idle:.4f}, "
            f"{nlaunch} launches per call; bound {bound_us:.2f} us: "
            f"{nbyte} bytes = {nbyte / PEAK_BYTES_PER_S * 1e6:.2f} us at "
            f"{PEAK_BYTES_PER_S / 1e12:g} TB/s, "
            f"{nbyte / bw_read * 1e6:.2f} us at the measured "
            f"{bw_read / 1e12:.4f} TB/s; {nops} operations = "
            f"{ops_us:.2f} us at 67 TFLOP/s; on {card}")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        log(f"[{phase}] {what}: device time by kernel (us, launches): "
            + "; ".join(f"{k[:60]} {us:.2f} x{n}" for k, (us, n) in top))
        out = dict(ev_us=ev_ms * 1e3, busy_us=busy, idle=idle,
                   launches=nlaunch, bound_us=bound_us)
        if library is not None:
            lname, lcall = library
            lib_ms = time_ms(lcall)
            lib_busy = sum(us for us, _ in
                           device_us_by_kernel(lcall).values())
            log(f"[{phase}] beside it, {lname}: events "
                f"{lib_ms * 1e3:.2f} us (median of 30), device busy "
                f"{lib_busy:.2f} us; on {card}")
            out["library_us"] = lib_ms * 1e3
        return out

    f4 = 4

    # --- cg: the flagship, __graft_entry__.entry()'s step at n = 2^20 ------
    n = 1 << 20
    m = banded_system(n)
    m64 = m.astype(np.float64)
    op = SparseOperator.from_matrix(from_scipy(m), device=dev)
    assert isinstance(op.plan, DiaPlan) and op.strategy == "dia", op
    assert len(op.plan.offsets) == 7, op.plan.offsets
    b_np = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    b = torch.from_numpy(b_np).to(dev)
    state = (torch.zeros_like(b), b, b, torch.vdot(b, b))
    step, counts = counted("cg", lambda: solvers.cg_step(op.matvec, state))
    assert counts == {"spmv_dia_f32": 1}, counts
    # the step from the same state in float64 on the host
    b64 = b_np.astype(np.float64)
    ap = m64 @ b64
    alpha = (b64 @ b64) / (b64 @ ap)
    r1 = b64 - alpha * ap
    rz1 = r1 @ r1
    want = (alpha * b64, r1, r1 + (rz1 / (b64 @ b64)) * b64, rz1)
    errs = [vec_rel(g, w) for g, w in zip(step, want)]
    log(f"[cg] cg_step vs float64 numpy step (x, r, p, rz): rel err "
        f"{', '.join(f'{e:.3g}' for e in errs)} (limit 1e-05)")
    assert all(e <= 1e-5 for e in errs), errs
    res, counts = counted("cg", lambda: solvers.cg(op.matvec, b, tol=1e-6,
                                                   maxiter=100))
    k = res.iterations
    assert counts == {"spmv_dia_f32": k + 1}, (k, counts)
    resid = np.linalg.norm(b64 - m64 @ res.x.cpu().numpy().astype(
        np.float64)) / np.linalg.norm(b64)
    log(f"[cg] cg(op.matvec, b, tol=1e-6, maxiter=100): {k} iterations, "
        f"float64 residual |b - A x| / |b| = {resid:.3g} (limit 1e-05)")
    assert 0 < k < 100 and resid <= 1e-5, (k, resid)
    vals = nbytes(op.plan.vals)
    # the step's bytes: the DIA values once, and 14 vector passes: the
    # matvec reads p and writes Ap (2), <p, Ap> (2), x + a p (3),
    # r - a Ap (3), <r, r> (1), r + b p (3)
    step_bytes = vals + 14 * n * f4
    a_csr = csr_tensor(m, dev)
    p_col = b.reshape(-1, 1)
    lib = ("torch.sparse.mm (CSR) of the SpMV alone", lambda:
           torch.sparse.mm(a_csr, p_col))
    measure("cg", f"cg_step (kernel A: {vals} bytes of DIA values, 14 "
            f"vector passes of {n * f4} bytes)",
            lambda: solvers.cg_step(op.matvec, state), step_bytes,
            library=lib)
    measure("cg", "one SpMV, op.matvec (kernel A alone)",
            lambda: op.matvec(b), vals + 2 * n * f4)
    # the solve: one matvec and 5 vector passes to start, then per
    # iteration the step's bytes and the condition's <r, r> (1 pass)
    measure("cg", f"cg to 1e-6 ({k} iterations, one host sync each)",
            lambda: solvers.cg(op.matvec, b, tol=1e-6, maxiter=100),
            (k + 1) * vals + (5 + 15 * k) * n * f4)
    del op, a_csr, state, step, res
    torch.cuda.empty_cache()

    # --- cg_fem: the cant-like FEM matrix made SPD -------------------------
    t0 = time.perf_counter()
    s64 = fem_spd(realistic.cant_like())
    s32 = s64.astype(np.float32)
    op = SparseOperator.from_matrix(from_scipy(s32), device=dev)
    t_plan = time.perf_counter() - t0
    nf = s32.shape[0]
    log(f"[cg_fem] S = A + A^T of cant_like, strictly diagonally dominant: "
        f"{s32.shape}, {s32.nnz} nonzeros; {op!r}; built and planned in "
        f"{t_plan:.3f} s")
    bf_np = np.random.default_rng(1).standard_normal(nf).astype(np.float32)
    bf = torch.from_numpy(bf_np).to(dev)
    res, counts = counted("cg_fem", lambda: solvers.cg(op.matvec, bf,
                                                       tol=1e-6, maxiter=100))
    k = res.iterations
    assert counts and all(c % (k + 1) == 0 for c in counts.values()), counts
    bf64 = bf_np.astype(np.float64)
    resid = np.linalg.norm(bf64 - s64 @ res.x.cpu().numpy().astype(
        np.float64)) / np.linalg.norm(bf64)
    log(f"[cg_fem] cg to 1e-6: {k} iterations, float64 residual "
        f"{resid:.3g} (limit 1e-05); the plan's kernels "
        f"{sorted(counts)} per apply "
        f"{ {c: n // (k + 1) for c, n in counts.items()} }")
    assert 0 < k < 100 and resid <= 1e-5, (k, resid)
    # the least an SpMV must move: the matrix as CSR (a value and a
    # column a nonzero, the row pointers), x and y; the plan's own byte
    # model (its padded tiles) is printed beside
    spmv_bytes = s32.nnz * 8 + (nf + 1) * f4 + 2 * nf * f4
    log(f"[cg_fem] an SpMV's bound counts {spmv_bytes} bytes (CSR, x, y); "
        f"the plan's bytes_per_apply is {op.stats['bytes_per_apply']}")
    measure("cg_fem", f"cg to 1e-6 ({k} iterations)",
            lambda: solvers.cg(op.matvec, bf, tol=1e-6, maxiter=100),
            (k + 1) * spmv_bytes + (5 + 15 * k) * nf * f4)
    a_csr = csr_tensor(s32, dev)
    measure("cg_fem", "one SpMV, op.matvec", lambda: op.matvec(bf),
            spmv_bytes, library=("torch.sparse.mm (CSR)", lambda:
                                 torch.sparse.mm(a_csr, bf.reshape(-1, 1))))
    del op, a_csr, res
    torch.cuda.empty_cache()

    # --- pcg_ilu0: ILU(0) of the SPD band, L and U swept on the card -------
    nb_ = 1 << 15
    rng = np.random.default_rng(0)
    a64 = spd_banded(rng, nb_)
    bp_np = rng.standard_normal(nb_).astype(np.float32)
    a32 = a64.astype(np.float32)
    t0 = time.perf_counter()
    L, U = sptrsv.ilu0(from_scipy(a64))
    t_ilu = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp = place(sptrsv.build_trisolve_plan(L, lower=True, unit_diag=True),
               dev)
    up = place(sptrsv.build_trisolve_plan(U, lower=False), dev)
    t_tri = time.perf_counter() - t0
    op = SparseOperator.from_matrix(from_scipy(a32), device=dev)
    assert isinstance(op.plan, DiaPlan), op
    log(f"[pcg_ilu0] n = {nb_}, band 3: ilu0 on the host {t_ilu:.3f} s, "
        f"the two TriSolvePlans built and placed {t_tri:.3f} s ("
        f"{lp.num_blocks} blocks, W = {lp.width} and {up.width}); {op!r}")
    bp = torch.from_numpy(bp_np).to(dev)

    def M(r):
        return sptrsv.trisolve(up, sptrsv.trisolve(lp, r))

    plain, _ = counted("pcg_ilu0", lambda: solvers.cg(
        op.matvec, bp, tol=1e-6, maxiter=400))
    pc, counts = counted("pcg_ilu0", lambda: solvers.cg(
        op.matvec, bp, tol=1e-6, maxiter=400, M=M))
    assert counts == {"spmv_dia_f32": pc.iterations + 1}, counts
    bp64 = bp_np.astype(np.float64)
    resid = np.linalg.norm(bp64 - a64 @ pc.x.cpu().numpy().astype(
        np.float64)) / np.linalg.norm(bp64)
    log(f"[pcg_ilu0] plain cg {plain.iterations} iterations, ILU(0)-"
        f"preconditioned {pc.iterations}; float64 residual {resid:.3g} "
        f"(limit 1e-04)")
    assert pc.iterations < plain.iterations and resid <= 1e-4, \
        (plain.iterations, pc.iterations, resid)
    tri_bytes = (nbytes(lp.diag_blocks, lp.off_blocks)
                 + nbytes(up.diag_blocks, up.off_blocks))
    # the library pair: two sparse triangular solves of the CSR factors
    l_csr = sp.csr_matrix((L.data, L.indices, L.indptr), shape=L.shape)
    u_csr = sp.csr_matrix((U.data, U.indices, U.indptr), shape=U.shape)
    l_t, u_t = csr_tensor(l_csr, dev), csr_tensor(u_csr, dev)
    r_col = bp.reshape(-1, 1)

    def lib_m():
        y = torch.triangular_solve(r_col, l_t, upper=False,
                                   unitriangular=True).solution
        return torch.triangular_solve(y, u_t, upper=True).solution

    err = vec_rel(lib_m().reshape(-1), M(bp).double().cpu().numpy())
    log(f"[pcg_ilu0] M(r) vs torch.triangular_solve over the CSR factors: "
        f"rel err {err:.3g} (limit 1e-04)")
    assert err <= 1e-4, err
    measure("pcg_ilu0", f"M(r) = U^-1 L^-1 r (two sweeps of "
            f"{lp.num_blocks} blocks; {tri_bytes} bytes of blocks)",
            lambda: M(bp), tri_bytes + 4 * nb_ * f4,
            library=("torch.triangular_solve, sparse CSR L then U",
                     lib_m))
    vals = nbytes(op.plan.vals)
    kp = pc.iterations
    measure("pcg_ilu0", f"pcg to 1e-6 ({kp} iterations)",
            lambda: solvers.cg(op.matvec, bp, tol=1e-6, maxiter=400, M=M),
            (kp + 1) * (vals + tri_bytes) + (7 + 17 * kp) * nb_ * f4)
    measure("pcg_ilu0", f"plain cg to 1e-6 ({plain.iterations} iterations)",
            lambda: solvers.cg(op.matvec, bp, tol=1e-6, maxiter=400),
            (plain.iterations + 1) * vals
            + (5 + 15 * plain.iterations) * nb_ * f4)
    del op, lp, up, l_t, u_t
    torch.cuda.empty_cache()

    # --- trisolve: tools/suite.py's lower band at n = 2^15 -----------------
    nt = 1 << 15
    rng = np.random.default_rng(0)
    l6 = sp.spdiags(rng.standard_normal((5, nt)).astype(np.float32),
                    [-4, -3, -2, -1, 0], nt, nt).tocsr()
    l6 = sp.tril((l6 + sp.eye(nt) * 8).tocsr()).tocsr().astype(np.float32)
    l6.sort_indices()
    tplan = place(sptrsv.build_trisolve_plan(from_scipy(l6), lower=True),
                  dev)
    b6_np = rng.standard_normal(nt).astype(np.float32)
    b6 = torch.from_numpy(b6_np).to(dev)
    x6 = sptrsv.trisolve(tplan, b6)
    torch.cuda.synchronize()
    b6_64 = b6_np.astype(np.float64)
    resid = np.linalg.norm(b6_64 - l6.astype(np.float64) @ x6.cpu().numpy(
    ).astype(np.float64)) / np.linalg.norm(b6_64)
    log(f"[trisolve] n = {nt}, {tplan.num_blocks} blocks, W = "
        f"{tplan.width}: float64 residual {resid:.3g} (limit 1e-02, the "
        f"suite's)")
    assert resid <= 1e-2, resid
    t_bytes = nbytes(tplan.diag_blocks, tplan.off_blocks) + 2 * nt * f4
    l6_t = csr_tensor(l6, dev)
    b6_col = b6.reshape(-1, 1)
    err = vec_rel(torch.triangular_solve(b6_col, l6_t, upper=False)
                  .solution.reshape(-1), x6.double().cpu().numpy())
    log(f"[trisolve] torch.triangular_solve (sparse CSR) vs trisolve: rel "
        f"err {err:.3g}")
    r = measure("trisolve", f"trisolve ({tplan.num_blocks}-step dependency "
                f"chain)", lambda: sptrsv.trisolve(tplan, b6), t_bytes,
                library=("torch.triangular_solve, sparse CSR", lambda:
                         torch.triangular_solve(b6_col, l6_t, upper=False)))
    log(f"[trisolve] {r['launches']} launches for a chain of "
        f"{tplan.num_blocks} dependent steps: "
        f"{r['ev_us'] / tplan.num_blocks:.2f} us a step by events")
    del tplan, l6_t
    torch.cuda.empty_cache()

    # --- spgemm: tools/suite.py's A @ A at n = 2^14 ------------------------
    ng = 1 << 14
    m5 = sp.random(ng, ng, density=16 / ng, format="csr",
                   random_state=np.random.RandomState(0),
                   dtype=np.float64).astype(np.float32)
    m5.sort_indices()
    a5 = from_scipy(m5)
    t0 = time.perf_counter()
    host = spgemm.spgemm_symbolic(a5, a5)
    t_sym = time.perf_counter() - t0
    gplan = place(host, dev)
    ad = torch.from_numpy(m5.data).to(dev)
    c_data = spgemm.spgemm_numeric(gplan, ad, ad)
    torch.cuda.synchronize()
    want5 = (m5.astype(np.float64) @ m5.astype(np.float64)).tocsr()
    want5.sort_indices()
    got5 = sp.csr_matrix((c_data.cpu().numpy().astype(np.float64),
                          host.c_indices, host.c_indptr), shape=(ng, ng))
    err = abs(got5 - want5).max() / abs(want5).max()
    log(f"[spgemm] n = {ng}, {m5.nnz} nonzeros: symbolic on the host "
        f"{t_sym:.3f} s, {host.a_src.shape[0]} products into {host.c_nnz} "
        f"nonzeros of C; numeric vs float64 scipy rel err {err:.3g} (limit "
        f"1e-05)")
    assert host.c_nnz == want5.nnz and err <= 1e-5, (host.c_nnz, err)
    # pattern reuse: new values on the same pattern
    a2 = torch.from_numpy((m5.data * 1.5 + 0.25).astype(np.float32)).to(dev)
    m5b = sp.csr_matrix((m5.data * 1.5 + 0.25, m5.indices, m5.indptr),
                        shape=m5.shape).astype(np.float64)
    want_b = (m5b @ m5.astype(np.float64)).tocsr()
    got_b = sp.csr_matrix((spgemm.spgemm_numeric(gplan, a2, ad).cpu().numpy()
                           .astype(np.float64), host.c_indices,
                           host.c_indptr), shape=(ng, ng))
    err = abs(got_b - want_b).max() / abs(want_b).max()
    log(f"[spgemm] pattern reuse with new values of A: rel err {err:.3g}")
    assert err <= 1e-5, err
    g_bytes = (nbytes(gplan.a_src, gplan.b_src, gplan.out_id)
               + host.c_nnz * f4 + 2 * nbytes(ad))
    a5_t = csr_tensor(m5, dev)
    measure("spgemm", f"spgemm_numeric ({host.a_src.shape[0]} products)",
            lambda: spgemm.spgemm_numeric(gplan, ad, ad), g_bytes,
            library=("torch.sparse.mm of two CSR tensors (symbolic and "
                     "numeric together)",
                     lambda: torch.sparse.mm(a5_t, a5_t)))
    # the deterministic segment sum the numeric phase does not take:
    # torch.segment_reduce over the sorted out_id, one segment a CTA
    prods = ad.index_select(0, gplan.a_src) * ad.index_select(0, gplan.b_src)
    bounds = torch.arange(host.c_nnz + 1, device=dev, dtype=torch.int32)
    offsets = torch.searchsorted(gplan.out_id, bounds)

    def seg_sum():
        return torch.segment_reduce(prods, "sum", offsets=offsets,
                                    unsafe=True)

    err = max_abs(seg_sum(), c_data) / float(c_data.abs().max())
    log(f"[spgemm] torch.segment_reduce vs index_add_ sums: rel err "
        f"{err:.3g}")
    assert err <= 1e-6, err
    measure("spgemm", "the segment sum alone as torch.segment_reduce (not "
            "taken: deterministic, one segment a CTA)", seg_sum,
            nbytes(prods, gplan.out_id) + host.c_nnz * f4)
    del gplan, a5_t
    torch.cuda.empty_cache()

    # --- gcn: ogbn-arxiv's widths, 3 layers, hidden 256 --------------------
    t0 = time.perf_counter()
    adj = arxiv_like()
    a_norm = gnn.normalized_adjacency(from_scipy(adj))
    t_graph = time.perf_counter() - t0
    nn_, sizes = adj.shape[0], [128, 256, 256, 40]
    a_dev = place(a_norm, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((nn_, sizes[0]), generator=gen, device=dev)
    labels = torch.randint(0, sizes[-1], (nn_,), generator=gen, device=dev)
    params = gnn.init_gcn_params(gen, sizes, device=dev)
    for w, bias in params:
        w.requires_grad_()
        bias.requires_grad_()
    log(f"[gcn] synthetic ogbn-arxiv: {nn_} nodes, {adj.nnz // 2} edges "
        f"symmetrised, A-hat {a_norm.nnz} nonzeros with self loops; built "
        f"in {t_graph:.3f} s")

    def train_step():
        for w, bias in params:
            w.grad = bias.grad = None
        logits = gnn.gcn_forward(a_dev, x, params)
        loss = torch.nn.functional.cross_entropy(logits, labels)
        loss.backward()
        return logits

    logits, counts = counted("gcn", train_step)
    assert counts == {}, counts        # reference.spmm: no kernel of ours
    grads = [g for w, bias in params for g in (w.grad, bias.grad)]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(float(g.abs().max()) > 0 for g in grads)
    # float64 forward on the host
    an64 = sp.csr_matrix((a_norm.data.astype(np.float64), a_norm.indices,
                          a_norm.indptr), shape=a_norm.shape)
    h = x.double().cpu().numpy()
    for i, (w, bias) in enumerate(params):
        h = an64 @ (h @ w.detach().double().cpu().numpy()) \
            + bias.detach().double().cpu().numpy()
        if i < len(params) - 1:
            h = np.maximum(h, 0.0)
    err = vec_rel(logits, h)
    log(f"[gcn] logits {tuple(logits.shape)} vs float64 host forward: rel "
        f"err {err:.3g} (limit 1e-04); gradients finite and non-zero")
    assert logits.shape == (nn_, sizes[-1]) and err <= 1e-4, err
    t0 = time.perf_counter()
    op = SparseOperator.from_matrix(a_norm, device=dev)
    t_plan = time.perf_counter() - t0
    with torch.no_grad():
        fwd_ref = gnn.gcn_forward(a_dev, x, params)
        fwd_op, counts = counted("gcn", lambda: gnn.gcn_forward(
            a_dev, x, params, spmm=lambda _, mm: op.matmat(mm)))
    assert counts == {}, counts        # a PackedPlan: reference.spmm
    err = vec_rel(fwd_op, fwd_ref.double().cpu().numpy())
    log(f"[gcn] op.matmat forward ({op!r}, planned in {t_plan:.3f} s, "
        f"launches {counts}) vs the reference.spmm forward: rel err "
        f"{err:.3g} (limit 1e-05)")
    assert err <= 1e-5, err
    an_t = csr_tensor(sp.csr_matrix((a_norm.data, a_norm.indices,
                                     a_norm.indptr), shape=a_norm.shape), dev)
    a_bytes = nbytes(a_dev.data, a_dev.indices, a_dev.indptr)
    for kf in (256, 40):
        hk = torch.randn((nn_, kf), generator=gen, device=dev)
        # least bytes: A-hat once, H once, the output once; the rows of H
        # a row gather reads (one per nonzero) given beside it
        gather = a_norm.nnz * kf * f4
        measure("gcn", f"aggregate reference.spmm, k = {kf} (rows of H "
                f"gathered per nonzero: {gather} bytes)",
                lambda: reference.spmm(a_dev, hk),
                a_bytes + 2 * nn_ * kf * f4, nops=2 * a_norm.nnz * kf,
                library=("torch.sparse.mm of A-hat's CSR", lambda:
                         torch.sparse.mm(an_t, hk)))
    # the forward: each layer's H W (dense operations) and aggregate (A-hat,
    # its input and output once); the backward: the aggregates again
    # (A-hat^T G) and the products for each W and each H but X's
    dense = [2 * nn_ * a * b_ for a, b_ in zip(sizes, sizes[1:])]
    fwd_ops = sum(dense) + sum(2 * a_norm.nnz * kf for kf in sizes[1:])
    train_ops = 2 * fwd_ops + sum(dense[1:])
    fwd_bytes = sum(a_bytes + 2 * nn_ * kf * f4 for kf in sizes[1:])
    forward = torch.no_grad()(gnn.gcn_forward)
    measure("gcn", "forward, reference.spmm aggregates (no grad)",
            lambda: forward(a_dev, x, params), fwd_bytes,
            nops=fwd_ops)
    measure("gcn", "forward, op.matmat aggregates (no grad)",
            lambda: forward(a_dev, x, params,
                            spmm=lambda _, mm: op.matmat(mm)), fwd_bytes, nops=fwd_ops)
    measure("gcn", "training step: forward, cross entropy, backward",
            train_step, 2 * fwd_bytes, nops=train_ops)
    log(f"[solvers] max_memory_allocated: "
        f"{torch.cuda.max_memory_allocated()} bytes")



def main():
    import scipy.sparse as sp

    from spmv_vector_cache_tpu_torch.formats.cached import CachedPlan

    from spmv_vector_cache_tpu_torch.formats.chunk import ChunkPlan
    from spmv_vector_cache_tpu_torch.formats.containers import COO
    from spmv_vector_cache_tpu_torch.formats.convert import (coo_to_csr,
                                                              from_scipy)
    from spmv_vector_cache_tpu_torch.formats.dia import DiaPlan, HybridPlan
    from spmv_vector_cache_tpu_torch.formats.packed import PackedPlan
    from spmv_vector_cache_tpu_torch.formats.plan import SellPlan
    from spmv_vector_cache_tpu_torch.ops import _kernels, df64
    from spmv_vector_cache_tpu_torch.ops.lane_perm import (
        lane_unpermute, lane_unpermute_plain, unpermute_plan_rows)
    from spmv_vector_cache_tpu_torch.ops.operator import SparseOperator
    from spmv_vector_cache_tpu_torch.ops.runs import (EXTRACT_BLOCK_ROWS,
                                                      RUN_ATOMIC,
                                                      extract_on, heavy_on,
                                                      light_on, runs_on,
                                                      tile_runs)
    from spmv_vector_cache_tpu_torch.ops.spmm_dia import (spmm_dia_kernel,
                                                          spmm_dia_plain,
                                                          spmm_dia_tiling)
    from spmv_vector_cache_tpu_torch.ops.spmm_sell import (spmm_window_kernel,
                                                           spmm_window_plain)
    from spmv_vector_cache_tpu_torch.ops.spmv_chunk import (heavy_kernel,
                                                            heavy_plain,
                                                            light_kernel,
                                                            light_plain)
    from spmv_vector_cache_tpu_torch.ops.spmv_dia import (
        spmv_dia_df, spmv_dia_f64_kernel, spmv_dia_f64_plain,
        spmv_dia_halo_kernel, spmv_dia_halo_plain, spmv_dia_kernel,
        spmv_dia_plain)
    from spmv_vector_cache_tpu_torch.ops.spmv_packed import (
        packed_rows_kernel, packed_rows_plain, packed_scan_kernel,
        packed_scan_plain)
    from spmv_vector_cache_tpu_torch.ops.spmv_sell import (
        folds_groups, row_parts, sell_global_f64_kernel,
        sell_global_f64_plain, sell_global_kernel, sell_global_plain,
        sell_window_f64_kernel, sell_window_f64_plain, sell_window_kernel,
        sell_window_plain, spmv_sell_double_pair)
    from spmv_vector_cache_tpu_torch.ops.strategy import (plan_nnz,
                                                          select_strategy)
    from spmv_vector_cache_tpu_torch.parallel import (
        build_sharded_dia_plan, build_sharded_plan, make_mesh,
        place_on_mesh, spmm_sharded, spmv_dia_sharded, spmv_sharded)
    from spmv_vector_cache_tpu_torch.parallel.spmv_sharded import (
        _local_plan, exchange_mode)
    from spmv_vector_cache_tpu_torch.parallel.mesh import (shard_vector,
                                                           with_halos)
    from spmv_vector_cache_tpu_torch.tools import realistic
    from spmv_vector_cache_tpu_torch.utils import roofline
    from spmv_vector_cache_tpu_torch.utils.platform import require_cuda
    from spmv_vector_cache_tpu_torch.utils.stream import (
        checksum_stream, checksum_stream_plain)

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
    # (each draw kept in float64 for the float64 phases, which use the
    # same values unrounded)
    rng = np.random.default_rng(0)
    offs = list(range(-(ndiag // 2), ndiag // 2 + 1))
    band_vals = rng.standard_normal((ndiag, n))
    band = sp.spdiags(band_vals.astype(np.float32), offs, n, n).tocsr()
    band.sort_indices()
    band64 = sp.spdiags(band_vals, offs, n, n).tocsr()
    band64.sort_indices()
    del band_vals
    x_dia64 = rng.standard_normal(n)
    x_dia = x_dia64.astype(np.float32)

    ns, blk = n >> 1, 128
    rsh = np.repeat(np.arange(ns, dtype=np.int64), ndiag)
    csh = ((rsh // blk) * blk
           + rng.integers(0, blk, rsh.shape[0])).astype(np.int32)
    sell_vals = rng.standard_normal(rsh.shape[0])
    a_sell = coo_to_csr(COO(
        data=sell_vals.astype(np.float32),
        row=rsh.astype(np.int32), col=csh, shape=(ns, ns)))
    a_sell64 = coo_to_csr(COO(data=sell_vals, row=rsh.astype(np.int32),
                              col=csh, shape=(ns, ns)))
    x_sell64 = rng.standard_normal(ns)
    x_sell = x_sell64.astype(np.float32)
    m_sell = sp.csr_matrix((a_sell.data, a_sell.indices, a_sell.indptr),
                           shape=(ns, ns))

    rng_h = np.random.default_rng(0)
    rr = np.repeat(np.arange(n, dtype=np.int64), 2)
    cc = np.clip(rr + rng_h.integers(-512, 513, rr.shape[0]), 0, n - 1)
    resid_vals = rng_h.standard_normal(rr.shape[0])
    resid = sp.csr_matrix((resid_vals.astype(np.float32), (rr, cc)),
                          shape=(n, n))
    m_hyb = (band + resid).tocsr().astype(np.float32)
    m_hyb.sort_indices()
    m_hyb64 = (band64 + sp.csr_matrix((resid_vals, (rr, cc)),
                                      shape=(n, n))).tocsr()
    m_hyb64.sort_indices()
    x_hyb64 = rng_h.standard_normal(n)
    x_hyb = x_hyb64.astype(np.float32)

    a_chunk = realistic.scircuit_like()
    a_packed = realistic.mac_econ_like()
    rng_x = np.random.default_rng(0)
    x_chunk = rng_x.standard_normal(a_chunk.shape[1]).astype(np.float32)
    x_packed = rng_x.standard_normal(a_packed.shape[1]).astype(np.float32)

    rng_z = np.random.default_rng(3)
    a_cached = zipf_cols_matrix(rng_z)
    x_cached = rng_z.standard_normal(a_cached.shape[1]).astype(np.float32)
    rng_u = np.random.default_rng(3)
    a_deep = uniform_matrix(rng_u)
    x_deep = np.abs(rng_u.standard_normal(a_deep.shape[1])).astype(
        np.float32)
    rng_u = np.random.default_rng(3)
    a_deep64 = uniform_matrix(rng_u, dtype=np.float64)
    x_deep64 = np.abs(rng_u.standard_normal(a_deep64.shape[1]))
    rng_w = np.random.default_rng(3)
    a_wide = uniform_matrix(rng_w, cols=1 << 19)
    x_wide = np.abs(rng_w.standard_normal(a_wide.shape[1])).astype(
        np.float32)

    def scipy_of(a):
        return sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)

    # --- plan on the host, place on the card (the default device) ----------
    ops = {}
    for name, a, x, semiring in (
            ("dia", from_scipy(band.astype(np.float32)), x_dia,
             "plus_times"),
            ("sell", a_sell, x_sell, "plus_times"),
            ("hybrid", from_scipy(m_hyb), x_hyb, "plus_times"),
            ("chunk", a_chunk, x_chunk, "plus_times"),
            ("packed", a_packed, x_packed, "plus_times"),
            ("cached", a_cached, x_cached, "plus_times"),
            ("deep", a_deep, x_deep, "min_plus"),
            ("wide", a_wide, x_wide, "min_plus"),
            ("dia_f64", from_scipy(band64), x_dia64, "plus_times"),
            ("sell_f64", a_sell64, x_sell64, "plus_times"),
            ("hybrid_f64", from_scipy(m_hyb64), x_hyb64, "plus_times"),
            ("deep_f64", a_deep64, x_deep64, "plus_times")):
        op = SparseOperator.from_matrix(
            a, semiring=semiring,
            value_dtype=np.float64 if name.endswith("_f64") else np.float32)
        assert op.device.type == "cuda", op.device
        ops[name] = (op, torch.from_numpy(x).to(dev))
        stats_of = {HybridPlan: lambda p: p.dia,
                    CachedPlan: lambda p: p.hot}.get(type(op.plan),
                                                    lambda p: p)
        fill = stats_of(op.plan).stats.fill
        log(f"[{name}] {op!r} plan_seconds={op.stats['plan_seconds']:.3f} "
            f"bytes_per_apply={op.stats['bytes_per_apply']} fill={fill:.4f}")
    # the deep phase's plan once more, on the stream route
    ops["stream"] = (SparseOperator(ops["deep"][0].plan, strategy="stream",
                                    semiring="min_plus"), ops["deep"][1])
    # SpMM: four of the operators applied to B (cols, k), k = 16 (the k4
    # of tools/suite.py), N(0, 1) from a seeded generator
    K_RHS = 16
    rng_b = np.random.default_rng(4)
    b_host = {}
    for name, base in (("spmm_dia", "dia"), ("spmm_sell", "sell"),
                       ("spmm_hybrid", "hybrid"), ("spmm_packed", "packed")):
        op = ops[base][0]
        b_host[name] = rng_b.standard_normal((op.shape[1], K_RHS)).astype(
            np.float32)
        ops[name] = (op, torch.from_numpy(b_host[name]).to(dev))

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
    assert p_chunk.residue is None, type(p_chunk.residue)
    assert all(b.stats.window_blocks <= 64 for b in p_chunk.buckets)
    log(f"[chunk] window buckets (K, tiles) "
        f"{[(b.stats.window_blocks, b.num_tiles) for b in p_chunk.buckets]}"
        f", subwindow buckets (W, tiles) "
        f"{[(h.window_blocks, h.num_tiles) for h in p_chunk.hbuckets]}, "
        f"{p_chunk.num_blocks} light blocks, {p_chunk.num_heavy} heavy rows, "
        f"residue {type(p_chunk.residue).__name__}")
    heavy = heavy_on(p_chunk)
    heavy_work = runs_on(heavy.tile_row, heavy.rows.shape[0])
    log(f"[chunk] kernel D's slab: {heavy.vals.shape[0]} real tiles of "
        f"{sum(h.num_tiles for h in p_chunk.hbuckets)}, "
        f"{heavy.rows.shape[0]} of the {p_chunk.num_heavy} heavy rows have "
        f"subwindow tiles (at most "
        f"{int(torch.bincount(heavy.tile_row).max())} each), "
        f"{heavy_work.runs.shape[0]} records, most tiles a record "
        f"{heavy_work.max_tiles}, split {heavy_work.split}")
    light_heavy = torch.cat([b.tile_slice[b.tile_slice >= p_chunk.num_blocks]
                             for b in p_chunk.buckets])
    log(f"[chunk] the light buckets hold {light_heavy.numel()} tiles of "
        f"{int(torch.unique(light_heavy).numel())} heavy rows (of "
        f"{sum(b.num_tiles for b in p_chunk.buckets)} light tiles): the "
        f"heavy merge after the light route stays")
    light = light_on(p_chunk)
    light_rows = light.row_off.shape[0] - 1
    light_len = light.row_off.diff()
    unit_rows, unit_recs = light.units.diff(dim=0).T
    light_bytes = nbytes(light.row_off, light.cols, light.vals, light.tiled,
                         light.units)
    # the records are the buckets' real slots: every nonzero, no padding
    assert light.vals.shape[0] == sum(b.stats.nnz for b in p_chunk.buckets)
    log(f"[chunk] the light route's records: {light.vals.shape[0]} of the "
        f"buckets' {sum(b.vals.numel() for b in p_chunk.buckets)} slots, "
        f"{light_rows} lane rows ({int((light_len > 0).sum())} with "
        f"records, at most {int(light_len.max())} a row), "
        f"{light.units.shape[0] - 1} CTAs (at most "
        f"{int(unit_rows.max())} rows and {int(unit_recs.max())} "
        f"records each), {light_bytes} bytes on the card")
    p_packed = ops["packed"][0].plan
    assert isinstance(p_packed, PackedPlan) and \
        ops["packed"][0].strategy == "packed"
    assert p_packed.stats.overflow_nnz > 0, p_packed.stats
    log(f"[packed] {p_packed.stats}")
    f_tables = extract_on(p_packed)
    ov_per_cta = f_tables.ov_off[1:] - f_tables.ov_off[:-1]
    log(f"[packed] kernel F's tables: {f_tables.woff.shape[0] - 1} windows "
        f"of {p_packed.stats.num_steps_b} visits, {ov_per_cta.shape[0]} CTAs "
        f"of {EXTRACT_BLOCK_ROWS} rows, {int((ov_per_cta > 0).sum())} with "
        f"overflow (at most {int(ov_per_cta.max())} entries)")
    p_cached = ops["cached"][0].plan
    assert isinstance(p_cached, CachedPlan) and \
        ops["cached"][0].strategy == "cached"
    hot, tier2 = p_cached.hot, p_cached.cold
    assert isinstance(hot, SellPlan) and select_strategy(hot) == "window"
    assert tuple(p_cached.hot_cols.shape) == (256,)
    assert hot.stats.window_blocks == 2, hot.stats
    assert isinstance(tier2, CachedPlan) and tier2.cold is None
    assert tier2.coverage == 1.0 and isinstance(tier2.hot, SellPlan)
    assert select_strategy(tier2.hot) == "resident"
    log(f"[cached] tier 1: {p_cached.hot_cols.shape[0]} hot columns, "
        f"coverage {p_cached.coverage:.4f}, window K="
        f"{hot.stats.window_blocks}, vals {tuple(hot.vals.shape)}, wg="
        f"{hot.stats.group_tiles}, fold={hot.stats.group_fold}; tier 2: "
        f"{tier2.hot_cols.shape[0]} columns, coverage {tier2.coverage}, "
        f"resident, {tier2.hot.stats.num_tiles} tiles, fill "
        f"{tier2.hot.stats.fill:.4f}, fold={tier2.hot.stats.group_fold}")
    p_deep = ops["deep"][0].plan
    assert isinstance(p_deep, SellPlan) and ops["deep"][0].strategy == "deep"
    assert p_deep.stats.window_blocks == 0
    log(f"[deep] {p_deep.stats.num_tiles} tiles, fill "
        f"{p_deep.stats.fill:.4f}, bytes_per_apply "
        f"{ops['deep'][0].stats['bytes_per_apply']}")
    p_wide = ops["wide"][0].plan
    assert isinstance(p_wide, SellPlan) and ops["wide"][0].strategy == \
        "stream" and p_wide.stats.window_blocks == 0
    log(f"[wide] {p_wide.stats.num_tiles} tiles, fill "
        f"{p_wide.stats.fill:.4f}, {p_wide.shape[1] // 128} x blocks")
    p_dia64 = ops["dia_f64"][0].plan
    assert isinstance(p_dia64, DiaPlan) and p_dia64.double
    assert ops["dia_f64"][0].strategy == "dia"
    assert tuple(p_dia64.vals.shape) == (128, 54, 64, 128), p_dia64.vals.shape
    p_sell64 = ops["sell_f64"][0].plan
    st = p_sell64.stats
    assert isinstance(p_sell64, SellPlan) and st.double
    assert ops["sell_f64"][0].strategy == "window"
    assert tuple(p_sell64.vals.shape) == (16384, 16, 128), p_sell64.vals.shape
    assert (st.window_blocks, st.group_tiles, st.uniform_parts) == \
        (1, 2, 2), st
    assert folds_groups(p_sell64) and st.group_slice_identity, st
    p_hyb64 = ops["hybrid_f64"][0].plan
    assert isinstance(p_hyb64, HybridPlan) and p_hyb64.dia.double
    assert ops["hybrid_f64"][0].strategy == "dia"
    assert isinstance(p_hyb64.rest, SellPlan) and p_hyb64.rest.stats.double
    assert p_hyb64.rest.stats.window_blocks > 0, p_hyb64.rest.stats
    log(f"[hybrid_f64] dia vals {tuple(p_hyb64.dia.vals.shape)}, rest vals "
        f"{tuple(p_hyb64.rest.vals.shape)} K="
        f"{p_hyb64.rest.stats.window_blocks} fold="
        f"{folds_groups(p_hyb64.rest)} identity map "
        f"{p_hyb64.rest.identity_map}")
    p_deep64 = ops["deep_f64"][0].plan
    assert isinstance(p_deep64, SellPlan) and p_deep64.stats.double
    assert p_deep64.stats.window_blocks == 0
    assert ops["deep_f64"][0].strategy == "deep"
    log(f"[deep_f64] vals {tuple(p_deep64.vals.shape)}, fill "
        f"{p_deep64.stats.fill:.4f}")

    # --- the main path, once per phase, counting the launches ---------------
    kernels = {"spmv_dia_f32": spmv_dia_kernel,
               "spmv_sell_window_f32": sell_window_kernel,
               "spmv_chunk_light_f32": light_kernel,
               "lane_unpermute_f32": lane_unpermute,
               "spmv_subwin_f32": heavy_kernel,
               "packed_scan_f32": packed_scan_kernel,
               "packed_extract_f32": packed_rows_kernel,
               "spmv_sell_global_f32": sell_global_kernel,
               "spmm_dia_f32": spmm_dia_kernel,
               "spmm_sell_window_f32": spmm_window_kernel,
               "spmv_dia_f64": spmv_dia_f64_kernel,
               "spmv_sell_window_f64": sell_window_f64_kernel,
               "spmv_sell_global_f64": sell_global_f64_kernel,
               "spmv_dia_halo_f32": spmv_dia_halo_kernel,
               "stream_checksum_f32": checksum_stream}
    path_kernels = {"dia": ["spmv_dia_f32"],
                    "sell": ["spmv_sell_window_f32"],
                    "hybrid": ["spmv_dia_f32", "spmv_sell_window_f32"],
                    "chunk": ["spmv_chunk_light_f32", "lane_unpermute_f32",
                              "spmv_subwin_f32"],
                    "packed": ["packed_scan_f32", "packed_extract_f32"],
                    "cached": ["spmv_sell_window_f32",
                               "spmv_sell_global_f32"],
                    "deep": ["spmv_sell_global_f32"],
                    "stream": ["spmv_sell_global_f32"],
                    "wide": ["spmv_sell_global_f32"],
                    "spmm_dia": ["spmm_dia_f32"],
                    "spmm_sell": ["spmm_sell_window_f32"],
                    "spmm_hybrid": ["spmm_dia_f32", "spmm_sell_window_f32"],
                    "spmm_packed": [],
                    "dia_f64": ["spmv_dia_f64"],
                    "sell_f64": ["spmv_sell_window_f64"],
                    "hybrid_f64": ["spmv_dia_f64", "spmv_sell_window_f64"],
                    "deep_f64": ["spmv_sell_global_f64"]}
    # the packed, chunk, SpMM or float64 phase launches exactly these,
    # and no other kernel: the PackedPlan has no fused SpMM kernel and
    # runs the reference SpMM
    exact_launches = {"packed": {"packed_scan_f32": 1,
                                 "packed_extract_f32": 1},
                      "chunk": {"spmv_chunk_light_f32": 1,
                                "lane_unpermute_f32": 1,
                                "spmv_subwin_f32": 1},
                      "spmm_dia": {"spmm_dia_f32": 1},
                      "spmm_sell": {"spmm_sell_window_f32": 1},
                      "spmm_hybrid": {"spmm_dia_f32": 1,
                                      "spmm_sell_window_f32": 1},
                      "spmm_packed": {},
                      "dia_f64": {"spmv_dia_f64": 1},
                      "sell_f64": {"spmv_sell_window_f64": 1},
                      "hybrid_f64": {"spmv_dia_f64": 1,
                                     "spmv_sell_window_f64": 1},
                      "deep_f64": {"spmv_sell_global_f64": 1}}
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
        if name in exact_launches:
            want = dict.fromkeys(kernels, 0)
            want.update(exact_launches[name])
            assert counts == want, (name, counts)
        for k, c in counts.items():
            launches[k] += c

    # --- the stream checksum and the sharded paths: their plans and inputs,
    # then one counted run each ----------------------------------------------
    # a 256 MiB float32 stream of (8, 128) tiles, 64 tiles (256 KiB, one
    # CTA of kernel N) per checksum; the ramp holds t in tile t
    n_tiles, STREAM_BLOCK = (256 << 20) // 4096, 64
    ramp = torch.arange(n_tiles, dtype=torch.float32, device=dev)[
        :, None, None].expand(n_tiles, 8, 128).contiguous()
    noise = torch.randn((n_tiles, 8, 128), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6))
    mesh4 = make_mesh(4, device="cuda")       # one card: 4 shards on it
    t0 = time.perf_counter()
    sp_dia = place_on_mesh(build_sharded_dia_plan(from_scipy(band), 4),
                           mesh4)
    t_dia = time.perf_counter() - t0
    assert (sp_dia.halo, sp_dia.rows_per_shard) == (128, 262144), sp_dia
    t0 = time.perf_counter()
    sp_sell = place_on_mesh(build_sharded_plan(a_sell, 4), mesh4)
    t_sell = time.perf_counter() - t0
    assert (sp_sell.halo, sp_sell.rows_per_shard) == (128, 131072), sp_sell
    assert sp_sell.window_blocks == 1, sp_sell
    log(f"[sharded] 4 shards on {[str(d) for d in mesh4.devices]}: DIA "
        f"plan {t_dia:.3f} s (vals {tuple(sp_dia.vals[0].shape)} per shard, "
        f"halo {sp_dia.halo}), SELL plan {t_sell:.3f} s (vals "
        f"{tuple(sp_sell.vals[0].shape)} per shard, K="
        f"{sp_sell.window_blocks}, halo {sp_sell.halo}, identity map "
        f"{sp_sell.identity_map})")
    x_dia_t, x_sell_t = ops["dia"][1], ops["sell"][1]
    b_sell_t = ops["spmm_sell"][1]
    # name: (the main path, the launches it must make, and no other)
    more_paths = {
        "stream_checksum": (lambda: checksum_stream(ramp, STREAM_BLOCK),
                   {"stream_checksum_f32": 1}),
        "sharded_dia": (lambda: spmv_dia_sharded(sp_dia, x_dia_t, mesh4),
                        {"spmv_dia_halo_f32": 4}),
        "sharded_sell": (lambda: spmv_sharded(sp_sell, x_sell_t, mesh4,
                                              mode="halo"),
                         {"spmv_sell_window_f32": 4}),
        "sharded_sell_ag": (lambda: spmv_sharded(sp_sell, x_sell_t, mesh4,
                                                 mode="all_gather"),
                            {"spmv_sell_window_f32": 4}),
        "sharded_spmm": (lambda: spmm_sharded(sp_sell, b_sell_t, mesh4),
                         {"spmm_sell_window_f32": 4}),
    }
    for name, (run, exact) in more_paths.items():
        for k in kernels.values():
            k.launches = 0
        ys[name] = run()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in kernels.items()}
        log(f"[{name}] main-path launches: {counts}")
        want = dict.fromkeys(kernels, 0)
        want.update(exact)
        assert counts == want, (name, counts)
        for k, c in counts.items():
            launches[k] += c

    # --- y against a float64 host reference ---------------------------------
    ref64 = {"dia": (band, x_dia), "sell": (m_sell, x_sell),
             "hybrid": (m_hyb, x_hyb), "chunk": (scipy_of(a_chunk), x_chunk),
             "packed": (scipy_of(a_packed), x_packed),
             "cached": (scipy_of(a_cached), x_cached),
             "spmm_dia": (band, b_host["spmm_dia"]),
             "spmm_sell": (m_sell, b_host["spmm_sell"]),
             "spmm_hybrid": (m_hyb, b_host["spmm_hybrid"]),
             "spmm_packed": (scipy_of(a_packed), b_host["spmm_packed"])}
    want64 = {name: m.astype(np.float64) @ x.astype(np.float64)
              for name, (m, x) in ref64.items()}
    want64["deep"] = want64["stream"] = min_plus_host(a_deep, x_deep)
    want64["wide"] = min_plus_host(a_wide, x_wide)
    for name, want in want64.items():
        y = ys[name]
        assert y.shape == want.shape and bool(torch.isfinite(y).all())
        err = rel_err(y, want)
        log(f"[{name}] y vs float64 host: rel err {err:.3g} "
            f"(limit {Y_RTOL:g})")
        assert err < Y_RTOL, (name, err)
    # one kernel, one plan: the stream route's y is the deep route's
    assert torch.equal(ys["stream"], ys["deep"])
    log("[stream] y equals the deep route's y exactly")
    # the sharded paths against float64 scipy, and kernel M against kernel
    # A: the same slab values and the same diagonal order, so bit for bit
    for name, base in (("sharded_dia", "dia"), ("sharded_sell", "sell"),
                       ("sharded_sell_ag", "sell"),
                       ("sharded_spmm", "spmm_sell")):
        y, want = ys[name], want64[base]
        assert y.shape == want.shape and bool(torch.isfinite(y).all())
        err = rel_err(y, want)
        log(f"[{name}] y vs float64 host: rel err {err:.3g} (limit "
            f"{Y_RTOL:g})")
        assert err < Y_RTOL, (name, err)
    assert torch.equal(ys["sharded_dia"], ys["dia"])
    log("[sharded_dia] y equals kernel A's unsharded y bit for bit")
    err = max_abs(ys["sharded_sell"], ys["sharded_sell_ag"])
    tol = KERNEL_RTOL * max(1.0, float(ys["sharded_sell_ag"].abs().max()))
    assert err <= tol, err
    log(f"[sharded_sell] halo vs all_gather y: max abs err {err:.3g} "
        f"(limit {tol:.3g}; exact: "
        f"{torch.equal(ys['sharded_sell'], ys['sharded_sell_ag'])})")
    # 'auto' picks the halo exchange (the partials' index_add_ sums in no
    # fixed order, so two runs agree to rounding, not bit for bit)
    assert exchange_mode(sp_sell, "auto") == "halo"
    err = max_abs(spmv_sharded(sp_sell, x_sell_t, mesh4, mode="auto"),
                  ys["sharded_sell"])
    assert err <= tol, err
    log(f"[sharded_sell] mode='auto' runs the halo exchange (halo "
        f"{sp_sell.halo} <= rows_per_shard {sp_sell.rows_per_shard}); its y "
        f"vs the halo run's: max abs err {err:.3g}")
    # the ramp's checksums against their closed form: block b sums tiles
    # 64b .. 64b+63, each 1024 copies of its index
    b_idx = np.arange(n_tiles // STREAM_BLOCK, dtype=np.float64)
    closed = 1024.0 * (STREAM_BLOCK * STREAM_BLOCK * b_idx
                       + STREAM_BLOCK * (STREAM_BLOCK - 1) / 2)
    got = ys["stream_checksum"].cpu().numpy().astype(np.float64)
    err = float(np.abs(got - closed).max() / np.abs(closed).max())
    log(f"[stream_checksum] {got.shape[0]} ramp checksums of {STREAM_BLOCK} tiles "
        f"vs the closed form: rel err {err:.3g} (limit 1e-06)")
    assert got.shape == closed.shape and err < 1e-6, err
    ref_f64 = {"dia_f64": (band64, x_dia64), "sell_f64": (scipy_of(a_sell64),
                                                          x_sell64),
               "hybrid_f64": (m_hyb64, x_hyb64),
               "deep_f64": (scipy_of(a_deep64), x_deep64)}
    for name, (m, x) in ref_f64.items():
        y, want = ys[name], m @ x
        assert y.dtype == torch.float64 and y.shape == want.shape
        assert bool(torch.isfinite(y).all())
        err = rel_err(y, want)
        want64[name] = want
        log(f"[{name}] y vs float64 scipy: rel err {err:.3g} (limit "
            f"{Y_RTOL_F64:g})")
        assert err < Y_RTOL_F64, (name, err)
    # the pair API: (xh, xl) float32 in, (yh, yl) out, joined against the
    # float64 apply's y (not counted: the main path ran above)
    for name, pair_fn in (("sell_f64", lambda xh, xl: spmv_sell_double_pair(
                              p_sell64, xh, xl)),
                          ("dia_f64", lambda xh, xl: spmv_dia_df(
                              p_dia64, xh, xl))):
        yh, yl = pair_fn(*df64.split(ops[name][1]))
        assert yh.dtype == yl.dtype == torch.float32
        err = max_abs(df64.join(yh, yl), ys[name]) / max(
            1.0, float(ys[name].abs().max().item()))
        log(f"[{name}] pair API joined vs the float64 apply: rel err "
            f"{err:.3g} (limit {PAIR_RTOL:g})")
        assert err < PAIR_RTOL, (name, err)

    # --- each kernel against its plain version, at the main path's shapes ---
    def window_args(plan):
        st = plan.stats
        return dict(group_tiles=st.group_tiles,
                    window_grain=st.window_grain, fold=folds_groups(plan),
                    semiring="plus_times")

    # each pair: (kernel call, plain call, bytes the kernel must move,
    # operations it does, in float32, or float64 for the _f64 kernels); a
    # gather kernel must read only the distinct x entries its columns
    # name, not all of x
    def dia_pair(plan, x):
        args = (plan.vals, plan.offsets, x, plan.shape[0])
        return (lambda: spmv_dia_kernel(*args),
                lambda: spmv_dia_plain(*args),
                nbytes(plan.vals, x) + 4 * len(plan.offsets)
                + plan.shape[0] * 4,
                2 * plan.vals.numel())

    def sell_pair(plan, x):
        args = (plan.vals, plan.cols_win, plan.window_base, x)
        kw = window_args(plan)
        rows_out = plan.num_tiles // (plan.stats.group_tiles
                                      if kw["fold"] else 1)
        base = plan.window_base.long().repeat_interleave(
            plan.stats.group_tiles) * plan.stats.window_grain
        cols = base[:, None, None] + plan.cols_win.long()
        return (lambda: sell_window_kernel(*args, **kw),
                lambda: sell_window_plain(*args, **kw),
                nbytes(*args[:3]) + x_bytes_read(x, cols)
                + rows_out * plan.lane_rows * 4,
                2 * plan.vals.numel())

    # the chunk light route reads the records, their offsets and work
    # list, the tiled bytes and the x they name; it writes every lane row
    def light_pair(lr, x):
        return (lambda: light_kernel(lr, x, semiring="plus_times"),
                lambda: light_plain(lr, x, semiring="plus_times"),
                nbytes(lr.row_off, lr.cols, lr.vals, lr.tiled, lr.units)
                + x_bytes_read(x, lr.cols) + (lr.row_off.shape[0] - 1) * 4,
                2 * lr.vals.shape[0])

    # kernel D adds each heavy row's sum into y in place: each version
    # updates its own copy of the chunk phase's y (the timed calls go on
    # adding); it reads and writes the heavy rows of y, no partials
    def heavy_pair(h, x):
        args = (h.vals, h.cols_win, h.bases, h.tile_row, h.rows, x)
        y_k, y_p = ys["chunk"].clone(), ys["chunk"].clone()
        cols = h.bases.long()[:, :, None] * 128 + h.cols_win.long()
        return (lambda: heavy_kernel(*args, y_k, semiring="plus_times"),
                lambda: heavy_plain(*args, y_p, semiring="plus_times"),
                nbytes(*args[:5], heavy_work.runs) + x_bytes_read(x, cols)
                + 2 * h.rows.shape[0] * 4,
                2 * h.vals.numel())

    # kernel G sums each slice's tiles itself: its output is y's rows
    # (identity map, uniform parts) or the slice sums, written once
    def global_pair(plan, x, semiring):
        parts = row_parts(plan)
        args = (plan.vals, plan.cols, plan.tile_slice, x)
        kw = dict(num_slices=plan.num_slices, parts=parts,
                  rows=plan.shape[0], semiring=semiring)
        out_elems = plan.shape[0] if parts else \
            plan.num_slices * plan.lane_rows
        runs = tile_runs(plan.tile_slice, plan.num_slices)
        return (lambda: sell_global_kernel(*args, **kw),
                lambda: sell_global_plain(*args, **kw),
                nbytes(*args[:3]) + runs.nbytes + x_bytes_read(x, plan.cols)
                + out_elems * 4,
                2 * plan.vals.numel())

    def spmm_dia_pair(plan, b):
        args = (plan.vals, plan.offsets, b, plan.shape[0])
        return (lambda: spmm_dia_kernel(*args),
                lambda: spmm_dia_plain(*args),
                nbytes(plan.vals, b) + 4 * len(plan.offsets)
                + plan.shape[0] * b.shape[1] * 4,
                2 * plan.vals.numel() * b.shape[1])

    # kernel H sums each slice's tiles itself: its output is Y's rows
    # (identity map, uniform parts) or the slice sums, written once
    def spmm_window_pair(plan, b):
        st = plan.stats
        parts = row_parts(plan)
        args = (plan.vals, plan.cols_win, plan.window_base, plan.tile_slice,
                b)
        kw = dict(num_slices=plan.num_slices, group_tiles=st.group_tiles,
                  window_grain=st.window_grain, parts=parts,
                  rows=plan.shape[0])
        out_rows = plan.shape[0] if parts else \
            plan.num_slices * plan.lane_rows
        base = plan.window_base.long().repeat_interleave(
            st.group_tiles) * st.window_grain
        cols = base[:, None, None] + plan.cols_win.long()
        runs = tile_runs(plan.tile_slice, plan.num_slices)
        return (lambda: spmm_window_kernel(*args, **kw),
                lambda: spmm_window_plain(*args, **kw),
                nbytes(*args[:4]) + runs.nbytes + x_bytes_read(b, cols)
                + out_rows * b.shape[1] * 4,
                2 * plan.vals.numel() * b.shape[1])

    # the float64 kernels read a (.., 2C, ..) hi/lo slab: two words per
    # stored slot, 2 FP64 operations per slot
    def dia_f64_pair(plan, x):
        args = (plan.vals, plan.offsets, x, plan.shape[0])
        return (lambda: spmv_dia_f64_kernel(*args),
                lambda: spmv_dia_f64_plain(*args),
                nbytes(plan.vals, x) + 4 * len(plan.offsets)
                + plan.shape[0] * 8,
                plan.vals.numel())

    def sell_f64_pair(plan, x):
        st = plan.stats
        args = (plan.vals, plan.cols_win, plan.window_base, x)
        kw = dict(group_tiles=st.group_tiles, window_grain=st.window_grain,
                  fold=folds_groups(plan))
        rows_out = plan.num_tiles // (st.group_tiles if kw["fold"] else 1)
        base = plan.window_base.long().repeat_interleave(
            st.group_tiles) * st.window_grain
        cols = base[:, None, None] + plan.cols_win.long()
        return (lambda: sell_window_f64_kernel(*args, **kw),
                lambda: sell_window_f64_plain(*args, **kw),
                nbytes(*args[:3]) + x_bytes_read(x, cols)
                + rows_out * plan.lane_rows * 8,
                plan.vals.numel())

    # kernel L, as G: y's rows (identity map, uniform parts) or the slice
    # sums, written once in float64
    def global_f64_pair(plan, x):
        parts = row_parts(plan)
        args = (plan.vals, plan.cols, plan.tile_slice, x)
        kw = dict(num_slices=plan.num_slices, parts=parts,
                  rows=plan.shape[0])
        out_elems = plan.shape[0] if parts else \
            plan.num_slices * plan.lane_rows
        runs = tile_runs(plan.tile_slice, plan.num_slices)
        return (lambda: sell_global_f64_kernel(*args, **kw),
                lambda: sell_global_f64_plain(*args, **kw),
                nbytes(*args[:3]) + runs.nbytes + x_bytes_read(x, plan.cols)
                + out_elems * 8,
                plan.vals.numel())

    # kernel C at the chunk phase's shape: (light blocks, 128) sums
    y2d = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (p_chunk.num_blocks, 128)).astype(np.float32)).to(dev)
    lane_args = (y2d, p_chunk.perm_idx)
    pst = p_packed.stats
    x_pk = ops["packed"][1]
    scan_args = (p_packed.vals, p_packed.cols, p_packed.cstep, x_pk)
    scan_kw = dict(chunk_blocks=pst.chunk_blocks, step_tiles=pst.step_tiles)
    scan_cols = (p_packed.cstep.long().repeat_interleave(
        pst.step_tiles)[:, None, None] * (pst.chunk_blocks * 128)
        + (p_packed.cols.long() & 16383))
    # kernel F reads the plain scan, so both versions see the same input
    ext_args = (packed_scan_plain(*scan_args, **scan_kw), p_packed.sblock,
                p_packed.esrc, x_pk, f_tables)
    ext_kw = dict(rows=p_packed.shape[0], step_tiles=pst.step_tiles)
    # kernel F reads only the piece sums that esrc picks, its tables, the
    # overflow's x, and writes y
    f_parts = packed_extract_bytes(p_packed, f_tables, x_pk)
    f_bytes = sum(f_parts.values())
    picked = f_parts["picked S entries"] // 4
    novf = f_tables.ov_vals.shape[0]
    log(f"[packed] kernel F's bytes: "
        + ", ".join(f"{k} {v}" for k, v in f_parts.items())
        + f": {f_bytes} in all")
    # kernel G, resident route: the cached phase's tier 2 on its x[hot_cols]
    x_tier2 = ops["cached"][1].index_select(0, tier2.hot_cols)
    x_tier1 = ops["cached"][1].index_select(0, p_cached.hot_cols)

    # (kernel, phase, what, (kernel call, plain call, bytes, operations),
    # exact); a kernel's JSON row sums its calls in its headline phase
    cases = [("spmv_dia_f32", "dia", "", dia_pair(p_dia, ops["dia"][1]),
              False),
             ("spmv_sell_window_f32", "sell", "",
              sell_pair(p_sell, ops["sell"][1]), False),
             ("spmv_dia_f32", "hybrid", "", dia_pair(p_hyb.dia,
                                                     ops["hybrid"][1]),
              False),
             ("spmv_sell_window_f32", "hybrid", "",
              sell_pair(p_hyb.rest, ops["hybrid"][1]), False)]
    cases += [("spmv_chunk_light_f32", "chunk",
               f" ({light.vals.shape[0]} records, {light_rows} lane rows)",
               light_pair(light, ops["chunk"][1]), False)]
    cases += [("spmv_subwin_f32", "chunk",
               f" ({heavy.vals.shape[0]} tiles of W="
               f"{[h.window_blocks for h in p_chunk.hbuckets]})",
               heavy_pair(heavy, ops["chunk"][1]), False)]
    # kernel C through the public wrapper, which allocates its output;
    # then the apply's call, which un-permutes its input in place (timed
    # on a copy, permuted anew by every call)
    y2d_work = y2d.clone()
    c_bytes = 2 * nbytes(y2d) + nbytes(p_chunk.perm_idx)
    cases += [("lane_unpermute_f32", "chunk", " (public, allocating)",
               (lambda: lane_unpermute(*lane_args),
                lambda: lane_unpermute_plain(*lane_args), c_bytes, 0), True),
              ("lane_unpermute_f32", "chunk apply",
               " (in place, the apply's call)",
               (lambda: unpermute_plan_rows(y2d_work, p_chunk.perm_idx),
                lambda: lane_unpermute_plain(*lane_args), c_bytes, 0), True),
              ("packed_scan_f32", "packed", "",
               (lambda: packed_scan_kernel(*scan_args, **scan_kw),
                lambda: packed_scan_plain(*scan_args, **scan_kw),
                nbytes(*scan_args[:3]) + x_bytes_read(x_pk, scan_cols)
                + nbytes(p_packed.vals),
                2 * p_packed.vals.numel()), False),
              ("packed_extract_f32", "packed", "",
               (lambda: packed_rows_kernel(*ext_args, **ext_kw),
                lambda: packed_rows_plain(*ext_args, **ext_kw),
                f_bytes, picked + 2 * novf), False),
              ("spmv_sell_window_f32", "cached", " tier 1",
               sell_pair(hot, x_tier1), False),
              ("spmv_sell_global_f32", "cached", " resident (tier 2)",
               global_pair(tier2.hot, x_tier2, "plus_times"), False),
              ("spmv_sell_global_f32", "deep", " deep",
               global_pair(p_deep, ops["deep"][1], "min_plus"), True),
              ("spmv_sell_global_f32", "stream", " stream",
               global_pair(p_deep, ops["deep"][1], "min_plus"), True),
              ("spmv_sell_global_f32", "wide", " stream (2^19 columns)",
               global_pair(p_wide, ops["wide"][1], "min_plus"), True),
              ("spmm_dia_f32", "spmm_dia", f" k={K_RHS}",
               spmm_dia_pair(p_dia, ops["spmm_dia"][1]), False),
              ("spmm_sell_window_f32", "spmm_sell", f" k={K_RHS}",
               spmm_window_pair(p_sell, ops["spmm_sell"][1]), False),
              ("spmm_dia_f32", "spmm_hybrid", f" k={K_RHS}",
               spmm_dia_pair(p_hyb.dia, ops["spmm_hybrid"][1]), False),
              ("spmm_sell_window_f32", "spmm_hybrid", f" k={K_RHS}",
               spmm_window_pair(p_hyb.rest, ops["spmm_hybrid"][1]), False),
              ("spmv_dia_f64", "dia_f64", "",
               dia_f64_pair(p_dia64, ops["dia_f64"][1]), False),
              ("spmv_sell_window_f64", "sell_f64", "",
               sell_f64_pair(p_sell64, ops["sell_f64"][1]), False),
              ("spmv_dia_f64", "hybrid_f64", "",
               dia_f64_pair(p_hyb64.dia, ops["hybrid_f64"][1]), False),
              ("spmv_sell_window_f64", "hybrid_f64", "",
               sell_f64_pair(p_hyb64.rest, ops["hybrid_f64"][1]), False),
              ("spmv_sell_global_f64", "deep_f64", "",
               global_f64_pair(p_deep64, ops["deep_f64"][1]), False)]

    # kernel M, each shard of the sharded DIA phase on its halo'd x
    def halo_pair(d):
        args = (sp_dia.vals[d], sp_dia.offsets, x_ext[d],
                sp_dia.rows_per_shard, sp_dia.halo)
        return (lambda: spmv_dia_halo_kernel(*args),
                lambda: spmv_dia_halo_plain(*args),
                nbytes(sp_dia.vals[d], x_ext[d]) + 4 * len(sp_dia.offsets)
                + sp_dia.rows_per_shard * 4,
                2 * sp_dia.vals[d].numel())

    x_shards = shard_vector(x_dia_t, torch.float32, 4,
                            sp_dia.rows_per_shard, mesh4)
    x_ext = [with_halos(x_shards, d, sp_dia.halo, dev)
             for d, dev in enumerate(mesh4.devices)]
    cases += [("spmv_dia_halo_f32", "sharded_dia", f" shard {d}",
               halo_pair(d), False) for d in range(4)]
    # kernel H, each shard of the sharded SpMM phase on the replicated B
    # (zero-padded to the shards' rows, as spmm_sharded hands it over)
    b_pad = b_sell_t.new_zeros((4 * sp_sell.rows_per_shard, K_RHS))
    b_pad[:b_sell_t.shape[0]] = b_sell_t
    shard_plans = [_local_plan(sp_sell, d, sp_sell.cols[d],
                               sp_sell.window_base[d], b_pad.shape[0],
                               sp_sell.max_window_base) for d in range(4)]
    cases += [("spmm_sell_window_f32", "sharded_spmm", f" shard {d}",
               spmm_window_pair(lp, b_pad), False)
              for d, lp in enumerate(shard_plans)]
    for name, plan in (("spmm_sell", p_sell), ("spmm_hybrid", p_hyb.rest),
                       *((f"sharded_spmm shard {d}", lp)
                         for d, lp in enumerate(shard_plans))):
        runs = tile_runs(plan.tile_slice, plan.num_slices)
        log(f"[{name}] kernel H: parts={row_parts(plan)} (1: identity "
            f"map, p: lane fold, 0: slice sums), {runs.shape[0]} runs over "
            f"{plan.num_tiles} tiles and {plan.num_slices} slices, "
            f"{int(((runs[:, 3] & RUN_ATOMIC) != 0).sum())} split "
            f"(atomic) pieces")
    log(f"[spmm_dia] kernel I tiling at k={K_RHS}: "
        f"{spmm_dia_tiling(p_dia.offsets, K_RHS)}")
    # kernel N on the random stream: one add per float read
    cases += [("stream_checksum_f32", "stream_checksum",
               f" block={STREAM_BLOCK} tiles",
               (lambda: checksum_stream(noise, STREAM_BLOCK),
                lambda: checksum_stream_plain(noise, STREAM_BLOCK),
                nbytes(noise) + noise.numel() // (STREAM_BLOCK * 256),
                noise.numel()), False)]
    headline = {"spmv_dia_f32": "dia", "spmv_sell_window_f32": "sell",
                "spmv_chunk_light_f32": "chunk",
                "lane_unpermute_f32": "chunk", "spmv_subwin_f32": "chunk",
                "packed_scan_f32": "packed", "packed_extract_f32": "packed",
                "spmv_sell_global_f32": "deep", "spmm_dia_f32": "spmm_dia",
                "spmm_sell_window_f32": "spmm_sell",
                "spmv_dia_f64": "dia_f64", "spmv_sell_window_f64": "sell_f64",
                "spmv_sell_global_f64": "deep_f64",
                "spmv_dia_halo_f32": "sharded_dia",
                "stream_checksum_f32": "stream_checksum"}
    rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                    bound_by="bytes", library_ms=None) for k in kernels}
    bound_terms = {k: [0.0, 0.0] for k in kernels}
    # (bytes, operations, peak operations/s) of each headline case
    bound_work = {k: [] for k in kernels}
    for kname, phase, what, (kern, plain, nbyte, nops), exact in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        assert got.shape == ref.shape, (kname, phase, got.shape, ref.shape)
        if exact:
            # a permutation, or order-free min-plus sums: bit for bit
            assert torch.equal(got, ref), (kname, phase)
            err, tol = 0.0, 0.0
        else:
            err = max_abs(got, ref)
            rtol = KERNEL_RTOL_F64 if got.dtype == torch.float64 \
                else KERNEL_RTOL
            tol = rtol * max(1.0, float(ref.abs().max().item()))
            assert err <= tol, (kname, phase, err)
        log(f"[{phase}] {kname}{what} vs plain: max abs err {err:.3g} "
            f"(limit {tol:.3g}{', exact' if exact else ''}), shape "
            f"{tuple(got.shape)}")
        rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], err)
        bytes_ms = nbyte / PEAK_BYTES_PER_S * 1e3
        ops_ms = nops / (PEAK_F64_PER_S if kname.endswith("_f64")
                         else PEAK_F32_PER_S) * 1e3
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        log(f"[{phase}] {kname}{what}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({nbyte} bytes, {nops} operations) on {card}")
        if phase == headline[kname]:
            rows[kname]["ms"] += min(k1, k2)
            rows[kname]["plain_ms"] += min(p1, p2)
            rows[kname]["bound_ms"] += max(bytes_ms, ops_ms)
            bound_terms[kname][0] += bytes_ms
            bound_terms[kname][1] += ops_ms
            bound_work[kname].append((nbyte, nops, PEAK_F64_PER_S
                                      if kname.endswith("_f64")
                                      else PEAK_F32_PER_S))
    for kname, (bytes_ms, ops_ms) in bound_terms.items():
        rows[kname]["bound_by"] = "bytes" if bytes_ms >= ops_ms \
            else "operations"

    # kernel C's function is one torch.gather of the (blocks, 1024) image
    img = y2d.reshape(-1, 1024)
    gidx = p_chunk.perm_idx.long().reshape(-1, 1024)
    assert torch.equal(torch.gather(img, 1, gidx).reshape(y2d.shape),
                       lane_unpermute(*lane_args))
    # in turns, like for like: the public wrapper against torch.gather,
    # both allocating their output; the apply's in-place call against
    # torch.gather into an output allocated beforehand
    buf = torch.empty_like(img)

    def apply_c():
        return unpermute_plan_rows(y2d_work, p_chunk.perm_idx)

    def public_c():
        return lane_unpermute(*lane_args)

    def gather():
        return torch.gather(img, 1, gidx)

    def gather_out():
        return torch.gather(img, 1, gidx, out=buf)

    for what, c_call, g_call in (
            ("allocating: the public lane_unpermute, torch.gather", public_c,
             gather),
            ("into a buffer: the apply's in-place call, torch.gather(out=)",
             apply_c, gather_out)):
        c1, g1, g2, c2 = (time_ms(c_call), time_ms(g_call), time_ms(g_call),
                          time_ms(c_call))
        if c_call is public_c:
            rows["lane_unpermute_f32"]["library_ms"] = min(g1, g2)
        log(f"[chunk] in turns, {what}: kernel C {c1:.4f}/{c2:.4f} ms, "
            f"torch.gather {g1:.4f}/{g2:.4f} ms; CUDA events, on {card}")
    host_cost(y2d, p_chunk.perm_idx, img, gidx, card)
    # kernel N: torch.sum streams the same 256 MiB (one sum, not 1024)
    lib_ms = min(time_ms(lambda: torch.sum(noise)) for _ in "ab")
    rows["stream_checksum_f32"]["library_ms"] = lib_ms
    log(f"[stream_checksum] torch.sum of the same buffer: {lib_ms:.4f} ms "
        f"on {card}")

    # kernels H and I: torch.sparse.mm of the same matrix, as a CSR tensor
    # on the card, with the same B (a yardstick, never on the path)
    def library_device_us(phase, what, call):
        """A library call's device time by the profiler (its event time
        on a sub-20-us function measures host dispatch)."""
        by_kernel = device_us_by_kernel(call)
        us = sum(t for t, _ in by_kernel.values())
        log(f"[{phase}] {what} device time by profiler: {us:.2f} us per "
            f"call ({', '.join(k[:40] for k in by_kernel) or 'none'}) on "
            f"{card}")
        return us

    csr_t = {"dia": csr_tensor(band, dev), "sell": csr_tensor(m_sell, dev)}
    for kname, phase, base in (("spmm_dia_f32", "spmm_dia", "dia"),
                               ("spmm_sell_window_f32", "spmm_sell",
                                "sell")):
        a_t, b = csr_t[base], ops[phase][1]
        err = rel_err(torch.sparse.mm(a_t, b), want64[phase])
        assert err < Y_RTOL, (phase, err)
        lib_ms = min(time_ms(lambda: torch.sparse.mm(a_t, b)) for _ in "ab")
        rows[kname]["library_ms"] = lib_ms
        log(f"[{phase}] torch.sparse.mm (CSR, k={K_RHS}): {lib_ms:.4f} ms, "
            f"rel err {err:.3g} vs float64, on {card}")
    # kernels A and B, and J, K and L: torch.sparse.mm of the same
    # matrix as a CSR tensor (float32, or float64), x as (cols, 1)
    for kname, phase, m, dtype, tol in (
            ("spmv_dia_f32", "dia", band, np.float32, Y_RTOL),
            ("spmv_sell_window_f32", "sell", m_sell, np.float32, Y_RTOL),
            ("spmv_dia_f64", "dia_f64", band64, np.float64, Y_RTOL_F64),
            ("spmv_sell_window_f64", "sell_f64", ref_f64["sell_f64"][0],
             np.float64, Y_RTOL_F64),
            ("spmv_sell_global_f64", "deep_f64", ref_f64["deep_f64"][0],
             np.float64, Y_RTOL_F64)):
        a_t = csr_t[phase] if phase in csr_t else csr_tensor(m, dev, dtype)
        x_col = ops[phase][1].reshape(-1, 1)
        err = rel_err(torch.sparse.mm(a_t, x_col).reshape(-1),
                      want64[phase])
        assert err < tol, (phase, err)
        lib_ms = min(time_ms(lambda: torch.sparse.mm(a_t, x_col))
                     for _ in "ab")
        rows[kname]["library_ms"] = lib_ms
        log(f"[{phase}] torch.sparse.mm (CSR {np.dtype(dtype).name}, x as "
            f"(cols, 1)): {lib_ms:.4f} ms, rel err {err:.3g} vs float64, "
            f"on {card}")
        library_device_us(phase, "torch.sparse.mm",
                          lambda: torch.sparse.mm(a_t, x_col))
        del a_t
    # kernel G on the cached tier 2: torch.sparse.mm of the tier's matrix
    # (its plan's slots as a CSR over the tier's columns) over x[hot_cols]
    m_t2 = plan_csr(tier2.hot)
    want_t2 = m_t2.astype(np.float64) @ x_tier2.double().cpu().numpy()
    a_t, x_col = csr_tensor(m_t2, dev), x_tier2.reshape(-1, 1)
    err = rel_err(torch.sparse.mm(a_t, x_col).reshape(-1), want_t2)
    assert err < Y_RTOL, err
    lib_ms = min(time_ms(lambda: torch.sparse.mm(a_t, x_col)) for _ in "ab")
    log(f"[cached] torch.sparse.mm of tier 2 (CSR float32, {m_t2.nnz} nnz "
        f"over {m_t2.shape[1]} columns, x[hot_cols] as (cols, 1)): "
        f"{lib_ms:.4f} ms, rel err {err:.3g} vs float64, on {card}")
    library_device_us("cached", "torch.sparse.mm of tier 2",
                      lambda: torch.sparse.mm(a_t, x_col))
    # kernel D: torch.sparse.mm of the heavy rows' CSR (the slab's
    # nonzeros, one row per heavy row with tiles) over x: D's sums
    hv = heavy.vals.reshape(heavy.vals.shape[0], -1).cpu().numpy()
    hc = (heavy.bases.long()[:, :, None] * 128 + heavy.cols_win.long())
    hc = hc.reshape(hv.shape).cpu().numpy()
    hr = np.repeat(heavy.tile_row.cpu().numpy(), hv.shape[1]).reshape(
        hv.shape)
    keep = hv != 0
    m_heavy = sp.csr_matrix((hv[keep], (hr[keep], hc[keep])),
                            shape=(heavy.rows.shape[0], a_chunk.shape[1]))
    x_chunk_t = ops["chunk"][1]
    want_h = m_heavy.astype(np.float64) @ x_chunk.astype(np.float64)
    a_t, x_col = csr_tensor(m_heavy, dev), x_chunk_t.reshape(-1, 1)
    err = rel_err(torch.sparse.mm(a_t, x_col).reshape(-1), want_h)
    assert err < Y_RTOL, err
    # D's sums are what it adds to y: the plain version on a zero y
    d_sums = heavy_plain(heavy.vals, heavy.cols_win, heavy.bases,
                         heavy.tile_row, heavy.rows, x_chunk_t,
                         torch.zeros_like(ys["chunk"]),
                         semiring="plus_times")[heavy.rows.long()]
    assert rel_err(d_sums, want_h) < Y_RTOL
    lib_ms = min(time_ms(lambda: torch.sparse.mm(a_t, x_col)) for _ in "ab")
    rows["spmv_subwin_f32"]["library_ms"] = lib_ms
    log(f"[chunk] torch.sparse.mm of the heavy rows' CSR (float32, "
        f"{m_heavy.nnz} nnz in {m_heavy.shape[0]} rows, x as (cols, 1)): "
        f"{lib_ms:.4f} ms, rel err {err:.3g} vs float64, on {card}")
    library_device_us("chunk", "torch.sparse.mm of the heavy rows",
                      lambda: torch.sparse.mm(a_t, x_col))
    # the packed apply (kernels E and F): torch.sparse.mm of the matrix's
    # CSR over x, by events and by the profiler (F alone computes no
    # function a PyTorch call does: its input is E's scan)
    a_t, x_col = csr_tensor(scipy_of(a_packed), dev), x_pk.reshape(-1, 1)
    err = rel_err(torch.sparse.mm(a_t, x_col).reshape(-1), want64["packed"])
    assert err < Y_RTOL, err
    lib_ms = min(time_ms(lambda: torch.sparse.mm(a_t, x_col)) for _ in "ab")
    log(f"[packed] torch.sparse.mm of the matrix (CSR float32, "
        f"{a_packed.indices.shape[0]} nnz, x as (cols, 1)), beside the "
        f"apply: {lib_ms:.4f} ms, rel err {err:.3g} vs float64, on {card}")
    library_device_us("packed", "torch.sparse.mm of the matrix",
                      lambda: torch.sparse.mm(a_t, x_col))
    # the chunk light route: torch.sparse.mm of the light records as a CSR
    # (they are one: offsets by lane row, columns, values) over x, the
    # per-(segment, lane) sums the route writes; beside it the route's own
    # device time by the profiler, in the same run
    m_light = sp.csr_matrix(
        (light.vals.cpu().numpy(), light.cols.cpu().numpy(),
         light.row_off.cpu().numpy()), shape=(light_rows, a_chunk.shape[1]))
    want_l = m_light.astype(np.float64) @ x_chunk.astype(np.float64)
    a_t, x_col = csr_tensor(m_light, dev), ops["chunk"][1].reshape(-1, 1)
    err = rel_err(torch.sparse.mm(a_t, x_col).reshape(-1), want_l)
    assert err < Y_RTOL, err
    lib_ms = min(time_ms(lambda: torch.sparse.mm(a_t, x_col)) for _ in "ab")
    rows["spmv_chunk_light_f32"]["library_ms"] = lib_ms
    log(f"[chunk] torch.sparse.mm of the light records' CSR (float32, "
        f"{m_light.nnz} nnz in {m_light.shape[0]} lane rows, x as (cols, "
        f"1)): {lib_ms:.4f} ms, rel err {err:.3g} vs float64, on {card}")
    lib_us = library_device_us("chunk", "torch.sparse.mm of the light "
                               "buckets", lambda: torch.sparse.mm(a_t, x_col))
    # the route's own sums against float64: a lane row with no record is
    # 0 under plus_times, as the library's
    err = rel_err(light_kernel(light, ops["chunk"][1],
                               semiring="plus_times").reshape(-1), want_l)
    assert err < Y_RTOL, err
    route_us = library_device_us(
        "chunk", "the light route (spmv_chunk_light_f32)",
        lambda: light_kernel(light, ops["chunk"][1], semiring="plus_times"))
    log(f"[chunk] the light route against torch.sparse.mm of the same "
        f"records, profiler device time: {route_us:.2f} us against "
        f"{lib_us:.2f} us (ratio {route_us / lib_us:.3f}); route vs "
        f"float64 rel err {err:.3g}, on {card}")
    # kernel M: torch.sparse.mm of each shard's rows, their columns
    # shifted onto the shard's halo'd x, over that x; the four summed
    rps, halo = sp_dia.rows_per_shard, sp_dia.halo
    rows["spmv_dia_halo_f32"]["library_ms"] = 0.0
    for d in range(4):
        sub = band[d * rps:(d + 1) * rps]
        cols_d = sub.indices.astype(np.int64) - (d * rps - halo)
        assert cols_d.min() >= 0 and cols_d.max() < x_ext[d].shape[0]
        a_t = csr_tensor(sp.csr_matrix((sub.data, cols_d, sub.indptr),
                                       shape=(rps, x_ext[d].shape[0])), dev)
        x_col = x_ext[d].reshape(-1, 1)
        err = rel_err(torch.sparse.mm(a_t, x_col).reshape(-1),
                      want64["dia"][d * rps:(d + 1) * rps])
        assert err < Y_RTOL, (d, err)
        lib_ms = min(time_ms(lambda: torch.sparse.mm(a_t, x_col))
                     for _ in "ab")
        rows["spmv_dia_halo_f32"]["library_ms"] += lib_ms
        log(f"[sharded_dia] torch.sparse.mm of shard {d} (CSR float32 over "
            f"its halo'd x): {lib_ms:.4f} ms, rel err {err:.3g} vs "
            f"float64, on {card}")
    del a_t

    # --- the apply, end to end ----------------------------------------------
    # name: (the apply, its nonzeros, its RHS count)
    applies = {name: ((lambda op=op, x=x: op @ x), plan_nnz(op.plan),
                      x.shape[1] if x.dim() == 2 else 1)
               for name, (op, x) in ops.items()}
    for name, base in (("sharded_dia", "dia"), ("sharded_sell", "sell"),
                       ("sharded_sell_ag", "sell"),
                       ("sharded_spmm", "spmm_sell")):
        applies[name] = (more_paths[name][0],) + applies[base][1:]
    # kernel N on the random stream (no nonzeros: its rate is bytes/s)
    applies["stream_checksum"] = (
        lambda: checksum_stream(noise, STREAM_BLOCK), None, 1)
    def kernel_g(key):
        """A profiler key of kernel G or L, in either of its shapes."""
        return "global_rows_kernel" in key or "global_runs_kernel" in key

    busy_us = {}
    for name, (apply, nnz, rhs) in applies.items():
        ms = time_ms(apply)
        rate = (f"{nbytes(noise) / ms / 1e9:.4f} TB/s read" if nnz is None
                else f"{nnz * rhs / ms / 1e6:.2f} Gnnz/s (nnz={nnz}"
                f"{f' x {rhs} RHS' if rhs > 1 else ''})")
        log(f"[{name}] apply: {ms:.4f} ms -> {rate} on {card}")
        # a profiler session now and then records no device activity at
        # all (seen on the deep phase on an H100): one more session
        by_kernel = device_us_by_kernel(apply) or device_us_by_kernel(apply)
        if not by_kernel:
            log(f"[{name}] device time by kernel: not measured (the "
                f"profiler saw no device activity, twice)")
            continue
        busy = busy_us[name] = sum(us for us, _ in by_kernel.values())
        log(f"[{name}] device busy {busy:.2f} us of a {ms * 1e3:.2f} us "
            f"apply -> idle share {1 - busy / (ms * 1e3):.3f}")
        for k, (us, n) in sorted(by_kernel.items(),
                                 key=lambda kv: -kv[1][0]):
            log(f"[{name}]   {us:9.2f} us  x{n:g}  {k[:90]}")
        if name in ("spmm_sell", "spmm_hybrid", "sharded_spmm"):
            # kernel H sums its slices itself: no index_add_ of partials
            # and, on the window plan, nothing after H at all
            assert not any("indexFunc" in k for k in by_kernel), name
            assert any("spmm_runs_kernel" in k for k in by_kernel), name
            if name == "spmm_sell":
                assert len(by_kernel) == 1, by_kernel
        if name in ("deep", "stream", "wide"):
            # kernel G sums each slice and writes y's rows itself: no
            # scatter_reduce (the segment reduce) nor index_add_ after it
            assert not any("scatter" in k.lower() or "indexFunc" in k
                           for k in by_kernel), (name, by_kernel)
            assert any(kernel_g(k) for k in by_kernel), name
        if name == "deep_f64":
            # kernel L likewise: it alone, no index_add_ and no fill
            assert len(by_kernel) == 1, by_kernel
            assert kernel_g(next(iter(by_kernel))), by_kernel
        if name == "packed":
            # kernel E, then kernel F, once each, and nothing else: no
            # index_add_, gather, fill or add of the overflow COO after F
            assert sorted(n for _, n in by_kernel.values()) == [1, 1], \
                by_kernel
            assert any("packed_scan_kernel" in k for k in by_kernel) and \
                any("packed_rows_kernel" in k for k in by_kernel), by_kernel
        if name == "chunk":
            # one launch each of the light route and kernel D, and one
            # index_add_, the heavy merge's: the light buckets have none
            for kern in ("light_rows_kernel", "heavy_runs_kernel"):
                n = [n for k, (_, n) in by_kernel.items() if kern in k]
                assert n == [1], (kern, by_kernel)
            adds = sum(n for k, (_, n) in by_kernel.items()
                       if "indexFunc" in k)
            assert adds == 1, by_kernel
    for kname, plan in (("spmv_dia_f32", p_dia),
                        ("spmv_sell_window_f32", p_sell),
                        ("spmv_sell_global_f32", p_deep),
                        ("spmv_dia_f64", p_dia64),
                        ("spmv_sell_window_f64", p_sell64),
                        ("spmv_sell_global_f64", p_deep64)):
        r = rows[kname]
        nnz = plan_nnz(plan)
        log(f"{kname}: kernel {nnz / r['ms'] / 1e6:.2f} Gnnz/s, plain "
            f"{nnz / r['plain_ms'] / 1e6:.2f} Gnnz/s on {card}")

    # --- fused SpMM against k looped SpMVs and torch.sparse.mm (ROADMAP
    # item 9); the looped applies take B's columns made contiguous
    # beforehand, so each is the plain SpMV main path -------------------------
    gen = torch.Generator(device=dev).manual_seed(5)
    for name in ("dia", "sell"):
        op, a_t = ops[name][0], csr_t[name]
        for k in (8, 32, 64):
            b = torch.randn((op.shape[1], k), generator=gen, device=dev)
            cols_b = b.T.contiguous()
            fused = op @ b
            looped = torch.stack([op @ cols_b[j] for j in range(k)], dim=1)
            err = max_abs(fused, looped)
            tol = KERNEL_RTOL * max(1.0, float(looped.abs().max().item()))
            assert err <= tol, (name, k, err)
            t_f = time_ms(lambda: op @ b, iters=20)
            t_l = time_ms(lambda: [op @ cols_b[j] for j in range(k)],
                          iters=10)
            t_s = time_ms(lambda: torch.sparse.mm(a_t, b), iters=20)
            log(f"[fused-vs-looped] {name} k={k}: fused {t_f:.4f} ms, "
                f"looped {t_l:.4f} ms ({k} applies), torch.sparse.mm "
                f"{t_s:.4f} ms; looped/fused {t_l / t_f:.2f}, "
                f"sparse.mm/fused {t_s / t_f:.2f}; fused vs looped max abs "
                f"err {err:.3g} on {card}")
            del b, cols_b, fused, looped
        torch.cuda.empty_cache()

    # --- stream_checksum: the read probe on kernel N (the bandwidth every
    # roofline fraction below divides by) and the readwrite probe ---------
    checksum_stream.launches = 0
    bw_read = roofline.measure_stream_bandwidth(mode="read")
    n_probe = checksum_stream.launches
    assert n_probe > 0, n_probe
    bw_rw = roofline.measure_stream_bandwidth(mode="readwrite")
    log(f"[stream_checksum] measure_stream_bandwidth (256 MiB): read "
        f"{bw_read / 1e12:.4f} TB/s ({n_probe} launches of kernel N; "
        f"{bw_read / PEAK_BYTES_PER_S:.4f} of the data sheet's "
        f"{PEAK_BYTES_PER_S / 1e12:g} TB/s), readwrite "
        f"{bw_rw / 1e12:.4f} TB/s, on {card}")
    # every measured-bandwidth bound and audit fraction divides by kernel
    # N's rate: torch.sum's rate on a buffer of the same size tells a
    # change to kernel N apart from a change in the card
    row_n = rows["stream_checksum_f32"]
    log(f"[stream_checksum] beside the probe, on the same 256 MiB: "
        f"torch.sum {nbytes(noise) / row_n['library_ms'] / 1e9:.4f} TB/s, "
        f"kernel N (CUDA events) {nbytes(noise) / row_n['ms'] / 1e9:.4f} "
        f"TB/s, on {card}")
    # a probe above the data sheet would mean the probe is wrong
    assert 0 < bw_read < 1.05 * PEAK_BYTES_PER_S, bw_read

    # --- marginal: the two-point marginal of a chain of kernel-A applies,
    # beside the CUDA-event time of one apply -------------------------------
    op_dia, x_d = ops["dia"]

    def dia_chain(n):
        def go():
            for _ in range(n):
                y = op_dia @ x_d
            return y[:1]
        return go

    spmv_dia_kernel.launches = 0
    t_marg = roofline.time_marginal(dia_chain, i1=30, i2=90)
    n_chain = spmv_dia_kernel.launches
    assert n_chain > 0, n_chain
    ev_ms = time_ms(lambda: op_dia @ x_d)
    log(f"[marginal] time_marginal, DIA headline ({n_chain} launches of "
        f"kernel A): {t_marg * 1e6:.2f} us per apply; CUDA events "
        f"{ev_ms * 1e3:.2f} us per apply; profiler device busy "
        f"{busy_us.get('dia', float('nan')):.2f} us; on {card}")

    # --- audit: SparseOperator.audit at the measured read bandwidth --------
    for name, path in (("dia", ["spmv_dia_f32"]),
                       ("sell", ["spmv_sell_window_f32"])):
        op = ops[name][0]
        for k in kernels.values():
            k.launches = 0
        out = op.audit(stream_bw=bw_read)
        assert all(kernels[k].launches > 0 for k in path), name
        log(f"[audit] {name}: seconds {out['seconds'] * 1e6:.2f} us per "
            f"apply (profiler device busy "
            f"{busy_us.get(name, float('nan')):.2f} us), gnnz_per_s "
            f"{out['gnnz_per_s']:.4f}, achieved_gb_per_s "
            f"{out['achieved_gb_per_s']:.2f}, peak_gb_per_s "
            f"{out['peak_gb_per_s']:.2f}, roofline_fraction "
            f"{out['roofline_fraction']:.4f} (bytes_per_apply "
            f"{op.stats['bytes_per_apply']}), on {card}")
        # above 1.05 the byte model or the probe would be wrong
        assert out["roofline_fraction"] <= 1.05, (name, out)

    # every kernel's bound at the measured read bandwidth beside the one at
    # the data sheet's 3.35 TB/s
    for kname, work in bound_work.items():
        rows[kname]["bound_ms_at_measured_bw"] = 1e3 * sum(
            max(b / bw_read, o / peak) for b, o, peak in work)
        log(f"{kname}: bound {rows[kname]['bound_ms']:.5f} ms at "
            f"{PEAK_BYTES_PER_S / 1e12:g} TB/s, "
            f"{rows[kname]['bound_ms_at_measured_bw']:.5f} ms at the "
            f"measured {bw_read / 1e12:.4f} TB/s; kernel "
            f"{rows[kname]['ms']:.5f} ms")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} bytes")

    # --- the solver layer over the operator ---------------------------------
    del ops, ys, csr_t, ramp, noise
    torch.cuda.empty_cache()
    solver_phases(card, dev, kernels, launches, bw_read)

    csrc = "spmv_vector_cache_tpu_torch/csrc/"
    meta = {
        "spmv_dia_f32": ("spmv_dia.cu", "spmv_vector_cache_tpu/ops/"
                         "spmv_dia.py:63, spmv_vector_cache_tpu/ops/"
                         "spmv_dia.py:81"),
        "spmv_sell_window_f32": ("spmv_sell_window.cu",
                                 "spmv_vector_cache_tpu/ops/"
                                 "spmv_pallas.py:162"),
        "spmv_chunk_light_f32": ("spmv_chunk_light.cu", ", ".join(
            f"spmv_vector_cache_tpu/ops/spmv_pallas.py:{line}"
            for line in (162, 620))),
        "lane_unpermute_f32": ("lane_perm.cu", "spmv_vector_cache_tpu/ops/"
                               "lane_perm.py:26"),
        "spmv_subwin_f32": ("spmv_subwin.cu", "spmv_vector_cache_tpu/ops/"
                            "spmv_pallas.py:282"),
        "packed_scan_f32": ("spmv_packed.cu", "spmv_vector_cache_tpu/ops/"
                            "spmv_packed.py:44"),
        "packed_extract_f32": ("spmv_packed.cu", "spmv_vector_cache_tpu/ops/"
                               "spmv_packed.py:91"),
        "spmv_sell_global_f32": ("spmv_sell_global.cu", ", ".join(
            f"spmv_vector_cache_tpu/ops/spmv_pallas.py:{line}"
            for line in (406, 508, 581))),
        "spmm_dia_f32": ("spmm_dia.cu", "spmv_vector_cache_tpu/ops/"
                         "spmm_dia.py:36"),
        "spmm_sell_window_f32": ("spmm_sell_window.cu", ", ".join(
            f"spmv_vector_cache_tpu/ops/spmm_pallas.py:{line}"
            for line in (34, 104))),
        "spmv_dia_f64": ("spmv_dia.cu", "spmv_vector_cache_tpu/ops/"
                         "spmv_dia.py:135, spmv_vector_cache_tpu/ops/"
                         "spmv_dia.py:159"),
        "spmv_sell_window_f64": ("spmv_sell_window.cu",
                                 "spmv_vector_cache_tpu/ops/"
                                 "spmv_pallas.py:675"),
        "spmv_sell_global_f64": ("spmv_sell_global.cu",
                                 "spmv_vector_cache_tpu/ops/"
                                 "spmv_pallas.py:708"),
        "spmv_dia_halo_f32": ("spmv_dia.cu", "spmv_vector_cache_tpu/"
                              "parallel/dia_sharded.py:120"),
        "stream_checksum_f32": ("stream_checksum.cu",
                                "tests/test_backend_stream.py:26"),
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
