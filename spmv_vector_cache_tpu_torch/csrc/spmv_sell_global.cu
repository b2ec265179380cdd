// SELL SpMV over global column ids for Hopper (sm_90a), plain C interface
// bound with ctypes: kernel G.
//
// Replaces three Pallas kernels of spmv_vector_cache_tpu/ops/spmv_pallas.py,
// which compute one function and differ only in where x lives on a TPU:
// `_make_resident_kernel` (x in VMEM, a select tree over <= 64 blocks),
// `_make_deep_kernel` (a loop over <= 2048 VMEM blocks) and
// `_make_stream_kernel` (x gathered by XLA before the kernel).  It returns
// what `ops/spmv_sell.py` `_spmv_global` hands to `_reduce_partials` on
// each of the three routes:
//   per tile   out[t, l] = (+)_p  vals[t, p, l] (x) x[cols[t, p, l]]   (T, R)
//   per group  out[g, l] = (+)_{t in g, p} ...                     (T/wg, R)
// x reads as 0 at a column >= cols, as in the reference's zero-padded x
// image; padding slots carry column 0 and the semiring's zero.
//
// Bound: the nonzero stream, 8 B per slot (f32 value + int32 column),
// read once.  A Hopper thread reads x[c] from device memory through
// L1/L2 (x of a resident or deep plan is at most 1 MB and stays in the
// 50 MB L2), so one kernel serves all three routes and the stream route
// builds no pre-gathered x.  Design: one thread per output lane,
// neighbouring threads on neighbouring lanes, so every vals/cols load of
// a warp is 128 contiguous bytes; each thread walks its row's positions
// (and its group's tiles when folding).  All five semirings are one
// template on the (init, step) pairs of semiring.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;

// thread i computes output element i = row * lanes + lane; a row is a
// tile (tiles_per_row = 1) or a group of wg tiles (tiles_per_row = wg).
template <class S>
__global__ void global_kernel(const float* __restrict__ vals,
                              const int* __restrict__ cols,
                              const float* __restrict__ x,
                              float* __restrict__ out, long long n_out,
                              int positions, int lanes, int tiles_per_row,
                              long long ncols) {
    long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n_out) return;
    long long row = i / lanes;
    int lane = (int)(i - row * lanes);
    int n = tiles_per_row * positions;
    long long slot = row * n * lanes + lane;
    float acc = S::init();
#pragma unroll 8
    for (int p = 0; p < n; ++p) {
        long long s = slot + (long long)p * lanes;
        long long c = __ldg(cols + s);
        float xv = (c >= 0 && c < ncols) ? __ldg(x + c) : 0.0f;
        acc = S::step(acc, __ldg(vals + s), xv);
    }
    out[i] = acc;
}

}  // namespace

// vals, cols: (tiles, positions, lanes); out: (out_rows, lanes) with
// out_rows = tiles / group_tiles when fold, else tiles.
// semiring: a code of semiring.cuh
extern "C" int spmv_sell_global_f32(const float* vals, const int* cols,
                                    const float* x, float* out,
                                    long long out_rows, int positions,
                                    int lanes, int group_tiles, int fold,
                                    long long ncols, int semiring,
                                    void* stream) {
    long long n_out = out_rows * lanes;
    if (n_out > 0) {
        int tpr = fold ? group_tiles : 1;
        unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
        cudaError_t err = spmv::with_semiring(semiring, [&](auto s) {
            global_kernel<decltype(s)>
                <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
                    vals, cols, x, out, n_out, positions, lanes, tpr,
                    ncols);
        });
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
