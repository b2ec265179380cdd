// SELL SpMV over global column ids for Hopper (sm_90a), plain C interface
// bound with ctypes: kernel G (float32, five semirings) and its float64
// build, kernel L (plus_times).
//
// Kernel G replaces three Pallas kernels of
// spmv_vector_cache_tpu/ops/spmv_pallas.py, which compute one function and
// differ only in where x lives on a TPU: `_make_resident_kernel` (x in
// VMEM, a select tree over <= 64 blocks), `_make_deep_kernel` (a loop over
// <= 2048 VMEM blocks) and `_make_stream_kernel` (x gathered by XLA before
// the kernel).  It returns what `ops/spmv_sell.py` `_spmv_global` hands to
// `_reduce_partials` on each of the three routes:
//   per tile   out[t, l] = (+)_p  vals[t, p, l] (x) x[cols[t, p, l]]   (T, R)
//   per group  out[g, l] = (+)_{t in g, p} ...                     (T/wg, R)
// x reads as 0 at a column >= cols, as in the reference's zero-padded x
// image; padding slots carry column 0 and the semiring's zero.
//
// Kernel L replaces the double-float stream kernel `_make_stream_kernel_df`
// (run by `_spmv_stream_df` over hi/lo x pre-gathered at `cols`): per-tile
// sums over a double plan, whose vals are (T, 2P, R) hi/lo float32 pairs
// (values.cuh) while cols stays (T, P, R), reading a float64 x at `cols`
// directly and writing float64 partials.  The port runs every windowless
// double plan on it, whatever strategy name the operator hands over.
//
// Bound: the nonzero stream, 8 B per slot (f32 value + int32 column; 12 B
// in L), read once.  A Hopper thread reads x[c] from device memory through
// L1/L2 (x of a resident or deep plan is at most 1 MB, 2 MB in float64,
// and stays in the 50 MB L2), so one kernel serves all three routes and
// the stream route builds no pre-gathered x.  Design: one thread per
// output lane, neighbouring threads on neighbouring lanes, so every
// vals/cols load of a warp is 128 contiguous bytes; each thread walks its
// row's tiles and positions.  All five semirings are one template on the
// (init, step) pairs of semiring.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "semiring.cuh"
#include "values.cuh"

namespace {

constexpr int kThreads = 256;

// thread i computes output element i = row * lanes + lane; a row is a
// tile (tiles_per_row = 1) or a group of wg tiles (tiles_per_row = wg).
template <class S, class V>
__global__ void global_kernel(const float* __restrict__ vals,
                              const int* __restrict__ cols,
                              const typename V::T* __restrict__ x,
                              typename V::T* __restrict__ out,
                              long long n_out, int positions, int lanes,
                              int tiles_per_row, long long ncols) {
    using T = typename V::T;
    long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n_out) return;
    long long row = i / lanes;
    int lane = (int)(i - row * lanes);
    const long long pr = (long long)positions * lanes;  // one channel
    long long t0 = row * tiles_per_row;
    long long slot = t0 * pr + lane;
    const float* v = vals + t0 * V::kChannels * pr + lane;
    T acc = S::init();
    for (int tt = 0; tt < tiles_per_row; ++tt, v += (V::kChannels - 1) * pr) {
#pragma unroll 8
        for (int p = 0; p < positions; ++p, slot += lanes, v += lanes) {
            long long c = __ldg(cols + slot);
            T xv = (c >= 0 && c < ncols) ? __ldg(x + c) : T(0);
            acc = S::step(acc, V::load(v, pr), xv);
        }
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
            global_kernel<decltype(s), spmv::F32Values>
                <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
                    vals, cols, x, out, n_out, positions, lanes, tpr,
                    ncols);
        });
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

// vals: the double plan's (tiles, 2*positions, lanes) hi/lo slab; cols:
// (tiles, positions, lanes); x: float64; out: (tiles, lanes) float64
// per-tile partials; plus_times
extern "C" int spmv_sell_global_f64(const float* vals, const int* cols,
                                    const double* x, double* out,
                                    long long tiles, int positions,
                                    int lanes, long long ncols,
                                    void* stream) {
    long long n_out = tiles * lanes;
    if (n_out > 0) {
        unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
        global_kernel<spmv::PlusTimesF64, spmv::PairValues>
            <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
                vals, cols, x, out, n_out, positions, lanes, 1, ncols);
    }
    return (int)cudaGetLastError();
}
