// SELL window SpMV for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas kernel `_make_window_kernel` with its helper
// `_gather_window` (spmv_vector_cache_tpu/ops/spmv_pallas.py), as run by
// `_window_partials`; it returns exactly what that function returns:
//   per tile   out[t, l] = (+)_p  vals[t, p, l] (x) x[c(t, p, l)]     (T, R)
//   per group  out[g, l] = (+)_{t in g, p} ...                   (T/wg, R)
// with c = window_base[t / wg] * window_grain + cols_win[t, p, l].  x
// reads as 0 at c >= cols, as in the reference's zero-padded x image;
// the reference's overlapped xw image and select trees exist only for
// Mosaic's aligned slices and are not carried over: x is gathered
// directly.  Padding slots carry the semiring's zero and offset 0.
//
// Bound: the nonzero stream, 6 B per slot (f32 value + int16 offset),
// read once; x is gathered from L1/L2 because a window spans at most
// K*128 columns.  Design: one block of R (=128) threads per tile (or per
// group when folding), one thread per lane; each thread loops over the
// positions (and over the group's tiles when folding), so a warp reads
// 32 consecutive values and offsets (coalesced).  All five semirings are
// one template on the (init, step) pairs of semiring.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "semiring.cuh"

namespace {

// blockIdx.x = output row: a tile (tiles_per_row = 1) or a group
// (tiles_per_row = wg); threadIdx.x = lane.
template <class S>
__global__ void window_kernel(const float* __restrict__ vals,
                              const int16_t* __restrict__ cols_win,
                              const int* __restrict__ window_base,
                              const float* __restrict__ x,
                              float* __restrict__ out, int positions,
                              int lanes, int group_tiles, int tiles_per_row,
                              int window_grain, long long cols) {
    long long row = blockIdx.x;
    int lane = threadIdx.x;
    long long t0 = row * tiles_per_row;
    long long base =
        (long long)__ldg(window_base + t0 / group_tiles) * window_grain;
    long long slot = t0 * positions * lanes + lane;
    int n = tiles_per_row * positions;
    float acc = S::init();
    for (int p = 0; p < n; ++p, slot += lanes) {
        long long c = base + (long long)__ldg(cols_win + slot);
        float xv = c < cols ? __ldg(x + c) : 0.0f;
        acc = S::step(acc, __ldg(vals + slot), xv);
    }
    out[row * lanes + lane] = acc;
}

}  // namespace

// semiring: a code of semiring.cuh
extern "C" int spmv_sell_window_f32(const float* vals,
                                    const int16_t* cols_win,
                                    const int* window_base, const float* x,
                                    float* out, long long out_rows,
                                    int positions, int lanes,
                                    int group_tiles, int fold,
                                    int window_grain, long long cols,
                                    int semiring, void* stream) {
    if (out_rows > 0) {
        int tpr = fold ? group_tiles : 1;
        cudaError_t err = spmv::with_semiring(semiring, [&](auto s) {
            window_kernel<decltype(s)>
                <<<(unsigned)out_rows, lanes, 0, (cudaStream_t)stream>>>(
                    vals, cols_win, window_base, x, out, positions, lanes,
                    group_tiles, tpr, window_grain, cols);
        });
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
