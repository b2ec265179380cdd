// Heavy-row subwindow SpMV for Hopper (sm_90a), plain C interface bound
// with ctypes.
//
// Replaces the Pallas kernel `_make_subwin_kernel` as run by
// `_subwin_partials` (spmv_vector_cache_tpu/ops/spmv_pallas.py), the
// ChunkPlan's heavy-row tiles; it returns what that function returns:
//   out[t, l] = (+)_p vals[t, p, l] (x) x[bases[t, p]*128 + cols_win[t, p, l]]
// per tile, (T, 128).  Each position row p of a tile has its own window
// base; x reads as 0 at columns >= cols, as in the reference's x image
// zero-padded by W blocks.  Padding slots carry the semiring's zero and
// offset 0.
//
// Bound: the nonzero stream, 6 B per slot (f32 value + int16 offset),
// read once; a position row's 128 columns are consecutive in a heavy
// row, so its x reads fall within W blocks and are served by L1/L2.
// Design: as kernel B (spmv_sell_window.cu) — one block of 128 threads
// per tile, one thread per lane, a loop over the 8 positions; the
// reference's pre-gathered W-block x windows and select tree exist only
// for Mosaic and are not carried over: x is read directly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "semiring.cuh"

namespace {

constexpr long long kBlock = 128;     // columns per x block of `bases`

template <class S>
__global__ void subwin_kernel(const float* __restrict__ vals,
                              const int16_t* __restrict__ cols_win,
                              const int* __restrict__ bases,
                              const float* __restrict__ x,
                              float* __restrict__ out, int positions,
                              int lanes, long long cols) {
    long long t = blockIdx.x;
    int lane = threadIdx.x;
    const int* base = bases + t * positions;
    long long slot = t * positions * lanes + lane;
    float acc = S::init();
    for (int p = 0; p < positions; ++p, slot += lanes) {
        long long c = (long long)__ldg(base + p) * kBlock +
                      (long long)__ldg(cols_win + slot);
        float xv = c < cols ? __ldg(x + c) : 0.0f;
        acc = S::step(acc, __ldg(vals + slot), xv);
    }
    out[t * lanes + lane] = acc;
}

}  // namespace

// semiring: a code of semiring.cuh
extern "C" int spmv_subwin_f32(const float* vals, const int16_t* cols_win,
                               const int* bases, const float* x, float* out,
                               long long tiles, int positions, int lanes,
                               long long cols, int semiring, void* stream) {
    if (tiles > 0) {
        cudaError_t err = spmv::with_semiring(semiring, [&](auto s) {
            subwin_kernel<decltype(s)>
                <<<(unsigned)tiles, lanes, 0, (cudaStream_t)stream>>>(
                    vals, cols_win, bases, x, out, positions, lanes, cols);
        });
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}
