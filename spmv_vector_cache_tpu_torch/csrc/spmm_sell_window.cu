// SELL window SpMM for Hopper (sm_90a), plain C interface bound with
// ctypes: kernel H.
//
// Replaces the Pallas kernel `_make_spmm_kernel` and its operand builder
// `_bt_windows`, as run by `_spmm_window`
// (spmv_vector_cache_tpu/ops/spmm_pallas.py).  With B of shape (cols, k),
// row-major as the caller hands it, it writes row-major
//   per tile   out[t, l, j] = sum_p  vals[t, p, l] * B[c(t, p, l), j]
//                                                          (T, R, k)
//   per group  out[g, l, j] = sum_{t in g, p} ...       (T/wg, R, k)
// with c = window_base[t / wg] * window_grain + cols_win[t, p, l], as in
// kernel B (spmv_sell_window.cu).  B reads as 0 at c >= cols (padding
// slots may point past the last column); columns j >= k are neither
// read nor written.  The reference builds a transposed B, a k8-padded
// copy and an overlapped grain image of it, all for Mosaic's aligned
// window slices; here B is read where it lies, and `ops/spmm_sell.py`
// reduces the partials as kernel B's are reduced (tiles or groups to
// slices, then the sub-row fixup), over a trailing k axis.
//
// Bound: bytes — the nonzero stream, 6 B per slot (f32 value + int16
// offset), read once per block of up to 8 RHS chunks, the B rows the
// slots name and the partials.  B is gathered through L1/L2: a group's
// window spans at most K*128 rows of B.  Design: a block of R (=128)
// lanes by up to 8 RHS chunks per output row (a tile, or a group when
// folding); one thread per (lane, chunk) keeps its chunk's C sums in
// registers and walks the positions (and the group's tiles when
// folding).  A warp's value and offset loads are 32 contiguous slots;
// its B loads are one 32-byte sector per slot at C = 8.  The warps of
// one block read the same slots, so the slot stream leaves device memory
// once for up to 64 RHS.  plus_times only, as the reference kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "spmm_rhs.cuh"

namespace {

// blockIdx.x = output row: a tile (tiles_per_row = 1) or a group
// (tiles_per_row = wg); threadIdx.x = lane; blockIdx.y * blockDim.y +
// threadIdx.y = RHS chunk.
template <int C, bool VEC>
__global__ void spmm_window_kernel(const float* __restrict__ vals,
                                   const int16_t* __restrict__ cols_win,
                                   const int* __restrict__ window_base,
                                   const float* __restrict__ b,
                                   float* __restrict__ out, int positions,
                                   int lanes, int group_tiles,
                                   int tiles_per_row, int window_grain,
                                   long long cols, int k, int nchunk) {
    int ch = blockIdx.y * blockDim.y + threadIdx.y;
    if (ch >= nchunk) return;
    int j0 = ch * C;
    int n = min(C, k - j0);
    long long row = blockIdx.x;
    int lane = threadIdx.x;
    long long t0 = row * tiles_per_row;
    long long base =
        (long long)__ldg(window_base + t0 / group_tiles) * window_grain;
    long long slot = t0 * positions * lanes + lane;
    int np = tiles_per_row * positions;
    float acc[C];
#pragma unroll
    for (int i = 0; i < C; ++i) acc[i] = 0.0f;
    for (int p = 0; p < np; ++p, slot += lanes) {
        long long c = base + (long long)__ldg(cols_win + slot);
        float w = __ldg(vals + slot);
        float bv[C];
        if (c < cols) {
            spmm::load<C, VEC>(b + c * k + j0, n, bv);
        } else {
#pragma unroll
            for (int i = 0; i < C; ++i) bv[i] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < C; ++i) acc[i] = fmaf(w, bv[i], acc[i]);
    }
    spmm::store<C, VEC>(out + (row * lanes + lane) * k + j0, n, acc);
}

}  // namespace

extern "C" int spmm_sell_window_f32(const float* vals,
                                    const int16_t* cols_win,
                                    const int* window_base, const float* b,
                                    float* out, long long out_rows,
                                    int positions, int lanes,
                                    int group_tiles, int fold,
                                    int window_grain, long long cols, int k,
                                    void* stream) {
    bool aligned = (uintptr_t)b % 16 == 0 && (uintptr_t)out % 16 == 0;
    int tpr = fold ? group_tiles : 1;
    cudaError_t err = spmm::with_chunk(k, aligned, [&](auto ch) {
        using Ch = decltype(ch);
        int nchunk = (k + Ch::C - 1) / Ch::C;
        if (out_rows <= 0 || lanes <= 0) return;
        int per_block = std::min(nchunk, std::max(1, 1024 / lanes));
        dim3 grid((unsigned)out_rows,
                  (unsigned)((nchunk + per_block - 1) / per_block));
        dim3 block((unsigned)lanes, (unsigned)per_block);
        spmm_window_kernel<Ch::C, Ch::VEC>
            <<<grid, block, 0, (cudaStream_t)stream>>>(
                vals, cols_win, window_base, b, out, positions, lanes,
                group_tiles, tpr, window_grain, cols, k, nchunk);
    });
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
