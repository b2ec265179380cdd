// DIA SpMM for Hopper (sm_90a), plain C interface bound with ctypes:
// kernel I.
//
// Replaces the Pallas kernel `_make_dia_spmm_kernel`, run by `_spmm_dia`
// (spmv_vector_cache_tpu/ops/spmm_dia.py).  With B of shape (cols, k),
// row-major as the caller hands it,
//   Y[r, j] = sum_d vals[t, d, i, l] * B[r + off_d, j],
//   r = t*S*128 + i*128 + l,
// summed over the diagonals in plan order, where B reads as 0 outside
// rows [0, cols).  Y (rows, k) is written row-major, straight: there is
// no transposed, zero-padded B image and no (k8, T, 8, S, 128) output
// to relayout, both of which the reference builds for Mosaic.
//
// Bound: bytes — the value slab (4 B per stored slot), B and Y, each
// once; B's rows are re-read once per diagonal, from L1/L2 (neighbouring
// diagonals touch neighbouring rows).  Design: one thread per (row, RHS
// chunk), the chunk index fastest, so a warp's B loads and Y stores are
// contiguous runs of whole rows and its value loads are contiguous; the
// thread keeps its chunk's C sums in registers.  With C = 8 a chunk is
// one 32-byte sector (two float4 loads when k is a multiple of 8).

#include <cuda_runtime.h>
#include <stdint.h>

#include "spmm_rhs.cuh"

namespace {

template <int C, bool VEC>
__global__ void spmm_dia_kernel(const float* __restrict__ vals,
                                const float* __restrict__ b,
                                const int* __restrict__ offsets,
                                float* __restrict__ y, long long rows,
                                long long cols, int k, int nchunk, int ndiag,
                                int rows_per_step) {
    long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long r = tid / nchunk;
    if (r >= rows) return;
    int j0 = (int)(tid - r * nchunk) * C;
    int n = min(C, k - j0);
    long long t = r / rows_per_step;
    long long rem = r - t * rows_per_step;
    const float* v = vals + t * ndiag * (long long)rows_per_step + rem;
    float acc[C];
#pragma unroll
    for (int i = 0; i < C; ++i) acc[i] = 0.0f;
    for (int d = 0; d < ndiag; ++d) {
        long long c = r + __ldg(offsets + d);
        float w = __ldg(v + (long long)d * rows_per_step);
        float bv[C];
        if (c >= 0 && c < cols) {
            spmm::load<C, VEC>(b + c * k + j0, n, bv);
        } else {
#pragma unroll
            for (int i = 0; i < C; ++i) bv[i] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < C; ++i) acc[i] = fmaf(w, bv[i], acc[i]);
    }
    spmm::store<C, VEC>(y + r * k + j0, n, acc);
}

}  // namespace

extern "C" int spmm_dia_f32(const float* vals, const float* b,
                            const int* offsets, float* y, long long rows,
                            long long cols, int k, int ndiag,
                            int rows_per_step, void* stream) {
    bool aligned = (uintptr_t)b % 16 == 0 && (uintptr_t)y % 16 == 0;
    cudaError_t err = spmm::with_chunk(k, aligned, [&](auto ch) {
        using Ch = decltype(ch);
        int nchunk = (k + Ch::C - 1) / Ch::C;
        long long threads = rows * nchunk;
        if (threads <= 0) return;
        const int block = 256;
        spmm_dia_kernel<Ch::C, Ch::VEC>
            <<<(unsigned)((threads + block - 1) / block), block, 0,
               (cudaStream_t)stream>>>(vals, b, offsets, y, rows, cols, k,
                                       nchunk, ndiag, rows_per_step);
    });
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
