// DIA SpMV for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas kernels `_make_dia_kernel` and
// `_make_dia_kernel_windowed` (spmv_vector_cache_tpu/ops/spmv_dia.py),
// which compute the same function with x resident in VMEM or streamed in
// sliding blocks; that choice is a VMEM-capacity one the card does not
// have, so one kernel serves both.
//
// y[r] = sum_k vals[t, k, i, l] * x[r + off_k], r = t*S*128 + i*128 + l,
// where x reads as 0 outside [0, cols) (the reference's zero-padded x
// image).  Only rows below `rows` are written.
//
// Bound: the value stream, 4 B per stored slot, read once; x is re-read
// D times but from L1/L2 (neighbouring diagonals touch neighbouring
// addresses).  Design: one thread per row, so neighbouring threads read
// neighbouring `vals` and `x` addresses (coalesced); the k-sum runs in
// the order of the plain PyTorch version; the offsets are a small int32
// device array read through the read-only cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void spmv_dia_kernel(const float* __restrict__ vals,
                                const float* __restrict__ x,
                                const int* __restrict__ offsets,
                                float* __restrict__ y,
                                long long rows, long long cols, int ndiag,
                                int rows_per_step) {
    long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    long long t = r / rows_per_step;
    long long rem = r - t * rows_per_step;
    const float* v = vals + t * ndiag * (long long)rows_per_step + rem;
    float acc = 0.0f;
    for (int k = 0; k < ndiag; ++k) {
        long long c = r + __ldg(offsets + k);
        float xv = (c >= 0 && c < cols) ? __ldg(x + c) : 0.0f;
        acc = fmaf(__ldg(v + (long long)k * rows_per_step), xv, acc);
    }
    y[r] = acc;
}

}  // namespace

extern "C" int spmv_dia_f32(const float* vals, const float* x,
                            const int* offsets, float* y, long long rows,
                            long long cols, int ndiag, int rows_per_step,
                            void* stream) {
    if (rows > 0) {
        const int threads = 256;
        long long blocks = (rows + threads - 1) / threads;
        spmv_dia_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
            vals, x, offsets, y, rows, cols, ndiag, rows_per_step);
    }
    return (int)cudaGetLastError();
}
