// In-block lane un-permutation for Hopper (sm_90a), plain C interface
// bound with ctypes.
//
// Replaces the Pallas kernel `_kernel` of `lane_unpermute`
// (spmv_vector_cache_tpu/ops/lane_perm.py), the ChunkPlan's row fixup:
//   out[s*128 + l] = y2d[(s/8)*1024 + idx[s, l]]
// for y2d of (S, 128) float32 with S % 8 == 0 and idx int16 in [0, 1024).
// The one-block reach holds because the ChunkPlan sorts rows within
// aligned windows of exactly 1024 rows (formats/chunk.py CHUNK_SIGMA).
//
// Bound: bytes, 10 per element (int16 index, float32 read and write).
// Design: one thread per output element; neighbouring threads read
// neighbouring indices and write neighbouring outputs (coalesced), and
// the gathered reads stay inside one 4 KB block of y2d.  The reference's
// 8 in-lane gathers merged by selects exist only for Mosaic and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void lane_unpermute_kernel(const float* __restrict__ y2d,
                                      const int16_t* __restrict__ idx,
                                      float* __restrict__ out,
                                      long long n) {
    long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    long long block = i >> 10;               // aligned 8-row block of i
    out[i] = __ldg(y2d + (block << 10) + __ldg(idx + i));
}

}  // namespace

// n = S * 128 elements
extern "C" int lane_unpermute_f32(const float* y2d, const int16_t* idx,
                                  float* out, long long n, void* stream) {
    if (n > 0) {
        long long blocks = (n + kThreads - 1) / kThreads;
        lane_unpermute_kernel<<<(unsigned)blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(y2d, idx, out, n);
    }
    return (int)cudaGetLastError();
}
