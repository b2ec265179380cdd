// In-block lane un-permutation for Hopper (sm_90a), plain C interface
// bound with ctypes: kernel C.
//
// Replaces the Pallas kernel `_kernel` of `lane_unpermute`
// (spmv_vector_cache_tpu/ops/lane_perm.py), the ChunkPlan's row fixup:
//   out[s*128 + l] = y2d[(s/8)*1024 + idx[s, l]]
// for y2d of (S, 128) float32 with S % 8 == 0 and idx int16 in [0, 1024).
// The one-block reach holds because the ChunkPlan sorts rows within
// aligned windows of exactly 1024 rows (formats/chunk.py CHUNK_SIGMA).
//
// Bound: bytes, 10 per element (int16 index, float32 read and write);
// at the chunk phase's 1.7 MB the launch itself is most of the time,
// and on the host an output allocation costs more than the kernel
// (PERF.md).  Design: one CTA per aligned 8-row block (1024 elements),
// 128 threads of 8 consecutive elements each: the block's 4 KB of y2d
// comes into shared memory (two float4 loads a thread), then one
// 16-byte load of 8 indices, 8 gathers from shared memory and two
// float4 stores.  A CTA reads its whole block before any thread writes,
// so `out` may be `y2d` itself: the ChunkPlan apply un-permutes its own
// block sums in place and allocates nothing.  The reference's 8 in-lane
// gathers merged by selects exist only for Mosaic and are not carried
// over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;              // elements of an aligned 8-row block
constexpr int kThreads = kBlock / 8;      // 8 elements per thread

__global__ void __launch_bounds__(kThreads)
lane_unpermute_kernel(const float* y2d, const int16_t* __restrict__ idx,
                      float* out) {
    __shared__ __align__(16) float blk[kBlock];
    const long long b0 = (long long)blockIdx.x * kBlock;
    const int e = threadIdx.x * 8;
    const float4* src = reinterpret_cast<const float4*>(y2d + b0 + e);
    float4* dst = reinterpret_cast<float4*>(blk + e);
    dst[0] = src[0];
    dst[1] = src[1];
    const int4 iv = __ldg(reinterpret_cast<const int4*>(idx + b0 + e));
    __syncthreads();              // the whole block read: out may alias y2d
    const unsigned w[4] = {(unsigned)iv.x, (unsigned)iv.y, (unsigned)iv.z,
                           (unsigned)iv.w};
    float v[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v[2 * i] = blk[w[i] & 0xffffu];
        v[2 * i + 1] = blk[w[i] >> 16];
    }
    float4* o = reinterpret_cast<float4*>(out + b0 + e);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
}

}  // namespace

// n = S * 128 elements, a multiple of 1024; y2d, idx and out 16-byte
// aligned; out == y2d un-permutes in place.
extern "C" int lane_unpermute_f32(const float* y2d, const int16_t* idx,
                                  float* out, long long n, void* stream) {
    if (n % kBlock) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)y2d % 16 || (uintptr_t)idx % 16 || (uintptr_t)out % 16)
        return (int)cudaErrorMisalignedAddress;
    if (n > 0)
        lane_unpermute_kernel<<<(unsigned)(n / kBlock), kThreads, 0,
                                (cudaStream_t)stream>>>(y2d, idx, out);
    return (int)cudaGetLastError();
}
