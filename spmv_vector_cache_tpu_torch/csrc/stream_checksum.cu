// Stream checksum for Hopper (sm_90a), plain C interface bound with
// ctypes: kernel N.
//
// Kernel N replaces `_checksum_stream` (tests/test_backend_stream.py), the
// reference's streaming-pipeline checksum (its StreamReducer role): a
// (T, P, R) float32 stream is cut into checksum blocks of `block` tiles,
// and each block reduces to one float32 sum.  The same pass is the
// port's bandwidth probe (utils/roofline.py, measure_stream_bandwidth),
// so it must read at the card's full rate: every roofline fraction the
// port reports divides by what it measures.
//
// Bound: the bytes of the stream, each read once (the sums written are
// 1/(block*P*R) of that).  Design: a streaming reduction, one CTA per
// checksum block.  Each thread issues 16-byte loads (float4), kUnroll of
// them in flight before it adds any, with the evict-first cache hint (the
// stream is read once), looping over the whole block; four accumulators
// per thread keep the adds independent; a warp-shuffle tree and one
// shared-memory step reduce the CTA to the block's sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float quad_sum(float4 v) {
    return (v.x + v.y) + (v.z + v.w);
}

// one CTA: the block_vec4 float4s of checksum block blockIdx.x, reduced
// to one float written to out[blockIdx.x]
__global__ void __launch_bounds__(kThreads)
stream_checksum_kernel(const float4* __restrict__ data,
                       float* __restrict__ out, long long block_vec4) {
    __shared__ float warp_part[kThreads / 32];
    const float4* p = data + (long long)blockIdx.x * block_vec4;
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = 0.f;
    long long i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < block_vec4;
         i += kUnroll * kThreads) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(p + i + u * kThreads);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc[u] += quad_sum(v[u]);
    }
    for (; i < block_vec4; i += kThreads) acc[0] += quad_sum(__ldcs(p + i));
    float s = warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_part[warp] = s;
    __syncthreads();
    if (warp == 0) {
        s = warp_sum(lane < kThreads / 32 ? warp_part[lane] : 0.f);
        if (lane == 0) out[blockIdx.x] = s;
    }
}

}  // namespace

// data: (num_blocks * block_elems) float32, 16-byte aligned, block_elems a
// multiple of 4; out: (num_blocks,) float32
extern "C" int stream_checksum_f32(const float* data, float* out,
                                   long long num_blocks,
                                   long long block_elems, void* stream) {
    if (num_blocks > 0 && block_elems > 0) {
        stream_checksum_kernel<<<(unsigned)num_blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
            reinterpret_cast<const float4*>(data), out, block_elems / 4);
    }
    return (int)cudaGetLastError();
}
