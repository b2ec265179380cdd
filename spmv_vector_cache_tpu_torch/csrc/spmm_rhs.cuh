// Right-hand-side chunks of the DIA SpMM kernel I: C consecutive
// columns of one row of a row-major (n, k) float32 matrix, held in
// registers.  A chunk is C = the power of two >= k, at most 8 (one
// 32-byte sector at C = 8); the last chunk of a row may hold fewer than
// C columns, and those past k are neither read nor written.
#pragma once

#include <cuda_runtime.h>

namespace spmm {

template <int C_, bool VEC_>
struct Chunk {
    static constexpr int C = C_;
    // every chunk is whole and 16-byte aligned: float4 loads and stores
    static constexpr bool VEC = VEC_;
};

// v[0:C] = p[0:n], 0 past n (n <= C).
template <int C, bool VEC>
__device__ __forceinline__ void load(const float* __restrict__ p, int n,
                                     float (&v)[C]) {
    if constexpr (VEC) {
#pragma unroll
        for (int i = 0; i < C; i += 4) {
            float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
            v[i] = q.x;
            v[i + 1] = q.y;
            v[i + 2] = q.z;
            v[i + 3] = q.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < C; ++i) v[i] = i < n ? __ldg(p + i) : 0.0f;
    }
}

// p[0:n] = v[0:n] (n <= C).
template <int C, bool VEC>
__device__ __forceinline__ void store(float* __restrict__ p, int n,
                                      const float (&v)[C]) {
    if constexpr (VEC) {
#pragma unroll
        for (int i = 0; i < C; i += 4)
            *reinterpret_cast<float4*>(p + i) =
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else {
#pragma unroll
        for (int i = 0; i < C; ++i)
            if (i < n) p[i] = v[i];
    }
}

// The chunk width for k right-hand sides.
inline int chunk_width(int k) { return k >= 8 ? 8 : k > 2 ? 4 : k; }

// Calls launch(Chunk<C, VEC>{}) for k right-hand sides; VEC when C is a
// multiple of 4 that divides k and both matrices are 16-byte aligned
// (`aligned`).  k < 1 is cudaErrorInvalidValue.
template <class F>
cudaError_t with_chunk(int k, bool aligned, F&& launch) {
    if (k < 1) return cudaErrorInvalidValue;
    int c = chunk_width(k);
    bool vec = aligned && k % c == 0;
    switch (c) {
        case 1: launch(Chunk<1, false>{}); break;
        case 2: launch(Chunk<2, false>{}); break;
        case 4:
            if (vec) launch(Chunk<4, true>{});
            else launch(Chunk<4, false>{});
            break;
        default:
            if (vec) launch(Chunk<8, true>{});
            else launch(Chunk<8, false>{});
    }
    return cudaSuccess;
}

}  // namespace spmm
