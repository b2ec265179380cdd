// Semirings of the SELL kernels (B, D and G), as (init, step) pairs over
// float32: step(acc, v, x) = acc (+) (v (x) x).  The boolean semiring
// runs on a {0, 1} float encoding (and = *, or = max), so it shares
// max_times.  Codes match ops/semiring.py KERNEL_CODE:
// 0 plus_times, 1 min_plus, 2 max_plus, 3 max_times, 4 or_and.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace spmv {

struct PlusTimes {
    static __device__ float init() { return 0.0f; }
    static __device__ float step(float acc, float v, float x) {
        return fmaf(v, x, acc);
    }
};
struct MinPlus {
    static __device__ float init() { return INFINITY; }
    static __device__ float step(float acc, float v, float x) {
        return fminf(acc, v + x);
    }
};
struct MaxPlus {
    static __device__ float init() { return -INFINITY; }
    static __device__ float step(float acc, float v, float x) {
        return fmaxf(acc, v + x);
    }
};
struct MaxTimes {
    static __device__ float init() { return -INFINITY; }
    static __device__ float step(float acc, float v, float x) {
        return fmaxf(acc, v * x);
    }
};

// Calls launch(S{}) with the semiring of `code`; an unknown code is
// cudaErrorInvalidValue.
template <class F>
cudaError_t with_semiring(int code, F&& launch) {
    switch (code) {
        case 0: launch(PlusTimes{}); return cudaSuccess;
        case 1: launch(MinPlus{}); return cudaSuccess;
        case 2: launch(MaxPlus{}); return cudaSuccess;
        case 3:
        case 4: launch(MaxTimes{}); return cudaSuccess;
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace spmv
