// Value policies of the SpMV kernels A, B and G and of their float64
// builds J, K and L: how a kernel reads the value of one slot of a plan's
// value slab, and in what type it reads x and sums.
//
// A float32 plan stores one float per slot.  A double plan stores each
// value as the reference's (hi, lo) float32 pair (formats/plan.py,
// formats/dia.py): the highs fill the slab's first half along the
// position (SELL) or diagonal (DIA) axis and the lows the second half, so
// a slot's low word sits `half` floats after its high word.  PairValues
// joins the two into one double: hi + lo is exact in double (the two
// significands span at most 48 of its 53 bits), so the kernel sees the
// plan's float64 value bit for bit, and FP64 fma does the rest; the
// reference's error-free float32 transforms are not needed on Hopper.
#pragma once

#include <cuda_runtime.h>

namespace spmv {

struct F32Values {
    using T = float;
    static constexpr int kChannels = 1;
    static __device__ float load(const float* v, long long /*half*/) {
        return __ldg(v);
    }
};

struct PairValues {
    using T = double;
    static constexpr int kChannels = 2;
    static __device__ double load(const float* v, long long half) {
        return (double)__ldg(v) + (double)__ldg(v + half);
    }
};

// acc + v * x, rounded once, in the policy's type
__device__ inline float madd(float v, float x, float acc) {
    return fmaf(v, x, acc);
}
__device__ inline double madd(double v, double x, double acc) {
    return fma(v, x, acc);
}

// plus_times over float64, the one semiring of the double plans, with
// the add, atomic and finish of semiring.cuh's float32 semirings (kernel
// L combines a split slice's pieces with a float64 atomicAdd)
struct PlusTimesF64 {
    static __device__ double init() { return 0.0; }
    static __device__ double step(double acc, double v, double x) {
        return madd(v, x, acc);
    }
    static __device__ double add(double a, double b) { return a + b; }
    static __device__ void atomic(double* p, double v) { atomicAdd(p, v); }
    static __device__ double finish(double v) { return v; }
};

}  // namespace spmv
