// Value policies of the SpMV and SpMM kernels: how a kernel reads the
// value of one slot of a plan's value slab (its `Slot` type), and in what
// type `T` it reads x and sums.
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
//
// A bfloat16 plan stores 2 bytes a slot; Bf16Values widens each exactly
// (the bf16 bits are the high half of the float32's) and the kernel reads
// x and sums in float32, as the reference does (`_compute_dtype`), so
// its float32 code path serves it with half the value bytes.  An int32 or
// uint32 plan sums in its own type, wrapping mod 2^32 as the reference's
// int32 and uint32 sums do: the arithmetic below runs in unsigned, where
// wrapping is defined, and reinterprets.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spmv {

struct F32Values {
    using T = float;
    using Slot = float;
    static constexpr int kChannels = 1;
    static __device__ float load(const float* v, long long /*half*/) {
        return __ldg(v);
    }
};

struct PairValues {
    using T = double;
    using Slot = float;
    static constexpr int kChannels = 2;
    static __device__ double load(const float* v, long long half) {
        return (double)__ldg(v) + (double)__ldg(v + half);
    }
};

struct Bf16Values {
    using T = float;
    using Slot = uint16_t;
    static constexpr int kChannels = 1;
    static __device__ float load(const uint16_t* v, long long /*half*/) {
        return __uint_as_float((unsigned)__ldg(v) << 16);
    }
};

struct I32Values {
    using T = int;
    using Slot = int;
    static constexpr int kChannels = 1;
    static __device__ int load(const int* v, long long /*half*/) {
        return __ldg(v);
    }
};

struct U32Values {
    using T = unsigned;
    using Slot = unsigned;
    static constexpr int kChannels = 1;
    static __device__ unsigned load(const unsigned* v, long long /*half*/) {
        return __ldg(v);
    }
};

// a stored slot as the sum type, outside a kernel's load path (kernel I
// widens staged bf16 values with it)
__device__ inline float widen(uint16_t v) {
    return __uint_as_float((unsigned)v << 16);
}
template <class T>
__device__ inline T widen(T v) {
    return v;
}

// acc + v * x, rounded once, in the policy's type; integers wrap
__device__ inline float madd(float v, float x, float acc) {
    return fmaf(v, x, acc);
}
__device__ inline double madd(double v, double x, double acc) {
    return fma(v, x, acc);
}
__device__ inline int madd(int v, int x, int acc) {
    return (int)((unsigned)v * (unsigned)x + (unsigned)acc);
}
__device__ inline unsigned madd(unsigned v, unsigned x, unsigned acc) {
    return v * x + acc;
}

// a + b and a * b, each rounded to nearest (no fma contraction: kernels
// E and F keep the reference's separate product and sums); integers wrap
__device__ inline float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ inline int add_rn(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}
__device__ inline unsigned add_rn(unsigned a, unsigned b) { return a + b; }
__device__ inline float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ inline int mul_rn(int a, int b) {
    return (int)((unsigned)a * (unsigned)b);
}
__device__ inline unsigned mul_rn(unsigned a, unsigned b) { return a * b; }

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
