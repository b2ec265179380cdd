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
//
// The narrow policies store a slot in the value type's own width and
// widen it to the sum type as it is loaded: a float16 plan (2 B a slot)
// sums in float32 (its y is rounded to float16 once, by the caller); an
// int8, uint8, int16 or uint16 plan (1 or 2 B a slot) sums in 32 bits,
// sign-extended for the signed types and zero-extended for the unsigned,
// and its y is narrowed once, by the caller (narrowing mod 2^8 or 2^16
// commutes with the wrapping + and *).  `Wrap` is the type a product is
// wrapped to before a max (semiring.cuh IntMaxTimes), as the reference
// takes the max of products in the value type.  Every policy's
// `widen(slot)` is the value of a stored slot in the sum type, for the
// kernels that stage slots before they read them (H, I, E).  `Scan` is
// the type kernel E writes its scan in and kernel F reads it in: the
// slot type of the narrow integers (a piece sum narrowed to 8 or 16 bits
// is all that y, narrowed once at the end, keeps of it: narrowing
// commutes with F's wrapping sums), else the sum type.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spmv {

struct F32Values {
    using T = float;
    using Slot = float;
    using Scan = float;
    using Wrap = float;
    static constexpr int kChannels = 1;
    static __device__ float widen(float v) { return v; }
    static __device__ float load(const float* v, long long /*half*/) {
        return __ldg(v);
    }
};

struct PairValues {
    using T = double;
    using Slot = float;
    using Wrap = double;
    static constexpr int kChannels = 2;
    static __device__ double load(const float* v, long long half) {
        return (double)__ldg(v) + (double)__ldg(v + half);
    }
};

struct Bf16Values {
    using T = float;
    using Slot = uint16_t;
    using Scan = float;
    using Wrap = float;
    static constexpr int kChannels = 1;
    static __device__ float widen(uint16_t v) {
        return __uint_as_float((unsigned)v << 16);
    }
    static __device__ float load(const uint16_t* v, long long /*half*/) {
        return __uint_as_float((unsigned)__ldg(v) << 16);
    }
};

struct I32Values {
    using T = int;
    using Slot = int;
    using Scan = int;
    using Wrap = int;
    static constexpr int kChannels = 1;
    static __device__ int widen(int v) { return v; }
    static __device__ int load(const int* v, long long /*half*/) {
        return __ldg(v);
    }
};

struct U32Values {
    using T = unsigned;
    using Slot = unsigned;
    using Scan = unsigned;
    using Wrap = unsigned;
    static constexpr int kChannels = 1;
    static __device__ unsigned widen(unsigned v) { return v; }
    static __device__ unsigned load(const unsigned* v, long long /*half*/) {
        return __ldg(v);
    }
};

// float16 slots (their IEEE half bits), widened exactly to float32
struct F16Values {
    using T = float;
    using Slot = uint16_t;
    using Scan = float;
    using Wrap = float;
    static constexpr int kChannels = 1;
    static __device__ float widen(uint16_t v) {
        return __half2float(__ushort_as_half(v));
    }
    static __device__ float load(const uint16_t* v, long long /*half*/) {
        return widen(__ldg(v));
    }
};

// int8, uint8, int16 and uint16 slots, summed as int: the conversion
// sign-extends a signed slot and zero-extends an unsigned one
template <class S>
struct NarrowIntValues {
    using T = int;
    using Slot = S;
    using Scan = S;
    using Wrap = S;
    static constexpr int kChannels = 1;
    static __device__ int widen(S v) { return (int)v; }
    static __device__ int load(const S* v, long long /*half*/) {
        return (int)__ldg(v);
    }
};
using I8Values = NarrowIntValues<int8_t>;
using U8Values = NarrowIntValues<uint8_t>;
using I16Values = NarrowIntValues<int16_t>;
using U16Values = NarrowIntValues<uint16_t>;

// N consecutive elements of E, loaded and stored as vectors of up to 16
// bytes (the address aligned to min(16, N * sizeof(E))), read and written
// one element at a time: a thread's run of slots, offsets or sums
template <int N> struct VecOf;
template <> struct VecOf<1> { using type = unsigned char; };
template <> struct VecOf<2> { using type = unsigned short; };
template <> struct VecOf<4> { using type = unsigned; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

template <class E, int N>
struct Run {
    static constexpr int kBytes = N * (int)sizeof(E);
    static constexpr int kVec = kBytes < 16 ? kBytes : 16;
    using Vec = typename VecOf<kVec>::type;
    union {
        Vec v[kBytes / kVec];
        E e[N];
    };
    __device__ __forceinline__ void load(const E* p) {
#pragma unroll
        for (int i = 0; i < kBytes / kVec; ++i)
            v[i] = __ldg(reinterpret_cast<const Vec*>(p) + i);
    }
    __device__ __forceinline__ void store(E* p) const {
#pragma unroll
        for (int i = 0; i < kBytes / kVec; ++i)
            reinterpret_cast<Vec*>(p)[i] = v[i];
    }
};

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
