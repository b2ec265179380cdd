// Semirings of the SELL kernels (B, D, G and the chunk light route), as
// (init, step) pairs over float32: step(acc, v, x) = acc (+) (v (x) x);
// zero() the semiring's zero, the value of a plan's padding slots and,
// for a finite x, the product of one; add(a, b) = a (+) b and
// atomic(p, v): *p = *p (+) v in one atomic update, for kernel G's sums of
// a slice split over several CTAs; finish(v): a sum as written out.  The
// boolean semiring runs on a {0, 1} float encoding (and = *, or = max),
// so it shares max_times; kernel G, which writes its reduced sums, maps
// them back to {0, 1} as the reference's or_and segment reduce does.
// Codes match ops/semiring.py KERNEL_CODE:
// 0 plus_times, 1 min_plus, 2 max_plus, 3 max_times, 4 or_and.
//
// The integer semirings (IntPlusTimes, IntMaxTimes, IntOrAnd) run the
// same (init, step) pairs over T = int or unsigned, for the int32 and
// uint32 plans: sums and products in unsigned, so that they wrap mod 2^32
// (signed overflow is undefined in C++), max in T's own order, a split
// slice's pieces combined by the integer atomicAdd and atomicMax.
// The narrow integer plans (int8, uint8, int16, uint16) sum as int; W,
// their value type, is what IntMaxTimes wraps each product to (and
// sign-extends, for a signed W) before the max, as the reference takes
// the max of products computed in the value type.  The empty max stays
// T's least value: the caller narrows y, and first raises it to W's least
// value (ops/semiring.py finish_y), so that kernel and plain version
// agree on the sums they hand over.
// min_plus and max_plus have no integer form (their zero is infinite):
// with_semiring refuses them there.  The float32 structs are the ones
// the float32 builds always compiled (a run-time choice of type there
// once cost kernel A 6 % of its device time on an H100, spmv_dia.cu).
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

namespace spmv {

// float min / max as one integer atomic: a float with its sign bit clear
// orders as a signed int, one with it set as the reverse of an unsigned
// int (-0.0 included), so each lands where the float order puts it
__device__ __forceinline__ void atomic_min_f32(float* p, float v) {
    if (!signbit(v))
        atomicMin(reinterpret_cast<int*>(p), __float_as_int(v));
    else
        atomicMax(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* p, float v) {
    if (!signbit(v))
        atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
    else
        atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

struct PlusTimes {
    static __device__ float init() { return 0.0f; }
    static __device__ float zero() { return 0.0f; }
    static __device__ float step(float acc, float v, float x) {
        return fmaf(v, x, acc);
    }
    static __device__ float add(float a, float b) { return a + b; }
    static __device__ void atomic(float* p, float v) { atomicAdd(p, v); }
    static __device__ float finish(float v) { return v; }
};
struct MinPlus {
    static __device__ float init() { return INFINITY; }
    static __device__ float zero() { return INFINITY; }
    static __device__ float step(float acc, float v, float x) {
        return fminf(acc, v + x);
    }
    static __device__ float add(float a, float b) { return fminf(a, b); }
    static __device__ void atomic(float* p, float v) { atomic_min_f32(p, v); }
    static __device__ float finish(float v) { return v; }
};
struct MaxPlus {
    static __device__ float init() { return -INFINITY; }
    static __device__ float zero() { return -INFINITY; }
    static __device__ float step(float acc, float v, float x) {
        return fmaxf(acc, v + x);
    }
    static __device__ float add(float a, float b) { return fmaxf(a, b); }
    static __device__ void atomic(float* p, float v) { atomic_max_f32(p, v); }
    static __device__ float finish(float v) { return v; }
};
struct MaxTimes {
    static __device__ float init() { return -INFINITY; }
    static __device__ float zero() { return 0.0f; }
    static __device__ float step(float acc, float v, float x) {
        return fmaxf(acc, v * x);
    }
    static __device__ float add(float a, float b) { return fmaxf(a, b); }
    static __device__ void atomic(float* p, float v) { atomic_max_f32(p, v); }
    static __device__ float finish(float v) { return v; }
};
// or_and: max_times, its reduced sums written as the reference's
// segment reduce gives them, 1 where the integer part is positive, else 0
// (an empty slice's -inf included); monotone, so it commutes with the
// atomic max of a split slice's pieces
struct OrAnd : MaxTimes {
    static __device__ float finish(float v) { return v >= 1.0f ? 1.0f : 0.0f; }
};

template <class T>
struct IntPlusTimes {
    static __device__ T init() { return T(0); }
    static __device__ T zero() { return T(0); }
    static __device__ T step(T acc, T v, T x) {
        return T((unsigned)v * (unsigned)x + (unsigned)acc);
    }
    static __device__ T add(T a, T b) { return T((unsigned)a + (unsigned)b); }
    static __device__ void atomic(T* p, T v) {
        atomicAdd(reinterpret_cast<unsigned*>(p), (unsigned)v);
    }
    static __device__ T finish(T v) { return v; }
};
// the empty max: INT_MIN for int, 0 for unsigned (what the reference's
// segment max fills an empty segment with); W: the type each product is
// wrapped to before the max
template <class T, class W = T>
struct IntMaxTimes {
    static __device__ T init() {
        return std::is_signed<T>::value ? T(INT_MIN) : T(0);
    }
    static __device__ T zero() { return T(0); }
    static __device__ T step(T acc, T v, T x) {
        const T p = T(W((unsigned)v * (unsigned)x));
        return p > acc ? p : acc;
    }
    static __device__ T add(T a, T b) { return a > b ? a : b; }
    static __device__ void atomic(T* p, T v) { atomicMax(p, v); }
    static __device__ T finish(T v) { return v; }
};
template <class T, class W = T>
struct IntOrAnd : IntMaxTimes<T, W> {
    static __device__ T finish(T v) { return v >= T(1) ? T(1) : T(0); }
};

// Calls launch(S{}) with the semiring of `code` over sums of type T
// (float: the five float32 semirings; int, unsigned: the three integer
// ones, their products wrapped to W before a max); an unknown code, or
// min_plus and max_plus over an integer T, is cudaErrorInvalidValue.
template <class T = float, class W = T, class F>
cudaError_t with_semiring(int code, F&& launch) {
    if constexpr (std::is_same<T, float>::value) {
        switch (code) {
            case 0: launch(PlusTimes{}); return cudaSuccess;
            case 1: launch(MinPlus{}); return cudaSuccess;
            case 2: launch(MaxPlus{}); return cudaSuccess;
            case 3: launch(MaxTimes{}); return cudaSuccess;
            case 4: launch(OrAnd{}); return cudaSuccess;
            default: return cudaErrorInvalidValue;
        }
    } else {
        switch (code) {
            case 0: launch(IntPlusTimes<T>{}); return cudaSuccess;
            case 3: launch(IntMaxTimes<T, W>{}); return cudaSuccess;
            case 4: launch(IntOrAnd<T, W>{}); return cudaSuccess;
            default: return cudaErrorInvalidValue;
        }
    }
}

}  // namespace spmv
