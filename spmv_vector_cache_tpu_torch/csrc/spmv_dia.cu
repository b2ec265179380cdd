// DIA SpMV for Hopper (sm_90a), plain C interface bound with ctypes:
// kernel A (float32), its float64 build, kernel J, and its halo build,
// kernel M.
//
// Kernel A replaces the Pallas kernels `_make_dia_kernel` and
// `_make_dia_kernel_windowed` (spmv_vector_cache_tpu/ops/spmv_dia.py),
// which compute the same function with x resident in VMEM or streamed in
// sliding blocks; that choice is a VMEM-capacity one the card does not
// have, so one kernel serves both.  Kernel J replaces their double-float
// forms `_make_dia_kernel_df` and `_make_dia_kernel_df_windowed` (with
// `_df_diag_accumulate`), which emulate f64 with hi/lo f32 pairs and
// error-free transforms; J joins each pair into a double (values.cuh)
// and sums in FP64, reading a float64 x and writing a float64 y.
// Kernel M replaces `_local_dia_spmv`
// (spmv_vector_cache_tpu/parallel/dia_sharded.py), one shard's DIA SpMV
// over an x that carries both neighbours' halos; the reference runs
// `_make_dia_kernel` there with pad_left = halo, so M is A with an x
// origin: the shard's row r reads x_ext[halo + r + off_k], and the left
// halo sits below the shard's own columns.
//
// y[r] = sum_k vals[t, k, i, l] * x[origin + r + off_k],
// r = t*S*128 + i*128 + l, where x reads as 0 outside [0, x_len) (the
// reference's zero-padded x image); A and J run with origin 0 and
// x_len = cols.  Only rows below `rows` are written.  A double plan's
// slab is (T, 2D, S*128): the low word of diagonal k sits at diagonal
// D + k.
//
// Bound: the value stream, 1, 2 or 4 B per stored slot (8 B, two words,
// in J), read once; x is re-read D times but from on-chip copies
// (neighbouring diagonals touch neighbouring addresses).  J's FP64 work,
// 2 flops per slot, is far below the card's FP64 rate.
//
// A and M (`dia_rows_kernel`): each thread sums R consecutive rows of one
// step, R chosen at launch (ops/spmv_dia.py dia_launch_shape: up to 16 B
// of slots and 8 rows, so 4 rows of 4-byte slots and 8 of 2- and 1-byte
// ones, fewer where the rows would not fill the card; 16 rows of 1-byte
// slots were slower on an H100).  Per diagonal it makes one
// vector load of its R slots (a step's run of a diagonal is S*128 slots,
// so every run starts 16-byte aligned), and it issues the loads of a
// group of 8 diagonals (kGroup) before the group's first multiply-add, so that
// enough bytes stay in flight at the narrow widths.  The offsets are a kernel
// parameter (the first kParamDiags) and the device array past that.
// Staged (a run-time choice of the launch): the CTA first copies its x
// window, x[row0 + lo, row0 + rows_cta + hi), into shared memory (each
// entry read once, while the first group's slot loads are in flight), as
// overlapping groups: group g holds window entries [gR, gR + 2R - 1) at
// words g(2R - 1) .. g(2R - 1) + 2R - 2, so thread i's R entries of a
// diagonal (window entries iR + c .. iR + c + R - 1, c = off - lo) are the
// words (i + c/R)(2R - 1) + c%R + j: one base a diagonal, R reads at fixed
// offsets, and an odd stride between the threads of a warp (no bank
// conflict).  Unstaged (a span too wide for the budget), each thread
// reads its x entries through L1, as the one-row kernel did.  Either way
// a row's sum runs over the diagonals in order, one multiply-add each, so
// every R, CTA size and path gives the same y bit for bit (M on a shard
// is A on the whole), the plain PyTorch version's order.  Rows past
// `rows` are loaded from the slab's padding and not written.
//
// A and M have a build for each value policy of values.cuh: the float32
// entry points, and `_bf16` (2 B a slot widened to float32, x and y
// float32: 2 B of the stream a slot instead of 4), `_i32` and `_u32`
// (sums wrapping mod 2^32) entry points with the same arguments.
// The `_f16`, `_i8`, `_u8`, `_i16` and `_u16` builds read 2- and 1-byte
// slots, widened to float32 (float16) or int (the integers, sign- or
// zero-extended) as they are used; x and the sums stay in that 32-bit
// type, and the wrapper narrows y once (ops/semiring.py finish_y).
// J keeps the one-row kernel below (`spmv_dia_kernel`): one thread per
// row, neighbouring threads on neighbouring `vals` and `x` addresses, the
// offsets a small int32 device array read through the read-only cache.

#include <cuda_runtime.h>
#include <stdint.h>

#include "values.cuh"

namespace {


// --- A and M ---------------------------------------------------------------

// offsets passed as a kernel parameter; a plan with more diagonals reads
// the rest from the device array
constexpr int kParamDiags = 64;
struct DiagOffsets {
    int v[kParamDiags];
};
// the most threads a CTA of A or M has, and the shared memory a staged
// CTA may take (the 48 KB a kernel gets without opting in); mirrored by
// ops/spmv_dia.py MAX_THREADS and STAGE_BYTES
constexpr int kMaxThreads = 256;
constexpr int kStageBytes = 48 * 1024;
// x loads a thread has in flight while it stages its CTA's window
constexpr int kStageLoads = 8;
// diagonals whose slot loads a thread has in flight together, at most
// 8 x 16 B (probes_torch/dia_shapes.py --define times another
// SPMV_DIA_GROUP_DIAGS: on an H100, larger groups, 32 of 4-byte vectors
// or 16 of 8- or 16-byte ones, were slower on most shapes and on small
// launches)
#ifndef SPMV_DIA_GROUP_DIAGS
#define SPMV_DIA_GROUP_DIAGS 8
#endif
constexpr int kGroup = SPMV_DIA_GROUP_DIAGS;

// the vector type of N bytes of slots
using spmv::VecOf;

// R slots, loaded as one vector and read one by one
template <class Slot, int R>
union Slots {
    typename VecOf<R * (int)sizeof(Slot)>::type vec;
    Slot s[R];
};

__device__ inline unsigned bits(float v) { return __float_as_uint(v); }
__device__ inline unsigned bits(int v) { return (unsigned)v; }
__device__ inline unsigned bits(unsigned v) { return v; }

// y[r .. r + R), R of the sum type's 4-byte words, as 16-, 8- or 4-byte
// stores (y is the wrapper's own allocation and r a multiple of R)
template <class T, int R>
__device__ inline void store_rows(T* y, const T (&acc)[R]) {
    if constexpr (R >= 4) {
#pragma unroll
        for (int q = 0; q < R; q += 4)
            *reinterpret_cast<uint4*>(y + q) =
                make_uint4(bits(acc[q]), bits(acc[q + 1]), bits(acc[q + 2]),
                           bits(acc[q + 3]));
    } else if constexpr (R == 2) {
        *reinterpret_cast<uint2*>(y) = make_uint2(bits(acc[0]),
                                                  bits(acc[1]));
    } else {
        y[0] = acc[0];
    }
}

// one thread's R rows, staged or through L1 (kStaged); every thread of
// the CTA calls it, so that the staged CTA meets at its barrier
template <class V, bool kHalo, int R, bool kStaged>
__device__ __forceinline__ void dia_rows(
    const typename V::Slot* __restrict__ vals,
    const typename V::T* __restrict__ x, const int* __restrict__ offsets,
    const DiagOffsets& offs, typename V::T* __restrict__ y, long long rows,
    long long x_len, long long x_origin, int ndiag, int rows_per_step,
    int lo, int span) {
    using T = typename V::T;
    using Slot = typename V::Slot;
    using Vec = typename VecOf<R * (int)sizeof(Slot)>::type;
    constexpr int W = 2 * R - 1;             // words of a staged group
    extern __shared__ __align__(16) unsigned char smem[];
    T* xs = reinterpret_cast<T*>(smem);

    const long long row0 = (long long)blockIdx.x * blockDim.x * R;
    const long long r = row0 + (long long)threadIdx.x * R;
    const bool live = r < rows;
    const long long t = r / rows_per_step;
    const Slot* v = vals + t * ndiag * (long long)rows_per_step +
                    (r - t * rows_per_step);
    const long long xr = (kHalo ? x_origin : 0) + r;

    Vec buf[kGroup];
    auto load = [&](int k0) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
            if (k0 + g < ndiag)
                buf[g] = __ldg(reinterpret_cast<const Vec*>(
                    v + (long long)(k0 + g) * rows_per_step));
    };
    if (live) load(0);                 // in flight while x is staged
    if constexpr (kStaged) {
        // each window entry e is read once (kStageLoads loads in flight a
        // thread) and written to its group e / R and, where it belongs
        // to the group before too, to that one
        const int groups = (int)blockDim.x + span / R;
        const int n = (groups + 1) * R - 1;
        const long long x0 = (kHalo ? x_origin : 0) + row0 + lo;
        for (int e0 = threadIdx.x; e0 < n; e0 += kStageLoads * blockDim.x) {
            T xv[kStageLoads];
#pragma unroll
            for (int u = 0; u < kStageLoads; ++u) {
                const int e = e0 + u * (int)blockDim.x;
                const long long c = x0 + e;
                xv[u] = (e < n && c >= 0 && c < x_len) ? __ldg(x + c) : T(0);
            }
#pragma unroll
            for (int u = 0; u < kStageLoads; ++u) {
                const int e = e0 + u * (int)blockDim.x;
                const int g = (unsigned)e / R, o = (unsigned)e % R;
                if (e >= n) continue;
                if (g < groups) xs[g * W + o] = xv[u];
                if (g > 0 && o < R - 1) xs[(g - 1) * W + o + R] = xv[u];
            }
        }
        __syncthreads();
    }
    if (!live) return;

    T acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = T(0);
    for (int k0 = 0; k0 < ndiag; k0 += kGroup) {
        if (k0 > 0) load(k0);
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
            const int k = k0 + g;
            if (k >= ndiag) break;
            const int off = k < kParamDiags ? offs.v[k] : __ldg(offsets + k);
            Slots<Slot, R> s;
            s.vec = buf[g];
            if constexpr (kStaged) {
                const unsigned c = (unsigned)(off - lo);    // in [0, span]
                const T* xp = xs + (threadIdx.x + c / R) * W + c % R;
#pragma unroll
                for (int j = 0; j < R; ++j)
                    acc[j] = spmv::madd(V::widen(s.s[j]), xp[j], acc[j]);
            } else {
                const long long c = xr + off;
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    const T xv = (c + j >= 0 && c + j < x_len)
                                     ? __ldg(x + c + j) : T(0);
                    acc[j] = spmv::madd(V::widen(s.s[j]), xv, acc[j]);
                }
            }
        }
    }
    if (r + R <= rows) {
        store_rows<T, R>(y + r, acc);
    } else {
#pragma unroll
        for (int j = 0; j < R; ++j)
            if (r + j < rows) y[r + j] = acc[j];
    }
}

template <class V, bool kHalo, int R>
__global__ void __launch_bounds__(kMaxThreads)
dia_rows_kernel(const typename V::Slot* __restrict__ vals,
                const typename V::T* __restrict__ x,
                const int* __restrict__ offsets,
                const __grid_constant__ DiagOffsets offs,
                typename V::T* __restrict__ y, long long rows,
                long long x_len, long long x_origin, int ndiag,
                int rows_per_step, int lo, int span, int staged) {
    if (staged)
        dia_rows<V, kHalo, R, true>(vals, x, offsets, offs, y, rows, x_len,
                                    x_origin, ndiag, rows_per_step, lo,
                                    span);
    else
        dia_rows<V, kHalo, R, false>(vals, x, offsets, offs, y, rows, x_len,
                                     x_origin, ndiag, rows_per_step, lo,
                                     span);
}

// launch A or M at R rows a thread and `threads` a CTA; refuses
// (cudaErrorInvalidValue) a shape the build or the operands do not take
template <class V, bool kHalo, int R>
int launch_rows(const void* vals, const void* x, const int* offsets,
                const int* host_offsets, void* y, long long rows,
                long long x_len, long long x_origin, int ndiag,
                int rows_per_step, int threads, int staged, void* stream) {
    using T = typename V::T;
    using Slot = typename V::Slot;
    constexpr int kVec = R * (int)sizeof(Slot);
    constexpr int kOut = R * (int)sizeof(T) < 16 ? R * (int)sizeof(T) : 16;
    if (threads < 32 || threads > kMaxThreads || threads % 32 ||
        rows_per_step % R || reinterpret_cast<uintptr_t>(vals) % kVec ||
        reinterpret_cast<uintptr_t>(y) % kOut)
        return (int)cudaErrorInvalidValue;
    DiagOffsets offs{};
    int lo = 0, hi = 0;
    for (int k = 0; k < ndiag; ++k) {
        const int o = host_offsets[k];
        if (k < kParamDiags) offs.v[k] = o;
        lo = (k == 0 || o < lo) ? o : lo;
        hi = (k == 0 || o > hi) ? o : hi;
    }
    const int span = hi - lo;
    const size_t smem =
        staged ? (size_t)(threads + span / R) * (2 * R - 1) * sizeof(T) : 0;
    if (smem > (size_t)kStageBytes) return (int)cudaErrorInvalidValue;
    if (rows > 0) {
        const long long per_cta = (long long)threads * R;
        const long long blocks = (rows + per_cta - 1) / per_cta;
        dia_rows_kernel<V, kHalo, R><<<(unsigned)blocks, threads, smem,
                                       (cudaStream_t)stream>>>(
            static_cast<const Slot*>(vals), static_cast<const T*>(x),
            offsets, offs, static_cast<T*>(y), rows, x_len, x_origin, ndiag,
            rows_per_step, lo, span, staged);
    }
    return (int)cudaGetLastError();
}

// R from the launch shape: 1, 2, 4, and 8 where 16 B of slots hold 8
template <class V, bool kHalo>
int launch_dia(const void* vals, const void* x, const int* offsets,
               const int* host_offsets, void* y, long long rows,
               long long x_len, long long x_origin, int ndiag,
               int rows_per_step, int rows_per_thread, int threads,
               int staged, void* stream) {
    constexpr int kMaxR = 16 / (int)sizeof(typename V::Slot);
#define SPMV_DIA_R(R)                                                       \
    return launch_rows<V, kHalo, R>(vals, x, offsets, host_offsets, y,      \
                                    rows, x_len, x_origin, ndiag,           \
                                    rows_per_step, threads, staged, stream)
    switch (rows_per_thread) {
        case 1: SPMV_DIA_R(1);
        case 2: SPMV_DIA_R(2);
        case 4: SPMV_DIA_R(4);
        case 8:
            if constexpr (kMaxR >= 8) { SPMV_DIA_R(8); }
            break;
    }
#undef SPMV_DIA_R
    return (int)cudaErrorInvalidValue;
}

// --- J ---------------------------------------------------------------------

// The one-row kernel, kept for J as it was.  kHalo: the x origin is read
// at run time (it served M until M moved to dia_rows_kernel); J compiles
// without it (a run-time origin of 0 cost the one-row A 6 % of its device
// time on an H100; A and M keep the split as dia_rows_kernel's kHalo)
template <class V, bool kHalo>
__global__ void spmv_dia_kernel(const typename V::Slot* __restrict__ vals,
                                const typename V::T* __restrict__ x,
                                const int* __restrict__ offsets,
                                typename V::T* __restrict__ y,
                                long long rows, long long x_len,
                                long long x_origin, int ndiag,
                                int rows_per_step) {
    using T = typename V::T;
    long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    long long t = r / rows_per_step;
    long long rem = r - t * rows_per_step;
    const long long half = (long long)ndiag * rows_per_step;
    const typename V::Slot* v = vals + t * V::kChannels * half + rem;
    const long long r_x = kHalo ? r + x_origin : r;
    T acc = T(0);
    for (int k = 0; k < ndiag; ++k) {
        long long c = r_x + __ldg(offsets + k);
        T xv = (c >= 0 && c < x_len) ? __ldg(x + c) : T(0);
        acc = spmv::madd(V::load(v + (long long)k * rows_per_step, half), xv,
                         acc);
    }
    y[r] = acc;
}

template <class V, bool kHalo>
int launch(const typename V::Slot* vals, const typename V::T* x,
           const int* offsets,
           typename V::T* y, long long rows, long long x_len,
           long long x_origin, int ndiag, int rows_per_step, void* stream) {
    if (rows > 0) {
        const int threads = 256;
        long long blocks = (rows + threads - 1) / threads;
        spmv_dia_kernel<V, kHalo><<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
            vals, x, offsets, y, rows, x_len, x_origin, ndiag,
            rows_per_step);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// A and M for each value policy: vals (T, D, S*128) of the policy's
// slots, x and y of its sum type; `offsets` the plan's offsets on the
// card and `host_offsets` the same on the host (read at launch); the
// launch shape (rows a thread, threads a CTA, x staged or not) from
// ops/spmv_dia.py dia_launch_shape.  Kernel M: x_ext holds the shard's x
// with the left halo first, so the shard's row r reads
// x_ext[x_origin + r + off_k]
#define SPMV_DIA_BUILD(sfx, V)                                              \
    extern "C" int spmv_dia_##sfx(                                          \
        const void* vals, const void* x, const int* offsets,                \
        const int* host_offsets, void* y, long long rows, long long cols,   \
        int ndiag, int rows_per_step, int rows_per_thread, int threads,     \
        int staged, void* stream) {                                         \
        return launch_dia<V, false>(vals, x, offsets, host_offsets, y,      \
                                    rows, cols, 0, ndiag, rows_per_step,    \
                                    rows_per_thread, threads, staged,       \
                                    stream);                                \
    }                                                                       \
    extern "C" int spmv_dia_halo_##sfx(                                     \
        const void* vals, const void* x_ext, const int* offsets,            \
        const int* host_offsets, void* y, long long rows, long long x_len,  \
        long long x_origin, int ndiag, int rows_per_step,                   \
        int rows_per_thread, int threads, int staged, void* stream) {       \
        return launch_dia<V, true>(vals, x_ext, offsets, host_offsets, y,   \
                                   rows, x_len, x_origin, ndiag,            \
                                   rows_per_step, rows_per_thread, threads, \
                                   staged, stream);                         \
    }

SPMV_DIA_BUILD(f32, spmv::F32Values)
SPMV_DIA_BUILD(bf16, spmv::Bf16Values)
SPMV_DIA_BUILD(i32, spmv::I32Values)
SPMV_DIA_BUILD(u32, spmv::U32Values)
SPMV_DIA_BUILD(f16, spmv::F16Values)
SPMV_DIA_BUILD(i8, spmv::I8Values)
SPMV_DIA_BUILD(u8, spmv::U8Values)
SPMV_DIA_BUILD(i16, spmv::I16Values)
SPMV_DIA_BUILD(u16, spmv::U16Values)

// vals: the double plan's (T, 2D, S*128) hi/lo slab; x, y: float64
extern "C" int spmv_dia_f64(const float* vals, const double* x,
                            const int* offsets, double* y, long long rows,
                            long long cols, int ndiag, int rows_per_step,
                            void* stream) {
    return launch<spmv::PairValues, false>(vals, x, offsets, y, rows, cols,
                                           0, ndiag, rows_per_step, stream);
}
