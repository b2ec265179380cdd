// SELL window SpMM for Hopper (sm_90a), plain C interface bound with
// ctypes: kernel H, from the slot stream to slice sums or rows of Y.
//
// Replaces the Pallas kernel `_make_spmm_kernel` and its operand builder
// `_bt_windows`, as run by `_spmm_window`
// (spmv_vector_cache_tpu/ops/spmm_pallas.py), together with the slice
// reduction that follows it there.  With B of shape (cols, k), row-major
// as the caller hands it, a tile t's slot (p, l) holds vals[t, p, l] at
// column c = window_base[t / wg] * window_grain + cols_win[t, p, l], as
// in kernel B (spmv_sell_window.cu); B reads as 0 at c >= cols.  The
// tiles of one slice are one contiguous run (tile_slice is
// nondecreasing), and kernel H writes, plus_times,
//   parts == 0:  S[s, l, j] = sum over the run of slice s, over p,
//                of vals * B[c, j]                          (slices, R, k)
//   parts >= 1:  Y[s * R/parts + r, j] = sum_{q < parts}
//                                        S[s, q * R/parts + r, j]
//                for rows < out_rows: the lane fold of a uniform-parts
//                plan (parts = p) or the identity map (parts = 1)
// so no partials reach device memory and no reduction pass follows.
//
// Work list: `runs` holds one int4 record per CTA, {t0, t1, s0, s1}:
// the CTA sums tiles [t0, t1) and writes slices [s0, s1), empty slices
// as 0.  Short slices are packed several to a CTA; a slice of more than
// a cap of tiles (ops/spmm_sell.py RUN_CAP: 32 tiles, a slice whose
// longest sub-row has more than 256 nonzeros, or the padding tiles a
// plan appends to its last slice) is split over several CTAs, each
// marked with kAtomic, which add their sums into a zeroed output with
// Hopper's float4 atomicAdd.  Those sums are in no fixed order; every
// other output is written once, by one CTA, in a fixed order.
//
// Bound: bytes — the slot stream (6 B per slot: f32 value, int16
// offset), the distinct B rows the slots name, the output once.  Design:
// - the RHS axis lies across neighbouring threads: `lane_threads`
//   threads per lane, V consecutive columns each (float4 or two, or one
//   float where k is not a multiple of 4), so one warp load reads whole
//   64-byte row segments of B (8 rows at k = 16) instead of 32 scattered
//   pieces; blockIdx.y walks the RHS axis in chunks of lane_threads * V;
// - each tile's slots (4 KB of values, 2 KB of offsets at P = 8,
//   R = 128) come into shared memory with cp.async, in a ring of
//   kStages buffers that keeps the next tiles of the run in flight, one
//   barrier a tile; the warps read them there, so no warp waits on a
//   slot load before its B loads (reading each lane's slots straight
//   from device memory, which no other warp needs, measured slower:
//   PERF.md);
// - a lane's sums stay in registers over the run; the lane fold goes
//   through shared memory.
// B stays in device memory, read through L1 and L2: a group's window
// spans K*128 rows of B, a few KB at K = 1.
//
// H has a build for each value policy of values.cuh: the float32 entry
// point, and `_bf16` (2 B values staged as they are and widened to
// float32 as they are read; B and Y float32, as the reference's SELL
// SpMM sums a bfloat16 plan), `_i32` and `_u32` (B and Y of the value
// type, sums wrapping mod 2^32, a split slice's pieces combined with the
// integer atomicAdd, one a column) entry points with the same arguments.
// The `_f16`, `_i8`, `_u8`, `_i16` and `_u16` builds read 2- and 1-byte
// slots, widened to float32 (float16) or int (the integers, sign- or
// zero-extended) as they load; B and the sums stay in that 32-bit type,
// and the wrapper narrows Y once (ops/semiring.py finish_y).  Their
// slots are staged by the same 16-byte cp.async pieces, 8 or 16 slots a
// piece.

#include <cuda_runtime.h>
#include <stdint.h>

#include "values.cuh"

namespace {

// bit 30 of a run record's fourth word: the CTA holds one piece of a
// slice split over several CTAs
constexpr int kAtomic = 1 << 30;
constexpr int kMaxThreads = 1024;
// tile buffers in the shared-memory ring: up to kStages - 1 tiles in
// flight while one is summed
constexpr int kStages = 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the 16-byte vector of four T
template <class T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<unsigned> { using type = uint4; };

// v[0:V] = p[0:V]; V = 1 or a multiple of 4 (16-byte aligned p).
template <int V, class T>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         T (&v)[V]) {
    using Q = typename Vec4<T>::type;
    if constexpr (V == 1) {
        v[0] = __ldg(p);
    } else {
#pragma unroll
        for (int i = 0; i < V; i += 4) {
            Q q = __ldg(reinterpret_cast<const Q*>(p + i));
            v[i] = q.x;
            v[i + 1] = q.y;
            v[i + 2] = q.z;
            v[i + 3] = q.w;
        }
    }
}

// *p += v atomically: float32 in one vector atomic (sm_90), an integer
// type a column at a time, in unsigned (wrapping)
__device__ __forceinline__ void atomic_add4(float* p, const float* v) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
}
template <class T>
__device__ __forceinline__ void atomic_add4(T* p, const T* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
        atomicAdd(reinterpret_cast<unsigned*>(p + i), (unsigned)v[i]);
}
__device__ __forceinline__ void atomic_add1(float* p, float v) {
    atomicAdd(p, v);
}
template <class T>
__device__ __forceinline__ void atomic_add1(T* p, T v) {
    atomicAdd(reinterpret_cast<unsigned*>(p), (unsigned)v);
}

// p[0:V] = v, or += v atomically (p zeroed beforehand).
template <int V, class T>
__device__ __forceinline__ void put(T* __restrict__ p, const T (&v)[V],
                                    bool atomic) {
    using Q = typename Vec4<T>::type;
    if constexpr (V == 1) {
        if (atomic)
            atomic_add1(p, v[0]);
        else
            *p = v[0];
    } else {
#pragma unroll
        for (int i = 0; i < V; i += 4) {
            if (atomic) {
                atomic_add4(p + i, v + i);
            } else {
                Q q;
                q.x = v[i];
                q.y = v[i + 1];
                q.z = v[i + 2];
                q.w = v[i + 3];
                *reinterpret_cast<Q*>(p + i) = q;
            }
        }
    }
}

// blockIdx.x = run record, blockIdx.y = RHS chunk; threadIdx.x =
// lane * lane_threads + g, thread g of a lane holding columns
// j = blockIdx.y * lane_threads * V + g * V .. + V.
template <class P, int V>
__global__ void __launch_bounds__(kMaxThreads)
spmm_runs_kernel(const typename P::Slot* __restrict__ vals,
                 const int16_t* __restrict__ cols_win,
                 const int* __restrict__ window_base,
                 const int* __restrict__ tile_slice,
                 const int4* __restrict__ runs,
                 const typename P::T* __restrict__ b,
                 typename P::T* __restrict__ out, int positions, int lanes,
                 int lane_threads, int group_tiles, int window_grain,
                 long long cols, int k, int parts, long long out_rows) {
    using T = typename P::T;
    using Slot = typename P::Slot;
    constexpr int kUnroll = V == 8 ? 4 : 8;
    constexpr int kSlotBytes = (int)sizeof(Slot);
    extern __shared__ __align__(16) unsigned char smem[];
    // kStages tile buffers of `slots` values then `slots` offsets (6
    // bytes a slot, 4 for bf16; 16-byte aligned as slots % 8 == 0), then
    // the lane fold's
    const int slots = positions * lanes;                  // per tile
    const int tile_bytes = slots * (kSlotBytes + 2);
    auto sv = [&](int buf) {
        return reinterpret_cast<Slot*>(smem + buf * tile_bytes);
    };
    auto sc = [&](int buf) {
        return reinterpret_cast<int16_t*>(smem + buf * tile_bytes +
                                          slots * kSlotBytes);
    };
    T* red = reinterpret_cast<T*>(smem + kStages * tile_bytes);

    const int tid = threadIdx.x;
    const int lane = tid / lane_threads;
    const int g = tid - lane * lane_threads;
    const int ck = lane_threads * V;
    const int j = blockIdx.y * ck + g * V;
    const bool active = j < k;
    const int4 run = __ldg(runs + blockIdx.x);
    const long long t0 = run.x, t1 = run.y;
    int cur = run.z;
    const int s1 = run.w & ~kAtomic;
    const bool atomic = (run.w & kAtomic) != 0;
    constexpr int kPer = 16 / kSlotBytes;                  // slots a piece
    const int vchunks = slots / kPer, cchunks = slots / 8; // 16-byte pieces

    auto load_tile = [&](long long t, int buf) {
        const Slot* gv = vals + t * slots;
        const int16_t* gc = cols_win + t * slots;
        Slot* dv = sv(buf);
        int16_t* dc = sc(buf);
        for (int i = tid; i < vchunks + cchunks; i += blockDim.x) {
            if (i < vchunks)
                cp_async16(dv + kPer * i, gv + kPer * i);
            else
                cp_async16(dc + 8 * (i - vchunks), gc + 8 * (i - vchunks));
        }
    };

    T acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = T(0);

    // write slice s's sums (every thread of the CTA calls it), then zero
    auto flush = [&](int s) {
        if (parts == 0) {
            if (active)
                put<V>(out + ((long long)s * lanes + lane) * k + j, acc,
                       atomic);
        } else if (parts == 1) {
            long long row = (long long)s * lanes + lane;
            if (active && row < out_rows)
                put<V>(out + row * k + j, acc, atomic);
        } else {
            const int rps = lanes / parts;
#pragma unroll
            for (int i = 0; i < V; ++i) red[lane * ck + g * V + i] = acc[i];
            __syncthreads();
            if (lane < rps && active) {
                T sum[V];
#pragma unroll
                for (int i = 0; i < V; ++i)
                    sum[i] = red[lane * ck + g * V + i];
                for (int q = 1; q < parts; ++q) {
                    const T* r = red + (q * rps + lane) * ck + g * V;
#pragma unroll
                    for (int i = 0; i < V; ++i)
                        sum[i] = spmv::add_rn(sum[i], r[i]);
                }
                long long row = (long long)s * rps + lane;
                if (row < out_rows) put<V>(out + row * k + j, sum, atomic);
            }
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = T(0);
    };

    // one commit group per tile, empty past the run's end, so that
    // waiting for all but the newest kStages - 2 groups waits for tile t
    for (int i = 0; i < kStages - 1; ++i) {
        if (t0 + i < t1) load_tile(t0 + i, i);
        cp_async_commit();
    }
    for (long long t = t0; t < t1; ++t) {
        const int buf = (int)((t - t0) % kStages);
        cp_async_wait<kStages - 2>();
        // tile t is in shared memory, and every thread is done with tile
        // t - 1, whose buffer takes tile t + kStages - 1
        __syncthreads();
        if (t + kStages - 1 < t1)
            load_tile(t + kStages - 1, (buf + kStages - 1) % kStages);
        cp_async_commit();
        const int s = __ldg(tile_slice + t);
        while (cur < s) flush(cur++);         // the slices before tile t
        const long long base =
            (long long)__ldg(window_base + t / group_tiles) * window_grain;
        if (active) {
            const Slot* v = sv(buf) + lane;
            const int16_t* c = sc(buf) + lane;
#pragma unroll kUnroll
            for (int p = 0; p < positions; ++p) {
                const T w = P::widen(v[p * lanes]);
                const long long col = base + c[p * lanes];
                if (col < cols) {
                    T bv[V];
                    load_row<V>(b + col * k + j, bv);
#pragma unroll
                    for (int i = 0; i < V; ++i)
                        acc[i] = spmv::madd(w, bv[i], acc[i]);
                }
            }
        }
    }
    while (cur < s1) flush(cur++);
}

template <class P, int V>
cudaError_t launch(const void* vals, const int16_t* cols_win,
                   const int* window_base, const int* tile_slice,
                   const int* runs, const void* b, void* out,
                   long long num_runs, int positions, int lanes,
                   int lane_threads, int group_tiles, int window_grain,
                   long long cols, int k, int parts, long long out_rows,
                   cudaStream_t stream) {
    using T = typename P::T;
    const int ck = lane_threads * V;
    const size_t slots = (size_t)positions * lanes;
    const size_t smem = kStages * slots * (sizeof(typename P::Slot) + 2) +
                        (parts > 1 ? (size_t)lanes * ck * sizeof(T) : 0);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            spmm_runs_kernel<P, V>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    dim3 grid((unsigned)num_runs, (unsigned)((k + ck - 1) / ck));
    spmm_runs_kernel<P, V><<<grid, lanes * lane_threads, smem, stream>>>(
        static_cast<const typename P::Slot*>(vals), cols_win, window_base,
        tile_slice, reinterpret_cast<const int4*>(runs),
        static_cast<const T*>(b), static_cast<T*>(out), positions, lanes,
        lane_threads, group_tiles, window_grain, cols, k, parts, out_rows);
    return cudaSuccess;
}

template <class P>
int launch_spmm(const void* vals, const int16_t* cols_win,
                const int* window_base, const int* tile_slice,
                const int* runs, const void* b, void* out,
                long long num_runs, int positions, int lanes,
                int group_tiles, int window_grain, long long cols, int k,
                int parts, long long out_rows, void* stream) {
    if (k < 1 || positions < 1 || lanes < 1 || lanes > kMaxThreads ||
        (positions * lanes) % 8 || parts < 0 || (parts > 1 && lanes % parts))
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)vals % 16 || (uintptr_t)cols_win % 16 ||
        (uintptr_t)runs % 16)
        return (int)cudaErrorMisalignedAddress;
    if (num_runs <= 0) return (int)cudaGetLastError();
    const bool aligned = (uintptr_t)b % 16 == 0 && (uintptr_t)out % 16 == 0;
    const int v = !aligned || k % 4 ? 1 : (k % 8 == 0 && k > 32 ? 8 : 4);
    // threads per lane: a power of two covering k / v columns, at most 8
    const int need = (k + v - 1) / v;
    int lane_threads = 1;
    while (lane_threads < need && lane_threads < 8 &&
           lanes * lane_threads * 2 <= kMaxThreads)
        lane_threads *= 2;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    switch (v) {
        case 1:
            err = launch<P, 1>(vals, cols_win, window_base, tile_slice, runs,
                               b, out, num_runs, positions, lanes,
                               lane_threads, group_tiles, window_grain, cols,
                               k, parts, out_rows, s);
            break;
        case 4:
            err = launch<P, 4>(vals, cols_win, window_base, tile_slice, runs,
                               b, out, num_runs, positions, lanes,
                               lane_threads, group_tiles, window_grain, cols,
                               k, parts, out_rows, s);
            break;
        default:
            err = launch<P, 8>(vals, cols_win, window_base, tile_slice, runs,
                               b, out, num_runs, positions, lanes,
                               lane_threads, group_tiles, window_grain, cols,
                               k, parts, out_rows, s);
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// runs: (num_runs, 4) int32 records; out: (num_slices, lanes, k) when
// parts == 0, else (out_rows, k), zeroed by the caller when a record
// carries kAtomic.  positions * lanes must be a multiple of 8, and vals,
// cols_win and runs 16-byte aligned (cp.async and int4 reads).  b and
// out: the policy's sum type.
#define SPMM_SELL_WINDOW_BUILD(sfx, P)                                      \
    extern "C" int spmm_sell_window_##sfx(                                  \
        const void* vals, const int16_t* cols_win, const int* window_base,  \
        const int* tile_slice, const int* runs, const void* b, void* out,   \
        long long num_runs, int positions, int lanes, int group_tiles,      \
        int window_grain, long long cols, int k, int parts,                 \
        long long out_rows, void* stream) {                                 \
        return launch_spmm<P>(vals, cols_win, window_base, tile_slice,      \
                              runs, b, out, num_runs, positions, lanes,     \
                              group_tiles, window_grain, cols, k, parts,    \
                              out_rows, stream);                            \
    }

SPMM_SELL_WINDOW_BUILD(f32, spmv::F32Values)
SPMM_SELL_WINDOW_BUILD(bf16, spmv::Bf16Values)
SPMM_SELL_WINDOW_BUILD(i32, spmv::I32Values)
SPMM_SELL_WINDOW_BUILD(u32, spmv::U32Values)
SPMM_SELL_WINDOW_BUILD(f16, spmv::F16Values)
SPMM_SELL_WINDOW_BUILD(i8, spmv::I8Values)
SPMM_SELL_WINDOW_BUILD(u8, spmv::U8Values)
SPMM_SELL_WINDOW_BUILD(i16, spmv::I16Values)
SPMM_SELL_WINDOW_BUILD(u16, spmv::U16Values)
