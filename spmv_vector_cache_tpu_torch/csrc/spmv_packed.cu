// Packed two-pass SpMV for Hopper (sm_90a), plain C interface bound with
// ctypes: kernel E (pass A, scan) and kernel F (pass B, extract).
//
// Kernel E replaces the Pallas kernel `_make_scan_kernel`
// (spmv_vector_cache_tpu/ops/spmv_packed.py).  For each 128-slot row r
// of the (T, 8, 128) slot tiles, with chunk c = cstep[r / (8*ST)]:
//   p[l] = vals[r, l] * x[c*CB*128 + (cols[r, l] & 16383)]   (x = 0 past
//          the last column)
//   S[r, l] = p[l0] + ... + p[l], l0 the last lane <= l whose cols carry
//          the piece-start flag (bit 14), or lane 0
// so each piece's sum lands at its end slot.  The reference runs a
// Hillis-Steele scan over lane rolls; here one warp owns a row, each
// thread scans its 4 consecutive slots serially and the warp combines
// the 32 partial results with a segmented shuffle scan — the same piece
// sums, added in another order.
//
// Kernel F replaces the Pallas kernel `_make_extract_kernel` (same
// file) and also computes what the reference does after that call
// (`spmv_packed.py:189-197`: the window mask and the overflow COO), so
// the apply is E then F and nothing else.  For each y row r < rows, in
// window w = r / 8192 at element e = r % 8192:
//   y[r] = sum over visits i in [woff[w], woff[w+1]) of
//          S[sblock[i]*ST*1024 + esrc[i, e]]  (esrc < 0: none)
//        + sum over r's overflow entries j, in the plan's order, of
//          ov_vals[j] * x[ov_cols[j]]
// so a window with no visit gives 0 plus its overflow.  On the TPU the
// grid walks the visits in order with the window's y block resident;
// here each CTA owns a block of rows (8 a thread), reads its window's
// visit range from a table built at placement (no search), and writes
// its rows of y once: no atomic, no partial buffer, y the same every
// run.
//
// Bound: bytes.  Pass A streams 6 B per slot in and 4 B out (vectorised:
// 16 B of values and 8 B of columns per thread); its x reads fall in one
// chunk of CB*128 columns, served by L1/L2.  Pass B reads 2 B of esrc per
// y row and visit of its window, sblock, the S entries esrc picks, the
// overflow triples and their x, and writes 4 B per row of y.  With a
// thread per row and visit loads issued one after another it was
// latency-bound (a dependent esrc load then S gather per visit, ~2 loads
// in flight a thread, well under the ~2 MB in flight the card needs).
// So a thread loads 16 B of esrc (8 rows) a visit, issues a batch of
// visits' esrc loads and then all their S gathers before summing them,
// and the CTA's thread groups take interleaved batches of the window's
// visits; group 0 adds the other groups' sums in group order from shared
// memory.  The order is fixed, so y is the same every run, but it is not
// visit order.  The overflow entries are staged through shared memory
// a CTA-wide round at a time and added, after the visits, by the thread
// that owns the row.  On the H100, 256 rows a CTA in 4 groups of 32
// threads, 2 visits a batch, was the fastest launch shape: 6.5 us on
// `mac_econ_like` against a 4.90 us bound (16.4 MB), where the one-row
// threads took 10.8 us before the overflow ops (probes_torch/
// extract_shapes.py; PERF.md).  Issuing the next batch's esrc loads
// before this batch's gathers, or S gathers that skip L1, were slower.
//
// E and F have a build for each value policy of values.cuh: the float32
// entry point, and `_bf16`, `_i32` and `_u32` (sums wrapping mod 2^32)
// entry points with the same arguments.  E's bf16 build loads 8 B of
// values a thread and widens them to float32 (x and the scan float32:
// 4 B of the stream a slot instead of 6); F's reads the float32 scan and
// x and 2 B an overflow value, widened as it is loaded.
// The `_f16`, `_i8`, `_u8`, `_i16` and `_u16` builds read 2- and 1-byte
// slots, widened to float32 (float16) or int (the integers, sign- or
// zero-extended) as they load; x and the sums stay in that 32-bit type,
// and the wrapper narrows y once (ops/semiring.py finish_y).  E loads four
// slots a thread as one 8- or 4-byte word; F reads the 32-bit scan and
// x and the overflow values in the slab's width.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "values.cuh"

namespace {

using spmv::add_rn;
using spmv::mul_rn;

// four consecutive slots from 16-byte (8-byte for bf16) aligned p, as
// the sum type
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const uint16_t* p, float (&v)[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const int* p, int (&v)[4]) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const unsigned* p, unsigned (&v)[4]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// four consecutive slots of a policy from p, widened to the sum type:
// the 4-byte types and bfloat16 by the loads above, the float16 and the
// narrow integer slots by one 8-byte (2-byte slots) or 4-byte (1-byte
// slots) load from p, aligned to that size
template <class V>
__device__ __forceinline__ void load4v(const typename V::Slot* p,
                                       typename V::T (&v)[4]) {
    using Slot = typename V::Slot;
    if constexpr (sizeof(Slot) == 4 ||
                  std::is_same<V, spmv::Bf16Values>::value) {
        load4(p, v);
    } else {
        using Word = std::conditional_t<sizeof(Slot) == 2, uint2, unsigned>;
        union {
            Word w;
            Slot s[4];
        } u;
        u.w = __ldg(reinterpret_cast<const Word*>(p));
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = V::widen(u.s[j]);
    }
}

// p[0:4] = a, b, c, d as one 16-byte store (p 16-byte aligned)
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(int* p, int a, int b, int c, int d) {
    *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}
__device__ __forceinline__ void store4(unsigned* p, unsigned a, unsigned b,
                                       unsigned c, unsigned d) {
    *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

constexpr int kRowSlots = 128;        // slots per scanned row
constexpr int kWindowRows = 8192;     // y rows per pass-B window
constexpr unsigned kFullMask = 0xffffffffu;

// blockDim.x = 256: 8 warps, one 128-slot row each
template <class V>
__global__ void packed_scan_kernel(const typename V::Slot* __restrict__ vals,
                                   const int16_t* __restrict__ cols,
                                   const int* __restrict__ cstep,
                                   const typename V::T* __restrict__ x,
                                   typename V::T* __restrict__ out,
                                   long long rows, int rows_per_step,
                                   long long chunk_cols, long long ncols) {
    using T = typename V::T;
    long long row = (long long)blockIdx.x * (blockDim.x / 32) +
                    threadIdx.x / 32;
    if (row >= rows) return;              // uniform over the warp
    int k = threadIdx.x & 31;
    long long xbase =
        (long long)__ldg(cstep + row / rows_per_step) * chunk_cols;
    long long off = row * kRowSlots + 4 * k;
    T v[4];
    load4v<V>(vals + off, v);
    short4 c4 = __ldg(reinterpret_cast<const short4*>(cols + off));
    int c[4] = {c4.x, c4.y, c4.z, c4.w};
    T s[4];
    bool start[4];
    for (int j = 0; j < 4; ++j) {
        long long g = xbase + (c[j] & 16383);
        T xv = g < ncols ? __ldg(x + g) : T(0);
        T p = mul_rn(v[j], xv);
        start[j] = (c[j] >> 14) & 1;
        s[j] = (j == 0 || start[j]) ? p : add_rn(s[j - 1], p);
    }
    // segmented inclusive scan of the threads' (sum, any-start) pairs
    T inc = s[3];
    int flag = start[0] | start[1] | start[2] | start[3];
    for (int d = 1; d < 32; d <<= 1) {
        T up = __shfl_up_sync(kFullMask, inc, d);
        int up_flag = __shfl_up_sync(kFullMask, flag, d);
        if (k >= d) {
            if (!flag) inc = add_rn(up, inc);
            flag |= up_flag;
        }
    }
    T carry = __shfl_up_sync(kFullMask, inc, 1);
    if (k > 0) {
        // the carry runs into this thread's slots up to its first start
        for (int j = 0; j < 4 && !start[j]; ++j)
            s[j] = add_rn(carry, s[j]);
    }
    store4(out + off, s[0], s[1], s[2], s[3]);
}

// Kernel F's launch shape, chosen on the H100 by
// probes_torch/extract_shapes.py, which builds other shapes by defining
// these: rows a CTA writes (8 a thread; a divisor of 8192, and equal to
// ops/runs.py EXTRACT_BLOCK_ROWS, by which placement groups the
// overflow), thread groups that split a window's visits, and visits a
// thread loads before it sums them.
#ifndef PACKED_F_BLOCK_ROWS
#define PACKED_F_BLOCK_ROWS 256
#endif
#ifndef PACKED_F_GROUPS
#define PACKED_F_GROUPS 4
#endif
#ifndef PACKED_F_BATCH
#define PACKED_F_BATCH 2
#endif

constexpr int kRowsPerThread = 8;    // one 16 B esrc load a visit
constexpr int kBlockRows = PACKED_F_BLOCK_ROWS;
constexpr int kGroups = PACKED_F_GROUPS;
constexpr int kBatch = PACKED_F_BATCH;
constexpr int kTX = kBlockRows / kRowsPerThread;  // threads of a group
constexpr int kThreads = kTX * kGroups;
static_assert(kBlockRows % kRowsPerThread == 0 &&
                  kWindowRows % kBlockRows == 0,
              "a CTA's rows are whole threads' and divide a window");
static_assert(kThreads <= 1024 && kGroups >= 1 && kBatch >= 1,
              "kernel F's launch shape");

__device__ __forceinline__ int esrc_at(const int4& v, int j) {
    int word = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
    return (int)(short)(j & 1 ? (word >> 16) : word);
}

// blockDim (kTX, kGroups): kTX threads own the CTA's kBlockRows rows,
// kGroups groups of them split the window's visits; V: the value policy
// (T the sum type, the overflow values its slots, widened as they load)
template <class V, class T = typename V::T, class OV = typename V::Slot>
__global__ void __launch_bounds__(kThreads) packed_rows_kernel(
        const T* __restrict__ scan, const int* __restrict__ sblock,
        const int* __restrict__ woff, const int16_t* __restrict__ esrc,
        const int* __restrict__ ov_off, const int* __restrict__ ov_lane,
        const int* __restrict__ ov_cols, const OV* __restrict__ ov_vals,
        const T* __restrict__ x, T* __restrict__ y, long long rows,
        long long block_slots) {
    // the sums of groups 1.. for group 0 to add; the overflow products of
    // a round, their rows in the block, and each thread's run of them
    __shared__ __align__(16) T part[kGroups > 1 ? kGroups - 1 : 1]
                                   [kBlockRows];
    __shared__ T ov_prod[kThreads];
    __shared__ int ov_row[kThreads];
    __shared__ int ov_first[kTX], ov_last[kTX];
    const int tx = threadIdx.x, g = threadIdx.y;
    const int tid = g * kTX + tx;
    const long long row0 = (long long)blockIdx.x * kBlockRows;
    const int w = (int)(row0 / kWindowRows);
    const int e0 = (int)(row0 % kWindowRows) + tx * kRowsPerThread;

    // the first round of overflow entries, loaded before the visits
    const int o0 = ov_off ? __ldg(ov_off + blockIdx.x) : 0;
    const int o1 = ov_off ? __ldg(ov_off + blockIdx.x + 1) : 0;
    int lane = 0, col = 0;
    T val = T(0);
    if (o0 + tid < o1) {
        lane = __ldg(ov_lane + o0 + tid);
        col = __ldg(ov_cols + o0 + tid);
        val = V::widen(__ldg(ov_vals + o0 + tid));
    }

    T acc[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] = T(0);
    const int v0 = __ldg(woff + w), v1 = __ldg(woff + w + 1);
    for (int i0 = v0 + g * kBatch; i0 < v1; i0 += kGroups * kBatch) {
        int4 ev[kBatch];
        long long base[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u;
            if (i < v1) {
                ev[u] = __ldg(reinterpret_cast<const int4*>(
                    esrc + (long long)i * kWindowRows + e0));
                base[u] = (long long)__ldg(sblock + i) * block_slots;
            } else {
                ev[u] = make_int4(-1, -1, -1, -1);
                base[u] = 0;
            }
        }
        T v[kBatch][kRowsPerThread];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
            for (int j = 0; j < kRowsPerThread; ++j) {
                const int src = esrc_at(ev[u], j);
                v[u][j] = src >= 0 ? __ldg(scan + base[u] + src) : T(0);
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
            for (int j = 0; j < kRowsPerThread; ++j)
                acc[j] = add_rn(acc[j], v[u][j]);
        }
    }
    if (kGroups > 1) {
        if (g > 0) {
            T* mine = &part[g - 1][tx * kRowsPerThread];
            store4(mine, acc[0], acc[1], acc[2], acc[3]);
            store4(mine + 4, acc[4], acc[5], acc[6], acc[7]);
        }
        __syncthreads();
        if (g == 0) {
#pragma unroll
            for (int h = 1; h < kGroups; ++h) {
#pragma unroll
                for (int j = 0; j < kRowsPerThread; ++j)
                    acc[j] = add_rn(acc[j],
                                    part[h - 1][tx * kRowsPerThread + j]);
            }
        }
    }

    // the overflow, a round of up to kThreads entries at a time: each
    // entry's product into shared memory, then each row's run of entries
    // (sorted by row, the plan's order within a row) added by its owner
    for (int r0 = o0; r0 < o1; r0 += kThreads) {
        const int m = min(kThreads, o1 - r0);
        if (r0 > o0 && tid < m) {
            lane = __ldg(ov_lane + r0 + tid);
            col = __ldg(ov_cols + r0 + tid);
            val = V::widen(__ldg(ov_vals + r0 + tid));
        }
        if (tid < kTX) ov_first[tid] = ov_last[tid] = 0;
        if (tid < m) {
            ov_prod[tid] = mul_rn(val, __ldg(x + col));
            ov_row[tid] = lane;
        }
        __syncthreads();
        if (tid < m) {
            const int own = lane / kRowsPerThread;
            if (tid == 0 || ov_row[tid - 1] / kRowsPerThread != own)
                ov_first[own] = tid;
            if (tid == m - 1 || ov_row[tid + 1] / kRowsPerThread != own)
                ov_last[own] = tid + 1;
        }
        __syncthreads();
        if (g == 0) {
            for (int k = ov_first[tx]; k < ov_last[tx]; ++k) {
                const int jk = ov_row[k] % kRowsPerThread;
                const T p = ov_prod[k];
#pragma unroll
                for (int j = 0; j < kRowsPerThread; ++j)
                    if (j == jk) acc[j] = add_rn(acc[j], p);
            }
        }
        __syncthreads();
    }

    if (g == 0) {
        const long long r = row0 + tx * kRowsPerThread;
        if (r + kRowsPerThread <= rows) {
            store4(y + r, acc[0], acc[1], acc[2], acc[3]);
            store4(y + r + 4, acc[4], acc[5], acc[6], acc[7]);
        } else {
#pragma unroll
            for (int j = 0; j < kRowsPerThread; ++j)
                if (r + j < rows) y[r + j] = acc[j];
        }
    }
}

template <class V>
int launch_scan(const void* vals, const int16_t* cols, const int* cstep,
                const void* x, void* out, long long rows, int rows_per_step,
                long long chunk_cols, long long ncols, void* stream) {
    using T = typename V::T;
    if (rows > 0) {
        constexpr int threads = 256;
        long long blocks = (rows + threads / 32 - 1) / (threads / 32);
        packed_scan_kernel<V><<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
            static_cast<const typename V::Slot*>(vals), cols, cstep,
            static_cast<const T*>(x), static_cast<T*>(out), rows,
            rows_per_step, chunk_cols, ncols);
    }
    return (int)cudaGetLastError();
}

template <class V>
int launch_rows(const void* scan, const int* sblock, const int* woff,
                const int16_t* esrc, const int* ov_off, const int* ov_lane,
                const int* ov_cols, const void* ov_vals, const void* x,
                void* y, long long rows, long long block_slots,
                void* stream) {
    using T = typename V::T;
    if (rows > 0) {
        const unsigned grid = (unsigned)((rows + kBlockRows - 1) /
                                         kBlockRows);
        packed_rows_kernel<V><<<grid, dim3(kTX, kGroups), 0,
                                    (cudaStream_t)stream>>>(
            static_cast<const T*>(scan), sblock, woff, esrc, ov_off, ov_lane,
            ov_cols, static_cast<const typename V::Slot*>(ov_vals),
            static_cast<const T*>(x), static_cast<T*>(y), rows, block_slots);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// rows = T * 8 scanned rows; rows_per_step = 8 * step_tiles;
// chunk_cols = chunk_blocks * 128; ncols = columns of x; vals 16-byte
// aligned; x and out of the policy's sum type
#define PACKED_SCAN_BUILD(sfx, V)                                           \
    extern "C" int packed_scan_##sfx(                                       \
        const void* vals, const int16_t* cols, const int* cstep,            \
        const void* x, void* out, long long rows, int rows_per_step,        \
        long long chunk_cols, long long ncols, void* stream) {              \
        return launch_scan<V>(vals, cols, cstep, x, out, rows,              \
                              rows_per_step, chunk_cols, ncols, stream);    \
    }

PACKED_SCAN_BUILD(f32, spmv::F32Values)
PACKED_SCAN_BUILD(bf16, spmv::Bf16Values)
PACKED_SCAN_BUILD(i32, spmv::I32Values)
PACKED_SCAN_BUILD(u32, spmv::U32Values)
PACKED_SCAN_BUILD(f16, spmv::F16Values)
PACKED_SCAN_BUILD(i8, spmv::I8Values)
PACKED_SCAN_BUILD(u8, spmv::U8Values)
PACKED_SCAN_BUILD(i16, spmv::I16Values)
PACKED_SCAN_BUILD(u16, spmv::U16Values)

// y: rows sums, written, in CTAs of PACKED_F_BLOCK_ROWS rows; ov_off:
// one offset a CTA and one more, or null for no overflow (x is then not
// read); block_slots = step_tiles * 1024; scan, x and y of the sum type
// T, ov_vals of the policy's slots
#define PACKED_EXTRACT_BUILD(sfx, V)                                    \
    extern "C" int packed_extract_##sfx(                                    \
        const void* scan, const int* sblock, const int* woff,               \
        const int16_t* esrc, const int* ov_off, const int* ov_lane,         \
        const int* ov_cols, const void* ov_vals, const void* x, void* y,    \
        long long rows, long long block_slots, void* stream) {              \
        return launch_rows<V>(scan, sblock, woff, esrc, ov_off,         \
                                  ov_lane, ov_cols, ov_vals, x, y, rows,    \
                                  block_slots, stream);                     \
    }

PACKED_EXTRACT_BUILD(f32, spmv::F32Values)
PACKED_EXTRACT_BUILD(bf16, spmv::Bf16Values)
PACKED_EXTRACT_BUILD(i32, spmv::I32Values)
PACKED_EXTRACT_BUILD(u32, spmv::U32Values)
PACKED_EXTRACT_BUILD(f16, spmv::F16Values)
PACKED_EXTRACT_BUILD(i8, spmv::I8Values)
PACKED_EXTRACT_BUILD(u8, spmv::U8Values)
PACKED_EXTRACT_BUILD(i16, spmv::I16Values)
PACKED_EXTRACT_BUILD(u16, spmv::U16Values)
