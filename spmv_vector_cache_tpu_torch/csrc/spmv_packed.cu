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
// Hillis-Steele scan over lane rolls; here each thread scans SL
// consecutive slots of a row serially and the row's 128 / SL threads
// combine their partial results with a segmented shuffle scan — the
// same piece sums, added in another order.  S is written in the value
// type for the 8- and 16-bit integer builds (`Scan` of values.cuh: what
// y, narrowed once, keeps of a piece sum, and the reference's own scan
// type), in the 32-bit sum type for the others.
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
// Bound: bytes.  Pass A streams the slot (1, 2 or 4 B) and its 2-B
// column in and writes S (1 or 2 B for the narrow integers, else 4 B);
// its x reads fall in one chunk of CB*128 columns, served by L1/L2.
// E's one warp a row (4 slots a thread, S in 32 bits) barely gained from
// a narrower slab (mac_econ_like: 7.0 us in int8 against 7.4 in float32
// on an H100): a short chain of dependent loads a thread and 1.5 waves
// of small CTAs.  So a thread takes 8 slots (one vector load of slots,
// one of columns), issues every load, then every x gather, then
// multiplies, in CTAs of 512 threads (32 rows): of 4, 8 and 16 slots a
// thread and 128 to 1024 threads a CTA, the fastest in every build on
// the uncut uniform draw but bfloat16, and within 6 % of the fastest on
// mac_econ_like, where 4 slots suit the 4-byte scans better
// (probes_torch/scan_shapes.py: mac_econ_like int8 6.8 -> 4.6 us,
// float32 7.4 -> 6.3).  Pass B reads 2 B of esrc per
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
// entry points with the same arguments.  E's bf16 build loads 2 B of
// value a slot and widens it to float32 (x and the scan float32); F's
// reads the float32 scan and x and 2 B an overflow value, widened as it
// is loaded.
// The `_f16`, `_i8`, `_u8`, `_i16` and `_u16` builds read 2- and 1-byte
// slots, widened to float32 (float16) or int (the integers, sign- or
// zero-extended) as they load; x and the sums stay in that 32-bit type,
// and the wrapper narrows y once (ops/semiring.py finish_y).  F reads the
// scan in the build's Scan type (the narrow integers' sign- or
// zero-extended) and the overflow values in the slab's width.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "values.cuh"

namespace {

using spmv::add_rn;
using spmv::mul_rn;

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

// Kernel E's launch shape: SL consecutive slots of a row a thread (8 at
// 512 threads a CTA, the wrapper's choice, ops/spmv_packed.py
// scan_launch_shape; 4 and 16, and 128 to 1024 threads, for
// probes_torch/scan_shapes.py to time beside it), so G = 128 / SL
// threads a row and 32 / G rows a warp; at most kScanMaxThreads threads
// a CTA, a multiple of 32
constexpr int kScanMaxThreads = 1024;

template <class V, int SL>
__global__ void __launch_bounds__(kScanMaxThreads) packed_scan_kernel(
        const typename V::Slot* __restrict__ vals,
        const int16_t* __restrict__ cols, const int* __restrict__ cstep,
        const typename V::T* __restrict__ x,
        typename V::Scan* __restrict__ out, long long rows,
        int rows_per_step, long long chunk_cols, long long ncols) {
    using T = typename V::T;
    using Scan = typename V::Scan;
    constexpr int G = kRowSlots / SL;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long row = tid / G;
    // uniform over a warp: rows is a multiple of 8, a warp holds 32 / G
    // rows (at most 8) from a multiple of 32 / G
    if (row >= rows) return;
    const int k = (int)(tid % G);
    const long long off = row * kRowSlots + (long long)k * SL;
    // every load first: the slots, their columns and the row's chunk
    spmv::Run<typename V::Slot, SL> v;
    v.load(vals + off);
    spmv::Run<int16_t, SL> c;
    c.load(cols + off);
    const long long xbase =
        (long long)__ldg(cstep + row / rows_per_step) * chunk_cols;
    // then every x gather
    T xv[SL];
#pragma unroll
    for (int j = 0; j < SL; ++j) {
        const long long g = xbase + (c.e[j] & 16383);
        xv[j] = g < ncols ? __ldg(x + g) : T(0);
    }
    // then the products and the thread's own segmented scan
    T s[SL];
    unsigned starts = 0;
#pragma unroll
    for (int j = 0; j < SL; ++j) {
        const T p = mul_rn(V::widen(v.e[j]), xv[j]);
        const bool st = (c.e[j] >> 14) & 1;
        starts |= (unsigned)st << j;
        s[j] = (j == 0 || st) ? p : add_rn(s[j - 1], p);
    }
    // segmented inclusive scan of the row's G (sum, any-start) pairs
    T inc = s[SL - 1];
    int flag = starts != 0;
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
        const T up = __shfl_up_sync(kFullMask, inc, d, G);
        const int up_flag = __shfl_up_sync(kFullMask, flag, d, G);
        if (k >= d) {
            if (!flag) inc = add_rn(up, inc);
            flag |= up_flag;
        }
    }
    const T carry = __shfl_up_sync(kFullMask, inc, 1, G);
    // the carry runs into this thread's slots up to its first start
    const int first = starts ? __ffs(starts) - 1 : SL;
    spmv::Run<Scan, SL> o;
#pragma unroll
    for (int j = 0; j < SL; ++j)
        o.e[j] = (Scan)((k > 0 && j < first) ? add_rn(carry, s[j]) : s[j]);
    o.store(out + off);
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
        const typename V::Scan* __restrict__ scan,
        const int* __restrict__ sblock,
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
                // a narrow integer scan sign- or zero-extends to int
                v[u][j] = src >= 0 ? (T)__ldg(scan + base[u] + src) : T(0);
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

template <class V, int SL>
int launch_scan_at(const void* vals, const int16_t* cols, const int* cstep,
                   const void* x, void* out, long long rows,
                   int rows_per_step, long long chunk_cols, long long ncols,
                   int threads, void* stream) {
    using T = typename V::T;
    using Slot = typename V::Slot;
    using Scan = typename V::Scan;
    constexpr int kV = spmv::Run<Slot, SL>::kVec;
    constexpr int kC = spmv::Run<int16_t, SL>::kVec;
    constexpr int kO = spmv::Run<Scan, SL>::kVec;
    if (threads < 32 || threads > kScanMaxThreads || threads % 32 ||
        rows % 8 || reinterpret_cast<uintptr_t>(vals) % kV ||
        reinterpret_cast<uintptr_t>(cols) % kC ||
        reinterpret_cast<uintptr_t>(out) % kO)
        return (int)cudaErrorInvalidValue;
    if (rows > 0) {
        const long long per_cta = (long long)threads * SL / kRowSlots;
        const long long blocks = (rows + per_cta - 1) / per_cta;
        packed_scan_kernel<V, SL><<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
            static_cast<const Slot*>(vals), cols, cstep,
            static_cast<const T*>(x), static_cast<Scan*>(out), rows,
            rows_per_step, chunk_cols, ncols);
    }
    return (int)cudaGetLastError();
}

// SL from the launch shape: 4, 8 or 16 slots a thread
template <class V>
int launch_scan(const void* vals, const int16_t* cols, const int* cstep,
                const void* x, void* out, long long rows, int rows_per_step,
                long long chunk_cols, long long ncols, int slots_per_thread,
                int threads, void* stream) {
    switch (slots_per_thread) {
#define PACKED_SCAN_SL(SL)                                                  \
        case SL:                                                            \
            return launch_scan_at<V, SL>(vals, cols, cstep, x, out, rows,   \
                                         rows_per_step, chunk_cols, ncols,  \
                                         threads, stream);
        PACKED_SCAN_SL(4)
        PACKED_SCAN_SL(8)
        PACKED_SCAN_SL(16)
#undef PACKED_SCAN_SL
    }
    return (int)cudaErrorInvalidValue;
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
            static_cast<const typename V::Scan*>(scan), sblock, woff, esrc,
            ov_off, ov_lane, ov_cols,
            static_cast<const typename V::Slot*>(ov_vals),
            static_cast<const T*>(x), static_cast<T*>(y), rows, block_slots);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// rows = T * 8 scanned rows; rows_per_step = 8 * step_tiles;
// chunk_cols = chunk_blocks * 128; ncols = columns of x; vals, cols and
// out aligned to the vectors a thread moves (16 bytes at most); x of
// the policy's sum type, out of its Scan type; slots_per_thread (4, 8
// or 16) and threads a CTA: the launch shape
#define PACKED_SCAN_BUILD(sfx, V)                                           \
    extern "C" int packed_scan_##sfx(                                       \
        const void* vals, const int16_t* cols, const int* cstep,            \
        const void* x, void* out, long long rows, int rows_per_step,        \
        long long chunk_cols, long long ncols, int slots_per_thread,        \
        int threads, void* stream) {                                        \
        return launch_scan<V>(vals, cols, cstep, x, out, rows,              \
                              rows_per_step, chunk_cols, ncols,             \
                              slots_per_thread, threads, stream);           \
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
// read); block_slots = step_tiles * 1024; scan of the policy's Scan
// type, x and y of its sum type T, ov_vals of its slots
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
