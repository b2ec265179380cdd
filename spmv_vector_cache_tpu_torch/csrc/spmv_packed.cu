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
// the apply is E then F and nothing else.  It reads no dense extraction
// index.  The plan's esrc, (visits, 64, 128) int16 with a -1 wherever a
// row of the visited window has no piece, is compacted once at placement
// (formats/tables.py extract_tables) into a list of what each y row sums, in
// CSR form over the rows:
//   entries[row_off[r] .. row_off[r+1]) = the S slots of r's primary
//       pieces (sblock[i]*ST*1024 + esrc[i, e], >= 0), in visit order,
//       then -1 - j for each of r's overflow entries j (ov_cols and
//       ov_vals sorted stably by row), in the plan's order
//   y[r] = the sum of S[slot] over its slots and of ov_vals[j] *
//          x[ov_cols[j]] over its overflow entries (0 for none)
// On the TPU the grid walks the visits in order with the window's y
// block resident; here each CTA takes one unit of rows from a work list
// built at placement with the list (`units`, no search at run time):
// either consecutive rows whose rows plus entries ("merge steps") fit
// kFUnit = PACKED_F_THREADS x PACKED_F_ITEMS, or one hub row with more.
// In an ordinary unit the CTA stages every entry's term in shared memory
// (a thread issues its PACKED_F_ITEMS coalesced list loads, then their S
// gathers or overflow products) beside each row's end, and each thread
// then takes PACKED_F_ITEMS consecutive steps of the unit's merge path
// over (row ends, entries), found by a binary search (Merrill and
// Garland's merge-based CSR SpMV): a CTA's work is even whatever its
// rows' lengths, empty rows included.  A row that spans threads is
// joined by a segmented scan of the threads' tails.  A hub row's CTA
// sums a strided share a thread, PACKED_F_ITEMS loads in flight, then
// reduces the threads' sums.  Hub units come first in the grid, the
// longest first, so they start in the first wave; the rest follow in row
// order, so the CTAs that run together read neighbouring rows' pieces,
// which sit close in S ((chunk, row) order), through L2.
//
// Summation order, fixed by the list alone, so y is the same every run
// (no atomic; each row written once, by one thread): in an ordinary unit
// each thread adds its own terms of a row one after another; the partial
// sums of a row from earlier threads combine in the scan (a shuffle tree
// within a warp, then the warps' totals folded in warp order), and the
// thread that holds the row's end adds its terms to that carry one after
// another.  A hub row: thread t adds entries t, t + PACKED_F_THREADS, ...
// in order, then a shuffle tree within each warp and the warps' sums in
// warp order.  (The plain version adds a row's entries in list order.)
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
// float32 7.4 -> 6.3).  Pass B reads 4 B of list an entry, the S entries
// the list picks (S at most once: neighbouring rows share its sectors),
// 4 B of row offset a row, 16 B of work list a CTA, the overflow values
// and columns with the x they read, and writes y once.  The dense esrc
// it read before took 2 B for every row of a window at every visit: on
// GAP's kron graph at scale 21, 2.27 GB an apply, 97 % of it -1, where
// the list is 145 MB.  On an H100 that draw's F moves its 314 MB in
// 286 us (33 % of the 94-us bound) against the dense table's 2.60 ms
// (probes_torch/extract_shapes.py; PERF.md).  Of 128 to 1024 threads a
// CTA and 4, 8 and 16 steps a thread, 512 x 4 was the fastest there
// (256 x 8: 347 us, 128 x 8: 476); a branch per entry between a gather
// and an overflow product, in place of every gather first, took 326 us,
// and re-reading the terms from shared memory in the second walk 289.
// What holds F at a third of its bound is not measured apart: each 4-B
// gather moves a 32-B sector, and a CTA waits on a chain of three
// dependent loads (its work-list record, its list, the gathers).  That
// chain is why the smaller mac_econ_like plan loses: its F takes 10.0 us
// against the dense table's 6.5 (1.4 waves of CTAs; the list's bound
// 2.8 us against 4.9).
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

constexpr int kRowSlots = 128;        // slots per scanned row
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
// these: threads a CTA, and merge steps (entries or row ends) a thread
// takes, so a CTA's unit is their product (formats/tables.py F_UNIT, by which
// placement cuts the work list: the launch refuses a larger one)
#ifndef PACKED_F_THREADS
#define PACKED_F_THREADS 512
#endif
#ifndef PACKED_F_ITEMS
#define PACKED_F_ITEMS 4
#endif

constexpr int kFThreads = PACKED_F_THREADS;
constexpr int kFItems = PACKED_F_ITEMS;
constexpr int kFUnit = kFThreads * kFItems;
constexpr int kFWarps = kFThreads / 32;
// a unit's terms and row ends in shared memory, one word of padding
// after every 32 (f_skew), so that the threads of a warp, each at its own
// run of the merge path, mostly fall in distinct banks
constexpr int kFSlots = kFUnit + kFUnit / 32;
static_assert(kFThreads % 32 == 0 && kFThreads <= 1024 && kFItems >= 1 &&
                  kFItems <= 32,
              "kernel F's launch shape");
static_assert(kFSlots * 8 <= 48 * 1024,
              "a unit's terms and row ends fit static shared memory");

__device__ __forceinline__ int f_skew(int j) { return j + (j >> 5); }

// the terms of kFItems entries e[k] (where live[k]): a primary piece's sum
// from the scan (a narrow integer scan sign- or zero-extends to int), or
// an overflow product.  Straight-line, so that every load of a kind is
// in flight together: each piece's gather, then each overflow entry's
// value and column, then its x
template <class V, int K>
__device__ __forceinline__ void f_terms(
        const typename V::Scan* __restrict__ scan,
        const int* __restrict__ ov_cols,
        const typename V::Slot* __restrict__ ov_vals,
        const typename V::T* __restrict__ x, const int (&e)[K],
        const bool (&live)[K], typename V::T (&v)[K]) {
    using T = typename V::T;
    using OV = typename V::Slot;
#pragma unroll
    for (int k = 0; k < K; ++k)
        v[k] = live[k] && e[k] >= 0 ? (T)__ldg(scan + e[k]) : T(0);
    bool any = false;
#pragma unroll
    for (int k = 0; k < K; ++k) any |= live[k] && e[k] < 0;
    if (!any) return;
    int col[K];
    OV val[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const bool o = live[k] && e[k] < 0;
        col[k] = o ? __ldg(ov_cols + (-1 - e[k])) : 0;
        val[k] = o ? __ldg(ov_vals + (-1 - e[k])) : OV(0);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
        if (live[k] && e[k] < 0)
            v[k] = mul_rn(V::widen(val[k]), __ldg(x + col[k]));
}

// blockDim kFThreads; CTA u sums rows [units[u].x, units[u].y), whose
// entries are [units[u].z, units[u].w); V: the value policy (T the sum
// type, the overflow values its slots, widened as they load)
template <class V, class T = typename V::T, class OV = typename V::Slot>
__global__ void __launch_bounds__(kFThreads) packed_rows_kernel(
        const typename V::Scan* __restrict__ scan,
        const int* __restrict__ row_off, const int* __restrict__ entries,
        const int4* __restrict__ units, const int* __restrict__ ov_cols,
        const OV* __restrict__ ov_vals, const T* __restrict__ x,
        T* __restrict__ y) {
    // the unit's terms and each row's end (from its first entry); the
    // warps' scan totals and their flags
    __shared__ T term[kFSlots];
    __shared__ int row_end[kFSlots];
    __shared__ T wsum[kFWarps];
    __shared__ int wflag[kFWarps];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int4 u = __ldg(units + blockIdx.x);
    const long long r0 = u.x;
    const int nrows = u.y - u.x, e0 = u.z, nent = u.w - u.z;
    const int* __restrict__ mine = entries + e0;

    if (nrows + nent > kFUnit) {
        // a hub row (placement gives a longer unit one row): a strided
        // share a thread, kFItems loads, then their terms, then the sum
        T acc = T(0);
        for (int b = 0; b < nent; b += kFUnit) {
            int e[kFItems];
            bool live[kFItems];
#pragma unroll
            for (int k = 0; k < kFItems; ++k) {
                const int j = b + k * kFThreads + t;
                live[k] = j < nent;
                e[k] = live[k] ? __ldg(mine + j) : 0;
            }
            T v[kFItems];
            f_terms<V>(scan, ov_cols, ov_vals, x, e, live, v);
#pragma unroll
            for (int k = 0; k < kFItems; ++k)
                if (live[k]) acc = add_rn(acc, v[k]);
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
            acc = add_rn(acc, __shfl_down_sync(kFullMask, acc, d));
        if (lane == 0) wsum[warp] = acc;
        __syncthreads();
        if (t == 0) {
            T s = wsum[0];
            for (int w = 1; w < kFWarps; ++w) s = add_rn(s, wsum[w]);
            y[r0] = s;
        }
        return;
    }

    // stage the terms and the row ends: every list and row-offset load,
    // then every gather, coalesced (a unit holds at most kFUnit of each)
    {
        int e[kFItems], re[kFItems];
        bool live[kFItems];
#pragma unroll
        for (int k = 0; k < kFItems; ++k) {
            const int j = k * kFThreads + t;
            live[k] = j < nent;
            e[k] = live[k] ? __ldg(mine + j) : 0;
            re[k] = j < nrows ? __ldg(row_off + r0 + 1 + j) - e0 : 0;
        }
        T v[kFItems];
        f_terms<V>(scan, ov_cols, ov_vals, x, e, live, v);
#pragma unroll
        for (int k = 0; k < kFItems; ++k) {
            const int j = k * kFThreads + t;
            if (live[k]) term[f_skew(j)] = v[k];
            if (j < nrows) row_end[f_skew(j)] = re[k];
        }
    }
    __syncthreads();

    // this thread's steps: from diagonal d of the merge path, where the
    // path has taken i row ends and d - i entries (entry j belongs to the
    // first row whose end is past it)
    const int total = nrows + nent;
    const int d = min(t * kFItems, total);
    int lo = max(0, d - nent), hi = min(d, nrows);
    while (lo < hi) {
        const int p = (lo + hi) >> 1;
        if (row_end[f_skew(p)] <= d - p - 1)
            lo = p + 1;
        else
            hi = p;
    }
    const int i0 = lo, j0 = d - lo;
    const int steps = min(kFItems, total - d);

    // the steps' terms (0 at a row end) and which steps end a row, kept
    // for the second walk; the sum of the terms after the last row end
    T v[kFItems];
    unsigned ends = 0;
    T tail = T(0);
    {
        int i = i0, j = j0;
        int end = i < nrows ? row_end[f_skew(i)] : 0;
#pragma unroll
        for (int s = 0; s < kFItems; ++s) {
            v[s] = T(0);
            if (s < steps) {
                if (j < end) {
                    v[s] = term[f_skew(j)];
                    tail = add_rn(tail, v[s]);
                    ++j;
                } else {
                    ends |= 1u << s;
                    tail = T(0);
                    ++i;
                    end = i < nrows ? row_end[f_skew(i)] : 0;
                }
            }
        }
    }

    // segmented exclusive scan of (tail, ends != 0) over the CTA: the
    // carry of the row this thread starts in, from the threads before it
    T s = tail;
    int f = ends != 0;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
        const T up = __shfl_up_sync(kFullMask, s, dd);
        const int up_f = __shfl_up_sync(kFullMask, f, dd);
        if (lane >= dd) {
            if (!f) s = add_rn(up, s);
            f |= up_f;
        }
    }
    if (lane == 31) {
        wsum[warp] = s;
        wflag[warp] = f;
    }
    const T ex = __shfl_up_sync(kFullMask, s, 1);
    const int ex_f = __shfl_up_sync(kFullMask, f, 1);
    __syncthreads();
    T carry = T(0);
    for (int w = 0; w < warp; ++w)
        carry = (w == 0 || wflag[w]) ? wsum[w] : add_rn(carry, wsum[w]);
    if (lane > 0) carry = (ex_f || warp == 0) ? ex : add_rn(carry, ex);

    // the steps again: a row's end writes its sum
    T run = carry;
    long long row = r0 + i0;
#pragma unroll
    for (int k = 0; k < kFItems; ++k) {
        if (k < steps) {
            if ((ends >> k) & 1) {
                y[row++] = run;
                run = T(0);
            } else {
                run = add_rn(run, v[k]);
            }
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
int launch_rows(const void* scan, const int* row_off, const int* entries,
                const int* units, const int* ov_cols, const void* ov_vals,
                const void* x, void* y, long long num_units, int unit,
                void* stream) {
    using T = typename V::T;
    if (unit < 1 || unit > kFUnit || num_units >= (1LL << 31) ||
        reinterpret_cast<uintptr_t>(units) % 16)
        return (int)cudaErrorInvalidValue;
    if (num_units > 0)
        packed_rows_kernel<V><<<(unsigned)num_units, kFThreads, 0,
                                (cudaStream_t)stream>>>(
            static_cast<const typename V::Scan*>(scan), row_off, entries,
            reinterpret_cast<const int4*>(units), ov_cols,
            static_cast<const typename V::Slot*>(ov_vals),
            static_cast<const T*>(x), static_cast<T*>(y));
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

// y: one sum a row of the units, written once; row_off, entries: the
// compacted list (formats/tables.py extract_tables); units: num_units (first
// row, end row, first entry, end entry) records, 16-byte aligned, each
// of at most `unit` merge steps or one row (unit at most
// PACKED_F_THREADS * PACKED_F_ITEMS); ov_cols, ov_vals, x:
// the overflow, null where the list holds none (x is then not read);
// scan of the policy's Scan type, x and y of its sum type T, ov_vals of
// its slots
#define PACKED_EXTRACT_BUILD(sfx, V)                                        \
    extern "C" int packed_extract_##sfx(                                    \
        const void* scan, const int* row_off, const int* entries,           \
        const int* units, const int* ov_cols, const void* ov_vals,          \
        const void* x, void* y, long long num_units, int unit,              \
        void* stream) {                                                     \
        return launch_rows<V>(scan, row_off, entries, units, ov_cols,       \
                              ov_vals, x, y, num_units, unit, stream);      \
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
