// Heavy-row subwindow SpMV for Hopper (sm_90a), plain C interface bound
// with ctypes: kernel D.
//
// Replaces the Pallas kernel `_make_subwin_kernel` as run by
// `_subwin_partials` (spmv_vector_cache_tpu/ops/spmv_pallas.py) once per
// W bucket of a ChunkPlan's heavy rows, together with what `_spmv_chunk`
// does to its (T, 128) per-tile partials afterwards: each bucket's segment
// reduce over the unified segment space, the add across buckets, and the
// heavy rows' lane fold.  Kernel D runs once per apply over all the
// plan's heavy subwindow tiles, which placement gathers into one slab
// (formats/tables.py `heavy_tiles`: the buckets' real tiles, stably ordered by
// heavy row, padding dropped) with kernel G's work list over it: one
// int4 record {t0, t1, s0, s1} sums tiles [t0, t1) and heavy rows
// [s0, s1).  A tile t adds
//   (+)_{p, l} vals[t, p, l] (x) x[bases[t, p] * 128 + cols_win[t, p, l]]
// to heavy row tile_row[t], and for each heavy row k the kernel writes
//   y[rows[k]] = y[rows[k]] (+) finish(sum of row k's tiles)
// in place, after the apply's light part has written y.  A row of more
// than RUN_CAP tiles is split over records (kAtomic) that each combine
// with the semiring's atomic (semiring.cuh).  x reads as 0 at columns
// >= ncols, as in the reference's x image zero-padded by W blocks;
// padding slots carry the semiring's zero and offset 0.
//
// Bound: the slab, 6 B per slot (f32 value + int16 offset) and 4 B per
// position row (its base), read once, x's distinct entries and the
// heavy rows of y; a position row's 128 columns are consecutive in a
// heavy row, so its x reads fall within W blocks and are served by
// L1/L2.  The reference's pre-gathered W-block x windows and select tree
// exist only for Mosaic and are not carried over: x is read directly.
// A ChunkPlan has few heavy tiles (52 on scircuit_like), so the kernel is
// bound by latency: one launch instead of one per bucket, up to 8 tiles
// of a record side by side in a CTA (one group of `lanes` threads each,
// a tile's bases, offsets and values loaded before its x reads), the
// record's heavy rows of y loaded while the tiles are, and the tiles'
// sums folded over lanes with warp shuffles and over tiles in shared
// memory, in tile order, so no partials reach device memory.
//
// D has a build for each value policy of values.cuh: the float32 entry
// point, and `_bf16` (2 B values widened to float32, x and y float32),
// `_i32` and `_u32` (plus_times, max_times and or_and, sums wrapping mod
// 2^32) entry points with the same arguments.
// The `_f16`, `_i8`, `_u8`, `_i16` and `_u16` builds read 2- and 1-byte
// slots, widened to float32 (float16) or int (the integers, sign- or
// zero-extended) as they load; x and the sums stay in that 32-bit type,
// and y, which D updates in place, is narrowed once after it
// (ops/semiring.py finish_y).

#include <cuda_runtime.h>
#include <stdint.h>

#include "semiring.cuh"
#include "values.cuh"

namespace {

constexpr long long kBlock = 128;     // columns per x block of `bases`
// bit 30 of a run record's fourth word: one piece of a split row
constexpr int kAtomic = 1 << 30;
// most tiles a CTA sums side by side, one group of `lanes` threads each
constexpr int kMaxGroups = 8;
// most tiles of one record, and most warps of one tile
constexpr int kMaxTiles = 256;
constexpr int kMaxWarps = 8;
// slots whose loads a thread issues before their x reads
constexpr int kBatch = 8;

// blockIdx.x: records in a grid-stride loop; threadIdx.x = group g *
// lanes + lane
template <class S, class V>
__global__ void __launch_bounds__(kMaxGroups * 128)
heavy_runs_kernel(const typename V::Slot* __restrict__ vals,
                  const int16_t* __restrict__ cols_win,
                  const int* __restrict__ bases,
                  const int* __restrict__ tile_row,
                  const int* __restrict__ rows,
                  const int4* __restrict__ runs,
                  const typename V::T* __restrict__ x,
                  typename V::T* __restrict__ y, long long num_runs,
                  int positions, int lanes, long long ncols) {
    using T = typename V::T;
    __shared__ T wsum[kMaxTiles * kMaxWarps];       // a tile's warp sums
    __shared__ int ts[kMaxTiles];
    const int groups = blockDim.x / lanes;
    const int g = threadIdx.x / lanes;
    const int lane = threadIdx.x - g * lanes;
    const int warps = lanes / 32;
    const long long slots = (long long)positions * lanes;
    for (long long rec = blockIdx.x; rec < num_runs; rec += gridDim.x) {
        const int4 run = __ldg(runs + rec);
        const int nt = run.y - run.x;
        const int s0 = run.z;
        const int ns = (run.w & ~kAtomic) - s0;
        const bool atomic = (run.w & kAtomic) != 0;
        for (int j = threadIdx.x; j < nt; j += blockDim.x)
            ts[j] = __ldg(tile_row + run.x + j);
        // thread si < ns writes heavy row s0 + si: its row of y, and the
        // value there, ahead of the sums (ns <= blockDim.x, checked)
        T* dst = nullptr;
        T old = T(0);
        if (threadIdx.x < ns) {
            dst = y + __ldg(rows + s0 + threadIdx.x);
            if (!atomic) old = *dst;
        }
        // 1. each group sums whole tiles, a batch of positions' bases,
        // offsets and values loaded before their x reads
        for (int j = g; j < nt; j += groups) {
            const long long t = run.x + j;
            const int* base = bases + t * positions;
            const long long slot = t * slots + lane;
            T acc = S::init();
            for (int p0 = 0; p0 < positions; p0 += kBatch) {
                long long cc[kBatch];
                T vv[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const bool ok = p0 + u < positions;
                    const long long s = slot + (long long)(p0 + u) * lanes;
                    cc[u] = ok ? (long long)__ldg(base + p0 + u) * kBlock +
                                     __ldg(cols_win + s)
                               : ncols;
                    vv[u] = ok ? V::load(vals + s, 0) : T(0);
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u)
                    if (p0 + u < positions)
                        acc = S::step(acc, vv[u],
                                      cc[u] < ncols ? __ldg(x + cc[u])
                                                    : T(0));
            }
            // the tile's lanes: a warp's 32 by shuffles, then its warps
            for (int off = 16; off > 0; off >>= 1)
                acc = S::add(acc, __shfl_xor_sync(0xffffffffu, acc, off));
            if ((lane & 31) == 0) wsum[j * warps + lane / 32] = acc;
        }
        __syncthreads();
        // 2. each heavy row of the record: its tiles in tile order
        if (threadIdx.x < ns) {
            T acc = S::init();
            for (int j = 0; j < nt; ++j)
                if (ts[j] == s0 + (int)threadIdx.x)
                    for (int w = 0; w < warps; ++w)
                        acc = S::add(acc, wsum[j * warps + w]);
            if (atomic)
                S::atomic(dst, S::finish(acc));
            else
                *dst = S::add(old, S::finish(acc));
        }
        __syncthreads();            // before the next record's tile sums
    }
}

template <class V>
int launch_heavy(const void* vals, const int16_t* cols_win, const int* bases,
                 const int* tile_row, const int* rows, const int* runs,
                 const void* x, void* y, long long num_runs, int positions,
                 int lanes, long long ncols, int max_tiles, int max_slices,
                 int semiring, void* stream) {
    using T = typename V::T;
    if (positions < 1 || lanes < 32 || lanes % 32 ||
        lanes > 32 * kMaxWarps || max_tiles < 1 || max_tiles > kMaxTiles ||
        max_slices < 1 || max_slices > lanes)
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)runs % 16) return (int)cudaErrorMisalignedAddress;
    if (num_runs <= 0) return (int)cudaGetLastError();
    // a group per tile of the longest record, as many as a CTA holds
    int groups = max_tiles < kMaxGroups ? max_tiles : kMaxGroups;
    if (groups * lanes > kMaxGroups * 128) groups = kMaxGroups * 128 / lanes;
    const unsigned blocks =
        (unsigned)(num_runs < (1LL << 20) ? num_runs : (1LL << 20));
    using W = typename V::Wrap;
    cudaError_t err = spmv::with_semiring<T, W>(semiring, [&](auto s) {
        heavy_runs_kernel<decltype(s), V>
            <<<blocks, groups * lanes, 0, (cudaStream_t)stream>>>(
                static_cast<const typename V::Slot*>(vals), cols_win, bases,
                tile_row, rows, reinterpret_cast<const int4*>(runs),
                static_cast<const T*>(x), static_cast<T*>(y), num_runs,
                positions, lanes, ncols);
    });
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// vals, cols_win: (tiles, positions, lanes) values / int16; bases:
// (tiles, positions) int32; tile_row: (tiles,) int32, nondecreasing;
// rows: (heavy rows,) int32 rows of y; runs: (num_runs, 4) int32 records
// of at most max_tiles tiles and max_slices heavy rows each; x: (ncols,);
// y: updated in place.
// lanes a multiple of 32, at most 256; runs 16-byte aligned.  semiring:
// a code of semiring.cuh
#define SPMV_SUBWIN_BUILD(sfx, V)                                           \
    extern "C" int spmv_subwin_##sfx(                                       \
        const void* vals, const int16_t* cols_win, const int* bases,        \
        const int* tile_row, const int* rows, const int* runs,              \
        const void* x, void* y, long long num_runs, int positions,          \
        int lanes, long long ncols, int max_tiles, int max_slices,          \
        int semiring, void* stream) {                                       \
        return launch_heavy<V>(vals, cols_win, bases, tile_row, rows, runs, \
                               x, y, num_runs, positions, lanes, ncols,     \
                               max_tiles, max_slices, semiring, stream);    \
    }

SPMV_SUBWIN_BUILD(f32, spmv::F32Values)
SPMV_SUBWIN_BUILD(bf16, spmv::Bf16Values)
SPMV_SUBWIN_BUILD(i32, spmv::I32Values)
SPMV_SUBWIN_BUILD(u32, spmv::U32Values)
SPMV_SUBWIN_BUILD(f16, spmv::F16Values)
SPMV_SUBWIN_BUILD(i8, spmv::I8Values)
SPMV_SUBWIN_BUILD(u8, spmv::U8Values)
SPMV_SUBWIN_BUILD(i16, spmv::I16Values)
SPMV_SUBWIN_BUILD(u16, spmv::U16Values)
