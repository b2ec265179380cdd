// SELL SpMV over global column ids for Hopper (sm_90a), plain C interface
// bound with ctypes: kernel G (float32, five semirings) and its float64
// build, kernel L (plus_times).
//
// Kernel G replaces three Pallas kernels of
// spmv_vector_cache_tpu/ops/spmv_pallas.py, which compute one function and
// differ only in where x lives on a TPU: `_make_resident_kernel` (x in
// VMEM, a select tree over <= 64 blocks), `_make_deep_kernel` (a loop over
// <= 2048 VMEM blocks) and `_make_stream_kernel` (x gathered by XLA before
// the kernel), together with the slice reduction that follows them in
// `_spmv_resident` / `_spmv_deep` / `_spmv_stream`.  A tile t's slot
// (p, l) holds vals[t, p, l] at column cols[t, p, l]; x reads as the
// semiring's annihilated 0 at a column >= cols, as in the reference's
// zero-padded x image, and padding slots carry column 0 and the
// semiring's zero.  The tiles of one slice are one contiguous run
// (tile_slice is nondecreasing), and kernel G writes
//   parts == 0:  S[s, l] = (+) over the run of slice s, over p, of
//                vals (x) x[cols]                           (slices, R)
//   parts >= 1:  y[s * R/parts + r] = (+)_{q < parts} S[s, q * R/parts + r]
//                for rows < out_rows: the lane fold of a uniform-parts
//                plan (parts = p) or the identity map (parts = 1)
// from the work list of kernel H (formats/tables.py `tile_runs`, built at
// placement): one int4 record {t0, t1, s0, s1} sums tiles [t0, t1) and
// writes slices [s0, s1); a piece of a slice split over several records
// (kAtomic) combines into an output preset to the semiring's init with
// the semiring's atomic (semiring.cuh): an add in no fixed order under
// plus_times, order-free min and max under the others.  So no per-tile
// partials reach device memory and no reduction pass follows.
//
// Bound: the nonzero stream, 8 B per slot (f32 value + int32 column),
// read once, x's distinct entries and the output once.  x is gathered
// through L1 (which holds all of a resident route's x, <= 32 KB) and
// L2: a gather from device memory costs a whole 32-byte L2 sector per
// 4-byte x entry, and on the deep draw's uniform columns the gathers
// bound the kernel.  Two on-chip homes for x lost to L2 on the H100
// (PERF.md): a copy of x in each CTA's shared memory costs more than
// the L1 misses it saves on the cached tier 2, and x split over a
// thread-block cluster's distributed shared memory took 2.4-2.8 times
// as long on the deep and 2^19-column draws (4-byte remote reads).
// Design: two shapes of one computation, chosen at launch from the
// plan.  Neighbouring threads take neighbouring lanes, so every vals/cols
// load of a warp is 128 contiguous bytes, and a thread issues a batch of
// its tile's column and value loads before their x gathers (tile_sum).
// * global_runs_kernel: a persistent CTA takes records in a grid-stride
//   loop; its 2 groups of R threads sum the record's tiles side by side;
//   the tile sums meet in shared memory, where each slice's are added in
//   tile order and folded into rows.  It serves the lane fold of a
//   uniform-parts plan and plans with no more records than CTAs resident
//   at once (the cached tier 2: each record's chain of tiles halved).
// * global_rows_kernel: one thread per (record, lane) sums each slice's
//   tiles in tile order in registers and writes the row: no shared memory
//   and no barrier, so no warp waits on another's gathers.  It serves the
//   identity map and slice sums when records outnumber the resident CTAs
//   (the deep draws: G 7-8 % and L 16-17 % faster than in
//   global_runs_kernel, PERF.md).

// Kernel L is kernel G's body under the float64 pair policy (values.cuh),
// plus_times only.  It replaces the double-float stream kernel
// `_make_stream_kernel_df` (run by `_spmv_stream_df` over hi/lo x
// pre-gathered at `cols`) and the slice reduction after it: a double
// plan's vals are (T, 2P, R) hi/lo float32 pairs (the lo word
// positions * lanes floats after its hi word) while cols stays
// (T, P, R); L reads a float64 x at `cols` directly, sums, keeps tile and
// slice sums in shared memory and writes y in float64, and combines a
// split slice's pieces with a float64 atomicAdd into an output preset to
// 0.0.  The port runs every windowless double plan on it, whatever
// strategy name the operator hands over.  Bound: 12 B per slot (hi, lo,
// column) read once, x's distinct entries and y once; as for G, the
// x gathers through L1/L2 bound it (a 32-byte sector per 8-byte x entry
// on uniform columns; x is 2 MB of float64 on the deep draw, past a
// CTA's 227 KB of shared memory, and the on-chip homes of x lost to L2
// for G on the same draw, PERF.md).
//
// G has a build for each value policy of values.cuh: the float32 entry
// point, and `_bf16` (2 B values widened to float32, x and y float32),
// `_i32` and `_u32` (plus_times, max_times and or_and; sums wrapping mod
// 2^32, a split slice's pieces combined with the integer atomicAdd and
// atomicMax) entry points with the same arguments.
// The `_f16`, `_i8`, `_u8`, `_i16` and `_u16` builds read 2- and 1-byte
// slots, widened to float32 (float16) or int (the integers, sign- or
// zero-extended) as they load; x and the sums stay in that 32-bit type,
// and the wrapper narrows y once (ops/semiring.py finish_y).  The narrow
// integers' split slices combine in 32 bits too (there are no 8- or
// 16-bit atomics), before y is narrowed.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "semiring.cuh"
#include "values.cuh"

namespace {

// bit 30 of a run record's fourth word: one piece of a split slice
constexpr int kAtomic = 1 << 30;
// threads of kernel G's CTA: 2 groups of 128 lanes, each summing a tile
constexpr int kThreadsG = 256;
// slots whose column and value loads a thread of global_runs_kernel
// issues before their gathers (global_rows_kernel: 16 bytes of values, 4
// floats or 2 doubles, which measured best for L on the deep draw and
// tied for G, PERF.md)
constexpr int kBatch = 8;
// Hopper's shared memory per block
constexpr size_t kMaxSmem = 227 * 1024;

// Tile t's sum over its positions at `lane`: batches of `batch` column
// and value loads, each batch issued before its x gathers.
template <class S, class V, int batch>
__device__ __forceinline__ typename V::T tile_sum(
    const typename V::Slot* __restrict__ vals, const int* __restrict__ cols,
    const typename V::T* __restrict__ x, long long t, int lane,
    int positions, int lanes, long long ncols) {
    using T = typename V::T;
    const long long slots = (long long)positions * lanes;   // one channel
    const typename V::Slot* v = vals + t * slots * V::kChannels + lane;
    const int* c = cols + t * slots + lane;
    T acc = S::init();
    for (int p0 = 0; p0 < positions; p0 += batch) {
        int cc[batch];
        T vv[batch];
#pragma unroll
        for (int u = 0; u < batch; ++u) {
            const bool ok = p0 + u < positions;
            cc[u] = ok ? __ldg(c + (p0 + u) * lanes) : -1;
            vv[u] = ok ? V::load(v + (p0 + u) * lanes, slots) : T(0);
        }
#pragma unroll
        for (int u = 0; u < batch; ++u)
            if (p0 + u < positions)
                acc = S::step(acc, vv[u],
                              cc[u] >= 0 && cc[u] < ncols ? __ldg(x + cc[u])
                                                          : T(0));
    }
    return acc;
}

// The output of one row of a slice: written, or combined with the
// semiring's atomic into an output preset to its init (a split slice).
template <class S, class T>
__device__ __forceinline__ void put(T* out, long long row, T acc,
                                   bool atomic) {
    if (atomic)
        S::atomic(out + row, S::finish(acc));
    else
        out[row] = S::finish(acc);
}

// blockIdx.x = a persistent CTA; threadIdx.x = group g * lanes + lane.
// Shared memory: a record's tile sums (max_tiles rows of `lanes`), its
// slice sums (max_slices rows), both in the policy's type V::T, then its
// tile_slice entries.  V::load reads a slot's value (F32Values: kernel G;
// PairValues: kernel L, its lo word `slots` floats after the hi word).
template <class S, class V>
__global__ void __launch_bounds__(kThreadsG)
global_runs_kernel(const typename V::Slot* __restrict__ vals,
                   const int* __restrict__ cols,
                   const int* __restrict__ tile_slice,
                   const int4* __restrict__ runs,
                   const typename V::T* __restrict__ x,
                   typename V::T* __restrict__ out, long long num_runs,
                   int positions, int lanes, long long ncols, int parts,
                   long long out_rows, int max_tiles, int max_slices) {
    using T = typename V::T;
    extern __shared__ __align__(16) unsigned char smem[];
    const int groups = blockDim.x / lanes;
    const int g = threadIdx.x / lanes;
    const int lane = threadIdx.x - g * lanes;
    T* part = reinterpret_cast<T*>(smem);              // tile sums
    T* sums = part + max_tiles * lanes;                // slice sums
    int* ts = reinterpret_cast<int*>(sums + max_slices * lanes);
    for (long long rec = blockIdx.x; rec < num_runs; rec += gridDim.x) {
        const int4 run = __ldg(runs + rec);
        const int nt = run.y - run.x;
        const int s0 = run.z;
        const int ns = (run.w & ~kAtomic) - s0;
        const bool atomic = (run.w & kAtomic) != 0;
        if (threadIdx.x < nt) ts[threadIdx.x] = __ldg(tile_slice + run.x +
                                                      threadIdx.x);
        // 1. each group sums whole tiles of the record, its positions'
        // column and value loads issued before their x gathers
        for (int j = g; j < nt; j += groups)
            part[j * lanes + lane] = tile_sum<S, V, kBatch>(
                vals, cols, x, run.x + j, lane, positions, lanes, ncols);
        __syncthreads();
        // 2. each slice's tiles, in tile order
        for (int si = g; si < ns; si += groups) {
            T acc = S::init();
            for (int j = 0; j < nt; ++j)
                if (ts[j] == s0 + si)
                    acc = S::add(acc, part[j * lanes + lane]);
            sums[si * lanes + lane] = acc;
        }
        __syncthreads();
        // 3. the slices' rows: the lane fold, or the sums as they are
        const int rps = parts > 1 ? lanes / parts : lanes;
        for (int e = threadIdx.x; e < ns * rps; e += blockDim.x) {
            const int si = e / rps, r = e - si * rps;
            T acc = sums[si * lanes + r];
            for (int q = 1; q < parts; ++q)
                acc = S::add(acc, sums[si * lanes + q * rps + r]);
            const long long row = (long long)(s0 + si) * rps + r;
            if (parts == 0 || row < out_rows) put<S>(out, row, acc, atomic);
        }
        __syncthreads();                // before the next record's sums
    }
}

// parts <= 1.  blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes =
// the record, threadIdx.x % lanes = the lane; a warp holds one record.
template <class S, class V>
__global__ void __launch_bounds__(kThreadsG)
global_rows_kernel(const typename V::Slot* __restrict__ vals,
                   const int* __restrict__ cols,
                   const int* __restrict__ tile_slice,
                   const int4* __restrict__ runs,
                   const typename V::T* __restrict__ x,
                   typename V::T* __restrict__ out, long long num_runs,
                   int positions, int lanes, long long ncols, int parts,
                   long long out_rows) {
    using T = typename V::T;
    const long long rec = (long long)blockIdx.x * (blockDim.x / lanes) +
                          threadIdx.x / lanes;
    const int lane = threadIdx.x % lanes;
    if (rec >= num_runs) return;
    const int4 run = __ldg(runs + rec);
    const bool atomic = (run.w & kAtomic) != 0;
    const int s1 = run.w & ~kAtomic;
    for (int s = run.z, t = run.x; s < s1; ++s) {
        T acc = S::init();
        for (; t < run.y && __ldg(tile_slice + t) == s; ++t)
            acc = S::add(acc, tile_sum<S, V, (int)(16 / sizeof(T))>(
                                  vals, cols, x, t, lane, positions, lanes,
                                  ncols));
        const long long row = (long long)s * lanes + lane;
        if (parts == 0 || row < out_rows) put<S>(out, row, acc, atomic);
    }
}

// How many CTAs of `fn` fit on the card at once, cached by (kernel,
// shared memory, device).
struct Fit {
    const void* fn;
    size_t smem;
    int device, count;
};

int resident(const void* fn, int threads, size_t smem) {
    static std::mutex mu;
    static std::vector<Fit> fits;
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess) return 0;
    std::lock_guard<std::mutex> lock(mu);
    for (const Fit& f : fits)
        if (f.fn == fn && f.smem == smem && f.device == device)
            return f.count;
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem) != cudaSuccess)
        return 0;
    fits.push_back({fn, smem, device, sms * per_sm});
    return sms * per_sm;
}

template <class S, class V>
cudaError_t launch_runs(const typename V::Slot* vals, const int* cols,
                        const int* tile_slice, const int* runs,
                        const typename V::T* x, typename V::T* out,
                        long long num_runs, int positions, int lanes,
                        long long ncols, int parts, long long out_rows,
                        int max_tiles, int max_slices, cudaStream_t stream) {
    auto fn = global_runs_kernel<S, V>;
    const int threads = max(1, kThreadsG / lanes) * lanes;
    const size_t smem =
        (size_t)(max_tiles + max_slices) * lanes * sizeof(typename V::T) +
        (size_t)(max_tiles + 3) / 4 * 4 * sizeof(int);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int fit = resident((const void*)fn, threads, smem);
    if (fit <= 0) return cudaErrorInvalidConfiguration;
    if (parts <= 1 && num_runs > fit) {
        // more records than resident CTAs: one thread per (record, lane)
        const int per = threads / lanes;
        global_rows_kernel<S, V>
            <<<(unsigned)((num_runs + per - 1) / per), threads, 0,
               stream>>>(
            vals, cols, tile_slice, reinterpret_cast<const int4*>(runs), x,
            out, num_runs, positions, lanes, ncols, parts, out_rows);
        return cudaSuccess;
    }
    // as many CTAs as fit at once, and no more than there are records
    const long long n = num_runs < fit ? num_runs : fit;
    fn<<<(unsigned)n, threads, smem, stream>>>(
        vals, cols, tile_slice, reinterpret_cast<const int4*>(runs), x, out,
        num_runs, positions, lanes, ncols, parts, out_rows, max_tiles,
        max_slices);
    return cudaSuccess;
}

// the entry points' shared refusals: 0, or a cudaError_t
int refuse(const int* runs, int positions, int lanes, int parts,
           int max_tiles, int max_slices) {
    if (positions < 1 || lanes < 32 || lanes % 32 || lanes > kThreadsG ||
        max_tiles < 0 || max_tiles > kThreadsG || max_slices < 0 ||
        parts < 0 || (parts > 1 && lanes % parts))
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)runs % 16) return (int)cudaErrorMisalignedAddress;
    return 0;
}

template <class V>
int launch_global(const void* vals, const int* cols, const int* tile_slice,
                  const int* runs, const void* x, void* out,
                  long long num_runs, int positions, int lanes,
                  long long ncols, int parts, long long out_rows,
                  int max_tiles, int max_slices, int semiring,
                  void* stream) {
    using T = typename V::T;
    if (int bad = refuse(runs, positions, lanes, parts, max_tiles,
                         max_slices))
        return bad;
    if (num_runs <= 0) return (int)cudaGetLastError();
    cudaError_t err = cudaErrorInvalidValue;
    using W = typename V::Wrap;
    cudaError_t bad = spmv::with_semiring<T, W>(semiring, [&](auto sr) {
        err = launch_runs<decltype(sr), V>(
            static_cast<const typename V::Slot*>(vals), cols, tile_slice,
            runs, static_cast<const T*>(x), static_cast<T*>(out), num_runs,
            positions, lanes, ncols, parts, out_rows, max_tiles, max_slices,
            (cudaStream_t)stream);
    });
    if (bad != cudaSuccess) return (int)bad;
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// vals, cols: (tiles, positions, lanes); runs: (num_runs, 4) int32
// records, of at most max_tiles tiles and max_slices slices each; out:
// (num_slices, lanes) when parts == 0, else (out_rows,),
// preset to the semiring's init by the caller when a record carries
// kAtomic.  lanes a multiple of 32, runs 16-byte aligned.  semiring: a
// code of semiring.cuh.  x and out: the policy's sum type.
#define SPMV_SELL_GLOBAL_BUILD(sfx, V)                                      \
    extern "C" int spmv_sell_global_##sfx(                                  \
        const void* vals, const int* cols, const int* tile_slice,           \
        const int* runs, const void* x, void* out, long long num_runs,      \
        int positions, int lanes, long long ncols, int parts,               \
        long long out_rows, int max_tiles, int max_slices, int semiring,    \
        void* stream) {                                                     \
        return launch_global<V>(vals, cols, tile_slice, runs, x, out,       \
                                num_runs, positions, lanes, ncols, parts,   \
                                out_rows, max_tiles, max_slices, semiring,  \
                                stream);                                    \
    }

SPMV_SELL_GLOBAL_BUILD(f32, spmv::F32Values)
SPMV_SELL_GLOBAL_BUILD(bf16, spmv::Bf16Values)
SPMV_SELL_GLOBAL_BUILD(i32, spmv::I32Values)
SPMV_SELL_GLOBAL_BUILD(u32, spmv::U32Values)
SPMV_SELL_GLOBAL_BUILD(f16, spmv::F16Values)
SPMV_SELL_GLOBAL_BUILD(i8, spmv::I8Values)
SPMV_SELL_GLOBAL_BUILD(u8, spmv::U8Values)
SPMV_SELL_GLOBAL_BUILD(i16, spmv::I16Values)
SPMV_SELL_GLOBAL_BUILD(u16, spmv::U16Values)

// Kernel L: as spmv_sell_global_f32, plus_times, over a double plan:
// vals the (tiles, 2*positions, lanes) hi/lo slab, cols (tiles,
// positions, lanes), x and out float64 (out preset to 0.0 by the caller
// when a record carries kAtomic)
extern "C" int spmv_sell_global_f64(const float* vals, const int* cols,
                                    const int* tile_slice, const int* runs,
                                    const double* x, double* out,
                                    long long num_runs, int positions,
                                    int lanes, long long ncols, int parts,
                                    long long out_rows, int max_tiles,
                                    int max_slices, void* stream) {
    if (int bad = refuse(runs, positions, lanes, parts, max_tiles,
                         max_slices))
        return bad;
    if (num_runs <= 0) return (int)cudaGetLastError();
    cudaError_t err =
        launch_runs<spmv::PlusTimesF64, spmv::PairValues>(
            vals, cols, tile_slice, runs, x, out, num_runs, positions, lanes,
            ncols, parts, out_rows, max_tiles, max_slices,
            (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
