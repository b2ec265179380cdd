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
// from the work list of kernel H (ops/spmm_sell.py `tile_runs`, built at
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
// Design: a persistent CTA takes records in a grid-stride loop; its 2
// groups of R threads (one per lane, neighbouring threads on
// neighbouring lanes, so every vals/cols load of a warp is 128
// contiguous bytes) sum the record's tiles side by side, each issuing a
// tile's column and value loads, eight positions at a time, before their
// x gathers; the tile sums then meet in shared memory, where each
// slice's are added in tile order and folded into rows.

// Kernel L replaces the double-float stream kernel `_make_stream_kernel_df`
// (run by `_spmv_stream_df` over hi/lo x pre-gathered at `cols`): per-tile
// sums over a double plan, whose vals are (T, 2P, R) hi/lo float32 pairs
// (values.cuh) while cols stays (T, P, R), reading a float64 x at `cols`
// directly, one thread per output lane, and writing float64 partials for
// the slice reduction that follows.  The port runs every windowless
// double plan on it, whatever strategy name the operator hands over.
// Bound: 12 B per slot read once.

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
// slots whose column and value loads a thread issues before their gathers
constexpr int kBatch = 8;
// Hopper's shared memory per block
constexpr size_t kMaxSmem = 227 * 1024;
// kernel L's CTA
constexpr int kThreads = 256;

// blockIdx.x = a persistent CTA; threadIdx.x = group g * lanes + lane.
// Shared memory: a record's tile sums (max_tiles rows of `lanes`), its
// slice sums (max_slices rows), then its tile_slice entries.
template <class S>
__global__ void __launch_bounds__(kThreadsG)
global_runs_kernel(const float* __restrict__ vals,
                   const int* __restrict__ cols,
                   const int* __restrict__ tile_slice,
                   const int4* __restrict__ runs, const float* __restrict__ x,
                   float* __restrict__ out, long long num_runs, int positions,
                   int lanes, long long ncols, int parts, long long out_rows,
                   int max_tiles, int max_slices) {
    extern __shared__ __align__(16) float smem[];
    const int groups = blockDim.x / lanes;
    const int g = threadIdx.x / lanes;
    const int lane = threadIdx.x - g * lanes;
    float* part = smem;                                // tile sums
    float* sums = part + max_tiles * lanes;            // slice sums
    int* ts = reinterpret_cast<int*>(sums + max_slices * lanes);
    const long long slots = (long long)positions * lanes;
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
        for (int j = g; j < nt; j += groups) {
            const long long t = run.x + j;
            const float* v = vals + t * slots + lane;
            const int* c = cols + t * slots + lane;
            float acc = S::init();
            for (int p0 = 0; p0 < positions; p0 += kBatch) {
                int cc[kBatch];
                float vv[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const bool ok = p0 + u < positions;
                    cc[u] = ok ? __ldg(c + (p0 + u) * lanes) : -1;
                    vv[u] = ok ? __ldg(v + (p0 + u) * lanes) : 0.0f;
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u)
                    if (p0 + u < positions)
                        acc = S::step(
                            acc, vv[u],
                            cc[u] >= 0 && cc[u] < ncols ? __ldg(x + cc[u])
                                                        : 0.0f);
            }
            part[j * lanes + lane] = acc;
        }
        __syncthreads();
        // 2. each slice's tiles, in tile order
        for (int si = g; si < ns; si += groups) {
            float acc = S::init();
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
            float acc = sums[si * lanes + r];
            for (int q = 1; q < parts; ++q)
                acc = S::add(acc, sums[si * lanes + q * rps + r]);
            const long long row = (long long)(s0 + si) * rps + r;
            if (parts == 0 || row < out_rows) {
                if (atomic)
                    S::atomic(out + row, S::finish(acc));
                else
                    out[row] = S::finish(acc);
            }
        }
        __syncthreads();                // before the next record's sums
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

template <class S>
cudaError_t launch_runs(const float* vals, const int* cols,
                        const int* tile_slice, const int* runs,
                        const float* x, float* out, long long num_runs,
                        int positions, int lanes, long long ncols, int parts,
                        long long out_rows, int max_tiles, int max_slices,
                        cudaStream_t stream) {
    auto fn = global_runs_kernel<S>;
    const int threads = max(1, kThreadsG / lanes) * lanes;
    const size_t smem = ((size_t)(max_tiles + max_slices) * lanes +
                         (max_tiles + 3) / 4 * 4) * sizeof(float);
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int fit = resident((const void*)fn, threads, smem);
    if (fit <= 0) return cudaErrorInvalidConfiguration;
    // as many CTAs as fit at once, and no more than there are records
    const long long n = num_runs < fit ? num_runs : fit;
    fn<<<(unsigned)n, threads, smem, stream>>>(
        vals, cols, tile_slice, reinterpret_cast<const int4*>(runs), x, out,
        num_runs, positions, lanes, ncols, parts, out_rows, max_tiles,
        max_slices);
    return cudaSuccess;
}

// thread i computes output element i = row * lanes + lane of kernel L's
// per-tile partials; a row is a tile (tiles_per_row = 1) or a group of
// wg tiles (tiles_per_row = wg).
template <class S, class V>
__global__ void global_kernel(const float* __restrict__ vals,
                              const int* __restrict__ cols,
                              const typename V::T* __restrict__ x,
                              typename V::T* __restrict__ out,
                              long long n_out, int positions, int lanes,
                              int tiles_per_row, long long ncols) {
    using T = typename V::T;
    long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n_out) return;
    long long row = i / lanes;
    int lane = (int)(i - row * lanes);
    const long long pr = (long long)positions * lanes;  // one channel
    long long t0 = row * tiles_per_row;
    long long slot = t0 * pr + lane;
    const float* v = vals + t0 * V::kChannels * pr + lane;
    T acc = S::init();
    for (int tt = 0; tt < tiles_per_row; ++tt, v += (V::kChannels - 1) * pr) {
#pragma unroll 8
        for (int p = 0; p < positions; ++p, slot += lanes, v += lanes) {
            long long c = __ldg(cols + slot);
            T xv = (c >= 0 && c < ncols) ? __ldg(x + c) : T(0);
            acc = S::step(acc, V::load(v, pr), xv);
        }
    }
    out[i] = acc;
}

}  // namespace

// vals, cols: (tiles, positions, lanes); runs: (num_runs, 4) int32
// records, of at most max_tiles tiles and max_slices slices each; out:
// (num_slices, lanes) when parts == 0, else (out_rows,),
// preset to the semiring's init by the caller when a record carries
// kAtomic.  lanes a multiple of 32, runs 16-byte aligned.  semiring: a
// code of semiring.cuh
extern "C" int spmv_sell_global_f32(const float* vals, const int* cols,
                                    const int* tile_slice, const int* runs,
                                    const float* x, float* out,
                                    long long num_runs, int positions,
                                    int lanes, long long ncols, int parts,
                                    long long out_rows, int max_tiles,
                                    int max_slices, int semiring,
                                    void* stream) {
    if (positions < 1 || lanes < 32 || lanes % 32 || lanes > kThreadsG ||
        max_tiles < 0 || max_tiles > kThreadsG || max_slices < 0 ||
        parts < 0 || (parts > 1 && lanes % parts))
        return (int)cudaErrorInvalidValue;
    if ((uintptr_t)runs % 16) return (int)cudaErrorMisalignedAddress;
    if (num_runs <= 0) return (int)cudaGetLastError();
    cudaError_t err = cudaErrorInvalidValue;
    cudaError_t bad = spmv::with_semiring(semiring, [&](auto sr) {
        err = launch_runs<decltype(sr)>(
            vals, cols, tile_slice, runs, x, out, num_runs, positions, lanes,
            ncols, parts, out_rows, max_tiles, max_slices,
            (cudaStream_t)stream);
    });
    if (bad != cudaSuccess) return (int)bad;
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// vals: the double plan's (tiles, 2*positions, lanes) hi/lo slab; cols:
// (tiles, positions, lanes); x: float64; out: (tiles, lanes) float64
// per-tile partials; plus_times
extern "C" int spmv_sell_global_f64(const float* vals, const int* cols,
                                    const double* x, double* out,
                                    long long tiles, int positions,
                                    int lanes, long long ncols,
                                    void* stream) {
    long long n_out = tiles * lanes;
    if (n_out > 0) {
        unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
        global_kernel<spmv::PlusTimesF64, spmv::PairValues>
            <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
                vals, cols, x, out, n_out, positions, lanes, 1, ncols);
    }
    return (int)cudaGetLastError();
}
