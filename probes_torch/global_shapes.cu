// A shape of kernels G and L tried beside the two that ship
// (csrc/spmv_sell_global.cu), for probes_torch/global_shapes.py: `groups`
// thread groups per record inside each warp (a warp = 32/groups
// consecutive rows x groups), each group summing every groups-th tile of
// a slice, the tile sums combined in tile order by warp shuffles; a
// thread sums the `parts` lanes of its row in turn and folds them; no
// shared memory, no barrier.  BATCH: slots whose loads a thread issues
// before their gathers.
#include <cuda_runtime.h>
#include <stdint.h>
#include "../spmv_vector_cache_tpu_torch/csrc/semiring.cuh"
#include "../spmv_vector_cache_tpu_torch/csrc/values.cuh"
namespace {
constexpr int kAtomic = 1 << 30;
#ifndef BATCH
#define BATCH 4
#endif
template <class S, class V>
__device__ __forceinline__ typename V::T tile_sum(
    const float* __restrict__ vals, const int* __restrict__ cols,
    const typename V::T* __restrict__ x, long long t, int lane,
    int positions, int lanes, long long ncols) {
    using T = typename V::T;
    const long long slots = (long long)positions * lanes;
    const float* v = vals + t * slots * V::kChannels + lane;
    const int* c = cols + t * slots + lane;
    T acc = S::init();
    for (int p0 = 0; p0 < positions; p0 += BATCH) {
        int cc[BATCH];
        T vv[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const bool ok = p0 + u < positions;
            cc[u] = ok ? __ldg(c + (p0 + u) * lanes) : -1;
            vv[u] = ok ? V::load(v + (p0 + u) * lanes, slots) : T(0);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u)
            if (p0 + u < positions)
                acc = S::step(acc, vv[u], cc[u] >= 0 && cc[u] < ncols
                                              ? __ldg(x + cc[u]) : T(0));
    }
    return acc;
}
template <class S, class V>
__global__ void __launch_bounds__(512)
wg_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
          const int* __restrict__ tile_slice, const int4* __restrict__ runs,
          const typename V::T* __restrict__ x, typename V::T* __restrict__ out,
          long long num_runs, int positions, int lanes, long long ncols,
          int parts, long long out_rows, int groups) {
    using T = typename V::T;
    const int np = parts > 1 ? parts : 1;
    const int rps = lanes / np;
    const int per_rec = rps * groups;
    const long long rec = (long long)blockIdx.x * (blockDim.x / per_rec) +
                          threadIdx.x / per_rec;
    const int i = threadIdx.x % per_rec;
    const int wl = 32 / groups;
    const int k = i % 32, g = k / wl;
    const int r = (i / 32) * wl + k % wl;
    if (rec >= num_runs) return;          // a whole warp: one record
    const int4 run = __ldg(runs + rec);
    const bool atomic = (run.w & kAtomic) != 0;
    const int s1 = run.w & ~kAtomic;
    int t0 = run.x;
    for (int s = run.z; s < s1; ++s) {
        int t1 = t0;
        while (t1 < run.y && __ldg(tile_slice + t1) == s) ++t1;
        T row = S::init();
        for (int q = 0; q < np; ++q) {
            const int lane = q * rps + r;
            T acc = S::init();
            for (int tb = t0; tb < t1; tb += groups) {
                const T mine = tb + g < t1
                    ? tile_sum<S, V>(vals, cols, x, tb + g, lane, positions,
                                     lanes, ncols)
                    : S::init();
                for (int h = 0; h < groups && tb + h < t1; ++h)
                    acc = S::add(acc, __shfl_sync(0xffffffffu, mine,
                                                  k % wl + h * wl));
            }
            row = q ? S::add(row, acc) : acc;
        }
        const long long o = (long long)s * rps + r;
        if (g == 0 && (parts == 0 || o < out_rows)) {
            if (atomic) S::atomic(out + o, S::finish(row));
            else out[o] = S::finish(row);
        }
        t0 = t1;
    }
}
template <class S, class V, class X>
int go(const float* vals, const int* cols, const int* ts, const int* runs,
       const X* x, X* out, long long num_runs, int positions, int lanes,
       long long ncols, int parts, long long out_rows, int groups,
       void* stream) {
    const int rps = lanes / (parts > 1 ? parts : 1);
    const int per_rec = rps * groups;
    const int per = per_rec >= 256 ? 1 : 256 / per_rec;
    wg_kernel<S, V><<<(unsigned)((num_runs + per - 1) / per), per * per_rec,
                      0, (cudaStream_t)stream>>>(
        vals, cols, ts, (const int4*)runs, x, out, num_runs, positions, lanes,
        ncols, parts, out_rows, groups);
    return (int)cudaGetLastError();
}
}  // namespace
#define ARGS const float* vals, const int* cols, const int* ts, const int* runs
#define TAIL long long num_runs, int positions, int lanes, long long ncols, \
             int parts, long long out_rows, int groups, void* stream
#define PASS vals, cols, ts, runs, x, out, num_runs, positions, lanes, ncols, \
             parts, out_rows, groups, stream
extern "C" int wg_f64(ARGS, const double* x, double* out, TAIL) {
    return go<spmv::PlusTimesF64, spmv::PairValues>(PASS);
}
extern "C" int wg_f32_minplus(ARGS, const float* x, float* out, TAIL) {
    return go<spmv::MinPlus, spmv::F32Values>(PASS);
}
extern "C" int wg_f32_plus(ARGS, const float* x, float* out, TAIL) {
    return go<spmv::PlusTimes, spmv::F32Values>(PASS);
}
