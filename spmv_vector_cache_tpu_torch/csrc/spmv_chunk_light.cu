// The chunk light route for Hopper (sm_90a), plain C interface bound with
// ctypes: a ChunkPlan's light buckets in one launch, float32, five
// semirings.
//
// Replaces, on the ChunkPlan apply, the Pallas window kernel
// `_make_window_kernel` with `_gather_window`, as `_window_partials` runs
// it on each light bucket, together with the sorted segment reduce and
// the add across buckets that `_spmv_chunk` makes of its partials
// (spmv_vector_cache_tpu/ops/spmv_pallas.py).  It writes what those give:
//   y2d[r] = (+)_{records of lane row r} vals (x) x[col]     (segments*128)
// over the unified segment space, r = segment * 128 + lane.  The records
// are the buckets' real slots, which placement lists by lane row in the
// reference's order (formats/tables.py light_records): the buckets' padding,
// 98 % of their slots on a power-law matrix, is never read.  A lane row
// of a segment that some bucket tile maps to also sums the semiring's
// zero, what the reference's padding slots give it for a finite x (this
// moves only max_times, whose zero 0 is not its empty sum -inf).  x reads
// as 0 at a column past its length, as in kernel B.
//
// Bound: the records, 8 B each (int32 column, float32 value), read once;
// 4 B of offsets and 4 B of y2d a lane row; the distinct x entries the
// columns name.  Design: one CTA of 128 threads a unit of at most 128
// consecutive lane rows (one segment, split at row boundaries where it
// holds many records: formats/tables.py light_units, so a long segment spreads
// over CTAs).  The CTA stages its records LIGHT_CHUNK at a time through
// shared memory: each thread loads LIGHT_CHUNK / 128 of them, coalesced
// and all in flight, then the x entries they name; then each thread
// sums its own row's records of the chunk in the plan's order.  The
// kernel is latency-bound (PERF.md): the unit's bounds, its records and
// their x entries are three dependent loads.  Each lane row has one owner and no atomics: y is the same on
// every run.
//
// The route has a build for each value policy of values.cuh: the float32
// entry point, and `_bf16` (2 B record values widened to float32, x and
// y2d float32: 6 B a record instead of 8), `_i32` and `_u32` (plus_times,
// max_times and or_and, sums wrapping mod 2^32) entry points with the
// same arguments.
// The `_f16`, `_i8`, `_u8`, `_i16` and `_u16` builds read 2- and 1-byte
// slots, widened to float32 (float16) or int (the integers, sign- or
// zero-extended) as they load; x and the sums stay in that 32-bit type,
// and the wrapper narrows y once (ops/semiring.py finish_y).

#include <cuda_runtime.h>
#include <stdint.h>

#include "semiring.cuh"
#include "values.cuh"

// LIGHT_CHUNK: records a CTA stages through shared memory at a time;
// LIGHT_MIN_CTAS: the CTAs an SM must be able to hold at once (a register
// cap for nvcc: 40 registers at 12).  probes_torch/light_shapes.py builds
// others with -D and times them on the card; on an H100, with
// formats/tables.py's 256 records a unit, 512 and 12 took 8.2-8.6 us on
// scircuit_like's records, the other shapes 8.8-28 us; a warp a unit of
// up to 32 rows in place of the CTA took 9.3 us at best, and a grid of
// resident CTAs walking the units with the next unit's records loaded
// ahead 10.0 us at best (PERF.md).
#ifndef LIGHT_CHUNK
#define LIGHT_CHUNK 512
#endif
#ifndef LIGHT_MIN_CTAS
#define LIGHT_MIN_CTAS 12
#endif

// threads a CTA: the most lane rows a unit holds (formats/tables.py makes
// units of at most one segment's 128 rows), one a thread
#define LIGHT_ROWS 128
static_assert(LIGHT_CHUNK % LIGHT_ROWS == 0,
              "each thread stages a whole number of records a chunk");

namespace {

template <class S, class V>
__global__ void __launch_bounds__(LIGHT_ROWS, LIGHT_MIN_CTAS)
    light_rows_kernel(const int* __restrict__ row_off,
                      const int* __restrict__ cols,
                      const typename V::Slot* __restrict__ vals,
                      const uint8_t* __restrict__ tiled,
                      const int2* __restrict__ units,
                      const typename V::T* __restrict__ x,
                      typename V::T* __restrict__ y2d, long long ncols) {
    using T = typename V::T;
    constexpr int kPer = LIGHT_CHUNK / LIGHT_ROWS;
    __shared__ T sv[LIGHT_CHUNK];
    __shared__ T sx[LIGHT_CHUNK];
    // the unit's (lane row, record) bounds: the records' first chunk, the
    // thread's row offsets and its segment's byte all load together
    const int2 lo = __ldg(units + blockIdx.x);
    const int2 hi = __ldg(units + blockIdx.x + 1);
    const int r = lo.x + (int)threadIdx.x;
    const bool mine = r < hi.x;
    int k0 = 0, k1 = 0;
    bool pad = false;
    if (mine) {
        k0 = __ldg(row_off + r);
        k1 = __ldg(row_off + r + 1);
        pad = __ldg(tiled + r / 128) != 0;
    }
    T acc = S::init();
    for (int c0 = lo.y; c0 < hi.y; c0 += LIGHT_CHUNK) {
        const int n = min(LIGHT_CHUNK, hi.y - c0);
        int c[kPer];
        T v[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int i = (int)threadIdx.x + j * LIGHT_ROWS;
            if (i < n) {
                c[j] = __ldg(cols + c0 + i);
                v[j] = V::load(vals + c0 + i, 0);
            }
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int i = (int)threadIdx.x + j * LIGHT_ROWS;
            if (i < n) {
                sx[i] = (long long)c[j] < ncols ? __ldg(x + c[j]) : T(0);
                sv[i] = v[j];
            }
        }
        __syncthreads();
        const int a = max(k0, c0) - c0, b = min(k1, c0 + n) - c0;
        for (int i = a; i < b; ++i) acc = S::step(acc, sv[i], sx[i]);
        __syncthreads();
    }
    if (mine) {
        if (pad) acc = S::add(acc, S::zero());
        y2d[r] = S::finish(acc);
    }
}

template <class V>
int launch_light(const int* row_off, const int* cols, const void* vals,
                 const uint8_t* tiled, const int* units, const void* x,
                 void* y2d, long long num_units, long long ncols,
                 int semiring, void* stream) {
    using T = typename V::T;
    if (num_units > 0) {
        using W = typename V::Wrap;
        cudaError_t err = spmv::with_semiring<T, W>(semiring, [&](auto s) {
            light_rows_kernel<decltype(s), V>
                <<<(unsigned)num_units, LIGHT_ROWS, 0,
                   (cudaStream_t)stream>>>(
                    row_off, cols, static_cast<const typename V::Slot*>(vals),
                    tiled, reinterpret_cast<const int2*>(units),
                    static_cast<const T*>(x), static_cast<T*>(y2d), ncols);
        });
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// row_off: (rows + 1) int32; cols, vals: the records; tiled: a byte (0
// or 1) a segment of 128 rows; units: (num_units + 1, 2) int32 (lane
// row, record) boundaries, 8-byte aligned, at most 128 rows a unit;
// y2d: (rows,) of the policy's sum type, every row written; semiring: a
// code of semiring.cuh
#define SPMV_CHUNK_LIGHT_BUILD(sfx, V)                                      \
    extern "C" int spmv_chunk_light_##sfx(                                  \
        const int* row_off, const int* cols, const void* vals,              \
        const uint8_t* tiled, const int* units, const void* x, void* y2d,   \
        long long num_units, long long ncols, int semiring,                 \
        void* stream) {                                                     \
        return launch_light<V>(row_off, cols, vals, tiled, units, x, y2d,   \
                               num_units, ncols, semiring, stream);         \
    }

SPMV_CHUNK_LIGHT_BUILD(f32, spmv::F32Values)
SPMV_CHUNK_LIGHT_BUILD(bf16, spmv::Bf16Values)
SPMV_CHUNK_LIGHT_BUILD(i32, spmv::I32Values)
SPMV_CHUNK_LIGHT_BUILD(u32, spmv::U32Values)
SPMV_CHUNK_LIGHT_BUILD(f16, spmv::F16Values)
SPMV_CHUNK_LIGHT_BUILD(i8, spmv::I8Values)
SPMV_CHUNK_LIGHT_BUILD(u8, spmv::U8Values)
SPMV_CHUNK_LIGHT_BUILD(i16, spmv::I16Values)
SPMV_CHUNK_LIGHT_BUILD(u16, spmv::U16Values)
