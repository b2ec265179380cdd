// SELL window SpMV for Hopper (sm_90a), plain C interface bound with
// ctypes: kernel B (float32, five semirings) and its float64 build, kernel
// K (plus_times).
//
// Kernel B replaces the Pallas kernel `_make_window_kernel` with its
// helper `_gather_window` (spmv_vector_cache_tpu/ops/spmv_pallas.py), as
// run by `_window_partials`; it returns exactly what that function
// returns:
//   per tile   out[t, l] = (+)_p  vals[t, p, l] (x) x[c(t, p, l)]     (T, R)
//   per group  out[g, l] = (+)_{t in g, p} ...                   (T/wg, R)
// with c = window_base[t / wg] * window_grain + cols_win[t, p, l].  x
// reads as 0 at c >= cols, as in the reference's zero-padded x image;
// the reference's overlapped xw image and select trees exist only for
// Mosaic's aligned slices and are not carried over: x is gathered
// directly.  Padding slots carry the semiring's zero and offset 0.
//
// Kernel K replaces the double-float window kernel `_make_window_kernel_df`
// with `_df_product_reduce` (run by `_spmv_window_df`): the same sums over
// a double plan, whose vals are (T, 2P, R) hi/lo float32 pairs (values.cuh)
// while cols_win stays (T, P, R); x and the partials are float64.  The
// reference's kernel always writes per tile; K folds per group where B
// does, and both reduce to the same y (`_reduce_partials`).
//
// Bound: the nonzero stream, read once: 6 B a slot in float32 (value and
// int16 offset), 4 B at 2-byte slots, 3 B at 1-byte ones (10 B in K); x
// is gathered through L1/L2 because a window spans at most K*128
// columns.  All five semirings are one template on the (init, step)
// pairs of semiring.cuh.
//
// B (`window_lanes_kernel`, every value build): each thread sums L = 4
// consecutive lanes of an output row (a tile, or a group when folding),
// so a position is one vector load of L slots (4 B at 1-byte slots, 8 B
// at 2-byte, 16 B at 4-byte) and one of L offsets (8 B); it issues the
// loads of U = 4 positions, then their x gathers, then the steps, and
// 128 threads a CTA hold 4 output rows (ops/spmv_sell.py
// window_launch_shape).  With one thread a lane (the design before) a
// warp moved 32 B of 1-byte slots a load, one load in flight a thread:
// the int8 rest of the cut Hybrid took the int16 one's time.  On an H100
// (probes_torch/window_shapes.py, kernel alone): the shuffled band 40.9
// -> 37.9 us in float32, 31.0 / 30.8 -> 27.4 in bfloat16 / float16,
// 27.0 -> 23.1 in int8 (67 % of its bound); the Hybrid rest 24.1 ->
// 22.6; the cut Hybrid's int8 rest 4.5 -> 4.2, of which one CTA's chain
// alone takes 2.9 us.  The shape is within 5 % of the fastest of 1 to 16
// lanes a thread, 2 to 8 positions in flight and 64 to 256 threads a
// CTA on every plan the probe times; x windows staged in shared memory
// were slower on every one (PERF.md).  Each thread sums its lanes over
// the positions in order, as the plain version does, so every launch
// shape gives the same partials bit for bit.
//
// K keeps the one-lane kernel below (`window_kernel`): one block of R
// (=128) threads per tile (or per group when folding), one thread per
// lane, a loop over the group's tiles and each tile's positions.
//
// B has a build for each value policy of values.cuh: the float32 entry
// point, and `_bf16` (2 B values widened to float32, x and the partials
// float32), `_i32` and `_u32` (plus_times, max_times and or_and, sums
// wrapping mod 2^32) entry points with the same arguments.
// The `_f16`, `_i8`, `_u8`, `_i16` and `_u16` builds read 2- and 1-byte
// slots, widened to float32 (float16) or int (the integers, sign- or
// zero-extended) as they load; x and the sums stay in that 32-bit type,
// and the wrapper narrows y once (ops/semiring.py finish_y).  Under
// max_times an integer product wraps to the value type before the max
// (semiring.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "semiring.cuh"
#include "values.cuh"

namespace {

// K: blockIdx.x = output row, a tile (tiles_per_row = 1) or a group
// (tiles_per_row = wg); threadIdx.x = lane.
template <class S, class V>
__global__ void window_kernel(const typename V::Slot* __restrict__ vals,
                              const int16_t* __restrict__ cols_win,
                              const int* __restrict__ window_base,
                              const typename V::T* __restrict__ x,
                              typename V::T* __restrict__ out, int positions,
                              int lanes, int group_tiles, int tiles_per_row,
                              int window_grain, long long cols) {
    using T = typename V::T;
    long long row = blockIdx.x;
    int lane = threadIdx.x;
    long long t0 = row * tiles_per_row;
    long long base =
        (long long)__ldg(window_base + t0 / group_tiles) * window_grain;
    const long long pr = (long long)positions * lanes;  // one channel
    long long slot = t0 * pr + lane;
    const typename V::Slot* v = vals + t0 * V::kChannels * pr + lane;
    T acc = S::init();
    for (int tt = 0; tt < tiles_per_row; ++tt, v += (V::kChannels - 1) * pr) {
        for (int p = 0; p < positions; ++p, slot += lanes, v += lanes) {
            long long c = base + (long long)__ldg(cols_win + slot);
            T xv = c < cols ? __ldg(x + c) : T(0);
            acc = S::step(acc, V::load(v, pr), xv);
        }
    }
    out[row * lanes + lane] = acc;
}

// --- B: L lanes a thread -------------------------------------------------

// lanes a thread (L) and the positions whose loads a thread has in
// flight together (U), at every slot width; L is mirrored by
// ops/spmv_sell.py WINDOW_LANES (probes_torch/window_shapes.py builds
// other values with -D and times them)
#ifndef SPMV_WINDOW_LANES
#define SPMV_WINDOW_LANES 4
#endif
#ifndef SPMV_WINDOW_UNROLL
#define SPMV_WINDOW_UNROLL 4
#endif
constexpr int kLanes = SPMV_WINDOW_LANES;
constexpr int kUnroll = SPMV_WINDOW_UNROLL;
// the most threads a CTA has
constexpr int kWinMaxThreads = 256;

// blockDim.x = n * (lanes / L): n output rows (tiles, or groups when
// folding) a CTA, lanes / L threads a row, each summing L consecutive
// lanes over the row's tiles and positions, x read through L1
template <class S, class V, int L>
__global__ void __launch_bounds__(kWinMaxThreads)
window_lanes_kernel(const typename V::Slot* __restrict__ vals,
                    const int16_t* __restrict__ cols_win,
                    const int* __restrict__ window_base,
                    const typename V::T* __restrict__ x,
                    typename V::T* __restrict__ out, long long out_rows,
                    int positions, int lanes, int group_tiles,
                    int tiles_per_row, int window_grain, long long cols) {
    using T = typename V::T;
    using Slot = typename V::Slot;
    const int tpo = lanes / L;                   // threads an output row
    const long long o = (long long)blockIdx.x * (blockDim.x / tpo) +
                        threadIdx.x / tpo;
    if (o >= out_rows) return;
    const int lane0 = ((int)threadIdx.x % tpo) * L;
    const int qn = tiles_per_row * positions;    // position rows of a row
    const long long first = (o * qn) * lanes + lane0;
    const Slot* v = vals + first;
    const int16_t* cw = cols_win + first;
    const long long base =
        (long long)__ldg(window_base + o * tiles_per_row / group_tiles) *
        window_grain;
    const T* xp = x + base;
    const long long lim = cols - base;           // x reads 0 from here on

    T acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = S::init();
    for (int q0 = 0; q0 < qn; q0 += kUnroll) {
        // the slots and offsets of U positions, then their x gathers,
        // then the steps
        spmv::Run<Slot, L> vb[kUnroll];
        spmv::Run<int16_t, L> cb[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (q0 + u >= qn) break;
            vb[u].load(v + (long long)(q0 + u) * lanes);
            cb[u].load(cw + (long long)(q0 + u) * lanes);
        }
        T xv[kUnroll][L];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (q0 + u >= qn) break;
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int c = cb[u].e[l];
                xv[u][l] = c < lim ? __ldg(xp + c) : T(0);
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (q0 + u >= qn) break;
#pragma unroll
            for (int l = 0; l < L; ++l)
                acc[l] = S::step(acc[l], V::widen(vb[u].e[l]), xv[u][l]);
        }
    }
    spmv::Run<T, L> r;
#pragma unroll
    for (int l = 0; l < L; ++l) r.e[l] = acc[l];
    r.store(out + o * lanes + lane0);
}

// semiring: a code of semiring.cuh; lanes_per_thread must be the
// build's L, rows_per_cta * lanes / L threads a CTA.  Refuses
// (cudaErrorInvalidValue) a shape the build or the operands do not take.
template <class V>
int launch_window(const void* vals, const int16_t* cols_win,
                  const int* window_base, const void* x, void* out,
                  long long out_rows, int positions, int lanes,
                  int group_tiles, int fold, int window_grain,
                  long long cols, int semiring, int lanes_per_thread,
                  int rows_per_cta, void* stream) {
    using T = typename V::T;
    using Slot = typename V::Slot;
    constexpr int L = kLanes;
    const long long threads = (long long)rows_per_cta * (lanes / L);
    if (lanes_per_thread != L || lanes % L || rows_per_cta < 1 ||
        threads > kWinMaxThreads || threads % 32 ||
        reinterpret_cast<uintptr_t>(vals) % spmv::Run<Slot, L>::kVec ||
        reinterpret_cast<uintptr_t>(cols_win) %
            spmv::Run<int16_t, L>::kVec ||
        reinterpret_cast<uintptr_t>(out) % spmv::Run<T, L>::kVec)
        return (int)cudaErrorInvalidValue;
    if (out_rows > 0) {
        const unsigned blocks =
            (unsigned)((out_rows + rows_per_cta - 1) / rows_per_cta);
        const int tpr = fold ? group_tiles : 1;
        using W = typename V::Wrap;
        cudaError_t err = spmv::with_semiring<T, W>(semiring, [&](auto s) {
            window_lanes_kernel<decltype(s), V, L>
                <<<blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>(
                    static_cast<const Slot*>(vals), cols_win, window_base,
                    static_cast<const T*>(x), static_cast<T*>(out),
                    out_rows, positions, lanes, group_tiles, tpr,
                    window_grain, cols);
        });
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace

#define SPMV_SELL_WINDOW_BUILD(sfx, V)                                      \
    extern "C" int spmv_sell_window_##sfx(                                  \
        const void* vals, const int16_t* cols_win, const int* window_base,  \
        const void* x, void* out, long long out_rows, int positions,        \
        int lanes, int group_tiles, int fold, int window_grain,             \
        long long cols, int semiring, int lanes_per_thread,                 \
        int rows_per_cta, void* stream) {                                   \
        return launch_window<V>(vals, cols_win, window_base, x, out,        \
                                out_rows, positions, lanes, group_tiles,    \
                                fold, window_grain, cols, semiring,         \
                                lanes_per_thread, rows_per_cta, stream);    \
    }

SPMV_SELL_WINDOW_BUILD(f32, spmv::F32Values)
SPMV_SELL_WINDOW_BUILD(bf16, spmv::Bf16Values)
SPMV_SELL_WINDOW_BUILD(i32, spmv::I32Values)
SPMV_SELL_WINDOW_BUILD(u32, spmv::U32Values)
SPMV_SELL_WINDOW_BUILD(f16, spmv::F16Values)
SPMV_SELL_WINDOW_BUILD(i8, spmv::I8Values)
SPMV_SELL_WINDOW_BUILD(u8, spmv::U8Values)
SPMV_SELL_WINDOW_BUILD(i16, spmv::I16Values)
SPMV_SELL_WINDOW_BUILD(u16, spmv::U16Values)

// vals: the double plan's (T, 2*positions, lanes) hi/lo slab; x, out:
// float64; plus_times
extern "C" int spmv_sell_window_f64(const float* vals,
                                    const int16_t* cols_win,
                                    const int* window_base, const double* x,
                                    double* out, long long out_rows,
                                    int positions, int lanes,
                                    int group_tiles, int fold,
                                    int window_grain, long long cols,
                                    void* stream) {
    if (out_rows > 0) {
        int tpr = fold ? group_tiles : 1;
        window_kernel<spmv::PlusTimesF64, spmv::PairValues>
            <<<(unsigned)out_rows, lanes, 0, (cudaStream_t)stream>>>(
                vals, cols_win, window_base, x, out, positions, lanes,
                group_tiles, tpr, window_grain, cols);
    }
    return (int)cudaGetLastError();
}
