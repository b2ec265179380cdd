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
// Bound: the nonzero stream, 6 B per slot (f32 value + int16 offset;
// 10 B in K), read once; x is gathered from L1/L2 because a window spans
// at most K*128 columns.  Design: one block of R (=128) threads per tile
// (or per group when folding), one thread per lane; each thread loops
// over the group's tiles and each tile's positions, so a warp reads 32
// consecutive values and offsets (coalesced).  All five semirings are one
// template on the (init, step) pairs of semiring.cuh.
//
// B has a build for each value policy of values.cuh: the float32 entry
// point, and `_bf16` (2 B values widened to float32, x and the partials
// float32: 4 B of the stream a slot instead of 6), `_i32` and `_u32`
// (plus_times, max_times and or_and, sums wrapping mod 2^32) entry
// points with the same arguments.
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

// blockIdx.x = output row: a tile (tiles_per_row = 1) or a group
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

// semiring: a code of semiring.cuh
template <class V>
int launch_window(const void* vals, const int16_t* cols_win,
                  const int* window_base, const void* x, void* out,
                  long long out_rows, int positions, int lanes,
                  int group_tiles, int fold, int window_grain,
                  long long cols, int semiring, void* stream) {
    using T = typename V::T;
    if (out_rows > 0) {
        int tpr = fold ? group_tiles : 1;
        using W = typename V::Wrap;
        cudaError_t err = spmv::with_semiring<T, W>(semiring, [&](auto s) {
            window_kernel<decltype(s), V>
                <<<(unsigned)out_rows, lanes, 0, (cudaStream_t)stream>>>(
                    static_cast<const typename V::Slot*>(vals), cols_win,
                    window_base, static_cast<const T*>(x),
                    static_cast<T*>(out), positions, lanes, group_tiles,
                    tpr, window_grain, cols);
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
        long long cols, int semiring, void* stream) {                       \
        return launch_window<V>(vals, cols_win, window_base, x, out,        \
                                out_rows, positions, lanes, group_tiles,    \
                                fold, window_grain, cols, semiring,         \
                                stream);                                    \
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
