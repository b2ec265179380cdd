// DIA SpMV for Hopper (sm_90a), plain C interface bound with ctypes:
// kernel A (float32), its float64 build, kernel J, and its halo build,
// kernel M.
//
// Kernel A replaces the Pallas kernels `_make_dia_kernel` and
// `_make_dia_kernel_windowed` (spmv_vector_cache_tpu/ops/spmv_dia.py),
// which compute the same function with x resident in VMEM or streamed in
// sliding blocks; that choice is a VMEM-capacity one the card does not
// have, so one kernel serves both.  Kernel J replaces their double-float
// forms `_make_dia_kernel_df` and `_make_dia_kernel_df_windowed` (with
// `_df_diag_accumulate`), which emulate f64 with hi/lo f32 pairs and
// error-free transforms; J joins each pair into a double (values.cuh)
// and sums in FP64, reading a float64 x and writing a float64 y.
// Kernel M replaces `_local_dia_spmv`
// (spmv_vector_cache_tpu/parallel/dia_sharded.py), one shard's DIA SpMV
// over an x that carries both neighbours' halos; the reference runs
// `_make_dia_kernel` there with pad_left = halo, so M is A with an x
// origin: the shard's row r reads x_ext[halo + r + off_k], and the left
// halo sits below the shard's own columns.
//
// y[r] = sum_k vals[t, k, i, l] * x[origin + r + off_k],
// r = t*S*128 + i*128 + l, where x reads as 0 outside [0, x_len) (the
// reference's zero-padded x image); A and J run with origin 0 and
// x_len = cols.  Only rows below `rows` are written.  A double plan's
// slab is (T, 2D, S*128): the low word of diagonal k sits at diagonal
// D + k.
//
// Bound: the value stream, 4 B per stored slot (8 B, two words, in J),
// read once; x is re-read D times but from L1/L2 (neighbouring diagonals
// touch neighbouring addresses).  J's FP64 work, 2 flops per slot, is
// far below the card's FP64 rate.  Design: one thread per row, so
// neighbouring threads read neighbouring `vals` and `x` addresses
// (coalesced); the k-sum runs in the order of the plain PyTorch version;
// the offsets are a small int32 device array read through the read-only
// cache.
//
// A and M have a build for each value policy of values.cuh: the float32
// entry points, and `_bf16` (2 B a slot widened to float32, x and y
// float32: 2 B of the stream a slot instead of 4), `_i32` and `_u32`
// (sums wrapping mod 2^32) entry points with the same arguments.
// The `_f16`, `_i8`, `_u8`, `_i16` and `_u16` builds read 2- and 1-byte
// slots, widened to float32 (float16) or int (the integers, sign- or
// zero-extended) as they load; x and the sums stay in that 32-bit type,
// and the wrapper narrows y once (ops/semiring.py finish_y).

#include <cuda_runtime.h>
#include <stdint.h>

#include "values.cuh"

namespace {

// kHalo: the x origin is read at run time (kernel M); A and J compile
// without it, so their code is what it was before M (a run-time origin
// of 0 cost A 6 % of its device time on an H100)
template <class V, bool kHalo>
__global__ void spmv_dia_kernel(const typename V::Slot* __restrict__ vals,
                                const typename V::T* __restrict__ x,
                                const int* __restrict__ offsets,
                                typename V::T* __restrict__ y,
                                long long rows, long long x_len,
                                long long x_origin, int ndiag,
                                int rows_per_step) {
    using T = typename V::T;
    long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    long long t = r / rows_per_step;
    long long rem = r - t * rows_per_step;
    const long long half = (long long)ndiag * rows_per_step;
    const typename V::Slot* v = vals + t * V::kChannels * half + rem;
    const long long r_x = kHalo ? r + x_origin : r;
    T acc = T(0);
    for (int k = 0; k < ndiag; ++k) {
        long long c = r_x + __ldg(offsets + k);
        T xv = (c >= 0 && c < x_len) ? __ldg(x + c) : T(0);
        acc = spmv::madd(V::load(v + (long long)k * rows_per_step, half), xv,
                         acc);
    }
    y[r] = acc;
}

template <class V, bool kHalo>
int launch(const typename V::Slot* vals, const typename V::T* x,
           const int* offsets,
           typename V::T* y, long long rows, long long x_len,
           long long x_origin, int ndiag, int rows_per_step, void* stream) {
    if (rows > 0) {
        const int threads = 256;
        long long blocks = (rows + threads - 1) / threads;
        spmv_dia_kernel<V, kHalo><<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
            vals, x, offsets, y, rows, x_len, x_origin, ndiag,
            rows_per_step);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// A and M for each value policy: vals (T, D, S*128) of the policy's
// slots, x and y of its sum type.  Kernel M: x_ext holds the shard's x
// with the left halo first, so the shard's row r reads
// x_ext[x_origin + r + off_k]
#define SPMV_DIA_BUILD(sfx, V)                                              \
    extern "C" int spmv_dia_##sfx(const void* vals, const void* x,          \
                                  const int* offsets, void* y,              \
                                  long long rows, long long cols,           \
                                  int ndiag, int rows_per_step,             \
                                  void* stream) {                           \
        return launch<V, false>(static_cast<const V::Slot*>(vals),          \
                                static_cast<const V::T*>(x), offsets,       \
                                static_cast<V::T*>(y), rows, cols, 0,       \
                                ndiag, rows_per_step, stream);              \
    }                                                                       \
    extern "C" int spmv_dia_halo_##sfx(                                     \
        const void* vals, const void* x_ext, const int* offsets, void* y,   \
        long long rows, long long x_len, long long x_origin, int ndiag,     \
        int rows_per_step, void* stream) {                                  \
        return launch<V, true>(static_cast<const V::Slot*>(vals),           \
                               static_cast<const V::T*>(x_ext), offsets,    \
                               static_cast<V::T*>(y), rows, x_len,          \
                               x_origin, ndiag, rows_per_step, stream);     \
    }

SPMV_DIA_BUILD(f32, spmv::F32Values)
SPMV_DIA_BUILD(bf16, spmv::Bf16Values)
SPMV_DIA_BUILD(i32, spmv::I32Values)
SPMV_DIA_BUILD(u32, spmv::U32Values)
SPMV_DIA_BUILD(f16, spmv::F16Values)
SPMV_DIA_BUILD(i8, spmv::I8Values)
SPMV_DIA_BUILD(u8, spmv::U8Values)
SPMV_DIA_BUILD(i16, spmv::I16Values)
SPMV_DIA_BUILD(u16, spmv::U16Values)

// vals: the double plan's (T, 2D, S*128) hi/lo slab; x, y: float64
extern "C" int spmv_dia_f64(const float* vals, const double* x,
                            const int* offsets, double* y, long long rows,
                            long long cols, int ndiag, int rows_per_step,
                            void* stream) {
    return launch<spmv::PairValues, false>(vals, x, offsets, y, rows, cols,
                                           0, ndiag, rows_per_step, stream);
}
