// DIA SpMM for Hopper (sm_90a), plain C interface bound with ctypes:
// kernel I.
//
// Replaces the Pallas kernel `_make_dia_spmm_kernel`, run by `_spmm_dia`
// (spmv_vector_cache_tpu/ops/spmm_dia.py).  With B of shape (cols, k),
// row-major as the caller hands it,
//   Y[r, j] = sum_d vals[t, d, i, l] * B[r + off_d, j],
//   r = t*S*128 + i*128 + l,
// summed over the diagonals in plan order, where B reads as 0 outside
// rows [0, cols).  Y (rows, k) is written row-major, straight: there is
// no transposed, zero-padded B image and no (k8, T, 8, S, 128) output
// to relayout, both of which the reference builds for Mosaic.
//
// Bound: bytes — the value slab (4 B per stored slot), B and Y, each
// once.  The rows of B that a run of R consecutive rows of Y reads are
// one contiguous span, [r0 + min_off, r0 + R + max_off): R rows plus the
// band's spread.  Design:
// - a CTA owns R consecutive rows of one DIA step (R = 128 / threads per
//   row: small CTAs, many to an SM, overlap one CTA's loads with
//   another's sums) and a chunk of up to 128 columns of Y (blockIdx.y);
// - it brings the span of B into shared memory once, with cp.async
//   (16-byte pieces, or 4-byte ones for an unaligned B or a k that is
//   not a multiple of 4), rows outside [0, cols) as zeros, each row
//   padded to a stride that makes a quarter warp's float4 reads hit 32
//   distinct banks, and in the same commit group its rows' runs of the
//   value slab (vals[t, d] is S*128 contiguous floats), so that one
//   wait covers every load of the band;
// - the plan's diagonals are grouped on the host into bands whose span
//   fits the shared-memory budget (ops/spmm_dia.py `dia_bands`; one band
//   for bench.py's -13..13): bands are staged one after another, double
//   buffered, and the sums stay in registers across bands;
// - a thread owns one row and KC of its columns (4, 8, 16 or 32; at k >
//   32 several threads share a row, interleaved by float4) and reads
//   its values and B from shared memory only.
// Every B row is read once per CTA that needs it (R rows plus the band's
// spread: the neighbours' halo rows, 20 % more than B at R = 128 on the
// bench.py offsets, come mostly from L2) instead of once per diagonal
// through L1.
//
// I has a build for each value policy of values.cuh: the float32 entry
// point, and `_bf16`, `_i32` and `_u32` entry points with the same
// arguments.  The bf16 build sums in float32 with a float32 B and Y (the
// reference rounds B to bfloat16 and sums and returns Y in bfloat16,
// ROADMAP.md queue 3); it stages its 2-byte values with plain loads,
// widened to float32 in shared memory, where the 4-byte types copy them
// with cp.async.  The integer builds sum wrapping mod 2^32.
// The `_f16`, `_i8`, `_u8`, `_i16` and `_u16` builds read 2- and 1-byte
// slots, widened to float32 (float16) or int (the integers, sign- or
// zero-extended) as they load; B and the sums stay in that 32-bit type,
// and the wrapper narrows Y once (ops/semiring.py finish_y).  Their 1- and
// 2-byte values are staged as bf16's are, by plain loads, widened.

#include <cuda_runtime.h>
#include <stdint.h>

#include "values.cuh"

namespace {

// the 16-byte vector of four T
template <class T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<unsigned> { using type = uint4; };

constexpr int kMaxThreads = 512;
// diagonals whose values and offsets a thread reads before it uses them
constexpr int kBatch = 8;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// blockIdx.x = (DIA step, run of rpc rows in it), blockIdx.y = column
// chunk of tpr * KC columns; thread = row i * tpr + q, thread q of a row
// holding the float4 pieces q, q + tpr, q + 2 tpr, ... of the chunk.
// bands[b] = {first diagonal, end diagonal}; a buffer holds buf_rows
// rows of B, `stride` floats each, then band_diags runs of rpc values.
template <class P, int KC>
__global__ void __launch_bounds__(kMaxThreads)
spmm_dia_kernel(const typename P::Slot* __restrict__ vals,
                const typename P::T* __restrict__ b,
                const int* __restrict__ offsets,
                const int2* __restrict__ bands, typename P::T* __restrict__ y,
                long long rows, long long cols, int k, int ndiag,
                int rows_per_step, int nbands, int rpc, int tpr, int stride,
                int buf_rows, int band_diags, int buffers, int bvec,
                int vvec, int yvec) {
    using T = typename P::T;
    using Slot = typename P::Slot;
    using Q = typename Vec4<T>::type;
    // a widened copy of the values: the 4-byte types copy their bits
    constexpr bool kCopy = sizeof(Slot) == sizeof(T);
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    T* smem = reinterpret_cast<T*>(smem_bytes);
    const int chunks = (rows_per_step + rpc - 1) / rpc;
    const long long t = blockIdx.x / chunks;
    const int c0 = (int)(blockIdx.x - t * chunks) * rpc;
    const long long r0 = t * rows_per_step + c0;
    const long long left = rows - r0;
    const int nrow = (int)min((long long)min(rpc, rows_per_step - c0), left);
    if (nrow <= 0) return;                  // the last step's padding rows
    const int j0 = blockIdx.y * tpr * KC;
    const int ncol = min(tpr * KC, k - j0);
    const int tid = threadIdx.x;
    const int i = tid / tpr;
    const int q = tid - i * tpr;
    const int b_floats = buf_rows * stride;
    const int buf_floats = (b_floats + band_diags * rpc + 3) / 4 * 4;
    const Slot* v = vals + t * ndiag * (long long)rows_per_step + c0;

    // B rows [r0 + lo, r0 + nrow + hi) of band `band`, columns [j0, j0 +
    // ncol), into `dst`, then the band's values of rows [r0, r0 + nrow)
    // into rows of rpc floats after them; one commit group
    auto stage = [&](int band, T* dst) {
        const int2 bd = __ldg(bands + band);
        const int lo = __ldg(offsets + bd.x);
        const int span = nrow + __ldg(offsets + bd.y - 1) - lo;
        const long long g0 = r0 + lo;
        if (bvec) {
            const int per = ncol / 4;
            for (int e = tid; e < span * per; e += blockDim.x) {
                const int rho = e / per, m = e - rho * per;
                const long long g = g0 + rho;
                T* d = dst + rho * stride + 4 * m;
                if (g >= 0 && g < cols)
                    cp_async16(d, b + g * k + j0 + 4 * m);
                else
                    *reinterpret_cast<Q*>(d) = Q{};
            }
        } else {
            for (int e = tid; e < span * ncol; e += blockDim.x) {
                const int rho = e / ncol, m = e - rho * ncol;
                const long long g = g0 + rho;
                T* d = dst + rho * stride + m;
                if (g >= 0 && g < cols)
                    cp_async4(d, b + g * k + j0 + m);
                else
                    *d = T(0);
            }
        }
        T* dv = dst + b_floats;
        const Slot* sv = v + bd.x * (long long)rows_per_step;
        const int per = (nrow + 3) / 4;
        for (int e = tid; e < (bd.y - bd.x) * per; e += blockDim.x) {
            const int d = e / per, m = 4 * (e - d * per);
            const Slot* src = sv + d * (long long)rows_per_step + m;
            T* dd = dv + d * rpc + m;
            if constexpr (kCopy) {
                if (vvec && m + 4 <= nrow) {
                    cp_async16(dd, src);
                } else {
                    for (int j = 0; j < 4 && m + j < nrow; ++j)
                        cp_async4(dd + j, src + j);
                }
            } else {
                // read before the barrier that precedes their use
                for (int j = 0; j < 4 && m + j < nrow; ++j)
                    dd[j] = P::widen(__ldg(src + j));
            }
        }
        cp_async_commit();
    };

    T acc[KC];
#pragma unroll
    for (int e = 0; e < KC; ++e) acc[e] = T(0);

    if (nbands > 0) stage(0, smem);
    for (int bnd = 0; bnd < nbands; ++bnd) {
        const T* cur = smem + (bnd % buffers) * buf_floats;
        // the next band streams in while this one is summed; an empty
        // group past the last band keeps the wait below uniform
        if (bnd + 1 < nbands)
            stage(bnd + 1, smem + ((bnd + 1) % buffers) * buf_floats);
        else
            cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();                    // band bnd is in shared memory
        const int2 bd = __ldg(bands + bnd);
        const int lo = __ldg(offsets + bd.x);
        if (i < nrow) {
            const T* base = cur + (i - lo) * stride + 4 * q;
            const T* wv = cur + b_floats + i - bd.x * rpc;
            for (int d = bd.x; d < bd.y; d += kBatch) {
                T w[kBatch];
                int o[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const bool ok = d + u < bd.y;
                    w[u] = ok ? wv[(d + u) * rpc] : T(0);
                    o[u] = ok ? __ldg(offsets + d + u) : lo;
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    if (d + u < bd.y) {         // uniform over the CTA
                        const T* row = base + o[u] * stride;
#pragma unroll
                        for (int m = 0; m < KC / 4; ++m) {
                            const Q bv = *reinterpret_cast<const Q*>(
                                row + 4 * tpr * m);
                            acc[4 * m] = spmv::madd(w[u], bv.x, acc[4 * m]);
                            acc[4 * m + 1] =
                                spmv::madd(w[u], bv.y, acc[4 * m + 1]);
                            acc[4 * m + 2] =
                                spmv::madd(w[u], bv.z, acc[4 * m + 2]);
                            acc[4 * m + 3] =
                                spmv::madd(w[u], bv.w, acc[4 * m + 3]);
                        }
                    }
                }
            }
        }
        __syncthreads();            // done with `cur` before it is refilled
    }

    if (i < nrow) {
        T* yr = y + (r0 + i) * k;
#pragma unroll
        for (int m = 0; m < KC / 4; ++m) {
            const int col = j0 + 4 * (q + tpr * m);
            if (yvec && col + 3 < k) {
                Q out;
                out.x = acc[4 * m];
                out.y = acc[4 * m + 1];
                out.z = acc[4 * m + 2];
                out.w = acc[4 * m + 3];
                *reinterpret_cast<Q*>(yr + col) = out;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (col + e < k) yr[col + e] = acc[4 * m + e];
            }
        }
    }
}

template <class P, int KC>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const typename P::Slot* vals, const typename P::T* b,
                   const int* offsets, const int* bands, typename P::T* y,
                   long long rows,
                   long long cols, int k, int ndiag, int rows_per_step,
                   int nbands, int rpc, int tpr, int stride, int buf_rows,
                   int band_diags, int buffers, int bvec, int vvec,
                   int yvec) {
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            spmm_dia_kernel<P, KC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    spmm_dia_kernel<P, KC><<<grid, threads, smem, stream>>>(
        vals, b, offsets, reinterpret_cast<const int2*>(bands), y, rows, cols,
        k, ndiag, rows_per_step, nbands, rpc, tpr, stride, buf_rows,
        band_diags, buffers, bvec, vvec, yvec);
    return cudaSuccess;
}

template <class P>
int launch_spmm_dia(const void* vals_, const void* b_, const int* offsets,
                    const int* bands, void* y_, long long rows,
                    long long cols, int k, int ndiag, int rows_per_step,
                    int nbands, int rows_per_cta, int cols_per_thread,
                    int threads_per_row, int stride, int buf_rows,
                    int band_diags, int buffers, void* stream) {
    using T = typename P::T;
    const auto* vals = static_cast<const typename P::Slot*>(vals_);
    const auto* b = static_cast<const T*>(b_);
    auto* y = static_cast<T*>(y_);
    const int kc = cols_per_thread, tpr = threads_per_row;
    if (k < 1 || rows_per_cta < 1 || tpr < 1 ||
        rows_per_cta * tpr > kMaxThreads || stride % 4 ||
        stride < tpr * kc || buffers < 1 || buffers > 2 ||
        (nbands > 1 && buffers < 2) || (uintptr_t)bands % 8)
        return (int)cudaErrorInvalidValue;
    const long long steps = (rows + rows_per_step - 1) / rows_per_step;
    if (rows <= 0) return (int)cudaGetLastError();
    const int chunks = (rows_per_step + rows_per_cta - 1) / rows_per_cta;
    dim3 grid((unsigned)(steps * chunks),
              (unsigned)((k + tpr * kc - 1) / (tpr * kc)));
    const size_t smem = (size_t)buffers *
                        (((size_t)buf_rows * stride +
                          (size_t)band_diags * rows_per_cta + 3) / 4 * 4) *
                        sizeof(T);
    const int bvec = (uintptr_t)b % 16 == 0 && k % 4 == 0;
    const int vvec = (uintptr_t)vals % 16 == 0 && rows_per_step % 4 == 0 &&
                     rows_per_cta % 4 == 0;
    const int yvec = (uintptr_t)y % 16 == 0 && k % 4 == 0;
    const int threads = rows_per_cta * tpr;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    switch (kc) {
        case 4:
            err = launch<P, 4>(grid, threads, smem, s, vals, b, offsets,
                               bands, y, rows, cols, k, ndiag, rows_per_step, nbands,
                            rows_per_cta, tpr, stride, buf_rows, band_diags,
                            buffers, bvec, vvec, yvec);
            break;
        case 8:
            err = launch<P, 8>(grid, threads, smem, s, vals, b, offsets, bands,
                            y, rows, cols, k, ndiag, rows_per_step, nbands,
                            rows_per_cta, tpr, stride, buf_rows, band_diags,
                            buffers, bvec, vvec, yvec);
            break;
        case 16:
            err = launch<P, 16>(grid, threads, smem, s, vals, b, offsets, bands,
                             y, rows, cols, k, ndiag, rows_per_step, nbands,
                             rows_per_cta, tpr, stride, buf_rows, band_diags,
                             buffers, bvec, vvec, yvec);
            break;
        case 32:
            err = launch<P, 32>(grid, threads, smem, s, vals, b, offsets, bands,
                             y, rows, cols, k, ndiag, rows_per_step, nbands,
                             rows_per_cta, tpr, stride, buf_rows, band_diags,
                             buffers, bvec, vvec, yvec);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// bands: (nbands, 2) int32 {first, end} diagonal indices, increasing
// offsets within and across bands; rows_per_cta * threads_per_row <=
// 512; a band's span (rows_per_cta + its last offset - its first) <=
// buf_rows and its diagonals <= band_diags; stride >= threads_per_row *
// cols_per_thread, a multiple of 4 (ops/spmm_dia.py spmm_dia_tiling).
// vals: the policy's slots; b and y: its sum type
#define SPMM_DIA_BUILD(sfx, P)                                              \
    extern "C" int spmm_dia_##sfx(                                          \
        const void* vals, const void* b, const int* offsets,                \
        const int* bands, void* y, long long rows, long long cols, int k,   \
        int ndiag, int rows_per_step, int nbands, int rows_per_cta,         \
        int cols_per_thread, int threads_per_row, int stride,               \
        int buf_rows, int band_diags, int buffers, void* stream) {          \
        return launch_spmm_dia<P>(vals, b, offsets, bands, y, rows, cols,   \
                                  k, ndiag, rows_per_step, nbands,          \
                                  rows_per_cta, cols_per_thread,            \
                                  threads_per_row, stride, buf_rows,        \
                                  band_diags, buffers, stream);             \
    }

SPMM_DIA_BUILD(f32, spmv::F32Values)
SPMM_DIA_BUILD(bf16, spmv::Bf16Values)
SPMM_DIA_BUILD(i32, spmv::I32Values)
SPMM_DIA_BUILD(u32, spmv::U32Values)
SPMM_DIA_BUILD(f16, spmv::F16Values)
SPMM_DIA_BUILD(i8, spmv::I8Values)
SPMM_DIA_BUILD(u8, spmv::U8Values)
SPMM_DIA_BUILD(i16, spmv::I16Values)
SPMM_DIA_BUILD(u16, spmv::U16Values)
