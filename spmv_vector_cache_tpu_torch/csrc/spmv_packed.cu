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
// Hillis-Steele scan over lane rolls; here one warp owns a row, each
// thread scans its 4 consecutive slots serially and the warp combines
// the 32 partial results with a segmented shuffle scan — the same piece
// sums, added in another order.
//
// Kernel F replaces the Pallas kernel `_make_extract_kernel` (same
// file).  Output element (w, e) of y window w (8192 rows) is
//   out[w*8192 + e] = sum over visits i with wstep[i] == w, in order, of
//                     S[sblock[i]*ST*1024 + esrc[i, e]]  (esrc < 0: none)
// and 0 for a window with no visit.  On the TPU the grid runs the visits
// in order and keeps the window's y block resident between them; blocks
// of a GPU grid run in parallel, so each thread owns one y element and
// walks its window's visit range itself (wstep is nondecreasing, so the
// range is found by binary search).  No two threads write one element.
//
// Bound: bytes.  Pass A streams 6 B per slot in and 4 B out (vectorised:
// 16 B of values and 8 B of columns per thread); its x reads fall in one
// chunk of CB*128 columns, served by L1/L2.  Pass B streams 2 B of esrc
// per output element and visit, and reads S at the pieces' end slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowSlots = 128;        // slots per scanned row
constexpr int kWindowRows = 8192;     // y rows per pass-B window
constexpr unsigned kFullMask = 0xffffffffu;

// blockDim.x = 256: 8 warps, one 128-slot row each
__global__ void packed_scan_kernel(const float* __restrict__ vals,
                                   const int16_t* __restrict__ cols,
                                   const int* __restrict__ cstep,
                                   const float* __restrict__ x,
                                   float* __restrict__ out, long long rows,
                                   int rows_per_step, long long chunk_cols,
                                   long long ncols) {
    long long row = (long long)blockIdx.x * (blockDim.x / 32) +
                    threadIdx.x / 32;
    if (row >= rows) return;              // uniform over the warp
    int k = threadIdx.x & 31;
    long long xbase =
        (long long)__ldg(cstep + row / rows_per_step) * chunk_cols;
    long long off = row * kRowSlots + 4 * k;
    float4 v4 = __ldg(reinterpret_cast<const float4*>(vals + off));
    short4 c4 = __ldg(reinterpret_cast<const short4*>(cols + off));
    float v[4] = {v4.x, v4.y, v4.z, v4.w};
    int c[4] = {c4.x, c4.y, c4.z, c4.w};
    float s[4];
    bool start[4];
    for (int j = 0; j < 4; ++j) {
        long long g = xbase + (c[j] & 16383);
        float xv = g < ncols ? __ldg(x + g) : 0.0f;
        float p = __fmul_rn(v[j], xv);
        start[j] = (c[j] >> 14) & 1;
        s[j] = (j == 0 || start[j]) ? p : __fadd_rn(s[j - 1], p);
    }
    // segmented inclusive scan of the threads' (sum, any-start) pairs
    float inc = s[3];
    int flag = start[0] | start[1] | start[2] | start[3];
    for (int d = 1; d < 32; d <<= 1) {
        float up = __shfl_up_sync(kFullMask, inc, d);
        int up_flag = __shfl_up_sync(kFullMask, flag, d);
        if (k >= d) {
            if (!flag) inc = __fadd_rn(up, inc);
            flag |= up_flag;
        }
    }
    float carry = __shfl_up_sync(kFullMask, inc, 1);
    if (k > 0) {
        // the carry runs into this thread's slots up to its first start
        for (int j = 0; j < 4 && !start[j]; ++j)
            s[j] = __fadd_rn(carry, s[j]);
    }
    *reinterpret_cast<float4*>(out + off) = make_float4(s[0], s[1], s[2],
                                                        s[3]);
}

// first i in [0, n) with a[i] >= key (a nondecreasing)
__device__ int lower_bound(const int* __restrict__ a, int n, int key) {
    int lo = 0, hi = n;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// grid (kWindowRows / blockDim.x, num_windows)
__global__ void packed_extract_kernel(const float* __restrict__ scan,
                                      const int* __restrict__ sblock,
                                      const int* __restrict__ wstep,
                                      const int16_t* __restrict__ esrc,
                                      float* __restrict__ out, int steps_b,
                                      long long block_slots) {
    int w = blockIdx.y;
    int e = blockIdx.x * blockDim.x + threadIdx.x;
    int first = lower_bound(wstep, steps_b, w);
    int last = lower_bound(wstep, steps_b, w + 1);
    float acc = 0.0f;
    for (int i = first; i < last; ++i) {
        int src = __ldg(esrc + (long long)i * kWindowRows + e);
        if (src >= 0)
            acc += __ldg(scan + (long long)__ldg(sblock + i) * block_slots +
                         src);
    }
    out[(long long)w * kWindowRows + e] = acc;
}

}  // namespace

// rows = T * 8 scanned rows; rows_per_step = 8 * step_tiles;
// chunk_cols = chunk_blocks * 128; ncols = columns of x
extern "C" int packed_scan_f32(const float* vals, const int16_t* cols,
                               const int* cstep, const float* x, float* out,
                               long long rows, int rows_per_step,
                               long long chunk_cols, long long ncols,
                               void* stream) {
    if (rows > 0) {
        constexpr int threads = 256;
        long long blocks = (rows + threads / 32 - 1) / (threads / 32);
        packed_scan_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
            vals, cols, cstep, x, out, rows, rows_per_step, chunk_cols,
            ncols);
    }
    return (int)cudaGetLastError();
}

// out: num_windows * 8192 floats; block_slots = step_tiles * 1024
extern "C" int packed_extract_f32(const float* scan, const int* sblock,
                                  const int* wstep, const int16_t* esrc,
                                  float* out, int num_windows, int steps_b,
                                  long long block_slots, void* stream) {
    if (num_windows > 0) {
        constexpr int threads = 256;
        dim3 grid(kWindowRows / threads, (unsigned)num_windows);
        packed_extract_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
            scan, sblock, wstep, esrc, out, steps_b, block_slots);
    }
    return (int)cudaGetLastError();
}
