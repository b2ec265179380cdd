/* Native host-side sparse reference runtime — see spmvref.h.
 *
 * Semantics ported from the reference's software layer (cited per
 * function); implementation is fresh C++17 for a POSIX host rather than
 * the Zynq bare-metal environment.
 */
#include "spmvref.h"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>
#include <vector>

namespace {
constexpr spmv_index_t kIndexMask = 0x3FFFFFFF;  /* SparseMatrix.cpp:63 */
}

extern "C" {

/* --- kernels ----------------------------------------------------------- */

void spmv_csc_f64(uint32_t /*rows*/, uint32_t cols, uint32_t /*nnz*/,
                  const spmv_index_t *indptr, const spmv_index_t *inds,
                  const double *data, const double *x, double *y) {
  /* the golden loop: y[rowInd[e]] += nzData[e] * x[col]
   * (SoftwareSpMV.cpp:59-64), with CMS marker bits stripped so marked
   * matrices still produce correct results */
  for (uint32_t col = 0; col < cols; ++col) {
    const double xj = x[col];
    for (spmv_index_t e = indptr[col]; e < indptr[col + 1]; ++e) {
      y[inds[e] & kIndexMask] += data[e] * xj;
    }
  }
}

void spmv_csr_f64(uint32_t rows, uint32_t /*cols*/, uint32_t /*nnz*/,
                  const spmv_index_t *indptr, const spmv_index_t *inds,
                  const double *data, const double *x, double *y) {
  for (uint32_t row = 0; row < rows; ++row) {
    double acc = y[row];
    for (spmv_index_t e = indptr[row]; e < indptr[row + 1]; ++e) {
      acc += data[e] * x[inds[e] & kIndexMask];
    }
    y[row] = acc;
  }
}

void spmv_csc_u64(uint32_t /*rows*/, uint32_t cols, uint32_t /*nnz*/,
                  const spmv_index_t *indptr, const spmv_index_t *inds,
                  const uint64_t *data, const uint64_t *x, uint64_t *y) {
  for (uint32_t col = 0; col < cols; ++col) {
    const uint64_t xj = x[col];
    for (spmv_index_t e = indptr[col]; e < indptr[col + 1]; ++e) {
      y[inds[e] & kIndexMask] += data[e] * xj;
    }
  }
}

/* --- analyses ----------------------------------------------------------- */

void spmv_mark_row_starts(uint32_t rows, uint32_t nnz, spmv_index_t *inds,
                          int reverse, int shift) {
  /* seen-bitmap pass over the nz stream (SparseMatrix.cpp:52-90);
   * bit 31 = row start / CMS bit, bit 30 = row end */
  const uint32_t words = rows / 32 + 1;
  std::vector<uint32_t> seen(words, 0);
  for (uint32_t i = 0; i < nnz; ++i) {
    const uint32_t e = reverse ? (nnz - 1 - i) : i;
    const spmv_index_t row = inds[e] & kIndexMask;
    const uint32_t w = row / 32, b = row % 32;
    if (!(seen[w] & (1u << b))) {
      seen[w] |= 1u << b;
      inds[e] |= 1u << shift;
    }
  }
}

void spmv_clear_row_markings(uint32_t nnz, spmv_index_t *inds) {
  for (uint32_t e = 0; e < nnz; ++e) inds[e] &= kIndexMask;
}

uint32_t spmv_max_alive(uint32_t rows, uint32_t nnz,
                        const spmv_index_t *inds) {
  /* peak live-row count (SparseMatrix.cpp:92-108): +1 at first nz of a
   * row, -1 at its last, both applied within one step */
  std::vector<spmv_index_t> scratch(inds, inds + nnz);
  for (uint32_t e = 0; e < nnz; ++e) scratch[e] &= kIndexMask;
  spmv_mark_row_starts(rows, nnz, scratch.data(), 0, 31);
  spmv_mark_row_starts(rows, nnz, scratch.data(), 1, 30);
  uint32_t max_alive = 0, cur = 0;
  for (uint32_t e = 0; e < nnz; ++e) {
    if (scratch[e] & (1u << 31)) ++cur;
    if (scratch[e] & (1u << 30)) --cur;
    if (cur > max_alive) max_alive = cur;
  }
  return max_alive;
}

uint32_t spmv_max_col_span(uint32_t cols, const spmv_index_t *indptr,
                           const spmv_index_t *inds) {
  /* max (last - first) row index per column (SparseMatrix.cpp:110-119) */
  uint32_t max_span = 0;
  for (uint32_t c = 0; c < cols; ++c) {
    if (indptr[c + 1] == indptr[c]) continue;
    const uint32_t first = inds[indptr[c]] & kIndexMask;
    const uint32_t last = inds[indptr[c + 1] - 1] & kIndexMask;
    const uint32_t span = last - first;
    if (span > max_span) max_span = span;
  }
  return max_span;
}

/* --- conversion ---------------------------------------------------------- */

void spmv_csr_to_csc_f64(uint32_t rows, uint32_t cols, uint32_t nnz,
                         const spmv_index_t *row_ptr,
                         const spmv_index_t *col_ind, const double *a,
                         spmv_index_t *col_ptr, spmv_index_t *row_ind,
                         double *b) {
  /* counting-sort transpose (csr2csc.c:11-39 lineage): histogram of the
   * minor index, exclusive prefix sum, stable scatter */
  std::memset(col_ptr, 0, sizeof(spmv_index_t) * (cols + 1));
  for (uint32_t e = 0; e < nnz; ++e) ++col_ptr[col_ind[e] + 1];
  for (uint32_t c = 0; c < cols; ++c) col_ptr[c + 1] += col_ptr[c];
  std::vector<spmv_index_t> next(col_ptr, col_ptr + cols);
  for (uint32_t r = 0; r < rows; ++r) {
    for (spmv_index_t e = row_ptr[r]; e < row_ptr[r + 1]; ++e) {
      const spmv_index_t c = col_ind[e];
      const spmv_index_t dst = next[c]++;
      row_ind[dst] = r;
      b[dst] = a[e];
    }
  }
}

/* --- memory + timing ----------------------------------------------------- */

int spmv_ilu0_f64(uint32_t rows, const spmv_index_t *indptr,
                  const spmv_index_t *inds, double *data) {
  /* In-place IKJ Doolittle ILU(0) on the CSR pattern (columns must be
   * sorted per row).  The sorted-merge inner update replaces the Python
   * prototype's per-row dict lookups; this is the "factor once on the
   * host, solve many on device" half of the preconditioner path
   * (BASELINE config 4), the same host/accelerator split the reference
   * uses for its preprocessing analyses (SparseMatrix.cpp:52-119).
   * Returns 0; (i+1) if row i lacks a diagonal; -(k+1) on zero pivot. */
  std::vector<spmv_index_t> diag(rows);
  for (uint32_t i = 0; i < rows; ++i) {
    spmv_index_t lo = indptr[i], hi = indptr[i + 1];
    /* binary search for the diagonal entry */
    while (lo < hi) {
      spmv_index_t mid = lo + (hi - lo) / 2;
      if ((inds[mid] & kIndexMask) < i) lo = mid + 1; else hi = mid;
    }
    if (lo >= indptr[i + 1] || (inds[lo] & kIndexMask) != i)
      return static_cast<int>(i) + 1;
    diag[i] = lo;
  }
  for (uint32_t i = 0; i < rows; ++i) {
    for (spmv_index_t e = indptr[i]; e < diag[i]; ++e) {
      const spmv_index_t k = inds[e] & kIndexMask;
      const double pivot = data[diag[k]];
      if (pivot == 0.0) return -(static_cast<int>(k) + 1);
      const double lik = data[e] / pivot;
      data[e] = lik;
      /* row_i[j] -= lik * row_k[j] over the shared pattern, j > k:
       * two-pointer merge of the sorted column lists */
      spmv_index_t f = diag[k] + 1;            /* row k, cols > k   */
      spmv_index_t g = e + 1;                  /* row i, cols > k   */
      const spmv_index_t fend = indptr[k + 1], gend = indptr[i + 1];
      while (f < fend && g < gend) {
        const spmv_index_t cf = inds[f] & kIndexMask;
        const spmv_index_t cg = inds[g] & kIndexMask;
        if (cf == cg) {
          data[g] -= lik * data[f];
          ++f; ++g;
        } else if (cf < cg) {
          ++f;
        } else {
          ++g;
        }
      }
    }
  }
  return 0;
}

void *spmv_malloc_aligned(size_t bytes, size_t align) {
  /* burst-aligned allocation (malloc_aligned.c:6-58 role; the reference
   * hand-rolls book-keeping, POSIX gives it to us directly) */
  if (align < sizeof(void *)) align = sizeof(void *);
  void *p = nullptr;
  if (posix_memalign(&p, align, bytes ? bytes : align) != 0) return nullptr;
  return p;
}

void spmv_free_aligned(void *p) { free(p); }

double spmv_time_seconds(void) {
  /* monotonic wall clock (timer.c:15-31 role, sans the 333 MHz SCU) */
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<double>(ts.tv_sec) + 1e-9 * static_cast<double>(ts.tv_nsec);
}

/* --- wire format ---------------------------------------------------------- */

namespace {
long file_size(FILE *f) {
  if (fseek(f, 0, SEEK_END) != 0) return -1;
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  return n;
}

void *read_whole(const std::string &path, long *out_bytes) {
  FILE *f = fopen(path.c_str(), "rb");
  if (!f) return nullptr;
  long n = file_size(f);
  if (n < 0) { fclose(f); return nullptr; }
  void *buf = spmv_malloc_aligned(static_cast<size_t>(n), 64);
  if (buf && fread(buf, 1, static_cast<size_t>(n), f) !=
                 static_cast<size_t>(n)) {
    spmv_free_aligned(buf);
    buf = nullptr;
  }
  fclose(f);
  if (out_bytes) *out_bytes = n;
  return buf;
}
}  // namespace

int spmv_load_matrix(const char *dir, const char *name, spmv_meta_t *meta,
                     spmv_index_t **indptr, spmv_index_t **inds, void **data) {
  /* file-based analog of loadSparseMatrixFromSDCard + SparseMatrix::
   * fromMemory (main.cpp:26-47, SparseMatrix.cpp:29-50) */
  const std::string base = std::string(dir) + "/" + name + "-";
  long n = 0;
  spmv_meta_t *m = static_cast<spmv_meta_t *>(read_whole(base + "meta.bin", &n));
  if (!m || n < static_cast<long>(sizeof(spmv_meta_t))) {
    spmv_free_aligned(m);
    return 1;
  }
  *meta = *m;
  spmv_free_aligned(m);
  if (meta->rows == 0 || meta->cols == 0 || meta->nnz == 0) return 2;

  *indptr = static_cast<spmv_index_t *>(read_whole(base + "indptr.bin", &n));
  if (!*indptr || n != static_cast<long>((meta->cols + 1) * 4)) return 3;
  *inds = static_cast<spmv_index_t *>(read_whole(base + "inds.bin", &n));
  if (!*inds || n != static_cast<long>(meta->nnz * 4)) return 4;
  *data = read_whole(base + "data.bin", &n);
  if (!*data || n != static_cast<long>(meta->nnz) * 8) return 5;
  return 0;
}

}  /* extern "C" */
