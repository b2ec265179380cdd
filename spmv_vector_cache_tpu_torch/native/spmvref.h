/* Native host-side sparse reference runtime.
 *
 * C++ re-home of the reference's Zynq software layer (C ABI for ctypes):
 *   - sequential CSC/CSR SpMV golden kernels   (software/SoftwareSpMV.cpp:50-70)
 *   - preprocessing analyses: row-start (CMS) marking, maxAlive, maxColSpan
 *                                              (software/SparseMatrix.cpp:52-119)
 *   - counting-sort CSR<->CSC transpose        (software/csr2csc.c:11-39)
 *   - 64-byte aligned allocation               (software/malloc_aligned.c:6-58)
 *   - monotonic timer                          (software/timer.c:1-31)
 *   - binary wire-format loader for the reference's meta/indptr/inds/data
 *     blobs                                    (software/SparseMatrix.cpp:29-50,
 *                                              matrices/matrixutils.py:187-260)
 *
 * Index type is uint32 ("SpMVIndex", SparseMatrix.h:5), value type double
 * ("SpMVData", SparseMatrix.h:6); uint64 value entry points cover the
 * *-uint64 exactness variants.
 */
#ifndef SPMVREF_H
#define SPMVREF_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef uint32_t spmv_index_t;
typedef double spmv_data_t;

/* mirror of CompressedSparseMetadata (software/SparseMatrix.h:8-16) */
typedef struct {
  uint32_t rows;
  uint32_t cols;
  uint32_t nnz;
  uint32_t starting_row;
  uint32_t indptr_base;
  uint32_t inds_base;
  uint32_t data_base;
} spmv_meta_t;

/* --- kernels ----------------------------------------------------------- */

/* y += A x over CSC, in exact storage order (SoftwareSpMV.cpp:59-64) */
void spmv_csc_f64(uint32_t rows, uint32_t cols, uint32_t nnz,
                  const spmv_index_t *indptr, const spmv_index_t *inds,
                  const double *data, const double *x, double *y);

void spmv_csr_f64(uint32_t rows, uint32_t cols, uint32_t nnz,
                  const spmv_index_t *indptr, const spmv_index_t *inds,
                  const double *data, const double *x, double *y);

/* integer semiring variant for the *-uint64 exactness matrices */
void spmv_csc_u64(uint32_t rows, uint32_t cols, uint32_t nnz,
                  const spmv_index_t *indptr, const spmv_index_t *inds,
                  const uint64_t *data, const uint64_t *x, uint64_t *y);

/* --- analyses (SparseMatrix.cpp:52-119) -------------------------------- */

/* set bit `shift` on first (reverse=0) / last (reverse=1) nz of each row */
void spmv_mark_row_starts(uint32_t rows, uint32_t nnz, spmv_index_t *inds,
                          int reverse, int shift);
void spmv_clear_row_markings(uint32_t nnz, spmv_index_t *inds);
uint32_t spmv_max_alive(uint32_t rows, uint32_t nnz, const spmv_index_t *inds);
uint32_t spmv_max_col_span(uint32_t cols, const spmv_index_t *indptr,
                           const spmv_index_t *inds);

/* --- conversion (csr2csc.c:11-39 counting transpose) -------------------- */

void spmv_csr_to_csc_f64(uint32_t rows, uint32_t cols, uint32_t nnz,
                         const spmv_index_t *row_ptr, const spmv_index_t *col_ind,
                         const double *a,
                         spmv_index_t *col_ptr, spmv_index_t *row_ind,
                         double *b);

/* --- factorization -------------------------------------------------------
 * In-place ILU(0) on the CSR pattern (sorted columns). Returns 0 on
 * success, i+1 if row i lacks a diagonal entry, -(k+1) on zero pivot.
 */
int spmv_ilu0_f64(uint32_t rows, const spmv_index_t *indptr,
                  const spmv_index_t *inds, double *data);

/* --- memory + timing ---------------------------------------------------- */

void *spmv_malloc_aligned(size_t bytes, size_t align); /* 64B default role */
void spmv_free_aligned(void *p);
double spmv_time_seconds(void);

/* --- wire format --------------------------------------------------------
 * Load "<dir>/<name>-{meta,indptr,inds,data}.bin".  Returns 0 on success.
 * Buffers are allocated with spmv_malloc_aligned(…, 64) and owned by the
 * caller (free with spmv_free_aligned).  *data_is_u64 reports the payload
 * dtype heuristic (dir name tag, matrixutils.py:100-103, decided by caller).
 */
int spmv_load_matrix(const char *dir, const char *name, spmv_meta_t *meta,
                     spmv_index_t **indptr, spmv_index_t **inds, void **data);

#ifdef __cplusplus
}
#endif

#endif /* SPMVREF_H */
