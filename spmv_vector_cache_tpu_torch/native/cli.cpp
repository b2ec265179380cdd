/* spmv_bench — native benchmark CLI.
 *
 * The role of the reference's interactive benchmark app (software/
 * main.cpp:146-264): sweep a list of matrices, run the golden software
 * SpMV, time it, optionally run preprocessing analyses (CMS marking,
 * maxAlive, maxColSpan — the -p flag mirrors benchmarkSW's preprocessing
 * timing, SoftwareSpMV.cpp:72-94), check against golden.bin when present
 * (the compareGolden memcmp, HardwareSpMV.cpp:37-39), and emit one CSV row
 * per run with the statKeys taxonomy (SpMV.h:28-29, main.cpp:49-66).
 *
 * Matrices load from directories in the reference's binary wire format
 * (file system instead of SD card + JTAG).
 *
 * Usage:  spmv_bench [-n iters] [-p] [-x] <matrix-dir> [<matrix-dir> ...]
 *   -n N   timing iterations (default 10)
 *   -p     run preprocessing analyses and report their times
 *   -x     value payload is uint64 (exactness variants)
 */
#include "spmvref.h"

#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

namespace {

std::string basename_of(std::string path) {
  while (!path.empty() && path.back() == '/') path.pop_back();
  const size_t slash = path.find_last_of('/');
  return slash == std::string::npos ? path : path.substr(slash + 1);
}

int check_golden(const std::string &dir, const double *y, uint32_t rows) {
  /* memcmp vs golden.bin: 0 diff bytes = pass (HardwareSpMV.cpp:37-61) */
  const std::string path = dir + "/golden.bin";
  FILE *f = fopen(path.c_str(), "rb");
  if (!f) return -1; /* no golden available */
  std::vector<double> gold(rows);
  const size_t got = fread(gold.data(), sizeof(double), rows, f);
  fclose(f);
  if (got != rows) return -2;
  int diff = 0;
  for (uint32_t i = 0; i < rows; ++i) {
    if (std::memcmp(&gold[i], &y[i], sizeof(double)) != 0) ++diff;
  }
  return diff;
}

}  // namespace

int main(int argc, char **argv) {
  int iters = 10;
  bool prep = false, u64 = false;
  std::vector<std::string> dirs;
  for (int i = 1; i < argc; ++i) {
    if (!std::strcmp(argv[i], "-n") && i + 1 < argc) {
      iters = std::atoi(argv[++i]);
    } else if (!std::strcmp(argv[i], "-p")) {
      prep = true;
    } else if (!std::strcmp(argv[i], "-x")) {
      u64 = true;
    } else {
      dirs.push_back(argv[i]);
    }
  }
  if (dirs.empty()) {
    std::fprintf(stderr,
                 "usage: spmv_bench [-n iters] [-p] [-x] <matrix-dir>...\n");
    return 2;
  }

  /* CSV header (printKeys role, main.cpp:49-55) */
  std::printf("matrix,rows,cols,nz,spmvtime,mnnz_per_s,diffFromGolden");
  if (prep) std::printf(",cmstime,maxAliveTime,maxColSpanTime,maxAlive,maxColSpan");
  std::printf("\n");

  int rc = 0;
  for (const std::string &dir : dirs) {
    const std::string name = basename_of(dir);
    spmv_meta_t meta;
    spmv_index_t *indptr = nullptr, *inds = nullptr;
    void *data = nullptr;
    const int err = spmv_load_matrix(dir.c_str(), name.c_str(), &meta,
                                     &indptr, &inds, &data);
    if (err != 0) {
      std::fprintf(stderr, "error: cannot load %s (code %d)\n", dir.c_str(),
                   err);
      rc = 1;
      continue;
    }

    double spmv_time = 0.0;
    int diff = -1;
    if (u64) {
      std::vector<uint64_t> x(meta.cols, 1), y(meta.rows, 0);
      const double t0 = spmv_time_seconds();
      for (int it = 0; it < iters; ++it) {
        std::fill(y.begin(), y.end(), 0);
        spmv_csc_u64(meta.rows, meta.cols, meta.nnz, indptr, inds,
                     static_cast<const uint64_t *>(data), x.data(), y.data());
      }
      spmv_time = (spmv_time_seconds() - t0) / iters;
    } else {
      std::vector<double> x(meta.cols, 1.0), y(meta.rows, 0.0);
      const double t0 = spmv_time_seconds();
      for (int it = 0; it < iters; ++it) {
        std::fill(y.begin(), y.end(), 0.0);
        spmv_csc_f64(meta.rows, meta.cols, meta.nnz, indptr, inds,
                     static_cast<const double *>(data), x.data(), y.data());
      }
      spmv_time = (spmv_time_seconds() - t0) / iters;
      diff = check_golden(dir, y.data(), meta.rows);
    }

    std::printf("%s,%u,%u,%u,%.6g,%.3f,%d", name.c_str(), meta.rows,
                meta.cols, meta.nnz, spmv_time,
                meta.nnz / spmv_time / 1e6, diff);

    if (prep) {
      double t0 = spmv_time_seconds();
      spmv_mark_row_starts(meta.rows, meta.nnz, inds, 0, 31);
      const double cms_time = spmv_time_seconds() - t0;
      spmv_clear_row_markings(meta.nnz, inds);

      t0 = spmv_time_seconds();
      const uint32_t alive = spmv_max_alive(meta.rows, meta.nnz, inds);
      const double alive_time = spmv_time_seconds() - t0;

      t0 = spmv_time_seconds();
      const uint32_t span = spmv_max_col_span(meta.cols, indptr, inds);
      const double span_time = spmv_time_seconds() - t0;
      std::printf(",%.6g,%.6g,%.6g,%u,%u", cms_time, alive_time, span_time,
                  alive, span);
    }
    std::printf("\n");

    if (diff > 0) rc = 1; /* golden mismatch fails the run */
    spmv_free_aligned(indptr);
    spmv_free_aligned(inds);
    spmv_free_aligned(data);
  }
  return rc;
}
