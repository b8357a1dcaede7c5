// Fast CSV ingestion for the photo-z data path (ref demo_photoz.m:41
// csvread) — a mmap'd single-pass float parser, ~10-20x faster than
// numpy.loadtxt on the multi-GB catalogs the 10M-row north-star targets.
// NaN/empty fields parse to NaN (missing-data path).
// A copy of gpz_tpu/native/csv_reader.cpp.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Pass 1: count columns (from the first line) and rows.
// Returns 0 on success.
int gpz_csv_dims(const char* path, int64_t* rows_out, int64_t* cols_out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  size_t len = static_cast<size_t>(st.st_size);
  if (len == 0) { close(fd); *rows_out = 0; *cols_out = 0; return 0; }
  const char* buf =
      static_cast<const char*>(mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0));
  if (buf == MAP_FAILED) { close(fd); return -1; }

  int64_t cols = 1;
  size_t i = 0;
  for (; i < len && buf[i] != '\n'; ++i)
    if (buf[i] == ',') ++cols;

  int64_t rows = 0;
  for (size_t j = 0; j < len; ++j)
    if (buf[j] == '\n') ++rows;
  if (len > 0 && buf[len - 1] != '\n') ++rows;  // no trailing newline

  munmap(const_cast<char*>(buf), len);
  close(fd);
  *rows_out = rows;
  *cols_out = cols;
  return 0;
}

// Pass 2: parse into a caller-allocated (rows, cols) row-major double array.
// skip_rows skips leading (header) lines. Returns number of rows parsed, or
// a negative errno-style code.
int64_t gpz_csv_read(const char* path, double* out, int64_t rows,
                     int64_t cols, int64_t skip_rows) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  size_t len = static_cast<size_t>(st.st_size);
  const char* buf =
      static_cast<const char*>(mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0));
  if (buf == MAP_FAILED) { close(fd); return -1; }
  madvise(const_cast<char*>(buf), len, MADV_SEQUENTIAL);

  const char* p = buf;
  const char* end = buf + len;
  for (int64_t s = 0; s < skip_rows && p < end; ++s) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }

  int64_t r = 0;
  while (p < end && r < rows) {
    for (int64_t c = 0; c < cols; ++c) {
      // strtod handles nan/inf/exponents; empty field -> NaN
      if (p >= end || *p == ',' || *p == '\n' || *p == '\r') {
        out[r * cols + c] = NAN;
      } else {
        char* next = nullptr;
        out[r * cols + c] = strtod(p, &next);
        p = next;
      }
      while (p < end && *p != ',' && *p != '\n') ++p;
      if (p < end && *p == ',') ++p;
    }
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
    ++r;
  }

  munmap(const_cast<char*>(buf), len);
  close(fd);
  return r;
}

}  // extern "C"
