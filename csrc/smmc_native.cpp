// Native runtime components for stock_market_monte_carlo_jax.
//
// The reference implements its runtime in C++ (CSV parsing via
// fast-cpp-csv-parser, file writers in src/helpers.cpp, Sobol generators in
// include/sobol_joekuo/). These are this framework's equivalents, exposed
// through a C ABI consumed via ctypes (stock_market_monte_carlo_jax/native).
// Python falls back to pure-Python implementations when this library is not
// built, so it is an accelerator, not a dependency.
//
// Build: `make native` at the repo root.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// Read the `returns` column of a CSV (header row names columns; extra
// columns ignored; blank/NaN cells skipped — same contract as the loader in
// data/loader.py and the reference's io::CSVReader<1> usage,
// src/simulations.cpp:83-93). Returns the count written into `out`
// (capped at `cap`), or a negative error code.
long smmc_read_returns(const char *path, float *out, long cap) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1;

  std::string content;
  {
    char buf[1 << 16];
    size_t n;
    while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) {
      content.append(buf, n);
    }
  }
  std::fclose(f);

  long count = 0;
  size_t pos = 0;
  const size_t len = content.size();
  int returns_col = -1;
  int line_no = 0;

  while (pos < len && count < cap) {
    size_t eol = content.find('\n', pos);
    if (eol == std::string::npos) eol = len;
    size_t line_end = eol;
    if (line_end > pos && content[line_end - 1] == '\r') --line_end;

    int col = 0;
    size_t cell_start = pos;
    for (size_t i = pos; i <= line_end; ++i) {
      if (i == line_end || content[i] == ',') {
        const char *cell = content.data() + cell_start;
        size_t cell_len = i - cell_start;
        if (line_no == 0) {
          if (cell_len == 7 && std::strncmp(cell, "returns", 7) == 0) {
            returns_col = col;
          }
        } else if (col == returns_col && cell_len > 0) {
          std::string s(cell, cell_len);
          char *end = nullptr;
          double v = std::strtod(s.c_str(), &end);
          if (end != s.c_str() && !std::isnan(v)) {
            out[count++] = static_cast<float>(v);
          }
        }
        ++col;
        cell_start = i + 1;
      }
    }
    if (line_no == 0 && returns_col < 0) return -2;  // no 'returns' column
    ++line_no;
    pos = eol + 1;
  }
  return count;
}

// Write one simulation's CSV in the reference schema (src/helpers.cpp:
// 23-38): "Returns,," + comma-terminated cells, newline, "Values," + cells.
// %g formatting matches std::ofstream's 6-significant-digit default.
int smmc_write_data_file(const char *path, const float *returns,
                         long n_returns, const float *values, long n_values) {
  FILE *f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fputs("Returns,,", f);
  for (long i = 0; i < n_returns; ++i) std::fprintf(f, "%g,", returns[i]);
  std::fputs("\nValues,", f);
  for (long i = 0; i < n_values; ++i) std::fprintf(f, "%g,", values[i]);
  int rc = std::fclose(f);
  return rc == 0 ? 0 : -2;
}

// Gray-code-ordered Sobol points from direction numbers — the CPU
// cross-check for the on-device generator (ops/sobol.py), re-deriving the
// same sequence the serial recurrence of the reference's Joe-Kuo generator
// (include/sobol_joekuo/sobol.cc:74-166) would produce for our direction
// numbers. direction is (dims, 32) uint32 (bit-k scaled); emits n points
// starting at sequence index `offset` into out (n * dims doubles, row-major).
int smmc_sobol_points(const uint32_t *direction, int dims, long long offset,
                      long long n, double *out) {
  if (dims <= 0 || n < 0 || offset < 0) return -1;
  // a (dims, 32) table carries a 32-bit sequence: beyond 2^32 the gray
  // fold would mix index bit 32 into state bit 31 and silently diverge
  // from the Python/device 32-bit generator this function cross-checks
  // (sobol.py truncates the index to uint32; the deep path needs the
  // (dims, 64) table / smmc_sobol_bits64)
  if (offset > 4294967296LL - n) return -1;
  const double scale = 1.0 / 4294967296.0;  // 2^-32
  // state for index `offset`: XOR of direction numbers over set bits of
  // gray(offset)
  std::vector<uint32_t> x(dims, 0);
  uint64_t gray = (uint64_t)offset ^ ((uint64_t)offset >> 1);
  for (int b = 0; b < 32; ++b) {
    if ((gray >> b) & 1ull) {
      for (int d = 0; d < dims; ++d) x[d] ^= direction[d * 32 + b];
    }
  }
  for (long long i = 0; i < n; ++i) {
    for (int d = 0; d < dims; ++d) out[i * dims + d] = x[d] * scale;
    // advance: XOR direction number of the lowest zero bit of (offset+i)
    uint64_t idx = (uint64_t)(offset + i);
    int c = 0;
    while (idx & 1ull) {
      idx >>= 1;
      ++c;
    }
    if (c < 32) {
      for (int d = 0; d < dims; ++d) x[d] ^= direction[d * 32 + c];
    }
  }
  return 0;
}

// 64-bit-depth Sobol integers — the i8-parity cross-check (the reference's
// i8_sobol supports 2^62 sequence indices in double precision,
// include/sobol/sobol.cpp:14191; its Joe-Kuo generator is 32-bit only).
// direction64 is (dims, 64) uint64 0.64-fixed-point direction numbers;
// emits the raw 64-bit XOR-fold state for n consecutive indices starting
// at `offset` (gray-code order, random access).
int smmc_sobol_bits64(const uint64_t *direction64, int dims,
                      long long offset, long long n, uint64_t *out) {
  if (dims <= 0 || n < 0 || offset < 0) return -1;
  std::vector<uint64_t> x(dims, 0);
  uint64_t gray = (uint64_t)offset ^ ((uint64_t)offset >> 1);
  for (int b = 0; b < 64; ++b) {
    if ((gray >> b) & 1ull) {
      for (int d = 0; d < dims; ++d) x[d] ^= direction64[d * 64 + b];
    }
  }
  for (long long i = 0; i < n; ++i) {
    for (int d = 0; d < dims; ++d) out[i * dims + d] = x[d];
    uint64_t idx = (uint64_t)(offset + i);
    int c = 0;
    while (idx & 1ull) {
      idx >>= 1;
      ++c;
    }
    if (c < 64) {
      for (int d = 0; d < dims; ++d) x[d] ^= direction64[d * 64 + c];
    }
  }
  return 0;
}

// Exact streaming merge of partition statistics (Chan et al.) — the
// host-side companion to the on-device partial stats, replacing the
// reference's biased mean-of-block-means merge
// (examples/benchmark_mc_gpu_reduceBlock.cpp:7-26).
// stats vectors are [n, mean, M2]; merges b into a.
void smmc_welford_merge(double *a, const double *b) {
  const double na = a[0], nb = b[0];
  const double n = na + nb;
  if (n <= 0) return;
  const double delta = b[1] - a[1];
  a[1] += delta * (nb / n);
  a[2] += b[2] + delta * delta * (na * nb / n);
  a[0] = n;
}

}  // extern "C"
