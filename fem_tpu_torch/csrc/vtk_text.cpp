// The text of a legacy ASCII VTK file, formatted from whole arrays on the
// host: the reference's WriteOutput (m_io.F90:480-555), as
// fem_tpu_torch/io/vtk.py writes it.
//
//   POINTS rows     F0.3, zero-padded to 3 components, each value + " "
//   CELLS rows      "n id id ..."
//   CELL_TYPES rows the VTK cell type
//   STRESS rows     F0.6, each value + " "
//   displacements   F0.6, zero-padded to 3 components, each value + " "
//
// F0.d is Python's f"{v:.{d}f}" with the leading zero dropped, as Fortran
// prints it: ".000", "-.000000". std::to_chars(..., chars_format::fixed, d)
// rounds the exact binary value correctly, as Python does; NaN of either
// sign prints "nan", the infinities "inf" and "-inf", as in Python.
//
// Each section's rows are split into `threads` contiguous chunks. Thread t
// formats chunk t of every section into its own string, and the pieces are
// joined in order, so the bytes do not depend on the thread count.
//
// Plain C ABI, bound with ctypes by fem_tpu_torch/kernels_build.py.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// The longest fixed spelling of a double: 309 integer digits, the point,
// 6 decimals and the sign.
constexpr int kMaxValue = 330;

void put_f0(std::string &s, double v, int decimals) {
  if (std::isnan(v)) {
    s.append("nan");
    return;
  }
  char buf[kMaxValue];
  char *end = std::to_chars(buf, buf + kMaxValue, v, std::chars_format::fixed,
                            decimals).ptr;
  const char *p = buf;
  if (p[0] == '-' && p[1] == '0' && p[2] == '.') {
    s.push_back('-');
    p += 2;
  } else if (p[0] == '0' && p[1] == '.') {
    p += 1;
  }
  s.append(p, end - p);
}

void put_int(std::string &s, long long v) {
  char buf[24];
  s.append(buf, std::to_chars(buf, buf + sizeof buf, v).ptr - buf);
}

// Rows of `ncol` values, the first `width` read from `x` (row-major, `width`
// per row) and the rest 0.0: " ".join(values) + " ".
void value_rows(std::string &s, const double *x, int width, int ncol,
                int decimals, long long lo, long long hi) {
  s.reserve(s.size() + (hi - lo) * ncol * (decimals + 6));
  for (long long i = lo; i < hi; ++i) {
    for (int c = 0; c < ncol; ++c) {
      if (c) s.push_back(' ');
      put_f0(s, c < width ? x[i * width + c] : 0.0, decimals);
    }
    s.append(" \n");
  }
}

void cell_rows(std::string &s, const long long *offsets,
               const long long *nodes, long long lo, long long hi) {
  s.reserve(s.size() + (offsets[hi] - offsets[lo]) * 8 + (hi - lo) * 3);
  for (long long i = lo; i < hi; ++i) {
    put_int(s, offsets[i + 1] - offsets[i]);
    s.push_back(' ');
    for (long long k = offsets[i]; k < offsets[i + 1]; ++k) {
      if (k > offsets[i]) s.push_back(' ');
      put_int(s, nodes[k]);
    }
    s.push_back('\n');
  }
}

void type_rows(std::string &s, const long long *vtk_ids, long long lo,
               long long hi) {
  s.reserve(s.size() + (hi - lo) * 3);
  for (long long i = lo; i < hi; ++i) {
    put_int(s, vtk_ids[i]);
    s.push_back('\n');
  }
}

std::string header(const char *fmt, long long a, long long b = 0) {
  char buf[128];
  int n = std::snprintf(buf, sizeof buf, fmt, a, b);
  return std::string(buf, n);
}

}  // namespace

extern "C" {

// Formats the whole file into a buffer allocated with malloc: *out and *len
// on return, freed by fem_vtk_free. Returns 0, or 1 if memory ran out.
//   coords (nnds, pdim), disp (nnds, pdim) and stress (nnds, cpdim) float64;
//   vtk_ids (ne,), offsets (ne + 1,) and nodes (offsets[ne],) int64.
int fem_vtk_text(const double *coords, const double *stress,
                 const double *disp, long long nnds, int pdim, int cpdim,
                 const long long *vtk_ids, const long long *offsets,
                 const long long *nodes, long long ne, int threads,
                 char **out, long long *len) {
  const int nt = std::max(1, threads);
  const int ncol = std::max(pdim, 3);
  constexpr int kSections = 5;
  // pieces[s * nt + t]: chunk t of section s
  std::vector<std::string> pieces(kSections * nt);
  std::vector<char> failed(nt, 0);
  auto work = [&](int t) {
    try {
      auto chunk = [&](long long n, long long &lo, long long &hi) {
        lo = n * t / nt;
        hi = n * (t + 1) / nt;
      };
      long long lo, hi;
      chunk(nnds, lo, hi);
      value_rows(pieces[0 * nt + t], coords, pdim, ncol, 3, lo, hi);
      value_rows(pieces[3 * nt + t], stress, cpdim, cpdim, 6, lo, hi);
      value_rows(pieces[4 * nt + t], disp, pdim, ncol, 6, lo, hi);
      chunk(ne, lo, hi);
      cell_rows(pieces[1 * nt + t], offsets, nodes, lo, hi);
      type_rows(pieces[2 * nt + t], vtk_ids, lo, hi);
    } catch (...) {  // std::bad_alloc
      failed[t] = 1;
    }
  };
  std::vector<std::thread> pool;
  try {
    for (int t = 1; t < nt; ++t) pool.emplace_back(work, t);
  } catch (...) {  // no thread could be started: this one does the rest
    for (int t = 1 + static_cast<int>(pool.size()); t < nt; ++t) work(t);
  }
  work(0);
  for (auto &th : pool) th.join();
  if (std::count(failed.begin(), failed.end(), 1)) return 1;

  const std::string heads[kSections] = {
      "# vtk DataFile Version 2.0\nFile written by Defmod\nASCII\n"
      "DATASET UNSTRUCTURED_GRID\n" +
          header("POINTS %lld double\n", nnds),
      header("CELLS %lld %lld\n", ne, offsets[ne] + ne),
      header("CELL_TYPES %lld\n", ne),
      header("POINT_DATA %lld\nSCALARS STRESS FLOAT %lld\n"
             "LOOKUP_TABLE DEFAULT\n", nnds, cpdim),
      "VECTORS displacements double\n"};
  size_t total = 0;
  for (int s = 0; s < kSections; ++s) {
    total += heads[s].size();
    for (int t = 0; t < nt; ++t) total += pieces[s * nt + t].size();
  }
  char *buf = static_cast<char *>(std::malloc(total));
  if (!buf) return 1;
  char *p = buf;
  for (int s = 0; s < kSections; ++s) {
    std::memcpy(p, heads[s].data(), heads[s].size());
    p += heads[s].size();
    for (int t = 0; t < nt; ++t) {
      const std::string &piece = pieces[s * nt + t];
      std::memcpy(p, piece.data(), piece.size());
      p += piece.size();
    }
  }
  *out = buf;
  *len = static_cast<long long>(total);
  return 0;
}

void fem_vtk_free(char *p) { std::free(p); }

}  // extern "C"
