// The Jacobian half of problem.load's mesh check
// (fem_tpu_torch/models/problem.py, _validate_mesh): each continuum
// element's least Jacobian determinant over its integration points.
//
//   J[p][d] = sum_n dN[i][p][n] * x[conn[e][n]][d]   (einsum "ipn,end->eipd")
//   det J   in closed form: 2x2, or 3x3 by cofactors along the first row
//
// The loop is instantiated for each continuum shape the port has (nodes,
// dimension, integration points): tri (3, 2, 1), qua (4, 2, 4), tet (4, 3,
// 1) and hex (8, 3, 8), so that every inner loop has a fixed trip count;
// read at run time, the same loop is several times slower and stops
// scaling with threads. The minimum follows numpy's: a NaN at any point
// is the element's minimum, and a NaN is not <= 0.
//
// Elements are split into `threads` contiguous chunks, one a thread, and
// each element is computed alone, so the output does not depend on the
// thread count. The caller has checked that every node id of `conn`
// indexes a row of `coords`.
//
// Plain C ABI, bound with ctypes by fem_tpu_torch/kernels_build.py.

#include <algorithm>
#include <cmath>
#include <limits>
#include <thread>
#include <vector>

namespace {

template <int D>
double det(const double (&j)[D][D]);

template <>
double det<2>(const double (&j)[2][2]) {
  return j[0][0] * j[1][1] - j[0][1] * j[1][0];
}

template <>
double det<3>(const double (&j)[3][3]) {
  return j[0][0] * (j[1][1] * j[2][2] - j[1][2] * j[2][1]) -
         j[0][1] * (j[1][0] * j[2][2] - j[1][2] * j[2][0]) +
         j[0][2] * (j[1][0] * j[2][1] - j[1][1] * j[2][0]);
}

// Elements [lo, hi): each one's least det J into out, and the count of
// those whose least det J is <= 0.
template <int NN, int D, int NIP>
long long min_detj(const double *coords, const int *conn, const double *dn,
                   double *out, long long lo, long long hi) {
  double g[NIP][D][NN];
  std::copy(dn, dn + NIP * D * NN, &g[0][0][0]);
  long long bad = 0;
  for (long long e = lo; e < hi; ++e) {
    double x[NN][D];
    for (int n = 0; n < NN; ++n) {
      const double *c = coords + static_cast<long long>(conn[e * NN + n]) * D;
      for (int d = 0; d < D; ++d) x[n][d] = c[d];
    }
    double least = std::numeric_limits<double>::infinity();
    for (int i = 0; i < NIP; ++i) {
      double j[D][D];
      for (int p = 0; p < D; ++p) {
        for (int d = 0; d < D; ++d) {
          double s = 0.0;
          for (int n = 0; n < NN; ++n) s += g[i][p][n] * x[n][d];
          j[p][d] = s;
        }
      }
      const double v = det<D>(j);
      if (v < least || std::isnan(v)) least = v;
    }
    out[e] = least;
    bad += least <= 0.0;
  }
  return bad;
}

using Check = long long (*)(const double *, const int *, const double *,
                            double *, long long, long long);

Check shape(int nn, int pdim, int nip) {
  if (nn == 3 && pdim == 2 && nip == 1) return min_detj<3, 2, 1>;
  if (nn == 4 && pdim == 2 && nip == 4) return min_detj<4, 2, 4>;
  if (nn == 4 && pdim == 3 && nip == 1) return min_detj<4, 3, 1>;
  if (nn == 8 && pdim == 3 && nip == 8) return min_detj<8, 3, 8>;
  return nullptr;
}

}  // namespace

extern "C" {

// coords (nnds, pdim) float64, conn (ne, nn) int32, dn (nip, pdim, nn)
// float64, out (ne,) float64. Returns the count of elements whose least
// det J is <= 0, or -1 if (nn, pdim, nip) is not a shape the port has.
long long fem_mesh_min_detj(const double *coords, int pdim, const int *conn,
                            long long ne, int nn, const double *dn, int nip,
                            int threads, double *out) {
  const Check check = shape(nn, pdim, nip);
  if (!check) return -1;
  const int nt = static_cast<int>(
      std::max<long long>(1, std::min<long long>(threads, ne)));
  std::vector<long long> bad(nt, 0);
  auto work = [&](int t) {
    bad[t] = check(coords, conn, dn, out, ne * t / nt, ne * (t + 1) / nt);
  };
  std::vector<std::thread> pool;
  try {
    for (int t = 1; t < nt; ++t) pool.emplace_back(work, t);
  } catch (...) {  // no thread could be started: this one does the rest
    for (int t = 1 + static_cast<int>(pool.size()); t < nt; ++t) work(t);
  }
  work(0);
  for (auto &th : pool) th.join();
  long long total = 0;
  for (long long b : bad) total += b;
  return total;
}

}  // extern "C"
