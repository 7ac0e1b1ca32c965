// Kernel K1: batched hex8 element stiffness for an isotropic Lame material,
// and (hex8_stiffness_coord_grad_kernel, further down) its backward in the
// element coordinates.
//
// Replaces fem_tpu/ops/pallas_kernels.py:hex8_stiffness_pallas (kernel body
// _kernel). Same result as fem_tpu_torch.ops.stiffness.
// element_stiffness_lame_batchlast for hex8, its plain torch form:
//
//   k_e[(a,p),(b,q)] = lam M_ab[p][q] + mu M_ab[q][p] + mu [p==q] tr(M_ab),
//   M_ab[p][q]       = sum over the 8 Gauss points of detJ w dNx[p,a] dNx[q,b]
//
// In:  ec (3, 8, ne) element coordinates, element index fastest;
//      lam, mu (ne,).
// Out: ke (24, 24, ne), row a*3+p, column b*3+q, element index fastest.
//
// What bounds it on the H100: the output. Each element writes 576 values
// (4.6 KB in float64) from ~6k FMAs and 192 bytes of input, so at 3.35 TB/s
// the stores take about 4x longer than the FP64 arithmetic at its peak. The
// design therefore makes every store coalesced and computes each 3x3 block
// directly: the Pallas kernel's one-hot selection matmuls existed only
// because Mosaic had no cheaper way to pick rows, and are not carried over.
//
// Design: a block owns kElems elements. Phase 1: thread (x=element, y=Gauss
// point) forms J, its closed-form inverse and the 24 spatial gradients dNx
// and writes them with detJ to shared memory (25 KB in float64, under the
// 48 KB static limit). Phase 2: thread (x=element, y=node a) holds
// w detJ dNx[., a] for all Gauss points in registers and walks b = 0..7,
// accumulating one 3x3 block M_ab at a time (9 accumulators, not the 300
// pair sums that would exceed the 255-register budget) and storing its 9
// entries. Consecutive threads hold consecutive elements, so each store of a
// warp covers two contiguous runs of kElems elements.

#include <cuda_runtime.h>

namespace {

constexpr int kElems = 16;  // elements per block (threadIdx.x)
constexpr int kNodes = 8;   // = Gauss points = threadIdx.y

// Sign of node (or Gauss point) i along axis d, in the order of
// fem_tpu.ops.elements' hex8 registry: (-,-,-) (+,-,-) (+,+,-) (-,+,-)
// (-,-,+) (+,-,+) (+,+,+) (-,+,+).
__device__ __forceinline__ double node_sign(int i, int d) {
  int bit = d == 0 ? ((i + 1) >> 1) & 1 : d == 1 ? (i >> 1) & 1 : (i >> 2) & 1;
  return bit ? 1.0 : -1.0;
}

// dN/dxi_p of node a at Gauss point ip, evaluated in double exactly as the
// registry's numpy table is (0.125 * s_p * (1 + s xi) * (1 + s xi)).
__device__ __forceinline__ double shape_grad(int ip, int p, int a) {
  const double g = 1.0 / sqrt(3.0);
  double f[3];
  for (int d = 0; d < 3; ++d) f[d] = node_sign(ip, d) * g;
  const double s0 = node_sign(a, 0), s1 = node_sign(a, 1), s2 = node_sign(a, 2);
  if (p == 0) return 0.125 * s0 * (1 + s1 * f[1]) * (1 + s2 * f[2]);
  if (p == 1) return 0.125 * s1 * (1 + s0 * f[0]) * (1 + s2 * f[2]);
  return 0.125 * s2 * (1 + s0 * f[0]) * (1 + s1 * f[1]);
}

template <typename T>
__global__ void __launch_bounds__(kElems * kNodes)
hex8_stiffness_kernel(const T* __restrict__ ec, const T* __restrict__ lam,
                      const T* __restrict__ mu, T* __restrict__ out,
                      long long ne) {
  __shared__ T dnx[kNodes][3][kNodes][kElems];  // [ip][p][a][element]
  __shared__ T detj[kNodes][kElems];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long e = (long long)blockIdx.x * kElems + tx;
  const bool valid = e < ne;

  if (valid) {  // phase 1: Gauss point ip = ty of element e
    const int ip = ty;
    T X[3][8];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int a = 0; a < 8; ++a) X[d][a] = ec[(d * 8 + a) * ne + e];
    T dN[3][8];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int a = 0; a < 8; ++a) dN[p][a] = (T)shape_grad(ip, p, a);
    T J[3][3];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T acc = 0;
#pragma unroll
        for (int a = 0; a < 8; ++a) acc += dN[p][a] * X[d][a];
        J[p][d] = acc;
      }
    // closed-form inverse (fem_tpu/ops/stiffness.py:148-165)
    const T c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    const T c01 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
    const T c02 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
    const T c10 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
    const T c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
    const T c12 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
    const T c20 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
    const T c21 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
    const T c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const T det = J[0][0] * c00 + J[0][1] * c10 + J[0][2] * c20;
    const T inv[3][3] = {{c00 / det, c01 / det, c02 / det},
                         {c10 / det, c11 / det, c12 / det},
                         {c20 / det, c21 / det, c22 / det}};
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int a = 0; a < 8; ++a)
        dnx[ip][p][a][tx] =
            inv[p][0] * dN[0][a] + inv[p][1] * dN[1][a] + inv[p][2] * dN[2][a];
    detj[ip][tx] = det;  // Gauss weight is 1
  }
  __syncthreads();
  if (!valid) return;

  // phase 2: node a = ty against every node b
  const int a = ty;
  T sa[kNodes][3];
#pragma unroll
  for (int ip = 0; ip < kNodes; ++ip)
#pragma unroll
    for (int p = 0; p < 3; ++p) sa[ip][p] = detj[ip][tx] * dnx[ip][p][a][tx];
  const T l = lam[e];
  const T m = mu[e];
  for (int b = 0; b < kNodes; ++b) {
    T M[3][3] = {};
#pragma unroll
    for (int ip = 0; ip < kNodes; ++ip) {
      const T g0 = dnx[ip][0][b][tx], g1 = dnx[ip][1][b][tx],
              g2 = dnx[ip][2][b][tx];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        M[p][0] += sa[ip][p] * g0;
        M[p][1] += sa[ip][p] * g1;
        M[p][2] += sa[ip][p] * g2;
      }
    }
    const T tr = M[0][0] + M[1][1] + M[2][2];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        T v = l * M[p][q] + m * M[q][p];
        if (p == q) v += m * tr;
        out[(long long)((a * 3 + p) * 24 + b * 3 + q) * ne + e] = v;
      }
  }
}

// K1's coordinate backward. With G the gradient of the output and L =
// <G, k_e>, it writes dL/dX (3, 8, ne). Only G's symmetric part Gs counts,
// since k_e is symmetric. At each Gauss point (weight 1), with N = dNx (3x8),
// dN the reference gradients, J = dN X^T, inv = J^-1 and Gs_ab the 3x3 block
// of Gs at nodes a, b:
//
//   M_ab       = lam Gs_ab + mu Gs_ab^T + mu tr(Gs_ab) I
//   Nbar'[:,a] = 2 sum_b M_ab N[:,b]      dL/dN = detJ Nbar'
//   C          = (Nbar' dN^T) inv^T       dL/ddetJ = f = tr(C) / 2
//   Jbar       = detJ inv^T (f I - C)     dL/dJ = Jbar
//   dL/dX[d,a] = sum_p Jbar[p,d] dN[p,a]  summed over the points
//
// (f is the point's term of L without detJ, by Euler's theorem for a form
// that is quadratic in N.) fem_tpu has no backward for its Pallas kernel;
// this gives what jax.grad gives through stiffness.element_stiffness_lame.
// Same result as cuda_kernels.hex8_stiffness_coord_grad_plain.
//
// What bounds it on the H100: reading G, 576 values per element, for ~6k
// FMAs. Thread (element, node a) reads Gs's block row a as G's row block and
// column block of node a, so every value of G is loaded twice, by two
// threads of one block: the second load is served from L1 / L2, and device
// memory sees G about once. Every load is coalesced (element index fastest).
//
// Design: the forward's block of kElems x 8 threads and one shared buffer
// [ip][p][a][element] used four times. Phase 1: thread (element, Gauss
// point) forms J, inv, detJ (kept in registers) and N into the buffer.
// Phase 2: thread (element, node a) walks b = 0..7, forms M_ab from 18 loads
// of G and accumulates Nbar'[:, a] of all 8 Gauss points (24 registers),
// then stores them into the buffer. Phase 3: thread (element, Gauss point)
// chains its Nbar' to the point's dL/dX and stores it in its own slice.
// Phase 4: thread (element, node a) sums its 3 values over the Gauss points
// in a fixed order (the same bits on every run) and writes them.
template <typename T>
__global__ void __launch_bounds__(kElems * kNodes)
hex8_stiffness_coord_grad_kernel(const T* __restrict__ ec,
                                 const T* __restrict__ lam,
                                 const T* __restrict__ mu,
                                 const T* __restrict__ grad,
                                 T* __restrict__ out, long long ne) {
  __shared__ T buf[kNodes][3][kNodes][kElems];  // [ip][p][a][element]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long e = (long long)blockIdx.x * kElems + tx;
  const bool valid = e < ne;

  // phase 1: Gauss point ip = ty; inv and det stay in registers for phase 3
  T inv[3][3] = {};
  T det = 0;
  if (valid) {
    const int ip = ty;
    T X[3][8];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int a = 0; a < 8; ++a) X[d][a] = ec[(d * 8 + a) * ne + e];
    T J[3][3];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T acc = 0;
#pragma unroll
        for (int a = 0; a < 8; ++a) acc += (T)shape_grad(ip, p, a) * X[d][a];
        J[p][d] = acc;
      }
    const T c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    const T c01 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
    const T c02 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
    const T c10 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
    const T c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
    const T c12 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
    const T c20 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
    const T c21 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
    const T c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    det = J[0][0] * c00 + J[0][1] * c10 + J[0][2] * c20;
    inv[0][0] = c00 / det; inv[0][1] = c01 / det; inv[0][2] = c02 / det;
    inv[1][0] = c10 / det; inv[1][1] = c11 / det; inv[1][2] = c12 / det;
    inv[2][0] = c20 / det; inv[2][1] = c21 / det; inv[2][2] = c22 / det;
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int a = 0; a < 8; ++a)
        buf[ip][p][a][tx] = inv[p][0] * (T)shape_grad(ip, 0, a) +
                            inv[p][1] * (T)shape_grad(ip, 1, a) +
                            inv[p][2] * (T)shape_grad(ip, 2, a);
  }
  __syncthreads();

  // phase 2: node a = ty; nb[ip][x] = Nbar'[x, a] at Gauss point ip
  T nb[kNodes][3] = {};
  if (valid) {
    const int a = ty;
    const T l = lam[e];
    const T m = mu[e];
    for (int b = 0; b < kNodes; ++b) {
      T gs[3][3];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          gs[p][q] = T(0.5) * (__ldg(grad + (long long)((a * 3 + p) * 24 +
                                                        b * 3 + q) * ne + e) +
                               __ldg(grad + (long long)((b * 3 + q) * 24 +
                                                        a * 3 + p) * ne + e));
      const T tr = gs[0][0] + gs[1][1] + gs[2][2];
      T M[3][3];
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          M[x][q] = l * gs[x][q] + m * gs[q][x] + (x == q ? m * tr : T(0));
#pragma unroll
      for (int ip = 0; ip < kNodes; ++ip) {
        const T n0 = buf[ip][0][b][tx], n1 = buf[ip][1][b][tx],
                n2 = buf[ip][2][b][tx];
#pragma unroll
        for (int x = 0; x < 3; ++x)
          nb[ip][x] += M[x][0] * n0 + M[x][1] * n1 + M[x][2] * n2;
      }
    }
  }
  __syncthreads();
  if (valid) {
#pragma unroll
    for (int ip = 0; ip < kNodes; ++ip)
#pragma unroll
      for (int x = 0; x < 3; ++x) buf[ip][x][ty][tx] = T(2) * nb[ip][x];
  }
  __syncthreads();

  // phase 3: Gauss point ip = ty, its own slice buf[ip][.][.][tx] only
  if (valid) {
    const int ip = ty;
    T ib[3][3];  // Nbar' dN^T
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        T acc = 0;
#pragma unroll
        for (int a = 0; a < 8; ++a)
          acc += buf[ip][p][a][tx] * (T)shape_grad(ip, q, a);
        ib[p][q] = acc;
      }
    T C[3][3];  // ib inv^T
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int r = 0; r < 3; ++r)
        C[p][r] = ib[p][0] * inv[r][0] + ib[p][1] * inv[r][1] +
                  ib[p][2] * inv[r][2];
    const T f = T(0.5) * (C[0][0] + C[1][1] + C[2][2]);
    T Jb[3][3];  // det (f inv^T - inv^T C)
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        Jb[p][d] = det * (f * inv[d][p] - (inv[0][p] * C[0][d] +
                                           inv[1][p] * C[1][d] +
                                           inv[2][p] * C[2][d]));
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int a = 0; a < 8; ++a)
        buf[ip][d][a][tx] = Jb[0][d] * (T)shape_grad(ip, 0, a) +
                            Jb[1][d] * (T)shape_grad(ip, 1, a) +
                            Jb[2][d] * (T)shape_grad(ip, 2, a);
  }
  __syncthreads();
  if (!valid) return;

  // phase 4: node a = ty, summed over the Gauss points
  const int a = ty;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T acc = 0;
#pragma unroll
    for (int ip = 0; ip < kNodes; ++ip) acc += buf[ip][d][a][tx];
    out[(long long)(d * 8 + a) * ne + e] = acc;
  }
}

template <typename T>
int launch(const void* ec, const void* lam, const void* mu, void* out,
           long long ne, void* stream) {
  const dim3 block(kElems, kNodes);
  const unsigned grid = (unsigned)((ne + kElems - 1) / kElems);
  hex8_stiffness_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)ec, (const T*)lam, (const T*)mu, (T*)out, ne);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_coord_grad(const void* ec, const void* lam, const void* mu,
                      const void* grad, void* out, long long ne,
                      void* stream) {
  const dim3 block(kElems, kNodes);
  const unsigned grid = (unsigned)((ne + kElems - 1) / kElems);
  hex8_stiffness_coord_grad_kernel<T>
      <<<grid, block, 0, (cudaStream_t)stream>>>(
          (const T*)ec, (const T*)lam, (const T*)mu, (const T*)grad, (T*)out,
          ne);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hex8_stiffness_f64(const void* ec, const void* lam,
                                  const void* mu, void* out, long long ne,
                                  void* stream) {
  return launch<double>(ec, lam, mu, out, ne, stream);
}

extern "C" int hex8_stiffness_f32(const void* ec, const void* lam,
                                  const void* mu, void* out, long long ne,
                                  void* stream) {
  return launch<float>(ec, lam, mu, out, ne, stream);
}

extern "C" int hex8_stiffness_coord_grad_f64(const void* ec, const void* lam,
                                             const void* mu, const void* grad,
                                             void* out, long long ne,
                                             void* stream) {
  return launch_coord_grad<double>(ec, lam, mu, grad, out, ne, stream);
}

extern "C" int hex8_stiffness_coord_grad_f32(const void* ec, const void* lam,
                                             const void* mu, const void* grad,
                                             void* out, long long ne,
                                             void* stream) {
  return launch_coord_grad<float>(ec, lam, mu, grad, out, ne, stream);
}
