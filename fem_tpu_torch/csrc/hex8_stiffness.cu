// Kernel K1: batched hex8 element stiffness for an isotropic Lame material.
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

template <typename T>
int launch(const void* ec, const void* lam, const void* mu, void* out,
           long long ne, void* stream) {
  const dim3 block(kElems, kNodes);
  const unsigned grid = (unsigned)((ne + kElems - 1) / kElems);
  hex8_stiffness_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)ec, (const T*)lam, (const T*)mu, (T*)out, ne);
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
