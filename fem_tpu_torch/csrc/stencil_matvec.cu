// Kernel K2: matrix-free K.u on a uniform hex8 node grid, scalar material.
//
// Replaces fem_tpu/ops/pallas_kernels.py:stencil_matvec_pallas (kernel body
// _stencil_kernel_factory). Same result as
// fem_tpu_torch.ops.cuda_kernels.stencil_matvec_plain, which keeps the
// semantics of fem_tpu/ops/structured.py:_planes_core:
//
//   out_p[n] = sum_a M_a[n] sum_{b,q} k[(a*3+p)*24 + b*3+q] u_q[n - off_a + off_b]
//
// with a, b the 8 hex corners (offsets in fem_tpu's _HEX_OFFSETS order) and
// M_a[n] = 1 when the cell at n - off_a exists (0 <= c <= n_axis - 2 on
// every axis). u and out are (nx, ny, nz, 3) node-interleaved, z fastest.
//
// What bounds it on the H100: not device memory. In float64 at 81^3 nodes,
// u and out are 25 MB, 8 us of traffic at 3.35 TB/s, while each node does
// 576 FMAs and 192 loads of its 27 neighbours' values. The loads hit L1
// (neighbouring threads share neighbours), so the kernel is bound by load
// and FMA instruction issue. The design keeps that count at the masked
// per-corner form's 576 FMAs and reads k_ref from shared memory, where every
// thread of a warp reads the same entry (a broadcast).
//
// Design: one thread per node computes all three components. The 576 k_ref
// values are staged in shared memory per block. Boundaries are handled by
// the cell-existence test per corner, computed from the node index, so no
// padding of u is needed and any grid shape works (the Pallas kernel padded
// y and z to the TPU's (8, 128) tiling). Threads are numbered z fastest, so
// a warp reads and writes contiguous runs of u and out.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// fem_tpu/ops/structured.py:_HEX_OFFSETS: corner a -> (x, y, z) offset
__device__ __forceinline__ int off_x(int a) { return ((a + 1) >> 1) & 1; }
__device__ __forceinline__ int off_y(int a) { return (a >> 1) & 1; }
__device__ __forceinline__ int off_z(int a) { return (a >> 2) & 1; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_matvec_kernel(const T* __restrict__ k, const T* __restrict__ u,
                      T* __restrict__ out, int nx, int ny, int nz) {
  __shared__ T sk[576];
  for (int i = threadIdx.x; i < 576; i += blockDim.x) sk[i] = k[i];
  __syncthreads();

  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= (long long)nx * ny * nz) return;
  const int iz = (int)(n % nz);
  const long long t = n / nz;
  const int iy = (int)(t % ny);
  const int ix = (int)(t / ny);

  T acc0 = 0, acc1 = 0, acc2 = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int cx = ix - off_x(a), cy = iy - off_y(a), cz = iz - off_z(a);
    if (cx < 0 || cx > nx - 2 || cy < 0 || cy > ny - 2 || cz < 0 ||
        cz > nz - 2)
      continue;  // no cell at n - off_a: corner a contributes nothing
    T p0 = 0, p1 = 0, p2 = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const long long m =
          ((long long)(cx + off_x(b)) * ny + (cy + off_y(b))) * nz +
          (cz + off_z(b));
      const T u0 = __ldg(u + 3 * m), u1 = __ldg(u + 3 * m + 1),
              u2 = __ldg(u + 3 * m + 2);
      const T* kr = sk + (a * 3) * 24 + b * 3;  // row (a, p=0), column (b, q)
      p0 += kr[0] * u0 + kr[1] * u1 + kr[2] * u2;
      p1 += kr[24] * u0 + kr[25] * u1 + kr[26] * u2;
      p2 += kr[48] * u0 + kr[49] * u1 + kr[50] * u2;
    }
    acc0 += p0;
    acc1 += p1;
    acc2 += p2;
  }
  out[3 * n] = acc0;
  out[3 * n + 1] = acc1;
  out[3 * n + 2] = acc2;
}

template <typename T>
int launch(const void* k, const void* u, void* out, int nx, int ny, int nz,
           void* stream) {
  const long long nodes = (long long)nx * ny * nz;
  const unsigned grid = (unsigned)((nodes + kThreads - 1) / kThreads);
  stencil_matvec_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)k, (const T*)u, (T*)out, nx, ny, nz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stencil_matvec_f64(const void* k, const void* u, void* out,
                                  int nx, int ny, int nz, void* stream) {
  return launch<double>(k, u, out, nx, ny, nz, stream);
}

extern "C" int stencil_matvec_f32(const void* k, const void* u, void* out,
                                  int nx, int ny, int nz, void* stream) {
  return launch<float>(k, u, out, nx, ny, nz, stream);
}
