// Kernel K3: CSR sparse matrix-vector product,
//
//   out[i] = sum_{k = indptr[i] .. indptr[i+1]-1} data[k] * x[indices[k]]
//
// Replaces fem_tpu/ops/pallas_kernels.py:ell_matvec_pallas (kernel body
// _ell_kernel_factory), which never lowered on the TPU (Mosaic has no
// arbitrary-index gather); fem_tpu runs the same product as XLA's gather on a
// padded row-major ELL, solver/amg.py:_ell_matvec. Same result as
// fem_tpu_torch.ops.cuda_kernels.csr_matvec_plain.
//
// Layout: plain CSR without padding or permutation, built once at set-up
// (solver/amg.py:Csr): indptr int64 (n + 1), indices int32 and data (nnz).
//
// What bounds it on the H100: device memory. Every nonzero is read once
// (8 + 4 bytes in float64) for one FMA. data and indices are streamed with
// evict-first loads (__ldcs), so that x, gathered through the read-only path
// (__ldg), stays in L1 / L2 (at the AMG's sizes x is at most 4.2 MB).
//
// LANES threads share a row (a power of two <= 32, chosen by the table from
// its mean row length: a few for the prolongation's ~16 nonzeros per row, a
// warp for the ~81 of a 3D operator or the ~1,700 of a restriction row).
// The lanes of a row are neighbours in the warp and read neighbouring
// nonzeros; each takes k = lo + lane, lo + lane + LANES, ..., with the loads
// of four of them in flight at a time. The LANES partial sums are folded
// with __shfl_down_sync. The order of every sum is fixed by (row length,
// LANES), with no atomics, so repeated runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int LANES>
__global__ void __launch_bounds__(kThreads)
csr_matvec_kernel(const long long* __restrict__ indptr,
                  const int* __restrict__ indices, const T* __restrict__ data,
                  const T* __restrict__ x, T* __restrict__ out, long long n) {
  const long long row =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  T acc = 0;
  if (row < n) {
    const long long hi = __ldg(indptr + row + 1);
    for (long long k = __ldg(indptr + row) + lane; k < hi; k += 4 * LANES) {
      // up to four nonzeros of the lane, all loads issued before the sums
      int c[4];
      T a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = k + j * LANES < hi;
        c[j] = in ? __ldcs(indices + k + j * LANES) : -1;
        a[j] = in ? __ldcs(data + k + j * LANES) : T(0);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c[j] >= 0) acc += a[j] * __ldg(x + c[j]);
    }
  }
  // every lane of the warp takes part in the shuffles (no early return)
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, LANES);
  if (lane == 0 && row < n) out[row] = acc;
}

template <typename T, int LANES>
int launch_lanes(const void* indptr, const void* indices, const void* data,
                 const void* x, void* out, long long n, cudaStream_t stream) {
  const long long threads = n * LANES;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  csr_matvec_kernel<T, LANES><<<grid, kThreads, 0, stream>>>(
      (const long long*)indptr, (const int*)indices, (const T*)data,
      (const T*)x, (T*)out, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* indptr, const void* indices, const void* data,
           const void* x, void* out, long long n, int lanes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch_lanes<T, 1>(indptr, indices, data, x, out, n, s);
    case 2: return launch_lanes<T, 2>(indptr, indices, data, x, out, n, s);
    case 4: return launch_lanes<T, 4>(indptr, indices, data, x, out, n, s);
    case 8: return launch_lanes<T, 8>(indptr, indices, data, x, out, n, s);
    case 16: return launch_lanes<T, 16>(indptr, indices, data, x, out, n, s);
    case 32: return launch_lanes<T, 32>(indptr, indices, data, x, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int csr_matvec_f64(const void* indptr, const void* indices,
                              const void* data, const void* x, void* out,
                              long long n, int lanes, void* stream) {
  return launch<double>(indptr, indices, data, x, out, n, lanes, stream);
}

extern "C" int csr_matvec_f32(const void* indptr, const void* indices,
                              const void* data, const void* x, void* out,
                              long long n, int lanes, void* stream) {
  return launch<float>(indptr, indices, data, x, out, n, lanes, stream);
}
