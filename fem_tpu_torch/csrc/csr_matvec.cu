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
//
// K3's backward: in x it is K3 on the transposed table (formed once per
// table, solver/amg.py:Csr.transposed), in data csr_data_grad_kernel below.

#include <cuda_runtime.h>

#include <type_traits>

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

// The backward of K3 in data: out[k] = gy[i] * x[indices[k]] for
// indptr[i] <= k < indptr[i + 1], one product per nonzero and no sum (the
// backward in x is K3 itself on the transposed table). Rows are shared by
// LANES threads as in K3, each lane taking k = lo + lane, lo + lane + LANES,
// ..., so that a warp reads and writes neighbouring nonzeros, with the
// column loads and then the gathers of four of them in flight at a time.
// Same result as cuda_kernels.csr_data_grad_plain. What bounds it: device
// memory, each nonzero's column read and its product written (4 + 8 bytes
// in float64).
template <typename T, int LANES>
__global__ void __launch_bounds__(kThreads)
csr_data_grad_kernel(const long long* __restrict__ indptr,
                     const int* __restrict__ indices, const T* __restrict__ x,
                     const T* __restrict__ gy, T* __restrict__ out,
                     long long n) {
  const long long row =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / LANES;
  if (row >= n) return;
  const int lane = threadIdx.x % LANES;
  const T g = __ldg(gy + row);
  const long long hi = __ldg(indptr + row + 1);
  for (long long k = __ldg(indptr + row) + lane; k < hi; k += 4 * LANES) {
    int c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = k + j * LANES < hi ? __ldcs(indices + k + j * LANES) : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c[j] >= 0) out[k + j * LANES] = g * __ldg(x + c[j]);
  }
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

template <typename T, int LANES>
int launch_data_grad_lanes(const void* indptr, const void* indices,
                           const void* x, const void* gy, void* out,
                           long long n, cudaStream_t stream) {
  const long long threads = n * LANES;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  csr_data_grad_kernel<T, LANES><<<grid, kThreads, 0, stream>>>(
      (const long long*)indptr, (const int*)indices, (const T*)x,
      (const T*)gy, (T*)out, n);
  return (int)cudaGetLastError();
}

// K3 (DATA_GRAD false: a, b = data, x) or its backward in data (true:
// a, b = x, gy) with the LANES template argument picked from `lanes`
template <typename T, bool DATA_GRAD>
int launch(const void* indptr, const void* indices, const void* a,
           const void* b, void* out, long long n, int lanes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto lanes_c) {
    constexpr int L = decltype(lanes_c)::value;
    if constexpr (DATA_GRAD)
      return launch_data_grad_lanes<T, L>(indptr, indices, a, b, out, n, s);
    else
      return launch_lanes<T, L>(indptr, indices, a, b, out, n, s);
  };
  switch (lanes) {
    case 1: return go(std::integral_constant<int, 1>());
    case 2: return go(std::integral_constant<int, 2>());
    case 4: return go(std::integral_constant<int, 4>());
    case 8: return go(std::integral_constant<int, 8>());
    case 16: return go(std::integral_constant<int, 16>());
    case 32: return go(std::integral_constant<int, 32>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int csr_matvec_f64(const void* indptr, const void* indices,
                              const void* data, const void* x, void* out,
                              long long n, int lanes, void* stream) {
  return launch<double, false>(indptr, indices, data, x, out, n, lanes,
                               stream);
}

extern "C" int csr_matvec_f32(const void* indptr, const void* indices,
                              const void* data, const void* x, void* out,
                              long long n, int lanes, void* stream) {
  return launch<float, false>(indptr, indices, data, x, out, n, lanes,
                              stream);
}

extern "C" int csr_data_grad_f64(const void* indptr, const void* indices,
                                 const void* x, const void* gy, void* out,
                                 long long n, int lanes, void* stream) {
  return launch<double, true>(indptr, indices, x, gy, out, n, lanes, stream);
}

extern "C" int csr_data_grad_f32(const void* indptr, const void* indices,
                                 const void* x, const void* gy, void* out,
                                 long long n, int lanes, void* stream) {
  return launch<float, true>(indptr, indices, x, gy, out, n, lanes, stream);
}
