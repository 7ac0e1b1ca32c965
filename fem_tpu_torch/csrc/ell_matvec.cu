// Kernel K3: ELL sparse matrix-vector product,
//
//   out[i] = sum_{k=0..w-1} vals[k, i] * x[cols[k, i]]
//
// Replaces fem_tpu/ops/pallas_kernels.py:ell_matvec_pallas (kernel body
// _ell_kernel_factory), which never lowered on the TPU (Mosaic has no
// arbitrary-index gather); fem_tpu runs the same product as XLA's gather,
// solver/amg.py:_ell_matvec. Same result as
// fem_tpu_torch.ops.cuda_kernels.ell_matvec_plain.
//
// Layout: vals and cols are COLUMN-MAJOR, (w, n) with the row index fastest,
// built once at set-up (solver/amg.py:_to_ell). Padded slots hold val 0 and
// col 0, so x needs no bounds check.
//
// What bounds it on the H100: device memory. Every slot is read once (8 + 4
// bytes in float64) and does one FMA; the x gathers go through the read-only
// path (__ldg) and, at the AMG's sizes (x is at most 4.2 MB in float64),
// stay in the 50 MB L2. Neighbouring threads take neighbouring rows, so at
// each slot k a warp's vals/cols loads are contiguous.
//
// Row widths differ by level: a few tens (prolongation rows), ~81 (3D
// Galerkin operators), hundreds or more (restriction rows, on few rows). One
// thread per row would leave a restriction of a few thousand rows with a few
// thousand threads, each walking hundreds of slots. So LANES threads share
// a row (LANES a power of two <= 32, chosen from w by the wrapper): a warp
// covers R = 32 / LANES consecutive rows; lane t takes row t % R and slots
// k = t / R, t / R + LANES, ...; the LANES partial sums of a row are folded
// with __shfl_down_sync. The order of every sum is fixed by (w, LANES), with
// no atomics, so repeated runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int LANES>
__global__ void __launch_bounds__(kThreads)
ell_matvec_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                  const T* __restrict__ x, T* __restrict__ out, long long n,
                  int w) {
  constexpr int R = 32 / LANES;  // rows per warp
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = warp * R + lane % R;
  const int first = lane / R;
  T acc = 0;
  if (i < n) {
    for (int k = first; k < w; k += LANES) {
      const long long p = (long long)k * n + i;
      acc += vals[p] * __ldg(x + cols[p]);
    }
  }
  // every lane of the warp takes part in the shuffles (no early return)
#pragma unroll
  for (int off = 16; off >= R; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (first == 0 && i < n) out[i] = acc;
}

template <typename T, int LANES>
int launch_lanes(const void* vals, const void* cols, const void* x, void* out,
                 long long n, int w, cudaStream_t stream) {
  constexpr int R = 32 / LANES;
  const long long threads = (n + R - 1) / R * 32;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  ell_matvec_kernel<T, LANES><<<grid, kThreads, 0, stream>>>(
      (const T*)vals, (const int*)cols, (const T*)x, (T*)out, n, w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* vals, const void* cols, const void* x, void* out,
           long long n, int w, int lanes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 1: return launch_lanes<T, 1>(vals, cols, x, out, n, w, s);
    case 2: return launch_lanes<T, 2>(vals, cols, x, out, n, w, s);
    case 4: return launch_lanes<T, 4>(vals, cols, x, out, n, w, s);
    case 8: return launch_lanes<T, 8>(vals, cols, x, out, n, w, s);
    case 16: return launch_lanes<T, 16>(vals, cols, x, out, n, w, s);
    case 32: return launch_lanes<T, 32>(vals, cols, x, out, n, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ell_matvec_f64(const void* vals, const void* cols,
                              const void* x, void* out, long long n, int w,
                              int lanes, void* stream) {
  return launch<double>(vals, cols, x, out, n, w, lanes, stream);
}

extern "C" int ell_matvec_f32(const void* vals, const void* cols,
                              const void* x, void* out, long long n, int w,
                              int lanes, void* stream) {
  return launch<float>(vals, cols, x, out, n, w, lanes, stream);
}
