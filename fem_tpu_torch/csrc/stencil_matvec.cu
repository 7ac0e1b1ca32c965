// Kernel K2: matrix-free K.u on a uniform hex8 node grid, scalar material, as
// the collapsed 27-point stencil.
//
// Replaces fem_tpu/ops/pallas_kernels.py:stencil_matvec_pallas (kernel body
// _stencil_kernel_factory); the collapsed form is fem_tpu's
// ops/structured.py:matvec_planes27. Same result as
// fem_tpu_torch.ops.cuda_kernels.stencil27_plain, and to rounding as
// stencil_matvec_plain (the per-corner masked form of _planes_core):
//
//   out_p[n] = sum_{o, q} C[class(n), o, p, q] u_q[n + o]
//
// with o the 27 node offsets in {-1, 0, 1}^3 (o = 9 (ox+1) + 3 (oy+1) +
// (oz+1)) and class(n) = 9 cx + 3 cy + cz, where on each axis c = 0 at the
// first node, 2 at the last and 1 between. The tables C (27 x 27 x 3 x 3,
// cuda_kernels.stencil_tables, built once per operator) sum k_ref over the
// corners whose cell exists at a node of that class; C[13] is the interior
// stencil, fem_tpu's csum. u and out are (nx, ny, nz, 3) node-interleaved,
// z fastest.
//
// What bounds it on the H100: both rooflines meet. In float64 at 81^3 nodes
// the interior form's 243 FMAs per node take 7.6 us at 34 TFLOP/s and u and
// out (25.5 MB) take 7.6 us at 3.35 TB/s.
//
// Design: one launch, two kinds of block.
//  - Interior tiles cover the nodes 1 .. n-2 of every axis in tiles of
//    TX x TY x TZ. A block stages its tile of u with a one-node halo,
//    (TX+2)(TY+2)(TZ+2) nodes x 3, in shared memory, copying runs along z
//    (coalesced) with cp.async: the copies of a thread are all in flight
//    at once. Each thread owns one (y, z) and marches the TX nodes along
//    x: a staged value is read once per plane and feeds up to three outputs,
//    so a thread's TX nodes cost (TX + 2) x 27 shared loads for their
//    TX x 243 FMAs. The interior coefficients C[13] are a kernel argument
//    passed by value: every FMA takes its coefficient from the constant
//    bank through the uniform registers, with no per-thread load.
//  - Face blocks, launched first: one thread per boundary node (both x
//    faces, then the y faces and the z faces without the nodes already
//    counted) reads its 27 neighbours through L1 and its class's row of C
//    through the read-only path. At 81^3 they are 38,402 of 531,441 nodes.
// An axis of one node has no cell; its tables are 0 and so is K.u. Every sum
// is taken in a fixed order.
//
// The 2D branch (stencil9_kernel, entry points stencil_matvec2d_*): K.u on a
// uniform quad4 node grid, the collapsed 9-point stencil with 2 DOFs a node,
//
//   out_p[n] = sum_{o, q} C[class(n), o, p, q] u_q[n + o],
//
// o the 9 offsets in {-1, 0, 1}^2 (o = 3 (o0+1) + (o1+1)), class(n) = 3 c0 +
// c1 with c as above, C of shape (9, 9, 2, 2) and C[4] the interior stencil
// (36 values, passed by value as the 3D kernel passes its 243). The grid is
// (n0, n1) = (ny, nx), y-major as meshgen and the reference's make_example
// number the nodes; u and out are (n0, n1, 2), x fastest. The Pallas K2 is
// 3D only (fem_tpu computes 2D K.u in XLA: structured.matvec_planes27), so
// this branch is K2's function in the dimension the TPU kernel never
// covered. Same result as cuda_kernels.stencil9_plain, and to rounding as
// stencil_matvec_plain.
//
// What bounds it on the H100: bytes. In float64 on the 2049 x 1025 node grid
// u and out are 2 x 33.6 MB, 0.0201 ms at 3.35 TB/s; the 36 FMAs per node
// take 0.0044 ms at 34 TFLOP/s.
//
// Design: one thread per node, consecutive threads on consecutive nodes of a
// row, so each of the 9 neighbour loads of a warp is one contiguous run of
// 32 nodes; the three rows a block reads overlap the next blocks' and are
// served by L1 and L2, so device memory sees u about once. Interior nodes
// take their coefficients from the by-value argument (the constant bank),
// boundary nodes their class's row of C through the read-only path, with the
// loads of a neighbour outside the grid clamped into it and its values
// replaced by 0. Every node's sum runs over o, then q, in one fixed order:
// no atomics, the same bits on every run. Shared-memory tiling and cp.async
// are later work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int TX = 4, TY = 8, TZ = 16;
constexpr int kThreads = TY * TZ;
constexpr int SX = TX + 2, SY = TY + 2, SZ = TZ + 2;
constexpr int kStaged = SX * SY * SZ * 3;

template <typename T>
struct Interior {
  T c[27 * 9];  // C[13][o][p][q]
};

__device__ __forceinline__ int axis_class(int i, int n) {
  return i == 0 ? 0 : (i == n - 1 ? 2 : 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
stencil27_kernel(const Interior<T> ci, const T* __restrict__ coef,
                 const T* __restrict__ u, T* __restrict__ out, int nx,
                 int ny, int nz, int tiles_y, int tiles_z,
                 long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the face blocks come first, so that they run beside the tiles
  const long long face_blocks = gridDim.x - n_tiles;
  if ((long long)blockIdx.x >= face_blocks) {
    // ---- an interior tile ----
    T* s = reinterpret_cast<T*>(smem);  // [SX][SY][SZ * 3]
    const long long tile = blockIdx.x - face_blocks;
    const int z0 = 1 + (int)(tile % tiles_z) * TZ;
    const int y0 = 1 + (int)(tile / tiles_z % tiles_y) * TY;
    const int x0 = 1 + (int)(tile / tiles_z / tiles_y) * TX;
    // stage u[x0-1 .. x0+TX, y0-1 .. y0+TY, z0-1 .. z0+TZ, :], zeros outside
    // the grid: a warp copies one line of SZ nodes (SZ * 3 contiguous
    // values) at a time with cp.async, which issues every copy of the
    // thread before any arrives and passes nothing through registers
    for (int line = threadIdx.x / 32; line < SX * SY; line += kThreads / 32) {
      const int gx = x0 - 1 + line / SY, gy = y0 - 1 + line % SY;
      const bool row_in = gx < nx && gy < ny;
      const T* src = u + (((long long)gx * ny + gy) * nz + z0 - 1) * 3;
      T* dst = s + line * (SZ * 3);
      for (int r = threadIdx.x % 32; r < SZ * 3; r += 32) {
        const bool in = row_in && z0 - 1 + r / 3 < nz;
        __pipeline_memcpy_async(dst + r, in ? src + r : u, sizeof(T),
                                in ? 0 : sizeof(T));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    const int ty = threadIdx.x / TZ, tz = threadIdx.x % TZ;
    const int gy = y0 + ty, gz = z0 + tz;
    const bool owner = gy <= ny - 2 && gz <= nz - 2;
    // output i is complete after plane i + 2 and is stored then, so at most
    // three outputs' sums are live
    T acc[TX][3];
#pragma unroll
    for (int i = 0; i < TX; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0;
#pragma unroll
    for (int j = 0; j < SX; ++j) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const T* sp = s + (j * SY + ty + dy) * (SZ * 3) + (tz + dz) * 3;
          const T v0 = sp[0], v1 = sp[1], v2 = sp[2];
#pragma unroll
          for (int ox = -1; ox <= 1; ++ox) {
            const int i = j - 1 - ox;  // the output plane this offset feeds
            if (i < 0 || i >= TX) continue;
            const int o = (9 * (ox + 1) + 3 * dy + dz) * 9;
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              acc[i][p] += ci.c[o + 3 * p] * v0;
              acc[i][p] += ci.c[o + 3 * p + 1] * v1;
              acc[i][p] += ci.c[o + 3 * p + 2] * v2;
            }
          }
        }
      }
      const int i = j - 2;
      if (i >= 0 && owner && x0 + i <= nx - 2) {
        T* op = out + (((long long)(x0 + i) * ny + gy) * nz + gz) * 3;
        op[0] = acc[i][0];
        op[1] = acc[i][1];
        op[2] = acc[i][2];
      }
    }
    return;
  }
  // ---- a face node ----
  long long f = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int sy = ny == 1 ? 1 : 2, sz = nz == 1 ? 1 : 2;
  const long long yz = (long long)ny * nz;
  const long long fx = (nx == 1 ? 1 : 2) * yz;
  const long long fy = (long long)(nx > 2 ? nx - 2 : 0) * sy * nz;
  const long long fz =
      (long long)(nx > 2 ? nx - 2 : 0) * (ny > 2 ? ny - 2 : 0) * sz;
  int ix, iy, iz;
  if (f < fx) {
    ix = f < yz ? 0 : nx - 1;
    iy = (int)(f % yz / nz);
    iz = (int)(f % nz);
  } else if ((f -= fx) < fy) {
    const long long per = (long long)sy * nz;
    ix = 1 + (int)(f / per);
    iy = f % per < nz ? 0 : ny - 1;
    iz = (int)(f % nz);
  } else if ((f -= fy) < fz) {
    const long long per = (long long)(ny - 2) * sz;
    ix = 1 + (int)(f / per);
    iy = 1 + (int)(f % per / sz);
    iz = f % sz ? nz - 1 : 0;
  } else {
    return;
  }
  const T* cc = coef + (9 * axis_class(ix, nx) + 3 * axis_class(iy, ny)
                        + axis_class(iz, nz)) * 243;
  T a0 = 0, a1 = 0, a2 = 0;
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    // a neighbour outside the grid has coefficients 0; its load is clamped
    // into the grid and its values replaced by 0, without a branch, so that
    // the loads of all 27 neighbours can be in flight together
    const int jx = ix + o / 9 - 1, jy = iy + o / 3 % 3 - 1,
              jz = iz + o % 3 - 1;
    const bool in = jx >= 0 && jx < nx && jy >= 0 && jy < ny && jz >= 0 &&
                    jz < nz;
    const T* up = u + (((long long)min(max(jx, 0), nx - 1) * ny +
                        min(max(jy, 0), ny - 1)) * nz +
                       min(max(jz, 0), nz - 1)) * 3;
    const T v0 = in ? __ldg(up) : T(0), v1 = in ? __ldg(up + 1) : T(0),
            v2 = in ? __ldg(up + 2) : T(0);
    const T* k = cc + o * 9;
    a0 += __ldg(k) * v0;
    a0 += __ldg(k + 1) * v1;
    a0 += __ldg(k + 2) * v2;
    a1 += __ldg(k + 3) * v0;
    a1 += __ldg(k + 4) * v1;
    a1 += __ldg(k + 5) * v2;
    a2 += __ldg(k + 6) * v0;
    a2 += __ldg(k + 7) * v1;
    a2 += __ldg(k + 8) * v2;
  }
  T* op = out + (((long long)ix * ny + iy) * nz + iz) * 3;
  op[0] = a0;
  op[1] = a1;
  op[2] = a2;
}

int tiles(int n, int t) { return n > 2 ? (n - 2 + t - 1) / t : 0; }

template <typename T>
int launch(const void* interior, const void* coef, const void* u, void* out,
           int nx, int ny, int nz, void* stream) {
  Interior<T> ci;
  std::memcpy(ci.c, interior, sizeof(ci.c));
  const int tiles_y = tiles(ny, TY), tiles_z = tiles(nz, TZ);
  const long long n_tiles = (long long)tiles(nx, TX) * tiles_y * tiles_z;
  // boundary nodes: as counted by the face blocks
  const long long yz = (long long)ny * nz;
  const long long faces =
      (nx == 1 ? 1 : 2) * yz +
      (long long)(nx > 2 ? nx - 2 : 0) * (ny == 1 ? 1 : 2) * nz +
      (long long)(nx > 2 ? nx - 2 : 0) * (ny > 2 ? ny - 2 : 0) *
          (nz == 1 ? 1 : 2);
  const long long blocks = n_tiles + (faces + kThreads - 1) / kThreads;
  stencil27_kernel<T><<<(unsigned)blocks, kThreads, kStaged * sizeof(T),
                        (cudaStream_t)stream>>>(
      ci, (const T*)coef, (const T*)u, (T*)out, nx, ny, nz, tiles_y, tiles_z,
      n_tiles);
  return (int)cudaGetLastError();
}

constexpr int kThreads2D = 256;

template <typename T>
struct Interior2D {
  T c[9 * 4];  // C[4][o][p][q]
};

template <typename T>
__global__ void __launch_bounds__(kThreads2D)
stencil9_kernel(const Interior2D<T> ci, const T* __restrict__ coef,
                const T* __restrict__ u, T* __restrict__ out, int n0,
                int n1) {
  const long long n = (long long)blockIdx.x * kThreads2D + threadIdx.x;
  if (n >= (long long)n0 * n1) return;
  const int i0 = (int)(n / n1), i1 = (int)(n % n1);
  T a0 = 0, a1 = 0;
  if (i0 >= 1 && i0 <= n0 - 2 && i1 >= 1 && i1 <= n1 - 2) {
#pragma unroll
    for (int o = 0; o < 9; ++o) {
      const T* up = u + (n + (long long)(o / 3 - 1) * n1 + (o % 3 - 1)) * 2;
      const T v0 = __ldg(up), v1 = __ldg(up + 1);
      a0 += ci.c[o * 4] * v0;
      a0 += ci.c[o * 4 + 1] * v1;
      a1 += ci.c[o * 4 + 2] * v0;
      a1 += ci.c[o * 4 + 3] * v1;
    }
  } else {
    const T* cc = coef + (3 * axis_class(i0, n0) + axis_class(i1, n1)) * 36;
#pragma unroll
    for (int o = 0; o < 9; ++o) {
      const int j0 = i0 + o / 3 - 1, j1 = i1 + o % 3 - 1;
      const bool in = j0 >= 0 && j0 < n0 && j1 >= 0 && j1 < n1;
      const T* up = u + ((long long)min(max(j0, 0), n0 - 1) * n1 +
                         min(max(j1, 0), n1 - 1)) * 2;
      const T v0 = in ? __ldg(up) : T(0), v1 = in ? __ldg(up + 1) : T(0);
      const T* k = cc + o * 4;
      a0 += __ldg(k) * v0;
      a0 += __ldg(k + 1) * v1;
      a1 += __ldg(k + 2) * v0;
      a1 += __ldg(k + 3) * v1;
    }
  }
  out[2 * n] = a0;
  out[2 * n + 1] = a1;
}

template <typename T>
int launch2d(const void* interior, const void* coef, const void* u,
             void* out, int n0, int n1, void* stream) {
  Interior2D<T> ci;
  std::memcpy(ci.c, interior, sizeof(ci.c));
  const long long blocks =
      ((long long)n0 * n1 + kThreads2D - 1) / kThreads2D;
  stencil9_kernel<T><<<(unsigned)blocks, kThreads2D, 0,
                       (cudaStream_t)stream>>>(ci, (const T*)coef,
                                               (const T*)u, (T*)out, n0, n1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stencil_matvec2d_f64(const void* interior, const void* coef,
                                    const void* u, void* out, int n0, int n1,
                                    void* stream) {
  return launch2d<double>(interior, coef, u, out, n0, n1, stream);
}

extern "C" int stencil_matvec2d_f32(const void* interior, const void* coef,
                                    const void* u, void* out, int n0, int n1,
                                    void* stream) {
  return launch2d<float>(interior, coef, u, out, n0, n1, stream);
}

extern "C" int stencil_matvec_f64(const void* interior, const void* coef,
                                  const void* u, void* out, int nx, int ny,
                                  int nz, void* stream) {
  return launch<double>(interior, coef, u, out, nx, ny, nz, stream);
}

extern "C" int stencil_matvec_f32(const void* interior, const void* coef,
                                  const void* u, void* out, int nx, int ny,
                                  int nz, void* stream) {
  return launch<float>(interior, coef, u, out, nx, ny, nz, stream);
}
