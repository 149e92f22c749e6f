// Block-Thomas solve sweeps over a multi-RHS batch, forward (H x = b) and
// adjoint (H^H x = b), through the factor G of csrc/factor.cu.
//
// Replaces the Pallas TPU kernels
//   waveforminversionust_tpu/ops/pallas_sweep.py::_fwd_kernel / _bwd_kernel
// (launched per pass by _pass, via banded_solve_pallas). On the TPU the row
// recurrence was the sequential grid axis with the running vector in VMEM
// scratch. Here the right-hand sides are independent, so each block owns
// kRhs of them and loops over all ny rows inside the block, its running
// vector in shared memory: one launch per pass (elimination, substitution).
//
//   forward solve        adjoint solve (H^H)
//   z_0 = b_0            w_0 = G_0^H b_0
//   z_i = b_i - L_i G_{i-1} z_{i-1}
//                        w_i = G_i^H (b_i - U_{i-1}^H w_{i-1})
//   x_e = G_e z_e        x_e = w_e
//   x_i = G_i (z_i - U_i x_{i+1})
//                        x_i = w_i - G_i^H L_{i+1}^H x_{i+1}
//
// Layout: G (ny, nx, nx), coeffs (9, ny, nx), b / z / x (batch, ny, nx), all
// complex64 read as float2, contiguous. Planes: D = (0, 1, 2), L = (3, 5, 6),
// U = (4, 7, 8) as (main, sub, sup) of tri(T): T[j,j-1] = sub[j],
// T[j,j+1] = sup[j].
//
// Bound: each pass streams all of G (ny * nx^2 * 8 B, 0.22 GB at 301^2)
// through every block. Blocks walk the rows in step, so the card reads G
// from device memory about once and the blocks share it through the 50 MB
// L2. kRhs sets the trade-off: each G element loaded serves kRhs
// right-hand sides (more reuse, less L2 traffic) but batch / kRhs blocks
// fill fewer SMs. With one block per SM the pass is bound by L2 latency,
// not bandwidth: a first version (kRhs = 4, 320 threads, one load in
// flight per thread) moved ~5.6 GB/s per SM, 130 us per row step at 301^2
// and 78 ms per 256-RHS forward solve. So the block has 1024 threads and
// every thread issues its loads of G before it multiplies (15.7 ms at
// kRhs = 4), and kRhs = 2 spreads the batch over 128 of the 132 SMs
// (10.3 ms; one row per warp with 8 chunks ahead instead of 2 x 4: 18.6):
//   G_i x:   a warp per kRows output rows, each lane loading kAhead 32-wide
//            chunks of each row (kRows * kAhead loads in flight), then a
//            shuffle reduction;
//   G_i^H x: a thread per output column (coalesced reads of G's row j
//            across the warp), the rows j split into as many slices as the
//            block has room for, kAheadH rows loaded ahead, the slices'
//            partial sums added in shared memory.
// Measured at 301^2: kAheadH 4 -> 8 took the adjoint solve from 14.4 to
// 11.9 ms; kAhead 4 -> 8 slowed the forward one (10.3 -> 11.5 ms: it
// spills at the 64-register cap of a 1024-thread block).

#include <cuda_runtime.h>

namespace {

constexpr int kRhs = 2;
constexpr int kThreads = 1024;
constexpr int kRows = 2;
constexpr int kAhead = 4;
constexpr int kAheadH = 8;  // rows of G loaded ahead in gemv_h

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// conj(a) * b
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// Threads per column slice of gemv_h (warp aligned) and the slice count.
__host__ __device__ inline int slice_width(int nx) {
  const int w = (nx + 31) / 32 * 32;
  return w < kThreads ? w : kThreads;
}
__host__ __device__ inline int num_slices(int nx) {
  return kThreads / slice_width(nx);
}

// dst[r][i] = sum_j G[i][j] src[r][j]; a warp per kRows output rows.
__device__ void gemv_n(const float2* __restrict__ g, const float2* src,
                       float2* dst, int nx) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int row0 = (threadIdx.x >> 5) * kRows; row0 < nx;
       row0 += nwarps * kRows) {
    float ar[kRows][kRhs], ai[kRows][kRhs];
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int r = 0; r < kRhs; ++r) ar[q][r] = ai[q][r] = 0.f;
    for (int j0 = lane; j0 < nx; j0 += 32 * kAhead) {
      float2 gv[kRows][kAhead];
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int j = j0 + 32 * u;
          gv[q][u] = (row0 + q < nx && j < nx)
                         ? __ldg(g + (long long)(row0 + q) * nx + j)
                         : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = j0 + 32 * u;
        if (j < nx) {
#pragma unroll
          for (int r = 0; r < kRhs; ++r) {
            const float2 v = src[r * nx + j];
#pragma unroll
            for (int q = 0; q < kRows; ++q) {
              ar[q][r] += gv[q][u].x * v.x - gv[q][u].y * v.y;
              ai[q][r] += gv[q][u].x * v.y + gv[q][u].y * v.x;
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int r = 0; r < kRhs; ++r)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          ar[q][r] += __shfl_xor_sync(0xffffffffu, ar[q][r], o);
          ai[q][r] += __shfl_xor_sync(0xffffffffu, ai[q][r], o);
        }
    // lane q * kRhs + r writes dst[r][row0 + q]
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int r = 0; r < kRhs; ++r)
        if (lane == q * kRhs + r && row0 + q < nx)
          dst[r * nx + row0 + q] = make_float2(ar[q][r], ai[q][r]);
  }
}

// dst[r][c] = sum_j conj(G[j][c]) src[r][j]; part holds num_slices(nx) *
// kRhs * nx partial sums. Starts and ends with the block synchronised.
__device__ void gemv_h(const float2* __restrict__ g, const float2* src,
                       float2* dst, float2* part, int nx) {
  const int width = slice_width(nx), nslices = num_slices(nx);
  const int s = threadIdx.x / width, c0 = threadIdx.x - s * width;
  const int chunk = (nx + nslices - 1) / nslices;
  const int j_lo = s * chunk, j_hi = min(nx, j_lo + chunk);
  if (s < nslices) {
    for (int col = c0; col < nx; col += width) {
      float ar[kRhs], ai[kRhs];
#pragma unroll
      for (int r = 0; r < kRhs; ++r) ar[r] = ai[r] = 0.f;
      for (int j0 = j_lo; j0 < j_hi; j0 += kAheadH) {
        float2 gv[kAheadH];
#pragma unroll
        for (int u = 0; u < kAheadH; ++u)
          gv[u] = (j0 + u < j_hi) ? __ldg(g + (long long)(j0 + u) * nx + col)
                                  : make_float2(0.f, 0.f);
#pragma unroll
        for (int u = 0; u < kAheadH; ++u) {
          if (j0 + u < j_hi) {
#pragma unroll
            for (int r = 0; r < kRhs; ++r) {
              const float2 v = src[r * nx + j0 + u];
              ar[r] += gv[u].x * v.x + gv[u].y * v.y;
              ai[r] += gv[u].x * v.y - gv[u].y * v.x;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRhs; ++r)
        part[(s * kRhs + r) * nx + col] = make_float2(ar[r], ai[r]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRhs * nx; e += blockDim.x) {
    float2 acc = part[e];
    for (int t = 1; t < nslices; ++t) acc = cadd(acc, part[t * kRhs * nx + e]);
    dst[e] = acc;
  }
  __syncthreads();
}

struct Planes {
  const float2* c;
  long long plane;  // ny * nx
  int nx;
  __device__ const float2* at(int k, int row) const {
    return c + k * plane + (long long)row * nx;
  }
};

// (T v)[j] = m[j] v[j] + s[j] v[j-1] + p[j] v[j+1]
__device__ __forceinline__ float2 tri(const float2* m, const float2* s,
                                      const float2* p, const float2* v,
                                      int j, int nx) {
  float2 t = cmul(__ldg(m + j), v[j]);
  if (j > 0) t = cadd(t, cmul(__ldg(s + j), v[j - 1]));
  if (j < nx - 1) t = cadd(t, cmul(__ldg(p + j), v[j + 1]));
  return t;
}

// (T^H v)[j] = conj(m[j]) v[j] + conj(s[j+1]) v[j+1] + conj(p[j-1]) v[j-1]
__device__ __forceinline__ float2 tri_h(const float2* m, const float2* s,
                                        const float2* p, const float2* v,
                                        int j, int nx) {
  float2 t = cmulc(__ldg(m + j), v[j]);
  if (j < nx - 1) t = cadd(t, cmulc(__ldg(s + j + 1), v[j + 1]));
  if (j > 0) t = cadd(t, cmulc(__ldg(p + j - 1), v[j - 1]));
  return t;
}

__device__ __forceinline__ long long vidx(int r, int row, int j, int ny,
                                          int nx) {
  return ((long long)r * ny + row) * nx + j;
}

// Shared memory of a pass: the running vector cv, a temporary tv (kRhs x nx
// each) and gemv_h's partial sums.
__host__ __device__ inline size_t smem_floats2(int nx) {
  return (size_t)(2 + num_slices(nx)) * kRhs * nx;
}

// Pass 1: forward elimination (z) or, for the adjoint, the w recurrence.
template <bool kAdjoint>
__global__ void __launch_bounds__(kThreads)
sweep_pass1(const float2* __restrict__ g, const float2* __restrict__ coeffs,
            const float2* __restrict__ b, float2* z, int batch, int ny,
            int nx) {
  extern __shared__ float2 smem[];
  float2* cv = smem;              // running vector, kRhs x nx
  float2* tv = smem + kRhs * nx;  // temporary, kRhs x nx
  float2* part = tv + kRhs * nx;  // gemv_h partial sums
  const int r0 = blockIdx.x * kRhs;
  const Planes P{coeffs, (long long)ny * nx, nx};
  const long long gstride = (long long)nx * nx;
  const int n = kRhs * nx;

  // Row 0.
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / nx, j = e - r * nx;
    const float2 v = (r0 + r < batch) ? b[vidx(r0 + r, 0, j, ny, nx)]
                                      : make_float2(0.f, 0.f);
    if (kAdjoint) tv[e] = v; else cv[e] = v;
  }
  __syncthreads();
  if (kAdjoint) gemv_h(g, tv, cv, part, nx);  // w_0 = G_0^H b_0
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / nx, j = e - r * nx;
    if (r0 + r < batch) z[vidx(r0 + r, 0, j, ny, nx)] = cv[e];
  }

  for (int i = 1; i < ny; ++i) {
    if (!kAdjoint) {
      // z_i = b_i - tri(L_i) (G_{i-1} z_{i-1})
      gemv_n(g + (i - 1) * gstride, cv, tv, nx);
      __syncthreads();
      const float2 *lm = P.at(3, i), *ls = P.at(5, i), *lp = P.at(6, i);
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int r = e / nx, j = e - r * nx;
        const float2 bv = (r0 + r < batch) ? b[vidx(r0 + r, i, j, ny, nx)]
                                           : make_float2(0.f, 0.f);
        const float2 v = csub(bv, tri(lm, ls, lp, tv + r * nx, j, nx));
        cv[e] = v;
        if (r0 + r < batch) z[vidx(r0 + r, i, j, ny, nx)] = v;
      }
      __syncthreads();
    } else {
      // w_i = G_i^H (b_i - tri(U_{i-1})^H w_{i-1})
      const float2 *um = P.at(4, i - 1), *us = P.at(7, i - 1),
                   *up = P.at(8, i - 1);
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int r = e / nx, j = e - r * nx;
        const float2 bv = (r0 + r < batch) ? b[vidx(r0 + r, i, j, ny, nx)]
                                           : make_float2(0.f, 0.f);
        tv[e] = csub(bv, tri_h(um, us, up, cv + r * nx, j, nx));
      }
      __syncthreads();
      gemv_h(g + i * gstride, tv, cv, part, nx);
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int r = e / nx, j = e - r * nx;
        if (r0 + r < batch) z[vidx(r0 + r, i, j, ny, nx)] = cv[e];
      }
    }
  }
}

// Pass 2: back substitution from row ny-1 down to row 0.
template <bool kAdjoint>
__global__ void __launch_bounds__(kThreads)
sweep_pass2(const float2* __restrict__ g, const float2* __restrict__ coeffs,
            const float2* __restrict__ z, float2* x, int batch, int ny,
            int nx) {
  extern __shared__ float2 smem[];
  float2* cv = smem;
  float2* tv = smem + kRhs * nx;
  float2* part = tv + kRhs * nx;
  const int r0 = blockIdx.x * kRhs;
  const Planes P{coeffs, (long long)ny * nx, nx};
  const long long gstride = (long long)nx * nx;
  const int n = kRhs * nx;
  const int e_row = ny - 1;

  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / nx, j = e - r * nx;
    const float2 v = (r0 + r < batch) ? z[vidx(r0 + r, e_row, j, ny, nx)]
                                      : make_float2(0.f, 0.f);
    if (kAdjoint) cv[e] = v; else tv[e] = v;
  }
  __syncthreads();
  if (!kAdjoint) {
    gemv_n(g + e_row * gstride, tv, cv, nx);  // x_e = G_e z_e
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / nx, j = e - r * nx;
    if (r0 + r < batch) x[vidx(r0 + r, e_row, j, ny, nx)] = cv[e];
  }
  __syncthreads();

  for (int i = ny - 2; i >= 0; --i) {
    if (!kAdjoint) {
      // x_i = G_i (z_i - tri(U_i) x_{i+1})
      const float2 *um = P.at(4, i), *us = P.at(7, i), *up = P.at(8, i);
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int r = e / nx, j = e - r * nx;
        const float2 zv = (r0 + r < batch) ? z[vidx(r0 + r, i, j, ny, nx)]
                                           : make_float2(0.f, 0.f);
        tv[e] = csub(zv, tri(um, us, up, cv + r * nx, j, nx));
      }
      __syncthreads();
      gemv_n(g + i * gstride, tv, cv, nx);
      __syncthreads();
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int r = e / nx, j = e - r * nx;
        if (r0 + r < batch) x[vidx(r0 + r, i, j, ny, nx)] = cv[e];
      }
    } else {
      // x_i = w_i - G_i^H (tri(L_{i+1})^H x_{i+1})
      const float2 *lm = P.at(3, i + 1), *ls = P.at(5, i + 1),
                   *lp = P.at(6, i + 1);
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int r = e / nx, j = e - r * nx;
        tv[e] = tri_h(lm, ls, lp, cv + r * nx, j, nx);
      }
      __syncthreads();
      gemv_h(g + i * gstride, tv, cv, part, nx);
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int r = e / nx, j = e - r * nx;
        const float2 zv = (r0 + r < batch) ? z[vidx(r0 + r, i, j, ny, nx)]
                                           : make_float2(0.f, 0.f);
        const float2 v = csub(zv, cv[e]);
        cv[e] = v;
        if (r0 + r < batch) x[vidx(r0 + r, i, j, ny, nx)] = v;
      }
    }
    __syncthreads();
  }
}

template <bool kAdjoint>
int launch(const float2* g, const float2* coeffs, const float2* b, float2* z,
           float2* x, int batch, int ny, int nx, int* launched,
           cudaStream_t stream) {
  const size_t smem = smem_floats2(nx) * sizeof(float2);
  const int blocks = (batch + kRhs - 1) / kRhs;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)sweep_pass1<kAdjoint>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute((const void*)sweep_pass2<kAdjoint>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sweep_pass1<kAdjoint><<<blocks, kThreads, smem, stream>>>(g, coeffs, b, z,
                                                            batch, ny, nx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  sweep_pass2<kAdjoint><<<blocks, kThreads, smem, stream>>>(g, coeffs, z, x,
                                                            batch, ny, nx);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

}  // namespace

// b, x: (batch, ny, nx); z: (batch, ny, nx) scratch for the pass-1 vectors.
// *launched is raised by the number of kernels launched (2).
extern "C" int sweep_solve(const void* g, const void* coeffs, const void* b,
                           void* z, void* x, int batch, int ny, int nx,
                           int adjoint, int* launched, void* stream) {
  if (adjoint)
    return launch<true>((const float2*)g, (const float2*)coeffs,
                        (const float2*)b, (float2*)z, (float2*)x, batch, ny,
                        nx, launched, (cudaStream_t)stream);
  return launch<false>((const float2*)g, (const float2*)coeffs,
                       (const float2*)b, (float2*)z, (float2*)x, batch, ny,
                       nx, launched, (cudaStream_t)stream);
}
