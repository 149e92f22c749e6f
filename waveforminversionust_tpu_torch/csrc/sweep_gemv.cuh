// The gemvs and tridiagonal products of the solve sweeps, shared by the
// block-Thomas sweeps (sweep.cu) and the twisted ones (twisted.cu). A block
// of kThreads threads owns kRhs right-hand sides, its vectors (kRhs x nx) in
// shared memory, and streams the inverses G through L2:
//   G x:   a warp per kRows output rows, each lane loading kAhead 32-wide
//          chunks of each row (kRows * kAhead loads in flight), then a
//          shuffle reduction;
//   G^H x: a thread per output column (coalesced reads of G's row j across
//          the warp), the rows j split into as many slices as the block has
//          room for, kAheadH rows loaded ahead, the slices' partial sums
//          added in shared memory.
// Layout: G (ny, nx, nx), coeffs (9, ny, nx), vectors (batch, ny, nx), all
// complex64 read as float2, contiguous. Planes: D = (0, 1, 2), L = (3, 5, 6),
// U = (4, 7, 8) as (main, sub, sup) of tri(T): T[j,j-1] = sub[j],
// T[j,j+1] = sup[j].
#pragma once

#include "cplx.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRows = 2;
constexpr int kAhead = 4;
constexpr int kAheadH = 8;  // rows of G loaded ahead in gemv_h

// Threads per column slice of gemv_h (warp aligned) and the slice count.
__host__ __device__ inline int slice_width(int nx) {
  const int w = (nx + 31) / 32 * 32;
  return w < kThreads ? w : kThreads;
}
__host__ __device__ inline int num_slices(int nx) {
  return kThreads / slice_width(nx);
}

// dst[r][i] = sum_j G[i][j] src[r][j] for kRhs right-hand sides; a warp per
// kRows output rows.
template <int kRhs>
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
template <int kRhs>
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

// Shared memory of a pass: ``vectors`` buffers of kRhs x nx (the running
// vector, temporaries) and gemv_h's partial sums.
__host__ __device__ inline size_t smem_floats2(int nx, int rhs, int vectors) {
  return (size_t)(vectors + num_slices(nx)) * rhs * nx;
}

}  // namespace
