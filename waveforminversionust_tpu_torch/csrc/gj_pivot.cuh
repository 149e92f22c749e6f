// Scalar Gauss-Jordan inverse of one complex block of at most 64 x 64, held in
// the registers of one thread block: the chain shared by the pivot step of
// the row inverses (row_inverse.cuh) and the batched inverse (inv.cu).
//
// The block is identity-padded to 64 x 64 (padded rows and columns stay
// untouched by the elimination), so no element needs a mask. Thread
// (ty, tx) of kPivWarps warps keeps P[ty + kPivWarps a][tx + 32 c]
// (a < kPivRows, c < 2) in registers for all b steps; only pivot row and
// column j go through shared memory, double-buffered so that each step needs
// one barrier. Each step applies the general update P -= s rv to every
// element and then overwrites row j and column j with directly computed
// values (R p^-1, -C p^-1, p^-1), as the reference's _pivot_gj_ref does:
// the textbook single rank-1 update cancels catastrophically in FP32 on the
// Dirichlet rows (p ~ 1.6e6). The reciprocal of |p|^2, clamped at 1e-38, is
// __frcp_rn (correctly rounded) followed by two products.
//
// The b-step chain is bound by latency and instruction issue on one SM;
// measured per launch at 301^2 on an H100 (700 W): P in shared memory with
// (r, c) re-derived by integer division every step, 88 us; P in registers,
// 32 warps with 4 masked elements each, 55 us; 8 warps with 16 elements
// each, 118 us (too few warps to hide the chain's latency); this design
// with 16 warps and IEEE divisions, 44 us; with __frcp_rn, 16 warps 43 us,
// 32 warps 40 us.
#pragma once

#include "cplx.cuh"

constexpr int kBk = 64;        // Gauss-Jordan panel width
constexpr int kPivWarps = 32;  // the chain's block: 32 warps,
constexpr int kPivotThreads = 32 * kPivWarps;
constexpr int kPivRows = kBk / kPivWarps;  // each thread kPivRows x 2 elements

// P <- the b x b block at src (leading dimension ld), identity-padded.
__device__ __forceinline__ void gj_load(float2 (&P)[kPivRows][2],
                                        const float2* __restrict__ src,
                                        int ld, int b) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kPivRows; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = ty + kPivWarps * a, cc = tx + 32 * c;
      P[a][c] = (r < b && cc < b) ? src[(long long)r * ld + cc]
                                  : make_float2(r == cc ? 1.f : 0.f, 0.f);
    }
}

__device__ __forceinline__ void gj_store(const float2 (&P)[kPivRows][2],
                                         float2* __restrict__ dst, int ld,
                                         int b) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kPivRows; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = ty + kPivWarps * a, cc = tx + 32 * c;
      if (r < b && cc < b) dst[(long long)r * ld + cc] = P[a][c];
    }
}

// P <- P^-1 in b steps; rowj and colj are shared [2][kBk] buffers.
__device__ __forceinline__ void gj_chain(float2 (&P)[kPivRows][2],
                                         float2 (*rowj)[kBk],
                                         float2 (*colj)[kBk], int b) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int j = 0; j < b; ++j) {
    float2* rj = rowj[j & 1];
    float2* cj = colj[j & 1];
#pragma unroll
    for (int a = 0; a < kPivRows; ++a) {
      if (ty + kPivWarps * a == j) {  // warp-uniform: this warp holds row j
        rj[tx] = P[a][0];
        rj[tx + 32] = P[a][1];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (tx + 32 * c == j) cj[ty + kPivWarps * a] = P[a][c];
    }
    __syncthreads();
    const float2 piv = rj[j];
    const float inv = __frcp_rn(fmaxf(piv.x * piv.x + piv.y * piv.y, 1e-38f));
    const float2 p = make_float2(piv.x * inv, -piv.y * inv);  // 1 / piv
    const float2 rv[2] = {rj[tx], rj[tx + 32]};
#pragma unroll
    for (int a = 0; a < kPivRows; ++a) {
      const float2 s = cmul(cj[ty + kPivWarps * a], p);  // column j / piv
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float2 v = csub(P[a][c], cmul(s, rv[c]));
        P[a][c] = (tx + 32 * c == j) ? make_float2(-s.x, -s.y) : v;
      }
      if (ty + kPivWarps * a == j) {  // row j: p * rv, and p on the pivot
#pragma unroll
        for (int c = 0; c < 2; ++c)
          P[a][c] = (tx + 32 * c == j) ? p : cmul(p, rv[c]);
      }
    }
  }
}
