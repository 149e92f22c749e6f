// Gauss-Jordan inverse of one complex block of at most 64 x 64 by one thread
// block of 8 warps: the pivot step of the row inverses (row_inverse.cuh).
//
// What bounds it: 64 dependent pivot steps on one SM. The first version ran
// them as one scalar chain over the whole block, a block-wide barrier of 32
// warps, two shared-memory broadcasts and a reciprocal per step: 0.57 us a
// step, 36.8 us a launch for 2 MFLOP, and 63% of a factorization. This
// version is the same unpivoted blocked Gauss-Jordan that row_inverse.cuh
// runs at width 64, one level down, with the 8 steps of a sub-panel inside
// one warp and one block-wide barrier a sub-panel (8 in place of 64):
//
//   * P, identity-padded to 64 x 64 (the padding inverts to itself, so no
//     element needs a mask), stays in registers for the whole inverse: a
//     warp holds the 8 rows of one sub-panel, a lane a 4 x 4 tile of them.
//   * Elimination, sub-panel s, by its own warp alone: the 8 Gauss-Jordan
//     steps on the warp's 8 x 64 strip of rows, with column j, row j and the
//     pivot of each step broadcast by __shfl_sync: no barrier. Afterwards
//     the strip holds rs = Pinv R, and Pinv on the sub-panel's own columns.
//     The strip goes to shared memory, and so do the sub-panel's columns as
//     they were before the step, pivot rows zeroed (cz, stored transposed).
//   * Update, the other 7 warps, after the one barrier: P -= cz rs on every
//     4 x 4 tile, 8 multiply-adds deep, from two 16-byte loads of cz and two
//     of rs per depth step. The sub-panel's own columns start from 0 there,
//     which makes them -cz Pinv with no product of their own.
//   rs and cz are double-buffered, so the warp of sub-panel s + 1 goes from
//   its own update straight into its elimination while the others finish.
//
// At both levels the pivot row, pivot column and pivot are overwritten with
// directly computed values (p^-1 R, -C p^-1, p^-1), as the reference's
// _pivot_gj_ref does: the textbook single rank-1 update cancels
// catastrophically in FP32 on the Dirichlet rows (p ~ 1.6e6). The reciprocal
// of |p|^2, clamped at 1e-38, is __frcp_rn (correctly rounded) followed by
// two products.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W), kernel time of one 64 x 64
// block by torch.profiler, the scalar chain beside it at 40.8 us:
//   P in shared memory, 32 warps, sub-panels of 16, the 16 x 16 leaf by one
//   warp in registers, products and update from shared memory: 28.6 us; of 8:
//   24.5 us. Every phase was bound by the shared-memory pipe, which moves
//   128 B a cycle counted per lane (a broadcast costs what distinct
//   addresses cost), not by FP32 rate: a 2 x 2 register tile loads 8 B per
//   multiply-add;
//   the same with four fused multiply-adds per complex multiply-add in place
//   of six instructions, and two outputs a thread in the products: 24.7 /
//   21.0 us; with the next leaf run beside the update: no gain (the update
//   saturates the pipe, the leaf warp starves);
//   this design (4 x 4 tiles in registers, 4 B per multiply-add, one barrier
//   a sub-panel): 21.8 us; with the warps of consecutive sub-panels on one
//   scheduler, so that the next eliminating warp updates beside an idle one,
//   and fused multiply-adds in the strip: 19.9 us (10.1 us at 32 x 32).
//   Per sub-panel about 4400 cycles at 2 GHz: 1100 for the next warp's own
//   update, 300 to stage, 2700 for the 8 steps (333 a step: one warp's ~120
//   instructions and a dependent shuffle - reciprocal - multiply chain).
#pragma once

#include "cplx.cuh"

constexpr int kBk = 64;                   // Gauss-Jordan panel width
constexpr int kLeaf = 8;                  // sub-panel width: one warp's rows
constexpr int kPivWarps = kBk / kLeaf;    // the inverse's block: 8 warps,
constexpr int kPivotThreads = 32 * kPivWarps;
constexpr int kT = 4;                     // each thread a kT x kT tile of P

// A warp holds the kLeaf rows of one sub-panel, `sub`: lane (tr, tc) =
// (lane / 16, lane % 16) the tile from row kLeaf sub + 4 tr, column 4 tc.
// Sub-panels s and s + 1 go to warps that share a scheduler (w and w + 4), so
// that the warp that eliminates next runs its own update beside the warp that
// has just eliminated, which has none.
struct GjTile {
  int sub, tr, tc, r0, c0;
  __device__ GjTile() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    sub = 2 * (warp % 4) + warp / 4;
    tr = lane >> 4;
    tc = lane & 15;
    r0 = kLeaf * sub + kT * tr;
    c0 = kT * tc;
  }
};

// What the sub-panels exchange, two of each so that a sub-panel needs one
// barrier: rs, the eliminated pivot rows, and cz, the sub-panel's columns
// before the elimination with the pivot rows zeroed, stored transposed.
struct GjSmem {
  float2 rs[2][kLeaf][kBk];
  float2 czt[2][kLeaf][kBk];
};

// P <- the b x b block at src (leading dimension ld), identity-padded.
__device__ __forceinline__ void gj_load(float2 (&P)[kT][kT],
                                        const float2* __restrict__ src,
                                        int ld, int b) {
  const GjTile t;
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int c = 0; c < kT; ++c) {
      const int r = t.r0 + i, cc = t.c0 + c;
      P[i][c] = (r < b && cc < b) ? src[(long long)r * ld + cc]
                                  : make_float2(r == cc ? 1.f : 0.f, 0.f);
    }
}

__device__ __forceinline__ void gj_store(const float2 (&P)[kT][kT],
                                         float2* __restrict__ dst, int ld,
                                         int b) {
  const GjTile t;
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int c = 0; c < kT; ++c) {
      const int r = t.r0 + i, cc = t.c0 + c;
      if (r < b && cc < b) dst[(long long)r * ld + cc] = P[i][c];
    }
}

__device__ __forceinline__ float2 shfl2(float2 v, int lane) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, lane),
                     __shfl_sync(0xffffffffu, v.y, lane));
}

// Two complex values in one 16-byte shared-memory access.
__device__ __forceinline__ float4 pack(float2 a, float2 b) {
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 lo2(float4 v) { return make_float2(v.x, v.y); }
__device__ __forceinline__ float2 hi2(float4 v) { return make_float2(v.z, v.w); }
__device__ __forceinline__ float2 cneg(float2 a) { return make_float2(-a.x, -a.y); }

// One warp: the kLeaf Gauss-Jordan steps of sub-panel `sub` on the warp's own
// kLeaf x kBk strip of rows, in registers.
__device__ __forceinline__ void gj_strip(float2 (&P)[kT][kT], int sub,
                                         const GjTile& t) {
#pragma unroll
  for (int j = 0; j < kLeaf; ++j) {
    // pivot column: lanes tcj, register column jc; pivot row: lanes trj,
    // register row jr
    const int tcj = (kLeaf / kT) * sub + j / kT, jc = j % kT;
    const int trj = j / kT, jr = j % kT;
    float2 cj[kT], rv[kT];
#pragma unroll
    for (int i = 0; i < kT; ++i) cj[i] = shfl2(P[i][jc], 16 * t.tr + tcj);
#pragma unroll
    for (int c = 0; c < kT; ++c) rv[c] = shfl2(P[jr][c], 16 * trj + t.tc);
    const float2 piv = shfl2(P[jr][jc], 16 * trj + tcj);
    const float inv = __frcp_rn(fmaxf(piv.x * piv.x + piv.y * piv.y, 1e-38f));
    const float2 p = make_float2(piv.x * inv, -piv.y * inv);  // 1 / piv
    // A row <- row - s rv with s = its column-j entry / piv; row j <- p rv,
    // written as 0 + p rv so that one form serves every row; column j <- -s,
    // the pivot <- p: the multiplier itself on both.
    const bool pcol = t.tc == tcj;
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      const bool rowj = t.tr == trj && i == jr;
      const float2 s = cmul(cj[i], p);
      const float2 mult = rowj ? p : cneg(s);
#pragma unroll
      for (int c = 0; c < kT; ++c) {
        float2 u = rowj ? make_float2(0.f, 0.f) : P[i][c];
        cmac(u, mult, rv[c]);
        P[i][c] = (pcol && c == jc) ? mult : u;
      }
    }
  }
}

// P <- its inverse, for the leading b x b block of an identity-padded P.
__device__ __forceinline__ void gj_invert(float2 (&P)[kT][kT], GjSmem& s,
                                          int b) {
  const GjTile t;
  for (int lo = 0, sub = 0; lo < b; lo += kLeaf, ++sub) {
    float2 (*rs)[kBk] = s.rs[sub & 1];
    float2 (*cz)[kBk] = s.czt[sub & 1];
    const bool mine = t.sub == sub;         // my rows are the pivot rows
    const int pc = t.tc - (kLeaf / kT) * sub;
    const bool pcols = pc >= 0 && pc < kLeaf / kT;  // my columns are its columns
    if (pcols) {
#pragma unroll
      for (int c = 0; c < kT; ++c) {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        float4* dst = reinterpret_cast<float4*>(&cz[kT * pc + c][t.r0]);
        dst[0] = mine ? zero : pack(P[0][c], P[1][c]);
        dst[1] = mine ? zero : pack(P[2][c], P[3][c]);
        // off the pivot rows these columns end as 0 - cz Pinv
        if (!mine)
#pragma unroll
          for (int i = 0; i < kT; ++i) P[i][c] = make_float2(0.f, 0.f);
      }
    }
    if (mine) {
      gj_strip(P, sub, t);
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        float4* dst = reinterpret_cast<float4*>(&rs[kT * t.tr + i][t.c0]);
        dst[0] = pack(P[i][0], P[i][1]);
        dst[1] = pack(P[i][2], P[i][3]);
      }
    }
    __syncthreads();
    if (!mine) {
#pragma unroll
      for (int k = 0; k < kLeaf; ++k) {
        const float4* lp = reinterpret_cast<const float4*>(&cz[k][t.r0]);
        const float4* rp = reinterpret_cast<const float4*>(&rs[k][t.c0]);
        const float4 l01 = lp[0], l23 = lp[1], r01 = rp[0], r23 = rp[1];
        const float2 nl[kT] = {cneg(lo2(l01)), cneg(hi2(l01)), cneg(lo2(l23)),
                               cneg(hi2(l23))};
        const float2 r[kT] = {lo2(r01), hi2(r01), lo2(r23), hi2(r23)};
#pragma unroll
        for (int i = 0; i < kT; ++i)
#pragma unroll
          for (int c = 0; c < kT; ++c) cmac(P[i][c], nl[i], r[c]);
      }
    }
  }
}
