// Batched inverse of small complex blocks, (B, b, b) with b <= 64, by
// unpivoted in-place Gauss-Jordan: the pivot blocks of the blocked batched
// inverse that the cyclic-reduction factorization runs on every level.
//
// Replaces the Pallas TPU kernel
//   waveforminversionust_tpu/ops/pallas_inv.py::batched_small_inv_pallas
//   (_gj_kernel),
// which carried the batch in the 128 lanes (padded with identities, b a
// multiple of 8) so that every rank-1 update was a full-width vector op.
// That layout is not carried over.
//
// The kernel keeps the chain's per-element arithmetic, bit for bit; the
// layout is free. Each of the b steps applies the general update
// P -= s rv, s = C / p, to every element and then overwrites row j and column
// j with directly computed values (R p^-1, -C p^-1, p^-1; the reciprocal of
// |p|^2, clamped at 1e-38, by __frcp_rn), because the single rank-1 form
// cancels in FP32 on the Dirichlet rows. The roundings are those nvcc chose
// for the first version of this kernel (a block of 32 warps, 2 x 2 elements a
// thread, column and row j through shared memory, 37-41 us a 64 x 64 launch),
// pinned with __fmaf_rn / __fmul_rn, so the outputs are its bits. That
// matters: the unpivoted cyclic reduction amplifies the last bits of these
// inverses by up to 1e4 at 301^2, and the blocked inverse of gj_pivot.cuh,
// which rounds otherwise, moved that engine's residual after a refinement
// pass from 6.3e-4 to 2.6e-3 (NVIDIA H100 80GB HBM3, 700 W).
//
// The layout: one block of 8 warps a matrix, identity-padded to 64 x 64 so
// that no element needs a mask, in registers; each thread a 4 x 4 tile. A
// step reads column j (4 values), row j (4) and 1 / the pivot from shared
// memory, double-buffered by the parity of j; the threads holding column
// j + 1, row j + 1 and the next pivot write them after their update; one
// block barrier a step. A tile serves 16 elements with 4
// column values, 4 row values and 4 multipliers s, where the first version
// read 2 + 2 for 4 elements and had a thread per 4 elements: the shared-
// memory traffic of a step falls from 4 loads of 32 warps to 5 of 8 warps.
//
// Bound: neither bytes (each matrix is read and written once, 64 KB) nor the
// card's operations (8 b^3 FP32 flops a matrix), but one SM's time for a
// chain of b dependent steps. The pinned update is 6 FP32 instructions an
// element (a product, a fused multiply-add and a difference for each half),
// 4096 x 6 / 32 = 768 warp instructions a step; around it each step loads
// column j, row j and the pivot after a barrier, forms the multipliers,
// stores column and row j + 1 and the next reciprocal, and waits at the
// barrier, and that costs more than the update: chip_smoke.py prints about
// 1000 cycles a step, where the update alone takes about 170 on 8 warps,
// 190 with the barrier and 415 with the shared-memory reads
// (probes/k5_layouts.py times these parts). The row layout, warps owning
// rows with column j by __shfl_sync, gives the same bits and is no faster,
// with or without a lookahead row and per-row mbarriers: its shuffled
// column alone costs about 500 cycles a step (the same probe times it
// against this kernel). Splitting a matrix over a thread-block cluster
// would pay a cluster barrier a step, about as much as a whole step on one
// SM.
// With a batch above the 132 SMs two matrices share an SM.
// Any b <= 64 and any batch; the grid is the batch.
//
// blocked_small_inv below launches the blocked inverse of gj_pivot.cuh on
// the same kind of batch, for tests and timings of the factorizations' pivot
// step alone.

#include "gj_pivot.cuh"

namespace {

// The first version's roundings, which nvcc chose per expression there and
// which are pinned here so that the outputs are its bits. An element's
// update is P - s rv, each half a rounded product, a fused multiply-add and a
// difference:
__device__ __forceinline__ float2 gj_update(float2 P, float2 s, float2 rv) {
  const float tx = __fmaf_rn(s.x, rv.x, -__fmul_rn(s.y, rv.y));
  const float ty = __fmaf_rn(s.x, rv.y, __fmul_rn(s.y, rv.x));
  return make_float2(__fsub_rn(P.x, tx), __fsub_rn(P.y, ty));
}
// p rv, the pivot row's direct values.
__device__ __forceinline__ float2 gj_row(float2 p, float2 rv) {
  return make_float2(__fmaf_rn(p.x, rv.x, -__fmul_rn(p.y, rv.y)),
                     __fmaf_rn(p.x, rv.y, __fmul_rn(p.y, rv.x)));
}
// s = cj p, the column's multiplier. Its imaginary part fused the other
// product on rows 32 .. 63 of the first version (its second register row),
// so the rows of a warp (all on one side of row 32) say which.
__device__ __forceinline__ float2 gj_col(float2 cj, float2 p, bool low) {
  const float sx = __fmaf_rn(p.x, cj.x, -__fmul_rn(p.y, cj.y));
  const float sy = low ? __fmaf_rn(p.x, cj.y, __fmul_rn(cj.x, p.y))
                       : __fmaf_rn(p.y, cj.x, __fmul_rn(p.x, cj.y));
  return make_float2(sx, sy);
}
// 1 / piv: the reciprocal of |piv|^2, clamped at 1e-38, correctly rounded.
__device__ __forceinline__ float2 gj_pivot(float2 piv) {
  const float inv =
      __frcp_rn(fmaxf(__fmaf_rn(piv.x, piv.x, __fmul_rn(piv.y, piv.y)), 1e-38f));
  return make_float2(__fmul_rn(piv.x, inv), -__fmul_rn(piv.y, inv));
}

// Tiles of 4 x 4: lane l of warp w holds rows r0 = 4 (2 w + l / 16) .. r0 + 3
// and columns c0 = 4 (l % 16) .. c0 + 3; 8 warps a matrix.
constexpr int kTile = 4, kInvThreads = kBk * kBk / (kTile * kTile);

// What step j reads, written during step j - 1, by the parity of j.
struct GjBuf {
  float2 col[2][kBk];  // column j as it enters step j
  float2 row[2][kBk];  // row j
  float2 piv[2];       // 1 / its pivot
};

// Step j, j % 4 == KJ (so column j is element KJ of the threads that hold
// it, row j row KJ of theirs); LOW: the warp's rows lie in 0 .. 31.
template <int KJ, bool LOW>
__device__ __forceinline__ void gj_step(float2 (&P)[kTile][kTile], int j,
                                        int b, int r0, int c0, GjBuf& s) {
  const int in = j & 1;
  const float2 p = s.piv[in];
  float2 cj[kTile], rv[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) cj[i] = s.col[in][r0 + i];
#pragma unroll
  for (int k = 0; k < kTile; ++k) rv[k] = s.row[in][c0 + k];
  const bool colj = j - c0 == KJ;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const float2 si = gj_col(cj[i], p, LOW);
#pragma unroll
    for (int k = 0; k < kTile; ++k) P[i][k] = gj_update(P[i][k], si, rv[k]);
    if (colj) P[i][KJ] = make_float2(-si.x, -si.y);
  }
  if (j - r0 == KJ) {  // row j: p rv, and p on the pivot
#pragma unroll
    for (int k = 0; k < kTile; ++k) P[KJ][k] = gj_row(p, rv[k]);
    if (colj) P[KJ][KJ] = p;
  }
  const int n = j + 1;  // column n is element NI, row n row NI of their holders
  constexpr int NI = (KJ + 1) % kTile;
  if (n < b) {
    const bool coln = n - c0 == NI;
    if (coln) {
#pragma unroll
      for (int i = 0; i < kTile; ++i) s.col[in ^ 1][r0 + i] = P[i][NI];
    }
    if (n - r0 == NI) {
#pragma unroll
      for (int k = 0; k < kTile; ++k) s.row[in ^ 1][c0 + k] = P[NI][k];
      if (coln) s.piv[in ^ 1] = gj_pivot(P[NI][NI]);
    }
  }
  __syncthreads();
}

template <bool LOW>
__device__ __forceinline__ void gj_steps(float2 (&P)[kTile][kTile], int b,
                                         int r0, int c0, GjBuf& s) {
  for (int j = 0; j < b; ++j) {
    switch (j & 3) {
      case 0: gj_step<0, LOW>(P, j, b, r0, c0, s); break;
      case 1: gj_step<1, LOW>(P, j, b, r0, c0, s); break;
      case 2: gj_step<2, LOW>(P, j, b, r0, c0, s); break;
      case 3: gj_step<3, LOW>(P, j, b, r0, c0, s); break;
    }
  }
}

__global__ void __launch_bounds__(kInvThreads)
batched_gj(const float2* __restrict__ src, float2* __restrict__ dst, int b) {
  __shared__ __align__(16) GjBuf s;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = kTile * (2 * w + lane / 16), c0 = kTile * (lane % 16);
  const long long off = (long long)blockIdx.x * b * b;

  float2 P[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int r = r0 + i, c = c0 + k;
      P[i][k] = (r < b && c < b) ? src[off + (long long)r * b + c]
                                 : make_float2(r == c ? 1.f : 0.f, 0.f);
    }
  if (c0 == 0) {  // column 0, row 0 and its pivot
#pragma unroll
    for (int i = 0; i < kTile; ++i) s.col[0][r0 + i] = P[i][0];
  }
  if (r0 == 0) {
#pragma unroll
    for (int k = 0; k < kTile; ++k) s.row[0][c0 + k] = P[0][k];
    if (c0 == 0) s.piv[0] = gj_pivot(P[0][0]);
  }
  __syncthreads();
  if (r0 < 32)  // warp-uniform: a warp's rows lie on one side of row 32
    gj_steps<true>(P, b, r0, c0, s);
  else
    gj_steps<false>(P, b, r0, c0, s);

#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int r = r0 + i, c = c0 + k;
      if (r < b && c < b) dst[off + (long long)r * b + c] = P[i][k];
    }
}

// The blocked inverse of gj_pivot.cuh, one block per matrix.
__global__ void __launch_bounds__(kPivotThreads)
blocked_gj(const float2* __restrict__ p, float2* __restrict__ out, int b) {
  __shared__ GjSmem s;
  const long long off = (long long)blockIdx.x * b * b;
  float2 P[kT][kT];
  gj_load(P, p + off, b, b);
  gj_invert(P, s, b);
  gj_store(P, out + off, b, b);
}

}  // namespace

// p, out: (batch, b, b) complex64, b <= 64. *launched is raised by the
// number of kernels launched (1).
extern "C" int batched_small_inv(const void* p, void* out, int batch, int b,
                                 int* launched, void* stream) {
  if (b < 1 || b > kBk) return (int)cudaErrorInvalidValue;
  batched_gj<<<batch, kInvThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)p, (float2*)out, b);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

// The same function by the blocked inverse that the factorizations' pivot
// step runs (pivot_gj of row_inverse.cuh), launched on its own.
extern "C" int blocked_small_inv(const void* p, void* out, int batch, int b,
                                 int* launched, void* stream) {
  if (b < 1 || b > kBk) return (int)cudaErrorInvalidValue;
  blocked_gj<<<batch, kPivotThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)p, (float2*)out, b);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
