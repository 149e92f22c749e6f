// Batched inverse of small complex blocks, (B, b, b) with b <= 64, by
// unpivoted in-place Gauss-Jordan: the pivot blocks of the blocked batched
// inverse that the cyclic-reduction factorization runs on every level.
//
// Replaces the Pallas TPU kernel
//   waveforminversionust_tpu/ops/pallas_inv.py::batched_small_inv_pallas
//   (_gj_kernel),
// which carried the batch in the 128 lanes (padded with identities, b a
// multiple of 8) so that every rank-1 update was a full-width vector op.
// That layout is not carried over. Here one thread block of 32 warps owns one
// matrix, held in its threads' registers (thread (ty, tx) keeps
// P[ty + 32 a][tx + 32 c], a, c < 2), identity-padded to 64 x 64 so that no
// element needs a mask, and runs a b-step scalar chain: pivot row and column
// j go through shared memory, double-buffered so that each step needs one
// barrier; each step applies the general update P -= s rv to every element
// and then overwrites row j and column j with directly computed values
// (R p^-1, -C p^-1, p^-1; the reciprocal of |p|^2, clamped at 1e-38, by
// __frcp_rn), because the single rank-1 form cancels in FP32 on the
// Dirichlet rows. The grid is the batch, any B and any b <= 64.
//
// Bound: neither bytes (each matrix is read and written once, 64 KB) nor
// operations (8 b^3 FP32 flops a matrix), but the chain's latency: b
// dependent steps of a barrier, two shared-memory broadcasts and a
// reciprocal, 0.64 us a step. Two 1024-thread blocks of 32 registers fit an
// SM, so 150 matrices are resident at once, two to an SM on some.
//
// The factorizations' pivot step ran this chain too, until it got the
// blocked inverse of gj_pivot.cuh, which takes half the time for one matrix
// (19.9 against 40.8 us at 64 x 64, NVIDIA H100 80GB HBM3, 700 W). This
// kernel keeps the chain: the unpivoted cyclic reduction it serves amplifies
// the last bits of these inverses by up to 1e4 at 301^2, so a change of
// rounding moves that engine's residual by a factor (6.3e-4 to 2.6e-3 after a
// refinement pass with a blocked inverse here), and the inverse is 4.5% of
// that engine's time. blocked_small_inv below launches the blocked inverse
// on the same kind of batch, for tests and timings of the pivot step alone.

#include "gj_pivot.cuh"

namespace {

constexpr int kChainWarps = 32;  // the chain's block: 32 warps,
constexpr int kChainThreads = 32 * kChainWarps;
constexpr int kChainRows = kBk / kChainWarps;  // each thread kChainRows x 2 elements

// P <- the b x b block at src (leading dimension ld), identity-padded.
__device__ __forceinline__ void chain_load(float2 (&P)[kChainRows][2],
                                           const float2* __restrict__ src,
                                           int ld, int b) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kChainRows; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = ty + kChainWarps * a, cc = tx + 32 * c;
      P[a][c] = (r < b && cc < b) ? src[(long long)r * ld + cc]
                                  : make_float2(r == cc ? 1.f : 0.f, 0.f);
    }
}

__device__ __forceinline__ void chain_store(const float2 (&P)[kChainRows][2],
                                            float2* __restrict__ dst, int ld,
                                            int b) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < kChainRows; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = ty + kChainWarps * a, cc = tx + 32 * c;
      if (r < b && cc < b) dst[(long long)r * ld + cc] = P[a][c];
    }
}

// P <- P^-1 in b steps; rowj and colj are shared [2][kBk] buffers.
__device__ __forceinline__ void chain_invert(float2 (&P)[kChainRows][2],
                                             float2 (*rowj)[kBk],
                                             float2 (*colj)[kBk], int b) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int j = 0; j < b; ++j) {
    float2* rj = rowj[j & 1];
    float2* cj = colj[j & 1];
#pragma unroll
    for (int a = 0; a < kChainRows; ++a) {
      if (ty + kChainWarps * a == j) {  // warp-uniform: this warp holds row j
        rj[tx] = P[a][0];
        rj[tx + 32] = P[a][1];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (tx + 32 * c == j) cj[ty + kChainWarps * a] = P[a][c];
    }
    __syncthreads();
    const float2 piv = rj[j];
    const float inv = __frcp_rn(fmaxf(piv.x * piv.x + piv.y * piv.y, 1e-38f));
    const float2 p = make_float2(piv.x * inv, -piv.y * inv);  // 1 / piv
    const float2 rv[2] = {rj[tx], rj[tx + 32]};
#pragma unroll
    for (int a = 0; a < kChainRows; ++a) {
      const float2 s = cmul(cj[ty + kChainWarps * a], p);  // column j / piv
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float2 v = csub(P[a][c], cmul(s, rv[c]));
        P[a][c] = (tx + 32 * c == j) ? make_float2(-s.x, -s.y) : v;
      }
      if (ty + kChainWarps * a == j) {  // row j: p * rv, and p on the pivot
#pragma unroll
        for (int c = 0; c < 2; ++c)
          P[a][c] = (tx + 32 * c == j) ? p : cmul(p, rv[c]);
      }
    }
  }
}

__global__ void __launch_bounds__(kChainThreads)
batched_gj(const float2* __restrict__ p, float2* __restrict__ out, int b) {
  __shared__ float2 rowj[2][kBk], colj[2][kBk];
  const long long off = (long long)blockIdx.x * b * b;
  float2 P[kChainRows][2];
  chain_load(P, p + off, b, b);
  chain_invert(P, rowj, colj, b);
  chain_store(P, out + off, b, b);
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
  batched_gj<<<batch, kChainThreads, 0, (cudaStream_t)stream>>>(
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
