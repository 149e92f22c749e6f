// Batched inverse of small complex blocks, (B, b, b) with b <= 64, by
// unpivoted in-place Gauss-Jordan: the pivot blocks of the blocked batched
// inverse that the cyclic-reduction factorization runs on every level.
//
// Replaces the Pallas TPU kernel
//   waveforminversionust_tpu/ops/pallas_inv.py::batched_small_inv_pallas
//   (_gj_kernel),
// which carried the batch in the 128 lanes (padded with identities, b a
// multiple of 8) so that every rank-1 update was a full-width vector op.
// That layout is not carried over. Here one thread block owns one matrix,
// held in its threads' registers, and runs the b-step chain of gj_pivot.cuh
// (one barrier per step; pivot row and column overwritten with R p^-1,
// -C p^-1, p^-1; the reciprocal of |p|^2, clamped at 1e-38, by __frcp_rn);
// the grid is the batch, any B and any b <= 64.
//
// Bound: neither bytes (each matrix is read and written once, 64 KB) nor
// operations (8 b^3 FP32 flops a matrix), but the chain's latency: b
// dependent steps of a barrier, two shared-memory broadcasts and a
// reciprocal. A 1024-thread block fills an SM, so B matrices take
// ceil(B / 132) chains in a row.

#include "gj_pivot.cuh"

namespace {

__global__ void __launch_bounds__(kPivotThreads)
batched_gj(const float2* __restrict__ p, float2* __restrict__ out, int b) {
  __shared__ float2 rowj[2][kBk], colj[2][kBk];
  const long long off = (long long)blockIdx.x * b * b;
  float2 P[kPivRows][2];
  gj_load(P, p + off, b, b);
  gj_chain(P, rowj, colj, b);
  gj_store(P, out + off, b, b);
}

}  // namespace

// p, out: (batch, b, b) complex64, b <= 64. *launched is raised by the
// number of kernels launched (1).
extern "C" int batched_small_inv(const void* p, void* out, int batch, int b,
                                 int* launched, void* stream) {
  if (b < 1 || b > kBk) return (int)cudaErrorInvalidValue;
  batched_gj<<<batch, kPivotThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)p, (float2*)out, b);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
