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

#include "sweep_gemv.cuh"

namespace {

constexpr int kRhs = 2;

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
  if (kAdjoint) gemv_h<kRhs>(g, tv, cv, part, nx);  // w_0 = G_0^H b_0
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / nx, j = e - r * nx;
    if (r0 + r < batch) z[vidx(r0 + r, 0, j, ny, nx)] = cv[e];
  }

  for (int i = 1; i < ny; ++i) {
    if (!kAdjoint) {
      // z_i = b_i - tri(L_i) (G_{i-1} z_{i-1})
      gemv_n<kRhs>(g + (i - 1) * gstride, cv, tv, nx);
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
      gemv_h<kRhs>(g + i * gstride, tv, cv, part, nx);
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
    gemv_n<kRhs>(g + e_row * gstride, tv, cv, nx);  // x_e = G_e z_e
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
      gemv_n<kRhs>(g + i * gstride, tv, cv, nx);
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
      gemv_h<kRhs>(g + i * gstride, tv, cv, part, nx);
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
  const size_t smem = smem_floats2(nx, kRhs, 2) * sizeof(float2);
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
