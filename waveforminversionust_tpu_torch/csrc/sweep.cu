// Block-Thomas solve sweeps over a multi-RHS batch, forward (H x = b) and
// adjoint (H^H x = b), through the factor G of csrc/factor.cu, as one
// thread-block-cluster kernel for Hopper.
//
// Replaces the Pallas TPU kernels
//   waveforminversionust_tpu/ops/pallas_sweep.py::_fwd_kernel / _bwd_kernel
// (launched per pass by _pass, via banded_solve_pallas:220). On the TPU each
// row step was one matrix product over the whole batch, so every element of
// G read served all right-hand sides.
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
// Bound. Operations: 2 ny - 1 gemvs of nx x nx per right-hand side, 1.66 ms
// at the FP32 peak for 301^2 x 256. Bytes: G (0.22 GB) does not fit the 50
// MB L2, and every block that needs an element of G reads it from L2: the
// first port, each block owning 2 right-hand sides, read 601 x 128 x 725 KB
// = 55.8 GB from L2 a solve, 5.0 TB/s at 11.1 ms: bound by L2 bandwidth.
// The L2 bytes fall as 1 / R for R right-hand sides served by each G
// element read.
//
// Design (csrc/sweep_cluster.cuh, whose row step the twisted sweeps share):
// the right-hand sides are independent, so a cluster of C blocks owns R of
// them and walks all 2 ny - 1 row steps of both passes by itself, in one
// launch: rows 0 .. ny-1 eliminating, ny-1 the turning row, then ny-2 .. 0
// back substituting. R (and the gemv rows a block) is fixed by nx
// (choose(): 16 up to nx = 384, 8 up to 624, 4 up to 1264, the widest grid
// a solve takes); C is chosen per call from cudaOccupancyMaxActiveClusters:
// at 301^2 x 256 the H100 holds only 15 clusters of 8 such blocks at once
// (uneven GPCs), so 16 clusters of 6 blocks (R = 16, 56 gemv rows a block)
// beat 8 in two waves. On the H100 (PERF.md) most of a row step waits for
// G's copies: 8-byte copies and one bulk copy per row of a chunk were
// slower, and a deeper ring did not help.

#include "sweep_cluster.cuh"

namespace {

// The instantiation is fixed by nx: 16 right-hand sides a cluster (56 gemv
// rows a block) up to nx = 384, where two copies of the running vector
// still fit in shared memory; 8 (80 rows) up to 624; 4 (160 rows) up to
// 1264, where 8 blocks of 160 rows no longer cover a row step.
template <bool kAdjoint>
int choose(int batch, int nx, Plan* p) {
  int rc = plan<16, 7, 32, 3, kAdjoint>(batch, 1, nx, p);
  if (rc < 0) rc = plan<8, 5, 32, 4, kAdjoint>(batch, 1, nx, p);
  if (rc < 0) rc = plan<4, 10, 16, 3, kAdjoint>(batch, 1, nx, p);
  return rc;
}

template <bool kAdjoint>
int solve(const float2* g, const float2* coeffs, const float2* b, float2* z,
          float2* x, int batch, int ny, int nx, int* out,
          cudaStream_t stream) {
  Plan p;
  const int rc = choose<kAdjoint>(batch, nx, &p);
  if (rc != 0) return rc;
  Job job = {};
  job.chain[0] = Walk{0, 1, ny - 1, 2 * ny - 1, 0, 1};
  job.groups = p.clusters;
  return launch(p, g, coeffs, b, z, x, batch, ny, nx, job, out, stream);
}

}  // namespace

// b, x: (batch, ny, nx); z: (batch, ny, nx) scratch for the first pass's
// vectors. out[0] is raised by the number of kernels launched (1); out[1..7]
// receive the launch: right-hand sides a cluster, gemv rows a block, blocks
// a cluster, threads a block, shared-memory bytes a block, clusters resident
// at once, clusters launched. Returns 0, a cudaError_t, or -1 when no
// instantiation fits nx (nx > 1264) or the card holds none of its clusters.
extern "C" int sweep_solve(const void* g, const void* coeffs, const void* b,
                           void* z, void* x, int batch, int ny, int nx,
                           int adjoint, int* out, void* stream) {
  if (adjoint)
    return solve<true>((const float2*)g, (const float2*)coeffs,
                       (const float2*)b, (float2*)z, (float2*)x, batch, ny,
                       nx, out, (cudaStream_t)stream);
  return solve<false>((const float2*)g, (const float2*)coeffs,
                      (const float2*)b, (float2*)z, (float2*)x, batch, ny,
                      nx, out, (cudaStream_t)stream);
}
