// Block-Thomas factorization of the 9-point operator: all Schur-complement
// inverses G_i = S_i^-1 of
//   S_0 = tri(D_0),  S_i = tri(D_i) - tri(L_i) G_{i-1} tri(U_{i-1}).
//
// Replaces the Pallas TPU kernel
//   waveforminversionust_tpu/ops/pallas_factor.py::factor_g_pallas
//   (_factor_kernel, _gj_invert_block, _pivot_gj_ref),
// which ran the whole row recurrence inside one kernel with G_{i-1} in VMEM.
//
// The recurrence over rows is sequential, so each row is a short series of
// launches on one stream, issued by the host loop below: S_i elementwise,
// then its in-place blocked Gauss-Jordan inverse (row_inverse.cuh, shared
// with the twisted factorization; here every step carries one job).
//
// Bound: at 301^2 each row costs 1 + 5 x 2 = 11 launches (3311 per
// factorization). Not FLOPs or bytes (the rank-64 updates are ~6 MFLOP
// each, every byte stays in L2) but latency on one SM: the pivot inverse of
// each panel is 64 dependent steps. As one scalar chain with a block-wide
// barrier per step it took 36.8 us of the ~58 us of a panel, and a
// factorization 88.0-88.3 ms. Now the pivot inverse is blocked again inside
// the thread block (gj_pivot.cuh: 8 steps inside one warp, one barrier per
// 8; 19.9 us), the panel's copies are made by the launches that write those
// rows and columns, and the two products and the update of a panel are one
// launch (11.4 us for 18.5): a factorization takes 51.5-51.7 ms (both in
// one run on an NVIDIA H100 80GB HBM3, 700 W). What is left: the pivot
// inverse is 62% of the device time, the gaps between the launches of a row
// 6% of the whole (a CUDA graph).

#include "row_inverse.cuh"

// coeffs (9, ny, nx) -> g (ny, nx, nx); scratch holds job_scratch(nx) =
// kBk*kBk + 4*kBk*nx complex64 values (pinv, rs, cs, two cz). *launched is
// raised by the number of kernels launched.
extern "C" int factor_g(const void* coeffs, void* g, void* scratch, int ny,
                        int nx, int* launched, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float2* gg = (float2*)g;
  const long long gstride = (long long)nx * nx;
  for (int i = 0; i < ny; ++i) {
    float2* gi = gg + i * gstride;
    RowJobs jobs = {};
    jobs.j[0] = RowJob{gi, i ? gi - gstride : nullptr, nullptr, i};
    const cudaError_t err = invert_rows((const float2*)coeffs, jobs, 1,
                                        (float2*)scratch, ny, nx, launched,
                                        stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
