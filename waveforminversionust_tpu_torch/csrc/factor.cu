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
// Bound: at 301^2 each row costs 1 + 5 x 3 = 16 launches (4816 per
// factorization). Not FLOPs or bytes (the rank-64 updates are ~6 MFLOP
// each, every byte stays in L2) but the pivot inverse, a 64-step chain of
// block-wide barriers on one SM: about 40 us of the ~58 us a panel takes
// at 301^2. The design keeps P in registers and one barrier per step;
// spreading the pivot inverse over more SMs (a recursive 2x2 split) and
// capturing the per-row series in a CUDA graph are the next steps.

#include "row_inverse.cuh"

// coeffs (9, ny, nx) -> g (ny, nx, nx); scratch holds job_scratch(nx) =
// kBk*kBk + 3*kBk*nx complex64 values (pinv, rs, cz, cs). *launched is
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
