// 9-point complex Helmholtz operator apply, out = sum_s c_s * shift_s(u).
//
// Replaces the Pallas TPU kernels
//   waveforminversionust_tpu/ops/pallas_stencil.py::_kernel       (h_apply_pallas_cpx)
//   waveforminversionust_tpu/ops/pallas_stencil.py::_tiled_kernel (h_apply_tiled_cpx)
// The TPU needed two kernels because a whole field plus its nine planes
// outgrow VMEM past ~704^2; here one thread per output point reads its
// neighbours straight from device memory (L1/L2 serve the reuse), so one
// kernel serves both call sites at any grid size. The adjoint apply is the
// same kernel fed the re-centred conjugate planes (adjoint_coefficients).
//
// Layout: coeffs (9, ny, nx) complex64, u and out (batch, ny, nx) complex64,
// all contiguous; complex64 storage is read as interleaved float2.
//
// Bound: device-memory bandwidth. Per output point the kernel moves 8 B of
// u, 8 B of out and 72 B of coefficient planes; the planes are the same for
// every transmitter, so each thread loads its nine coefficients once into
// registers and loops over kBatchPerThread transmitters, which cuts the
// plane traffic to 72/kBatchPerThread B per point.

#include <cuda_runtime.h>

namespace {

constexpr int kBatchPerThread = 8;

__global__ void stencil9_kernel(const float2* __restrict__ coeffs,
                                const float2* __restrict__ u,
                                float2* __restrict__ out,
                                int batch, int ny, int nx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= nx || y >= ny) return;
  const long long plane = (long long)ny * nx;
  const long long p = (long long)y * nx + x;

  // Stencil slot order of ops/stencil.py: C, L, R, D, U, DL, DR, UL, UR.
  const int dys[9] = {0, 0, 0, -1, 1, -1, -1, 1, 1};
  const int dxs[9] = {0, -1, 1, 0, 0, -1, 1, -1, 1};
  float2 c[9];
  long long off[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    const int yy = y + dys[s], xx = x + dxs[s];
    const bool inside = yy >= 0 && yy < ny && xx >= 0 && xx < nx;
    // Zero halo: an outside neighbour gets a zero coefficient and a safe
    // in-bounds address (its own point).
    c[s] = inside ? coeffs[s * plane + p] : make_float2(0.f, 0.f);
    off[s] = inside ? (long long)yy * nx + xx : p;
  }

  const int b0 = blockIdx.z * kBatchPerThread;
  const int b1 = min(b0 + kBatchPerThread, batch);
  for (int b = b0; b < b1; ++b) {
    const float2* ub = u + b * plane;
    float re = 0.f, im = 0.f;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const float2 v = ub[off[s]];
      re += c[s].x * v.x - c[s].y * v.y;
      im += c[s].x * v.y + c[s].y * v.x;
    }
    out[b * plane + p] = make_float2(re, im);
  }
}

}  // namespace

// *launched is raised by the number of kernels launched (1).
extern "C" int stencil9_apply(const void* coeffs, const void* u, void* out,
                              int batch, int ny, int nx, int* launched,
                              void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + 31) / 32, (ny + 7) / 8,
                  (batch + kBatchPerThread - 1) / kBatchPerThread);
  stencil9_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float2*)coeffs, (const float2*)u, (float2*)out, batch, ny, nx);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
