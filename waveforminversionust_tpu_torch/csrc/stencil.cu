// 9-point complex Helmholtz operator apply, out = sum_s c_s * shift_s(u).
//
// Replaces the Pallas TPU kernels
//   waveforminversionust_tpu/ops/pallas_stencil.py::_kernel       (h_apply_pallas_cpx)
//   waveforminversionust_tpu/ops/pallas_stencil.py::_tiled_kernel (h_apply_tiled_cpx)
// The TPU needed two kernels because a whole field plus its nine planes
// outgrow VMEM past ~704^2; here one kernel serves both call sites at any
// grid size. The adjoint apply is the same kernel fed the re-centred
// conjugate planes (adjoint_coefficients).
//
// Layout: coeffs (9, ny, nx) complex64, u and out (batch, ny, nx) complex64,
// all contiguous; complex64 storage is read as interleaved float2.
//
// Bound: device-memory bandwidth: each u element read once, each output
// written once (8 B each a point and field), and the nine planes (72 B a
// point) once. The first version (one thread a point, nine 8-byte loads
// through L1, a group of 8 fields a thread) reread the planes for every
// group, 32 times a 256-field apply, and issued nine loads an output. This
// one:
//   * a block owns a tile of 32 x 16 points for a group of fields
//     (blockIdx.z); each thread keeps the nine coefficients of its two points
//     (one column, two rows) in registers for the whole group;
//   * the fields stream through a shared-memory tile with its one-point halo,
//     kStages deep: while the block computes field f, cp.async brings fields
//     f + 1 .. f + kStages - 1. A tile row is copied in 16-byte pieces where
//     the address allows: a row of an odd-width grid starts on an 8-byte
//     boundary every other row, so each row sits in shared memory at the
//     parity of its address (its "pad"), and the piece at either end that
//     straddles the grid's edge is an 8-byte copy beside a zero, or a 16-byte
//     copy whose source stops after 8 bytes (the rest is zero-filled). The
//     zero halo outside the grid is a store of zeros. What each thread copies
//     and where is worked out once a block, not once a field. Each u element
//     comes from device memory once a tile (its halo from L2), and each
//     output reads its nine neighbours from shared memory;
//   * one block barrier a field: it both says that field f has arrived and
//     that every thread is done with the buffer the next copy refills.
// The split of the batch into groups trades the planes' rereads (once a
// group, from L2) against enough blocks to keep bytes in flight on every SM:
// groups of kFields, chosen on the card (PERF.md, section 6).
// Each output keeps the arithmetic of the first version: the slot order C,
// L, R, D, U, DL, DR, UL, UR of ops/stencil.py, a zero coefficient for a
// neighbour outside the grid, and the same sums, so the outputs are its bits
// (but for the sign of an exact zero).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileX = 32;                // points a tile row: one warp
constexpr int kThreads = 256;             // 8 warps: 8 thread rows a tile
constexpr int kColsS = kTileX + 4;        // slots a tile row (even: 16-byte rows)
constexpr int kPairs = kColsS / 2;        // 16-byte pieces a tile row
constexpr int kTileY = 16;                // rows a tile: two a thread
constexpr int kRows = kTileY + 2;         // with the halo
constexpr int kTasks = kRows * kPairs;    // 16-byte pieces a tile
constexpr int kPer = (kTasks + kThreads - 1) / kThreads;  // of them a thread
constexpr int kFields = 8;                // fields a block
constexpr int kStages = 5;                // fields in shared memory at once
constexpr int kMinBlocks = 3;             // blocks an SM: at most 85 registers

__device__ __forceinline__ void cp_async(void* dst, const void* src, int size,
                                         int src_size) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(src_size) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
                 "l"(src), "r"(src_size) : "memory");
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
stencil9_kernel(const float2* __restrict__ coeffs, const float2* __restrict__ u,
                float2* __restrict__ out, int batch, int ny, int nx) {
  constexpr int S = kStages;
  __shared__ __align__(16) float2 tiles[S][kRows][kColsS];
  const int tx = threadIdx.x % kTileX, ty = threadIdx.x / kTileX;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int x = x0 + tx;
  const long long plane = (long long)ny * nx;
  // Stencil slot order of ops/stencil.py: C, L, R, D, U, DL, DR, UL, UR.
  const int dys[9] = {0, 0, 0, -1, 1, -1, -1, 1, 1};
  const int dxs[9] = {0, -1, 1, 0, 0, -1, 1, -1, 1};

  // The nine coefficients of this thread's two points, rows y0 + 2 ty + i.
  float2 c[2][9];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int y = y0 + 2 * ty + i;
    live[i] = x < nx && y < ny;
    const long long p = live[i] ? (long long)y * nx + x : 0;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const int yy = y + dys[s], xx = x + dxs[s];
      const bool inside = live[i] && yy >= 0 && yy < ny && xx >= 0 && xx < nx;
      c[i][s] = inside ? coeffs[s * plane + p] : make_float2(0.f, 0.f);
    }
  }

  // A tile row of field f sits in shared memory at the parity ("pad") of
  // its first element's address in 8-byte units: that of u, of f * plane
  // and of its offset in the field (0 for a row outside the grid).
  const int upar = (int)((reinterpret_cast<uintptr_t>(u) >> 3) & 1);
  const int ppar = (int)(plane & 1);
  auto row_par = [&](int gy) {
    return gy >= 0 && gy < ny ? (int)(((long long)gy * nx + x0 - 1) & 1) : 0;
  };
  // This thread's copy tasks, the same for every field: a 16-byte slot
  // pair (tile row r, slots 2m, 2m + 1), the field offset of its first
  // element at pad 0, the row's parity, and for pad 0 and 1 what to do:
  // 0 zeros, 1 copy 16 bytes, 2 copy 8 and zero 8, 3 zero 8 and copy 8.
  int tslot[kPer], toff[kPer], tpar[kPer], tmode[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int t = threadIdx.x + q * kThreads;
    const int r = t / kPairs, m = t % kPairs, gy = y0 - 1 + r;
    const bool row_in = gy >= 0 && gy < ny;
    tslot[q] = t < kTasks ? r * kColsS + 2 * m : -1;
    toff[q] = row_in ? gy * nx + x0 - 1 + 2 * m : 0;
    tpar[q] = row_par(gy);
    tmode[q] = 0;
#pragma unroll
    for (int pad = 0; pad < 2; ++pad) {
      const int xa = x0 - 1 + 2 * m - pad;
      const bool in0 = row_in && xa >= 0 && xa < nx;
      const bool in1 = row_in && xa + 1 >= 0 && xa + 1 < nx;
      tmode[q] |= (in0 ? (in1 ? 1 : 2) : (in1 ? 3 : 0)) << (2 * pad);
    }
  }
  auto issue = [&](float2* tile, int f) {
    const float2* uf = u + f * plane;
    const int fpar = upar ^ (f & ppar);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (tslot[q] < 0) continue;
      const int pad = tpar[q] ^ fpar;
      const float2* src = uf + toff[q] - pad;
      float2* dst = tile + tslot[q];
      switch ((tmode[q] >> (2 * pad)) & 3) {
        case 0: *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f); break;
        case 1: cp_async(dst, src, 16, 16); break;
        case 2: cp_async(dst, src, 16, 8); break;  // the second outside: zeros
        case 3:
          dst[0] = make_float2(0.f, 0.f);
          cp_async(dst + 1, src + 1, 8, 8);
          break;
      }
    }
  };
  int cpar[4];  // the parity of this thread's tile rows 2 ty .. 2 ty + 3
#pragma unroll
  for (int q = 0; q < 4; ++q) cpar[q] = row_par(y0 - 1 + 2 * ty + q);

  const int f0 = blockIdx.z * kFields;
  const int f1 = min(f0 + kFields, batch);
#pragma unroll
  for (int q = 0; q < S - 1; ++q) {  // the first S - 1 fields in flight
    if (f0 + q < f1) issue(&tiles[q][0][0], f0 + q);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int f = f0; f < f1; ++f) {
    const int buf = (f - f0) % S, ahead = f + S - 1;
    asm volatile("cp.async.wait_group %0;" ::"n"(S - 2) : "memory");
    __syncthreads();  // field f is in; every thread is done with field f - 1
    if (ahead < f1) issue(&tiles[(ahead - f0) % S][0][0], ahead);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const int fpar = upar ^ (f & ppar);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const int q = i + 1 + dys[s];
        const float2 v = tiles[buf][2 * ty + q][tx + 1 + dxs[s] + (cpar[q] ^ fpar)];
        re += c[i][s].x * v.x - c[i][s].y * v.y;
        im += c[i][s].x * v.y + c[i][s].y * v.x;
      }
      if (live[i])
        out[f * plane + (long long)(y0 + 2 * ty + i) * nx + x] = make_float2(re, im);
    }
  }
}

}  // namespace

// *launched is raised by the number of kernels launched (1).
extern "C" int stencil9_apply(const void* coeffs, const void* u, void* out,
                              int batch, int ny, int nx, int* launched,
                              void* stream) {
  const dim3 grid((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY,
                  (batch + kFields - 1) / kFields);
  stencil9_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)coeffs, (const float2*)u, (float2*)out, batch, ny, nx);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
