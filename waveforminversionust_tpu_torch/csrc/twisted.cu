// Twisted (two-sided) factorization of the 9-point operator and its solve
// sweeps over a multi-RHS batch, forward (H x = b) and adjoint (H^H x = b).
//
// Replaces the Pallas TPU kernels of
//   waveforminversionust_tpu/ops/pallas_twisted.py:
//   twisted_factor_pallas (_tfactor_kernel) and twisted_solve_pallas
//   (_in_kernel, _out_kernel),
// which advanced both elimination chains one row per sequential grid step,
// with the carried inverses and running vectors in VMEM.
//
//   downward (rows y < m):   S_y = D_y - L_y G_{y-1} U_{y-1},  G_y = S_y^-1
//   upward   (rows y > m):   T_y = D_y - U_y B_{y+1} L_{y+1},  B_y = T_y^-1
//   middle   (row m):        S_m = D_m - L_m G_{m-1} U_{m-1}
//                                      - U_m B_{m+1} L_{m+1},  G_m = S_m^-1
//   inward:   z_y = b_y - L_y G_{y-1} z_{y-1}        (top,    y = 1..m-1)
//             t_y = b_y - U_y B_{y+1} t_{y+1}        (bottom, y = ny-2..m+1)
//   middle:   x_m = G_m (b_m - L_m G_{m-1} z_{m-1} - U_m B_{m+1} t_{m+1})
//   outward:  x_y = G_y (z_y - U_y x_{y+1})          (top,    y = m-1..0)
//             x_y = B_y (t_y - L_y x_{y-1})          (bottom, y = m+1..ny-1)
// The adjoint runs the same chains on H^H: every gemv is G^H, and the plane
// roles swap and shift one row: inward top U_{y-1}^H, inward bottom
// L_{y+1}^H, middle U_{m-1}^H and L_{m+1}^H, outward top L_{y+1}^H, outward
// bottom U_{y-1}^H.
//
// The inverses are stored in row order, g (ny, nx, nx): rows < m hold G_y,
// row m the middle inverse, rows > m hold B_y. The TPU kernel's g_down / g_up
// block-step layout, its padding and its clamped index maps are not carried
// over, and any middle row 0 < m < ny - 1 is taken.
//
// Factor: the per-row series of launches of row_inverse.cuh, every launch
// carrying the top chain's row i and the bottom chain's row ny-1-i as two
// grid slices, so both chains advance in one series (the shorter chain's
// slice is dropped once it has reached the middle); then one series for the
// middle row with both Schur terms. At 301^2: 151 series of 11 launches. As
// in factor.cu the bound is the 64 dependent pivot steps of each panel, which
// the two chains run side by side on two SMs: 46.5-48.2 ms a factorization
// with the scalar pivot chain and two product launches a panel, 29.6-29.7 ms
// with the blocked inverse of gj_pivot.cuh and the one panel_update launch
// (one run, NVIDIA H100 80GB HBM3, 700 W).
//
// Sweeps: as in sweep.cu a block owns kRhs right-hand sides and walks the
// rows inside the block with its running vector in shared memory, streaming
// the inverses through L2 (sweep_gemv.cuh). Here a block owns (RHS group,
// chain): twisted_in walks both chains inward in one launch; twisted_out
// forms the middle (in the blocks of both chains, redundantly: three gemvs
// against ~150 per chain, and no third launch or grid barrier) and walks
// both chains outward. kRhs = 4 makes 2 x 64 = 128 blocks at 256 right-hand
// sides, one per SM (a 1024-thread block at 64 registers fills an SM), so
// that both chains of every group run at once; with kRhs = 2 the 256 blocks
// would run in two waves and the halved chain would buy nothing.

#include "row_inverse.cuh"
#include "sweep_gemv.cuh"

namespace {

constexpr int kRhs = 4;

template <bool kAdjoint>
__device__ __forceinline__ void gemv(const float2* __restrict__ g,
                                     const float2* src, float2* dst,
                                     float2* part, int nx) {
  if (kAdjoint) {
    gemv_h<kRhs>(g, src, dst, part, nx);
  } else {
    gemv_n<kRhs>(g, src, dst, nx);
    __syncthreads();
  }
}

// tri(T_row) v (forward) or tri(T_row)^H v (adjoint) at column j, T the plane
// triple L (upper == false) or U (upper == true).
template <bool kAdjoint>
__device__ __forceinline__ float2 triop(const Planes& P, bool upper, int row,
                                        const float2* v, int j, int nx) {
  const float2* m = P.at(upper ? 4 : 3, row);
  const float2* s = P.at(upper ? 7 : 5, row);
  const float2* p = P.at(upper ? 8 : 6, row);
  return kAdjoint ? tri_h(m, s, p, v, j, nx) : tri(m, s, p, v, j, nx);
}

// Rows of the batch in shared memory <-> global (batch, ny, nx).
__device__ __forceinline__ void load_row(float2* dst, const float2* src,
                                         int r0, int row, int batch, int ny,
                                         int nx) {
  for (int e = threadIdx.x; e < kRhs * nx; e += blockDim.x) {
    const int r = e / nx, j = e - r * nx;
    dst[e] = (r0 + r < batch) ? src[vidx(r0 + r, row, j, ny, nx)]
                              : make_float2(0.f, 0.f);
  }
}
__device__ __forceinline__ void store_row(float2* dst, const float2* src,
                                          int r0, int row, int batch, int ny,
                                          int nx) {
  for (int e = threadIdx.x; e < kRhs * nx; e += blockDim.x) {
    const int r = e / nx, j = e - r * nx;
    if (r0 + r < batch) dst[vidx(r0 + r, row, j, ny, nx)] = src[e];
  }
}

// The step that carries a chain's running vector cv (at row y - d) onto row
// y: out[e] = in[e] - tri(w), w = G_{y-d} cv (forward) or G_{y-d}^H cv. The
// planes are L_y / U_y on the forward top / bottom chain and U_{y-1} /
// L_{y+1} on the adjoint ones. ``in`` is b's row y in global memory (inward)
// or rv in shared memory (the middle's second term).
template <bool kAdjoint>
__device__ __forceinline__ float2 inward_term(const Planes& P, int chain,
                                              int y, int d, const float2* w,
                                              int j, int nx) {
  return kAdjoint ? triop<true>(P, chain == 0, y - d, w, j, nx)
                  : triop<false>(P, chain == 1, y, w, j, nx);
}

// Inward elimination; blockIdx.y is the chain (0 top, downward; 1 bottom,
// upward). Writes z_y (rows < m) and t_y (rows > m) into z.
template <bool kAdjoint>
__global__ void __launch_bounds__(kThreads)
twisted_in(const float2* __restrict__ g, const float2* __restrict__ coeffs,
           const float2* __restrict__ b, float2* z, int batch, int ny, int nx,
           int m) {
  extern __shared__ float2 smem[];
  float2* cv = smem;              // running vector, kRhs x nx
  float2* tv = smem + kRhs * nx;  // temporary, kRhs x nx
  float2* part = tv + 2 * kRhs * nx;  // gemv_h partial sums (after rv)
  const int r0 = blockIdx.x * kRhs;
  const int chain = blockIdx.y;
  const int d = chain ? -1 : 1;
  const int start = chain ? ny - 1 : 0;
  const Planes P{coeffs, (long long)ny * nx, nx};
  const long long gstride = (long long)nx * nx;
  const int n = kRhs * nx;

  load_row(cv, b, r0, start, batch, ny, nx);
  __syncthreads();
  store_row(z, cv, r0, start, batch, ny, nx);
  for (int y = start + d; y != m; y += d) {
    gemv<kAdjoint>(g + (y - d) * gstride, cv, tv, part, nx);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / nx, j = e - r * nx;
      const float2 bv = (r0 + r < batch) ? b[vidx(r0 + r, y, j, ny, nx)]
                                         : make_float2(0.f, 0.f);
      const float2 v = csub(bv, inward_term<kAdjoint>(P, chain, y, d,
                                                      tv + r * nx, j, nx));
      cv[e] = v;
      if (r0 + r < batch) z[vidx(r0 + r, y, j, ny, nx)] = v;
    }
    __syncthreads();
  }
}

// The middle, then outward substitution; blockIdx.y is the chain (0 top,
// upward from m - 1; 1 bottom, downward from m + 1). The blocks of both
// chains compute x_m; the top chain's write it.
template <bool kAdjoint>
__global__ void __launch_bounds__(kThreads)
twisted_out(const float2* __restrict__ g, const float2* __restrict__ coeffs,
            const float2* __restrict__ b, const float2* __restrict__ z,
            float2* x, int batch, int ny, int nx, int m) {
  extern __shared__ float2 smem[];
  float2* cv = smem;
  float2* tv = smem + kRhs * nx;
  float2* rv = tv + kRhs * nx;    // the middle residual, kRhs x nx
  float2* part = rv + kRhs * nx;
  const int r0 = blockIdx.x * kRhs;
  const int chain = blockIdx.y;
  const Planes P{coeffs, (long long)ny * nx, nx};
  const long long gstride = (long long)nx * nx;
  const int n = kRhs * nx;

  // r_m = b_m - (top chain's step onto row m) - (bottom chain's step onto it)
  load_row(rv, b, r0, m, batch, ny, nx);
  for (int c = 0; c < 2; ++c) {
    const int d = c ? -1 : 1;
    load_row(cv, z, r0, m - d, batch, ny, nx);
    __syncthreads();
    gemv<kAdjoint>(g + (m - d) * gstride, cv, tv, part, nx);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / nx, j = e - r * nx;
      rv[e] = csub(rv[e], inward_term<kAdjoint>(P, c, m, d, tv + r * nx, j, nx));
    }
    __syncthreads();
  }
  gemv<kAdjoint>(g + m * gstride, rv, cv, part, nx);  // x_m = G_m r_m
  if (chain == 0) store_row(x, cv, r0, m, batch, ny, nx);

  // Outward, away from the middle: onto row y from row y - e.
  //   forward: x_y = G_y (z_y - tri(U_y) x_{y+1})  /  B_y (t_y - tri(L_y) x_{y-1})
  //   adjoint: x_y = G_y^H (z_y - tri(L_{y+1})^H x_{y+1})
  //                  /  B_y^H (t_y - tri(U_{y-1})^H x_{y-1})
  const int e_dir = chain ? 1 : -1;
  for (int y = m + e_dir; y >= 0 && y < ny; y += e_dir) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / nx, j = e - r * nx;
      const float2 zv = (r0 + r < batch) ? z[vidx(r0 + r, y, j, ny, nx)]
                                         : make_float2(0.f, 0.f);
      const float2 t = kAdjoint
          ? triop<true>(P, chain == 1, y - e_dir, cv + r * nx, j, nx)
          : triop<false>(P, chain == 0, y, cv + r * nx, j, nx);
      tv[e] = csub(zv, t);
    }
    __syncthreads();
    gemv<kAdjoint>(g + y * gstride, tv, cv, part, nx);
    store_row(x, cv, r0, y, batch, ny, nx);
  }
}

template <bool kAdjoint>
int launch_sweeps(const float2* g, const float2* coeffs, const float2* b,
                  float2* z, float2* x, int batch, int ny, int nx, int m,
                  int* launched, cudaStream_t stream) {
  const size_t smem = smem_floats2(nx, kRhs, 3) * sizeof(float2);
  const dim3 grid((batch + kRhs - 1) / kRhs, 2);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)twisted_in<kAdjoint>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute((const void*)twisted_out<kAdjoint>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  twisted_in<kAdjoint><<<grid, kThreads, smem, stream>>>(g, coeffs, b, z,
                                                         batch, ny, nx, m);
  if ((err = counted(launched)) != cudaSuccess) return (int)err;
  twisted_out<kAdjoint><<<grid, kThreads, smem, stream>>>(g, coeffs, b, z, x,
                                                          batch, ny, nx, m);
  return (int)counted(launched);
}

}  // namespace

// coeffs (9, ny, nx) -> g (ny, nx, nx) about the middle row 0 < m < ny - 1;
// scratch holds 2 * job_scratch(nx) complex64 values. *launched is raised by
// the number of kernels launched.
extern "C" int twisted_factor_g(const void* coeffs, void* g, void* scratch,
                                int ny, int nx, int m, int* launched,
                                void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float2* c = (const float2*)coeffs;
  float2* gg = (float2*)g;
  const long long gs = (long long)nx * nx;
  const int nbot = ny - 1 - m;
  const int nsteps = m > nbot ? m : nbot;
  cudaError_t err;
  for (int i = 0; i < nsteps; ++i) {
    RowJobs jobs = {};
    int n = 0;
    if (i < m)  // top chain, row i
      jobs.j[n++] = RowJob{gg + i * gs, i ? gg + (i - 1) * gs : nullptr,
                           nullptr, i};
    if (i < nbot) {  // bottom chain, row ny-1-i
      const int y = ny - 1 - i;
      jobs.j[n++] = RowJob{gg + y * gs, nullptr,
                           i ? gg + (y + 1) * gs : nullptr, y};
    }
    err = invert_rows(c, jobs, n, (float2*)scratch, ny, nx, launched, stream);
    if (err != cudaSuccess) return (int)err;
  }
  RowJobs mid = {};
  mid.j[0] = RowJob{gg + m * gs, gg + (m - 1) * gs, gg + (m + 1) * gs, m};
  err = invert_rows(c, mid, 1, (float2*)scratch, ny, nx, launched, stream);
  return (int)err;
}

// b, x: (batch, ny, nx); z: (batch, ny, nx) scratch for the inward vectors.
// *launched is raised by the number of kernels launched (2).
extern "C" int twisted_sweep_solve(const void* g, const void* coeffs,
                                   const void* b, void* z, void* x, int batch,
                                   int ny, int nx, int m, int adjoint,
                                   int* launched, void* stream) {
  if (adjoint)
    return launch_sweeps<true>((const float2*)g, (const float2*)coeffs,
                               (const float2*)b, (float2*)z, (float2*)x, batch,
                               ny, nx, m, launched, (cudaStream_t)stream);
  return launch_sweeps<false>((const float2*)g, (const float2*)coeffs,
                              (const float2*)b, (float2*)z, (float2*)x, batch,
                              ny, nx, m, launched, (cudaStream_t)stream);
}
