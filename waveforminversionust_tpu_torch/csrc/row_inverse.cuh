// One step of a block elimination over the rows of the 9-point operator:
// build the Schur complement of a row from its neighbours' inverses and
// invert it in place. Shared by the block-Thomas factorization (factor.cu,
// one chain) and the twisted one (twisted.cu, two chains and a middle).
//
// A step carries one or two independent jobs (RowJob). Every launch of the
// series below serves all jobs of the step in one grid (a grid slice per
// job), so two chains advance a row in the launches one chain needs:
//   1. build_s: S = tri(D_row) - tri(L_row) G_dn tri(U_{row-1})
//                              - tri(U_row) G_up tri(L_{row+1}),
//      each term present when its inverse is given. Elementwise: entry
//      (r, c) needs only the 3x3 neighbourhood of G around (r, c), so no
//      matrix product. S is written into the job's slice of the output.
//   2. an in-place blocked, unpivoted Gauss-Jordan inverse of that slice,
//      panel width 64, the last panel masked to the ragged width (no
//      identity padding: the inverses are stored (ny, nx, nx)). Per panel:
//      a. pivot_gj: one block per job inverts the 64x64 pivot block P, held
//         in its threads' registers (gj_pivot.cuh), and copies the panel
//         columns C with the pivot rows zeroed;
//      b. panel_gemm: P^-1 R (pivot rows) and C P^-1, shared-memory tiled
//         complex FP32 products;
//      c. update_gemm: M -= C (P^-1 R) with the panel column / pivot row
//         overwrites fused into the epilogue.
// At 301^2 a step is 1 + 5 x 3 = 16 launches.
#pragma once

#include "gj_pivot.cuh"

namespace {

constexpr int kTile = 32;   // GEMM output tile (kTile x kTile)
constexpr int kTileK = 16;  // GEMM depth step
constexpr int kMaxJobs = 2;

struct RowJob {
  float2* m;           // nx x nx: S, then its inverse, in place
  const float2* g_dn;  // inverse of row - 1 (downward term), or nullptr
  const float2* g_up;  // inverse of row + 1 (upward term), or nullptr
  int row;
};
struct RowJobs {
  RowJob j[kMaxJobs];
};

// Scratch of one job: pinv (kBk x kBk), rs (kBk x nx), cz and cs (nx x kBk).
__host__ __device__ inline long long job_scratch(int nx) {
  return (long long)kBk * kBk + 3LL * kBk * nx;
}
struct Scratch {
  float2 *pinv, *rs, *cz, *cs;
  __host__ __device__ Scratch(float2* base, int job, int nx) {
    pinv = base + job * job_scratch(nx);
    rs = pinv + kBk * kBk;
    cz = rs + (long long)kBk * nx;
    cs = cz + (long long)kBk * nx;
  }
};

// (tri(O_orow) G tri(I_irow))[r, c] for plane triples o = (main, sub, sup)
// indices of tri(O) and i of tri(I).
__device__ __forceinline__ float2 schur_term(const float2* __restrict__ coeffs,
                                             const float2* __restrict__ g,
                                             int o0, int o1, int o2, int orow,
                                             int i0, int i1, int i2, int irow,
                                             int r, int c, int ny, int nx) {
  const long long plane = (long long)ny * nx;
  auto pl = [&](int k, int row) { return coeffs + k * plane + (long long)row * nx; };
  const float2 zero = make_float2(0.f, 0.f);
  // GI[q, c] = G[q, c] im[c] + G[q, c+1] is[c+1] + G[q, c-1] ip[c-1]
  const float2 *im = pl(i0, irow), *is = pl(i1, irow), *ip = pl(i2, irow);
  auto gi = [&](int q) {
    const float2* gq = g + (long long)q * nx;
    float2 t = cmul(gq[c], im[c]);
    t = cadd(t, c + 1 < nx ? cmul(gq[c + 1], is[c + 1]) : zero);
    t = cadd(t, c > 0 ? cmul(gq[c - 1], ip[c - 1]) : zero);
    return t;
  };
  // OGI[r, c] = om[r] GI[r, c] + os[r] GI[r-1, c] + op[r] GI[r+1, c]
  float2 t = cmul(pl(o0, orow)[r], gi(r));
  t = cadd(t, r > 0 ? cmul(pl(o1, orow)[r], gi(r - 1)) : zero);
  t = cadd(t, r + 1 < nx ? cmul(pl(o2, orow)[r], gi(r + 1)) : zero);
  return t;
}

// S of job blockIdx.z into its m. Planes: D = (0, 1, 2), L = (3, 5, 6),
// U = (4, 7, 8) as (main, sub, sup).
__global__ void build_s(const float2* __restrict__ coeffs, RowJobs jobs,
                        int ny, int nx) {
  const RowJob job = jobs.j[blockIdx.z];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= nx || c >= nx) return;
  const int i = job.row;
  const long long plane = (long long)ny * nx;
  auto pl = [&](int k, int row) { return coeffs + k * plane + (long long)row * nx; };

  // tri(D_i)[r, c]: main on the diagonal, sub[r] at c = r-1, sup[r] at c = r+1
  float2 s = make_float2(0.f, 0.f);
  if (c == r) s = pl(0, i)[r];
  else if (c == r - 1) s = pl(1, i)[r];
  else if (c == r + 1) s = pl(2, i)[r];

  if (job.g_dn)  // tri(L_i) G_{i-1} tri(U_{i-1})
    s = csub(s, schur_term(coeffs, job.g_dn, 3, 5, 6, i, 4, 7, 8, i - 1, r, c,
                           ny, nx));
  if (job.g_up)  // tri(U_i) B_{i+1} tri(L_{i+1})
    s = csub(s, schur_term(coeffs, job.g_up, 4, 7, 8, i, 3, 5, 6, i + 1, r, c,
                           ny, nx));
  job.m[(long long)r * nx + c] = s;
}

// One block of kPivWarps warps per job: pinv = inverse of the b x b pivot
// block m[lo:lo+b, lo:lo+b], and cz = the panel columns m[:, lo:lo+b] with
// the pivot rows zeroed. pinv and cz have a leading dimension of kBk.
__global__ void __launch_bounds__(kPivotThreads)
pivot_gj(RowJobs jobs, float2* scratch, int nx, int lo, int b) {
  __shared__ float2 rowj[2][kBk], colj[2][kBk];
  const float2* __restrict__ m = jobs.j[blockIdx.x].m;
  const Scratch sc(scratch, blockIdx.x, nx);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float2 zero = make_float2(0.f, 0.f);

  float2 P[kPivRows][2];
  gj_load(P, m + (long long)lo * nx + lo, nx, b);
  // cz: kCopy rows per thread per round, loads issued before the stores.
  constexpr int kCopy = 4;
  for (int r0 = ty; r0 < nx; r0 += kPivWarps * kCopy)
    for (int c = tx; c < b; c += 32) {
      float2 v[kCopy];
#pragma unroll
      for (int k = 0; k < kCopy; ++k) {
        const int r = r0 + kPivWarps * k;
        v[k] = (r < nx && (r < lo || r >= lo + b))
                   ? m[(long long)r * nx + lo + c] : zero;
      }
#pragma unroll
      for (int k = 0; k < kCopy; ++k) {
        const int r = r0 + kPivWarps * k;
        if (r < nx) sc.cz[(long long)r * kBk + c] = v[k];
      }
    }
  gj_chain(P, rowj, colj, b);
  gj_store(P, sc.pinv, kBk, b);
}

// acc (2x2 per thread, kTile x kTile per 16x16 block) += A[row0:, :k] B[:k, col0:]
// for row-major A (m x k, lda) and B (k x n, ldb); out-of-range reads are 0.
__device__ __forceinline__ void tile_cgemm(const float2* __restrict__ A, int lda,
                                           const float2* __restrict__ B, int ldb,
                                           int m, int n, int k, int row0,
                                           int col0, float2 acc[2][2]) {
  __shared__ float2 As[kTile][kTileK + 1];
  __shared__ float2 Bs[kTileK][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 16 + tx;
  const float2 zero = make_float2(0.f, 0.f);
  for (int k0 = 0; k0 < k; k0 += kTileK) {
    for (int e = tid; e < kTile * kTileK; e += 256) {
      const int rr = e / kTileK, kk = e - rr * kTileK;
      const int gr = row0 + rr, gk = k0 + kk;
      As[rr][kk] = (gr < m && gk < k) ? A[(long long)gr * lda + gk] : zero;
    }
    for (int e = tid; e < kTileK * kTile; e += 256) {
      const int kk = e / kTile, cc = e - kk * kTile;
      const int gk = k0 + kk, gc = col0 + cc;
      Bs[kk][cc] = (gk < k && gc < n) ? B[(long long)gk * ldb + gc] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float2 a0 = As[ty][kk], a1 = As[ty + 16][kk];
      const float2 b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
      cfma(acc[0][0], a0, b0);
      cfma(acc[0][1], a0, b1);
      cfma(acc[1][0], a1, b0);
      cfma(acc[1][1], a1, b1);
    }
    __syncthreads();
  }
}

// Job blockIdx.z / 2.
// blockIdx.z even: rs (b x nx, ld nx) = pinv (b x b) * m[lo:lo+b, :]
// blockIdx.z odd:  cs (nx x b, ld kBk) = cz (nx x b) * pinv (b x b)
__global__ void __launch_bounds__(256)
panel_gemm(RowJobs jobs, float2* scratch, int nx, int lo, int b) {
  const int job = blockIdx.z >> 1;
  const float2* __restrict__ m = jobs.j[job].m;
  const Scratch sc(scratch, job, nx);
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float2 acc[2][2];
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) acc[a][c] = make_float2(0.f, 0.f);
  if ((blockIdx.z & 1) == 0) {
    if (row0 >= b) return;  // whole block exits together
    tile_cgemm(sc.pinv, kBk, m + (long long)lo * nx, nx, b, nx, b, row0, col0, acc);
    for (int a = 0; a < 2; ++a)
      for (int c = 0; c < 2; ++c) {
        const int r = row0 + threadIdx.y + 16 * a, cc = col0 + threadIdx.x + 16 * c;
        if (r < b && cc < nx) sc.rs[(long long)r * nx + cc] = acc[a][c];
      }
  } else {
    if (col0 >= b) return;
    tile_cgemm(sc.cz, kBk, sc.pinv, kBk, nx, b, b, row0, col0, acc);
    for (int a = 0; a < 2; ++a)
      for (int c = 0; c < 2; ++c) {
        const int r = row0 + threadIdx.y + 16 * a, cc = col0 + threadIdx.x + 16 * c;
        if (r < nx && cc < b) sc.cs[(long long)r * kBk + cc] = acc[a][c];
      }
  }
}

// m (nx x nx) of job blockIdx.z after panel [lo, lo+b):
//   pivot rows:    pinv in the panel block, rs elsewhere
//   panel columns: -cs
//   elsewhere:     m - cz rs
__global__ void __launch_bounds__(256)
update_gemm(RowJobs jobs, float2* scratch, int nx, int lo, int b) {
  float2* __restrict__ m = jobs.j[blockIdx.z].m;
  const Scratch sc(scratch, blockIdx.z, nx);
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float2 acc[2][2];
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) acc[a][c] = make_float2(0.f, 0.f);
  tile_cgemm(sc.cz, kBk, sc.rs, nx, nx, nx, b, row0, col0, acc);
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      const int r = row0 + threadIdx.y + 16 * a, cc = col0 + threadIdx.x + 16 * c;
      if (r >= nx || cc >= nx) continue;
      const bool prow = r >= lo && r < lo + b, pcol = cc >= lo && cc < lo + b;
      float2* dst = m + (long long)r * nx + cc;
      if (prow) *dst = pcol ? sc.pinv[(r - lo) * kBk + (cc - lo)] : sc.rs[(long long)(r - lo) * nx + cc];
      else if (pcol) { const float2 v = sc.cs[(long long)r * kBk + (cc - lo)]; *dst = make_float2(-v.x, -v.y); }
      else *dst = csub(*dst, acc[a][c]);
    }
}

// The error of the launch just made; counts it in *launched if it went.
inline cudaError_t counted(int* launched) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

// The series of launches of one step: S and its inverse for the first
// njobs jobs. scratch holds njobs * job_scratch(nx) complex64 values.
inline cudaError_t invert_rows(const float2* coeffs, const RowJobs& jobs,
                               int njobs, float2* scratch, int ny, int nx,
                               int* launched, cudaStream_t stream) {
  const dim3 sblock(32, 8), sgrid((nx + 31) / 32, (nx + 7) / 8, njobs);
  const dim3 tblock(16, 16);
  const int nt = (nx + kTile - 1) / kTile;
  cudaError_t err;
  build_s<<<sgrid, sblock, 0, stream>>>(coeffs, jobs, ny, nx);
  if ((err = counted(launched)) != cudaSuccess) return err;
  for (int lo = 0; lo < nx; lo += kBk) {
    const int b = nx - lo < kBk ? nx - lo : kBk;
    pivot_gj<<<njobs, kPivotThreads, 0, stream>>>(jobs, scratch, nx, lo, b);
    if ((err = counted(launched)) != cudaSuccess) return err;
    panel_gemm<<<dim3(nt, nt, 2 * njobs), tblock, 0, stream>>>(jobs, scratch, nx, lo, b);
    if ((err = counted(launched)) != cudaSuccess) return err;
    update_gemm<<<dim3(nt, nt, njobs), tblock, 0, stream>>>(jobs, scratch, nx, lo, b);
    if ((err = counted(launched)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
