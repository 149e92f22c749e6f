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
//      a. pivot_gj: one block per job inverts the 64x64 pivot block P
//         (gj_pivot.cuh: blocked again inside the thread block);
//      b. panel_update: one launch for both products and the update. Per
//         32 x 32 tile of M: T = P^-1 R on the tile's columns (on the
//         panel's own columns T = P^-1 with no product), then M -= C T,
//         with the overwrites in the epilogue: T on the pivot rows, 0 - C T
//         on the panel's columns. T is formed again by every tile of a
//         column (three times the multiply-adds of forming it once, ~160
//         MFLOP a panel over 100 blocks), which costs less than a second
//         launch and a round trip of P^-1 R and C P^-1 through memory.
//      R and C are the panel's pivot rows and columns as they are before
//      the panel's step (C with the pivot rows zeroed): copies, because the
//      update works in place. They are staged by the launch that last writes
//      those rows and columns (build_s for the first panel, panel_update of
//      the panel before for the others), so no launch of the series copies.
// At 301^2 a step is 1 + 5 x 2 = 11 launches. Measured on an NVIDIA H100
// 80GB HBM3 (700 W) by torch.profiler over a block-Thomas factorization:
// pivot_gj 36.8 us a launch with the scalar chain and the copy of C inside
// it, 19.9 us now; the products and the update 18.5 us a panel as two
// launches with the depth in four rounds of 16, 14.9 us with the depth
// staged at once, 11.4 us as one launch.
#pragma once

#include "gj_pivot.cuh"

namespace {

constexpr int kTile = 32;   // output tile of the panel update (kTile x kTile)
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

// Scratch of one job: pinv (kBk x kBk), two rc (kBk x nx) and two cz
// (nx x kBk): the panels take them in turns, each written by the launch that
// last changes its panel's rows and columns and read by the panel's own.
__host__ __device__ inline long long job_scratch(int nx) {
  return (long long)kBk * kBk + 4LL * kBk * nx;
}
struct Scratch {
  float2 *pinv, *rc[2], *cz[2];
  int nx;
  __host__ __device__ Scratch(float2* base, int job, int nx_) : nx(nx_) {
    pinv = base + job * job_scratch(nx);
    rc[0] = pinv + kBk * kBk;
    rc[1] = rc[0] + (long long)kBk * nx;
    cz[0] = rc[1] + (long long)kBk * nx;
    cz[1] = cz[0] + (long long)kBk * nx;
  }
  // v = m[r, c] as the panel before [lo, lo + b) leaves it: into that
  // panel's rc (leading dimension nx) if r is one of its pivot rows, and
  // into its cz (leading dimension kBk) if c is one of its columns, zeroed
  // on the pivot rows.
  __device__ void stage(int panel, int lo, int b, int r, int c,
                        float2 v) const {
    const bool prow = r >= lo && r < lo + b;
    if (prow) rc[panel & 1][(long long)(r - lo) * nx + c] = v;
    if (c >= lo && c < lo + b)
      cz[panel & 1][(long long)r * kBk + (c - lo)] =
          prow ? make_float2(0.f, 0.f) : v;
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

// S of job blockIdx.z into its m, and the first panel's rc and cz. Planes:
// D = (0, 1, 2), L = (3, 5, 6), U = (4, 7, 8) as (main, sub, sup).
__global__ void build_s(const float2* __restrict__ coeffs, RowJobs jobs,
                        float2* scratch, int ny, int nx) {
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
  Scratch(scratch, blockIdx.z, nx).stage(0, 0, nx < kBk ? nx : kBk, r, c, s);
}

// One block of kPivWarps warps per job: pinv (leading dimension kBk) = the
// inverse of the b x b pivot block m[lo:lo+b, lo:lo+b] (gj_pivot.cuh).
__global__ void __launch_bounds__(kPivotThreads)
pivot_gj(RowJobs jobs, float2* scratch, int nx, int lo, int b) {
  __shared__ GjSmem s;
  const float2* __restrict__ m = jobs.j[blockIdx.x].m;
  float2 P[kT][kT];
  gj_load(P, m + (long long)lo * nx + lo, nx, b);
  gj_invert(P, s, b);
  gj_store(P, Scratch(scratch, blockIdx.x, nx).pinv, kBk, b);
}

// The shared memory of panel_update (dynamic: over the 48 KB a launch may ask
// for unannounced).
struct PanelSmem {
  float2 a[kBk][kBk + 1];      // pinv
  float2 r[kBk][kTile + 2];    // the tile's columns of rc
  float2 t[kBk][kTile + 2];    // T = pinv rc on them, or pinv's own columns
  float2 cz[kTile][kBk + 1];   // the tile's rows of cz
};

// m (nx x nx) of job blockIdx.z after panel [lo, lo+b), tile (blockIdx.y,
// blockIdx.x) by 8 warps:
//   pivot rows:    T = pinv rc (pinv itself on the panel's columns)
//   panel columns: 0 - cz pinv = 0 - cz T
//   elsewhere:     m - cz T
// and the next panel's rc and cz from its rows and columns. T (64 x 32) is
// formed by warps 0-3 with a 4 x 4 register tile a thread (the products are
// bound by shared-memory bytes per multiply-add, not by FP32 rate), while
// warps 4-7 fetch the tile's rows of cz; then all 8 warps update, 2 x 2.
// Splitting the depth of both products over all 8 warps instead, with 4 x 4
// tiles and the partial sums added through shared memory, was slower (a
// block-Thomas factorization 53.5 against 51.8 ms).
__global__ void __launch_bounds__(256)
panel_update(RowJobs jobs, float2* scratch, int nx, int lo, int b) {
  extern __shared__ float4 panel_raw[];
  PanelSmem& s = *reinterpret_cast<PanelSmem*>(panel_raw);
  float2* __restrict__ m = jobs.j[blockIdx.z].m;
  const Scratch sc(scratch, blockIdx.z, nx);
  const int panel = lo / kBk, nlo = lo + b;
  const int nb = nx - nlo < kBk ? nx - nlo : kBk;
  const float2* __restrict__ rc = sc.rc[panel & 1];
  const float2* __restrict__ cz = sc.cz[panel & 1];
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 16 + tx;
  const float2 zero = make_float2(0.f, 0.f);
  // whole tiles: panels start at multiples of kBk = 2 kTile
  const bool pcols = col0 >= lo && col0 < lo + b;
  const bool prows = row0 >= lo && row0 < lo + b;

  // the values to update, asked for before the products: 0 on the panel's
  // columns (0 - cz pinv there)
  float2 old[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = row0 + ty + 16 * a, gc = col0 + tx + 16 * c;
      old[a][c] = (!prows && !pcols && r < nx && gc < nx)
                      ? m[(long long)r * nx + gc] : zero;
    }

  if (pcols) {
#pragma unroll
    for (int e = tid; e < kBk * kTile; e += 256) {
      const int k = e / kTile, c = e % kTile, pc = col0 - lo + c;
      s.t[k][c] = (k < b && pc < b) ? sc.pinv[k * kBk + pc] : zero;
    }
  } else {
#pragma unroll
    for (int e = tid; e < kBk * kBk; e += 256) {
      const int i = e / kBk, k = e % kBk;
      s.a[i][k] = (i < b && k < b) ? sc.pinv[i * kBk + k] : zero;
    }
#pragma unroll
    for (int e = tid; e < kBk * kTile; e += 256) {
      const int k = e / kTile, c = e % kTile, gc = col0 + c;
      s.r[k][c] = (k < b && gc < nx) ? rc[(long long)k * nx + gc] : zero;
    }
    __syncthreads();
  }
  if (tid >= 128) {
    if (!prows) {
#pragma unroll
      for (int e = tid - 128; e < kTile * kBk; e += 128) {
        const int rr = e / kBk, k = e % kBk, gr = row0 + rr;
        s.cz[rr][k] = (gr < nx && k < b) ? cz[(long long)gr * kBk + k] : zero;
      }
    }
  } else if (!pcols) {
    const int i0 = 4 * (tid / 8), j0 = 4 * (tid % 8);  // T[i0:i0+4, j0:j0+4]
    float2 acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][c] = zero;
#pragma unroll 4
    for (int k = 0; k < b; ++k) {
      const float4* rp = reinterpret_cast<const float4*>(&s.r[k][j0]);
      const float4 r01 = rp[0], r23 = rp[1];
      const float2 rv[4] = {lo2(r01), hi2(r01), lo2(r23), hi2(r23)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 a = s.a[i0 + q][k];
#pragma unroll
        for (int c = 0; c < 4; ++c) cmac(acc[q][c], a, rv[c]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4* tp = reinterpret_cast<float4*>(&s.t[i0 + q][j0]);
      tp[0] = pack(acc[q][0], acc[q][1]);
      tp[1] = pack(acc[q][2], acc[q][3]);
    }
  }
  __syncthreads();  // t and cz are whole

  float2 acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) acc[a][0] = acc[a][1] = zero;
  if (!prows) {
#pragma unroll 8
    for (int k = 0; k < b; ++k) {
      const float2 a0 = s.cz[ty][k], a1 = s.cz[ty + 16][k];
      const float2 t0 = s.t[k][tx], t1 = s.t[k][tx + 16];
      cmac(acc[0][0], a0, t0);
      cmac(acc[0][1], a0, t1);
      cmac(acc[1][0], a1, t0);
      cmac(acc[1][1], a1, t1);
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int rr = ty + 16 * a, cc = tx + 16 * c;
      const int r = row0 + rr, gc = col0 + cc;
      if (r >= nx || gc >= nx) continue;
      const float2 v = prows ? s.t[r - lo][cc] : csub(old[a][c], acc[a][c]);
      m[(long long)r * nx + gc] = v;
      sc.stage(panel + 1, nlo, nb, r, gc, v);
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
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)panel_update, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(PanelSmem));
  if (err != cudaSuccess) return err;
  build_s<<<sgrid, sblock, 0, stream>>>(coeffs, jobs, scratch, ny, nx);
  if ((err = counted(launched)) != cudaSuccess) return err;
  for (int lo = 0; lo < nx; lo += kBk) {
    const int b = nx - lo < kBk ? nx - lo : kBk;
    pivot_gj<<<njobs, kPivotThreads, 0, stream>>>(jobs, scratch, nx, lo, b);
    if ((err = counted(launched)) != cudaSuccess) return err;
    panel_update<<<dim3(nt, nt, njobs), tblock, sizeof(PanelSmem), stream>>>(
        jobs, scratch, nx, lo, b);
    if ((err = counted(launched)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
