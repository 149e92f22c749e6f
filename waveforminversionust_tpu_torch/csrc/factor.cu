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
// launches on one stream, issued by the host loop below:
//   1. build_s: S_i, elementwise. Entry (r, c) needs only the 3x3
//      neighbourhood of G_{i-1} around (r, c), so no matrix product.
//      S_i is written into G_i's slice of the output.
//   2. an in-place blocked, unpivoted Gauss-Jordan inverse of that slice,
//      panel width 64, the last panel masked to the ragged width (no
//      identity padding: G is stored (ny, nx, nx)). Per panel:
//      a. pivot_gj: one block inverts the 64x64 pivot block P, held in its
//         threads' registers (64x64 complex = 32 KB), with the
//         cancellation-safe pivot row/column overwrite of _pivot_gj_ref,
//         and copies the panel columns C with the pivot rows zeroed;
//      b. panel_gemm: P^-1 R (pivot rows) and C P^-1, shared-memory tiled
//         complex FP32 products;
//      c. update_gemm: M -= C (P^-1 R) with the panel column / pivot row
//         overwrites fused into the epilogue.
//
// Bound: at 301^2 each row costs 1 + 5 x 3 = 16 launches (4816 per
// factorization). Not FLOPs or bytes (the rank-64 updates are ~6 MFLOP
// each, every byte stays in L2) but the pivot inverse, a 64-step chain of
// block-wide barriers on one SM: about 40 us of the ~58 us a panel takes
// at 301^2. The design keeps P in registers and one barrier per step;
// spreading the pivot inverse over more SMs (a recursive 2x2 split) and
// capturing the per-row series in a CUDA graph are the next steps.

#include <cuda_runtime.h>

namespace {

constexpr int kBk = 64;        // Gauss-Jordan panel width
constexpr int kTile = 32;      // GEMM output tile (kTile x kTile)
constexpr int kTileK = 16;     // GEMM depth step
constexpr int kPivWarps = 32;  // pivot_gj: 32 warps,
constexpr int kPivotThreads = 32 * kPivWarps;
constexpr int kPivRows = kBk / kPivWarps;  // each thread kPivRows x 2 elements

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ void cfma(float2& acc, float2 a, float2 b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}

// S_i into g_i (nx x nx). g_prev = G_{i-1} (unused at i = 0).
__global__ void build_s(const float2* __restrict__ coeffs,
                        const float2* __restrict__ g_prev,
                        float2* __restrict__ g_i, int i, int ny, int nx) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= nx || c >= nx) return;
  const long long plane = (long long)ny * nx;
  auto pl = [&](int k, int row) { return coeffs + k * plane + (long long)row * nx; };
  const float2 zero = make_float2(0.f, 0.f);

  // tri(D_i)[r, c]: main on the diagonal, sub[r] at c = r-1, sup[r] at c = r+1
  float2 s = zero;
  if (c == r) s = pl(0, i)[r];
  else if (c == r - 1) s = pl(1, i)[r];
  else if (c == r + 1) s = pl(2, i)[r];

  if (i > 0) {
    // GU[q, c] = G[q, c] um[c] + G[q, c+1] us[c+1] + G[q, c-1] up[c-1]
    const float2 *um = pl(4, i - 1), *us = pl(7, i - 1), *up = pl(8, i - 1);
    auto gu = [&](int q) {
      const float2* gq = g_prev + (long long)q * nx;
      float2 t = cmul(gq[c], um[c]);
      t = cadd(t, c + 1 < nx ? cmul(gq[c + 1], us[c + 1]) : zero);
      t = cadd(t, c > 0 ? cmul(gq[c - 1], up[c - 1]) : zero);
      return t;
    };
    // LGU[r, c] = lm[r] GU[r, c] + ls[r] GU[r-1, c] + lp[r] GU[r+1, c]
    float2 lgu = cmul(pl(3, i)[r], gu(r));
    lgu = cadd(lgu, r > 0 ? cmul(pl(5, i)[r], gu(r - 1)) : zero);
    lgu = cadd(lgu, r + 1 < nx ? cmul(pl(6, i)[r], gu(r + 1)) : zero);
    s = csub(s, lgu);
  }
  g_i[(long long)r * nx + c] = s;
}

// One block of kPivWarps warps: pinv = inverse of the b x b pivot block
// m[lo:lo+b, lo:lo+b] (scalar Gauss-Jordan), and cz = the panel columns
// m[:, lo:lo+b] with the pivot rows zeroed. pinv and cz have a leading
// dimension of kBk. The block is identity-padded to 64 x 64 (padded rows
// and columns stay untouched by the elimination), so no element needs a
// mask. Thread (ty, tx) keeps P[ty + kPivWarps a][tx + 32 c] (a <
// kPivRows, c < 2) in registers for all b steps; only pivot row and
// column j go through shared memory, double-buffered so that each step
// needs one barrier. Each step applies the general update P -= s rv to
// every element and then overwrites row j and column j, as _pivot_gj_ref
// does. The b-step chain is bound by latency and instruction issue on one
// SM; measured per launch at 301^2: P in shared memory with (r, c)
// re-derived by integer division every step, 88 us; P in registers, 32
// warps with 4 masked elements each, 55 us; 8 warps with 16 elements
// each, 118 us (too few warps to hide the chain's latency); this design
// with 16 warps and IEEE divisions, 44 us; with __frcp_rn, 16 warps 43 us,
// 32 warps 40 us.
__global__ void __launch_bounds__(kPivotThreads)
pivot_gj(const float2* __restrict__ m, float2* __restrict__ pinv,
         float2* __restrict__ cz, int nx, int lo, int b) {
  __shared__ float2 rowj[2][kBk], colj[2][kBk];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float2 zero = make_float2(0.f, 0.f);

  float2 P[kPivRows][2];
#pragma unroll
  for (int a = 0; a < kPivRows; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = ty + kPivWarps * a, cc = tx + 32 * c;
      P[a][c] = (r < b && cc < b) ? m[(long long)(lo + r) * nx + lo + cc]
                                  : make_float2(r == cc ? 1.f : 0.f, 0.f);
    }
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
        if (r < nx) cz[(long long)r * kBk + c] = v[k];
      }
    }

  for (int j = 0; j < b; ++j) {
    float2* rj = rowj[j & 1];
    float2* cj = colj[j & 1];
#pragma unroll
    for (int a = 0; a < kPivRows; ++a) {
      if (ty + kPivWarps * a == j) {  // warp-uniform: this warp holds row j
        rj[tx] = P[a][0];
        rj[tx + 32] = P[a][1];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (tx + 32 * c == j) cj[ty + kPivWarps * a] = P[a][c];
    }
    __syncthreads();
    const float2 piv = rj[j];
    const float inv = __frcp_rn(fmaxf(piv.x * piv.x + piv.y * piv.y, 1e-38f));
    const float2 p = make_float2(piv.x * inv, -piv.y * inv);  // 1 / piv
    const float2 rv[2] = {rj[tx], rj[tx + 32]};
#pragma unroll
    for (int a = 0; a < kPivRows; ++a) {
      const float2 s = cmul(cj[ty + kPivWarps * a], p);  // column j / piv
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float2 v = csub(P[a][c], cmul(s, rv[c]));
        P[a][c] = (tx + 32 * c == j) ? make_float2(-s.x, -s.y) : v;
      }
      if (ty + kPivWarps * a == j) {  // row j: p * rv, and p on the pivot
#pragma unroll
        for (int c = 0; c < 2; ++c)
          P[a][c] = (tx + 32 * c == j) ? p : cmul(p, rv[c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kPivRows; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = ty + kPivWarps * a, cc = tx + 32 * c;
      if (r < b && cc < b) pinv[r * kBk + cc] = P[a][c];
    }
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

// blockIdx.z == 0: rs (b x nx, ld nx) = pinv (b x b) * m[lo:lo+b, :]
// blockIdx.z == 1: cs (nx x b, ld kBk) = cz (nx x b) * pinv (b x b)
__global__ void __launch_bounds__(256)
panel_gemm(const float2* __restrict__ m, const float2* __restrict__ pinv,
           const float2* __restrict__ cz, float2* __restrict__ rs,
           float2* __restrict__ cs, int nx, int lo, int b) {
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float2 acc[2][2];
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) acc[a][c] = make_float2(0.f, 0.f);
  if (blockIdx.z == 0) {
    if (row0 >= b) return;  // whole block exits together
    tile_cgemm(pinv, kBk, m + (long long)lo * nx, nx, b, nx, b, row0, col0, acc);
    for (int a = 0; a < 2; ++a)
      for (int c = 0; c < 2; ++c) {
        const int r = row0 + threadIdx.y + 16 * a, cc = col0 + threadIdx.x + 16 * c;
        if (r < b && cc < nx) rs[(long long)r * nx + cc] = acc[a][c];
      }
  } else {
    if (col0 >= b) return;
    tile_cgemm(cz, kBk, pinv, kBk, nx, b, b, row0, col0, acc);
    for (int a = 0; a < 2; ++a)
      for (int c = 0; c < 2; ++c) {
        const int r = row0 + threadIdx.y + 16 * a, cc = col0 + threadIdx.x + 16 * c;
        if (r < nx && cc < b) cs[(long long)r * kBk + cc] = acc[a][c];
      }
  }
}

// m (nx x nx) after panel [lo, lo+b):
//   pivot rows:    pinv in the panel block, rs elsewhere
//   panel columns: -cs
//   elsewhere:     m - cz rs
__global__ void __launch_bounds__(256)
update_gemm(float2* __restrict__ m, const float2* __restrict__ pinv,
            const float2* __restrict__ cz, const float2* __restrict__ rs,
            const float2* __restrict__ cs, int nx, int lo, int b) {
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float2 acc[2][2];
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) acc[a][c] = make_float2(0.f, 0.f);
  tile_cgemm(cz, kBk, rs, nx, nx, nx, b, row0, col0, acc);
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2; ++c) {
      const int r = row0 + threadIdx.y + 16 * a, cc = col0 + threadIdx.x + 16 * c;
      if (r >= nx || cc >= nx) continue;
      const bool prow = r >= lo && r < lo + b, pcol = cc >= lo && cc < lo + b;
      float2* dst = m + (long long)r * nx + cc;
      if (prow) *dst = pcol ? pinv[(r - lo) * kBk + (cc - lo)] : rs[(long long)(r - lo) * nx + cc];
      else if (pcol) { const float2 v = cs[(long long)r * kBk + (cc - lo)]; *dst = make_float2(-v.x, -v.y); }
      else *dst = csub(*dst, acc[a][c]);
    }
}

// The error of the launch just made; counts it in *launched if it went.
cudaError_t counted(int* launched) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace

// coeffs (9, ny, nx) -> g (ny, nx, nx); scratch holds
// kBk*kBk + 3*kBk*nx complex64 values (pinv, rs, cz, cs). *launched is
// raised by the number of kernels launched.
extern "C" int factor_g(const void* coeffs, void* g, void* scratch, int ny,
                        int nx, int* launched, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float2* c = (const float2*)coeffs;
  float2* gg = (float2*)g;
  float2* pinv = (float2*)scratch;
  float2* rs = pinv + kBk * kBk;
  float2* cz = rs + (long long)kBk * nx;
  float2* cs = cz + (long long)kBk * nx;
  const long long gstride = (long long)nx * nx;
  const dim3 sblock(32, 8), sgrid((nx + 31) / 32, (nx + 7) / 8);
  const dim3 tblock(16, 16);
  const int nt = (nx + kTile - 1) / kTile;
  cudaError_t err;
  for (int i = 0; i < ny; ++i) {
    float2* gi = gg + i * gstride;
    build_s<<<sgrid, sblock, 0, stream>>>(c, i ? gi - gstride : gi, gi, i, ny, nx);
    if ((err = counted(launched)) != cudaSuccess) return (int)err;
    for (int lo = 0; lo < nx; lo += kBk) {
      const int b = nx - lo < kBk ? nx - lo : kBk;
      pivot_gj<<<1, kPivotThreads, 0, stream>>>(gi, pinv, cz, nx, lo, b);
      if ((err = counted(launched)) != cudaSuccess) return (int)err;
      panel_gemm<<<dim3(nt, nt, 2), tblock, 0, stream>>>(gi, pinv, cz, rs, cs, nx, lo, b);
      if ((err = counted(launched)) != cudaSuccess) return (int)err;
      update_gemm<<<dim3(nt, nt), tblock, 0, stream>>>(gi, pinv, cz, rs, cs, nx, lo, b);
      if ((err = counted(launched)) != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaSuccess;
}
