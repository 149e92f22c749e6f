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
// Design. The right-hand sides are independent, so a cluster of C blocks
// owns R of them and walks all 2 ny - 1 row steps of both passes by itself,
// in one launch; clusters never wait on each other. Block k of a cluster
// owns a slice of ~nx / C outputs of every gemv (rows of G_i for G_i v,
// columns for G_i^H v) and also computes one halo output on each side, so
// it can form the next step's vector on its own rows. A row step:
//   1. G's slice streams through a ring of k-chunks in shared memory by
//      16-byte cp.async (a row of 301 is 2408 B, which TMA's 16-byte stride
//      rule cannot describe, and G stays unpadded: a chunk's row starts at
//      the even element at or before its first, and lands one element late
//      when that is odd), Stages - 1 chunks ahead across row steps;
//   2. the product from shared memory is register-tiled: a lane holds Mr
//      rows x 8 right-hand sides, the 16 half-warps split k (four-FMA cmac,
//      2.6 B of shared memory a complex multiply-add);
//   3. the block's own rows go to z / x, and the next step's input vector
//      (b or z minus the tridiagonal term, whose planes and b / z were
//      fetched during the product) is formed on them and pushed into every
//      peer's copy (distributed shared memory, double-buffered by step
//      parity); then one hardware cluster barrier (release / acquire at
//      cluster scope), the only synchronisation between blocks.
// R (and the gemv rows a block) is fixed by nx (choose(): 16 up to nx = 384,
// 8 up to 624, 4 up to 1264, the widest grid a solve takes); C is chosen per
// call from cudaOccupancyMaxActiveClusters: at 301^2 x 256 the H100 holds
// only 15 clusters of 8 such blocks at once (uneven GPCs), so 16 clusters of
// 6 blocks (R = 16, 56 gemv rows a block) beat 8 in two waves. On the H100
// (PERF.md) most of a row step waits for G's
// copies: 8-byte copies and one bulk copy per row of a chunk were slower,
// and a deeper ring did not help. Data written by other blocks during the
// kernel (the halo's w_i) is read with cp.async after a cluster barrier,
// never through the read-only path.

#include <cooperative_groups.h>

#include "cplx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps, 16 half-warps splitting k
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ long long vidx(int r, int row, int j, int ny,
                                          int nx) {
  return ((long long)r * ny + row) * nx + j;
}

// (T v)[j] = m[j] v[j] + s[j] v[j-1] + p[j] v[j+1]; v with stride vs
__device__ __forceinline__ float2 tri(const float2* m, const float2* s,
                                      const float2* p, const float2* v,
                                      int vs, int j, int nx) {
  float2 t = cmul(m[j], v[j * vs]);
  if (j > 0) t = cadd(t, cmul(s[j], v[(j - 1) * vs]));
  if (j < nx - 1) t = cadd(t, cmul(p[j], v[(j + 1) * vs]));
  return t;
}

// (T^H v)[j] = conj(m[j]) v[j] + conj(s[j+1]) v[j+1] + conj(p[j-1]) v[j-1]
__device__ __forceinline__ float2 tri_h(const float2* m, const float2* s,
                                        const float2* p, const float2* v,
                                        int vs, int j, int nx) {
  float2 t = cmulc(m[j], v[j * vs]);
  if (j < nx - 1) t = cadd(t, cmulc(s[j + 1], v[(j + 1) * vs]));
  if (j > 0) t = cadd(t, cmulc(p[j - 1], v[(j - 1) * vs]));
  return t;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// 16 bytes, both addresses 16-byte aligned, through L2 only
__device__ __forceinline__ void cp_async16(float2* dst, const float2* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory layout of one block, in float2, mirrored by the host. Every
// region starts at an even offset (16 bytes), for float4 reads of v and the
// 16-byte copies' destinations.
template <int R, int Mr, int Kc, int Stages>
struct Layout {
  static constexpr int kNr = R < 8 ? R : 8;    // right-hand sides a lane
  static constexpr int kCg = R / kNr;          // lane groups over R
  static constexpr int kRows = 16 / kCg * Mr;  // gemv rows a block covers
  // Copies start 16-byte aligned, so a row of a chunk lands one element
  // late when its first element is odd: rows hold Kc + 2 (forward)
  // or kRows + 2 (adjoint; padded so that consecutive rows fall 16 banks
  // apart) elements.
  static constexpr int kRowF = Kc + 2;
  static constexpr int kRowA =
      kRows + 2 + ((8 - (kRows + 2) % 16) + 16) % 16;
  static constexpr int kSlot =
      kRows * kRowF > Kc * kRowA ? kRows * kRowF : Kc * kRowA;
  int nxk, vsz;
  __host__ __device__ explicit Layout(int nx) {
    nxk = (nx + Kc - 1) / Kc * Kc;
    vsz = nxk * R;
  }
  __host__ __device__ int vbuf(int parity) const {
    return Stages * kSlot + parity * vsz;
  }
  __host__ __device__ int part() const { return vbuf(2); }
  __host__ __device__ int ybuf() const { return part() + 8 * kRows * R; }
  __host__ __device__ int stage() const { return ybuf() + kRows * R; }
  __host__ __device__ int planes() const { return stage() + kRows * R; }
  __host__ __device__ size_t bytes() const {
    return (size_t)(planes() + 3 * kRows) * sizeof(float2);
  }
  // Rows of G a block of a cluster of c computes: its slice of ceil(nx / c)
  // and one row of halo on each side.
  __host__ static bool fits(int nx, int c) {
    return (nx + c - 1) / c + 2 <= kRows;
  }
};

template <int R, int Mr, int Kc, int Stages, bool kAdjoint>
__global__ void __launch_bounds__(kThreads, 1)
sweep_cluster(const float2* __restrict__ g, const float2* __restrict__ coeffs,
              const float2* __restrict__ b, float2* z, float2* x, int batch,
              int ny, int nx) {
  using L = Layout<R, Mr, Kc, Stages>;
  constexpr int kNr = L::kNr, kCg = L::kCg, kRows = L::kRows;
  constexpr int kRowF = L::kRowF, kRowA = L::kRowA;
  constexpr int kUnroll = Kc / 16;  // k values a half-warp takes a chunk
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const L lay(nx);
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int r0 = blockIdx.x / nc * R;
  const int slice = (nx + nc - 1) / nc;
  const int o0 = min(nx, rank * slice), o1 = min(nx, o0 + slice);
  const int own = o1 - o0;
  // gemv rows [h0, h1): the slice and its halo, whose outputs feed tri
  const int h0 = own ? max(0, o0 - 1) : o0, h1 = own ? min(nx, o1 + 1) : o0;
  const int nrows = h1 - h0;
  const long long plane = (long long)ny * nx, gstride = (long long)nx * nx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane >> 4, li = lane & 15;
  const int rg = li / kCg, cgi = li % kCg;
  const int hw = warp * 2 + half;
  float2* ring = smem;
  float2* part = smem + lay.part();
  float2* ybuf = smem + lay.ybuf();
  float2* stage = smem + lay.stage();
  float2* cst = smem + lay.planes();  // tri's planes on rows o0 - 1 .. o1
  const int nsteps = 2 * ny - 1, nch = lay.nxk / Kc;
  const int nchunks = nsteps * nch;
  auto grow = [&](int s) { return s < ny ? s : 2 * ny - 2 - s; };

  // Chunk t of the stream of (row step, k-chunk) into ring slot t % Stages,
  // one commit group: each row of G_i's block (its rows h0.. forward, its
  // columns h0.. of rows k0.. adjoint) in 16-byte pairs from the even
  // element at or before the row's first, which lands at its parity.
  auto issue = [&](int t) {
    if (t < nchunks) {
      const long long gi = grow(t / nch) * gstride;
      const int k0 = (t % nch) * Kc;
      const int kn = min(Kc, nx - k0);
      float2* dst = ring + (t % Stages) * L::kSlot;
      constexpr int kPairs = (kAdjoint ? kRows : Kc) / 2 + 1;
      const int rows = kAdjoint ? kn : nrows, n = kAdjoint ? nrows : kn;
      for (int e = tid; e < rows * kPairs; e += kThreads) {
        const int q = e / kPairs, p = e - q * kPairs;
        const long long e0 = kAdjoint ? gi + (long long)(k0 + q) * nx + h0
                                      : gi + (long long)(h0 + q) * nx + k0;
        if (2 * p < (int)(e0 & 1) + n)
          cp_async16(dst + q * (kAdjoint ? kRowA : kRowF) + 2 * p,
                     g + (e0 & ~1LL) + 2 * p);
      }
    }
    cp_commit();
  };

  // What step s's post phase reads, fetched while its gemv runs (cp.async,
  // in the group of the chunk issued with it): w_i on the gemv rows (adjoint back substitution), else the
  // next step's b or z on the block's own rows; and the next step's tri
  // planes on rows o0 - 1 .. o1.
  auto fetch = [&](int s) {
    const float2* src = nullptr;
    int row = 0, lo = o0, n = own;
    if (kAdjoint && s >= ny) {
      src = z, row = grow(s), lo = h0, n = nrows;
    } else if (s + 1 < ny) {
      src = b, row = s + 1;
    } else if (!kAdjoint && s + 1 < nsteps) {
      src = z, row = grow(s + 1);
    }
    if (src != nullptr)
      for (int e = tid; e < n * R; e += kThreads) {
        const int r = e / n, ol = e - r * n;
        const bool ok = r0 + r < batch;
        cp_async8(stage + ol * R + r,
                  ok ? src + vidx(r0 + r, row, lo + ol, ny, nx) : b, ok);
      }
    if (s + 1 < nsteps) {
      const int in = grow(s + 1);
      // forward: L_i, then U_i; adjoint: U_{i-1}, then L_{i+1}
      const bool lower = kAdjoint ? s + 1 >= ny : s + 1 < ny;
      const int prow = kAdjoint ? (s + 1 < ny ? in - 1 : in + 1) : in;
      const int pk[3] = {lower ? 3 : 4, lower ? 5 : 7, lower ? 6 : 8};
      for (int e = tid; e < 3 * (own + 2); e += kThreads) {
        const int k = e / (own + 2), jl = e - k * (own + 2), j = o0 - 1 + jl;
        const bool ok = own > 0 && j >= 0 && j < nx;
        cp_async8(cst + k * kRows + jl,
                  ok ? coeffs + pk[k] * plane + (long long)prow * nx + j
                     : coeffs,
                  ok);
      }
    }
  };

  for (int e = tid; e < lay.planes() + 3 * kRows; e += kThreads)
    smem[e] = make_float2(0.f, 0.f);  // v past nx; ring rows never copied
  __syncthreads();
  for (int t = 0; t < Stages - 1; ++t) issue(t);
  cluster.sync();  // every peer has started before its memory is written

  // v_0 = b_0 on the block's rows, into every peer's vector.
  for (int e = tid; e < own * R; e += kThreads) {
    const int ol = e / R, r = e - ol * R;
    const float2 v = r0 + r < batch ? __ldg(b + vidx(r0 + r, 0, o0 + ol, ny, nx))
                                    : make_float2(0.f, 0.f);
    if (!kAdjoint && r0 + r < batch) z[vidx(r0 + r, 0, o0 + ol, ny, nx)] = v;
    for (int p = 0; p < nc; ++p)
      cluster.map_shared_rank(smem + lay.vbuf(0), p)[(o0 + ol) * R + r] = v;
  }
  cluster.sync();

  for (int s = 0; s < nsteps; ++s) {
    const bool first = s < ny;
    const int i = grow(s);
    const float2* vbuf = smem + lay.vbuf(s & 1);
    const long long gi = i * gstride;
    // where each of this lane's rows starts in a forward chunk's slot
    int rowoff[Mr];
#pragma unroll
    for (int q = 0; q < Mr; ++q) {
      const int row = rg * Mr + q;
      rowoff[q] = row * kRowF + (int)((gi + (long long)(h0 + row) * nx) & 1);
    }

    // y = (G_i or G_i^H) v on rows [h0, h1), chunk by chunk.
    float2 acc[Mr][kNr];
#pragma unroll
    for (int q = 0; q < Mr; ++q)
#pragma unroll
      for (int r = 0; r < kNr; ++r) acc[q][r] = make_float2(0.f, 0.f);
    for (int c = 0; c < nch; ++c) {
      const int t = s * nch + c;
      cp_wait<Stages - 2>();
      __syncthreads();  // chunk t landed; slot (t - 1) % Stages is free
      if (c == 0) fetch(s);  // joins chunk t + Stages - 1's group
      issue(t + Stages - 1);
      const float2* gs = ring + (t % Stages) * L::kSlot;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = hw + 16 * u, k = c * Kc + kk;
        const float4* vk =
            reinterpret_cast<const float4*>(vbuf + k * R + cgi * kNr);
        float2 gv[Mr], vv[kNr];
        if (kAdjoint) {
          const float2* gr =
              gs + kk * kRowA + (int)((gi + (long long)k * nx + h0) & 1);
#pragma unroll
          for (int q = 0; q < Mr; ++q) gv[q] = gr[rg * Mr + q];
        } else {
#pragma unroll
          for (int q = 0; q < Mr; ++q) gv[q] = gs[rowoff[q] + kk];
        }
#pragma unroll
        for (int r = 0; r < kNr / 2; ++r) {
          const float4 w = vk[r];
          vv[2 * r] = make_float2(w.x, w.y);
          vv[2 * r + 1] = make_float2(w.z, w.w);
        }
#pragma unroll
        for (int q = 0; q < Mr; ++q)
#pragma unroll
          for (int r = 0; r < kNr; ++r) {
            if (kAdjoint) {  // acc += conj(g) v
              acc[q][r].x = fmaf(gv[q].y, vv[r].y, fmaf(gv[q].x, vv[r].x, acc[q][r].x));
              acc[q][r].y = fmaf(-gv[q].y, vv[r].x, fmaf(gv[q].x, vv[r].y, acc[q][r].y));
            } else {
              cmac(acc[q][r], gv[q], vv[r]);
            }
          }
      }
    }
#pragma unroll
    for (int q = 0; q < Mr; ++q)
#pragma unroll
      for (int r = 0; r < kNr; ++r) {
        acc[q][r].x += __shfl_xor_sync(0xffffffffu, acc[q][r].x, 16);
        acc[q][r].y += __shfl_xor_sync(0xffffffffu, acc[q][r].y, 16);
      }
    if (half == 0) {
#pragma unroll
      for (int q = 0; q < Mr; ++q)
#pragma unroll
        for (int r = 0; r < kNr; ++r)
          part[(warp * kRows + rg * Mr + q) * R + cgi * kNr + r] = acc[q][r];
    }
    if (nch < Stages) cp_wait<0>();  // the fetch's group is not waited yet
    __syncthreads();

    // y on the gemv rows; the block's own rows of it to z / x.
    for (int e = tid; e < nrows * R; e += kThreads) {
      const int rl = e / R, r = e - rl * R, o = h0 + rl;
      float2 yv = part[rl * R + r];
#pragma unroll
      for (int w = 1; w < 8; ++w) yv = cadd(yv, part[(w * kRows + rl) * R + r]);
      if (kAdjoint && !first) yv = csub(stage[rl * R + r], yv);  // w_i - ..
      ybuf[rl * R + r] = yv;
      if (r0 + r < batch && o >= o0 && o < o1) {
        if (kAdjoint && first) z[vidx(r0 + r, i, o, ny, nx)] = yv;
        if (!first || s == ny - 1) x[vidx(r0 + r, i, o, ny, nx)] = yv;
      }
    }
    if (s == nsteps - 1) break;
    __syncthreads();

    // The next step's v on the block's own rows, into every peer's vector.
    const int sn = s + 1, in = grow(sn);
    float2* vnext = smem + lay.vbuf(sn & 1);
    const float2* yb = ybuf - h0 * R;  // yb[j * R + r] = y[j] for h0 <= j < h1
    // the planes staged by fetch: pm[j], ps[j], pp[j] for o0 - 1 <= j <= o1
    const float2 *pm = cst - (o0 - 1), *ps = pm + kRows, *pp = ps + kRows;
    for (int e = tid; e < own * R; e += kThreads) {
      const int ol = e / R, r = e - ol * R, j = o0 + ol;
      const float2* yr = yb + r;
      float2 v;
      if (!kAdjoint && sn < ny) {  // z_i = b_i - tri(L_i) G_{i-1} z_{i-1}
        v = csub(stage[ol * R + r], tri(pm, ps, pp, yr, R, j, nx));
        if (r0 + r < batch) z[vidx(r0 + r, in, j, ny, nx)] = v;
      } else if (!kAdjoint) {  // z_i - tri(U_i) x_{i+1}
        v = csub(stage[ol * R + r], tri(pm, ps, pp, yr, R, j, nx));
      } else if (sn < ny) {  // b_i - tri(U_{i-1})^H w_{i-1}
        v = csub(stage[ol * R + r], tri_h(pm, ps, pp, yr, R, j, nx));
      } else {  // tri(L_{i+1})^H x_{i+1}
        v = tri_h(pm, ps, pp, yr, R, j, nx);
      }
      for (int p = 0; p < nc; ++p)
        cluster.map_shared_rank(vnext, p)[j * R + r] = v;
    }
    cluster.sync();
  }
}

// A launch: an instantiation, its cluster size, and what the card holds.
struct Plan {
  int rhs, rows, cluster, threads, smem, max_clusters, clusters;
  const void* fn;
};

constexpr int kMaxC = 8;  // portable cluster size limit

// The launch of instantiation <R, Mr, Kc, Stages> at width nx: of the
// cluster sizes whose blocks cover nx (a slice and its halo within the gemv
// rows), the one whose clusters run in the fewest waves on this card
// (cudaOccupancyMaxActiveClusters), and of those the largest, whose blocks
// copy the fewest rows of G a step. Returns 0, a cudaError_t, or -1 when the
// instantiation does not fit nx.
template <int R, int Mr, int Kc, int Stages, bool kAdjoint>
int plan(int batch, int nx, Plan* p) {
  using L = Layout<R, Mr, Kc, Stages>;
  const size_t smem = L(nx).bytes();
  if (smem > (size_t)kMaxSmem || !L::fits(nx, kMaxC)) return -1;
  const void* fn = (const void*)sweep_cluster<R, Mr, Kc, Stages, kAdjoint>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int clusters = (batch + R - 1) / R;
  int waves = -1;
  for (int c = kMaxC; c >= 1 && L::fits(nx, c); --c) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (active > 0 && (waves < 0 || (clusters + active - 1) / active < waves)) {
      waves = (clusters + active - 1) / active;
      *p = Plan{R, L::kRows, c, kThreads, (int)smem, active, clusters, fn};
    }
  }
  return waves < 0 ? -1 : 0;
}

// The instantiation is fixed by nx: 16 right-hand sides a cluster (56 gemv
// rows a block) up to nx = 384, where two copies of the running vector
// still fit in shared memory; 8 (80 rows) up to 624; 4 (160 rows) up to
// 1264, where 8 blocks of 160 rows no longer cover a row step.
template <bool kAdjoint>
int choose(int batch, int nx, Plan* p) {
  int rc = plan<16, 7, 32, 3, kAdjoint>(batch, nx, p);
  if (rc < 0) rc = plan<8, 5, 32, 4, kAdjoint>(batch, nx, p);
  if (rc < 0) rc = plan<4, 10, 16, 3, kAdjoint>(batch, nx, p);
  return rc;
}

template <bool kAdjoint>
int launch(const float2* g, const float2* coeffs, const float2* b, float2* z,
           float2* x, int batch, int ny, int nx, int* out,
           cudaStream_t stream) {
  Plan p;
  const int rc = choose<kAdjoint>(batch, nx, &p);
  if (rc != 0) return rc;
  const int v[] = {p.rhs, p.rows, p.cluster, p.threads, p.smem,
                   p.max_clusters, p.clusters};
  for (int k = 0; k < 7; ++k) out[k + 1] = v[k];
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.clusters * p.cluster);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&g, (void*)&coeffs, (void*)&b, (void*)&z,
                  (void*)&x, (void*)&batch, (void*)&ny, (void*)&nx};
  cudaError_t err = cudaLaunchKernelExC(&cfg, p.fn, args);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++out[0];
  return (int)err;
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
    return launch<true>((const float2*)g, (const float2*)coeffs,
                        (const float2*)b, (float2*)z, (float2*)x, batch, ny,
                        nx, out, (cudaStream_t)stream);
  return launch<false>((const float2*)g, (const float2*)coeffs,
                       (const float2*)b, (float2*)z, (float2*)x, batch, ny,
                       nx, out, (cudaStream_t)stream);
}
