// The row step of the solve sweeps as a thread-block-cluster kernel for
// Hopper, shared by the block-Thomas sweeps (sweep.cu) and the twisted ones
// (twisted.cu). Each of them is a walk over rows of its factor: a chain of
// gemvs through the stored inverses, each followed by a tridiagonal term
// that forms the next step's input vector.
//
// Layout: G (ny, nx, nx), coeffs (9, ny, nx), b / z / x (batch, ny, nx), all
// complex64 read as float2, contiguous. Planes: D = (0, 1, 2), L = (3, 5, 6),
// U = (4, 7, 8) as (main, sub, sup) of tri(T): T[j,j-1] = sub[j],
// T[j,j+1] = sup[j].
//
// A walk (Walk) is the row map of its steps: an elimination pass from row y0
// in direction d up to a turning row, then back substitution the other way.
// Step s, on row i = row(s), multiplies by G_i (forward) or G_i^H (adjoint),
// then forms the input of step s + 1 (row n = row(s + 1)):
//   forward, elimination:   z_n = b_n - tri(L_n) G_i z_i
//   forward, back subst.:   x_i = G_i v_i,  v_n = z_n - tri(U_n) x_i
//   adjoint, elimination:   w_i = G_i^H v_i,  v_n = b_n - tri(U_i)^H w_i
//   adjoint, back subst.:   x_i = w_i - G_i^H v_i,  v_n = tri(L_i)^H x_i
// with the turning row's x = G v (no subtraction). The block-Thomas solve
// walks rows 0 .. ny-1 .. 0 (sweep.cu); the twisted factor's bottom chain
// walks upwards with L and U exchanged (twisted.cu). A walk may start from
// a vector left in memory by an earlier launch (Job::mid_in) and may end by
// leaving its last step's new vector there (Job::mid_out).
//
// Design. The right-hand sides are independent, so a cluster of C blocks
// owns R of them and walks its rows by itself; clusters never wait on each
// other. Block k of a cluster owns a slice of ~nx / C outputs of every gemv
// (rows of G_i for G_i v, columns for G_i^H v) and also computes one halo
// output on each side, so it can form the next step's vector on its own
// rows. A row step:
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
// The instantiation <R, Mr, Kc, Stages> is chosen by each caller, C per call
// by plan() from cudaOccupancyMaxActiveClusters: a cluster that does not fit
// beside the others runs in a second wave and doubles the time. Data written
// by other blocks during the kernel (the halo's w_i) is read with cp.async
// after a cluster barrier, never through the read-only path.
#pragma once

#include <cooperative_groups.h>

#include "cplx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps, 16 half-warps splitting k
constexpr int kMaxSmem = 232448;
constexpr int kMaxC = 8;  // portable cluster size limit

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

// The rows one cluster walks: steps 0 .. turn run the elimination from row
// y0 in direction d, steps past turn the back substitution back towards y0.
struct Walk {
  int y0, d, turn, nsteps;
  int swap;        // L and U exchanged (the twisted factor's bottom chain)
  int store_turn;  // x is written at the turning row
  __host__ __device__ int row(int s) const {
    return s <= turn ? y0 + d * s : y0 + d * (2 * turn - s);
  }
};

// What a launch walks: chain c's clusters are c * groups .. (c + 1) *
// groups - 1, one group of R right-hand sides each.
struct Job {
  Walk chain[2];
  int groups;
  // (2, batch, nx): when set, the first step's vector is mid_in[0] +
  // mid_in[1] - b at row(0) (the two chains' terms onto the twisted middle).
  const float2* mid_in;
  // (2, batch, nx): when set, the last step's new vector (row(nsteps)) goes
  // to chain c's half instead of the peers.
  float2* mid_out;
};

template <int R, int Mr, int Kc, int Stages, bool kAdjoint>
__global__ void __launch_bounds__(kThreads, 1)
sweep_cluster(const float2* __restrict__ g, const float2* __restrict__ coeffs,
              const float2* __restrict__ b, float2* z, float2* x, int batch,
              int ny, int nx, Job job) {
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
  const int cid = blockIdx.x / nc, chain = cid / job.groups;
  const Walk W = chain ? job.chain[1] : job.chain[0];
  const int r0 = (cid - chain * job.groups) * R;
  float2* mid_out =
      job.mid_out ? job.mid_out + (long long)chain * batch * nx : nullptr;
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
  const int nsteps = W.nsteps, turn = W.turn, nch = lay.nxk / Kc;
  const int nchunks = nsteps * nch;
  // the last step forms a vector only when it leaves it in mid_out
  const int nposts = mid_out ? nsteps : nsteps - 1;

  // Chunk t of the stream of (row step, k-chunk) into ring slot t % Stages,
  // one commit group: each row of G_i's block (its rows h0.. forward, its
  // columns h0.. of rows k0.. adjoint) in 16-byte pairs from the even
  // element at or before the row's first, which lands at its parity.
  auto issue = [&](int t) {
    if (t < nchunks) {
      const long long gi = W.row(t / nch) * gstride;
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
  // in the group of the chunk issued with it): w_i on the gemv rows
  // (adjoint back substitution), else the next step's b or z on the
  // block's own rows; and the next step's tri planes on rows o0 - 1 .. o1.
  auto fetch = [&](int s) {
    const float2* src = nullptr;
    int row = 0, lo = o0, n = own;
    if (kAdjoint && s > turn) {
      src = z, row = W.row(s), lo = h0, n = nrows;
    } else if (s + 1 <= turn) {
      src = b, row = W.row(s + 1);
    } else if (!kAdjoint && s + 1 < nsteps) {
      src = z, row = W.row(s + 1);
    }
    if (src != nullptr)
      for (int e = tid; e < n * R; e += kThreads) {
        const int r = e / n, ol = e - r * n;
        const bool ok = r0 + r < batch;
        cp_async8(stage + ol * R + r,
                  ok ? src + vidx(r0 + r, row, lo + ol, ny, nx) : b, ok);
      }
    if (s < nposts) {
      // elimination: L_n forward, U_i adjoint; back substitution: U_n
      // forward, L_i adjoint; exchanged on a swapped walk
      const bool lower = (kAdjoint ? s + 1 > turn : s + 1 <= turn) != W.swap;
      const int prow = W.row(kAdjoint ? s : s + 1);
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

  // The first step's vector on the block's rows, into every peer's copy:
  // b at row(0), or the twisted middle's right-hand side.
  const int y0 = W.row(0);
  for (int e = tid; e < own * R; e += kThreads) {
    const int ol = e / R, r = e - ol * R, j = o0 + ol;
    float2 v = make_float2(0.f, 0.f);
    if (r0 + r < batch) {
      v = __ldg(b + vidx(r0 + r, y0, j, ny, nx));
      if (job.mid_in) {
        const long long k = (long long)(r0 + r) * nx + j;
        v = csub(cadd(job.mid_in[k], job.mid_in[(long long)batch * nx + k]),
                 v);
      } else if (!kAdjoint) {
        z[vidx(r0 + r, y0, j, ny, nx)] = v;
      }
    }
    for (int p = 0; p < nc; ++p)
      cluster.map_shared_rank(smem + lay.vbuf(0), p)[j * R + r] = v;
  }
  cluster.sync();

  for (int s = 0; s < nsteps; ++s) {
    const int i = W.row(s);
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
    const bool keep_x = s > turn || (s == turn && W.store_turn);
    for (int e = tid; e < nrows * R; e += kThreads) {
      const int rl = e / R, r = e - rl * R, o = h0 + rl;
      float2 yv = part[rl * R + r];
#pragma unroll
      for (int w = 1; w < 8; ++w) yv = cadd(yv, part[(w * kRows + rl) * R + r]);
      if (kAdjoint && s > turn) yv = csub(stage[rl * R + r], yv);  // w_i - ..
      ybuf[rl * R + r] = yv;
      if (r0 + r < batch && o >= o0 && o < o1) {
        if (kAdjoint && s < turn) z[vidx(r0 + r, i, o, ny, nx)] = yv;
        if (keep_x) x[vidx(r0 + r, i, o, ny, nx)] = yv;
      }
    }
    if (s == nposts) break;
    __syncthreads();

    // The next step's v on the block's own rows, into every peer's vector
    // (or, after the last step, into mid_out).
    const int sn = s + 1, in = W.row(sn);
    float2* vnext = smem + lay.vbuf(sn & 1);
    const float2* yb = ybuf - h0 * R;  // yb[j * R + r] = y[j] for h0 <= j < h1
    // the planes staged by fetch: pm[j], ps[j], pp[j] for o0 - 1 <= j <= o1
    const float2 *pm = cst - (o0 - 1), *ps = pm + kRows, *pp = ps + kRows;
    for (int e = tid; e < own * R; e += kThreads) {
      const int ol = e / R, r = e - ol * R, j = o0 + ol;
      const float2* yr = yb + r;
      float2 v;
      if (!kAdjoint) {  // b_n or z_n minus tri(T_n) of G_i's product
        v = csub(stage[ol * R + r], tri(pm, ps, pp, yr, R, j, nx));
      } else if (sn <= turn) {  // b_n - tri(T_i)^H w_i
        v = csub(stage[ol * R + r], tri_h(pm, ps, pp, yr, R, j, nx));
      } else {  // tri(T_i)^H x_i
        v = tri_h(pm, ps, pp, yr, R, j, nx);
      }
      if (sn == nsteps) {
        if (r0 + r < batch) mid_out[(long long)(r0 + r) * nx + j] = v;
        continue;
      }
      if (!kAdjoint && sn <= turn && r0 + r < batch)
        z[vidx(r0 + r, in, j, ny, nx)] = v;
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

// The launch of instantiation <R, Mr, Kc, Stages> for `chains` walks of
// `batch` right-hand sides at width nx: of the cluster sizes whose blocks
// cover nx (a slice and its halo within the gemv rows), the one whose
// clusters run in the fewest waves on this card
// (cudaOccupancyMaxActiveClusters), and of those the largest, whose blocks
// copy the fewest rows of G a step. Returns 0, a cudaError_t, or -1 when the
// instantiation does not fit nx.
template <int R, int Mr, int Kc, int Stages, bool kAdjoint>
int plan(int batch, int chains, int nx, Plan* p) {
  using L = Layout<R, Mr, Kc, Stages>;
  const size_t smem = L(nx).bytes();
  if (smem > (size_t)kMaxSmem || !L::fits(nx, kMaxC)) return -1;
  const void* fn = (const void*)sweep_cluster<R, Mr, Kc, Stages, kAdjoint>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int clusters = chains * ((batch + R - 1) / R);
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

// Launch plan p over job; out[0] is raised by the launch, out[1..7] receive
// the plan: right-hand sides a cluster, gemv rows a block, blocks a cluster,
// threads a block, shared-memory bytes a block, clusters resident at once,
// clusters launched.
inline int launch(const Plan& p, const float2* g, const float2* coeffs,
                  const float2* b, float2* z, float2* x, int batch, int ny,
                  int nx, const Job& job, int* out, cudaStream_t stream) {
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
  Job j = job;
  void* args[] = {(void*)&g, (void*)&coeffs, (void*)&b, (void*)&z,
                  (void*)&x, (void*)&batch, (void*)&ny, (void*)&nx,
                  (void*)&j};
  cudaError_t err = cudaLaunchKernelExC(&cfg, p.fn, args);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++out[0];
  return (int)err;
}

}  // namespace
