// K5's Gauss-Jordan chain in the row layout: the alternative to the 4 x 4
// register tiles of csrc/inv.cu::batched_gj, kept to time against it
// (k5_layouts.py beside this file). Not on any path of the port.
//
// A matrix is one block of W warps (4 or 8). Warp w owns rows
// RW w .. RW w + RW - 1 (RW = 64 / W) and lane l columns l and l + 32, so a
// thread holds RW x 2 elements. Step j:
//   * column j needs no shared memory: a warp's elements of column j sit in
//     lane j & 31, and __shfl_sync broadcasts them;
//   * row j and 1 / its pivot come from shared memory, where the warp that
//     owns row j wrote them during step j - 1 (every row has its own slot,
//     so no slot is written twice);
//   * AHEAD: the warp that owns row j + 1 updates that row first and
//     publishes it before its other rows;
//   * FLAGS: instead of one block barrier a step, row j's slot has an
//     mbarrier that the owner's 32 lanes arrive on after writing it, and a
//     warp waits only for the row it needs: warps run apart as far as the
//     chain lets them.
// Every element's arithmetic is inv.cu's (gj_update, gj_col, gj_row,
// gj_pivot, included from there), so the outputs must be batched_gj's bits.

#include <utility>

#include "../waveforminversionust_tpu_torch/csrc/inv.cu"

namespace {

struct RowSmem {
  float2 row[kBk][kBk];           // row j as step j reads it
  float2 piv[kBk];                // 1 / its pivot
  unsigned long long bar[kBk];    // FLAGS: row j has been written
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned n) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(n)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];"
               : "=l"(state) : "r"(smem_addr(b)) : "memory");
}
// Every slot's barrier completes its phase 0 once.
__device__ __forceinline__ void mbar_wait(unsigned long long* b) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared.b64 p, [%1], 0;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(b)) : "memory");
  } while (!done);
}

__device__ __forceinline__ float2 half_of(const float2 (&e)[2], bool hi) {
  return hi ? e[1] : e[0];
}
__device__ __forceinline__ void set_half(float2 (&e)[2], bool hi, float2 v) {
  if (hi)
    e[1] = v;
  else
    e[0] = v;
}

// Row n (this warp's row NI) and 1 / its pivot into their slot.
template <int RW, int NI, bool FLAGS>
__device__ __forceinline__ void publish(float2 (&P)[RW][2], int n, int lane,
                                        RowSmem& s) {
  s.row[n][lane] = P[NI][0];
  s.row[n][lane + 32] = P[NI][1];
  if (lane == (n & 31)) s.piv[n] = gj_pivot(half_of(P[NI], n >= 32));
  if (FLAGS) mbar_arrive(&s.bar[n]);
}

// Row I's update by step j: s = c p from lane j & 31's element of column j,
// then P - s rv, and -s over column j.
template <int RW, int I, bool LOW>
__device__ __forceinline__ void update_row(float2 (&P)[RW][2], float2 p,
                                           float2 rv0, float2 rv1, int src,
                                           bool hi, bool mine) {
  const float2 c = half_of(P[I], hi);
  const float2 cj = make_float2(__shfl_sync(0xffffffffu, c.x, src),
                                __shfl_sync(0xffffffffu, c.y, src));
  const float2 si = gj_col(cj, p, LOW);
  P[I][0] = gj_update(P[I][0], si, rv0);
  P[I][1] = gj_update(P[I][1], si, rv1);
  if (mine) set_half(P[I], hi, make_float2(-si.x, -si.y));
}

template <int RW, bool LOW, int... I>
__device__ __forceinline__ void update_rows(std::integer_sequence<int, I...>,
                                            float2 (&P)[RW][2], int skip,
                                            float2 p, float2 rv0, float2 rv1,
                                            int src, bool hi, bool mine) {
  ((I != skip ? update_row<RW, I, LOW>(P, p, rv0, rv1, src, hi, mine)
              : void()), ...);
}

// Step j, j % RW == KJ (row j is row KJ of the warp that owns it).
template <int RW, int KJ, bool LOW, bool FLAGS, bool AHEAD>
__device__ __forceinline__ void row_step(float2 (&P)[RW][2], int j, int b,
                                         int r0, int lane, RowSmem& s) {
  constexpr int NI = (KJ + 1) % RW;
  if (FLAGS) mbar_wait(&s.bar[j]);
  const float2 p = s.piv[j];
  const float2 rv0 = s.row[j][lane], rv1 = s.row[j][lane + 32];
  const int src = j & 31, n = j + 1;
  const bool hi = j >= 32, mine = lane == src;
  const bool next = n < b && n - r0 == NI;  // warp-uniform
  const auto all = std::make_integer_sequence<int, RW>{};
  if (AHEAD && next) {
    update_row<RW, NI, LOW>(P, p, rv0, rv1, src, hi, mine);
    publish<RW, NI, FLAGS>(P, n, lane, s);
    update_rows<RW, LOW>(all, P, NI, p, rv0, rv1, src, hi, mine);
  } else {
    update_rows<RW, LOW>(all, P, -1, p, rv0, rv1, src, hi, mine);
    if (next) publish<RW, NI, FLAGS>(P, n, lane, s);
  }
  if (j - r0 == KJ) {  // row j: p rv, and p on the pivot
    P[KJ][0] = gj_row(p, rv0);
    P[KJ][1] = gj_row(p, rv1);
    if (mine) set_half(P[KJ], hi, p);
  }
  if (!FLAGS) __syncthreads();
}

template <int RW, bool LOW, bool FLAGS, bool AHEAD, int... KJ>
__device__ __forceinline__ void row_steps(std::integer_sequence<int, KJ...>,
                                          float2 (&P)[RW][2], int b, int r0,
                                          int lane, RowSmem& s) {
  for (int j0 = 0; j0 < b; j0 += RW)
    ((j0 + KJ < b ? row_step<RW, KJ, LOW, FLAGS, AHEAD>(P, j0 + KJ, b, r0,
                                                         lane, s)
                  : void()),
     ...);
}

// clk (block 0, thread 0): clock64 at the start, once row 0 is out, after
// the last step (all warps), after the stores.
template <int W, bool FLAGS, bool AHEAD>
__global__ void __launch_bounds__(32 * W)
rows_gj(const float2* __restrict__ src, float2* __restrict__ dst, int b,
        long long* clk) {
  constexpr int RW = kBk / W;
  __shared__ __align__(16) RowSmem s;
  const long long t0 = clock64();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, r0 = RW * w;
  const long long off = (long long)blockIdx.x * b * b;

  float2 P[RW][2];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + i, c = lane + 32 * h;
      P[i][h] = (r < b && c < b) ? src[off + (long long)r * b + c]
                                 : make_float2(r == c ? 1.f : 0.f, 0.f);
    }
  if (FLAGS) {
    if (threadIdx.x < kBk) mbar_init(&s.bar[threadIdx.x], 32);
    __syncthreads();
  }
  if (w == 0) publish<RW, 0, FLAGS>(P, 0, lane, s);
  if (!FLAGS) __syncthreads();
  const bool stamp = clk != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  const long long t1 = clock64();
  const auto steps = std::make_integer_sequence<int, RW>{};
  if (r0 < 32)  // warp-uniform: a warp's rows lie on one side of row 32
    row_steps<RW, true, FLAGS, AHEAD>(steps, P, b, r0, lane, s);
  else
    row_steps<RW, false, FLAGS, AHEAD>(steps, P, b, r0, lane, s);
  if (clk != nullptr) __syncthreads();
  const long long t2 = clock64();

#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + i, c = lane + 32 * h;
      if (r < b && c < b) dst[off + (long long)r * b + c] = P[i][h];
    }
  if (stamp) {
    clk[0] = t0;
    clk[1] = t1;
    clk[2] = t2;
    clk[3] = clock64();
  }
}

template <int W, bool FLAGS, bool AHEAD>
void launch(const void* p, void* out, int batch, int b, long long* clk,
            cudaStream_t s) {
  rows_gj<W, FLAGS, AHEAD><<<batch, 32 * W, 0, s>>>((const float2*)p,
                                                    (float2*)out, b, clk);
}

// What a step's parts cost alone, iters times in one block: KIND 0 the
// tile layout's 16-element update (gj_col and gj_update on registers only),
// 1 that and a block barrier, 2 that and the step's shared-memory reads of
// column j, row j and the pivot; 3 the row layout's 8 x 2 update with the
// column by __shfl_sync, 4 that and a block barrier. clk[0]: the cycles.
template <int KIND>
__global__ void __launch_bounds__(1024)
parts(const float2* __restrict__ in, float2* __restrict__ out, int iters,
      long long* clk) {
  __shared__ float2 col[kBk], row[kBk], piv;
  const int t = threadIdx.x, lane = t & 31, w = (t >> 5) & 7;
  const int r0 = 4 * (2 * w + lane / 16), c0 = 4 * (lane % 16);
  if (t < kBk) {
    col[t] = in[t];
    row[t] = in[kBk + t];
  }
  if (t == 0) piv = in[2 * kBk];
  float acc = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  if (KIND <= 2) {
    float2 P[4][4], cj[4], rv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cj[i] = in[(t + 3 * i) & 1023];
      rv[i] = in[(t + 5 * i + 1) & 1023];
#pragma unroll
      for (int k = 0; k < 4; ++k) P[i][k] = in[(t + 7 * i + k + 2) & 1023];
    }
    for (int it = 0; it < iters; ++it) {
      float2 p = make_float2(1.f, 0.5f);
      if (KIND == 2) {
        p = piv;
#pragma unroll
        for (int i = 0; i < 4; ++i) cj[i] = col[r0 + i];
#pragma unroll
        for (int k = 0; k < 4; ++k) rv[k] = row[c0 + k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 si = gj_col(cj[i], p, true);
#pragma unroll
        for (int k = 0; k < 4; ++k) P[i][k] = gj_update(P[i][k], si, rv[k]);
      }
      if (KIND >= 1) __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc += P[i][k].x + P[i][k].y;
  } else {
    float2 P[8][2];
    const float2 p = make_float2(1.f, 0.5f), rv0 = in[t & 1023],
                 rv1 = in[(t + 1) & 1023];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) P[i][h] = in[(t + 3 * i + h + 2) & 1023];
    for (int it = 0; it < iters; ++it) {
      const int src = it & 31;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 cj = make_float2(__shfl_sync(0xffffffffu, P[i][0].x, src),
                                      __shfl_sync(0xffffffffu, P[i][0].y, src));
        const float2 si = gj_col(cj, p, true);
        P[i][0] = gj_update(P[i][0], si, rv0);
        P[i][1] = gj_update(P[i][1], si, rv1);
      }
      if (KIND == 4) __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += P[i][0].x + P[i][1].y;
  }
  const long long t1 = clock64();
  out[t] = make_float2(acc, 0.f);
  if (t == 0) clk[0] = t1 - t0;
}

}  // namespace

// parts<kind> on threads threads of one block (kind 3 and 4: 256 at most).
extern "C" int k5_parts(const void* in, void* out, int kind, int threads,
                        int iters, long long* clk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float2* i = (const float2*)in;
  float2* o = (float2*)out;
  switch (kind) {
    case 0: parts<0><<<1, threads, 0, s>>>(i, o, iters, clk); break;
    case 1: parts<1><<<1, threads, 0, s>>>(i, o, iters, clk); break;
    case 2: parts<2><<<1, threads, 0, s>>>(i, o, iters, clk); break;
    case 3: parts<3><<<1, threads, 0, s>>>(i, o, iters, clk); break;
    case 4: parts<4><<<1, threads, 0, s>>>(i, o, iters, clk); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The row layout on (batch, b, b) complex64, b <= 64: warps 4 or 8, flags
// and ahead 0 or 1; clk: null, or 4 clock64 stamps of block 0.
extern "C" int k5_rows(const void* p, void* out, int batch, int b, int warps,
                       int flags, int ahead, long long* clk, void* stream) {
  if (b < 1 || b > kBk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  using L = void (*)(const void*, void*, int, int, long long*, cudaStream_t);
  static const L table[2][2][2] = {
      {{launch<4, false, false>, launch<4, false, true>},
       {launch<4, true, false>, launch<4, true, true>}},
      {{launch<8, false, false>, launch<8, false, true>},
       {launch<8, true, false>, launch<8, true, true>}}};
  if ((warps != 4 && warps != 8) || (flags | ahead) & ~1)
    return (int)cudaErrorInvalidValue;
  table[warps == 8][flags][ahead](p, out, batch, b, clk, s);
  return (int)cudaGetLastError();
}
