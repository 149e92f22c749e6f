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
// Sweeps: the row step of sweep.cu (csrc/sweep_cluster.cuh): a cluster of C
// blocks owns R right-hand sides of one chain, block k a slice of ~nx / C
// outputs of every gemv, G streamed from L2 through shared memory, the
// running vector pushed into every peer's shared memory each step. The
// bottom chain is the top chain's walk on the row-reversed system with L and
// U exchanged. Two launches, each holding the clusters of both chains:
//   in:  each chain eliminates from its end row towards m (m gemvs on the
//        top, ny - 1 - m on the bottom) and leaves its last step's vector
//        onto row m (b_m minus its term) in scratch beside z;
//   out: every cluster forms r_m = (top's) + (bottom's) - b_m, takes
//        x_m = G_m r_m (the top chain's clusters write it), then back
//        substitutes away from m (m rows on the top, ny - 1 - m below).
// A right-hand side thus takes 2 ny row steps in two chains of about ny / 2
// + 1 steps a launch, where block-Thomas takes 2 ny - 1 in one chain.
// Bound: operations, the 2 ny - 1 gemvs of nx x nx a right-hand side (the
// middle's runs in both chains), 1.66 ms at the FP32 peak for 301^2 x 256. Residency decides the time: at 301^2 x 256
// all 2 x 256 / R clusters must be on the card at once, or a second wave
// doubles it. K2's R = 16 instantiation (56 gemv rows a block, C >= 6: 192
// blocks) cannot; R = 8 with 160 rows a block (C = 2: 128 blocks) can, and
// on the H100 (PERF.md) it does.

#include "row_inverse.cuh"
#include "sweep_cluster.cuh"

namespace {

// The instantiation is fixed by nx: 8 right-hand sides a cluster and 160
// gemv rows a block up to nx = 432, where two copies of the running vector
// still fit in shared memory (at 301: 2 x 32 clusters of 2 blocks); then
// K2's: 8 and 80 up to 624, 4 and 160 up to 1264.
template <bool kAdjoint>
int choose(int batch, int nx, Plan* p) {
  int rc = plan<8, 10, 16, 3, kAdjoint>(batch, 2, nx, p);
  if (rc < 0) rc = plan<8, 5, 32, 4, kAdjoint>(batch, 2, nx, p);
  if (rc < 0) rc = plan<4, 10, 16, 3, kAdjoint>(batch, 2, nx, p);
  return rc;
}

template <bool kAdjoint>
int sweeps(const float2* g, const float2* coeffs, const float2* b, float2* z,
           float2* x, int batch, int ny, int nx, int m, int* out,
           cudaStream_t stream) {
  Plan p;
  int rc = choose<kAdjoint>(batch, nx, &p);
  if (rc != 0) return rc;
  const int nb = ny - 1 - m;  // rows below the middle
  Job in = {};
  in.chain[0] = Walk{0, 1, m, m, 0, 0};
  in.chain[1] = Walk{ny - 1, -1, nb, nb, 1, 0};
  in.groups = p.clusters / 2;
  in.mid_out = z + (long long)batch * ny * nx;
  Job back = {};
  back.chain[0] = Walk{m, 1, 0, m + 1, 0, 1};
  back.chain[1] = Walk{m, -1, 0, nb + 1, 1, 0};
  back.groups = in.groups;
  back.mid_in = in.mid_out;
  rc = launch(p, g, coeffs, b, z, x, batch, ny, nx, in, out, stream);
  if (rc != 0) return rc;
  return launch(p, g, coeffs, b, z, x, batch, ny, nx, back, out, stream);
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

// b, x: (batch, ny, nx); z: scratch of batch * ny * nx + 2 * batch * nx
// complex64 (the inward vectors, then the two chains' vectors onto row m).
// G 16-byte aligned. out[0] is raised by the number of kernels launched (2);
// out[1..7] receive the launch as sweep_solve's do (clusters: both chains').
// Returns 0, a cudaError_t, or -1 when no instantiation fits nx
// (nx > 1264) or the card holds none of its clusters.
extern "C" int twisted_sweep_solve(const void* g, const void* coeffs,
                                   const void* b, void* z, void* x, int batch,
                                   int ny, int nx, int m, int adjoint,
                                   int* out, void* stream) {
  if (adjoint)
    return sweeps<true>((const float2*)g, (const float2*)coeffs,
                        (const float2*)b, (float2*)z, (float2*)x, batch, ny,
                        nx, m, out, (cudaStream_t)stream);
  return sweeps<false>((const float2*)g, (const float2*)coeffs,
                       (const float2*)b, (float2*)z, (float2*)x, batch, ny,
                       nx, m, out, (cudaStream_t)stream);
}
