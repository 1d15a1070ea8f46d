// B4 and B6: the whole Gauss-Newton IRLS scan match of each particle in
// one launch, each particle with its own scan (B4, Loc2D) or one scan
// shared by all (B6, PFSlam2D: ops/gn_batch.py launches this entry point
// with scan_stride 0).
//
// For each particle p: an int8 squared-distance window grid[p] [h, w] whose
// cell (0, 0) is org[p] (cell coords [x, y]), a start state st0[p] (tx, ty,
// cos, sin) and the scan (px, py, fm) at offset p * scan_stride of the scan
// arrays (scan_stride = b: one scan [b] per particle; 0: one shared scan).
// The IRLS loop of gn_common.cuh:solve_block; with want_lik, one more
// evaluation with unit weights at the final state gives sum_d2. out
// [8, p_n] rows: tx ty cos sin chi2 iterations sum_d2 0.
//
// Replaces iris_lama_tpu/ops/gn_solve.py:_kernel (:104), driven by
// _solve_batched (:226): one Pallas program per particle (grid=(P,)) with
// the particle's s8 window resident in VMEM, a lax.while_loop over its
// iterations and a one-hot matrix-unit corner selection per evaluation.
// On the GPU the corners are four byte loads (in L2 after the first
// evaluation) and a program becomes a block. B6 replaces
// iris_lama_tpu/ops/gn_batch.py:_kernel (:108), driven by _solve_batched
// (:296): all particles in one Pallas program with per-particle pl.when
// guards; here a stopped particle's block simply ends. Its WAYS/BSPLIT
// interleave and VMEM grouping are TPU scheduling and have no counterpart.
//
// Bound on the H100: the function must read each window once (Loc2D: one
// 576 x 576 window, 332 KB, ~0.1 us at 3.35 TB/s; PFSlam2D: 30 x 432 x
// 432 bytes = 5.6 MB, ~1.7 us) and the scan (768 beams, 9 KB); its
// arithmetic (~60 flops per beam and evaluation) is far below
// the card's rate. The solve is a chain of dependent evaluations — each a
// gather of four grid bytes per beam, a block reduction and a scalar step —
// so it is latency bound, and at P = 1 one block runs on one of 132 SMs.
// Design: one block of 256 threads per particle, which loops over its own
// iterations (a stopped particle frees its SM); thread 0 runs the scalar
// step. Built with -fmad=false; the plain version (ops/gn_solve.py) sums in
// this kernel's order, so on the card the two agree bit for bit. Spreading
// one particle's beams over several blocks (a multi-block design for
// P = 1) is later work.

#include "gn_common.cuh"

namespace {

__global__ void __launch_bounds__(gn::kThreads)
    gn_solve_kernel(const int8_t* __restrict__ grid, int h, int w,
                    const int32_t* __restrict__ org,
                    const float* __restrict__ st0, gn::Scan scan,
                    int64_t scan_stride, gn::Consts k, int max_iter,
                    int want_lik, int p_n, float* __restrict__ out) {
  const int p = blockIdx.x;
  const int64_t o = p * scan_stride;
  const gn::Scan mine{scan.px + o, scan.py + o, scan.fm + o, scan.b};
  gn::solve_block(grid + (int64_t)p * h * w, h, w, org[2 * p], org[2 * p + 1],
                  st0 + 4 * p, mine, k, max_iter, want_lik, p, p_n, out);
}

}  // namespace

extern "C" int gn_solve_batched(const int8_t* grid, int p_n, int h, int w,
                                const int32_t* org, const float* st0,
                                const float* px, const float* py,
                                const float* fm, int b, int64_t scan_stride,
                                float max_dist, float res, float scale,
                                float cinv, int robust, float eps1,
                                float eps2, int cell_offset, int max_iter,
                                int want_lik, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_n > 0) {
    const gn::Scan scan{px, py, fm, b};
    const gn::Consts k{max_dist, res, scale, cinv, eps1, eps2, robust,
                       cell_offset};
    gn_solve_kernel<<<p_n, gn::kThreads, 0, s>>>(grid, h, w, org, st0, scan,
                                                 scan_stride, k, max_iter,
                                                 want_lik, p_n, out);
  }
  return (int)cudaGetLastError();
}
