// B5: one fused Gauss-Newton evaluation — the ten normal-equation sums of
// each particle's scan on its squared-distance window.
//
// For each particle p: an int8 window grid[p] [h, w] and, per beam i < b,
// the window-local cell (ly, lx)[p, i], its fractions (mux, muy), the hit
// (hx, hy) and the mask fm. out [p_n, 10]: a00 a01 a02 a11 a12 a22 g0 g1 g2
// chi2 of A = Jw'Jw, g = Jw'rw, chi2 = rw'rw (robust = 0: unit weights).
//
// Replaces iris_lama_tpu/ops/match_eval.py:_kernel (:122), driven by
// _eval_batched (:163): one Pallas program per particle with a one-hot
// matrix-unit corner selection and the ten reductions in VMEM.
//
// Bound on the H100: the function reads the scan's seven [b] operands and
// at most four grid bytes per beam (Loc2D: 768 beams, ~25 KB with the
// corners, ~0.01 us at 3.35 TB/s) and does ~60 flops per beam; launch
// latency dominates. Design: one block of 256 threads per particle; each
// thread adds its beams' terms (gn_common.cuh:add_beam), the block reduces
// them in the fixed order of gn_common.cuh, thread 0 writes the ten sums.
// Built with -fmad=false, so that _eval_math with the block-order sum
// (ops/match_eval.py:gn_eval_sq_plain) is its bit-equal plain version.

#include "gn_common.cuh"

namespace {

struct Beams {
  const int32_t* ly;
  const int32_t* lx;
  const float* mux;
  const float* muy;
  const float* hx;
  const float* hy;
  const float* fm;
  int b;
};

__global__ void __launch_bounds__(gn::kThreads)
    gn_eval_kernel(const int8_t* __restrict__ grid, int h, int w, Beams bm,
                   gn::Consts k, float* __restrict__ out) {
  const int p = blockIdx.x;
  const int8_t* g = grid + (int64_t)p * h * w;
  const int64_t o = (int64_t)p * bm.b;
  __shared__ float warp_buf[gn::kWarps][gn::kSums];
  float acc[gn::kSums];
#pragma unroll
  for (int i = 0; i < gn::kSums; ++i) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < bm.b; i += blockDim.x) {
    gn::add_beam(g, h, w, bm.ly[o + i], bm.lx[o + i], bm.mux[o + i],
                 bm.muy[o + i], bm.hx[o + i], bm.hy[o + i], bm.fm[o + i], k,
                 k.robust, acc);
  }
  gn::block_reduce(acc, warp_buf);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < gn::kSums; ++i) out[p * gn::kSums + i] = acc[i];
  }
}

}  // namespace

extern "C" int gn_eval_sq(const int8_t* grid, int p_n, int h, int w,
                          const int32_t* ly, const int32_t* lx,
                          const float* mux, const float* muy,
                          const float* hx, const float* hy, const float* fm,
                          int b, float max_dist, float res, float scale,
                          float cinv, int robust, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_n > 0) {
    const Beams bm{ly, lx, mux, muy, hx, hy, fm, b};
    const gn::Consts k{max_dist, res, scale, cinv, 0.0f, 0.0f, robust, 0};
    gn_eval_kernel<<<p_n, gn::kThreads, 0, s>>>(grid, h, w, bm, k, out);
  }
  return (int)cudaGetLastError();
}
