// Device code shared by the Gauss-Newton kernels: the whole IRLS solve
// (gn_solve.cu: B4 with one scan per particle, B6 with one scan shared by
// all particles) and B5 (match_eval.cu, one evaluation of the ten
// normal-equation sums): the per-beam terms, and B5's block reduction.
//
// Every source that includes this header is built with -fmad=false (no
// multiply-add is fused: a fused hx = tx + c*px - s*py can floor into the
// neighbouring cell) and with IEEE sqrtf, division, sinf and cosf (no fast
// math). The per-beam arithmetic repeats iris_lama_tpu/ops/match_eval.py:
// _eval_math and the scalar step iris_lama_tpu/ops/gn_solve.py:
// _solve3_scalar/_exp_compose statement for statement. Sums are reduced in
// one fixed order — thread t adds beams t, t + 256, ...; each warp halves by
// shuffle-down; the eight warp totals are added in turn — which the
// plain PyTorch versions repeat (ops/match_eval.py:_block_sum), so kernel and
// plain version agree bit for bit on the card.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace gn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 10;   // a00 a01 a02 a11 a12 a22 g0 g1 g2 chi2

// a scan of b beams: points [b, 2] (x, y) and a bool mask [b]
struct Scan {
  const float* xy;
  const uint8_t* mask;
  int b;
};

struct Consts {
  float max_dist, res, scale, cinv, eps1, eps2;
  int robust, cell_offset;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One beam's ten terms added into acc from its four corner distances (m):
// bilinear value and gradient, mask, robust weight (_eval_math). robust = 0
// gives unit weights.
__device__ __forceinline__ void add_values(float v00, float v10, float v01,
                                           float v11, float mux, float muy,
                                           float hx, float hy, float fm,
                                           const Consts& k, int robust,
                                           float acc[kSums]) {
  const float mix = 1.0f - mux;
  const float miy = 1.0f - muy;
  const float dist =
      v00 * mix * miy + v10 * miy * mux + v01 * mix * muy + v11 * mux * muy;
  const float gx_ = -((v00 - v10) * miy + (v01 - v11) * muy) * k.scale;
  const float gy_ = -((v00 - v01) * mix + (v10 - v11) * mux) * k.scale;
  const float r = dist * fm;
  const float gx = gx_ * fm;
  const float gy = gy_ * fm;
  const float jw = gy * hx - gx * hy;
  const float wgt = robust ? 1.0f / (1.0f + r * r * k.cinv) : 1.0f;
  const float sw = sqrtf(wgt);
  const float rw = r * sw;
  const float gxw = gx * sw;
  const float gyw = gy * sw;
  const float jww = jw * sw;
  acc[0] += gxw * gxw;
  acc[1] += gxw * gyw;
  acc[2] += gxw * jww;
  acc[3] += gyw * gyw;
  acc[4] += gyw * jww;
  acc[5] += jww * jww;
  acc[6] += gxw * rw;
  acc[7] += gyw * rw;
  acc[8] += jww * rw;
  acc[9] += rw * rw;
}

// One beam's ten terms added into acc: four clipped corner reads of the
// squared-distance grid g [h, w] (B2's function; out of range -> max_dist),
// then add_values.
__device__ __forceinline__ void add_beam(const int8_t* __restrict__ g, int h,
                                         int w, int ly, int lx, float mux,
                                         float muy, float hx, float hy,
                                         float fm, const Consts& k,
                                         int robust, float acc[kSums]) {
  const int64_t y0 = clampi(ly, 0, h - 1), y1 = clampi(ly + 1, 0, h - 1);
  const int64_t x0 = clampi(lx, 0, w - 1), x1 = clampi(lx + 1, 0, w - 1);
  const bool inx0 = lx >= 0 && lx < w, inx1 = lx + 1 >= 0 && lx + 1 < w;
  const bool iny0 = ly >= 0 && ly < h, iny1 = ly + 1 >= 0 && ly + 1 < h;
  const float v00 = inx0 && iny0 ? sqrtf((float)g[y0 * w + x0]) * k.res
                                 : k.max_dist;
  const float v10 = inx1 && iny0 ? sqrtf((float)g[y0 * w + x1]) * k.res
                                 : k.max_dist;
  const float v01 = inx0 && iny1 ? sqrtf((float)g[y1 * w + x0]) * k.res
                                 : k.max_dist;
  const float v11 = inx1 && iny1 ? sqrtf((float)g[y1 * w + x1]) * k.res
                                 : k.max_dist;
  add_values(v00, v10, v01, v11, mux, muy, hx, hy, fm, k, robust, acc);
}

// Block sum of the ten partial sums; the totals land in thread 0's acc.
// Ends with all threads past the barrier, so warp_buf may be rewritten by
// the next call only after thread 0 has read it (callers put a barrier in
// between).
__device__ void block_reduce(float acc[kSums], float (*warp_buf)[kSums]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    float v = acc[i];
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    acc[i] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) warp_buf[warp][i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      float t = warp_buf[0][i];
      for (int j = 1; j < kWarps; ++j) t += warp_buf[j][i];
      acc[i] = t;
    }
  }
}

}  // namespace gn
