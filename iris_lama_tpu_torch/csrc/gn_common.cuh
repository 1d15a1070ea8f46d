// Device code shared by the Gauss-Newton kernels: the whole IRLS solve
// (gn_solve.cu: B4 with one scan per particle, B6 with one scan shared by
// all particles) and B5 (match_eval.cu, one evaluation of the ten
// normal-equation sums).
//
// Every source that includes this header is built with -fmad=false (no
// multiply-add is fused: a fused hx = tx + c*px - s*py can floor into the
// neighbouring cell) and with IEEE sqrtf, division, sinf and cosf (no fast
// math). The per-beam arithmetic repeats iris_lama_tpu/ops/match_eval.py:
// _eval_math and the scalar step iris_lama_tpu/ops/gn_solve.py:
// _solve3_scalar/_exp_compose statement for statement. Sums are reduced in
// one fixed order — thread t adds beams t, t + 256, ...; each warp halves by
// shuffle-down; thread 0 adds the eight warp totals in turn — which the
// plain PyTorch versions repeat (ops/match_eval.py:_block_sum), so kernel and
// plain version agree bit for bit on the card.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace gn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 10;   // a00 a01 a02 a11 a12 a22 g0 g1 g2 chi2

struct Scan {
  const float* px;
  const float* py;
  const float* fm;
  int b;
};

struct Consts {
  float max_dist, res, scale, cinv, eps1, eps2;
  int robust, cell_offset;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One beam's ten terms added into acc: four clipped corner reads of the
// squared-distance grid g [h, w] (B2's function; out of range -> max_dist),
// bilinear value and gradient, mask, robust weight (_eval_math). robust = 0
// gives unit weights.
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

// This thread's partial sums over beams threadIdx.x, +blockDim.x, ... of
// the scan at state (tx, ty, c, s), on the window whose cell (0, 0) is
// (org_x, org_y).
__device__ void eval_partial(const int8_t* __restrict__ g, int h, int w,
                             int org_x, int org_y, const Scan& scan,
                             const Consts& k, int robust, float tx, float ty,
                             float c, float s, float acc[kSums]) {
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < scan.b; i += blockDim.x) {
    const float x = scan.px[i];
    const float y = scan.py[i];
    // lie.se2_apply + geometry.w2m_frac (floor + integer offset)
    const float hx = tx + c * x - s * y;
    const float hy = ty + s * x + c * y;
    const float mfx = hx * k.scale;
    const float mfy = hy * k.scale;
    const float flx = floorf(mfx);
    const float fly = floorf(mfy);
    const int lx = (int)flx + k.cell_offset - org_x;
    const int ly = (int)fly + k.cell_offset - org_y;
    add_beam(g, h, w, ly, lx, mfx - flx, mfy - fly, hx, hy, scan.fm[i], k,
             robust, acc);
  }
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

// The scalar step of one IRLS iteration at sums sm and state st: false
// when |g|_inf < eps1 or |h|_inf < eps2 (h = -A^-1 g: converged before the
// step), else true with cand = exp(h) * st.
__device__ bool gn_step(const float sm[kSums], const float st[4],
                        const Consts& k, float cand[4]) {
  const float g_max = fmaxf(fmaxf(fabsf(sm[6]), fabsf(sm[7])), fabsf(sm[8]));
  const bool stop_g = g_max < k.eps1;
  // _solve3_scalar: adjugate solve of A h = -g
  const float a00 = sm[0], a01 = sm[1], a02 = sm[2];
  const float a11 = sm[3], a12 = sm[4], a22 = sm[5];
  const float g0 = sm[6], g1 = sm[7], g2 = sm[8];
  const float co00 = a11 * a22 - a12 * a12;
  const float co01 = a02 * a12 - a01 * a22;
  const float co02 = a01 * a12 - a02 * a11;
  const float det = a00 * co00 + a01 * co01 + a02 * co02;
  const float co11 = a00 * a22 - a02 * a02;
  const float co12 = a01 * a02 - a00 * a12;
  const float co22 = a00 * a11 - a01 * a01;
  const float inv_det = fabsf(det) > 1e-30f ? 1.0f / det : 0.0f;
  float h0 = -(co00 * g0 + co01 * g1 + co02 * g2) * inv_det;
  float h1 = -(co01 * g0 + co11 * g1 + co12 * g2) * inv_det;
  float h2 = -(co02 * g0 + co12 * g1 + co22 * g2) * inv_det;
  if (stop_g) h0 = h1 = h2 = 0.0f;
  const float h_max = fmaxf(fmaxf(fabsf(h0), fabsf(h1)), fabsf(h2));
  if (stop_g || h_max < k.eps2) return false;
  // _exp_compose: exp(h) * state
  const float sw = sinf(h2);
  const float cw = cosf(h2);
  const bool small = fabsf(h2) < 1e-4f;
  const float t2 = h2 * h2;
  const float safe = small ? 1.0f : h2;
  const float sinc = small ? 1.0f - t2 / 6.0f : sw / safe;
  const float cosc = small ? h2 / 2.0f - t2 * h2 / 24.0f : (1.0f - cw) / safe;
  const float etx = sinc * h0 - cosc * h1;
  const float ety = cosc * h0 + sinc * h1;
  cand[0] = etx + cw * st[0] - sw * st[1];
  cand[1] = ety + sw * st[0] + cw * st[1];
  cand[2] = cw * st[2] - sw * st[3];
  cand[3] = sw * st[2] + cw * st[3];
  return true;
}

// The whole IRLS solve of particle p by one block of kThreads threads, on
// its window g [h, w] at (org_x, org_y) from start state st0 [4], with its
// scan. The loop of the reference (solver.cpp:53-118 /
// gauss_newton.cpp:53-91):
//
//   sums  = ten normal-equation sums at the state (A 6, g 3, chi2)
//   loop while not stopped and it < max_iter:
//     gn_step says converged                         -> stop, it unchanged
//     cand = exp(h) * state; it += 1
//     chi2(cand) < chi2 -> keep cand and its sums; else revert and stop
//   sum_d2 = chi2 at the final state with unit weights (want_lik)
//
// Thread 0 keeps the solver's state, decides each step and publishes the
// candidate and a go flag in shared memory; the block loops over its own
// iterations, so a particle that stops early frees its SM. Writes out
// [8, p_n] column p: tx ty cos sin chi2 iterations sum_d2 0.
__device__ void solve_block(const int8_t* __restrict__ g, int h, int w,
                            int org_x, int org_y,
                            const float* __restrict__ st0, const Scan& scan,
                            const Consts& k, int max_iter, int want_lik,
                            int p, int p_n, float* __restrict__ out) {
  __shared__ float warp_buf[kWarps][kSums];
  __shared__ float cand[4];
  __shared__ int go;

  float acc[kSums];
  float st[4] = {0.0f, 0.0f, 1.0f, 0.0f};   // thread 0's state
  float sm[kSums];
  int it = 0;
  bool stopped = false;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) cand[i] = st0[i];
  }
  __syncthreads();
  eval_partial(g, h, w, org_x, org_y, scan, k, k.robust, cand[0], cand[1],
               cand[2], cand[3], acc);
  block_reduce(acc, warp_buf);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) st[i] = cand[i];
    for (int i = 0; i < kSums; ++i) sm[i] = acc[i];
  }

  for (;;) {
    if (threadIdx.x == 0) {
      go = 0;
      if (!stopped && it < max_iter) {
        if (gn_step(sm, st, k, cand)) {
          go = 1;
        } else {
          stopped = true;   // converged before the step: it unchanged
        }
      }
    }
    __syncthreads();
    if (!go) break;
    eval_partial(g, h, w, org_x, org_y, scan, k, k.robust, cand[0], cand[1],
                 cand[2], cand[3], acc);
    block_reduce(acc, warp_buf);
    if (threadIdx.x == 0) {
      it += 1;
      if (sm[9] - acc[9] > 0.0f) {
        for (int i = 0; i < 4; ++i) st[i] = cand[i];
        for (int i = 0; i < kSums; ++i) sm[i] = acc[i];
      } else {
        stopped = true;   // invalid step: revert and stop
      }
    }
  }

  float sum_d2 = 0.0f;
  if (want_lik) {
    // every thread passed the loop's last barrier and thread 0 writes
    // nothing more to cand; publish the final state
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < 4; ++i) cand[i] = st[i];
    }
    __syncthreads();
    eval_partial(g, h, w, org_x, org_y, scan, k, 0, cand[0], cand[1],
                 cand[2], cand[3], acc);
    block_reduce(acc, warp_buf);
    sum_d2 = acc[9];
  }
  if (threadIdx.x == 0) {
    out[0 * p_n + p] = st[0];
    out[1 * p_n + p] = st[1];
    out[2 * p_n + p] = st[2];
    out[3 * p_n + p] = st[3];
    out[4 * p_n + p] = sm[9];
    out[5 * p_n + p] = (float)it;
    out[6 * p_n + p] = sum_d2;
    out[7 * p_n + p] = 0.0f;
  }
}

}  // namespace gn
