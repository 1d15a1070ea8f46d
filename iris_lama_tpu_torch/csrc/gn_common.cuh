// Device code shared by the Gauss-Newton kernels: the whole IRLS solve
// (gn_solve.cu: B4 with one scan per particle, B6 with one scan shared by
// all particles) and B5 (match_eval.cu, one evaluation of the ten
// normal-equation sums). One evaluation is the same code in all three: the
// block layout (Shape), the corner reads, the per-beam terms (add_values)
// and the block sums (block_sums); B4/B6 locate the beams at each state,
// B5 takes them as its operands give them.
//
// Every source that includes this header is built with -fmad=false (no
// multiply-add is fused: a fused hx = tx + c*px - s*py can floor into the
// neighbouring cell) and with IEEE sqrtf, division, sinf and cosf (no fast
// math). The per-beam arithmetic repeats iris_lama_tpu/ops/match_eval.py:
// _eval_math and the scalar step iris_lama_tpu/ops/gn_solve.py:
// _solve3_scalar/_exp_compose statement for statement. Sums are reduced in
// one fixed order — logical thread t adds beams t, t + 256, ... in turn;
// each warp halves by shuffle-down; the eight warp totals are added in
// turn — which the plain PyTorch versions repeat
// (ops/match_eval.py:_block_sum), so kernel and plain version agree bit
// for bit on the card.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace gn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 10;   // a00 a01 a02 a11 a12 a22 g0 g1 g2 chi2
constexpr int kMaxPT = 8;   // beams per logical thread held in registers
constexpr int kMaxQ = 4;    // threads per logical thread: <= 1024 a block

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

// The block's layout for PT = ceil(b / 256) beams per logical thread:
// Q threads share each logical thread's beams (physical thread L + 256 q
// takes its beams m = q, q + Q, ..., beam L + 256 m), S beams each; of a
// logical thread's PT terms, NX come from its Q - 1 partners through
// shared memory.
template <int PT>
struct Shape {
  static constexpr int Q = PT < kMaxQ ? PT : kMaxQ;
  static constexpr int S = (PT + Q - 1) / Q;
  static constexpr int NT = kThreads * Q;
  static constexpr int NX = PT - S;
  static constexpr int kXBytes = NX * kSums * kThreads * 4;
};

// This thread's S beams (slot s: beam L + 256 (q + Q s)); B4/B6 keep them
// in registers for the whole solve, B5 only their masks.
template <int S>
struct Beams {
  float px[S], py[S], fm[S];
};

// Where the beams land at one state: window-local cells and fractions.
template <int S>
struct Hits {
  float hx[S], hy[S], mux[S], muy[S];
  int lx[S], ly[S];
};

// beam m of logical thread L (beam L + 256 m) exists
template <int PT>
__device__ __forceinline__ bool has_beam(int m, int lt, int b) {
  return m < PT && lt + m * kThreads < b;
}

// the slot of a partner's term m (m % Q != 0) in the exchange buffer
template <int Q>
__device__ __forceinline__ int xslot(int m) {
  return m - m / Q - 1;
}

// The squared-distance element types of a window (DistanceConfig.sq_dtype:
// int8, uint8, int16, int32) by the code the wrappers pass.
enum SqType { kI8 = 0, kU8 = 1, kI16 = 2, kI32 = 3 };

// root[v] = sqrtf(v) * res for every one-byte v — int8 values indexed by
// their byte (root[(uint8_t)v]), uint8 values by their value: a corner's
// distance (the float operations of _eval_math's corner), looked up. The
// block's first 256 threads fill it; a block barrier must come before
// block_sums reads it. Wider types have no table: each corner computes
// sqrtf(v) * res itself, the same operations.
template <typename T>
__device__ __forceinline__ void fill_root(float* root, float res) {
  if constexpr (std::is_same_v<T, int8_t>) {
    if (threadIdx.x < 256) {
      root[threadIdx.x] = sqrtf((float)(int8_t)threadIdx.x) * res;
    }
  } else if constexpr (std::is_same_v<T, uint8_t>) {
    if (threadIdx.x < 256) root[threadIdx.x] = sqrtf((float)threadIdx.x) * res;
  }
}

// a stored squared distance v -> its distance sqrtf(v) * res (m)
template <typename T>
__device__ __forceinline__ float root_of(const float* root, T v, float res) {
  if constexpr (std::is_same_v<T, int8_t>) {
    return root[(uint8_t)v];
  } else if constexpr (std::is_same_v<T, uint8_t>) {
    return root[v];
  } else {
    return sqrtf((float)v) * res;
  }
}

// One beam beyond the kMaxPT * 256 held in registers (kMore kernels): its
// hit and mask, which the kernel's functor reads or computes again from
// global memory each evaluation.
struct Hit1 {
  float hx, hy, mux, muy, fm;
  int lx, ly;
};

// The functor of a kernel without extra beams: never called.
struct NoMore {
  __device__ void operator()(int, Hit1&) const {}
};

// The ten block sums of the beams' terms at the hits, in every thread's
// sm, in the order above: each thread reads the
// corners of its beams (all reads issued first) and takes their terms;
// the partners of a logical thread pass theirs through xbuf (a barrier of
// their Q warps); the logical thread adds its PT terms in beam order, its
// warp halves by shuffle-down and lane 0 writes the warp total (warp_buf,
// one block barrier); lanes 0-9 of every warp add one sum's eight totals
// in warp order and a shuffle broadcasts the ten. With kMore (PT = kMaxPT
// and b > 256 * kMaxPT) the logical thread then adds its beams lt + 256 m,
// m >= kMaxPT, in turn, each located by more(i, hit) and its corners read
// there: the order of _block_sum for any b.
template <int PT, typename T, bool kMore = false, typename More = NoMore>
__device__ __forceinline__ void block_sums(
    const T* __restrict__ g, int h, int w,
    const Beams<Shape<PT>::S>& bm, int b, const Hits<Shape<PT>::S>& hit,
    const Consts& k, int robust, const float* root, float* xbuf,
    float (*warp_buf)[kSums], float sm[kSums], const More& more = More{}) {
  using Sh = Shape<PT>;
  const int q = threadIdx.x / kThreads, lt = threadIdx.x % kThreads;
  T cv[Sh::S][4];
#pragma unroll
  for (int j = 0; j < Sh::S; ++j) {
    if (!has_beam<PT>(q + Sh::Q * j, lt, b)) continue;
    const int64_t y0 = clampi(hit.ly[j], 0, h - 1);
    const int64_t y1 = clampi(hit.ly[j] + 1, 0, h - 1);
    const int64_t x0 = clampi(hit.lx[j], 0, w - 1);
    const int64_t x1 = clampi(hit.lx[j] + 1, 0, w - 1);
    cv[j][0] = g[y0 * w + x0];
    cv[j][1] = g[y0 * w + x1];
    cv[j][2] = g[y1 * w + x0];
    cv[j][3] = g[y1 * w + x1];
  }
  // terms[j] = 0 + term: adding that in place of the term gives the same
  // sums (a running sum that starts at +0 is never -0)
  float terms[Sh::S][kSums];
#pragma unroll
  for (int j = 0; j < Sh::S; ++j) {
#pragma unroll
    for (int i = 0; i < kSums; ++i) terms[j][i] = 0.0f;
    if (!has_beam<PT>(q + Sh::Q * j, lt, b)) continue;
    const int lx = hit.lx[j], ly = hit.ly[j];
    const bool inx0 = lx >= 0 && lx < w, inx1 = lx + 1 >= 0 && lx + 1 < w;
    const bool iny0 = ly >= 0 && ly < h, iny1 = ly + 1 >= 0 && ly + 1 < h;
    const float v00 = inx0 && iny0 ? root_of(root, cv[j][0], k.res)
                                   : k.max_dist;
    const float v10 = inx1 && iny0 ? root_of(root, cv[j][1], k.res)
                                   : k.max_dist;
    const float v01 = inx0 && iny1 ? root_of(root, cv[j][2], k.res)
                                   : k.max_dist;
    const float v11 = inx1 && iny1 ? root_of(root, cv[j][3], k.res)
                                   : k.max_dist;
    add_values(v00, v10, v01, v11, hit.mux[j], hit.muy[j], hit.hx[j],
               hit.hy[j], bm.fm[j], k, robust, terms[j]);
  }
  const int lane = threadIdx.x & 31;
  const int warp = lt >> 5;
  if constexpr (Sh::Q > 1) {
    if (q != 0) {
#pragma unroll
      for (int j = 0; j < Sh::S; ++j) {
        const int m = q + Sh::Q * j;
        if (!has_beam<PT>(m, lt, b)) continue;
        float* x = xbuf + xslot<Sh::Q>(m) * kSums * kThreads + lt;
#pragma unroll
        for (int i = 0; i < kSums; ++i) x[i * kThreads] = terms[j][i];
      }
    }
    // the Q warps of logical warp `warp`: warp + 8 q
    asm volatile("bar.sync %0, %1;" ::"r"(1 + warp), "r"(32 * Sh::Q)
                 : "memory");
  }
  if (q == 0) {
    float acc[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int m = 0; m < PT; ++m) {
      if (!has_beam<PT>(m, lt, b)) continue;
      if (m % Sh::Q == 0) {
#pragma unroll
        for (int i = 0; i < kSums; ++i) acc[i] += terms[m / Sh::Q][i];
      } else {
        const float* x = xbuf + xslot<Sh::Q>(m) * kSums * kThreads + lt;
#pragma unroll
        for (int i = 0; i < kSums; ++i) acc[i] += x[i * kThreads];
      }
    }
    if constexpr (kMore) {
      for (int bi = lt + PT * kThreads; bi < b; bi += kThreads) {
        Hit1 e;
        more(bi, e);
        const int64_t y0 = clampi(e.ly, 0, h - 1);
        const int64_t y1 = clampi(e.ly + 1, 0, h - 1);
        const int64_t x0 = clampi(e.lx, 0, w - 1);
        const int64_t x1 = clampi(e.lx + 1, 0, w - 1);
        const T c00 = g[y0 * w + x0], c10 = g[y0 * w + x1];
        const T c01 = g[y1 * w + x0], c11 = g[y1 * w + x1];
        const bool inx0 = e.lx >= 0 && e.lx < w;
        const bool inx1 = e.lx + 1 >= 0 && e.lx + 1 < w;
        const bool iny0 = e.ly >= 0 && e.ly < h;
        const bool iny1 = e.ly + 1 >= 0 && e.ly + 1 < h;
        float t[kSums];
#pragma unroll
        for (int i = 0; i < kSums; ++i) t[i] = 0.0f;
        add_values(inx0 && iny0 ? root_of(root, c00, k.res) : k.max_dist,
                   inx1 && iny0 ? root_of(root, c10, k.res) : k.max_dist,
                   inx0 && iny1 ? root_of(root, c01, k.res) : k.max_dist,
                   inx1 && iny1 ? root_of(root, c11, k.res) : k.max_dist,
                   e.mux, e.muy, e.hx, e.hy, e.fm, k, robust, t);
#pragma unroll
        for (int i = 0; i < kSums; ++i) acc[i] += t[i];
      }
    }
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
  }
  __syncthreads();
  float t = 0.0f;
  if (lane < kSums) {
    t = warp_buf[0][lane];
    for (int j = 1; j < kWarps; ++j) t += warp_buf[j][lane];
  }
#pragma unroll
  for (int i = 0; i < kSums; ++i) sm[i] = __shfl_sync(0xffffffffu, t, i);
}

}  // namespace gn
