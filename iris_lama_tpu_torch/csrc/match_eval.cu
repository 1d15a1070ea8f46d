// B5: one fused Gauss-Newton evaluation — the ten normal-equation sums of
// each particle's scan on its squared-distance window.
//
// For each particle p: a squared-distance window grid[p] [h, w] (int8,
// uint8, int16 or int32: one instantiation each) and, per beam i < b,
// the window-local cell (ly, lx)[p, i], its fractions (mux, muy), the hit
// (hx, hy) and the mask fm. out [p_n, 10]: a00 a01 a02 a11 a12 a22 g0 g1 g2
// chi2 of A = Jw'Jw, g = Jw'rw, chi2 = rw'rw (robust = 0: unit weights).
// Each of the seven beam operands is read through its own element strides
// (along particles, along beams), so views such as loc[..., 1] of a
// [p, b, 2] tensor, and expanded operands (stride 0), are read in place.
//
// Replaces iris_lama_tpu/ops/match_eval.py:_kernel (:122), driven by
// _eval_batched (:163): one Pallas program per particle with a one-hot
// matrix-unit corner selection and the ten reductions in VMEM.
//
// Bound on the H100: the function reads the scan's seven [b] operands and
// at most four grid bytes per beam (Loc2D: 768 beams, ~25 KB with the
// corners, ~0.01 us at 3.35 TB/s) and does ~60 flops per beam: no launch
// can reach that, and what is left is one chain of dependent steps —
// operand loads, corner loads, the per-beam IEEE arithmetic, the block
// sums. Design: the evaluation of the whole-solve kernels B4/B6
// (gn_common.cuh:block_sums), so the chain is theirs: one block of
// 256 * Q threads per particle (768 at 768 beams: one beam a thread, Q
// threads sharing each summation lane of the fixed order through the
// exchange buffer in dynamic shared memory), every operand and corner read
// issued before its use, each corner's distance from a 256-entry table,
// and lanes 0-9 of every warp adding one sum's warp totals; threads 0-9
// then write the ten sums. Up to 2048 beams (gn::kMaxPT = 8 a lane) in
// registers; beyond that each summing thread reads its further beams'
// operands from global memory in turn (the kMore instantiation).
// Built with -fmad=false, so that _eval_math with the block-order sum
// (ops/match_eval.py:gn_eval_sq_plain) is its bit-equal plain version.

#include "gn_common.cuh"

namespace {

using gn::Hit1;
using gn::kMaxPT;
using gn::kSums;
using gn::kThreads;
using gn::kWarps;

// a beam operand [p_n, b] read through its element strides
template <typename T>
struct Operand {
  const T* ptr;
  int64_t sp, sb;   // along particles, along beams
  __device__ __forceinline__ T at(int p, int i) const {
    return ptr[p * sp + i * sb];
  }
};

struct BeamOps {
  Operand<int32_t> ly, lx;
  Operand<float> mux, muy, hx, hy, fm;
  int b;
};

// The beams beyond the register-held ones (kMore): beam i of particle p,
// read from its operands.
struct OpsMore {
  BeamOps op;
  int p;
  __device__ __forceinline__ void operator()(int i, Hit1& e) const {
    e.ly = op.ly.at(p, i);
    e.lx = op.lx.at(p, i);
    e.mux = op.mux.at(p, i);
    e.muy = op.muy.at(p, i);
    e.hx = op.hx.at(p, i);
    e.hy = op.hy.at(p, i);
    e.fm = op.fm.at(p, i);
  }
};

// The evaluation of particle blockIdx.x by Shape<PT>::NT threads; dynamic
// shared memory: the exchange buffer (Shape<PT>::kXBytes).
template <typename T, int PT, bool kMore>
__global__ void __launch_bounds__(gn::Shape<PT>::NT)
    gn_eval_kernel(const T* __restrict__ grid, int h, int w,
                   BeamOps op, gn::Consts k, float* __restrict__ out) {
  using Sh = gn::Shape<PT>;
  extern __shared__ __align__(16) int8_t dyn[];
  __shared__ float warp_buf[kWarps][kSums];
  __shared__ float root[256];
  gn::fill_root<T>(root, k.res);
  const int p = blockIdx.x;
  const int q = threadIdx.x / kThreads, lt = threadIdx.x % kThreads;
  const int b = op.b;
  gn::Beams<Sh::S> bm;   // only the masks: the hits come as operands
  gn::Hits<Sh::S> hit;
#pragma unroll
  for (int j = 0; j < Sh::S; ++j) {
    const int m = q + Sh::Q * j;
    if (!gn::has_beam<PT>(m, lt, b)) continue;
    const int i = lt + m * kThreads;
    hit.ly[j] = op.ly.at(p, i);
    hit.lx[j] = op.lx.at(p, i);
    hit.mux[j] = op.mux.at(p, i);
    hit.muy[j] = op.muy.at(p, i);
    hit.hx[j] = op.hx.at(p, i);
    hit.hy[j] = op.hy.at(p, i);
    bm.fm[j] = op.fm.at(p, i);
  }
  __syncthreads();   // the root table is filled
  float sm[kSums];
  gn::block_sums<PT, T, kMore>(grid + (int64_t)p * h * w, h, w, bm, b, hit,
                               k, k.robust, root,
                               reinterpret_cast<float*>(dyn), warp_buf, sm,
                               OpsMore{op, p});
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    if (threadIdx.x == i) out[p * kSums + i] = sm[i];
  }
}

template <typename T, int PT, bool kMore>
int launch(const void* grid, int p_n, int h, int w, const BeamOps& op,
           const gn::Consts& k, float* out, cudaStream_t s) {
  using Sh = gn::Shape<PT>;
  const auto kern = gn_eval_kernel<T, PT, kMore>;
  if constexpr (Sh::kXBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kXBytes);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<p_n, Sh::NT, Sh::kXBytes, s>>>(static_cast<const T*>(grid), h, w,
                                         op, k, out);
  return (int)cudaGetLastError();
}

// the instantiation for PT beams per logical thread (pt > kMaxPT: kMaxPT
// with the further beams read from global memory)
template <typename T, int PT>
int dispatch(int pt, const void* grid, int p_n, int h, int w,
             const BeamOps& op, const gn::Consts& k, float* out,
             cudaStream_t s) {
  if constexpr (PT < kMaxPT) {
    if (pt > PT) {
      return dispatch<T, PT + 1>(pt, grid, p_n, h, w, op, k, out, s);
    }
  } else {
    if (pt > PT) return launch<T, PT, true>(grid, p_n, h, w, op, k, out, s);
  }
  return launch<T, PT, false>(grid, p_n, h, w, op, k, out, s);
}

}  // namespace

// dtype: gn::SqType of the windows; strides: a host array of the 14
// element strides (along particles, along beams) of ly, lx, mux, muy, hx,
// hy, fm in turn; any b >= 0.
extern "C" int gn_eval_sq(const void* grid, int dtype, int p_n, int h, int w,
                          const int32_t* ly, const int32_t* lx,
                          const float* mux, const float* muy,
                          const float* hx, const float* hy, const float* fm,
                          const int64_t* strides, int b, float max_dist,
                          float res, float scale, float cinv, int robust,
                          float* out, void* stream) {
  const int pt = b > 0 ? (b + kThreads - 1) / kThreads : 1;
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  if (p_n <= 0) return (int)cudaGetLastError();
  const int64_t* st = strides;
  const BeamOps op{{ly, st[0], st[1]},   {lx, st[2], st[3]},
                   {mux, st[4], st[5]},  {muy, st[6], st[7]},
                   {hx, st[8], st[9]},   {hy, st[10], st[11]},
                   {fm, st[12], st[13]}, b};
  const gn::Consts k{max_dist, res, scale, cinv, 0.0f, 0.0f, robust, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gn::kI8:
      return dispatch<int8_t, 1>(pt, grid, p_n, h, w, op, k, out, s);
    case gn::kU8:
      return dispatch<uint8_t, 1>(pt, grid, p_n, h, w, op, k, out, s);
    case gn::kI16:
      return dispatch<int16_t, 1>(pt, grid, p_n, h, w, op, k, out, s);
    case gn::kI32:
      return dispatch<int32_t, 1>(pt, grid, p_n, h, w, op, k, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
