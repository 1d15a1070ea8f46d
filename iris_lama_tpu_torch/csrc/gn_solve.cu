// B4 and B6: the whole Gauss-Newton IRLS scan match of each particle in
// one launch, each particle with its own scan (B4, Loc2D) or one scan
// shared by all (B6, PFSlam2D: ops/gn_batch.py launches this entry point
// with scan_stride 0).
//
// For each particle p: a squared-distance window grid[p] [h, w] (int8,
// uint8, int16 or int32: one instantiation each) whose
// cell (0, 0) is org[p] (cell coords [x, y]), a start state st0[p] (tx, ty,
// cos, sin) and the scan (points [b, 2], bool mask [b]) at beam offset
// p * scan_stride (scan_stride = b: one scan per particle; 0: one shared
// scan).
// The IRLS loop of the reference (solver.cpp:53-118 /
// gauss_newton.cpp:53-91):
//
//   sums  = ten normal-equation sums at the state (A 6, g 3, chi2)
//   loop while not stopped and it < max_iter:
//     gn_step says converged                         -> stop, it unchanged
//     cand = exp(h) * state; it += 1
//     chi2(cand) < chi2 -> keep cand and its sums; else revert and stop
//   sum_d2 = chi2 at the final state with unit weights (want_lik)
//
// out [8, p_n] rows: tx ty cos sin chi2 iterations sum_d2 0.
//
// Replaces iris_lama_tpu/ops/gn_solve.py:_kernel (:104), driven by
// _solve_batched (:226): one Pallas program per particle (grid=(P,)) with
// the particle's s8 window resident in VMEM, a lax.while_loop over its
// iterations and a one-hot matrix-unit corner selection per evaluation.
// B6 replaces iris_lama_tpu/ops/gn_batch.py:_kernel (:108), driven by
// _solve_batched (:296): all particles in one Pallas program with
// per-particle pl.when guards; here a stopped particle's block simply ends.
// Its WAYS/BSPLIT interleave and VMEM grouping are TPU scheduling and have
// no counterpart.
//
// Bound on the H100: the function must read each window once (Loc2D: one
// 576 x 576 window, 332 KB, ~0.1 us at 3.35 TB/s; PFSlam2D: 30 x 432 x
// 432 bytes = 5.6 MB, ~1.7 us) and the scan (768 beams, 9 KB); its
// arithmetic (~60 flops per beam and evaluation) is far below the card's
// rate. The solve is a chain of dependent evaluations — each a gather of
// four grid bytes per beam, a block reduction and a scalar step — so it is
// latency bound, and at P = 1 one block runs on one of 132 SMs. Design:
// one block per particle, which loops over its own iterations (a stopped
// particle frees its SM), shortening the chain:
//   - the sums keep the order of gn_common.cuh, whose 256 "logical"
//     threads each add PT = ceil(b / 256) beams in turn (up to 8), but Q =
//     min(PT, 4) threads share each logical thread's beams (256 Q
//     threads: one beam each at the 768 beams of a 720-beam scan), so a
//     beam's arithmetic runs in parallel with its logical thread's others;
//     a partner passes its terms through shared memory (a barrier of the
//     Q warps concerned), and the logical thread adds the PT terms in beam
//     order;
//   - each thread keeps the point and mask of its beams in registers for
//     the whole solve (read from the caller's points and bool mask as they
//     are);
//   - where the window fits beside the exchange buffer (the PF's int8 or
//     uint8 432 x 432 at 768 beams; see kDynSmem), the block copies it into
//     shared memory
//     once (16-byte cp.async with a byte head and tail, overlapped with the
//     scan load and the first transform), so every corner read is a
//     shared-memory read; a larger window (Loc2D's 576 x 576) is read from
//     global memory (L2);
//   - a thread issues the corner reads of its beams before it uses them,
//     and takes each corner's distance sqrtf(v) * res from a 256-entry
//     table the block fills once for one-byte windows (the same float
//     operations; int16 and int32 windows compute it);
//   - beyond 256 * kMaxPT = 2048 beams (the kMore instantiation of PT =
//     kMaxPT), each summing thread adds its further beams lt + 256 m in
//     turn after its register-held ones, reading each beam's point and
//     mask again from global memory at every evaluation;
//   - each warp's total goes to a double-buffered shared array and lanes
//     0-9 of every warp add one sum's eight totals in warp order, broadcast
//     by shuffle: every thread holds the ten sums and runs the scalar step
//     on them itself (the same instructions on the same inputs, so every
//     thread takes the same decision) — one block barrier per evaluation,
//     no serial tail on thread 0.
// Built with -fmad=false; the plain version (ops/gn_solve.py) sums in this
// kernel's order, so on the card the two agree bit for bit.

#include "gn_common.cuh"

namespace {

using gn::Beams;
using gn::Hit1;
using gn::Hits;
using gn::Shape;
using gn::has_beam;
using gn::kMaxPT;
using gn::kSums;
using gn::kThreads;
using gn::kWarps;

// dynamic shared memory a block may take beside its 1,664 static bytes
// (the 232,448 bytes an H100 block may opt in to)
constexpr int kDynSmem = 232448 - 1664;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The scalar step of one IRLS iteration at sums sm and state st: false
// when |g|_inf < eps1 or |h|_inf < eps2 (h = -A^-1 g: converged before the
// step), else true with cand = exp(h) * st.
__device__ bool gn_step(const float sm[kSums], const float st[4],
                        const gn::Consts& k, float cand[4]) {
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

// lie.se2_apply + geometry.w2m_frac (floor + integer offset) of one beam
// (x, y) at state st, in window cells of the window at (org_x, org_y)
__device__ __forceinline__ void locate1(float x, float y, const float st[4],
                                        const gn::Consts& k, int org_x,
                                        int org_y, float& hx, float& hy,
                                        float& mux, float& muy, int& lx,
                                        int& ly) {
  const float tx = st[0], ty = st[1], c = st[2], s = st[3];
  hx = tx + c * x - s * y;
  hy = ty + s * x + c * y;
  const float mfx = hx * k.scale;
  const float mfy = hy * k.scale;
  const float flx = floorf(mfx);
  const float fly = floorf(mfy);
  lx = (int)flx + k.cell_offset - org_x;
  ly = (int)fly + k.cell_offset - org_y;
  mux = mfx - flx;
  muy = mfy - fly;
}

// locate1 of this thread's register-held beams
template <int PT>
__device__ __forceinline__ void locate(const Beams<Shape<PT>::S>& bm, int b,
                                       const float st[4], const gn::Consts& k,
                                       int org_x, int org_y,
                                       Hits<Shape<PT>::S>& hit) {
  using Sh = Shape<PT>;
  const int q = threadIdx.x / kThreads, lt = threadIdx.x % kThreads;
#pragma unroll
  for (int j = 0; j < Sh::S; ++j) {
    if (!has_beam<PT>(q + Sh::Q * j, lt, b)) continue;
    locate1(bm.px[j], bm.py[j], st, k, org_x, org_y, hit.hx[j], hit.hy[j],
            hit.mux[j], hit.muy[j], hit.lx[j], hit.ly[j]);
  }
}

// The beams beyond the register-held ones (kMore): beam i of the scan at
// beam offset so, read from global memory and located at the state (st0..
// st3, held by value).
struct ScanMore {
  const float* xy;
  const uint8_t* mask;
  int64_t so;
  float st[4];
  gn::Consts k;
  int org_x, org_y;
  __device__ __forceinline__ void operator()(int i, Hit1& e) const {
    const int64_t gi = so + i;
    e.fm = mask[gi] ? 1.0f : 0.0f;
    locate1(xy[2 * gi], xy[2 * gi + 1], st, k, org_x, org_y, e.hx, e.hy,
            e.mux, e.muy, e.lx, e.ly);
  }
};

// The whole IRLS solve of particle blockIdx.x by Shape<PT>::NT threads.
// Dynamic shared memory: the exchange buffer (kXBytes), then, kStaged, the
// window (h * w * sizeof(T) + 16 bytes).
template <typename T, int PT, bool kStaged, bool kMore>
__global__ void __launch_bounds__(Shape<PT>::NT)
    gn_solve_kernel(const T* __restrict__ grid, int h, int w,
                    const int32_t* __restrict__ org,
                    const float* __restrict__ st0, gn::Scan scan,
                    int64_t scan_stride, gn::Consts k, int max_iter,
                    int want_lik, int p_n, float* __restrict__ out) {
  using Sh = Shape<PT>;
  extern __shared__ __align__(16) int8_t dyn[];
  // warp totals, double-buffered: evaluation e writes buffer e & 1, so one
  // block barrier per evaluation suffices (a warp can be at most one
  // evaluation ahead of a warp still reading)
  __shared__ float warp_buf[2][kWarps][kSums];
  __shared__ float root[256];
  float* xbuf = reinterpret_cast<float*>(dyn);
  gn::fill_root<T>(root, k.res);
  const int p = blockIdx.x;
  const int64_t n = (int64_t)h * w;
  const T* g = grid + p * n;
  const T* gw = g;
  if (kStaged) {
    // the window's n * sizeof(T) bytes; win + off + i has the alignment of
    // gb + i modulo 16
    const int8_t* gb = reinterpret_cast<const int8_t*>(g);
    const int64_t nb = n * (int64_t)sizeof(T);
    int8_t* win = dyn + Sh::kXBytes;
    const int off = (int)(((uintptr_t)gb - __cvta_generic_to_shared(win)) &
                          15);
    int8_t* dst = win + off;
    const int64_t lead = (16 - ((uintptr_t)gb & 15)) & 15;
    const int head = (int)(nb < lead ? nb : lead);
    const int64_t chunks = (nb - head) / 16;
    for (int64_t c = threadIdx.x; c < chunks; c += Sh::NT) {
      cp_async16(dst + head + 16 * c, gb + head + 16 * c);
    }
    for (int64_t i = threadIdx.x; i < head; i += Sh::NT) dst[i] = gb[i];
    for (int64_t i = head + 16 * chunks + threadIdx.x; i < nb;
         i += Sh::NT) {
      dst[i] = gb[i];
    }
    gw = reinterpret_cast<const T*>(dst);
  }

  const int q = threadIdx.x / kThreads, lt = threadIdx.x % kThreads;
  const int64_t so = p * scan_stride;
  const int b = scan.b;
  Beams<Sh::S> bm;
#pragma unroll
  for (int j = 0; j < Sh::S; ++j) {
    const int m = q + Sh::Q * j;
    if (!has_beam<PT>(m, lt, b)) continue;
    const int64_t i = so + lt + m * kThreads;
    bm.px[j] = scan.xy[2 * i];
    bm.py[j] = scan.xy[2 * i + 1];
    bm.fm[j] = scan.mask[i] ? 1.0f : 0.0f;
  }
  const int org_x = org[2 * p], org_y = org[2 * p + 1];
  float st[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) st[i] = st0[4 * p + i];
  Hits<Sh::S> hit;
  locate<PT>(bm, b, st, k, org_x, org_y, hit);
  if (kStaged) cp_async_wait_all();
  __syncthreads();

  // the beams beyond the register-held ones, located at state s
  auto more = [=](const float s[4]) {
    return ScanMore{scan.xy, scan.mask, so, {s[0], s[1], s[2], s[3]}, k,
                    org_x, org_y};
  };
  // every thread holds the solver's state and takes the same decisions
  float sm[kSums];
  int e = 0;   // evaluations so far: picks warp_buf's buffer
  gn::block_sums<PT, T, kMore>(gw, h, w, bm, b, hit, k, k.robust, root,
                               xbuf, warp_buf[e++ & 1], sm, more(st));
  int it = 0;
  while (it < max_iter) {
    float cand[4];
    if (!gn_step(sm, st, k, cand)) break;   // converged: it unchanged
    float cs[kSums];
    locate<PT>(bm, b, cand, k, org_x, org_y, hit);
    gn::block_sums<PT, T, kMore>(gw, h, w, bm, b, hit, k, k.robust, root,
                                 xbuf, warp_buf[e++ & 1], cs, more(cand));
    it += 1;
    if (!(sm[9] - cs[9] > 0.0f)) break;     // invalid step: revert, stop
#pragma unroll
    for (int i = 0; i < 4; ++i) st[i] = cand[i];
#pragma unroll
    for (int i = 0; i < kSums; ++i) sm[i] = cs[i];
  }

  float sum_d2 = 0.0f;
  if (want_lik) {
    float ls[kSums];
    locate<PT>(bm, b, st, k, org_x, org_y, hit);
    gn::block_sums<PT, T, kMore>(gw, h, w, bm, b, hit, k, 0, root, xbuf,
                                 warp_buf[e++ & 1], ls, more(st));
    sum_d2 = ls[9];
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

struct Args {
  const void* grid;
  int p_n, h, w;
  const int32_t* org;
  const float* st0;
  gn::Scan scan;
  int64_t scan_stride;
  gn::Consts k;
  int max_iter, want_lik;
  float* out;
  cudaStream_t stream;
};

template <typename T, int PT, bool kStaged, bool kMore>
int launch(const Args& a) {
  using Sh = Shape<PT>;
  const auto kern = gn_solve_kernel<T, PT, kStaged, kMore>;
  const int64_t smem =
      Sh::kXBytes +
      (kStaged ? (int64_t)a.h * a.w * (int64_t)sizeof(T) + 16 : 0);
  if (smem > kDynSmem) return (int)cudaErrorInvalidValue;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.p_n, Sh::NT, smem, a.stream>>>(
      static_cast<const T*>(a.grid), a.h, a.w, a.org, a.st0, a.scan,
      a.scan_stride, a.k, a.max_iter, a.want_lik, a.p_n, a.out);
  return (int)cudaGetLastError();
}

// the instantiation for PT beams per logical thread (pt > kMaxPT: kMaxPT
// with the further beams read from global memory)
template <typename T, int PT>
int dispatch(const Args& a, int pt, int staged) {
  if constexpr (PT < kMaxPT) {
    if (pt > PT) return dispatch<T, PT + 1>(a, pt, staged);
  } else {
    if (pt > PT) {
      return staged ? launch<T, PT, true, true>(a)
                    : launch<T, PT, false, true>(a);
    }
  }
  return staged ? launch<T, PT, true, false>(a)
                : launch<T, PT, false, false>(a);
}

}  // namespace

// dtype: gn::SqType of the windows; staged = 1 copies each window into
// shared memory (the exchange buffer and h * w * sizeof(T) + 16 bytes
// within kDynSmem), 0 reads it from global memory; any b >= 0.
extern "C" int gn_solve_batched(const void* grid, int dtype, int p_n, int h,
                                int w, const int32_t* org, const float* st0,
                                const float* xy, const uint8_t* mask, int b,
                                int64_t scan_stride,
                                float max_dist, float res, float scale,
                                float cinv, int robust, float eps1,
                                float eps2, int cell_offset, int max_iter,
                                int want_lik, int staged, float* out,
                                void* stream) {
  const int pt = b > 0 ? (b + kThreads - 1) / kThreads : 1;
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  if (p_n <= 0) return (int)cudaGetLastError();
  const Args a{grid, p_n, h, w, org, st0, gn::Scan{xy, mask, b},
               scan_stride, gn::Consts{max_dist, res, scale, cinv, eps1,
                                       eps2, robust, cell_offset},
               max_iter, want_lik, out, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case gn::kI8: return dispatch<int8_t, 1>(a, pt, staged);
    case gn::kU8: return dispatch<uint8_t, 1>(a, pt, staged);
    case gn::kI16: return dispatch<int16_t, 1>(a, pt, staged);
    case gn::kI32: return dispatch<int32_t, 1>(a, pt, staged);
    default: return (int)cudaErrorInvalidValue;
  }
}
