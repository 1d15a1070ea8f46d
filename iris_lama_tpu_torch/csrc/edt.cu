// B3: exact capped squared Euclidean distance transform of an obstacle mask.
//
//   g[y, x]   = min{ |dy| : |dy| <= R, obst[y+dy, x] }, or R+1 if none
//   out[y, x] = min( max_sqdist, min_{|dx| <= R} dx^2 + g[y, x+dx]^2 )
//
// bool [p, h, w] -> int32 [p, h, w], one transform per particle (p = 1 is
// the single-grid case); cells outside the grid are not obstacles (the TPU
// version pads with "far" values). Equal, cell for cell, to
// iris_lama_tpu/sdm/distance.py:edt2d, whose vertical pass is a log-doubling
// min-plus erosion capped at R+1.
//
// Replaces iris_lama_tpu/ops/edt_pallas.py:_vertical_kernel (:25) and
// _horizontal_kernel (:37), driven by edt2d_pallas (:52). On the TPU both
// passes were whole-strip shift-and-min rounds in VMEM.
//
// Bound on the H100: the function reads the 1-byte mask and writes the
// 4-byte result once (448 x 448: 1 MB per grid, ~0.3 us at 3.35 TB/s; 30
// particles ~30 MB, ~9 us). It does ~2(2R+1) integer operations per cell
// (R = 10: ~250 M at P = 30), which at the SMs' integer issue rate take
// about as long, so the design keeps instructions per cell low as well as
// bytes: one fused launch, one block of 256 threads per 32 x 64 output
// tile of one particle (blockIdx.z), so the intermediate g never leaves
// the SM:
//   1. the mask tile with its halo (R rows above and below, R rounded up to
//      16 columns left and right) is copied into shared memory once, with
//      16-byte cp.async copies where the width allows (w % 16 == 0), byte
//      loads otherwise; cells outside the grid are written as 0;
//   2. vertical pass in shared memory: each thread sweeps one 4-column word
//      of an 8-row segment down and up, four byte lanes at once in plain
//      32-bit arithmetic (a distance grows by 0x01010101 a row and is
//      cleared on an obstacle byte; no byte exceeds 2R + 9 <= 137 before
//      the bytewise min with R+1 at the segment's rows), and the capped
//      |dy| is stored as uint8 (R + 1 <= 255);
//   3. horizontal pass: each thread takes 8 neighbouring output cells of a
//      row, slides a ring of 8 squared g values in registers over its taps
//      (8 taps a step, each a min of an add per cell) and stores the 8
//      results with two 16-byte stores (scalar at a ragged edge).
// A tap beyond R (an out-of-grid halo column, or a tap of the last step
// beyond 2R+1) never wins: dx^2 >= (R+1)^2 >= g[y, x]^2, the tap dx = 0.
//
// The tile takes R <= kMaxRadius = 64 (its halo and the uint8 |dy|). A
// larger radius (Loc2D's or a fine map's l2_max: R + 1 may pass 255) takes
// two launches chosen by the same call: edt_columns gives each column one
// thread that sweeps it down and up (O(h) a column whatever R), keeping the
// capped |dy| as int32 in a scratch grid the wrapper allocates; edt_rows
// gives each output cell one thread that takes the direct min over its
// 2R + 1 row taps (neighbouring threads read neighbouring g, from L1/L2).
// Bound: the same bytes as the tile (the scratch adds 8 bytes a cell of L2
// traffic), and ~2(2R + 1) integer operations a cell: at R = 100 on 448 x
// 448 ~81 M, ~1.2 us at the card's integer rate.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kSeg = 8;          // output rows per vertical sweep
constexpr int kOct = 8;          // output cells per thread, horizontal
constexpr int kMaxRadius = 64;   // 37,376 bytes of shared memory a block

__host__ __device__ inline int halo_cols(int radius) {
  return (radius + 15) / 16 * 16;
}

// mask tile row, bytes: a multiple of 16
__host__ __device__ inline int mask_stride(int radius) {
  return kTileW + 2 * halo_cols(radius);
}

// g tile row, bytes: the mask row and the up to 8 bytes a thread's last
// step of 8 taps reads beyond it (whatever they hold: a tap beyond R never
// wins), a multiple of 16
__host__ __device__ inline int g_stride(int radius) {
  return mask_stride(radius) + 16;
}

__host__ __device__ inline int edt_smem_bytes(int radius) {
  return (kTileH + 2 * radius) * mask_stride(radius) +
         kTileH * g_stride(radius);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one row of a downward or upward sweep over four columns packed in a
// word: the distance grows by one, and is 0 on an obstacle byte
__device__ __forceinline__ uint32_t sweep(uint32_t d, uint32_t m) {
  return (d + 0x01010101u) & ~(m * 0xFFu);
}

__global__ void __launch_bounds__(kThreads)
    edt_tile(const uint8_t* __restrict__ obst, int h, int w, int radius,
             int max_sqdist, int vec_in, int vec_out,
             int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int hl = halo_cols(radius);
  const int ms_w = mask_stride(radius);
  const int hr = kTileH + 2 * radius;
  const int gs_w = g_stride(radius);
  uint8_t* ms = smem;               // [hr][ms_w] mask tile with its halo
  uint8_t* gs = smem + hr * ms_w;   // [kTileH][gs_w] capped |dy|
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int64_t plane = (int64_t)blockIdx.z * h * w;
  const uint8_t* src = obst + plane;

  // 1. the mask tile (tile row r, column c <-> ms[r + radius][c + hl])
  if (vec_in) {
    // x0 - hl and w are multiples of 16: a span lies wholly in or out
    const int spans = ms_w / 16;
    for (int i = threadIdx.x; i < hr * spans; i += kThreads) {
      const int hy = i / spans;
      const int sx = (i - hy * spans) * 16;
      const int y = y0 - radius + hy;
      const int x = x0 - hl + sx;
      uint8_t* dst = ms + hy * ms_w + sx;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        cp_async16(dst, src + (int64_t)y * w + x);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < hr * ms_w; i += kThreads) {
      const int hy = i / ms_w;
      const int hx = i - hy * ms_w;
      const int y = y0 - radius + hy;
      const int x = x0 - hl + hx;
      ms[i] = (y >= 0 && y < h && x >= 0 && x < w)
                  ? (uint8_t)(src[(int64_t)y * w + x] != 0)
                  : (uint8_t)0;
    }
  }
  __syncthreads();

  // 2. vertical pass: word column wc, output rows r0 .. r0 + kSeg - 1
  {
    const int rs = ms_w / 4;        // mask row stride, words
    const int gw = gs_w / 4;        // g row stride, words
    const uint32_t far = (uint32_t)(radius + 1) * 0x01010101u;
    const uint32_t* mw = reinterpret_cast<const uint32_t*>(ms);
    uint32_t* gwp = reinterpret_cast<uint32_t*>(gs);
    for (int i = threadIdx.x; i < rs * (kTileH / kSeg); i += kThreads) {
      const int wc = i % rs;
      const int r0 = (i / rs) * kSeg;
      const uint32_t* col = mw + wc;
      uint32_t best[kSeg];
      // down: obstacles at dy = -R .. 0 (mask rows r0 .. r0 + R + j)
      uint32_t d = far;
#pragma unroll 4
      for (int hy = r0; hy < r0 + radius; ++hy) d = sweep(d, col[hy * rs]);
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        d = sweep(d, col[(r0 + radius + j) * rs]);
        best[j] = __vminu4(d, far);
      }
      // up: obstacles at dy = 0 .. R
      d = far;
#pragma unroll 4
      for (int hy = r0 + kSeg - 1 + 2 * radius; hy >= r0 + kSeg + radius;
           --hy) {
        d = sweep(d, col[hy * rs]);
      }
#pragma unroll
      for (int j = kSeg - 1; j >= 0; --j) {
        d = sweep(d, col[(r0 + radius + j) * rs]);
        gwp[(r0 + j) * gw + wc] = __vminu4(best[j], d);
      }
    }
  }
  __syncthreads();

  // 3. horizontal pass: output cells x .. x + 7 of tile row r
  const int r = threadIdx.x / (kTileW / kOct);
  const int y = y0 + r;
  const int x = x0 + kOct * (threadIdx.x % (kTileW / kOct));
  if (y >= h || x >= w) return;
  // s[t + j] is the tap dx = t - R of cell x + j
  const uint8_t* s = gs + r * gs_w + hl - radius + (x - x0);
  int b[kOct];
#pragma unroll
  for (int j = 0; j < kOct; ++j) b[j] = max_sqdist;
  int ring[kOct];   // s[t + j]^2 in slot (t + j) % 8
#pragma unroll
  for (int j = 0; j < kOct - 1; ++j) ring[j] = s[j] * s[j];
  for (int t0 = 0; t0 <= 2 * radius; t0 += kOct) {
#pragma unroll
    for (int k = 0; k < kOct; ++k) {
      const int v = s[t0 + k + kOct - 1];
      ring[(k + kOct - 1) % kOct] = v * v;
      const int dx = t0 + k - radius;
      const int dd = dx * dx;
#pragma unroll
      for (int j = 0; j < kOct; ++j) {
        b[j] = min(ring[(k + j) % kOct] + dd, b[j]);
      }
    }
  }
  int32_t* o = out + plane + (int64_t)y * w + x;
  if (vec_out && x + kOct <= w) {
    reinterpret_cast<int4*>(o)[0] = make_int4(b[0], b[1], b[2], b[3]);
    reinterpret_cast<int4*>(o)[1] = make_int4(b[4], b[5], b[6], b[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kOct; ++j) {
      if (x + j < w) o[j] = b[j];
    }
  }
}

// R > kMaxRadius, pass 1: g[p, y, x] = the capped |dy| of column x
__global__ void edt_columns(const uint8_t* __restrict__ obst, int h, int w,
                            int radius, int32_t* __restrict__ g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const int64_t plane = (int64_t)blockIdx.y * h * w;
  const uint8_t* col = obst + plane + x;
  int32_t* gc = g + plane + x;
  const int far = radius + 1;
  int d = far;   // rows since the last obstacle above, capped
#pragma unroll 8
  for (int y = 0; y < h; ++y) {
    d = col[(int64_t)y * w] ? 0 : min(d + 1, far);
    gc[(int64_t)y * w] = d;
  }
  d = far;       // ... below
#pragma unroll 8
  for (int y = h - 1; y >= 0; --y) {
    d = col[(int64_t)y * w] ? 0 : min(d + 1, far);
    gc[(int64_t)y * w] = min(gc[(int64_t)y * w], d);
  }
}

// R > kMaxRadius, pass 2: out[p, y, x] = min(max_sqdist, min over the row
// taps |dx| <= R inside the grid of dx^2 + g^2)
__global__ void edt_rows(const int32_t* __restrict__ g, int h, int w,
                         int radius, int max_sqdist,
                         int32_t* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const int64_t row = ((int64_t)blockIdx.z * h + blockIdx.y) * w;
  const int32_t* gr = g + row;
  const int lo = max(x - radius, 0), hi = min(x + radius, w - 1);
  int best = max_sqdist;
  for (int xx = lo; xx <= hi; ++xx) {
    const int dx = xx - x, gv = gr[xx];
    best = min(best, dx * dx + gv * gv);
  }
  out[row + x] = best;
}

}  // namespace

// g_scratch: an int32 [p, h, w] scratch grid, needed for radius >
// kMaxRadius (may be null otherwise).
extern "C" int edt2d(const uint8_t* obst, int p, int h, int w, int radius,
                     int max_sqdist, int32_t* g_scratch, int32_t* out,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (radius < 0) return (int)cudaErrorInvalidValue;
  if (radius > kMaxRadius) {
    if (g_scratch == nullptr) return (int)cudaErrorInvalidValue;
    if (p > 0 && h > 0 && w > 0) {
      const int threads = 128;
      edt_columns<<<dim3((w + threads - 1) / threads, p), threads, 0, s>>>(
          obst, h, w, radius, g_scratch);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      edt_rows<<<dim3((w + threads - 1) / threads, h, p), threads, 0, s>>>(
          g_scratch, h, w, radius, max_sqdist, out);
    }
    return (int)cudaGetLastError();
  }
  if (p > 0 && h > 0 && w > 0) {
    const int vec_in = w % 16 == 0 && (uintptr_t)obst % 16 == 0;
    const int vec_out = w % 4 == 0 && (uintptr_t)out % 16 == 0;
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, p);
    edt_tile<<<grid, kThreads, edt_smem_bytes(radius), s>>>(
        obst, h, w, radius, max_sqdist, vec_in, vec_out, out);
  }
  return (int)cudaGetLastError();
}
