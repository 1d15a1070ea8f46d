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
// particles ~30 MB, ~9 us); it does ~2(2R+1) compares per cell (R = 10:
// ~8.4 M simple integer ops per grid), far below the card's rate, so it is
// bytes (and, for one grid, launch) bound. Design: two kernels, one thread
// per cell, direct min over the 2R+1 window, the particle in blockIdx.z. The
// vertical pass reads a column window (neighbouring threads hold
// neighbouring x, so each row read is coalesced); the int32 intermediate g
// stays in L2 between the two launches, and the horizontal pass reads a row
// window of it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void edt_vertical(const uint8_t* __restrict__ obst, int h, int w,
                             int radius, int32_t* __restrict__ g) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const int64_t plane = (int64_t)blockIdx.z * h * w;
  obst += plane;
  g += plane;
  int best = radius + 1;
  const int lo = y - radius < 0 ? 0 : y - radius;
  const int hi = y + radius > h - 1 ? h - 1 : y + radius;
  for (int yy = lo; yy <= hi; ++yy) {
    if (obst[(int64_t)yy * w + x]) {
      const int a = yy > y ? yy - y : y - yy;
      best = a < best ? a : best;
    }
  }
  g[(int64_t)y * w + x] = best;
}

__global__ void edt_horizontal(const int32_t* __restrict__ g, int h, int w,
                               int radius, int max_sqdist,
                               int32_t* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const int64_t plane = (int64_t)blockIdx.z * h * w;
  const int32_t* row = g + plane + (int64_t)y * w;
  int best = max_sqdist;
  const int lo = x - radius < 0 ? 0 : x - radius;
  const int hi = x + radius > w - 1 ? w - 1 : x + radius;
  for (int xx = lo; xx <= hi; ++xx) {
    const int dx = xx - x;
    const int gv = row[xx];
    const int v = dx * dx + gv * gv;
    best = v < best ? v : best;
  }
  out[plane + (int64_t)y * w + x] = best;
}

}  // namespace

extern "C" int edt2d(const uint8_t* obst, int p, int h, int w, int radius,
                     int max_sqdist, int32_t* g_scratch, int32_t* out,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p > 0 && h > 0 && w > 0) {
    const int threads = 128;
    const dim3 grid((w + threads - 1) / threads, h, p);
    edt_vertical<<<grid, threads, 0, s>>>(obst, h, w, radius, g_scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    edt_horizontal<<<grid, threads, 0, s>>>(g_scratch, h, w, radius,
                                            max_sqdist, out);
  }
  return (int)cudaGetLastError();
}
