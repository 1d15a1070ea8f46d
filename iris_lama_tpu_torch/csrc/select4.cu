// B2: the four bilinear corners of a squared-distance grid.
//
//   out[0, i] = grid[y0, x0]   out[1, i] = grid[y0, x1]
//   out[2, i] = grid[y1, x0]   out[3, i] = grid[y1, x1]
//
// with y0 = clip(ly[i], 0, h-1), y1 = clip(ly[i]+1, 0, h-1) and likewise x;
// [h, w] grid of int8, uint8, int16 or int32 (DistanceConfig.sq_dtype: one
// instantiation each, the value widened as its type says — uint8 unsigned,
// the others signed — as the plain version's .to(torch.int32)), int32 [b]
// indices read through their element strides (so lx = loc[:, 0] and ly =
// loc[:, 1] of a [b, 2] tensor are read in place) -> int32 [4, b].
//
// Replaces iris_lama_tpu/ops/select4.py:_kernel (:36), driven by
// _select_batched (:67). The TPU has no fast gather, so the kernel there
// selected rows with an s8 one-hot matrix product on the matrix unit and
// reduced the columns with masks.
//
// Bound on the H100: launch latency. One call moves ~28 bytes per beam
// (8 of indices, 4 grid bytes, 16 of output: ~21 KB for 768 beams, a few
// nanoseconds at 3.35 TB/s); an empty kernel of the same launch shape
// takes ~0.8 us, and what is left is two dependent round trips to L2 (the
// indices, then the grid, 488 x 488 = 238 KB, resident in L2 across the
// IRLS iterations). Design: a plain gather, one thread per beam and four
// int8 loads from the grid; the four stores are coalesced along the beam
// axis. Two variants that shortened the loads — (lx, ly) in one 8-byte
// load and each row's two corners from one 32-bit word, one beam or four
// beams a thread — measured no faster (PERF.md, Findings).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <typename T>
__global__ void select4_kernel(const T* __restrict__ grid, int h, int w,
                               const int32_t* __restrict__ ly, int64_t sly,
                               const int32_t* __restrict__ lx, int64_t slx,
                               int b, int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int y = ly[i * sly];
  const int x = lx[i * slx];
  const int64_t y0 = clampi(y, 0, h - 1), y1 = clampi(y + 1, 0, h - 1);
  const int64_t x0 = clampi(x, 0, w - 1), x1 = clampi(x + 1, 0, w - 1);
  out[i] = grid[y0 * w + x0];
  out[b + i] = grid[y0 * w + x1];
  out[2 * b + i] = grid[y1 * w + x0];
  out[3 * b + i] = grid[y1 * w + x1];
}

template <typename T>
void launch(const void* grid, int h, int w, const int32_t* ly, int64_t sly,
            const int32_t* lx, int64_t slx, int b, int32_t* out,
            cudaStream_t s) {
  const int threads = 256;
  const int blocks = (b + threads - 1) / threads;
  select4_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(grid), h, w, ly, sly, lx, slx, b, out);
}

}  // namespace

// dtype: the grid's element type, 0 int8, 1 uint8, 2 int16, 3 int32
// (gn_common.cuh: SqType); sly, slx: the indices' element strides.
extern "C" int select4_sq(const void* grid, int dtype, int h, int w,
                          const int32_t* ly, int64_t sly, const int32_t* lx,
                          int64_t slx, int b, int32_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b > 0) {
    switch (dtype) {
      case 0: launch<int8_t>(grid, h, w, ly, sly, lx, slx, b, out, s); break;
      case 1: launch<uint8_t>(grid, h, w, ly, sly, lx, slx, b, out, s); break;
      case 2: launch<int16_t>(grid, h, w, ly, sly, lx, slx, b, out, s); break;
      case 3: launch<int32_t>(grid, h, w, ly, sly, lx, slx, b, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
