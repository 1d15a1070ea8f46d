// B1: unit-count deposit of the raycast (free-space cells and hit endpoints).
//
//   counts[q, y, x] = #{ t : (ly[q, t], lx[q, t]) == (y, x) },   int32 [p, h, w]
//
// for p particles of n elements each (p = 1 is the single-grid case).
// Elements outside [0, h) x [0, w) count nothing (callers route masked-out
// cells to the sentinel row ly == h); an element of particle q only ever
// touches grid q.
//
// Replaces iris_lama_tpu/ops/scatter_matmul.py:_kernel_band (:81) and the
// full-height _kernel (:55), driven by _scatter_batched (:118) and, for a
// particle batch, the vmap rule of scatter_counts_2d (:228). On the TPU the
// deposit was a one-hot contraction on the matrix unit over an 8-aligned
// row band per 4096-element chunk, exact only for beam-major input (with an
// XLA scatter fix-up for out-of-band elements).
//
// Bound on the H100: memory and atomics. The function reads 8 bytes of
// indices per element and writes the 4-byte count grids once (Slam2D: one
// grid of 448 x 448 from 155,136 elements, ~2 MB; PFSlam2D: 30 such grids,
// ~61 MB, ~18 us at 3.35 TB/s). Design: the grids are zeroed with
// cudaMemsetAsync, then a grid-stride loop gives each element one thread that
// does one 32-bit atomicAdd into its particle's grid (0.8 MB each, in L2).
// Integer atomics are exact in any order, so the result is bit-exact for any
// input order (no band precondition).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void deposit_kernel(const int32_t* __restrict__ ly,
                               const int32_t* __restrict__ lx, int64_t n,
                               int64_t total, int h, int w,
                               int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t plane = (int64_t)h * w;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int y = ly[t];
    const int x = lx[t];
    if (y >= 0 && y < h && x >= 0 && x < w) {
      atomicAdd(out + (t / n) * plane + (int64_t)y * w + x, 1);
    }
  }
}

}  // namespace

extern "C" int deposit_counts(const int32_t* ly, const int32_t* lx,
                              int64_t n, int p, int h, int w, int32_t* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int32_t) * (size_t)p * (size_t)h * (size_t)w, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = n * (int64_t)p;
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
    deposit_kernel<<<(unsigned)blocks, threads, 0, s>>>(ly, lx, n, total, h,
                                                        w, out);
  }
  return (int)cudaGetLastError();
}
