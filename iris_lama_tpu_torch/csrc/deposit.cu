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
//
// Two more entry points, the same memset + one int32 atomicAdd per element
// into one grid [h, w] (bound: 12 bytes read per element and the 4-byte grid
// written once — the Slam2D deposit's ~21 k elements into [448, 512], ~1.2
// MB, ~0.35 us at 3.35 TB/s; the launch dominates at that size):
//
// B7 scatter_add_2d: out[ly[t], lx[t]] += val[t] for int32 streams.
// Replaces iris_lama_tpu/ops/scatter_pallas.py:_scatter_kernel (:28),
// driven by scatter_add_2d (:71), which streamed the indices through SMEM
// and did one aligned (8, 128) tile read-modify-write per element in VMEM.
//
// B8 scatter_add_sorted: packed words
//   tile_y << 20 | tile_x << 11 | (y % 8) << 8 | (x % 128) << 1 | v
// each add v (0 or 1) at (tile_y * 8 + y % 8, tile_x * 128 + x % 128).
// Replaces iris_lama_tpu/ops/scatter_sorted.py:_kernel (:47), driven by
// scatter_add_sorted (:119), which accumulated an (8, 128) tile in a
// register while the sorted words stayed in one tile and flushed it once
// per tile change. The sort and the flush were TPU scheduling: one atomic
// per word is exact for any order, so this kernel needs neither.
//
// Both take in-grid indices (as the JAX functions require); an element
// outside the grid is dropped rather than written out of bounds.

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

__global__ void scatter_values_kernel(const int32_t* __restrict__ ly,
                                      const int32_t* __restrict__ lx,
                                      const int32_t* __restrict__ val,
                                      int64_t n, int h, int w,
                                      int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const int y = ly[t];
    const int x = lx[t];
    if (y >= 0 && y < h && x >= 0 && x < w) {
      atomicAdd(out + (int64_t)y * w + x, val[t]);
    }
  }
}

__global__ void scatter_packed_kernel(const int32_t* __restrict__ packed,
                                      int64_t n, int h, int w,
                                      int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const int32_t word = packed[t];
    const int v = word & 1;
    // arithmetic shift, as the TPU kernel's tile_code >> 9
    const int y = (word >> 20) * 8 + ((word >> 8) & 7);
    const int x = ((word >> 11) & 511) * 128 + ((word >> 1) & 127);
    if (v && y >= 0 && y < h && x >= 0 && x < w) {
      atomicAdd(out + (int64_t)y * w + x, v);
    }
  }
}

unsigned blocks_for(int64_t n) {
  const int64_t blocks = (n + 255) / 256;
  return (unsigned)(blocks > 132 * 32 ? 132 * 32 : blocks);
}

}  // namespace

extern "C" int scatter_add_2d(const int32_t* ly, const int32_t* lx,
                              const int32_t* val, int64_t n, int h, int w,
                              int32_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int32_t) * (size_t)h * (size_t)w, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    scatter_values_kernel<<<blocks_for(n), 256, 0, s>>>(ly, lx, val, n, h, w,
                                                        out);
  }
  return (int)cudaGetLastError();
}

extern "C" int scatter_add_sorted(const int32_t* packed, int64_t n, int h,
                                  int w, int32_t* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int32_t) * (size_t)h * (size_t)w, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    scatter_packed_kernel<<<blocks_for(n), 256, 0, s>>>(packed, n, h, w, out);
  }
  return (int)cudaGetLastError();
}

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
