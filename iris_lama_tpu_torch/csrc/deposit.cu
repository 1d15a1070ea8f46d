// B1: unit-count deposit of the raycast (free-space cells and hit endpoints).
//
//   counts[q, y, x] = #{ t : (ly[q, t], lx[q, t]) == (y, x) },   int32 [p, h, w]
//
// for p particles of n elements each (p = 1 is the single-grid case).
// Elements outside [0, h) x [0, w) count nothing (callers route masked-out
// cells to the sentinel row ly == h); an element of particle q only ever
// touches grid q. deposit_pair does a scan's two deposits in one launch:
// occ[q] = counts of the hit stream and vis[q] = occ[q] + counts of the
// free-space stream, into out [2, p, h, w].
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
// ~61 MB, ~18 us at 3.35 TB/s; the pair writes twice the grids). At P = 1
// the launches dominate: a memset and an empty kernel take ~2.3 us, the
// loads ~0.4 us and the atomics ~0.3 us more (PERF.md). Design:
//   - one cudaMemsetAsync zeroes every grid of the call, then one launch
//     takes every stream of the call (the pair: the hits into occ and vis,
//     the free cells into vis), so a scan's deposits are two launches, not
//     five (two memsets, two kernels and an add);
//   - each block takes 512 consecutive elements of one stream and
//     particle (blockIdx.y), each thread 2 of them, 256 apart so that every
//     load instruction of a warp reads 128 contiguous bytes; a thread issues
//     its 4 index loads before its first atomic (a grid-stride loop of one
//     element a thread has 2 in flight), and nothing divides by 64 bits.
//     Of 1, 2, 4 and 8 elements a thread, 2 measured fastest at P = 30 and
//     tied 1 at P = 1 (PERF.md, Findings);
//   - each element in the grid adds 1 with one atomicAdd, whose result is
//     unused (a fire-and-forget reduction in L2). Integer atomics are exact
//     in any order, so the result is bit-exact for any input order (no band
//     precondition).
// A variant in which a warp walked 32 adjacent rays step by step and merged
// the lanes holding one cell with __match_any_sync before one atomic was
// measured slower on the H100 (the match costs ~0.25 us a step; PERF.md,
// Findings) and is not kept.

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

constexpr int kThreads = 256;
constexpr int kPer = 2;                        // elements a thread
constexpr int kBlockElems = kThreads * kPer;   // elements a block

// One index stream of a call: n elements a particle (ly, lx at particle
// offset p * n) in `blocks` blocks, added to out_a and, where set, out_b.
struct Stream {
  const int32_t* ly;
  const int32_t* lx;
  int n, blocks;
  int32_t* out_a;
  int32_t* out_b;
};

// block blk of stream s for particle p: elements blk * 512 + t + 256 j
__device__ __forceinline__ void deposit_block(const Stream s, int blk, int p,
                                              int h, int w) {
  const int64_t pb = (int64_t)p * s.n;
  const int64_t plane = (int64_t)p * h * w;
  const int e0 = blk * kBlockElems + threadIdx.x;
  int ys[kPer], xs[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = e0 + kThreads * j;
    const bool ok = e < s.n;
    ys[j] = ok ? s.ly[pb + e] : -1;
    xs[j] = ok ? s.lx[pb + e] : -1;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if ((unsigned)ys[j] < (unsigned)h && (unsigned)xs[j] < (unsigned)w) {
      const int64_t c = plane + ys[j] * w + xs[j];
      atomicAdd(s.out_a + c, 1);
      if (s.out_b != nullptr) atomicAdd(s.out_b + c, 1);
    }
  }
}

// block blockIdx.x of stream a, then of stream b, for particle blockIdx.y
__global__ void __launch_bounds__(kThreads)
    deposit_kernel(Stream a, Stream b, int h, int w) {
  const int blk = blockIdx.x;
  if (blk < a.blocks) {
    deposit_block(a, blk, blockIdx.y, h, w);
  } else {
    deposit_block(b, blk - a.blocks, blockIdx.y, h, w);
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

Stream make_stream(const int32_t* ly, const int32_t* lx, int64_t n,
                   int32_t* out_a, int32_t* out_b) {
  const int blocks = n > 0 ? (int)((n + kBlockElems - 1) / kBlockElems) : 0;
  return Stream{ly, lx, (int)n, blocks, out_a, out_b};
}

int launch_deposit(const Stream& a, const Stream& b, int p, int h, int w,
                   int32_t* out, int64_t grids, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int32_t) * (size_t)grids * (size_t)h * (size_t)w, st);
  if (err != cudaSuccess) return (int)err;
  const int blocks = a.blocks + b.blocks;
  if (blocks > 0 && p > 0) {
    deposit_kernel<<<dim3(blocks, p), kThreads, 0, st>>>(a, b, h, w);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// n < 2^31 elements a particle; out [p, h, w].
extern "C" int deposit_counts(const int32_t* ly, const int32_t* lx,
                              int64_t n, int p, int h, int w, int32_t* out,
                              void* stream) {
  const Stream none{nullptr, nullptr, 0, 0, nullptr, nullptr};
  return launch_deposit(none, make_stream(ly, lx, n, out, nullptr), p, h, w,
                        out, p, static_cast<cudaStream_t>(stream));
}

// the hit stream (nh a particle) into occ = out[0] and vis = out[1], the
// free-space stream (nf a particle) into vis; out [2, p, h, w].
extern "C" int deposit_pair(const int32_t* hly, const int32_t* hlx,
                            int64_t nh, const int32_t* fly,
                            const int32_t* flx, int64_t nf, int p, int h,
                            int w, int32_t* out, void* stream) {
  int32_t* vis = out + (int64_t)p * h * w;
  return launch_deposit(make_stream(hly, hlx, nh, out, vis),
                        make_stream(fly, flx, nf, vis, nullptr), p, h, w,
                        out, 2 * (int64_t)p,
                        static_cast<cudaStream_t>(stream));
}

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
