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

// Two more entry points, B7 and B8: value scatters into one int32 grid
// [h, w], each one launch that writes every cell of a fresh grid itself
// (no memset):
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
// per tile change. The tile flushes were there for Mosaic's aligned
// slices and are not carried over; a sort only makes the run combine below
// collapse more, the result is the same in any order.
//
// Bound on the H100: the bytes, each input element read once (12 bytes for
// B7, 4 for B8) and the grid written once (the Slam2D deposit's ~43 k
// free cells into [448, 512]: ~1.4 MB, ~0.43 us at 3.35 TB/s), below the
// floor of any launch; what a call costs is launches and barriers. Design
// (PERF.md's kernel table, B7 and B8, with the designs below):
//   - one cooperative launch (every block resident; a launch the card
//     cannot hold is refused): the blocks zero the grid with 16-byte stores,
//     issue the loads of their first elements, meet at one grid barrier
//     (cooperative_groups' grid.sync: no block adds before every zero is in
//     place), then add with one int32 atomicAdd a cell run (a
//     fire-and-forget reduction in L2);
//   - before that atomic, the lanes of a warp holding a run of equal cells
//     (consecutive lanes: B8's sorted words, a stream of one cell) sum into
//     the run's first lane by a segmented shuffle sum, so a hot cell costs
//     one atomic a warp instead of 32 serialised in one L2 slice;
//   - the plan is the wrapper's: one block a streaming multiprocessor while
//     one round of loads holds the input, four beyond.
// The launch and its barrier alone take ~2 us (an empty cooperative launch
// ~0.9); a call on the deposit's stream ~2.8. Measured and not kept
// (PERF.md's kernel table, B7): the memset + one atomicAdd an element
// that these two entry points were (two device activities a call; as fast
// on the deposit's stream, ten times slower on a stream of one cell, whose
// atomics serialise in one L2 slice), and the grid held in a thread-block
// cluster's distributed shared memory (a band of it a cluster, the adds
// as shared-memory atomics through map_shared_rank; 1.7 to 10 times
// slower: two release/acquire cluster barriers, every cluster reading the
// whole input, a hot band's atomics, and __match_any_sync to combine a
// warp's equal cells costing more than it saved).
// Integer atomics are exact in any order, so both are bit-exact for any
// input order. An element outside the grid is dropped.

#include <cooperative_groups.h>
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

constexpr int kScatterThreads = 256;
constexpr int kScatterPer = 2;   // elements a thread loads before the barrier

// B7's input: one element is (ly, lx, val)
struct ValueStream {
  const int32_t* __restrict__ ly;
  const int32_t* __restrict__ lx;
  const int32_t* __restrict__ val;
  struct Item {
    int32_t y, x, v;
  };
  __device__ __forceinline__ Item load(int64_t t) const {
    return Item{ly[t], lx[t], val[t]};
  }
  static __device__ __forceinline__ Item none() { return Item{-1, -1, 0}; }
  // the element's flat cell; -1: nothing to add
  static __device__ __forceinline__ int cell(const Item& it, int h, int w,
                                             int32_t& v) {
    v = it.v;
    return v != 0 && (unsigned)it.y < (unsigned)h &&
                   (unsigned)it.x < (unsigned)w
               ? it.y * w + it.x
               : -1;
  }
};

// B8's input: one packed word
struct PackedStream {
  const int32_t* __restrict__ packed;
  struct Item {
    int32_t word;
  };
  __device__ __forceinline__ Item load(int64_t t) const {
    return Item{packed[t]};
  }
  static __device__ __forceinline__ Item none() { return Item{0}; }
  static __device__ __forceinline__ int cell(const Item& it, int h, int w,
                                             int32_t& v) {
    const int32_t word = it.word;
    v = word & 1;
    // arithmetic shift, as the TPU kernel's tile_code >> 9
    const int y = (word >> 20) * 8 + ((word >> 8) & 7);
    const int x = ((word >> 11) & 511) * 128 + ((word >> 1) & 127);
    return v != 0 && (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w
               ? y * w + x
               : -1;
  }
};

// One element a lane, all 32 lanes present: the lanes of a run of equal
// cells (consecutive lanes) sum their values (int32 wrap-around, as the
// atomics) into the run's first lane, which does the one atomic. A
// segmented suffix sum over the warp: after the step of distance d, a lane
// holds the sum of up to 2d lanes of its run from itself on.
__device__ __forceinline__ void add_runs(int32_t* __restrict__ out, int cell,
                                         int32_t v) {
  const unsigned lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(0xffffffffu, cell, 1);
  const bool head = lane == 0 || prev != cell;
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  const unsigned above = heads & ~((2u << lane) - 1u);
  const unsigned run_end = above ? (unsigned)(__ffs(above) - 1) : 32u;
  int32_t sum = cell >= 0 ? v : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t o = __shfl_down_sync(0xffffffffu, sum, d);
    if (lane + d < run_end) sum = (int32_t)((uint32_t)sum + (uint32_t)o);
  }
  if (head && cell >= 0 && sum != 0) atomicAdd(out + cell, sum);
}

// Rounds of kScatterThreads * kScatterPer consecutive elements a block:
// block b's round r starts at (r * gridDim.x + b) * kScatterThreads *
// kScatterPer, its thread t takes t, t + kScatterThreads, ...
template <class S>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_grid_kernel(const S s, int64_t n, int h, int w,
                        int32_t* __restrict__ out) {
  namespace cg = cooperative_groups;
  const int64_t total = (int64_t)h * w;
  const int64_t threads = (int64_t)gridDim.x * kScatterThreads;
  const int64_t tid = (int64_t)blockIdx.x * kScatterThreads + threadIdx.x;
  // 1. zero the grid, 16 bytes a store
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int64_t i = tid; i < total / 4; i += threads) {
    out4[i] = make_int4(0, 0, 0, 0);
  }
  for (int64_t i = total / 4 * 4 + tid; i < total; i += threads) out[i] = 0;
  // 2. the first round's loads, in flight across the barrier
  constexpr int64_t kRound = (int64_t)kScatterThreads * kScatterPer;
  typename S::Item items[kScatterPer];
  const int64_t first = (int64_t)blockIdx.x * kRound + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kScatterPer; ++j) {
    const int64_t t = first + (int64_t)j * kScatterThreads;
    items[j] = t < n ? s.load(t) : S::none();
  }
  // 3. every block's zeros are in place before any block adds
  cg::this_grid().sync();
  // 4. add: the first round, then the rest (every thread of a block runs
  //    every round, so each warp's shuffles see all 32 lanes)
  int32_t v;
#pragma unroll
  for (int j = 0; j < kScatterPer; ++j) {
    const int c = S::cell(items[j], h, w, v);
    add_runs(out, c, v);
  }
  for (int64_t r0 = first + (int64_t)gridDim.x * kRound; r0 - threadIdx.x < n;
       r0 += (int64_t)gridDim.x * kRound) {
#pragma unroll
    for (int j = 0; j < kScatterPer; ++j) {
      const int64_t t = r0 + (int64_t)j * kScatterThreads;
      const int c = S::cell(t < n ? s.load(t) : S::none(), h, w, v);
      add_runs(out, c, v);
    }
  }
}

// One cooperative launch of `blocks` blocks (all resident at once, or the
// launch is refused); grids below 2^31 cells.
template <class S>
int launch_scatter(const S& s, int64_t n, int h, int w, int blocks,
                   int32_t* out, cudaStream_t st) {
  if (n < 0 || h < 0 || w < 0 || (int64_t)h * w > INT32_MAX || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  void* args[] = {(void*)&s, (void*)&n, (void*)&h, (void*)&w, (void*)&out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)scatter_grid_kernel<S>, dim3((unsigned)blocks),
      dim3(kScatterThreads), args, 0, st);
  // a refused launch is reported here and cleared, so that no later
  // launch check reads it
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
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

// B7 and B8, each one cooperative launch of `blocks` blocks of 256 threads
// (ops/scatter_pallas.py:launch_blocks); out [h, w] is written whole.
extern "C" int scatter_add_2d(const int32_t* ly, const int32_t* lx,
                              const int32_t* val, int64_t n, int h, int w,
                              int blocks, int32_t* out, void* stream) {
  return launch_scatter(ValueStream{ly, lx, val}, n, h, w, blocks, out,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int scatter_add_sorted(const int32_t* packed, int64_t n, int h,
                                  int w, int blocks, int32_t* out,
                                  void* stream) {
  return launch_scatter(PackedStream{packed}, n, h, w, blocks, out,
                        static_cast<cudaStream_t>(stream));
}
