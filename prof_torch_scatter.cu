// A design of B7/B8 (csrc/deposit.cu: scatter_add_2d, scatter_add_sorted)
// that was measured on the H100 and not kept: prof_torch_scatter.py builds
// this file and times it beside the kept kernels (PERF.md, Findings).
// Nothing in the package calls it.
//
// The grid in a thread-block cluster's distributed shared memory, one
// launch, no memset: the grid, flattened, is cut into bands of consecutive
// cells, one a cluster of `cluster` blocks, and each band into slices of
// `cells_per_block` cells, one a block's dynamic shared memory. Each block
// zeroes its slice, cluster.sync(), reads 1/cluster of the input (each
// element is read once by each cluster), drops what lies outside the
// cluster's band and adds the rest into the owning block's shared memory
// with an atomicAdd through cluster.map_shared_rank; with `match`, the
// lanes of a warp holding one cell first combine (__match_any_sync,
// __reduce_add_sync). cluster.sync() again, then each block writes its
// slice once with 16-byte stores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kScatterThreads = 1024;
constexpr int kScatterPer = 4;       // elements a thread, loaded together
constexpr int kScatterMaxCluster = 16;
constexpr int kScatterMaxCells = 232448 / 4;   // 227 KB of int32 cells

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
  // the element's flat cell and value; false: nothing to add
  static __device__ __forceinline__ bool decode(const Item& it, int h, int w,
                                                int64_t& cell, int32_t& v) {
    cell = (int64_t)it.y * w + it.x;
    v = it.v;
    return v != 0 && (unsigned)it.y < (unsigned)h &&
           (unsigned)it.x < (unsigned)w;
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
  static __device__ __forceinline__ bool decode(const Item& it, int h, int w,
                                                int64_t& cell, int32_t& v) {
    const int32_t word = it.word;
    v = word & 1;
    // arithmetic shift, as the TPU kernel's tile_code >> 9
    const int y = (word >> 20) * 8 + ((word >> 8) & 7);
    const int x = ((word >> 11) & 511) * 128 + ((word >> 1) & 127);
    cell = (int64_t)y * w + x;
    return v != 0 && (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w;
  }
};

// Cluster k owns the band of cells_per_block * cluster cells from
// k * cells_per_block * cluster; its block of rank r the r-th slice of it.
template <class S>
__global__ void __launch_bounds__(kScatterThreads)
    scatter_cluster_kernel(const S s, int64_t n, int h, int w,
                           int cells_per_block, int32_t* __restrict__ out,
                           int match) {
  namespace cg = cooperative_groups;
  extern __shared__ int4 slice4[];
  int32_t* slice = reinterpret_cast<int32_t*>(slice4);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int64_t band_cells = (int64_t)cells_per_block * csize;
  const int64_t band0 = (int64_t)(blockIdx.x / csize) * band_cells;

  // 1. zero this block's slice; no block adds into a neighbour before the
  //    neighbour has started and zeroed
  for (int i = threadIdx.x; i < cells_per_block / 4; i += kScatterThreads) {
    slice4[i] = make_int4(0, 0, 0, 0);
  }
  cluster.sync();

  // 2. this block's share [t0, t1) of the stream, kScatterPer elements a
  //    thread in flight, kScatterThreads apart (coalesced); every thread
  //    runs every round, so the warp votes see all 32 lanes
  const int64_t per = (n + csize - 1) / csize;
  const int64_t t0 = min(n, (int64_t)rank * per);
  const int64_t t1 = min(n, t0 + per);
  const unsigned lane = threadIdx.x & 31;
  for (int64_t base = t0; base < t1;
       base += (int64_t)kScatterThreads * kScatterPer) {
    typename S::Item items[kScatterPer];
#pragma unroll
    for (int j = 0; j < kScatterPer; ++j) {
      const int64_t t = base + (int64_t)j * kScatterThreads + threadIdx.x;
      items[j] = t < t1 ? s.load(t) : S::none();
    }
#pragma unroll
    for (int j = 0; j < kScatterPer; ++j) {
      int64_t cell;
      int32_t v;
      bool ok = S::decode(items[j], h, w, cell, v);
      const int64_t rel = cell - band0;
      ok = ok && rel >= 0 && rel < band_cells;
      const unsigned valid = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        // match: the lanes holding this cell, one sum, one atomic
        const unsigned peers =
            match ? __match_any_sync(valid, (unsigned)rel) : 1u << lane;
        const int32_t sum =
            match ? (int32_t)__reduce_add_sync(peers, (unsigned)v) : v;
        if (lane == (unsigned)(__ffs(peers) - 1) && sum != 0) {
          const unsigned r = (unsigned)rel / (unsigned)cells_per_block;
          int32_t* dst = cluster.map_shared_rank(slice, r);
          atomicAdd(dst + ((unsigned)rel - r * (unsigned)cells_per_block),
                    sum);
        }
      }
    }
  }
  // every add of the cluster has landed, and no block exits while another
  // may still add into its slice
  cluster.sync();

  // 3. write this block's cells once (16-byte stores; a ragged end of the
  //    grid cell by cell)
  const int64_t my0 = band0 + (int64_t)rank * cells_per_block;
  const int64_t total = (int64_t)h * w;
  const int my_n =
      (int)max((int64_t)0, min(total - my0, (int64_t)cells_per_block));
  int4* out4 = reinterpret_cast<int4*>(out + my0);
  for (int i = threadIdx.x; i < my_n / 4; i += kScatterThreads) {
    out4[i] = slice4[i];
  }
  for (int i = my_n / 4 * 4 + threadIdx.x; i < my_n; i += kScatterThreads) {
    out[my0 + i] = slice[i];
  }
}

// The launch configuration of a plan; false: the plan does not cover the
// grid [h, w] or does not fit a block.
bool scatter_config(int h, int w, int cluster, int clusters,
                    int cells_per_block, cudaStream_t st,
                    cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (h < 0 || w < 0 || cluster < 1 || cluster > kScatterMaxCluster ||
      clusters < 1 || clusters > (1 << 26) || cells_per_block < 4 ||
      cells_per_block % 4 != 0 || cells_per_block > kScatterMaxCells ||
      (int64_t)cells_per_block * cluster * clusters < (int64_t)h * w) {
    return false;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(cluster * clusters));
  cfg.blockDim = dim3(kScatterThreads);
  cfg.dynamicSmemBytes = (size_t)cells_per_block * 4;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return true;
}

// above 48 KB of dynamic shared memory and above 8 blocks a cluster the
// kernel must be allowed them first
template <class S>
cudaError_t scatter_attributes(int cluster, int cells_per_block) {
  cudaError_t err = cudaFuncSetAttribute(
      scatter_cluster_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cells_per_block * 4);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(scatter_cluster_kernel<S>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  return err;
}

template <class S>
int launch_scatter(const S& s, int64_t n, int h, int w, int cluster,
                   int clusters, int cells_per_block, int match, int32_t* out,
                   cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (n < 0 || !scatter_config(h, w, cluster, clusters, cells_per_block, st,
                               cfg, attr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = scatter_attributes<S>(cluster, cells_per_block);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, scatter_cluster_kernel<S>, s, n, h, w,
                           cells_per_block, out, match);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class S>
int active_clusters(int cluster, int cells_per_block, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (!scatter_config(0, 0, cluster, 1, cells_per_block, nullptr, cfg,
                      attr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = scatter_attributes<S>(cluster, cells_per_block);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(
      count, scatter_cluster_kernel<S>, &cfg);
}

__global__ void floor_cluster_kernel() {}

}  // namespace

extern "C" int dsmem_scatter_add_2d(const int32_t* ly, const int32_t* lx,
                                    const int32_t* val, int64_t n, int h,
                                    int w, int cluster, int clusters,
                                    int cells_per_block, int match,
                                    int32_t* out, void* stream) {
  return launch_scatter(ValueStream{ly, lx, val}, n, h, w, cluster, clusters,
                        cells_per_block, match, out,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int dsmem_scatter_add_sorted(const int32_t* packed, int64_t n,
                                        int h, int w, int cluster,
                                        int clusters, int cells_per_block,
                                        int match, int32_t* out,
                                        void* stream) {
  return launch_scatter(PackedStream{packed}, n, h, w, cluster, clusters,
                        cells_per_block, match, out,
                        static_cast<cudaStream_t>(stream));
}

// how many clusters of the shape the card holds at once
extern "C" int dsmem_active_clusters(int cluster, int cells_per_block,
                                     int* count) {
  return active_clusters<ValueStream>(cluster, cells_per_block, count);
}

// an empty kernel of the same cluster shape and dynamic shared memory
extern "C" int dsmem_floor(int cluster, int clusters, int cells_per_block,
                           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      floor_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cells_per_block * 4);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(floor_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (!scatter_config(0, 0, cluster, clusters, cells_per_block,
                      static_cast<cudaStream_t>(stream), cfg, attr)) {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaLaunchKernelEx(&cfg, floor_cluster_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
