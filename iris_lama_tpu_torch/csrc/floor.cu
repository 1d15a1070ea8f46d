// The launch floor: an empty kernel, to time what any launch of a given
// shape costs on the card (prof_torch_kernels.py, prof_torch_deposit.py,
// chip_smoke.py), the same with the cudaMemsetAsync
// that the deposit kernels put before their launch, and a cooperative
// launch (B7/B8's), empty or with one grid barrier. It is no port of a TPU
// kernel and has no caller in the package.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void floor_kernel() {}

__global__ void floor_grid_kernel(int sync) {
  if (sync) cooperative_groups::this_grid().sync();
}

}  // namespace

extern "C" int launch_floor(int blocks, int threads, void* stream) {
  floor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// cudaMemsetAsync of `bytes` bytes at ptr, then (blocks > 0) the empty
// kernel: the floor of a zero-then-scatter launch pair
extern "C" int memset_floor(void* ptr, int64_t bytes, int blocks, int threads,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ptr, 0, (size_t)bytes, s);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0) floor_kernel<<<blocks, threads, 0, s>>>();
  return (int)cudaGetLastError();
}

// the empty kernel, or one grid barrier (sync != 0), launched
// cooperatively as `blocks` blocks of `threads`: the floor of B7/B8's
// launch, and of their launch and barrier
extern "C" int launch_floor_cooperative(int blocks, int threads, int sync,
                                        void* stream) {
  void* args[] = {&sync};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)floor_grid_kernel, dim3((unsigned)blocks),
      dim3((unsigned)threads), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
