// The launch floor: an empty kernel, to time what any launch of a given
// shape costs on the card (prof_torch_kernels.py, prof_torch_deposit.py,
// chip_smoke.py), and the same with the cudaMemsetAsync that the deposit
// kernels put before their launch. It is no port of a TPU kernel and has no
// caller in the package.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void floor_kernel() {}

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
