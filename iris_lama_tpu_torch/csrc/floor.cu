// The launch floor: an empty kernel, to time what any launch of a given
// shape costs on the card (prof_torch_kernels.py, chip_smoke.py). It is
// no port of a TPU kernel and has no caller in the package.

#include <cuda_runtime.h>

namespace {

__global__ void floor_kernel() {}

}  // namespace

extern "C" int launch_floor(int blocks, int threads, void* stream) {
  floor_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
