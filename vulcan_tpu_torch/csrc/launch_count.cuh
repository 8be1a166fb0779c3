// Launch counters on the card.  A counted kernel takes the address of its
// counter (a device word of ops/cuda_kernels.py's launch counters, or null)
// and adds one to it from the first thread of its first block, so that
// every launch counts where it runs: eagerly, and in each replay of a CUDA
// graph that holds it (a capture launches nothing; a kernel in a
// conditional node's body counts each time the body runs, and not at all
// where it does not).
#pragma once

__device__ __forceinline__ void count_launch(unsigned int* launches) {
  if (launches != nullptr && threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0 &&
      blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
    atomicAdd(launches, 1u);
  }
}
