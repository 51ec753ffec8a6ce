// An empty kernel: the floor below which no single launch goes on the card.
// chip_smoke.py and tools/ab_categorical.py time it as they time the
// categorical sampler (K9), captured in a CUDA graph, and print it beside the
// sampler's time.  Build: ops/nvcc.build_library (sm_90a, a plain C
// interface loaded with ctypes).
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" {

// One launch of the empty kernel (one block of 32 threads) on `stream`;
// returns the launch's cudaError_t.
int mmk_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
