// What the wide LSTM kernels' launch can count on, on one card: the clusters
// of `cl` blocks (one block a streaming multiprocessor, `smem` bytes of
// shared memory) that the card holds at once, whether a launch may carry a
// cluster dimension and the cooperative attribute together, and the cost of
// a grid barrier over 128 blocks: cooperative groups' grid sync, or a
// counter in device memory (a release add, an acquire spin).  Built and run
// by tools/wide_cluster_probe.py.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__global__ void probe_kernel(unsigned* ctr, int iters, int mode) {
  extern __shared__ unsigned char smem[];
  if (threadIdx.x == 0) smem[0] = 0;
  for (int i = 0; i < iters; ++i) {
    if (mode == 0) {
      cg::this_grid().sync();
    } else {
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(ctr, 1u);
        const unsigned target = (unsigned)(i + 1) * gridDim.x;
        while (*(volatile unsigned*)ctr < target) {
        }
        __threadfence();
      }
      __syncthreads();
    }
  }
}

static cudaLaunchConfig_t config(int cl, int smem, int coop, cudaLaunchAttribute* attr,
                                 cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(128);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  int n = 0;
  if (cl > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cl;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (coop) {
    attr[n].id = cudaLaunchAttributeCooperative;
    attr[n].val.cooperative = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cfg;
}

static int prepare(int smem) {
  cudaError_t e = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

extern "C" {

// The clusters of `cl` blocks the card holds at once, or minus the error.
int mmk_probe_clusters(int cl, int smem) {
  int err = prepare(smem);
  if (err) return -err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(cl, smem, 0, attr, 0);
  int n = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&n, probe_kernel, &cfg);
  return err ? -err : n;
}

// 128 blocks on clusters of `cl` (1: none), with the cooperative attribute
// where `coop` is set, `iters` grid barriers of `mode` (0 cooperative
// groups, 1 the counter); returns the launch's error.
int mmk_probe_launch(int cl, int smem, int coop, int iters, int mode, unsigned* ctr,
                     void* stream) {
  int err = prepare(smem);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(ctr, 0, sizeof(unsigned), s);
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(cl, smem, coop, attr, s);
  err = (int)cudaLaunchKernelEx(&cfg, probe_kernel, ctr, iters, mode);
  if (err) return err;
  return (int)cudaGetLastError();
}

const char* mmk_probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
}
