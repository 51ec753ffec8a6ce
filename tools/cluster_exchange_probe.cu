// The cost of one activation exchange inside a thread-block cluster.
//
// One cluster of CL blocks of 512 threads loops `iters` times over an
// exchange: every block writes its R x d floats into every peer's copy of
// the full rows (16-byte stores through map_shared_rank pointers), then the
// blocks synchronise.  Modes:
//   0  the barrier alone (barrier.cluster.arrive.release / wait.acquire);
//   1  push, then that barrier;
//   2  push, then one remote mbarrier arrive (release, cluster scope) on
//      each consumer's barrier, and a wait on the block's own (acquire);
//   3  the barrier, then every block reads the rows from their owners word
//      by word (a pull, as csrc/fused_lstm.cu's step does).
// Modes 1 and 2 double-buffer the rows by iteration parity (a producer may
// run one exchange ahead of a slow consumer), mode 2 its barriers too; a
// barrier counts CL arrivals a phase.  Built by tools/cluster_exchange_probe.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define PROBE_THREADS 512

__device__ __forceinline__ void cl_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cl_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int CL>
__global__ void __launch_bounds__(PROBE_THREADS, 1)
probe_kernel(int mode, int iters, int R, int d, float* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) float smem[];
  float* rows = smem;                      // (2, R, d): the full rows, by parity
  __shared__ __align__(8) uint64_t bars[2];
  const int n4 = R * d / 4, own4 = n4 / CL;  // float4s of the rows, and of a block's slice
  if (threadIdx.x < 2) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 ::"r"((unsigned)__cvta_generic_to_shared(&bars[threadIdx.x])), "r"(CL));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < 2 * R * d; i += PROBE_THREADS) rows[i] = 0.0f;
  cluster.sync();
  float acc = 0.0f;
  for (int it = 0; it < iters; ++it) {
    float4* buf = reinterpret_cast<float4*>(rows + (mode == 1 || mode == 2 ? (it & 1) * R * d : 0));
    if (mode == 1 || mode == 2) {
      for (int idx = threadIdx.x; idx < own4 * CL; idx += PROBE_THREADS) {
        const int peer = idx % CL, j = rank * own4 + idx / CL;
        float4* dst = cluster.map_shared_rank(buf + j, peer);
        *dst = make_float4((float)it, 1.0f, 2.0f, 3.0f);
      }
    }
    if (mode == 2) {
      __syncthreads();
      if (threadIdx.x < CL) {
        const unsigned local = (unsigned)__cvta_generic_to_shared(&bars[it & 1]);
        unsigned remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(remote) : "r"(local), "r"(threadIdx.x));
        asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
                     ::"r"(remote) : "memory");
      }
      unsigned done = 0;
      while (!done)
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p,"
            " [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"((unsigned)__cvta_generic_to_shared(&bars[it & 1])),
              "r"((it >> 1) & 1)
            : "memory");
    } else {
      cl_arrive();
      cl_wait();
    }
    if (mode == 3) {
      for (int i = threadIdx.x; i < R * d; i += PROBE_THREADS) {
        const int owner = (i / 4) / own4;
        const float* src = cluster.map_shared_rank(rows + i, owner < CL ? owner : CL - 1);
        acc += *src;
      }
      __syncthreads();
    }
    acc += reinterpret_cast<const float*>(buf)[threadIdx.x % (R * d)];
  }
  cluster.sync();
  if (acc == -1.0f) sink[0] = acc;
}

template <int CL>
static int launch(int mode, int iters, int R, int d, float* sink, void* stream) {
  const size_t smem = sizeof(float) * 2 * R * d;
  cudaError_t e = cudaFuncSetAttribute((const void*)probe_kernel<CL>,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute((const void*)probe_kernel<CL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(PROBE_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, probe_kernel<CL>, mode, iters, R, d, sink);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

int mmk_probe(int cl, int mode, int iters, int R, int d, float* sink, void* stream) {
  switch (cl) {
    case 2: return launch<2>(mode, iters, R, d, sink, stream);
    case 4: return launch<4>(mode, iters, R, d, sink, stream);
    case 8: return launch<8>(mode, iters, R, d, sink, stream);
    case 16: return launch<16>(mode, iters, R, d, sink, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mmk_probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
