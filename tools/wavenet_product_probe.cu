// The cost of one gated-conv product on a thread-block cluster, and of its
// push to every peer, with the weights resident in shared memory.
//
// One cluster of CL blocks of NT threads loops `iters` times over WaveNet-10's
// gated conv at one layer: S rows of K = 256 ([x(s-d) | x(s)], D = 128) times
// the block's slice of the 2D = 256 columns (2D / CL of them, matched tanh and
// sigmoid columns side by side, so the gate stays in the block), then the
// gate, then, in the modes that push, a store of the block's D / CL gate
// outputs of each row into every peer's copy of the full rows and the cluster
// barrier.  The product runs as warp tasks of R rows and four column quads;
// lane (slice sl, quad jj) sums k = sl, sl + 8, ... for its quad and R rows in
// registers, and the eight slices meet by shuffles (a reduce-scatter over the
// rows).  Modes:
//   0  the product alone (a block barrier after it);
//   1  the product, the gate, the push from the lanes' registers and the
//      cluster barrier;
//   2  the push and the cluster barrier alone (no product);
//   3  the product, then its sums through shared memory and a block barrier,
//      then the gate and the push by a thread a (row, quad), then the cluster
//      barrier (the shape of csrc/jukebox_group.cu's jg_quads + jg_push).
// `map` 0 puts the quad in the lane's low bits (lane = 4 sl + jj: the eight
// lanes of a 16-byte load phase read 128 distinct bytes), 1 the slice
// (lane = sl + 8 jj, as jg_quads: the phase reads one quad of eight k rows,
// 64 bytes apart, a four-way bank conflict at four quads a row).  Built by
// tools/wavenet_product_probe.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define PK 256   // K: [x(s-d) | x(s)]
#define PD 128   // D

__device__ __forceinline__ float4 shfl4(float4 v, int mask) {
  v.x = __shfl_xor_sync(0xffffffffu, v.x, mask);
  v.y = __shfl_xor_sync(0xffffffffu, v.y, mask);
  v.z = __shfl_xor_sync(0xffffffffu, v.z, mask);
  v.w = __shfl_xor_sync(0xffffffffu, v.w, mask);
  return v;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int CL, int NT, int R>
__global__ void __launch_bounds__(NT, 1)
probe_kernel(int mode, int map, int iters, int S, float* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr int NW = NT / 32, QN = 2 * PD / CL / 4, ND = PD / CL;  // quads, gate units a block
  extern __shared__ __align__(16) float smem[];
  float* w = smem;                 // (K, 4 QN) the slice, k-major
  float* x = w + PK * 4 * QN;      // (S, K) the rows
  float* y = x + S * PK;           // (2, S, D) the full gate rows, by parity
  float* red = y + 2 * S * PD;     // (S, 4 QN) mode 3's sums
  for (int i = threadIdx.x; i < PK * 4 * QN; i += NT) w[i] = 1e-3f * (float)((i * 7 + rank) % 13);
  for (int i = threadIdx.x; i < S * PK; i += NT) x[i] = 1e-2f * (float)((i * 5) % 11);
  for (int i = threadIdx.x; i < 2 * S * PD; i += NT) y[i] = 0.0f;
  cluster.sync();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sl = map ? (lane & 7) : (lane >> 2), jj = map ? (lane >> 3) : (lane & 3);
  const int m4 = map ? 4 : 16, m2 = map ? 2 : 8, m1 = map ? 1 : 4;  // lane masks of sl's bits
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const int nqg = (QN + 3) / 4, n_tasks = (S + R - 1) / R * nqg;
  float keep_alive = 0.0f;
  for (int it = 0; it < iters; ++it) {
    float* yb = y + (it & 1) * S * PD;
    if (mode != 2) {
      for (int task = warp; task < n_tasks; task += NW) {
        const int rg = task / nqg, j = (task - rg * nqg) * 4 + jj, jc = min(j, QN - 1);
        const int r0 = rg * R;
        int xo[R];
#pragma unroll
        for (int i = 0; i < R; ++i) xo[i] = min(r0 + i, S - 1) * PK;
        float4 acc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
        for (int k = sl; k < PK; k += 8) {
          const float4 wv = w4[k * QN + jc];
          float xv[R];
#pragma unroll
          for (int i = 0; i < R; ++i) xv[i] = x[xo[i] + k];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc[i].x = fmaf(xv[i], wv.x, acc[i].x);
            acc[i].y = fmaf(xv[i], wv.y, acc[i].y);
            acc[i].z = fmaf(xv[i], wv.z, acc[i].z);
            acc[i].w = fmaf(xv[i], wv.w, acc[i].w);
          }
        }
        // the eight slices: a reduce-scatter over the rows while there are
        // rows to halve, then an all-reduce (the same sum tree for every R)
        int rb = 0;
        const int masks[3] = {m4, m2, m1}, bits[3] = {4, 2, 1};
#pragma unroll
        for (int round = 0, n = R; round < 3; ++round) {
          const bool hi = sl & bits[round];
          if (n >= 2) {
            const int half = n / 2;
#pragma unroll
            for (int i = 0; i < R / 2; ++i) {
              if (i < half) {
                const float4 send = hi ? acc[i] : acc[half + i], keep = hi ? acc[half + i] : acc[i];
                acc[i] = add4(keep, shfl4(send, masks[round]));
              }
            }
            rb += hi ? half : 0;
            n = half;
          } else {
            acc[0] = add4(acc[0], shfl4(acc[0], masks[round]));
          }
        }
        const int dup = 8 / R - 1;  // the low slice bits that hold copies
        const int row = r0 + rb;
        const bool owner = (sl & dup) == 0 && j < QN && row < S;
        const float4 v = acc[0];
        if (mode == 0) {
          keep_alive += v.x + v.y + v.z + v.w;
        } else if (mode == 1) {
          if (owner) {
            const float2 g = make_float2(tanhf(v.x) * sigm(v.y), tanhf(v.z) * sigm(v.w));
            float2* p = reinterpret_cast<float2*>(yb + row * PD + rank * ND + 2 * j);
#pragma unroll
            for (int i = 0; i < CL; ++i) *cluster.map_shared_rank(p, (i + lane) % CL) = g;
          }
        } else if (owner) {
          reinterpret_cast<float4*>(red)[row * QN + j] = v;
        }
      }
    }
    if (mode == 3) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < S * QN; idx += NT) {
        const int row = idx / QN, j = idx - row * QN;
        const float4 v = reinterpret_cast<const float4*>(red)[idx];
        const float2 g = make_float2(tanhf(v.x) * sigm(v.y), tanhf(v.z) * sigm(v.w));
        float2* p = reinterpret_cast<float2*>(yb + row * PD + rank * ND + 2 * j);
#pragma unroll
        for (int i = 0; i < CL; ++i) *cluster.map_shared_rank(p, (i + idx) % CL) = g;
      }
    }
    if (mode == 2) {
      for (int idx = threadIdx.x; idx < S * ND / 2; idx += NT) {
        const int row = idx / (ND / 2), j = idx - row * (ND / 2);
        float2* p = reinterpret_cast<float2*>(yb + row * PD + rank * ND + 2 * j);
#pragma unroll
        for (int i = 0; i < CL; ++i)
          *cluster.map_shared_rank(p, (i + idx) % CL) = make_float2((float)it, 1.0f);
      }
    }
    if (mode == 0) {
      __syncthreads();
    } else {
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    }
  }
  if (keep_alive == 12345.0f) sink[0] = keep_alive + y[0];
  cluster.sync();
}

template <int CL, int NT, int R>
static int run(int mode, int map, int iters, int S, float* sink, cudaStream_t stream) {
  constexpr int QN = 2 * PD / CL / 4;
  const size_t smem = sizeof(float) * ((size_t)PK * 4 * QN + (size_t)S * PK + 2 * (size_t)S * PD +
                                       (size_t)S * 4 * QN);
  const void* k = (const void*)probe_kernel<CL, NT, R>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, probe_kernel<CL, NT, R>, mode, map, iters, S, sink);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int CL, int NT>
static int by_r(int r, int mode, int map, int iters, int S, float* sink, cudaStream_t s) {
  switch (r) {
    case 1: return run<CL, NT, 1>(mode, map, iters, S, sink, s);
    case 2: return run<CL, NT, 2>(mode, map, iters, S, sink, s);
    case 4: return run<CL, NT, 4>(mode, map, iters, S, sink, s);
    case 8: return run<CL, NT, 8>(mode, map, iters, S, sink, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int mmk_product_probe(int cl, int nt, int r, int mode, int map, int iters, int S, void* sink,
                      void* stream) {
  float* f = (float*)sink;
  cudaStream_t s = (cudaStream_t)stream;
  if (cl == 8 && nt == 256) return by_r<8, 256>(r, mode, map, iters, S, f, s);
  if (cl == 8 && nt == 512) return by_r<8, 512>(r, mode, map, iters, S, f, s);
  if (cl == 16 && nt == 256) return by_r<16, 256>(r, mode, map, iters, S, f, s);
  if (cl == 16 && nt == 512) return by_r<16, 512>(r, mode, map, iters, S, f, s);
  return (int)cudaErrorInvalidValue;
}

const char* mmk_product_probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
