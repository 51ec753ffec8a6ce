// SampleRNN autoregressive decode: the whole step loop in one kernel.
//
// Replaces the TPU kernels make_samplernn_pallas_decoder (whole decode in
// one call) and make_samplernn_pallas_chunked (state carried in and out) of
// mimikit_tpu/ops/pallas_decode.py.  One state-carrying entry serves both:
// it runs `n_steps` steps from absolute step `t0`, reading and writing the
// sample window, the LSTM carries and the tier caches in place.
//
// Per step (what pallas_decode.py:219-291 computes):
//   * every tier i with t % fs[i] == 0: framed dense on the last fs[i]
//     samples (scaled (tok/Q - 0.5)*2), plus cache row (t/fs[i]) % up[i-1]
//     of the tier above, -> LSTM cell (gate order i|f|g|o) -> linear
//     upsampler into this tier's cache (up[i] rows of H);
//   * bottom tier: framed dense on the last fs[-1] samples + cache row
//     t % fs[-2] -> Mish MLP -> Q+1 logits; logits[:Q] / max(sigmoid(l[Q]),
//     min_temperature), then / the stream's temperature + Gumbel noise when
//     sampling;
//     argmax with ties to the first index;
//   * teacher-forcing while t < prior_t, then the window takes the token.
//
// Design.  Streams are independent, so a block owns a group of G streams
// (as few as keep the grid within one block per SM) and loops over all
// steps itself: no grid-wide sync.  The window lives in
// shared memory as a ring indexed by absolute time; the dense layers'
// inputs and outputs (G rows each) live in shared memory; h, c and the
// tier caches stay in the state tensors in device memory (read one row per
// step, written when a tier fires).  Weights are f32 (1.84M of them, 7.4 MB,
// at the full width) and are read from device memory through L2, where they
// stay resident (50 MB).  Each thread owns output columns and keeps G
// accumulators, so one weight load feeds G fused multiply-adds, and keeps
// 16 weight loads in flight.
//
// Bound.  Per stream-step the full-width model needs ~0.61 MFLOP (bottom
// tier + head every step, tier 1 every 8 steps, tier 0 every 16), so at
// B=256 the card's f32 rate bounds the work by operations (~2.3 us a step).
// This version is bound instead by weight traffic: every block reads ~1.2 MB
// of weights from L2 each step, so the L2's bandwidth across the blocks and
// the latency of each thread's dependent loads set the pace; the design
// answers with G accumulators per load, 16 loads in flight per thread and
// one block per SM.  Tensor cores (wgmma) and weights held in shared memory
// across SMs are the later steps.
//
// bf16 weights (MMK_PALLAS_BF16=1; the TPU kernels' weight_dtype="bf16",
// pallas_decode.py:179-187): the same kernel instantiated on
// __nv_bfloat16 weights.  Each weight and bias is a 2-byte load converted to
// f32; each product's input activation is rounded to bf16 where JAX's wdot
// rounds it (the framed samples, x and h of the gates, h of the upsampler,
// each head layer's input; the block rounds a product's input rows in shared
// memory once, before the product); products and sums stay f32, in the same
// order as the f32 instantiation; the x + tier-cache add, the LSTM cell, the carries
// and the caches stay f32.  It halves the weight bytes each step re-reads
// from L2 (7.4 MB to 3.7 MB at the full width), the traffic this version is
// bound by; the operations are unchanged.
//
// Randomness: the port's counter hash of (seed, absolute t, stream, class)
// (noise.cuh).  The plain PyTorch twin computes the same hash, so both see
// identical noise, and sampled streams do not depend on the chunk length.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "noise.cuh"

#define MMK_MAX_TIERS 8
#define MMK_MAX_HEAD 4
#define MMK_THREADS 512

// Mirrors SrnnDecodeArgs in mimikit_tpu_torch/ops/samplernn_decode.py:
// pointers, then 64-bit integers, then 32-bit fields (no padding between).
struct SrnnDecodeArgs {
  const void* w;       // packed weights (samplernn_weight_pack), f32 or bf16
  const int* prompt;   // (B, prior_t)
  int* win;            // (B, rf), oldest sample first; in/out
  float* h;            // (n_tiers-1, B, H); in/out
  float* c;            // (n_tiers-1, B, H); in/out
  float* cache;        // (B, cache_rows, H); in/out
  int* out;            // (B, out_len)

  long long t0;        // absolute step of the first iteration
  long long out_t0;    // absolute step written to out[:, 0]
  long long off_win[MMK_MAX_TIERS];  // W_in (fs[i], H)
  long long off_bin[MMK_MAX_TIERS];  // (H)
  long long off_wx[MMK_MAX_TIERS];   // [W_ih^T; W_hh^T] (2H, 4H)
  long long off_bx[MMK_MAX_TIERS];   // (4H)
  long long off_wup[MMK_MAX_TIERS];  // (H, up[i]*H)
  long long off_bup[MMK_MAX_TIERS];  // (up[i]*H)
  long long off_wbot;                // (fs[-1], H)
  long long off_bbot;                // (H)
  long long off_wh[MMK_MAX_HEAD];    // (head_in[k], head_out[k])
  long long off_bh[MMK_MAX_HEAD];    // (head_out[k])

  int n_steps;
  int out_len;
  int B;
  int H;
  int Q;
  int rf;
  int prior_t;
  int n_tiers;
  int n_head;
  int argmax;
  int group;           // streams per block: 1, 2, 4 or 8
  int dstride;         // row stride of the shared buffers, a multiple of 4
  int cache_rows;      // sum(up)
  unsigned int seed;
  const float* temperature;  // (B,) a stream's temperature, read when sampling
  float min_temperature;
  int bf16;            // the weights are __nv_bfloat16 (else float)
  int fs[MMK_MAX_TIERS];
  int up[MMK_MAX_TIERS];
  int cache_row[MMK_MAX_TIERS];      // first cache row of tier i
  int head_in[MMK_MAX_HEAD];
  int head_out[MMK_MAX_HEAD];
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// A weight as f32, and a product input as the weight type rounds it: both
// the identity for f32 weights.
__device__ __forceinline__ float wload(const float* p) { return __ldg(p); }
__device__ __forceinline__ float wload(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
template <class WT>
__device__ __forceinline__ float wround(float x) {
  return x;
}
template <>
__device__ __forceinline__ float wround<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float mish_f(float x) {
  float sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

// Y[g][col] = act(X[g][:K] . W[:K][col] + bias[col]) for the G rows of X.
// W is (K, N) row-major; X rows are 16-byte aligned (xs % 4 == 0).  Rows
// g >= n_valid are computed but not stored (ragged last group).  With bf16
// weights the caller has rounded X to bf16 (round_inputs).
template <int G, bool MISH, class WT>
__device__ __forceinline__ void dense(const WT* __restrict__ W,
                                      const WT* __restrict__ bias,
                                      const float* X, int xs, int K, int N,
                                      float* Y, long long ys, int n_valid) {
  for (int col = threadIdx.x; col < N; col += blockDim.x) {
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0f;
    const WT* wp = W + col;
    int k = 0;
    // 16 weight loads in flight before their multiply-adds: the loop waits
    // on L2 latency, not on arithmetic
    for (; k + 16 <= K; k += 16) {
      float wv[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) wv[u] = wload(wp + (size_t)(k + u) * N);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int u = 0; u < 16; u += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(X + g * xs + k + u);
          acc[g] = fmaf(xv.x, wv[u + 0], acc[g]);
          acc[g] = fmaf(xv.y, wv[u + 1], acc[g]);
          acc[g] = fmaf(xv.z, wv[u + 2], acc[g]);
          acc[g] = fmaf(xv.w, wv[u + 3], acc[g]);
        }
      }
    }
    for (; k + 4 <= K; k += 4) {
      const float w0 = wload(wp + (size_t)(k + 0) * N);
      const float w1 = wload(wp + (size_t)(k + 1) * N);
      const float w2 = wload(wp + (size_t)(k + 2) * N);
      const float w3 = wload(wp + (size_t)(k + 3) * N);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 xv = *reinterpret_cast<const float4*>(X + g * xs + k);
        acc[g] = fmaf(xv.x, w0, acc[g]);
        acc[g] = fmaf(xv.y, w1, acc[g]);
        acc[g] = fmaf(xv.z, w2, acc[g]);
        acc[g] = fmaf(xv.w, w3, acc[g]);
      }
    }
    for (; k < K; ++k) {
      const float wv = wload(wp + (size_t)k * N);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(X[g * xs + k], wv, acc[g]);
    }
    const float bv = wload(bias + col);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v = acc[g] + bv;
      if (MISH) v = mish_f(v);
      if (g < n_valid) Y[g * ys + col] = v;
    }
  }
}

// A product reads its input rounded to bf16 when the weights are bf16 (JAX's
// wdot): the rows r < n_rows of X (K wide, row stride xs) rounded in place,
// once, by the block, before the product; nothing for f32 weights.
template <class WT>
__device__ __forceinline__ void round_inputs(float* X, int xs, int n_rows, int K) {}
template <>
__device__ __forceinline__ void round_inputs<__nv_bfloat16>(float* X, int xs, int n_rows, int K) {
  for (int idx = threadIdx.x; idx < n_rows * K; idx += blockDim.x) {
    float* x = X + (idx / K) * xs + idx % K;
    *x = wround<__nv_bfloat16>(*x);
  }
  __syncthreads();
}

template <int G, class WT>
__global__ void __launch_bounds__(MMK_THREADS)
samplernn_decode_kernel(const SrnnDecodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.dstride;
  float* bufX = smem;              // tier input [x | h]; head ping
  float* bufY = bufX + G * D;      // gates; head pong
  float* bufZ = bufY + G * D;      // new h
  int* ring = reinterpret_cast<int*>(bufZ + G * D);  // G * rf tokens

  const int H = a.H, Q = a.Q, rf = a.rf, B = a.B;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b0 = blockIdx.x * G;
  const int n_valid = min(G, B - b0);
  const long long cstride = (long long)a.cache_rows * H;  // per stream
  const WT* w = static_cast<const WT*>(a.w);

  // ring[g][s % rf] holds sample s; the window of step t is [t-rf, t)
  for (int idx = tid; idx < G * rf; idx += nth) {
    const int g = idx / rf, p = idx % rf;
    const int b = min(b0 + g, B - 1);
    ring[g * rf + (int)((a.t0 + p) % rf)] = a.win[(long long)b * rf + p];
  }
  __syncthreads();

  for (int i = 0; i < a.n_steps; ++i) {
    const long long t = a.t0 + i;
    const int tm = (int)(t % rf);

    for (int k = 0; k < a.n_tiers - 1; ++k) {
      const int f = a.fs[k];
      if (t % f != 0) continue;
      const WT* Win = w + a.off_win[k];
      const WT* bin = w + a.off_bin[k];
      const int prev_row =
          k > 0 ? a.cache_row[k - 1] + (int)((t / f) % a.up[k - 1]) : 0;
      for (int idx = tid; idx < G * H; idx += nth) {
        const int g = idx / H, j = idx % H;
        const int b = min(b0 + g, B - 1);
        float acc = 0.0f;
        for (int kk = 0; kk < f; ++kk) {
          const int tok = ring[g * rf + (tm + rf - f + kk) % rf];
          const float xv = wround<WT>(((float)tok / (float)Q - 0.5f) * 2.0f);
          acc = fmaf(xv, wload(Win + kk * H + j), acc);
        }
        acc += wload(bin + j);
        if (k > 0) acc += a.cache[b * cstride + (long long)prev_row * H + j];
        bufX[g * D + j] = acc;
        bufX[g * D + H + j] = a.h[((long long)k * B + b) * H + j];
      }
      __syncthreads();
      round_inputs<WT>(bufX, D, G, 2 * H);
      dense<G, false, WT>(w + a.off_wx[k], w + a.off_bx[k], bufX, D, 2 * H, 4 * H,
                      bufY, D, G);
      __syncthreads();
      for (int idx = tid; idx < G * H; idx += nth) {
        const int g = idx / H, j = idx % H;
        const int b = min(b0 + g, B - 1);
        const float* gt = bufY + g * D;
        const float gi = sigmoid_f(gt[j]);
        const float gf = sigmoid_f(gt[H + j]);
        const float gg = tanhf(gt[2 * H + j]);
        const float go = sigmoid_f(gt[3 * H + j]);
        const long long s = ((long long)k * B + b) * H + j;
        const float c2 = gf * a.c[s] + gi * gg;
        const float h2 = go * tanhf(c2);
        if (g < n_valid) {
          a.c[s] = c2;
          a.h[s] = h2;
        }
        bufZ[g * D + j] = h2;
      }
      __syncthreads();
      round_inputs<WT>(bufZ, D, G, H);
      dense<G, false, WT>(w + a.off_wup[k], w + a.off_bup[k], bufZ, D, H,
                      a.up[k] * H,
                      a.cache + b0 * cstride + (long long)a.cache_row[k] * H,
                      cstride, n_valid);
      __syncthreads();
    }

    // bottom tier: every step
    {
      const int f = a.fs[a.n_tiers - 1];
      const int row = a.cache_row[a.n_tiers - 2] + (int)(t % a.fs[a.n_tiers - 2]);
      const WT* Wb = w + a.off_wbot;
      const WT* bb = w + a.off_bbot;
      for (int idx = tid; idx < G * H; idx += nth) {
        const int g = idx / H, j = idx % H;
        const int b = min(b0 + g, B - 1);
        float acc = 0.0f;
        for (int kk = 0; kk < f; ++kk) {
          const int tok = ring[g * rf + (tm + rf - f + kk) % rf];
          const float xv = wround<WT>(((float)tok / (float)Q - 0.5f) * 2.0f);
          acc = fmaf(xv, wload(Wb + kk * H + j), acc);
        }
        acc += wload(bb + j);
        acc += a.cache[b * cstride + (long long)row * H + j];
        bufX[g * D + j] = acc;
      }
      __syncthreads();
    }

    // MLP head: Mish between layers, none after the last
    float* hin = bufX;
    float* hout = bufY;
    for (int l = 0; l < a.n_head; ++l) {
      round_inputs<WT>(hin, D, G, a.head_in[l]);
      if (l < a.n_head - 1)
        dense<G, true, WT>(w + a.off_wh[l], w + a.off_bh[l], hin, D, a.head_in[l],
                           a.head_out[l], hout, D, G);
      else
        dense<G, false, WT>(w + a.off_wh[l], w + a.off_bh[l], hin, D, a.head_in[l],
                            a.head_out[l], hout, D, G);
      __syncthreads();
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    const float* logits = hin;  // (G, Q + 1)

    // learned temperature, tempering, Gumbel noise, argmax: a warp a stream
    const int warp = tid >> 5, lane = tid & 31;
    for (int g = warp; g < G; g += nth >> 5) {
      const int b = b0 + g;
      const int bb = min(b, B - 1);
      const float* L = logits + g * D;
      const float lt = fmaxf(sigmoid_f(L[Q]), a.min_temperature);
      uint32_t htb = 0;
      float temp = 1.0f;
      if (!a.argmax) {
        htb = decode_noise_key(a.seed, t, b);
        temp = a.temperature[bb];
      }
      float best = -INFINITY;
      int bestq = 0x7fffffff;
      for (int q = lane; q < Q; q += 32) {
        float v = L[q] / lt;
        if (!a.argmax) v = v / temp + gumbel_from_bits(mix32(htb ^ (uint32_t)q));
        if (v > best) {
          best = v;
          bestq = q;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oq = __shfl_xor_sync(0xffffffffu, bestq, off);
        if (ov > best || (ov == best && oq < bestq)) {
          best = ov;
          bestq = oq;
        }
      }
      int tok = bestq == 0x7fffffff ? 0 : bestq;
      if (t < a.prior_t) tok = a.prompt[(long long)bb * a.prior_t + t];
      if (lane == 0) {
        ring[g * rf + tm] = tok;
        const long long o = t - a.out_t0;
        if (b < B && o >= 0 && o < a.out_len) a.out[(long long)b * a.out_len + o] = tok;
      }
    }
    __syncthreads();
  }

  const long long t_end = a.t0 + a.n_steps;
  for (int idx = tid; idx < G * rf; idx += nth) {
    const int g = idx / rf, p = idx % rf;
    if (g < n_valid)
      a.win[(long long)(b0 + g) * rf + p] = ring[g * rf + (int)((t_end + p) % rf)];
  }
}

template <int G, class WT>
static int launch(const SrnnDecodeArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)G * (3 * (size_t)a.dstride * sizeof(float) +
                                   (size_t)a.rf * sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(samplernn_decode_kernel<G, WT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.B + G - 1) / G;
  samplernn_decode_kernel<G, WT><<<grid, MMK_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class WT>
static int launch_group(const SrnnDecodeArgs& a, cudaStream_t s) {
  switch (a.group) {
    case 1: return launch<1, WT>(a, s);
    case 2: return launch<2, WT>(a, s);
    case 4: return launch<4, WT>(a, s);
    case 8: return launch<8, WT>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int mmk_samplernn_args_size(void) { return (int)sizeof(SrnnDecodeArgs); }

// Launch on `stream` (PyTorch's current stream); does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
int mmk_samplernn_decode(const SrnnDecodeArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return args->bf16 ? launch_group<__nv_bfloat16>(*args, s) : launch_group<float>(*args, s);
}

const char* mmk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
