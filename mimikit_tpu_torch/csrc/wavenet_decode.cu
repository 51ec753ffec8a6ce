// WaveNet autoregressive decode: the whole step loop in one kernel.
//
// Replaces the TPU kernels make_wavenet_pallas_decoder (K4, the whole
// decode in one call, mimikit_tpu/ops/pallas_decode.py:402) and
// make_wavenet_pallas_chunked (K5, the same step with the token carry and
// the dilation rings carried in and out, pallas_decode.py:559).  One
// state-carrying entry serves both: it runs `n_steps` steps from absolute
// step `t0`, reading and writing the token carry and the rings in place.
//
// Per step t (what pallas_decode.py:448-526 and :682-783 compute): the
// sample at s = t - 1 (the prompt's while s < prior_t, else the carried
// token) is embedded; per layer l with dilation d, ring slot s % d (the
// layer's input at s - d) is read before it is overwritten with the input
// at s, fg = [x(s-d) | x(s)] . [K0; K1] + b, y = tanh(fg[:D]) * sigmoid(fg[D:]),
// skips += y . Wsk + bsk, x = x + y . Wr + br (x = y on a layer without a
// residual); then the Mish MLP head gives Q+1 logits, logits[:Q] /
// max(sigmoid(l[Q]), min_temperature), then / temperature + Gumbel noise
// when sampling; argmax with ties to the first index; the token at t is the
// prompt's while t < prior_t.
//
// Design.  Streams are independent, so a block owns `group` streams (a
// launch parameter) and loops over all steps itself: no grid-wide sync.
// The rings live in device memory (4 * B * D * sum(d) bytes: 134 MB for
// WaveNet-10 at B=256), one (D,) row per stream read and written per layer
// and step (all of a step's rows are read at its start, one wait for the
// step); the layer's operands (G rows each) live in shared memory.  The
// weights (f32, 1.05M of them, 4.2 MB at full width) do not fit a block's
// 227 KB of shared memory: they are read through L2, where they stay
// resident (50 MB).  A dense product gives each thread one output column
// and a slice of the contraction (split-K, so that 1,024 threads have work
// at D = 128), G accumulators per weight load, 32 loads in flight a thread
// where a block owns at most 4 streams (16 beyond); the slices are summed in
// shared memory in a fixed order.
//
// Bound.  Per stream and step the full-width net does ~2.03 MFLOP (ten
// 256x256 gated convs, ten 128x256 skip/residual products, the head), so
// at B=256 the card's f32 rate bounds a step by operations (~7.8 us).  This
// version is bound instead by weight traffic: every block reads all 4.2 MB
// of weights from L2 each step, so an SM's L2 bandwidth sets a floor per
// step whatever the group, and more streams a block (fewer blocks) trade
// L2 traffic for fewer SMs at work; chip_smoke.py --bench sweeps the group.
// At narrow batch the chain of ~22 dependent products and ~80 block
// barriers a step sets the pace.  Weights held in shared memory across a
// cluster (each block one slice of every layer's columns) and bf16 weights
// are the later steps.
//
// Randomness: the port's counter hash of (seed, absolute t, stream, class)
// (noise.cuh), which the plain twin computes too.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "noise.cuh"

#define WN_MAX_LAYERS 64
#define WN_MAX_HEAD 8
#define WN_THREADS 1024

// Mirrors _Args in mimikit_tpu_torch/ops/wavenet_decode.py: pointers, then
// 64-bit integers, then 32-bit fields.
struct WnDecodeArgs {
  const float* w;      // packed weights (wavenet_weight_pack)
  const int* prompt;   // (B, prior_t)
  int* tok;            // (B,) token at position t0 - 1; in/out
  float* rings;        // (sum(d), B, D); in/out
  int* out;            // (B, out_len)

  long long t0;        // absolute step of the first iteration
  long long out_t0;    // absolute step written to out[:, 0]
  long long off_emb;                    // (Q, D)
  long long off_wc[WN_MAX_LAYERS];      // [K0; K1] (2D, 2D)
  long long off_bc[WN_MAX_LAYERS];      // (2D)
  long long off_wsr[WN_MAX_LAYERS];     // [W_skip | W_res] (D, S + D), or (D, S)
  long long off_bsr[WN_MAX_LAYERS];     // (S + D), or (S)
  long long ring_row[WN_MAX_LAYERS];    // first ring row of layer l
  long long off_wh[WN_MAX_HEAD];        // (head_in[k], head_out[k])
  long long off_bh[WN_MAX_HEAD];        // (head_out[k])

  int n_steps;
  int out_len;
  int B;
  int D;
  int S;
  int Q;
  int prior_t;
  int n_layers;
  int n_head;
  int argmax;
  int group;           // streams per block: 1, 2, 4, 8 or 16
  int ds;              // row stride of the shared rows, a multiple of 4
  int red;             // floats of split-K partial sums per stream
  unsigned int seed;
  float temperature;
  float min_temperature;
  int dil[WN_MAX_LAYERS];
  int has_res[WN_MAX_LAYERS];
  int head_in[WN_MAX_HEAD];
  int head_out[WN_MAX_HEAD];
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float mish_f(float x) {
  float sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

// Y[g][col] = act(X[g][:K] . W[:K][col] + bias[col]) for the G rows of X.
// W is (K, N) row-major; X rows are 16-byte aligned (xs % 4 == 0).  The
// contraction is split over `splits` thread groups; their partial sums go
// to red[g * reds + split * Np + col] and are summed in split order.  The
// caller synchronises the block after the call.
template <int G, bool MISH>
__device__ __forceinline__ void dense(const float* __restrict__ W,
                                      const float* __restrict__ bias,
                                      const float* X, int xs, int K, int N,
                                      float* Y, int ys, float* red, int reds) {
  const int Np = (N + 31) & ~31;
  int splits = (int)blockDim.x / Np;
  const int most = K / 32;  // at least 32 terms a slice
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  const int kc = (((K + splits - 1) / splits) + 3) & ~3;
  for (int idx = threadIdx.x; idx < splits * Np; idx += blockDim.x) {
    const int col = idx % Np, sp = idx / Np;
    if (col >= N) continue;
    const int k0 = sp * kc, k1 = min(K, k0 + kc);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0f;
    const float* wp = W + col;
    int k = k0;
    // LD weight loads in flight before their multiply-adds: each batch is
    // one wait on L2, so fewer, larger batches shorten the step's chain (32
    // where the G accumulators leave room in 64 registers a thread)
    constexpr int LD = G <= 4 ? 32 : 16;
    for (; k + LD <= k1; k += LD) {
      float wv[LD];
#pragma unroll
      for (int u = 0; u < LD; ++u) wv[u] = __ldg(wp + (size_t)(k + u) * N);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int u = 0; u < LD; u += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(X + g * xs + k + u);
          acc[g] = fmaf(xv.x, wv[u + 0], acc[g]);
          acc[g] = fmaf(xv.y, wv[u + 1], acc[g]);
          acc[g] = fmaf(xv.z, wv[u + 2], acc[g]);
          acc[g] = fmaf(xv.w, wv[u + 3], acc[g]);
        }
      }
    }
    for (; k + 4 <= k1; k += 4) {
      const float w0 = __ldg(wp + (size_t)(k + 0) * N);
      const float w1 = __ldg(wp + (size_t)(k + 1) * N);
      const float w2 = __ldg(wp + (size_t)(k + 2) * N);
      const float w3 = __ldg(wp + (size_t)(k + 3) * N);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 xv = *reinterpret_cast<const float4*>(X + g * xs + k);
        acc[g] = fmaf(xv.x, w0, acc[g]);
        acc[g] = fmaf(xv.y, w1, acc[g]);
        acc[g] = fmaf(xv.z, w2, acc[g]);
        acc[g] = fmaf(xv.w, w3, acc[g]);
      }
    }
    for (; k < k1; ++k) {
      const float wv = __ldg(wp + (size_t)k * N);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(X[g * xs + k], wv, acc[g]);
    }
    if (splits == 1) {
      const float bv = __ldg(bias + col);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float v = acc[g] + bv;
        if (MISH) v = mish_f(v);
        Y[g * ys + col] = v;
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) red[g * reds + sp * Np + col] = acc[g];
    }
  }
  if (splits > 1) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * N; idx += blockDim.x) {
      const int g = idx / N, col = idx % N;
      const float* r = red + g * reds + col;
      float v = r[0];
      for (int sp = 1; sp < splits; ++sp) v += r[sp * Np];
      v += __ldg(bias + col);
      if (MISH) v = mish_f(v);
      Y[g * ys + col] = v;
    }
  }
}

template <int G>
__global__ void __launch_bounds__(WN_THREADS)
wavenet_decode_kernel(const WnDecodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int ds = a.ds;
  float* rowA = smem;              // [x(s-d) | x(s)]: the layer's conv input
  float* rowB = rowA + G * ds;     // fg; then [skip | res]; head pong
  float* rowC = rowB + G * ds;     // y; head ping
  float* rowD = rowC + G * ds;     // skips
  float* red = rowD + G * ds;      // split-K partial sums, a.red per stream
  const int D = a.D, S = a.S, Q = a.Q, B = a.B, L = a.n_layers;
  const int dp = (D + 3) & ~3;
  float* rold = red + G * a.red;   // each layer's ring row x(s - d), (L, G, dp)
  int* stok = reinterpret_cast<int*>(rold + L * G * dp);  // token carry

  const int tid = threadIdx.x, nth = blockDim.x;
  const int b0 = blockIdx.x * G;
  const int n_valid = min(G, B - b0);
  const float* w = a.w;
  const float* emb = w + a.off_emb;

  if (tid < G) stok[tid] = tid < n_valid ? a.tok[b0 + tid] : 0;
  __syncthreads();

  for (int i = 0; i < a.n_steps; ++i) {
    const long long t = a.t0 + i;
    const long long s = t - 1;

    // the sample at s, embedded, is layer 0's input
    for (int idx = tid; idx < G * D; idx += nth) {
      const int g = idx / D, j = idx % D;
      const int b = min(b0 + g, B - 1);
      const int tk = s < a.prior_t ? a.prompt[(long long)b * a.prior_t + s] : stok[g];
      rowA[g * ds + D + j] = __ldg(emb + (long long)tk * D + j);
    }
    // every layer's ring slot s % d holds its input at s - d: read all of
    // them now, one wait for the step (layer l overwrites its slot later
    // in the step, after this read)
    for (int idx = tid; idx < L * G * D; idx += nth) {
      const int l = idx / (G * D), g = (idx / D) % G, j = idx % D;
      const long long row = a.ring_row[l] + s % a.dil[l];
      rold[(l * G + g) * dp + j] = g < n_valid ? a.rings[(row * B + b0 + g) * D + j] : 0.0f;
    }
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      // [x(s - d) | x(s)] is the conv's input; x(s) goes to the ring slot
      const long long row = a.ring_row[l] + s % a.dil[l];
      for (int idx = tid; idx < G * D; idx += nth) {
        const int g = idx / D, j = idx % D;
        if (g < n_valid) a.rings[(row * B + b0 + g) * D + j] = rowA[g * ds + D + j];
        rowA[g * ds + j] = rold[(l * G + g) * dp + j];
      }
      __syncthreads();
      dense<G, false>(w + a.off_wc[l], w + a.off_bc[l], rowA, ds, 2 * D, 2 * D, rowB, ds,
                      red, a.red);
      __syncthreads();
      for (int idx = tid; idx < G * D; idx += nth) {
        const int g = idx / D, j = idx % D;
        rowC[g * ds + j] = tanhf(rowB[g * ds + j]) * sigmoid_f(rowB[g * ds + D + j]);
      }
      __syncthreads();
      const int res = a.has_res[l];
      dense<G, false>(w + a.off_wsr[l], w + a.off_bsr[l], rowC, ds, D, S + (res ? D : 0),
                      rowB, ds, red, a.red);
      __syncthreads();
      const int W2 = max(S, D);
      for (int idx = tid; idx < G * W2; idx += nth) {
        const int g = idx / W2, j = idx % W2;
        if (j < S) rowD[g * ds + j] = (l == 0 ? 0.0f : rowD[g * ds + j]) + rowB[g * ds + j];
        if (j < D)
          rowA[g * ds + D + j] = res ? rowA[g * ds + D + j] + rowB[g * ds + S + j]
                                     : rowC[g * ds + j];
      }
      __syncthreads();
    }

    // MLP head on the skips: Mish between layers, none after the last
    const float* hin = rowD;
    for (int k = 0; k < a.n_head; ++k) {
      float* hout = (k & 1) ? rowC : rowB;
      if (k < a.n_head - 1)
        dense<G, true>(w + a.off_wh[k], w + a.off_bh[k], hin, ds, a.head_in[k],
                       a.head_out[k], hout, ds, red, a.red);
      else
        dense<G, false>(w + a.off_wh[k], w + a.off_bh[k], hin, ds, a.head_in[k],
                        a.head_out[k], hout, ds, red, a.red);
      __syncthreads();
      hin = hout;
    }
    const float* logits = hin;  // (G, Q + 1)

    // learned temperature, tempering, Gumbel noise, argmax: a warp a stream
    const int warp = tid >> 5, lane = tid & 31;
    for (int g = warp; g < G; g += nth >> 5) {
      const int b = b0 + g;
      const int bb = min(b, B - 1);
      const float* L = logits + g * ds;
      const float lt = fmaxf(sigmoid_f(L[Q]), a.min_temperature);
      uint32_t key = 0;
      if (!a.argmax) key = decode_noise_key(a.seed, t, b);
      float best = -INFINITY;
      int bestq = 0x7fffffff;
      for (int q = lane; q < Q; q += 32) {
        float v = L[q] / lt;
        if (!a.argmax) v = v / a.temperature + gumbel_from_bits(mix32(key ^ (uint32_t)q));
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
      int tk = bestq == 0x7fffffff ? 0 : bestq;
      if (t < a.prior_t) tk = a.prompt[(long long)bb * a.prior_t + t];
      if (lane == 0) {
        stok[g] = tk;
        const long long o = t - a.out_t0;
        if (b < B && o >= 0 && o < a.out_len) a.out[(long long)b * a.out_len + o] = tk;
      }
    }
    __syncthreads();
  }

  if (tid < n_valid) a.tok[b0 + tid] = stok[tid];
}

template <int G>
static int launch(const WnDecodeArgs& a, cudaStream_t stream) {
  const size_t dp = (size_t)((a.D + 3) & ~3);
  const size_t smem = (size_t)G * ((4 * (size_t)a.ds + (size_t)a.red + a.n_layers * dp) *
                                       sizeof(float) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(wavenet_decode_kernel<G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.B + G - 1) / G;
  wavenet_decode_kernel<G><<<grid, WN_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

int mmk_wavenet_args_size(void) { return (int)sizeof(WnDecodeArgs); }

// Launch on `stream` (PyTorch's current stream); does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
int mmk_wavenet_decode(const WnDecodeArgs* args, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (args->group) {
    case 1: return launch<1>(*args, s);
    case 2: return launch<2>(*args, s);
    case 4: return launch<4>(*args, s);
    case 8: return launch<8>(*args, s);
    case 16: return launch<16>(*args, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mmk_wavenet_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
