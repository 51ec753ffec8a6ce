// Device code shared by the two SimpleTransformer decode kernels
// (transformer_decode.cu, K6; transformer_kv.cu, K7).
//
// Both kernels are one persistent cooperative launch: every block of the grid
// (one a streaming multiprocessor) works on each stage of a step, and a grid
// barrier (cooperative_groups::this_grid().sync(); 1.1 us on the 132 blocks
// of an H100, tools/profile_transformer_decode.py) separates dependent stages.  A stage is one of:
//
//  * a tiled f32 product Y = act(X . W + b) (+ residual) over every block
//    (gemm_stage): a block owns one output tile of 16 rows x 16 columns at a
//    time, so each weight tile is read once a step for every 16 rows.  K runs
//    in chunks of 128; a chunk's operands arrive as four 16-byte loads a
//    thread, issued together, the next chunk's in flight during the current
//    one's products.  X's rows can be layer-normed as they are loaded (the
//    norm that ends the previous sub-layer); the blocks that own the tiles
//    of the first 16 columns then write the normed rows out for the residual
//    of the next product;
//  * attention (attn_block): a block a (stream, head[, block of 16 query
//    rows]), the keys and values staged in shared memory, a warp a query;
//  * the head and the sampling, a block a stream, the dense layers split
//    over K so that each thread has few dependent loads.
//
// Arithmetic: f32 on CUDA cores, fused multiply-adds summed in k order, the
// layer norm as flax computes it (var = max(0, E[x^2] - E[x]^2), eps 1e-5),
// exact expf/logf/sqrtf.  Data written during the launch (activations,
// tokens, rings) is read with plain loads (never the read-only path), after a
// grid barrier.  The products need d and ff to be multiples of 4 (the 16-byte
// loads); the gate (ops/transformer_decode.supports_kernel_decode) checks it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "noise.cuh"

namespace cg = cooperative_groups;

#define TF_THREADS 256
#define TF_WARPS (TF_THREADS / 32)
#define TF_BM 16
#define TF_BN 16
#define TF_BK 128
#define TF_AP (TF_BK + 4)  // row pitch of the X chunk in shared memory
#define TF_QB 16           // query rows a window-attention task
#define TF_MAX_HEAD 8

// A layer's tensors, in LAYER_KINDS order (mimikit_tpu_torch/ops/transformer_decode.py).
enum TfKind {
  K_WQKV, K_BQKV, K_WO, K_BO, K_WCQ, K_BCQ, K_WCO, K_BCO,
  K_LN1W, K_LN1B, K_LN2W, K_LN2B, K_LN3W, K_LN3B, K_W1, K_B1, K_W2, K_B2, TF_N_KINDS
};

__device__ __forceinline__ float tf_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float tf_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float tf_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float tf_mish(float x) {
  const float sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

// The scratch activations of one launch, for M rows (B * rf for K6, B for K7).
struct TfBufs {
  float* x0;   // (M, d) the PE'd input (the cross-attention's memory)
  float* x;    // (M, d) a sub-layer's input after its norm
  float* h;    // (M, d) a sub-layer's output before its norm
  float* qkv;  // (M, 3d) self q | k | v
  float* att;  // (M, d) attention output
  float* cq;   // (M, d) cross q
  float* ckv;  // (M, 2Ld) every layer's cross k | v
  float* ff;   // (M, ff) FFN hidden
};

__host__ __device__ inline long long tf_scratch_floats(long long M, int d, int ff, int L) {
  return M * (8LL * d + 2LL * L * d + ff);
}

__device__ __forceinline__ TfBufs tf_bufs(float* s, long long M, int d, int ff, int L) {
  TfBufs b;
  b.x0 = s;
  b.x = b.x0 + M * d;
  b.h = b.x + M * d;
  b.qkv = b.h + M * d;
  b.att = b.qkv + 3 * M * d;
  b.cq = b.att + M * d;
  b.ckv = b.cq + M * d;
  b.ff = b.ckv + 2LL * L * M * d;
  return b;
}

__host__ __device__ inline int tf_round4(int n) { return (n + 3) & ~3; }

// Shared memory of an attention task over n_keys keys and n_q queries of
// head width dh, in floats.
__host__ __device__ inline int tf_attn_floats(int n_keys, int n_q, int dh) {
  return tf_round4(n_keys * (dh + 1)) + tf_round4(n_keys * dh) + tf_round4(n_q * dh) +
         TF_WARPS * tf_round4(n_keys);
}

// Dynamic shared memory of one block, in floats: the largest stage's.
__host__ inline long long tf_smem_floats(int d, int n_heads, int rf, int n_q, int n_head,
                                         const int* head_in, const int* head_out) {
  long long gemm = TF_BM * TF_AP + TF_BK * TF_BN + 2 * TF_BM;
  long long attn = tf_attn_floats(rf, n_q, d / n_heads);
  int w = 0;
  for (int k = 0; k < n_head; ++k) {
    if (head_in[k] > w) w = head_in[k];
    if (head_out[k] > w) w = head_out[k];
  }
  const int w32 = (w + 31) & ~31;
  long long head = tf_round4(d) + 2LL * tf_round4(w) + (w32 > TF_THREADS ? w32 : TF_THREADS) +
                   2 * TF_WARPS;
  long long m = gemm > attn ? gemm : attn;
  return m > head ? m : head;
}

// -- products ---------------------------------------------------------------------

struct GemmJob {
  const float* X;     // (M, K) rows, leading dimension ldx
  int ldx;
  const float* ln_w;  // non-null: each X row is layer-normed (over its K values) on load
  const float* ln_b;
  float* xout;        // non-null (with ln_w): the normed rows are written here, (M, K)
  const float* W;     // (K, N) row-major, leading dimension ldw; read-only
  int ldw;
  const float* bias;  // (N), read-only
  const float* res;   // non-null: a residual (M, N) added last, leading dimension ldr
  int ldr;
  float* Y;           // (M, N), leading dimension ldy
  int ldy;
  int M, N, K, relu;
};

__device__ __forceinline__ int gemm_tiles(const GemmJob& j) {
  return ((j.M + TF_BM - 1) / TF_BM) * ((j.N + TF_BN - 1) / TF_BN);
}

// One K chunk of the tile's operands into registers: two float4 of X (rows 8
// apart) and two of W (rows 64 apart) a thread, all four loads issued together.
__device__ __forceinline__ void gemm_load(const GemmJob& j, int m0, int n0, int k0, float4 (&ra)[2],
                                          float4 (&rw)[2]) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int idx = threadIdx.x + u * TF_THREADS;
    const int r = idx / (TF_BK / 4), k = 4 * (idx % (TF_BK / 4));
    const int m = m0 + r, kk = k0 + k;
    ra[u] = (m < j.M && kk < j.K)
                ? *reinterpret_cast<const float4*>(j.X + (long long)m * j.ldx + kk)
                : zero;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int idx = threadIdx.x + u * TF_THREADS;
    const int k = idx / (TF_BN / 4), c = 4 * (idx % (TF_BN / 4));
    const int kk = k0 + k, n = n0 + c;
    rw[u] = (kk < j.K && n < j.N)
                ? __ldg(reinterpret_cast<const float4*>(j.W + (long long)kk * j.ldw + n))
                : zero;
  }
}

// The chunk from registers into shared memory, X normed on the way when the
// job has a norm.
__device__ __forceinline__ void gemm_store(const GemmJob& j, int m0, int k0, const float4 (&ra)[2],
                                           const float4 (&rw)[2], float* As, float* Ws,
                                           const float* mean, const float* rstd) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int idx = threadIdx.x + u * TF_THREADS;
    const int r = idx / (TF_BK / 4), k = 4 * (idx % (TF_BK / 4));
    const int kk = k0 + k;
    float4 v = ra[u];
    if (j.ln_w != nullptr && m0 + r < j.M && kk < j.K) {
      const float4 g = __ldg(reinterpret_cast<const float4*>(j.ln_w + kk));
      const float4 b = __ldg(reinterpret_cast<const float4*>(j.ln_b + kk));
      const float mu = mean[r], rs = rstd[r];
      v = make_float4((v.x - mu) * rs * g.x + b.x, (v.y - mu) * rs * g.y + b.y,
                      (v.z - mu) * rs * g.z + b.z, (v.w - mu) * rs * g.w + b.w);
    }
    *reinterpret_cast<float4*>(As + r * TF_AP + k) = v;
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
    *reinterpret_cast<float4*>(Ws + 4 * (threadIdx.x + u * TF_THREADS)) = rw[u];
}

// One 16 x 16 output tile: thread (tx, ty) owns row ty, column tx.
__device__ __forceinline__ void gemm_tile(const GemmJob& j, int m0, int n0, bool write_x,
                                          float* smem) {
  float* As = smem;                    // [TF_BM][TF_AP]: the X chunk, row-major
  float* Ws = As + TF_BM * TF_AP;      // [TF_BK][TF_BN]
  float* mean = Ws + TF_BK * TF_BN;    // [TF_BM]
  float* rstd = mean + TF_BM;          // [TF_BM]
  const int tid = threadIdx.x, tx = tid % TF_BN, ty = tid / TF_BN;
  const int warp = tid >> 5, lane = tid & 31;
  float4 ra[2], rw[2];
  gemm_load(j, m0, n0, 0, ra, rw);
  if (j.ln_w != nullptr) {
    for (int r = warp; r < TF_BM; r += TF_WARPS) {
      const int m = m0 + r;
      float s = 0.0f, s2 = 0.0f;
      const float* xr = j.X + (long long)m * j.ldx;
      if (m < j.M) {
#pragma unroll 8
        for (int k = lane; k < j.K; k += 32) {
          const float v = xr[k];
          s += v;
          s2 = fmaf(v, v, s2);
        }
      }
      s = tf_warp_sum(s);
      s2 = tf_warp_sum(s2);
      const float mu = s / (float)j.K;
      const float var = fmaxf(s2 / (float)j.K - mu * mu, 0.0f);
      const float rs = 1.0f / sqrtf(var + 1e-5f);
      if (lane == 0) {
        mean[r] = mu;
        rstd[r] = rs;
      }
      if (write_x && m < j.M) {
#pragma unroll 8
        for (int k = lane; k < j.K; k += 32)
          j.xout[(long long)m * j.K + k] =
              (xr[k] - mu) * rs * __ldg(j.ln_w + k) + __ldg(j.ln_b + k);
      }
    }
    __syncthreads();
  }
  float acc = 0.0f;
  for (int k0 = 0; k0 < j.K; k0 += TF_BK) {
    gemm_store(j, m0, k0, ra, rw, As, Ws, mean, rstd);
    __syncthreads();
    if (k0 + TF_BK < j.K) gemm_load(j, m0, n0, k0 + TF_BK, ra, rw);
    const float* a = As + ty * TF_AP;
#pragma unroll 8
    for (int k = 0; k < TF_BK; k += 4) {
      const float4 av = *reinterpret_cast<const float4*>(a + k);
      acc = fmaf(av.x, Ws[(k + 0) * TF_BN + tx], acc);
      acc = fmaf(av.y, Ws[(k + 1) * TF_BN + tx], acc);
      acc = fmaf(av.z, Ws[(k + 2) * TF_BN + tx], acc);
      acc = fmaf(av.w, Ws[(k + 3) * TF_BN + tx], acc);
    }
    __syncthreads();
  }
  const int m = m0 + ty, n = n0 + tx;
  if (m < j.M && n < j.N) {
    float v = acc + (j.bias != nullptr ? __ldg(j.bias + n) : 0.0f);
    if (j.relu) v = fmaxf(v, 0.0f);
    if (j.res != nullptr) v = j.res[(long long)m * j.ldr + n] + v;
    j.Y[(long long)m * j.ldy + n] = v;
  }
}

// Every tile of the jobs, spread over the grid (consecutive blocks take the
// row tiles of one column tile).  The caller puts a grid barrier after it.
__device__ __forceinline__ void gemm_stage(const GemmJob* jobs, int n_jobs, float* smem) {
  int total = 0;
  for (int q = 0; q < n_jobs; ++q) total += gemm_tiles(jobs[q]);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int q = 0, tt = t;
    while (tt >= gemm_tiles(jobs[q])) {
      tt -= gemm_tiles(jobs[q]);
      ++q;
    }
    const GemmJob& j = jobs[q];
    const int tm = (j.M + TF_BM - 1) / TF_BM;
    const int mt = tt % tm, nt = tt / tm;
    gemm_tile(j, mt * TF_BM, nt * TF_BN, j.xout != nullptr && nt == 0, smem);
    __syncthreads();
  }
}

__device__ __forceinline__ GemmJob gemm_job(const float* X, int ldx, const float* W, int ldw,
                                            const float* bias, float* Y, int ldy, int M, int N,
                                            int K) {
  GemmJob j;
  j.X = X;
  j.ldx = ldx;
  j.ln_w = nullptr;
  j.ln_b = nullptr;
  j.xout = nullptr;
  j.W = W;
  j.ldw = ldw;
  j.bias = bias;
  j.res = nullptr;
  j.ldr = 0;
  j.Y = Y;
  j.ldy = ldy;
  j.M = M;
  j.N = N;
  j.K = K;
  j.relu = 0;
  return j;
}

// -- attention (a block a task) ---------------------------------------------------------

// One head's attention for n_q query rows over n_keys key rows, by the block:
// query i sees keys 0 .. i (causal) or all n_keys.  Q, K, V point at the
// head's first row (leading dimensions ldq, ldk, ldv); out rows have leading
// dimension ldo.  Scores are q . k * inv (q_first: each q element scaled
// first, as K6 and the window twin scale; else the sum scaled, as the KV
// oracle does), masked keys excluded, softmax with the max over this head's
// own scores, then the weighted sum of the values.
__device__ __forceinline__ void attn_block(const float* Q, int ldq, const float* K, int ldk,
                                           const float* V, int ldv, float* out, int ldo,
                                           int n_q, int n_keys, int q_offset, bool causal,
                                           int dh, float inv, bool q_first, float* smem) {
  float* Ks = smem;                                   // [n_keys][dh + 1]
  float* Vs = Ks + tf_round4(n_keys * (dh + 1));      // [n_keys][dh]
  float* Qs = Vs + tf_round4(n_keys * dh);            // [n_q][dh]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = Qs + tf_round4(n_q * dh) + warp * tf_round4(n_keys);
#pragma unroll 4
  for (int idx = threadIdx.x; idx < n_keys * dh; idx += TF_THREADS) {
    const int r = idx / dh, c = idx % dh;
    Ks[r * (dh + 1) + c] = K[(long long)r * ldk + c];
    Vs[idx] = V[(long long)r * ldv + c];
  }
  for (int idx = threadIdx.x; idx < n_q * dh; idx += TF_THREADS) {
    const int r = idx / dh, c = idx % dh;
    const float q = Q[(long long)r * ldq + c];
    Qs[idx] = q_first ? q * inv : q;
  }
  __syncthreads();
  for (int i = warp; i < n_q; i += TF_WARPS) {
    const int cnt = causal ? q_offset + i + 1 : n_keys;
    const float* q = Qs + i * dh;
    float mx = -INFINITY;
    for (int j = lane; j < cnt; j += 32) {
      const float* k = Ks + j * (dh + 1);
      float sc = 0.0f;
#pragma unroll 8
      for (int c = 0; c < dh; ++c) sc = fmaf(q[c], k[c], sc);
      if (!q_first) sc *= inv;
      p[j] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = tf_warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < cnt; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = tf_warp_sum(sum);
    __syncwarp();
    for (int c = lane; c < dh; c += 32) {
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < cnt; ++j) acc = fmaf(p[j] / sum, Vs[j * dh + c], acc);
      out[(long long)i * ldo + c] = acc;
    }
    __syncwarp();
  }
  __syncthreads();
}

// -- the head and the sampling (a block a stream) -----------------------------------

// Block-wide sums of a and b (all threads get them); `red` holds 2 * TF_WARPS floats.
__device__ __forceinline__ void tf_block_sum2(float& a, float& b, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = tf_warp_sum(a);
  b = tf_warp_sum(b);
  if (lane == 0) {
    red[warp] = a;
    red[TF_WARPS + warp] = b;
  }
  __syncthreads();
  a = 0.0f;
  b = 0.0f;
  for (int w = 0; w < TF_WARPS; ++w) {
    a += red[w];
    b += red[TF_WARPS + w];
  }
  __syncthreads();
}

// x (d) in shared memory, normed in place.
__device__ __forceinline__ void tf_block_ln(float* x, int d, const float* g, const float* b,
                                            float* red) {
  float s = 0.0f, s2 = 0.0f;
  for (int k = threadIdx.x; k < d; k += TF_THREADS) {
    s += x[k];
    s2 = fmaf(x[k], x[k], s2);
  }
  tf_block_sum2(s, s2, red);
  const float mu = s / (float)d;
  const float var = fmaxf(s2 / (float)d - mu * mu, 0.0f);
  const float rs = 1.0f / sqrtf(var + 1e-5f);
  for (int k = threadIdx.x; k < d; k += TF_THREADS)
    x[k] = (x[k] - mu) * rs * __ldg(g + k) + __ldg(b + k);
  __syncthreads();
}

// out[c] = act(in . W[:, c] + bias[c]) for c < N, W (K, N) row-major, by the
// block: the contraction split over as many thread groups as fit (at least
// 32 terms a group), the groups' partial sums added in group order.
__device__ __forceinline__ void tf_block_dense(const float* in, int K, int N, const float* W,
                                               const float* bias, bool mish, float* out,
                                               float* red) {
  const int Np = (N + 31) & ~31;
  int groups = TF_THREADS / Np;
  if (groups > K / 32) groups = K / 32;
  if (groups < 1) groups = 1;
  const int kc = (K + groups - 1) / groups;
  for (int idx = threadIdx.x; idx < groups * Np; idx += TF_THREADS) {
    const int c = idx % Np, g = idx / Np;
    if (c >= N) continue;
    const int k1 = min(K, (g + 1) * kc);
    float acc = 0.0f;
#pragma unroll 16
    for (int k = g * kc; k < k1; ++k) acc = fmaf(in[k], __ldg(W + (long long)k * N + c), acc);
    red[g * Np + c] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += TF_THREADS) {
    float v = red[c];
    for (int g = 1; g < groups; ++g) v += red[g * Np + c];
    v += __ldg(bias + c);
    out[c] = mish ? tf_mish(v) : v;
  }
  __syncthreads();
}

struct TfHead {
  const float* w;                // packed weights
  const float* ln_w;             // the last layer's third norm
  const float* ln_b;
  const float* lnf_w;            // the final norm, or null
  const float* lnf_b;
  long long off_wh[TF_MAX_HEAD];
  long long off_bh[TF_MAX_HEAD];
  int head_in[TF_MAX_HEAD];
  int head_out[TF_MAX_HEAD];
  int n_head, d, Q, argmax;
  unsigned int seed;
  float temperature, min_temperature;
};

// Layer l's tensor `kind` in the packed weights of either kernel's arguments.
template <class A>
__device__ __forceinline__ const float* tf_layer_w(const A& a, int l, int kind) {
  return a.w + a.off_layer[kind] + (long long)l * a.layer_stride;
}

// The head's view of either kernel's arguments.
template <class A>
__device__ __forceinline__ TfHead tf_head_args(const A& a) {
  TfHead hd;
  hd.w = a.w;
  hd.ln_w = tf_layer_w(a, a.n_layers - 1, K_LN3W);
  hd.ln_b = tf_layer_w(a, a.n_layers - 1, K_LN3B);
  hd.lnf_w = a.final_ln ? a.w + a.off_lnf_w : nullptr;
  hd.lnf_b = a.final_ln ? a.w + a.off_lnf_b : nullptr;
  for (int k = 0; k < TF_MAX_HEAD; ++k) {
    hd.off_wh[k] = a.off_wh[k];
    hd.off_bh[k] = a.off_bh[k];
    hd.head_in[k] = a.head_in[k];
    hd.head_out[k] = a.head_out[k];
  }
  hd.n_head = a.n_head;
  hd.d = a.d;
  hd.Q = a.Q;
  hd.argmax = a.argmax;
  hd.seed = a.seed;
  hd.temperature = a.temperature;
  hd.min_temperature = a.min_temperature;
  return hd;
}

// The token after one stream's last row `src` (before the last layer's third
// norm): the norms, the Mish MLP, logits[:Q] / max(sigmoid(logits[Q]),
// min_temperature), / temperature + the noise of (seed, t, b) when sampling,
// argmax with ties to the lowest index.  Every thread returns the token.
__device__ __forceinline__ int tf_head_token(const TfHead& hd, const float* src, long long t,
                                             int b, float* smem) {
  const int d = hd.d;
  int w = 0;
  for (int k = 0; k < hd.n_head; ++k) w = max(w, max(hd.head_in[k], hd.head_out[k]));
  float* x = smem;
  float* h0 = x + tf_round4(d);
  float* h1 = h0 + tf_round4(w);
  float* red = h1 + tf_round4(w);  // max(TF_THREADS, 32-rounded w) floats
  for (int k = threadIdx.x; k < d; k += TF_THREADS) x[k] = src[k];
  __syncthreads();
  tf_block_ln(x, d, hd.ln_w, hd.ln_b, red);
  if (hd.lnf_w != nullptr) tf_block_ln(x, d, hd.lnf_w, hd.lnf_b, red);
  const float* in = x;
  for (int k = 0; k < hd.n_head; ++k) {
    float* out = (k & 1) ? h1 : h0;
    tf_block_dense(in, hd.head_in[k], hd.head_out[k], hd.w + hd.off_wh[k], hd.w + hd.off_bh[k],
                   k < hd.n_head - 1, out, red);
    in = out;
  }
  const int Q = hd.Q;
  const float lt = fmaxf(tf_sigmoid(in[Q]), hd.min_temperature);
  const uint32_t key = hd.argmax ? 0u : decode_noise_key(hd.seed, t, b);
  float best = -INFINITY;
  int bestq = 0x7fffffff;
  for (int q = threadIdx.x; q < Q; q += TF_THREADS) {
    float v = in[q] / lt;
    if (!hd.argmax) v = v / hd.temperature + gumbel_from_bits(mix32(key ^ (uint32_t)q));
    if (v > best) {
      best = v;
      bestq = q;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oq = __shfl_xor_sync(0xffffffffu, bestq, o);
    if (ov > best || (ov == best && oq < bestq)) {
      best = ov;
      bestq = oq;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* ired = reinterpret_cast<int*>(red);
  if (lane == 0) {
    red[warp] = best;
    ired[TF_WARPS + warp] = bestq;
  }
  __syncthreads();
  float bv = red[0];
  int bq = ired[TF_WARPS];
  for (int k = 1; k < TF_WARPS; ++k) {
    const float ov = red[k];
    const int oq = ired[TF_WARPS + k];
    if (ov > bv || (ov == bv && oq < bq)) {
      bv = ov;
      bq = oq;
    }
  }
  __syncthreads();
  return bq == 0x7fffffff ? 0 : bq;
}

// -- launch ---------------------------------------------------------------------------

// One block per streaming multiprocessor, launched cooperatively (the grid
// barriers need every block resident).  Returns the cudaError_t.
static int tf_launch_cooperative(const void* fn, void* args, size_t smem, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, TF_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {args};
  e = cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(TF_THREADS), kargs, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
