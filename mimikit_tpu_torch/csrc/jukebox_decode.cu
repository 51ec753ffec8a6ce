// JukeBox tier-pyramid decode: the whole autoregressive loop in one launch.
//
// Replaces the TPU kernel make_jukebox_pallas_decoder (K8,
// mimikit_tpu/ops/pallas_decode.py:2386; gate supports_pallas_jukebox :2227,
// pack jukebox_weight_pack :2286).  Per step and stream, from the (W,) lead
// window (the last W - 1 tokens and a never-read placeholder for the position
// being predicted): linearise the tokens as (tok / Q - 0.5) * 2; for each
// upper tier i of frame size f, frame the span [fs0 - f, W - f) into n_i
// frames, framed dense + the tier above's up-sampled rows + PE[frame], then
// the post-norm layers (causal self-attention, causal cross-attention on the
// tier's PE'd input, a Mish or ReLU FFN, three layer norms), tanh and the
// linear up-sampler (for the last upper tier only the chunk the bottom reads,
// the last of its last frame); the bottom's framed conv over window slots
// W - 1 - fs_b .. W - 2 plus that row; the Mish head, logits / max(sigmoid(
// extra logit), min_temperature), / the stream's temperature + Gumbel noise when sampling,
// argmax (ties to the lowest index); the token fills the placeholder, the
// oldest token drops out and a new placeholder is appended.
//
// Bound.  jukebox3 (d 128, 8 heads, ff 256, 2 layers a tier, W 128, frames
// (32, 16, 4): 3 and 6 frames) needs 6.19 MFLOP a stream-step for its output:
// tier 0 in full, tier 1 in full up to its last layer, where only the last
// frame's query, attention and FFN feed the bottom, the last 128 of tier 1's
// 2,048 up-sampler columns, the bottom conv and the head.  That is 0.378 ms
// for B=1 x 4,096 steps at the card's 67 TFLOP/s of f32 (6.05 ms at B=16);
// the 4.6 MB of weights read once are far below it.  This kernel computes
// every row of the last layer, ~7.5 MFLOP a stream-step.
//
// Design.  The step is tiny and deep: products of 3 or 6 rows by 128-384
// columns, ~40 dependent stages.  A persistent grid with a grid barrier
// between stages (the SimpleTransformer kernels' design) would pay ~40
// barriers of ~1.1 us a step.  Here a block owns a stream for its whole
// decode (no grid barrier; blocks loop over streams when B exceeds the
// grid): the window lives in shared memory as a ring, every activation of a
// step too, and a stage ends with a block barrier.  Each block reads the
// ~3.5 MB of weights a step uses from L2: a product gives a thread four
// adjacent output columns for every row (a 16-byte weight load serves up to
// 8 rows) and a slice of K, with 8 loads in flight; the K slices' partial
// sums meet in shared memory.  So a step is bound by one SM's L2 read rate
// and the chain of ~60 block-barrier stages, each opening on an L2 round
// trip; B streams cost about the same as one up to one stream an SM.  This
// kernel serves batches of more than _K8_CLUSTER_MAX_B streams
// (ops/jukebox_decode.decode_pyramid); narrower ones go to the cluster kernel
// of jukebox_cluster.cu, which spreads one stream over a thread-block
// cluster and keeps each block's slice of the weights in its shared memory.
//
// Randomness: the port's counter hash of (seed, absolute position, stream,
// class) (noise.cuh), which the plain twin computes too.

#include "transformer_common.cuh"

#define JB_THREADS 512
#define JB_WARPS (JB_THREADS / 32)
#define JB_MAXR 8           // rows one pass of a product keeps in registers
#define JB_MAXN 2048        // columns of the widest product
#define JB_MAX_TIERS 4
#define JB_MAX_HEAD 8

// Mirrors _Args in mimikit_tpu_torch/ops/jukebox_decode.py.
struct JbArgs {
  const float* w;   // packed weights (jukebox_weight_pack)
  int* window;      // (B, W) lead windows, advanced in place
  int* out;         // (B, n_steps) tokens
  long long off_in_w[JB_MAX_TIERS];   // framed dense (f, d)
  long long off_in_b[JB_MAX_TIERS];
  long long off_pe[JB_MAX_TIERS];     // (n_i, d)
  long long off_ckv_w[JB_MAX_TIERS];  // (d, 2Ld) every layer's cross [Wk | Wv]
  long long off_ckv_b[JB_MAX_TIERS];
  long long off_up_w[JB_MAX_TIERS];   // (d, t d)
  long long off_up_b[JB_MAX_TIERS];
  long long off_layer[JB_MAX_TIERS][TF_N_KINDS];  // layer 0's; layer l's lie l strides on
  long long layer_stride[JB_MAX_TIERS];
  long long off_bot_w;                // (fs_b, d)
  long long off_bot_b;
  long long off_wh[JB_MAX_HEAD];
  long long off_bh[JB_MAX_HEAD];
  long long t0;                       // absolute position of the first token
  int frame[JB_MAX_TIERS + 1];        // frame sizes, the bottom's last
  int n_frames[JB_MAX_TIERS];
  int t_up[JB_MAX_TIERS];
  int head_in[JB_MAX_HEAD];
  int head_out[JB_MAX_HEAD];          // columns, padded to a multiple of 4
  int n_up;
  int B;
  int n_steps;
  int W;
  int d;
  int n_heads;
  int ff;
  int n_layers;
  int Q;
  int n_head;
  int rows;                           // the most frames of a tier
  int head_width;                     // the widest head layer (padded)
  int mish_ffn;
  int argmax;
  unsigned int seed;
  const float* temperature;  // (B,) a stream's temperature, read when sampling
  float min_temperature;
  float inv_sqrt_dh;                  // 1 / sqrt(d / n_heads), rounded as the plain twin rounds it
};

__host__ __device__ inline long long jb_smem_floats(int W, int rows, int d, int ff, int L,
                                                    int head_width) {
  const int hw = tf_round4(d > head_width ? d : head_width);
  return (long long)JB_MAXR * JB_MAXN + 2LL * tf_round4(W) +
         (long long)rows * (8LL * d + 2LL * L * d + ff) + 2LL * hw + 2 * JB_WARPS;
}

// A stream's shared-memory buffers.
struct JbSmem {
  float* red;   // partial sums of a product
  float* lin;   // (W) linearised window, in order
  int* ring;    // (W) the window as a ring: slot j is ring[(head + j) % W]
  float* x0;    // (rows, d) a tier's PE'd input (the cross-attention's memory)
  float* x;     // (rows, d) a sub-layer's input after its norm
  float* h;     // (rows, d) a sub-layer's output before its norm
  float* att;   // (rows, d) attention output
  float* xup;   // (rows, d) the tier above's up-sampled rows; the bottom's row
  float* qkv;   // (rows, 3d) self q | k | v, or cross q
  float* mkv;   // (rows, 2Ld) every layer's cross k | v
  float* ffh;   // (rows, ff) FFN hidden
  float* hb0;   // head rows
  float* hb1;
  float* ared;  // (2 * JB_WARPS) the argmax's partials
};

__device__ inline JbSmem jb_carve(float* s, const JbArgs& a) {
  JbSmem m;
  const long long R = a.rows, d = a.d;
  const int hw = tf_round4(a.d > a.head_width ? a.d : a.head_width);
  m.red = s;
  m.lin = m.red + JB_MAXR * JB_MAXN;
  m.ring = reinterpret_cast<int*>(m.lin + tf_round4(a.W));
  m.x0 = reinterpret_cast<float*>(m.ring) + tf_round4(a.W);
  m.x = m.x0 + R * d;
  m.h = m.x + R * d;
  m.att = m.h + R * d;
  m.xup = m.att + R * d;
  m.qkv = m.xup + R * d;
  m.mkv = m.qkv + 3 * R * d;
  m.ffh = m.mkv + 2LL * a.n_layers * R * d;
  m.hb0 = m.ffh + R * a.ff;
  m.hb1 = m.hb0 + hw;
  m.ared = m.hb1 + hw;
  return m;
}

// Y[r, c] = act(sum_k X[r, k] W[k, c] + bias[c]) (+ res[r, c]) for r < M,
// c < N, by the block.  X, res and Y lie in shared memory (leading dimensions
// ldx, ldr, ldy), W (K, N; leading dimension ldw) and bias in device memory,
// read-only.  N and ldw are multiples of 4, N <= JB_MAXN.  A thread owns four
// adjacent columns of up to JB_MAXR rows and a slice of K (8 weight loads in
// flight); the slices' partial sums are added in slice order.  act: 0 none,
// 1 ReLU, 2 Mish.  Ends with a block barrier.
__device__ __noinline__ void jb_gemm(const float* X, int ldx, int M, int K, const float* W, int ldw,
                                     int N, const float* bias, int act, const float* res, int ldr,
                                     float* Y, int ldy, float* red) {
  const int N4 = N >> 2;
  int groups = N4 >= JB_THREADS ? 1 : JB_THREADS / N4;
  if (groups > K) groups = K;
  const int kc = (K + groups - 1) / groups;
  for (int r0 = 0; r0 < M; r0 += JB_MAXR) {
    const int m = min(JB_MAXR, M - r0);
    const float* Xr = X + (long long)r0 * ldx;
    for (int idx = threadIdx.x; idx < groups * N4; idx += JB_THREADS) {
      const int c4 = idx % N4, g = idx / N4;
      const int k0 = g * kc, k1 = min(K, k0 + kc);
      float4 acc[JB_MAXR];
#pragma unroll
      for (int r = 0; r < JB_MAXR; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float* wp = W + 4 * c4;
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wp + (long long)k * ldw));
#pragma unroll
        for (int r = 0; r < JB_MAXR; ++r) {
          if (r < m) {
            const float xv = Xr[r * ldx + k];
            acc[r].x = fmaf(xv, wv.x, acc[r].x);
            acc[r].y = fmaf(xv, wv.y, acc[r].y);
            acc[r].z = fmaf(xv, wv.z, acc[r].z);
            acc[r].w = fmaf(xv, wv.w, acc[r].w);
          }
        }
      }
      float* rp = red + (long long)g * m * N + 4 * c4;
#pragma unroll
      for (int r = 0; r < JB_MAXR; ++r)
        if (r < m) *reinterpret_cast<float4*>(rp + (long long)r * N) = acc[r];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < m * N; idx += JB_THREADS) {
      const int r = idx / N, c = idx - r * N;
      float v = red[idx];
      for (int g = 1; g < groups; ++g) v += red[(long long)g * m * N + idx];
      v += __ldg(bias + c);
      if (act == 1) v = fmaxf(v, 0.0f);
      else if (act == 2) v = tf_mish(v);
      if (res != nullptr) v = res[(r0 + r) * ldr + c] + v;
      Y[(r0 + r) * ldy + c] = v;
    }
    __syncthreads();
  }
}

// dst[r] = LayerNorm(src[r]) for M rows of d (flax's formula), a warp a row.
__device__ void jb_norm_rows(const float* src, float* dst, int M, int d, const float* g,
                             const float* b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < M; r += JB_WARPS) {
    const float* x = src + r * d;
    float s = 0.0f, s2 = 0.0f;
    for (int k = lane; k < d; k += 32) {
      s += x[k];
      s2 = fmaf(x[k], x[k], s2);
    }
    s = tf_warp_sum(s);
    s2 = tf_warp_sum(s2);
    const float mu = s / (float)d;
    const float var = fmaxf(s2 / (float)d - mu * mu, 0.0f);
    const float rs = 1.0f / sqrtf(var + 1e-5f);
    for (int k = lane; k < d; k += 32) dst[r * d + k] = (x[k] - mu) * rs * __ldg(g + k) + __ldg(b + k);
  }
  __syncthreads();
}

// Causal attention of n query rows over the n key rows of one tier, a warp a
// (row, head): scores (q * inv) . k over keys 0 .. i, softmax with the row's
// max, then the weighted sum of the values (each weight p / sum).
__device__ void jb_attend(const float* Qm, int ldq, const float* Km, const float* Vm, int ldkv,
                          float* out, int ldo, int n, int nH, int dH, float inv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int task = warp; task < n * nH; task += JB_WARPS) {
    const int i = task / nH, hh = task - i * nH, cnt = i + 1;
    const float* q = Qm + i * ldq + hh * dH;
    const float* kb = Km + hh * dH;
    const float* vb = Vm + hh * dH;
    auto score = [&](int j) {
      const float* k = kb + j * ldkv;
      float sc = 0.0f;
      for (int c = 0; c < dH; ++c) sc = fmaf(q[c] * inv, k[c], sc);
      return sc;
    };
    float mx = -INFINITY;
    for (int j = lane; j < cnt; j += 32) mx = fmaxf(mx, score(j));
    mx = tf_warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < cnt; j += 32) sum += expf(score(j) - mx);
    sum = tf_warp_sum(sum);
    for (int c0 = 0; c0 < dH; c0 += 32) {
      const int c = c0 + lane;
      float acc = 0.0f;
      for (int j0 = 0; j0 < cnt; j0 += 32) {
        const int j = j0 + lane;
        const float p = j < cnt ? expf(score(j) - mx) / sum : 0.0f;
        const int kn = min(32, cnt - j0);
        for (int jj = 0; jj < kn; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
          if (c < dH) acc = fmaf(pj, vb[(j0 + jj) * ldkv + c], acc);
        }
      }
      if (c < dH) out[i * ldo + hh * dH + c] = acc;
    }
  }
  __syncthreads();
}

// The token from the head's logits (Q + 1, in shared memory): logits[:Q] /
// max(sigmoid(logits[Q]), min_temperature), / stream s's temperature + the
// noise of (seed, t, s) when sampling, argmax with ties to the lowest index.  Every
// thread returns it.
__device__ __noinline__ int jb_pick(const float* logits, int Q, float min_temperature, int argmax,
                                    unsigned seed, float temp, long long t, int s, float* ared) {
  const float lt = fmaxf(tf_sigmoid(logits[Q]), min_temperature);
  const uint32_t key = argmax ? 0u : decode_noise_key(seed, t, s);
  float best = -INFINITY;
  int bestq = 0x7fffffff;
  for (int q = threadIdx.x; q < Q; q += JB_THREADS) {
    float v = logits[q] / lt;
    if (!argmax) v = v / temp + gumbel_from_bits(mix32(key ^ (uint32_t)q));
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
  int* ired = reinterpret_cast<int*>(ared);
  if (lane == 0) {
    ared[warp] = best;
    ired[JB_WARPS + warp] = bestq;
  }
  __syncthreads();
  float bv = ared[0];
  int bq = ired[JB_WARPS];
  for (int k = 1; k < JB_WARPS; ++k) {
    const float ov = ared[k];
    const int oq = ired[JB_WARPS + k];
    if (ov > bv || (ov == bv && oq < bq)) {
      bv = ov;
      bq = oq;
    }
  }
  __syncthreads();
  return bq == 0x7fffffff ? 0 : bq;
}

// One upper tier of one step: its rows end in m.x (tanh applied); the
// up-sampled rows for the tier below (or the bottom's one row) in m.xup.
__device__ void jb_tier(const JbArgs& a, const JbSmem& m, int ti) {
  const float* w = a.w;
  const int d = a.d, ff = a.ff, L = a.n_layers, nH = a.n_heads, dH = d / nH;
  const int f = a.frame[ti], n = a.n_frames[ti], t = a.t_up[ti], ldc = 2 * L * d;
  // x0 = framed dense (+ the tier above's rows) + PE
  jb_gemm(m.lin + (a.frame[0] - f), f, n, f, w + a.off_in_w[ti], d, d, w + a.off_in_b[ti], 0,
          ti > 0 ? m.xup : nullptr, d, m.x0, d, m.red);
  const float* pe = w + a.off_pe[ti];
  for (int idx = threadIdx.x; idx < n * d; idx += JB_THREADS) m.x0[idx] = m.x0[idx] + __ldg(pe + idx);
  __syncthreads();
  // every layer's cross k | v of the PE'd input
  jb_gemm(m.x0, d, n, d, w + a.off_ckv_w[ti], ldc, ldc, w + a.off_ckv_b[ti], 0, nullptr, 0, m.mkv,
          ldc, m.red);
  const float* xin = m.x0;
  for (int l = 0; l < L; ++l) {
    const float* lw = w + (long long)l * a.layer_stride[ti];
    const long long* o = a.off_layer[ti];
    jb_gemm(xin, d, n, d, lw + o[K_WQKV], 3 * d, 3 * d, lw + o[K_BQKV], 0, nullptr, 0, m.qkv,
            3 * d, m.red);
    jb_attend(m.qkv, 3 * d, m.qkv + d, m.qkv + 2 * d, 3 * d, m.att, d, n, nH, dH, a.inv_sqrt_dh);
    jb_gemm(m.att, d, n, d, lw + o[K_WO], d, d, lw + o[K_BO], 0, xin, d, m.h, d, m.red);
    jb_norm_rows(m.h, m.x, n, d, lw + o[K_LN1W], lw + o[K_LN1B]);
    jb_gemm(m.x, d, n, d, lw + o[K_WCQ], d, d, lw + o[K_BCQ], 0, nullptr, 0, m.qkv, d, m.red);
    jb_attend(m.qkv, d, m.mkv + 2 * l * d, m.mkv + 2 * l * d + d, ldc, m.att, d, n, nH, dH,
              a.inv_sqrt_dh);
    jb_gemm(m.att, d, n, d, lw + o[K_WCO], d, d, lw + o[K_BCO], 0, m.x, d, m.h, d, m.red);
    jb_norm_rows(m.h, m.x, n, d, lw + o[K_LN2W], lw + o[K_LN2B]);
    jb_gemm(m.x, d, n, d, lw + o[K_W1], ff, ff, lw + o[K_B1], a.mish_ffn ? 2 : 1, nullptr, 0,
            m.ffh, ff, m.red);
    jb_gemm(m.ffh, ff, n, ff, lw + o[K_W2], d, d, lw + o[K_B2], 0, m.x, d, m.h, d, m.red);
    jb_norm_rows(m.h, m.x, n, d, lw + o[K_LN3W], lw + o[K_LN3B]);
    xin = m.x;
  }
  for (int idx = threadIdx.x; idx < n * d; idx += JB_THREADS) m.x[idx] = tanhf(m.x[idx]);
  __syncthreads();
  if (ti < a.n_up - 1) {
    // (n, t d) row-major is the next tier's (n t, d) rows: frame m reads chunk m % t of row m / t
    jb_gemm(m.x, d, n, d, w + a.off_up_w[ti], t * d, t * d, w + a.off_up_b[ti], 0, nullptr, 0,
            m.xup, t * d, m.red);
  } else {
    // the bottom reads the last chunk of the last frame only
    jb_gemm(m.x + (n - 1) * d, d, 1, d, w + a.off_up_w[ti] + (t - 1) * d, t * d, d,
            w + a.off_up_b[ti] + (t - 1) * d, 0, nullptr, 0, m.xup, d, m.red);
  }
}

__global__ void __launch_bounds__(JB_THREADS, 1) jb_pyramid_kernel(const JbArgs a) {
  extern __shared__ __align__(16) float smem[];
  const JbSmem m = jb_carve(smem, a);
  const int W = a.W, d = a.d;
  const float* w = a.w;
  for (int s = blockIdx.x; s < a.B; s += gridDim.x) {
    for (int j = threadIdx.x; j < W; j += JB_THREADS) m.ring[j] = a.window[(long long)s * W + j];
    int head = 0;
    __syncthreads();
    for (int i = 0; i < a.n_steps; ++i) {
      for (int j = threadIdx.x; j < W; j += JB_THREADS) {
        const int p = head + j;
        m.lin[j] = ((float)m.ring[p < W ? p : p - W] / (float)a.Q - 0.5f) * 2.0f;
      }
      __syncthreads();
      for (int ti = 0; ti < a.n_up; ++ti) jb_tier(a, m, ti);
      // the bottom's framed conv over the last fs_b real tokens + the last up-sampled row
      const int fb = a.frame[a.n_up];
      jb_gemm(m.lin + (W - 1 - fb), fb, 1, fb, w + a.off_bot_w, d, d, w + a.off_bot_b, 0, m.xup, d,
              m.hb0, d, m.red);
      const float* in = m.hb0;
      for (int k = 0; k < a.n_head; ++k) {
        float* o = (k & 1) ? m.hb0 : m.hb1;
        jb_gemm(in, a.head_in[k], 1, a.head_in[k], w + a.off_wh[k], a.head_out[k], a.head_out[k],
                w + a.off_bh[k], k < a.n_head - 1 ? 2 : 0, nullptr, 0, o, a.head_out[k], m.red);
        in = o;
      }
      const int tok = jb_pick(in, a.Q, a.min_temperature, a.argmax, a.seed,
                              a.argmax ? 1.0f : a.temperature[s], a.t0 + i, s, m.ared);
      if (threadIdx.x == 0) {
        a.out[(long long)s * a.n_steps + i] = tok;
        // slot W - 1 (the placeholder) takes the token and becomes slot W - 2;
        // the oldest slot becomes the new placeholder
        const int p = head + W - 1;
        m.ring[p < W ? p : p - W] = tok;
        m.ring[head] = 0;
      }
      head = head + 1 < W ? head + 1 : 0;
      __syncthreads();
    }
    for (int j = threadIdx.x; j < W; j += JB_THREADS) {
      const int p = head + j;
      a.window[(long long)s * W + j] = m.ring[p < W ? p : p - W];
    }
    __syncthreads();
  }
}

extern "C" {

int mmk_jb_args_size(void) { return (int)sizeof(JbArgs); }

// Launch on `stream` (PyTorch's current stream); does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
int mmk_jb_decode(const JbArgs* args, void* stream) {
  const JbArgs a = *args;
  const size_t smem =
      sizeof(float) * (size_t)jb_smem_floats(a.W, a.rows, a.d, a.ff, a.n_layers, a.head_width);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute((const void*)jb_pyramid_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jb_pyramid_kernel, JB_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = a.B < sms * per_sm ? a.B : sms * per_sm;
  jb_pyramid_kernel<<<grid, JB_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* mmk_jb_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
