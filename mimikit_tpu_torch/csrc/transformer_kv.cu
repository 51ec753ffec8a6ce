// SimpleTransformer KV-ring stream decode: n_steps steps a launch, state carried.
//
// Replaces the TPU kernel make_transformer_kv_ring_pallas (K7,
// mimikit_tpu/ops/pallas_decode.py:1693); its oracle is
// make_transformer_kv_ring_decoder (:1478), which the plain twin ports.
// Iteration t pushes the token at s = t - 1 (the prompt's while s < prior_t,
// else the carried token) with the absolute sinusoidal PE of s (x0); per
// post-norm layer the self-attention's k|v of the layer's input and the
// cross-attention's k|v of x0 are written into ring slot s % rf first, then
// the layer attends over the min(t, rf) valid slots (write before read:
// unlike wavenet_decode.cu, the slot just written is attended); then the
// FFN, the head, the sampling as in K6; the token at t is the prompt's while
// t < prior_t.  The token carry and the rings are read and written in place.
//
// Bound.  Per stream and step the full-width net (d 256, 8 layers, rf 64) does
// 17.96 MFLOP once the rings are full (t >= rf; fewer slots before) and reads 2.10 MB of ring; the rings are 2.10 MB a stream (33.6 MB
// at B = 16).  Whatever B is, a step needs all 33.8 MB of weights: read once a
// step, a 1,600-step chunk moves 54 GB, ~16 ms at 3.35 TB/s, while its
// operation bound at B = 16 is 6.9 ms and real time for it is 100 ms.  So no
// block may re-read all weights for its own streams (the wavenet_decode.cu
// pattern would multiply that traffic by the number of blocks).
//
// Design (transformer_common.cuh).  One persistent cooperative launch, a
// block on every SM.  Each product's columns are split over the grid, for all
// B streams at once (tiles of 16 rows x 16 columns), so each weight tile is
// read once a step for every 16 streams; every layer's cross k|v (products
// of the same x0) is one (d, 2Ld) product at the step's first stage.  Per
// layer: [q|k|v] -> [ring write + self-attention] -> [out + residual] ->
// [norm 1 on load, cross q] -> [ring write + cross-attention] -> [out +
// residual] -> [norm 2 on load, FFN 1 + ReLU] -> [FFN 2 + residual], a grid
// barrier between stages; the head stage (a block a stream) also writes the
// next step's x0.  Attention is a block a (stream, head) with that head's
// ring rows staged in shared memory, its softmax max taken over that
// (stream, head)'s own scores (the NaN lesson of
// pallas_decode.py:1080-1084,1911-1912).  The rings, (L, B, rf, 4d) f32 in
// device memory, hold [self k | self v | cross k | cross v] per slot.  So a
// step is 8L + 1 grid barriers; at narrow B they, not the bytes, set the
// pace.
//
// Randomness: the port's counter hash of (seed, absolute step, stream,
// class) (noise.cuh): the plain twin draws the same noise, and any chunking
// of a stream draws the same tokens.

#include "transformer_common.cuh"

// Mirrors _Args in mimikit_tpu_torch/ops/transformer_kv.py.
struct TfKVArgs {
  const float* w;      // packed weights (transformer_weight_pack)
  const float* pe;     // (n_steps, d) absolute PE of positions t0 - 1 ..
  const int* prompt_T; // (prior_t, B)
  int* tok;            // (B,) token at position t0 - 1; in/out
  float* ring;         // (L, B, rf, 4d); in/out
  int* out;            // (B, n_steps)
  float* scratch;      // tf_scratch_floats(B, ...) floats

  long long off_emb;
  long long off_ckv_w;
  long long off_ckv_b;
  long long off_lnf_w;
  long long off_lnf_b;
  long long off_layer[TF_N_KINDS];
  long long layer_stride;
  long long off_wh[TF_MAX_HEAD];
  long long off_bh[TF_MAX_HEAD];
  long long t0;        // absolute step of the first iteration
  int head_in[TF_MAX_HEAD];
  int head_out[TF_MAX_HEAD];
  int B;
  int n_steps;
  int prior_t;
  int d;
  int n_heads;
  int ff;
  int n_layers;
  int rf;
  int Q;
  int n_head;
  int final_ln;
  int argmax;
  unsigned int seed;
  float temperature;
  float min_temperature;
  float inv_sqrt_dh;
};

// Ring attention of layer l, a block a (stream b, head h): write the new
// k|v head slice (rows of knew/vnew, leading dimension ldnew) into slot
// `slot` at lane offset `koff` of the ring row (0: self, 2d: cross), then
// attend q_b over slots 0 .. vcount - 1 (attn_block; scores scaled by inv
// after the product, as the oracle scales them).
__device__ __forceinline__ void attn_ring_stage(const float* Qs, int ldq, const float* knew,
                                                const float* vnew, int ldnew, float* ring,
                                                int koff, int l, int B, int rf, int d, int nH,
                                                int slot, int vcount, float inv, float* out,
                                                float* smem) {
  const int dH = d / nH;
  for (int task = blockIdx.x; task < B * nH; task += gridDim.x) {
    const int b = task / nH, h = task % nH;
    float* rows = ring + ((long long)l * B + b) * rf * 4 * d + koff + h * dH;
    float* at = rows + (long long)slot * 4 * d;
    for (int c = threadIdx.x; c < dH; c += TF_THREADS) {
      at[c] = knew[(long long)b * ldnew + h * dH + c];
      at[d + c] = vnew[(long long)b * ldnew + h * dH + c];
    }
    __syncthreads();
    attn_block(Qs + (long long)b * ldq + h * dH, ldq, rows, 4 * d, rows + d, 4 * d,
               out + (long long)b * d + h * dH, d, 1, vcount, 0, false, dH, inv, false, smem);
  }
}

__global__ void __launch_bounds__(TF_THREADS, 1) tf_kv_kernel(const TfKVArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int d = a.d, rf = a.rf, B = a.B, L = a.n_layers, ff = a.ff;
  const int ldc = 2 * L * d;
  const TfBufs s = tf_bufs(a.scratch, B, d, ff, L);
  const float* emb = a.w + a.off_emb;

  const TfHead hd = tf_head_args(a);

  // x0 of the first iteration: the token at t0 - 1
  {
    const long long sp = a.t0 - 1;
    for (int idx = blockIdx.x * TF_THREADS + threadIdx.x; idx < B * d;
         idx += gridDim.x * TF_THREADS) {
      const int b = idx / d, c = idx % d;
      const int tk = sp < a.prior_t ? a.prompt_T[sp * B + b] : a.tok[b];
      s.x0[idx] = __ldg(emb + (long long)tk * d + c) + __ldg(a.pe + c);
    }
  }
  grid.sync();

  for (int i = 0; i < a.n_steps; ++i) {
    const long long t = a.t0 + i;
    const int slot = (int)((t - 1) % rf);
    const int vcount = t < rf ? (int)t : rf;
    for (int l = 0; l < L; ++l) {
      GemmJob jobs[2];
      jobs[0] = gemm_job(l == 0 ? s.x0 : s.h, d, tf_layer_w(a, l, K_WQKV), 3 * d,
                         tf_layer_w(a, l, K_BQKV), s.qkv, 3 * d, B, 3 * d, d);
      if (l > 0) {
        jobs[0].ln_w = tf_layer_w(a, l - 1, K_LN3W);
        jobs[0].ln_b = tf_layer_w(a, l - 1, K_LN3B);
        jobs[0].xout = s.x;
      }
      jobs[1] = gemm_job(s.x0, d, a.w + a.off_ckv_w, ldc, a.w + a.off_ckv_b, s.ckv, ldc, B, ldc, d);
      gemm_stage(jobs, l == 0 ? 2 : 1, smem);
      grid.sync();
      attn_ring_stage(s.qkv, 3 * d, s.qkv + d, s.qkv + 2 * d, 3 * d, a.ring, 0, l, B, rf, d,
                      a.n_heads, slot, vcount, a.inv_sqrt_dh, s.att, smem);
      grid.sync();
      GemmJob j =
          gemm_job(s.att, d, tf_layer_w(a, l, K_WO), d, tf_layer_w(a, l, K_BO), s.h, d, B, d, d);
      j.res = l == 0 ? s.x0 : s.x;
      j.ldr = d;
      gemm_stage(&j, 1, smem);
      grid.sync();
      j = gemm_job(s.h, d, tf_layer_w(a, l, K_WCQ), d, tf_layer_w(a, l, K_BCQ), s.cq, d, B, d, d);
      j.ln_w = tf_layer_w(a, l, K_LN1W);
      j.ln_b = tf_layer_w(a, l, K_LN1B);
      j.xout = s.x;
      gemm_stage(&j, 1, smem);
      grid.sync();
      attn_ring_stage(s.cq, d, s.ckv + 2 * l * d, s.ckv + 2 * l * d + d, ldc, a.ring, 2 * d, l, B,
                      rf, d, a.n_heads, slot, vcount, a.inv_sqrt_dh, s.att, smem);
      grid.sync();
      j = gemm_job(s.att, d, tf_layer_w(a, l, K_WCO), d, tf_layer_w(a, l, K_BCO), s.h, d, B, d, d);
      j.res = s.x;
      j.ldr = d;
      gemm_stage(&j, 1, smem);
      grid.sync();
      j = gemm_job(s.h, d, tf_layer_w(a, l, K_W1), ff, tf_layer_w(a, l, K_B1), s.ff, ff, B, ff, d);
      j.ln_w = tf_layer_w(a, l, K_LN2W);
      j.ln_b = tf_layer_w(a, l, K_LN2B);
      j.xout = s.x;
      j.relu = 1;
      gemm_stage(&j, 1, smem);
      grid.sync();
      j = gemm_job(s.ff, ff, tf_layer_w(a, l, K_W2), d, tf_layer_w(a, l, K_B2), s.h, d, B, d, ff);
      j.res = s.x;
      j.ldr = d;
      gemm_stage(&j, 1, smem);
      grid.sync();
    }
    // the head; the token at t (the prompt's while t < prior_t) is the output
    // and the next iteration's push
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      int tk = tf_head_token(hd, s.h + (long long)b * d, t, b, smem);
      if (t < a.prior_t) tk = a.prompt_T[t * B + b];
      if (threadIdx.x == 0) {
        a.out[(long long)b * a.n_steps + i] = tk;
        if (i == a.n_steps - 1) a.tok[b] = tk;
      }
      if (i + 1 < a.n_steps)
        for (int c = threadIdx.x; c < d; c += TF_THREADS)
          s.x0[(long long)b * d + c] =
              __ldg(emb + (long long)tk * d + c) + __ldg(a.pe + (long long)(i + 1) * d + c);
      __syncthreads();
    }
    grid.sync();
  }
}

extern "C" {

int mmk_tf_kv_args_size(void) { return (int)sizeof(TfKVArgs); }

long long mmk_tf_kv_scratch_floats(const TfKVArgs* a) {
  return tf_scratch_floats(a->B, a->d, a->ff, a->n_layers);
}

// Launch on `stream` (PyTorch's current stream); does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
int mmk_tf_kv_decode(const TfKVArgs* args, void* stream) {
  TfKVArgs a = *args;
  const size_t smem =
      sizeof(float) *
      (size_t)tf_smem_floats(a.d, a.n_heads, a.rf, 1, a.n_head, a.head_in, a.head_out);
  return tf_launch_cooperative((const void*)tf_kv_kernel, &a, smem, (cudaStream_t)stream);
}

const char* mmk_tf_kv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
