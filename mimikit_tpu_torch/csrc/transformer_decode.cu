// SimpleTransformer window-refeed decode: the whole autoregressive loop in one launch.
//
// Replaces the TPU kernel make_transformer_pallas_decoder (K6,
// mimikit_tpu/ops/pallas_decode.py:1248, with _bd_masks/_bd_attend :1079-1139).
// Per step, for B streams of rf rows each (row s * rf + j is window slot j of
// stream s): embed the (B, rf) token window and add the window-relative
// sinusoidal PE (x0, also every layer's cross-attention memory); per
// post-norm layer: causal self-attention, causal cross-attention on x0, a
// ReLU FFN, three layer norms; the optional final norm and the Mish head on
// each stream's last row; logits / max(sigmoid(extra logit), min_temperature),
// / temperature + Gumbel noise when sampling, argmax (ties to the lowest
// index); the token is appended and the window moves on by one.
//
// Bound.  One stream's step at full width (d 256, 8 heads, ff 1,024, 8
// layers, rf 64) needs 1.005 GFLOP: all 64 rows in seven layers with causal
// attention, and in the last layer only the self and cross k|v at 64 rows,
// the rest at the one row the head reads.  That is 15 us at the card's 67
// TFLOP/s of f32 on CUDA cores (61.4 ms for 4,096 steps); its weights are 34
// MB, which stay in the 50 MB L2.  This kernel computes every row of the last
// layer too, 1.108 GFLOP a step.  One block, or a few, owning a stream (the SampleRNN and WaveNet kernels' design) would leave
// the card idle at B = 1 and take milliseconds a step.
//
// Design.  One persistent cooperative launch, a block on every SM; each step
// is a chain of stages separated by grid barriers (transformer_common.cuh):
// per layer [q|k|v products] -> [self-attention] -> [out product + residual]
// -> [norm 1 on load, cross q product] -> [cross-attention] -> [out product
// + residual] -> [norm 2 on load, FFN 1 + ReLU] -> [FFN 2 + residual], the
// third norm applied as the next layer's q|k|v (or the head) loads its rows;
// every layer's cross k|v, all products of x0, are one product at the first
// stage of the step.  A product stage gives each block output tiles of 16
// rows x 16 columns, so each weight tile is read from L2 once a step for
// each 16 rows: 4 times at B = 1, which buys 4 times the tiles to spread
// over the SMs.  Attention is a block a (stream, head, 16 query rows), the
// keys and values it sees staged in shared memory.  The head stage is a block a stream, which
// also writes the next step's x0 rows of its stream.  So a step is 8L + 1
// grid barriers: at B = 1 the barriers and the short stages between them,
// not the arithmetic, set the pace.  Fewer barriers, tensor cores (3xTF32 to
// keep f32 parity), and a last layer computing only the last row are the
// later steps.
//
// Randomness: the port's counter hash of (seed, absolute position, stream,
// class) (noise.cuh), which the plain twin computes too.

#include "transformer_common.cuh"

// Mirrors _Args in mimikit_tpu_torch/ops/transformer_decode.py.
struct TfWindowArgs {
  const float* w;      // packed weights (transformer_weight_pack)
  const float* pe;     // (rf, d) window-relative PE
  int* buf;            // (B, rf + n_steps): the first window, then the tokens
  float* scratch;      // tf_scratch_floats(B * rf, ...) floats

  long long off_emb;
  long long off_ckv_w;
  long long off_ckv_b;
  long long off_lnf_w;
  long long off_lnf_b;
  long long off_layer[TF_N_KINDS];  // layer 0's tensors; layer l's lie l strides on
  long long layer_stride;
  long long off_wh[TF_MAX_HEAD];
  long long off_bh[TF_MAX_HEAD];
  long long t0;        // absolute position of the first generated token
  int head_in[TF_MAX_HEAD];
  int head_out[TF_MAX_HEAD];
  int B;
  int n_steps;
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
  float inv_sqrt_dh;   // 1 / sqrt(d / n_heads), rounded as the plain twin rounds it
};

// Causal attention within each stream's rf rows: a block a (stream, head,
// block of TF_QB query rows), which stages the keys and values the rows see
// (attn_block).  q rows have leading dimension ldq, k and v rows ldkv; out
// is (M, d).
__device__ __forceinline__ void attn_window_stage(const float* Qs, int ldq, const float* Ks,
                                                  const float* Vs, int ldkv, float* out, int B,
                                                  int rf, int d, int nH, float inv, float* smem) {
  const int dH = d / nH, nqb = (rf + TF_QB - 1) / TF_QB;
  for (int task = blockIdx.x; task < B * nH * nqb; task += gridDim.x) {
    const int qb = task % nqb, h = (task / nqb) % nH, s = task / (nqb * nH);
    const int q0 = qb * TF_QB, n_q = min(TF_QB, rf - q0);
    const long long row = (long long)s * rf;
    attn_block(Qs + (row + q0) * ldq + h * dH, ldq, Ks + row * ldkv + h * dH, ldkv,
               Vs + row * ldkv + h * dH, ldkv, out + (row + q0) * d + h * dH, d, n_q, q0 + n_q,
               q0, true, dH, inv, true, smem);
  }
}

// x0 rows of stream s for the window buf[s, i0 .. i0 + rf), by the block's threads.
__device__ __forceinline__ void embed_window(const TfWindowArgs& a, float* x0, int s, int i0) {
  const int d = a.d, rf = a.rf;
  const long long W = (long long)rf + a.n_steps;
  const float* emb = a.w + a.off_emb;
  for (int idx = threadIdx.x; idx < rf * d; idx += TF_THREADS) {
    const int j = idx / d, c = idx % d;
    const int tk = a.buf[s * W + i0 + j];
    x0[((long long)s * rf + j) * d + c] =
        __ldg(emb + (long long)tk * d + c) + __ldg(a.pe + j * d + c);
  }
}

__global__ void __launch_bounds__(TF_THREADS, 1) tf_window_kernel(const TfWindowArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int d = a.d, rf = a.rf, B = a.B, L = a.n_layers, ff = a.ff;
  const int M = B * rf, ldc = 2 * L * d;
  const long long W = (long long)rf + a.n_steps;
  const TfBufs s = tf_bufs(a.scratch, M, d, ff, L);

  const TfHead hd = tf_head_args(a);

  for (int st = blockIdx.x; st < B; st += gridDim.x) embed_window(a, s.x0, st, 0);
  grid.sync();

  for (int i = 0; i < a.n_steps; ++i) {
    for (int l = 0; l < L; ++l) {
      // q|k|v of the layer's input (the previous layer's third norm on load);
      // at layer 0 also every layer's cross k|v of x0
      GemmJob jobs[2];
      jobs[0] = gemm_job(l == 0 ? s.x0 : s.h, d, tf_layer_w(a, l, K_WQKV), 3 * d,
                         tf_layer_w(a, l, K_BQKV), s.qkv, 3 * d, M, 3 * d, d);
      if (l > 0) {
        jobs[0].ln_w = tf_layer_w(a, l - 1, K_LN3W);
        jobs[0].ln_b = tf_layer_w(a, l - 1, K_LN3B);
        jobs[0].xout = s.x;
      }
      jobs[1] = gemm_job(s.x0, d, a.w + a.off_ckv_w, ldc, a.w + a.off_ckv_b, s.ckv, ldc, M, ldc, d);
      gemm_stage(jobs, l == 0 ? 2 : 1, smem);
      grid.sync();
      attn_window_stage(s.qkv, 3 * d, s.qkv + d, s.qkv + 2 * d, 3 * d, s.att, B, rf, d, a.n_heads,
                        a.inv_sqrt_dh, smem);
      grid.sync();
      const float* xin = l == 0 ? s.x0 : s.x;
      GemmJob j =
          gemm_job(s.att, d, tf_layer_w(a, l, K_WO), d, tf_layer_w(a, l, K_BO), s.h, d, M, d, d);
      j.res = xin;
      j.ldr = d;
      gemm_stage(&j, 1, smem);
      grid.sync();
      j = gemm_job(s.h, d, tf_layer_w(a, l, K_WCQ), d, tf_layer_w(a, l, K_BCQ), s.cq, d, M, d, d);
      j.ln_w = tf_layer_w(a, l, K_LN1W);
      j.ln_b = tf_layer_w(a, l, K_LN1B);
      j.xout = s.x;
      gemm_stage(&j, 1, smem);
      grid.sync();
      attn_window_stage(s.cq, d, s.ckv + 2 * l * d, s.ckv + 2 * l * d + d, ldc, s.att, B, rf, d,
                        a.n_heads, a.inv_sqrt_dh, smem);
      grid.sync();
      j = gemm_job(s.att, d, tf_layer_w(a, l, K_WCO), d, tf_layer_w(a, l, K_BCO), s.h, d, M, d, d);
      j.res = s.x;
      j.ldr = d;
      gemm_stage(&j, 1, smem);
      grid.sync();
      j = gemm_job(s.h, d, tf_layer_w(a, l, K_W1), ff, tf_layer_w(a, l, K_B1), s.ff, ff, M, ff, d);
      j.ln_w = tf_layer_w(a, l, K_LN2W);
      j.ln_b = tf_layer_w(a, l, K_LN2B);
      j.xout = s.x;
      j.relu = 1;
      gemm_stage(&j, 1, smem);
      grid.sync();
      j = gemm_job(s.ff, ff, tf_layer_w(a, l, K_W2), d, tf_layer_w(a, l, K_B2), s.h, d, M, d, ff);
      j.res = s.x;
      j.ldr = d;
      gemm_stage(&j, 1, smem);
      grid.sync();
    }
    // the head on each stream's last row; the token extends the window
    for (int st = blockIdx.x; st < B; st += gridDim.x) {
      const int tk = tf_head_token(hd, s.h + ((long long)st * rf + rf - 1) * d, a.t0 + i, st, smem);
      if (threadIdx.x == 0) a.buf[st * W + rf + i] = tk;
      __syncthreads();
      if (i + 1 < a.n_steps) embed_window(a, s.x0, st, i + 1);
      __syncthreads();
    }
    grid.sync();
  }
}

extern "C" {

int mmk_tf_window_args_size(void) { return (int)sizeof(TfWindowArgs); }

long long mmk_tf_window_scratch_floats(const TfWindowArgs* a) {
  return tf_scratch_floats((long long)a->B * a->rf, a->d, a->ff, a->n_layers);
}

// Launch on `stream` (PyTorch's current stream); does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
int mmk_tf_window_decode(const TfWindowArgs* args, void* stream) {
  TfWindowArgs a = *args;
  const size_t smem =
      sizeof(float) *
      (size_t)tf_smem_floats(a.d, a.n_heads, a.rf, TF_QB, a.n_head, a.head_in, a.head_out);
  return tf_launch_cooperative((const void*)tf_window_kernel, &a, smem, (cudaStream_t)stream);
}

const char* mmk_tf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
