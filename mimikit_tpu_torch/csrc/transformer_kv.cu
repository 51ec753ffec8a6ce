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
// Bound.  Per stream and step the full-width net (d 256, 8 layers, rf 64)
// does 17.96 MFLOP once the rings are full (t >= rf; fewer slots before) and
// reads 2.10 MB of ring; the rings are 2.10 MB a stream (33.6 MB at B = 16).
// Whatever B is, a step needs all 33.8 MB of weights: read once a step, a
// 1,600-step chunk moves 54 GB, ~16 ms at 3.35 TB/s, while its operation
// bound at B = 16 is 6.9 ms and real time for it is 100 ms.  The weights stay
// in the 50 MB L2; what sets the pace at narrow B is the chain of dependent
// stages a step, each opened by a grid barrier.
//
// Design (transformer_common.cuh).  One persistent cooperative launch, a
// block on every SM, 3L + 1 grid barriers a step (25 for 8 layers):
//
//   A  (row tile of streams, head h): fold the previous layer's FFN partials
//      (+ b2, + residual, norm 3) into the rows (x0 at layer 0); the head's
//      q|k|v (d x 3dh slice of Wqkv); write the self k|v into ring slot
//      s % rf; attend over the valid slots (staged TF_KT at a time, an
//      online softmax: no limit on rf); the head's share of the out product
//      (dh rows of Wo), a partial of d columns;
//   B  (row tile, head h): fold the nH self-out partials (+ bo, + residual,
//      norm 1); the head's cross q (d x dh of Wcq) and, from the x0 rows,
//      its cross k|v (d x 2dh of the all-layer cross k|v product); write
//      them into the ring; attend; the head's share of the cross out product;
//   C  (row tile, hidden slice of TF_HS units): fold the nH cross-out
//      partials (+ bco, + residual, norm 2); relu(x W1[:, slice] + b1); its
//      partial of FFN 2 (the slice's rows of W2);
//   head (a block a stream): fold the FFN partials (+ b2, + residual, norm
//      3), the final norm, the Mish MLP, the token; the next x0.
//
// With B = 16 and 8 heads, A and B are 128 tasks, C 256 rows x slices in
// 128 tasks of 2 rows: every stage fills the card.  Each task's weight slice
// (128 KB at full width) is copied into shared memory by the bulk copy
// engine for the block that will run it, issued before the barrier that
// opens the stage (transformer_common.cuh).
// The split-K partials (nH per attention out product, ff / TF_HS per FFN)
// are added by their consumer in partial order, then the bias, then the
// residual: no atomics, and the split depends on the widths only, so every
// chunking of a stream draws the same tokens.  Attention's softmax max is
// taken over the (stream, head)'s own scores (the NaN lesson of
// pallas_decode.py:1080-1084,1911-1912).  The rings, (L, B, rf, 4d) f32 in
// device memory, hold [self k | self v | cross k | cross v] per slot.
//
// Measured (chip_smoke.py and tools/profile_transformer_decode.py, NVIDIA
// H100 80GB HBM3, 700 W): 324 us a step at B = 16 and ~313 at B = 1 (525 and
// 492 with 8L + 1 barriers), ~12.5 us a stage: the barrier 1.1, the fold's
// L2 round trips ~2, the products ~3, one (stream, head)'s attention ~3,
// the next copies' issue ~2; each a chain on one SM, none near the card's
// rates.
//
// bf16 weights (MMK_DECODE_BF16=1 under MMK_DECODE_KV=1; the TPU kernel's
// bf16=True, pallas_decode.py:1716-1734): the kernel instantiated on
// __nv_bfloat16 (transformer_common.cuh's weight type).  The pack holds every
// weight, bias, norm affine and the embedding in bf16; each product rounds
// its input activation to bf16 as it reads it (x for q|k|v, the cross q and
// FFN 1, x0 for the cross k|v, the attention rows for the out products, the
// hidden rows for FFN 2, each head layer's input), as JAX's K7 rounds every
// dot input; the sums, the softmax, the norms' arithmetic, the PE rows, the
// residuals and the rings stay f32.  A step's weights are 16.9 MB instead of
// 33.8: the bytes bound halves (a 1,600-step chunk at B = 16: ~8 ms), the
// operation bound does not move, and since the chain of stages sets the pace
// (above), the step time is expected to move little.  Its gate asks d, ff
// and d / n_heads to be multiples of 8.
//
// Randomness: the port's counter hash of (seed, absolute step, stream,
// class) (noise.cuh): the plain twin draws the same noise, and any chunking
// of a stream draws the same tokens.

#include "transformer_common.cuh"

// Mirrors _Args in mimikit_tpu_torch/ops/transformer_kv.py.
struct TfKVArgs {
  const void* w;       // packed weights (transformer_weight_pack), f32 or bf16
  const float* pe;     // (n_steps, d) absolute PE of positions t0 - 1 ..
  const int* prompt_T; // (prior_t, B)
  int* tok;            // (B,) token at position t0 - 1; in/out
  float* ring;         // (L, B, rf, 4d); in/out
  int* out;            // (B, n_steps)
  float* scratch;      // mmk_tf_kv_scratch_floats floats
  long long* barriers; // (1,): the grid barriers block 0 passed

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
  const float* temperature;  // (B,) a stream's temperature, read when sampling
  float min_temperature;
  float inv_sqrt_dh;
  int bf16;            // the weights are __nv_bfloat16 (else float)
};

// The scratch activations, B rows each: x0 (the PE'd input), xa (a layer's
// input after norm 3), x1 (after norm 1), x2 (after norm 2), and the split-K
// partials po (nH, B, d) of the self out product, pc (nH, B, d) of the cross
// out product, pf (S, B, d) of FFN 2.
struct KVBufs {
  float *x0, *xa, *x1, *x2, *po, *pc, *pf;
};

__host__ __device__ inline long long kv_scratch_floats(int B, int d, int n_heads, int ff) {
  const long long S = tf_cdiv(ff, tf_hs(ff));
  return (long long)B * d * (4 + 2LL * n_heads + S);
}

template <class WT>
struct KV {
  const TfKVArgs& a;
  TfSmem L;
  float* sm;
  KVBufs s;
  int d, B, nH, dH, ff, hs, S;
  TfWeightBuffer wb;

  __device__ __forceinline__ KV(const TfKVArgs& args, float* smem) : a(args), sm(smem) {
    d = a.d;
    B = a.B;
    nH = a.n_heads;
    dH = d / nH;
    ff = a.ff;
    hs = tf_hs(ff);
    S = tf_cdiv(ff, hs);
    L = tf_smem(d, nH, ff, 1, tf_head_width(a.n_head, a.head_in, a.head_out), (int)sizeof(WT));
    wb.init(reinterpret_cast<uint64_t*>(sm + L.mbar));
    const long long Bd = (long long)B * d;
    s.x0 = a.scratch;
    s.xa = s.x0 + Bd;
    s.x1 = s.xa + Bd;
    s.x2 = s.x1 + Bd;
    s.po = s.x2 + Bd;
    s.pc = s.po + nH * Bd;
    s.pf = s.pc + nH * Bd;
  }

  __device__ __forceinline__ const WT* lw(int l, int kind) const {
    return tf_layer_w<WT>(a, l, kind);
  }

  // stage st = 3 l + kind (kind 0: A, 1: B, 2: C); st = 3L is the head
  __device__ __forceinline__ int rows_per_task(int kind) const {
    return tf_rows_per_task(B, kind == 2 ? S : nH);
  }
  __device__ __forceinline__ int n_tasks(int st) const {
    if (st == 3 * a.n_layers) return B;
    const int kind = st % 3, cols = kind == 2 ? S : nH;
    return tf_cdiv(B, rows_per_task(kind)) * cols;
  }

  // Issue the copies of task `task`'s weight slice, its columns' biases and
  // its fold's parameters (nothing for a task the stage does not have).
  __device__ __forceinline__ void issue(int st, int task) const {
    if (st >= 3 * a.n_layers || task >= n_tasks(st)) return;
    wb.begin();
    wb.expect(copy_slice(st, task));
  }

  // The copies of a task's slice; returns the bytes the bulk copies bring.
  __device__ __forceinline__ unsigned copy_slice(int st, int task) const {
    const int l = st / 3, kind = st % 3;
    unsigned bytes = 0;
    WT* W = reinterpret_cast<WT*>(sm + L.w);
    WT* bias = reinterpret_cast<WT*>(sm + L.bias);
    WT* fp = reinterpret_cast<WT*>(sm + L.fp);
    if (kind == 0) {
      const int h = task % nH;
      if (l > 0) bytes += tf_copy_fold_params(a, fp, l - 1, K_B2, K_LN3W, wb.bar);
      const WT* wqkv = lw(l, K_WQKV);  // column blocks of d x dH: q, k, v of head h
      for (int p = 0; p < 3; ++p) {
        bytes += tf_copy_run(W + p * d * dH, wqkv + (long long)(p * nH + h) * d * dH,
                             d * dH, wb.bar);
        bytes += tf_copy_run(bias + p * dH, lw(l, K_BQKV) + p * d + h * dH, dH, wb.bar);
      }
      bytes += tf_copy_run(W + tf_roundw<WT>(3 * d * dH), lw(l, K_WO) + (long long)h * dH * d,
                           dH * d, wb.bar);
    } else if (kind == 1) {
      const int h = task % nH;
      bytes += tf_copy_fold_params(a, fp, l, K_BO, K_LN1W, wb.bar);
      // column blocks of d x dH: layer l's cross k of head h, then its v
      const WT* wckv = tf_wbase<WT>(a) + a.off_ckv_w + (long long)(2 * l * nH + h) * d * dH;
      const WT* bckv = tf_wbase<WT>(a) + a.off_ckv_b + 2 * l * d + h * dH;
      bytes += tf_copy_run(W, lw(l, K_WCQ) + (long long)h * d * dH, d * dH, wb.bar);
      bytes += tf_copy_run(bias, lw(l, K_BCQ) + h * dH, dH, wb.bar);
      WT* Wkv = W + tf_roundw<WT>(d * dH);
      bytes += tf_copy_run(Wkv, wckv, d * dH, wb.bar);
      bytes += tf_copy_run(Wkv + d * dH, wckv + (long long)nH * d * dH, d * dH, wb.bar);
      bytes += tf_copy_run(bias + dH, bckv, dH, wb.bar);
      bytes += tf_copy_run(bias + 2 * dH, bckv + d, dH, wb.bar);
      bytes += tf_copy_run(Wkv + tf_roundw<WT>(2 * d * dH), lw(l, K_WCO) + (long long)h * dH * d,
                           dH * d, wb.bar);
    } else {
      const int sl = task % S, c0 = sl * hs, n = min(hs, ff - c0);
      bytes += tf_copy_fold_params(a, fp, l, K_BCO, K_LN2W, wb.bar);
      bytes += tf_copy_run(W, lw(l, K_W1) + (long long)c0 * d, d * n, wb.bar);
      bytes += tf_copy_run(bias, lw(l, K_B1) + c0, n, wb.bar);
      bytes += tf_copy_run(W + tf_roundw<WT>(d * hs), lw(l, K_W2) + (long long)c0 * d, n * d,
                           wb.bar);
    }
    return bytes;
  }

  // The self (koff 0) or cross (koff 2d) k|v of rows r < Rt (in the t
  // region, columns dH .. 3dH) into ring slot `slot` of head h, then each
  // row's attention over the vcount valid slots into the attention rows.
  __device__ __forceinline__ void ring_attend(int l, int r0, int Rt, int h, int koff, int slot,
                                              int vcount) const {
    float* T = sm + L.t;
    for (int r = 0; r < Rt; ++r) {
      float* rows = a.ring + ((long long)l * B + r0 + r) * a.rf * 4 * d + koff + h * dH;
      float* at = rows + (long long)slot * 4 * d;
      for (int c = threadIdx.x; c < dH; c += TF_THREADS) {
        at[c] = T[r * L.ld_qkv + dH + c];
        at[d + c] = T[r * L.ld_qkv + 2 * dH + c];
      }
      __syncthreads();
      attn_block(T + r * L.ld_qkv, L.ld_qkv, rows, 4 * d, rows + d, 4 * d,
                 T + L.att + r * L.ld_att, L.ld_att, 1, vcount, 0, false, dH, a.inv_sqrt_dh,
                 false, sm + L.u);
    }
  }

  __device__ __forceinline__ void run_task(int st, int task, int slot, int vcount) const {
    const int l = st / 3, kind = st % 3;
    const WT* W = reinterpret_cast<const WT*>(sm + L.w);
    float* X = sm + L.x;
    float* T = sm + L.t;
    float* U = sm + L.u;
    const WT* bias = reinterpret_cast<const WT*>(sm + L.bias);
    const WT* fp = reinterpret_cast<const WT*>(sm + L.fp);
    const long long Bd = (long long)B * d;
    const int R = rows_per_task(kind);
    wb.wait();  // the slice and the fold's parameters
    __syncthreads();
    TF_MARK(1);
    if (kind == 0) {
      const int h = task % nH, r0 = (task / nH) * R, Rt = min(R, B - r0);
      if (l == 0)
        tf_fold<WT>(X, d, Rt, r0, 1, d, s.x0, nullptr, 0, 0, nullptr, nullptr, nullptr, nullptr);
      else
        tf_fold<WT>(X, d, Rt, r0, 1, d, s.x2, s.pf, Bd, S, fp, fp + d, fp + 2 * d,
                    h == 0 ? s.xa : nullptr);
      TF_MARK(0);
      tf_product(X, d, Rt, W, dH, d * dH, d, 3 * dH, U, T, L.ld_qkv, bias, 0);  // q|k|v
      TF_MARK(2);
      ring_attend(l, r0, Rt, h, 0, slot, vcount);
      TF_MARK(3);
      tf_product(T + L.att, L.ld_att, Rt, W + tf_roundw<WT>(3 * d * dH), d, 0, dH, d, U,
                 s.po + h * Bd + (long long)r0 * d, d, nullptr, 0);
      TF_MARK(4);
    } else if (kind == 1) {
      const int h = task % nH, r0 = (task / nH) * R, Rt = min(R, B - r0);
      float* X2 = sm + L.x2;
      tf_fold<WT>(X, d, Rt, r0, 1, d, l == 0 ? s.x0 : s.xa, s.po, Bd, nH, fp, fp + d,
                  fp + 2 * d, h == 0 ? s.x1 : nullptr);
      tf_fold<WT>(X2, d, Rt, r0, 1, d, s.x0, nullptr, 0, 0, nullptr, nullptr, nullptr, nullptr);
      TF_MARK(0);
      tf_product(X, d, Rt, W, dH, 0, d, dH, U, T, L.ld_qkv, bias, 0);  // cross q
      tf_product(X2, d, Rt, W + tf_roundw<WT>(d * dH), dH, d * dH, d, 2 * dH, U, T + dH,
                 L.ld_qkv, bias + dH, 0);  // cross k|v of x0
      TF_MARK(2);
      ring_attend(l, r0, Rt, h, 2 * d, slot, vcount);
      TF_MARK(3);
      tf_product(T + L.att, L.ld_att, Rt, W + tf_roundw<WT>(d * dH) + tf_roundw<WT>(2 * d * dH),
                 d, 0, dH, d, U, s.pc + h * Bd + (long long)r0 * d, d, nullptr, 0);
      TF_MARK(4);
    } else {
      const int sl = task % S, r0 = (task / S) * R, Rt = min(R, B - r0);
      const int c0 = sl * hs, n = min(hs, ff - c0);
      tf_fold<WT>(X, d, Rt, r0, 1, d, s.x1, s.pc, Bd, nH, fp, fp + d, fp + 2 * d,
                  sl == 0 ? s.x2 : nullptr);
      TF_MARK(0);
      float* hid = T + L.hid;
      tf_product(X, d, Rt, W, n, 0, d, n, U, hid, L.ld_hid, bias, 1);  // relu(x W1 + b1)
      TF_MARK(2);
      tf_product(hid, L.ld_hid, Rt, W + tf_roundw<WT>(d * hs), d, 0, n, d, U,
                 s.pf + sl * Bd + (long long)r0 * d, d, nullptr, 0);
      TF_MARK(4);
    }
  }
};

template <class WT>
__global__ void __launch_bounds__(TF_THREADS, 1) tf_kv_kernel(const __grid_constant__ TfKVArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const KV<WT> k(a, smem);
  const int d = a.d, B = a.B, L = a.n_layers;
  const WT* emb = tf_wbase<WT>(a) + a.off_emb;
  long long n_sync = 0;

  // x0 of the first iteration: the token at t0 - 1
  {
    const long long sp = a.t0 - 1;
    for (int idx = blockIdx.x * TF_THREADS + threadIdx.x; idx < B * d;
         idx += gridDim.x * TF_THREADS) {
      const int b = idx / d, c = idx % d;
      const int tk = sp < a.prior_t ? a.prompt_T[sp * B + b] : a.tok[b];
      k.s.x0[idx] = tf_wldg(emb + (long long)tk * d + c) + __ldg(a.pe + c);
    }
  }
  k.issue(0, blockIdx.x);
  grid.sync();
  ++n_sync;

  for (int i = 0; i < a.n_steps; ++i) {
    const long long t = a.t0 + i;
    const int slot = (int)((t - 1) % a.rf);
    const int vcount = t < a.rf ? (int)t : a.rf;
    for (int st = 0; st < 3 * L; ++st) {
      TF_STAGE(st % 3);
      for (int task = blockIdx.x; task < k.n_tasks(st); task += gridDim.x) {
        if (task != blockIdx.x) k.issue(st, task);  // the first was issued before the barrier
        k.run_task(st, task, slot, vcount);
      }
      k.issue(st + 1, blockIdx.x);
      TF_MARK(5);
      grid.sync();
      ++n_sync;
    }
    // the head; the token at t (the prompt's while t < prior_t) is the output
    // and the next iteration's push
    float* x = smem + k.L.u;
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      tf_fold<WT>(x, d, 1, b, 1, d, k.s.x2, k.s.pf, (long long)B * d, k.S,
                  tf_layer_w<WT>(a, L - 1, K_B2), tf_layer_w<WT>(a, L - 1, K_LN3W),
                  tf_layer_w<WT>(a, L - 1, K_LN3B), nullptr);
      int tk = tf_head_token<WT>(a, t, b, x);
      if (t < a.prior_t) tk = a.prompt_T[t * B + b];
      if (threadIdx.x == 0) {
        a.out[(long long)b * a.n_steps + i] = tk;
        if (i == a.n_steps - 1) a.tok[b] = tk;
      }
      if (i + 1 < a.n_steps)
        for (int c = threadIdx.x; c < d; c += TF_THREADS)
          k.s.x0[(long long)b * d + c] =
              tf_wldg(emb + (long long)tk * d + c) + __ldg(a.pe + (long long)(i + 1) * d + c);
      __syncthreads();
    }
    if (i + 1 < a.n_steps) k.issue(0, blockIdx.x);
    grid.sync();
    ++n_sync;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.barriers != nullptr) *a.barriers = n_sync;
}

extern "C" {

int mmk_tf_kv_args_size(void) { return (int)sizeof(TfKVArgs); }

long long mmk_tf_kv_scratch_floats(const TfKVArgs* a) {
  return kv_scratch_floats(a->B, a->d, a->n_heads, a->ff);
}

long long mmk_tf_kv_smem_bytes(const TfKVArgs* a) {
  return (long long)sizeof(float) *
         tf_smem(a->d, a->n_heads, a->ff, 1, tf_head_width(a->n_head, a->head_in, a->head_out),
                 a->bf16 ? 2 : 4)
             .total;
}

// Launch on `stream` (PyTorch's current stream); does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
int mmk_tf_kv_decode(const TfKVArgs* args, void* stream) {
  TfKVArgs a = *args;
  const void* fn = a.bf16 ? (const void*)tf_kv_kernel<__nv_bfloat16>
                          : (const void*)tf_kv_kernel<float>;
  return tf_launch_cooperative(fn, &a, (size_t)mmk_tf_kv_smem_bytes(&a), (cudaStream_t)stream);
}

const char* mmk_tf_kv_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
