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
// MB, which stay in the 50 MB L2.  This kernel does that work: its last layer
// runs the queries, the attentions, the norms and the FFN on each stream's
// last row only.
//
// Design (transformer_common.cuh).  One persistent cooperative launch, a
// block on every SM, 4L + 1 grid barriers a step (33 for 8 layers):
//
//   1  (row tile, TF_TN columns of q|k|v; at layer 0 also of every layer's
//      cross k|v, products of x0): fold the previous layer's FFN partials
//      (+ b2, + residual, norm 3) into the rows (x0 at layer 0), the product;
//   2  (stream, head, TF_QB query rows): causal self-attention over the keys
//      the rows see (staged TF_KT at a time, an online softmax: no limit on
//      rf), then the head's share of the out product (dh rows of Wo), a
//      partial of d columns;
//   3  (stream, head, TF_QB query rows): fold the nH self-out partials (+ bo,
//      + residual, norm 1), the head's cross q (d x dh of Wcq), causal cross-
//      attention over x0's cross k|v, the head's share of the cross out
//      product;
//   4  (row tile, hidden slice of TF_HS units): fold the nH cross-out
//      partials (+ bco, + residual, norm 2); relu(x W1[:, slice] + b1); its
//      partial of FFN 2 (the slice's rows of W2);
//   head (a block a stream): fold the FFN partials (+ b2, + residual, norm
//      3) of the stream's last row, the final norm, the Mish MLP, the token;
//      the next window's x0 rows.
//
// In the last layer stage 1 computes the queries of the last rows only, and
// stages 2-4 run on the last rows only.  Rows a task are chosen so that a
// stage has about one task a block (at B = 1, 132 q|k|v tasks of 6 rows x 64
// columns; 64 attention tasks; 128 FFN tasks of 8 rows).  Each task's weight
// slice (64-128 KB at full width) is copied into shared memory by the bulk
// copy engine for the block that will run it, issued before the barrier
// that opens the stage.  The split-K partials (nH per attention out product,
// ff / TF_HS per FFN) are added by their consumer in partial order, then the
// bias, then the residual: no atomics.  The next window's rows but the last
// are embedded by the whole grid during the head stage.
//
// Measured (chip_smoke.py and tools/profile_transformer_decode.py, NVIDIA
// H100 80GB HBM3, 700 W): 449 us a step at B = 1 (678 with 8L + 1
// barriers), 3.8 ms at B = 16; at B = 1 a stage is ~13 us: the barrier, a
// fold of up to 17 partial rows from L2, products of a few rows, the next
// copies' issue.
//
// Randomness: the port's counter hash of (seed, absolute position, stream,
// class) (noise.cuh), which the plain twin computes too.

#include "transformer_common.cuh"

// Mirrors _Args in mimikit_tpu_torch/ops/transformer_decode.py.
struct TfWindowArgs {
  const float* w;      // packed weights (transformer_weight_pack)
  const float* pe;     // (rf, d) window-relative PE
  int* buf;            // (B, rf + n_steps): the first window, then the tokens
  float* scratch;      // mmk_tf_window_scratch_floats floats
  long long* barriers; // (1,): the grid barriers block 0 passed

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

__host__ __device__ inline long long win_scratch_floats(int B, int rf, int d, int n_heads, int ff,
                                                       int L) {
  const long long S = tf_cdiv(ff, tf_hs(ff));
  return (long long)B * rf * d * (7 + 2LL * L + 2LL * n_heads + S);
}

// A stage-1 column group: q (layer l's queries), k|v, or every layer's cross k|v.
struct ColGroup {
  const float* W;      // the group's first column block (blocks of d x dh)
  const float* bias;
  float* out;          // the group's first output column
  long long ldo;
  int N;               // columns
  int rows, row0, rstride;
  int ct;              // column tiles of tb blocks
};

struct Win {
  const TfWindowArgs& a;
  TfSmem L;
  float* sm;
  float *x0, *xa, *x1, *x2, *qkv, *ckv, *po, *pc, *pf;
  int d, B, rf, M, nH, dH, ff, hs, S, nqb, ldc, tb;
  TfWeightBuffer wb;

  __device__ __forceinline__ Win(const TfWindowArgs& args, float* smem) : a(args), sm(smem) {
    d = a.d;
    B = a.B;
    rf = a.rf;
    M = B * rf;
    nH = a.n_heads;
    dH = d / nH;
    ff = a.ff;
    hs = tf_hs(ff);
    S = tf_cdiv(ff, hs);
    nqb = tf_cdiv(rf, TF_QB);
    tb = TF_TN / dH > 1 ? TF_TN / dH : 1;  // column blocks a stage-1 task
    ldc = 2 * a.n_layers * d;
    L = tf_smem(d, nH, ff, TF_QB, tf_head_width(a.n_head, a.head_in, a.head_out));
    wb.init(reinterpret_cast<uint64_t*>(sm + L.mbar));
    const long long Md = (long long)M * d;
    x0 = a.scratch;
    xa = x0 + Md;
    x1 = xa + Md;
    x2 = x1 + Md;
    qkv = x2 + Md;
    ckv = qkv + 3 * Md;
    po = ckv + (long long)ldc * M;
    pc = po + nH * Md;
    pf = pc + nH * Md;
  }

  __device__ __forceinline__ const float* lw(int l, int kind) const {
    return tf_layer_w(a, l, kind);
  }
  __device__ __forceinline__ bool last(int l) const { return l == a.n_layers - 1; }

  // Stage 1's column groups at layer l (g < 2, or 3 at layer 0).
  __device__ __forceinline__ ColGroup group(int l, int g) const {
    ColGroup c;
    c.rows = M;
    c.row0 = 0;
    c.rstride = 1;
    if (g == 2) {
      c.W = a.w + a.off_ckv_w;
      c.bias = a.w + a.off_ckv_b;
      c.out = ckv;
      c.ldo = ldc;
      c.N = ldc;
    } else {
      c.W = lw(l, K_WQKV) + (long long)g * d * d;  // blocks nH g ..
      c.bias = lw(l, K_BQKV) + g * d;
      c.out = qkv + g * d;
      c.ldo = 3 * d;
      c.N = g == 0 ? d : 2 * d;
      if (g == 0 && last(l)) {  // the last layer's queries: each stream's last row
        c.rows = B;
        c.row0 = rf - 1;
        c.rstride = rf;
      }
    }
    c.ct = tf_cdiv(c.N / dH, tb);
    return c;
  }
  __device__ __forceinline__ int n_groups(int l) const { return l == 0 ? 3 : 2; }
  __device__ __forceinline__ int s1_rows(int l) const {
    int work = 0;
    for (int g = 0; g < n_groups(l); ++g) {
      const ColGroup c = group(l, g);
      work += c.rows * c.ct;
    }
    const int r = tf_cdiv(work, (int)gridDim.x);
    return r < 1 ? 1 : (r > TF_R ? TF_R : r);
  }
  // stage 1 task -> (group, row tile, column tile)
  __device__ __forceinline__ void s1_task(int l, int task, int& g, int& rt, int& ct, int& R) const {
    R = s1_rows(l);
    for (g = 0; g < n_groups(l); ++g) {
      const ColGroup c = group(l, g);
      const int n = tf_cdiv(c.rows, R) * c.ct;
      if (task < n) break;
      task -= n;
    }
    const ColGroup c = group(l, g);
    rt = task / c.ct;
    ct = task % c.ct;
  }
  // stage 4 rows: every row, or each stream's last row in the last layer
  __device__ __forceinline__ int s4_rows(int l) const { return last(l) ? B : M; }
  __device__ __forceinline__ int s4_R(int l) const { return tf_rows_per_task(s4_rows(l), S); }
  // stages 2 and 3: (stream, head, query block); one query block (the last
  // row) in the last layer
  __device__ __forceinline__ int attn_qb(int l) const { return last(l) ? 1 : nqb; }

  __device__ __forceinline__ int n_tasks(int st) const {
    const int l = st / 4, kind = st % 4;
    if (st == 4 * a.n_layers) return B;
    if (kind == 0) {
      const int R = s1_rows(l);
      int n = 0;
      for (int g = 0; g < n_groups(l); ++g) {
        const ColGroup c = group(l, g);
        n += tf_cdiv(c.rows, R) * c.ct;
      }
      return n;
    }
    if (kind == 3) return tf_cdiv(s4_rows(l), s4_R(l)) * S;
    return B * nH * attn_qb(l);
  }

  // Issue the copies of task `task`'s weight slice, its columns' biases and
  // its fold's parameters (nothing for a task the stage does not have).
  __device__ __forceinline__ void issue(int st, int task) const {
    if (st >= 4 * a.n_layers || task >= n_tasks(st)) return;
    wb.begin();
    wb.expect(copy_slice(st, task));
  }

  // The copies of a task's slice; returns the bytes the bulk copies bring.
  __device__ __forceinline__ unsigned copy_slice(int st, int task) const {
    const int l = st / 4, kind = st % 4;
    unsigned bytes = 0;
    float* W = sm + L.w;
    float* bias = sm + L.bias;
    float* fp = sm + L.fp;
    if (kind == 0) {
      int g, rt, ct, R;
      s1_task(l, task, g, rt, ct, R);
      const ColGroup c = group(l, g);
      const int b0 = ct * tb, nb = min(tb, c.N / dH - b0), n = nb * dH;
      if (l > 0 && g < 2) bytes += tf_copy_fold_params(a, fp, l - 1, K_B2, K_LN3W, wb.bar);
      bytes += tf_copy_run(W, c.W + (long long)b0 * d * dH, (nb * d) * dH, wb.bar);
      bytes += tf_copy_run(bias, c.bias + b0 * dH, n, wb.bar);
    } else if (kind == 3) {
      const int sl = task % S, c0 = sl * hs, n = min(hs, ff - c0);
      bytes += tf_copy_fold_params(a, fp, l, K_BCO, K_LN2W, wb.bar);
      bytes += tf_copy_run(W, lw(l, K_W1) + (long long)c0 * d, d * n, wb.bar);
      bytes += tf_copy_run(bias, lw(l, K_B1) + c0, n, wb.bar);
      bytes += tf_copy_run(W + tf_round4(d * hs), lw(l, K_W2) + (long long)c0 * d, n * d, wb.bar);
    } else {
      const int h = (task / attn_qb(l)) % nH;
      if (kind == 1) {
        bytes += tf_copy_run(W, lw(l, K_WO) + (long long)h * dH * d, dH * d, wb.bar);
      } else {
        bytes += tf_copy_fold_params(a, fp, l, K_BO, K_LN1W, wb.bar);
        bytes += tf_copy_run(W, lw(l, K_WCQ) + (long long)h * d * dH, d * dH, wb.bar);
        bytes += tf_copy_run(bias, lw(l, K_BCQ) + h * dH, dH, wb.bar);
        bytes += tf_copy_run(W + tf_round4(d * dH), lw(l, K_WCO) + (long long)h * dH * d,
                             dH * d, wb.bar);
      }
    }
    return bytes;
  }

  __device__ __forceinline__ void run_task(int st, int task) const {
    const int l = st / 4, kind = st % 4;
    float* W = sm + L.w;
    float* X = sm + L.x;
    float* T = sm + L.t;
    float* U = sm + L.u;
    float* bias = sm + L.bias;
    float* fp = sm + L.fp;
    const long long Md = (long long)M * d;
    wb.wait();  // the slice and the fold's parameters
    __syncthreads();
    TF_MARK(1);
    if (kind == 0) {
      int g, rt, ct, R;
      s1_task(l, task, g, rt, ct, R);
      const ColGroup c = group(l, g);
      const int r0 = rt * R, Rt = min(R, c.rows - r0);
      const long long row0 = c.row0 + (long long)r0 * c.rstride;
      if (l == 0 || g == 2)
        tf_fold(X, d, Rt, row0, c.rstride, d, x0, nullptr, 0, 0, nullptr, nullptr, nullptr,
                nullptr);
      else
        tf_fold(X, d, Rt, row0, c.rstride, d, x2, pf, Md, S, fp, fp + d, fp + 2 * d,
                (g == 0 && ct == 0) ? xa : nullptr);
      TF_MARK(0);
      const int b0 = ct * tb, nb = min(tb, c.N / dH - b0);
      tf_product(X, d, Rt, W, dH, d * dH, d, nb * dH, U, c.out + row0 * c.ldo + b0 * dH,
                 c.rstride * c.ldo, bias, 0);
      TF_MARK(2);
    } else if (kind == 3) {
      const int R = s4_R(l), sl = task % S, r0 = (task / S) * R;
      const int Rt = min(R, s4_rows(l) - r0);
      const int rstride = last(l) ? rf : 1;
      const long long row0 = (last(l) ? rf - 1 : 0) + (long long)r0 * rstride;
      const int c0 = sl * hs, n = min(hs, ff - c0);
      tf_fold(X, d, Rt, row0, rstride, d, x1, pc, Md, nH, fp, fp + d, fp + 2 * d,
              sl == 0 ? x2 : nullptr);
      TF_MARK(0);
      float* hid = T + L.hid;
      tf_product(X, d, Rt, W, n, 0, d, n, U, hid, L.ld_hid, bias, 1);  // relu(x W1 + b1)
      TF_MARK(2);
      tf_product(hid, L.ld_hid, Rt, W + tf_round4(d * hs), d, 0, n, d, U, pf + sl * Md + row0 * d,
                 (long long)rstride * d, nullptr, 0);
      TF_MARK(4);
    } else {
      const int nb = attn_qb(l);
      const int qb = task % nb, h = (task / nb) % nH, s = task / (nb * nH);
      const int q0 = last(l) ? rf - 1 : qb * TF_QB, n_q = last(l) ? 1 : min(TF_QB, rf - q0);
      const long long srow = (long long)s * rf, row0 = srow + q0;
      float* att = T + L.att;
      if (kind == 1) {
        attn_block(qkv + row0 * 3 * d + h * dH, 3 * d, qkv + srow * 3 * d + d + h * dH, 3 * d,
                   qkv + srow * 3 * d + 2 * d + h * dH, 3 * d, att, L.ld_att, n_q, q0 + n_q, q0,
                   true, dH, a.inv_sqrt_dh, true, U);
        TF_MARK(3);
        tf_product(att, L.ld_att, n_q, W, d, 0, dH, d, U, po + h * Md + row0 * d, d, nullptr, 0);
        TF_MARK(4);
      } else {
        tf_fold(X, d, n_q, row0, 1, d, l == 0 ? x0 : xa, po, Md, nH, fp, fp + d, fp + 2 * d,
                h == 0 ? x1 : nullptr);
        TF_MARK(0);
        tf_product(X, d, n_q, W, dH, 0, d, dH, U, T, L.ld_qkv, bias, 0);  // cross q
        TF_MARK(2);
        const float* kc = ckv + srow * ldc + 2 * l * d + h * dH;
        attn_block(T, L.ld_qkv, kc, ldc, kc + d, ldc, att, L.ld_att, n_q, q0 + n_q, q0, true, dH,
                   a.inv_sqrt_dh, true, U);
        TF_MARK(3);
        tf_product(att, L.ld_att, n_q, W + tf_round4(d * dH), d, 0, dH, d, U,
                   pc + h * Md + row0 * d,
                   d, nullptr, 0);
        TF_MARK(4);
      }
    }
  }

  // x0 rows j0 .. j1 - 1 of every stream's window buf[s, i0 .. i0 + rf),
  // by the threads idx = first, first + step, ... of the grid.
  __device__ __forceinline__ void embed_rows(int i0, int j0, int j1, int first, int step) const {
    const long long W = (long long)rf + a.n_steps;
    const float* emb = a.w + a.off_emb;
    const int n = j1 - j0;
    for (int idx = first; idx < B * n * d; idx += step) {
      const int c = idx % d, j = j0 + (idx / d) % n, s = idx / (d * n);
      const int tk = a.buf[s * W + i0 + j];
      x0[((long long)s * rf + j) * d + c] =
          __ldg(emb + (long long)tk * d + c) + __ldg(a.pe + j * d + c);
    }
  }
};

__global__ void __launch_bounds__(TF_THREADS, 1)
    tf_window_kernel(const __grid_constant__ TfWindowArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const Win k(a, smem);
  const int d = a.d, rf = a.rf, B = a.B, L = a.n_layers;
  const long long W = (long long)rf + a.n_steps;
  long long n_sync = 0;

  const int gtid = blockIdx.x * TF_THREADS + threadIdx.x, gthreads = gridDim.x * TF_THREADS;
  k.embed_rows(0, 0, rf, gtid, gthreads);
  k.issue(0, blockIdx.x);
  grid.sync();
  ++n_sync;

  for (int i = 0; i < a.n_steps; ++i) {
    for (int st = 0; st < 4 * L; ++st) {
      TF_STAGE(st % 4);
      for (int task = blockIdx.x; task < k.n_tasks(st); task += gridDim.x) {
        if (task != blockIdx.x) k.issue(st, task);  // the first was issued before the barrier
        k.run_task(st, task);
        __syncthreads();
      }
      k.issue(st + 1, blockIdx.x);
      TF_MARK(5);
      grid.sync();
      ++n_sync;
    }
    // the head on each stream's last row; the token extends the window.  The
    // next window's rows but the last hold tokens already known: the whole
    // grid embeds them meanwhile
    if (i + 1 < a.n_steps) k.embed_rows(i + 1, 0, rf - 1, gtid, gthreads);
    float* x = smem + k.L.u;
    for (int s = blockIdx.x; s < B; s += gridDim.x) {
      tf_fold(x, d, 1, (long long)s * rf + rf - 1, 1, d, k.x2, k.pf, (long long)k.M * d, k.S,
              tf_layer_w(a, L - 1, K_B2), tf_layer_w(a, L - 1, K_LN3W),
              tf_layer_w(a, L - 1, K_LN3B), nullptr);
      const int tk = tf_head_token(a, a.t0 + i, s, x);
      if (threadIdx.x == 0) a.buf[s * W + rf + i] = tk;
      if (i + 1 < a.n_steps)
        for (int c = threadIdx.x; c < d; c += TF_THREADS)
          k.x0[((long long)s * rf + rf - 1) * d + c] =
              __ldg(a.w + a.off_emb + (long long)tk * d + c) + __ldg(a.pe + (rf - 1) * d + c);
      __syncthreads();
    }
    if (i + 1 < a.n_steps) k.issue(0, blockIdx.x);
    grid.sync();
    ++n_sync;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.barriers != nullptr) *a.barriers = n_sync;
}

extern "C" {

int mmk_tf_window_args_size(void) { return (int)sizeof(TfWindowArgs); }

long long mmk_tf_window_scratch_floats(const TfWindowArgs* a) {
  return win_scratch_floats(a->B, a->rf, a->d, a->n_heads, a->ff, a->n_layers);
}

long long mmk_tf_window_smem_bytes(const TfWindowArgs* a) {
  return (long long)sizeof(float) *
         tf_smem(a->d, a->n_heads, a->ff, TF_QB,
                 tf_head_width(a->n_head, a->head_in, a->head_out))
             .total;
}

// Launch on `stream` (PyTorch's current stream); does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
int mmk_tf_window_decode(const TfWindowArgs* args, void* stream) {
  TfWindowArgs a = *args;
  return tf_launch_cooperative((const void*)tf_window_kernel, &a,
                               (size_t)mmk_tf_window_smem_bytes(&a), (cudaStream_t)stream);
}

const char* mmk_tf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
