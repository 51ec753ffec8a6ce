// Device code shared by the two SimpleTransformer decode kernels
// (transformer_decode.cu, K6; transformer_kv.cu, K7).
//
// Both kernels are one persistent cooperative launch: a block on every
// streaming multiprocessor, and a grid barrier (cooperative_groups
// this_grid().sync(); 1.1 us on the 132 blocks of an H100,
// tools/profile_transformer_decode.py) between dependent stages.  A stage is
// a list of tasks spread over the blocks (task t on block t % grid); each
// task is the work of a few rows (TF_R at most) on one slice of the weights:
//
//  * fold on load (tf_fold): a task's input rows are built where they are
//    read, from the previous stage's split-K partial sums, added in a fixed
//    order (partial 0, 1, ... then the bias, then the residual), and layer-
//    normed.  No stage writes a finished activation for another to re-read,
//    so a product and the norm that follows it need no barrier of their own.
//    One designated task of each row tile also writes the normed rows out,
//    as the residual of a later stage;
//  * products (tf_product): Y = X . W of the task's rows, X and the weight
//    slice both in shared memory, a thread a column, K split over thread
//    groups when the slice is narrow, the groups' sums added in group
//    order.  A partial product over a slice of K (attention's out product
//    per head, FFN 2 per hidden slice) is written to its own buffer, never
//    added atomically, so every sum runs in the same order whatever the
//    chunking, the batch or the grid;
//  * attention (attn_block): the keys and values a task's rows see staged
//    in shared memory, whole up to TF_KT keys, else TF_KT at a time with an
//    online softmax; a warp a query;
//  * the head and the sampling, a block a stream.
//
// Weights in flight across the barrier: the weights never change during a
// launch, so once a block has finished its last task of a stage it issues
// the copies of its first task of the next stage into its weight buffer
// (the weight slice, the slice's biases, the fold's bias and norm) and only
// then waits at the grid barrier.  The copies go through the bulk copy
// engine (tf_copy_run: TMA's 1-D cp.async.bulk, completion counted on an
// mbarrier in shared memory): the pack stores every column-sliced matrix in
// column blocks (ops/transformer_decode.transformer_weight_pack), so a
// task's slice is a few contiguous runs, a few instructions to issue.  After
// the barrier only the task's activation rows (a few KB, written during the
// launch) come from L2, with plain loads: data written during the launch is
// never read through the read-only path or by an async copy.
//
// Grid barriers a step: 3L + 1 in K7, 4L + 1 in K6 (each kernel's note says
// which stages), against 8L + 1 before this design.
//
// Arithmetic: f32 on CUDA cores, fused multiply-adds in k order within a
// slice, the layer norm as flax computes it (var = max(0, E[x^2] - E[x]^2),
// eps 1e-5), exact expf/logf/sqrtf.  d and ff must be multiples of 4; the
// gate (ops/transformer_decode.supports_kernel_decode) checks it and that
// tf_smem fits a block.
//
// The weight type WT.  Every function that reads the packed weights takes
// them as float or as __nv_bfloat16 (K7's bf16 route, MMK_DECODE_BF16=1):
// the copies move sizeof(WT) bytes a weight into a buffer of that type, a
// weight, bias or norm affine is converted to f32 where it is read
// (tf_wf, tf_w4, tf_wldg), and a product rounds each input activation to
// bf16 as it reads it (tf_in; JAX's K7 rounds every dot input,
// pallas_decode.py:1817).  Sums, norms, attention and the K/V rings stay
// f32.  Under bf16, d, ff and d / n_heads must be multiples of 8 (16-byte
// copies of 2-byte weights).  For WT = float every helper is the identity,
// so K6 and K7's f32 instantiation compile to the f32 arithmetic above.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "noise.cuh"

namespace cg = cooperative_groups;

// Profiling hooks, empty here: tools/profile_transformer_decode.py defines
// them in its copy of the sources to stamp block 0's clock at each phase of
// a task (TF_MARK: 0 fold, 1 weight wait, 2 first product, 3 attention, 4
// second product, 5 next stage's weight issue) and of each stage kind
// (TF_STAGE).
#ifndef TF_MARK
#define TF_MARK(phase)
#endif
#ifndef TF_STAGE
#define TF_STAGE(kind)
#endif

#define TF_THREADS 256
#define TF_WARPS (TF_THREADS / 32)
#define TF_R 16      // rows a task at most
#define TF_HS 64     // FFN hidden units a task (a K slice of FFN 2)
#define TF_TN 64     // columns a K6 q|k|v (or cross k|v) task
#define TF_QB 8      // query rows a K6 attention task
#define TF_KT 64     // keys an attention tile
#define TF_MAX_HEAD 8

// A layer's tensors, in LAYER_KINDS order (mimikit_tpu_torch/ops/transformer_decode.py).
enum TfKind {
  K_WQKV, K_BQKV, K_WO, K_BO, K_WCQ, K_BCQ, K_WCO, K_BCO,
  K_LN1W, K_LN1B, K_LN2W, K_LN2B, K_LN3W, K_LN3B, K_W1, K_B1, K_W2, K_B2, TF_N_KINDS
};

__host__ __device__ inline int tf_round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int tf_cdiv(int a, int b) { return (a + b - 1) / b; }

// -- the weight type ------------------------------------------------------------------

// n weights rounded up to a whole 16 bytes (4 floats, 8 bf16).
template <class WT>
__host__ __device__ inline int tf_roundw(int n) {
  return sizeof(WT) == 4 ? tf_round4(n) : (n + 7) & ~7;
}

// A weight as f32: from shared memory (tf_wf), through the read-only path
// (tf_wldg), or four adjacent ones (tf_w4; 16-byte aligned for float, 8 for
// bf16).
__device__ __forceinline__ float tf_wf(float v) { return v; }
__device__ __forceinline__ float tf_wf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float tf_wldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float tf_wldg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ float4 tf_w4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 tf_w4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// A product's input activation as a product with WT weights reads it.
template <class WT>
__device__ __forceinline__ float tf_in(float x) {
  return x;
}
template <>
__device__ __forceinline__ float tf_in<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// T itself, in a context that does not deduce it: a parameter of this type
// (a bias, possibly null) takes WT from another argument or the default.
template <class T>
struct tf_id {
  typedef T type;
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

// -- shared memory ----------------------------------------------------------------

// FFN hidden units a task: TF_HS, or all of a narrower FFN.
__host__ __device__ inline int tf_hs(int ff) { return ff < TF_HS ? ff : TF_HS; }

// Shared memory of an attention task with n_q queries of head width dh, in
// floats: one tile of TF_KT keys and values, the queries, each query's
// running max and sum, a warp's scores over the tile.  It does not grow with
// the keys (rf): they are staged TF_KT at a time.
__host__ __device__ inline int tf_attn_floats(int n_q, int dh) {
  return tf_round4(TF_KT * (dh + 1)) + tf_round4(TF_KT * dh) + tf_round4(n_q * dh) +
         tf_round4(2 * n_q) + TF_WARPS * TF_KT;
}

// The regions of a block's dynamic shared memory, offsets in floats:
//   w    the weight buffer (the prefetch target): the largest task slice,
//        about max(4 d dh, 2 d hs, d TF_TN) weights
//   bias the biases of the task's product columns (copied with the weights)
//   fp   the bias and the norm's scale and offset its fold adds (3 d, copied too)
//   (w, bias and fp hold weights of wbytes bytes; the offsets count floats)
//   x    TF_R rows of d (a task's folded input rows)
//   x2   TF_R rows of d (K7's x0 rows, for the cross k|v)
//   t    TF_R rows of q|k|v (3 dh), attention output (dh) and FFN hidden (hs)
//   u    scratch shared in turn by the products' group sums (TF_THREADS
//        TF_R), attention's staging (tf_attn_floats) and the head
//   mbar the mbarrier of the weight buffer's bulk copies
// n weights of wbytes bytes (4 or 2) rounded up to a whole 16 bytes, in
// weights; and n weights in floats.  For f32 they are the expressions the
// f32-only layout used, so K6's code does not change.
__host__ __device__ inline int tf_round_bytes(int n, int wbytes) {
  return wbytes == 4 ? tf_round4(n) : (n + 7) & ~7;
}
__host__ __device__ inline int tf_in_floats(int n, int wbytes) {
  return wbytes == 4 ? n : (n * wbytes + 3) / 4;
}

struct TfSmem {
  int w, bias, fp, x, x2, t, u, mbar, total;
  int ld_qkv, ld_att, ld_hid;  // row pitches in t
  int att, hid;                // offsets of the attention output and the hidden rows in t
};

__host__ __device__ inline TfSmem tf_smem(int d, int n_heads, int ff, int n_q, int head_w,
                                          int wbytes = 4) {
  const int dh = d / n_heads, hs = tf_hs(ff);
  TfSmem s;
  s.ld_qkv = tf_round4(3 * dh);
  s.ld_att = tf_round4(dh);
  s.ld_hid = tf_round4(hs);
  // the largest task slice: K7's self q|k|v + Wo rows, its cross q + cross
  // k|v + Wco rows, either kernel's FFN slice, K6's q|k|v column tile
  int w = tf_round_bytes(3 * d * dh, wbytes) + dh * d;
  const int cross =
      tf_round_bytes(d * dh, wbytes) + tf_round_bytes(2 * d * dh, wbytes) + dh * d;
  const int ffn = tf_round_bytes(d * hs, wbytes) + hs * d;
  if (cross > w) w = cross;
  if (ffn > w) w = ffn;
  if (d * TF_TN > w) w = d * TF_TN;
  int u = TF_THREADS * TF_R;
  const int attn = tf_attn_floats(n_q, dh);
  if (attn > u) u = attn;
  const int w32 = (head_w + 31) & ~31;
  const int head = tf_round4(d) + 2 * tf_round4(head_w) + (w32 > TF_THREADS ? w32 : TF_THREADS) +
                   2 * TF_WARPS;
  if (head > u) u = head;
  int nb = 3 * dh;  // the biases of a task's columns, gathered with its weights
  if (TF_TN > nb) nb = TF_TN;
  if (hs > nb) nb = hs;
  s.w = 0;
  s.bias = s.w + tf_round4(tf_in_floats(w, wbytes));
  s.fp = s.bias + tf_round4(tf_in_floats(nb, wbytes));
  s.x = s.fp + tf_in_floats(3 * d, wbytes);  // d: a multiple of 4 (f32), 8 (bf16)
  s.x2 = s.x + TF_R * d;
  s.t = s.x2 + TF_R * d;
  s.att = TF_R * s.ld_qkv;
  s.hid = s.att + TF_R * s.ld_att;
  s.u = s.t + s.hid + TF_R * s.ld_hid;
  s.mbar = s.u + tf_round4(u);  // the weight buffer's mbarrier (8 bytes)
  s.total = s.mbar + 4;
  return s;
}

// The widest layer of the head chain (its input or output).
__host__ __device__ inline int tf_head_width(int n_head, const int* head_in, const int* head_out) {
  int w = 0;
  for (int k = 0; k < n_head; ++k) {
    if (head_in[k] > w) w = head_in[k];
    if (head_out[k] > w) w = head_out[k];
  }
  return w;
}

// Rows a task of a stage with `rows` rows and `col_tasks` tasks a row tile:
// enough to give every block about one task, at most TF_R.  It depends on
// the widths, B and the grid, never on the number of steps.
__device__ __forceinline__ int tf_rows_per_task(int rows, int col_tasks) {
  int r = tf_cdiv(rows * col_tasks, (int)gridDim.x);
  return r < 1 ? 1 : (r > TF_R ? TF_R : r);
}

// The packed weights of either kernel's arguments, as WT.
template <class WT, class A>
__device__ __forceinline__ const WT* tf_wbase(const A& a) {
  return reinterpret_cast<const WT*>(a.w);
}

// Layer l's tensor `kind` in the packed weights of either kernel's arguments.
template <class WT = float, class A>
__device__ __forceinline__ const WT* tf_layer_w(const A& a, int l, int kind) {
  return tf_wbase<WT>(a) + a.off_layer[kind] + (long long)l * a.layer_stride;
}

// -- weight copies (the bulk copy engine) ----------------------------------------------

// A task's weight slice goes in one 16-byte-aligned bulk copy (TMA's 1-D
// cp.async.bulk) a contiguous run, each reporting its bytes to an mbarrier
// in shared memory; the block waits on the barrier's phase.  A thread issues
// one or two instructions, so the issue costs little before the grid
// barrier.  Every run is 16-byte aligned and a multiple of 16 bytes: the
// pack starts each tensor and each column block at a multiple of 4 floats,
// and the gate asks d, ff and d / n_heads to be multiples of 4.
__device__ __forceinline__ unsigned tf_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void tf_bulk_copy(void* dst, const void* src, unsigned bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(tf_smem_addr(dst)), "l"(src), "r"(bytes), "r"(tf_smem_addr(bar))
      : "memory");
}

#define TF_BULK_MAX 32768  // bytes a single bulk copy at most

// Copy the contiguous run src[0 .. n) of n weights into dst, in copies of
// TF_BULK_MAX bytes spread over the block's threads; returns the bytes.
template <class WT>
__device__ __forceinline__ unsigned tf_copy_run(WT* dst, const WT* src, int n, uint64_t* bar) {
  constexpr unsigned E = sizeof(WT);
  const unsigned total = E * n;
  for (unsigned off = TF_BULK_MAX * threadIdx.x; off < total; off += TF_BULK_MAX * TF_THREADS)
    tf_bulk_copy(dst + off / E, src + off / E, min((unsigned)TF_BULK_MAX, total - off), bar);
  return total;
}

// The block's weight buffer: its mbarrier and phase.  A block issues a
// task's copies (begin, the tf_copy_run calls, expect) at most one task
// ahead, and waits for them before it runs the task.
struct TfWeightBuffer {
  uint64_t* bar;
  mutable unsigned phase;
  mutable bool pending;  // copies issued and not yet waited for

  __device__ __forceinline__ void init(uint64_t* b) {
    bar = b;
    phase = 0;
    pending = false;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(tf_smem_addr(bar)));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // Before overwriting the buffer through the async proxy: its last reads
  // were generic.
  __device__ __forceinline__ void begin() const {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // Thread 0 arrives on the barrier, expecting the copies' bytes.
  __device__ __forceinline__ void expect(unsigned bytes) const {
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(tf_smem_addr(bar)), "r"(bytes) : "memory");
    pending = true;
  }
  __device__ __forceinline__ void wait() const {
    if (!pending) return;
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(tf_smem_addr(bar)), "r"(phase) : "memory");
    phase ^= 1;
    pending = false;
  }
};

// A fold's bias (layer l's tensor `bias`) and norm (its tensor `ln`: the
// scale, then the offset, adjacent in the pack) into fp[0 .. 3d); returns
// the bytes.
template <class WT, class A>
__device__ __forceinline__ unsigned tf_copy_fold_params(const A& a, WT* fp, int l, int bias,
                                                        int ln, uint64_t* bar) {
  return tf_copy_run(fp, tf_layer_w<WT>(a, l, bias), a.d, bar) +
         tf_copy_run(fp + a.d, tf_layer_w<WT>(a, l, ln), 2 * a.d, bar);
}

// -- fold on load -------------------------------------------------------------------

// Rows r < R of a tile, physical row row0 + r * rstride (of d floats):
//   v = res[row] + (parts[0][row] + ... + parts[n_parts - 1][row] + bias)
// (res or the parts may be absent), layer-normed with (g, b) when g is not
// null, into X (row pitch ldx); xout, when not null, gets the rows too.
// bias, g and b (weights of type WT) may lie in shared memory (a task's
// copies) or global.  The
// block's threads first take (row, 4 columns) items, each issuing its
// partials' 16-byte loads TF_FOLD_BATCH at a time, so a fold costs a few L2
// round trips however many partials it adds; then a warp a row takes the
// statistics from shared memory.  The caller's rows are ready after it
// returns.
#define TF_FOLD_BATCH 16
template <class WT = float>
__device__ __noinline__ void tf_fold(float* X, int ldx, int R, long long row0, int rstride,
                                     int d, const float* res, const float* parts,
                                     long long pstride, int n_parts,
                                     const typename tf_id<WT>::type* bias,
                                     const typename tf_id<WT>::type* g,
                                     const typename tf_id<WT>::type* b, float* xout) {
  const int d4 = d / 4;
  for (int item = threadIdx.x; item < R * d4; item += TF_THREADS) {
    const int r = item / d4, k = 4 * (item % d4);
    const long long off = (row0 + (long long)r * rstride) * d + k;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 rr = res != nullptr ? *reinterpret_cast<const float4*>(res + off) : v;
    if (n_parts > 0) {
      const float* p = parts + off;
      for (int q0 = 0; q0 < n_parts; q0 += TF_FOLD_BATCH) {
        float4 u[TF_FOLD_BATCH];
#pragma unroll
        for (int q = 0; q < TF_FOLD_BATCH; ++q)
          if (q0 + q < n_parts)
            u[q] = *reinterpret_cast<const float4*>(p + (q0 + q) * pstride);
#pragma unroll
        for (int q = 0; q < TF_FOLD_BATCH; ++q) {
          if (q0 + q < n_parts) {
            if (q0 + q == 0) {
              v = u[q];
            } else {
              v.x += u[q].x;
              v.y += u[q].y;
              v.z += u[q].z;
              v.w += u[q].w;
            }
          }
        }
      }
      if (bias != nullptr) {
        const float4 bb = tf_w4(bias + k);
        v.x += bb.x;
        v.y += bb.y;
        v.z += bb.z;
        v.w += bb.w;
      }
    }
    if (res != nullptr) v = make_float4(rr.x + v.x, rr.y + v.y, rr.z + v.z, rr.w + v.w);
    *reinterpret_cast<float4*>(X + r * ldx + k) = v;
    if (g == nullptr && xout != nullptr) *reinterpret_cast<float4*>(xout + off) = v;
  }
  __syncthreads();
  if (g != nullptr) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < R; r += TF_WARPS) {
      float* x = X + r * ldx;
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
      float* xo = xout != nullptr ? xout + (row0 + (long long)r * rstride) * d : nullptr;
      for (int k = lane; k < d; k += 32) {
        const float v = (x[k] - mu) * rs * tf_wf(g[k]) + tf_wf(b[k]);
        x[k] = v;
        if (xo != nullptr) xo[k] = v;
      }
    }
    __syncthreads();
  }
}

// -- products -----------------------------------------------------------------------

// Y[r][c] = act(sum_k X[r][k] W[k][c] + bias[c]) for r < R <= TF_R, c < N,
// X (row pitch ldx, a multiple of 4) and W (weights of type WT, each X
// element read through tf_in) in shared memory,
// Y with row pitch ldy, bias optional (null), act relu or none.  A thread a
// column (columns in blocks of TF_THREADS); when N is narrower, K is split
// over TF_THREADS / N thread groups (each of at least 16 terms, a multiple
// of 4), summed in group order through `red` (TF_THREADS * TF_R floats).
// One copy of the code serves every product of a kernel (not inlined): a
// step runs each stage once per block, so every stage's code would
// otherwise be fetched into the instruction cache anew.
template <class WT>
__device__ __forceinline__ void tf_out(float* Y, long long ldy, const WT* bias, int relu, int r,
                                       int c, float v) {
  if (bias != nullptr) v += tf_wf(bias[c]);
  if (relu) v = fmaxf(v, 0.0f);
  Y[r * ldy + c] = v;
}

template <int RP, class WT>
__device__ __noinline__ void tf_product_rows(const float* X, int ldx, int R, const WT* W,
                                             int bw, int bstride, int K, int N, float* red,
                                             float* Y, long long ldy, const WT* bias,
                                             int relu) {
  const int nc = N < TF_THREADS ? N : TF_THREADS;
  int groups = TF_THREADS / nc;
  const int most = tf_cdiv(K, 16);
  if (groups > most) groups = most;
  if (groups < 1) groups = 1;
  const int kc = tf_round4(tf_cdiv(K, groups));
  const int g = threadIdx.x / nc, c0 = threadIdx.x % nc;
  for (int cb = 0; cb < N; cb += nc) {
    const int c = cb + c0;
    const bool active = g < groups && c < N;
    float acc[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[r] = 0.0f;
    if (active) {
      const WT* wc = W + (c / bw) * bstride + c % bw;  // column c, row pitch bw
      const int k1 = min(K, (g + 1) * kc);
      int k = g * kc;
      for (; k + 4 <= k1; k += 4) {
        const float w0 = tf_wf(wc[(k + 0) * bw]), w1 = tf_wf(wc[(k + 1) * bw]);
        const float w2 = tf_wf(wc[(k + 2) * bw]), w3 = tf_wf(wc[(k + 3) * bw]);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(X + r * ldx + k);
          float a = acc[r];
          a = fmaf(tf_in<WT>(xv.x), w0, a);
          a = fmaf(tf_in<WT>(xv.y), w1, a);
          a = fmaf(tf_in<WT>(xv.z), w2, a);
          a = fmaf(tf_in<WT>(xv.w), w3, a);
          acc[r] = a;
        }
      }
      for (; k < k1; ++k) {
        const float w = tf_wf(wc[k * bw]);
#pragma unroll
        for (int r = 0; r < RP; ++r) acc[r] = fmaf(tf_in<WT>(X[r * ldx + k]), w, acc[r]);
      }
    }
    if (groups == 1) {
      if (active) {
#pragma unroll
        for (int r = 0; r < RP; ++r)
          if (r < R) tf_out(Y, ldy, bias, relu, r, c, acc[r]);
      }
    } else {
      if (active) {
#pragma unroll
        for (int r = 0; r < RP; ++r)
          if (r < R) red[(g * R + r) * nc + c0] = acc[r];
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < R * nc; idx += TF_THREADS) {
        const int r = idx / nc, cc = idx % nc;
        if (cb + cc < N) {
          float v = red[r * nc + cc];
          for (int q = 1; q < groups; ++q) v += red[(q * R + r) * nc + cc];
          tf_out(Y, ldy, bias, relu, r, cb + cc, v);
        }
      }
    }
    __syncthreads();
  }
}

// The product for R rows, run as if for the next power of two: the extra
// rows of X lie inside the task's row buffer and their results are dropped.
// W is a (K, N) matrix stored in column blocks of width bw, block j at W + j
// * bstride, each (K, bw) row-major (one block: bw = N).
template <class WT>
__device__ __forceinline__ void tf_product(const float* X, int ldx, int R, const WT* W, int bw,
                                           int bstride, int K, int N, float* red, float* Y,
                                           long long ldy, const typename tf_id<WT>::type* bias,
                                           int relu) {
  if (R <= 1)
    tf_product_rows<1, WT>(X, ldx, R, W, bw, bstride, K, N, red, Y, ldy, bias, relu);
  else if (R <= 2)
    tf_product_rows<2, WT>(X, ldx, R, W, bw, bstride, K, N, red, Y, ldy, bias, relu);
  else if (R <= 4)
    tf_product_rows<4, WT>(X, ldx, R, W, bw, bstride, K, N, red, Y, ldy, bias, relu);
  else if (R <= 8)
    tf_product_rows<8, WT>(X, ldx, R, W, bw, bstride, K, N, red, Y, ldy, bias, relu);
  else
    tf_product_rows<16, WT>(X, ldx, R, W, bw, bstride, K, N, red, Y, ldy, bias, relu);
}

// -- attention (a block a task) ---------------------------------------------------------

// Rows 0 .. n of a head's keys K and values V (leading dimensions ldk, ldv)
// into Ks [n][dh + 1] and Vs [n][dh] in shared memory, in 16-byte loads, all
// of a thread's issued together.  Every caller's rows are 16-byte aligned:
// the gate asks d and d / n_heads to be multiples of 4, and each key and
// value row starts a multiple of 4 floats into its buffer.
__device__ __forceinline__ void tf_stage_kv(float* Ks, float* Vs, const float* K, int ldk,
                                            const float* V, int ldv, int n, int dh) {
  const int dh4 = dh / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < n * dh4; idx += TF_THREADS) {
    const int r = idx / dh4, c = 4 * (idx % dh4);
    const float4 kv = *reinterpret_cast<const float4*>(K + (long long)r * ldk + c);
    const float4 vv = *reinterpret_cast<const float4*>(V + (long long)r * ldv + c);
    float* kr = Ks + r * (dh + 1) + c;
    kr[0] = kv.x;
    kr[1] = kv.y;
    kr[2] = kv.z;
    kr[3] = kv.w;
    *reinterpret_cast<float4*>(Vs + r * dh + c) = vv;
  }
}

// Q (n_q rows, leading dimension ldq) into Qs [n_q][dh], each element scaled
// by inv when q_first.
__device__ __forceinline__ void tf_stage_q(float* Qs, const float* Q, int ldq, int n_q, int dh,
                                           float inv, bool q_first) {
  for (int idx = threadIdx.x; idx < n_q * dh; idx += TF_THREADS) {
    const int r = idx / dh, c = idx % dh;
    const float q = Q[(long long)r * ldq + c];
    Qs[idx] = q_first ? q * inv : q;
  }
}

// One head's attention for n_q query rows over n_keys key rows, by the block:
// query i sees keys 0 .. q_offset + i (causal) or all n_keys.  Q, K, V point
// at the head's first row (leading dimensions ldq, ldk, ldv; K and V may be
// written during the launch, Q may lie in shared memory); the out rows
// (leading dimension ldo) lie in shared memory.  Scores are q . k * inv
// (q_first: each q element scaled first, as K6 and the window twin scale;
// else the sum scaled, as the KV oracle does), masked keys excluded, softmax
// with the max over this head's own scores, then the weighted sum of the
// values.  The order of every sum depends on n_keys only, so every chunking
// of a stream adds alike.  attn_whole stages all n_keys <= TF_KT keys at
// once; attn_tiled stages TF_KT at a time (any rf).  Both fit in
// tf_attn_floats(n_q, dh) floats of `smem`.
__device__ __noinline__ void attn_whole(const float* Q, int ldq, const float* K, int ldk,
                                        const float* V, int ldv, float* out, int ldo, int n_q,
                                        int n_keys, int q_offset, bool causal, int dh, float inv,
                                        bool q_first, float* smem) {
  float* Ks = smem;                                   // [n_keys][dh + 1]
  float* Vs = Ks + tf_round4(n_keys * (dh + 1));      // [n_keys][dh]
  float* Qs = Vs + tf_round4(n_keys * dh);            // [n_q][dh]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = Qs + tf_round4(n_q * dh) + warp * tf_round4(n_keys);
  tf_stage_kv(Ks, Vs, K, ldk, V, ldv, n_keys, dh);
  tf_stage_q(Qs, Q, ldq, n_q, dh, inv, q_first);
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
    for (int j = lane; j < cnt; j += 32) p[j] = p[j] / sum;
    __syncwarp();
    for (int c = lane; c < dh; c += 32) {
      float acc = 0.0f;
#pragma unroll 8
      for (int j = 0; j < cnt; ++j) acc = fmaf(p[j], Vs[j * dh + c], acc);
      out[(long long)i * ldo + c] = acc;
    }
    __syncwarp();
  }
  __syncthreads();
}

// The keys in tiles of TF_KT, in key order, with an online softmax: a
// query's running max m and sum l, and its out row, are rescaled by
// exp(m_old - m_new) when a tile raises the max, and the out row is divided
// by l after the last tile.
__device__ __noinline__ void attn_tiled(const float* Q, int ldq, const float* K, int ldk,
                                        const float* V, int ldv, float* out, int ldo, int n_q,
                                        int n_keys, int q_offset, bool causal, int dh, float inv,
                                        bool q_first, float* smem) {
  float* Ks = smem;                                   // [TF_KT][dh + 1]
  float* Vs = Ks + tf_round4(TF_KT * (dh + 1));       // [TF_KT][dh]
  float* Qs = Vs + tf_round4(TF_KT * dh);             // [n_q][dh]
  float* ml = Qs + tf_round4(n_q * dh);               // [n_q][2]: running max, running sum
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = ml + tf_round4(2 * n_q) + warp * TF_KT;
  tf_stage_q(Qs, Q, ldq, n_q, dh, inv, q_first);
  for (int i = threadIdx.x; i < n_q; i += TF_THREADS) {
    ml[2 * i] = -INFINITY;
    ml[2 * i + 1] = 0.0f;
  }
  for (int j0 = 0; j0 < n_keys; j0 += TF_KT) {
    const int kt = min(TF_KT, n_keys - j0);
    tf_stage_kv(Ks, Vs, K + (long long)j0 * ldk, ldk, V + (long long)j0 * ldv, ldv, kt, dh);
    __syncthreads();
    for (int i = warp; i < n_q; i += TF_WARPS) {
      int cnt = (causal ? min(q_offset + i + 1, n_keys) : n_keys) - j0;
      if (cnt <= 0) continue;  // a causal query that sees none of this tile
      if (cnt > kt) cnt = kt;
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
      const float m_old = ml[2 * i], l_old = ml[2 * i + 1];
      const float m_new = fmaxf(m_old, mx);
      const float scale = expf(m_old - m_new);  // 0 at the first tile (m_old = -inf)
      float sum = 0.0f;
      for (int j = lane; j < cnt; j += 32) {
        const float e = expf(p[j] - m_new);
        p[j] = e;
        sum += e;
      }
      sum = tf_warp_sum(sum);
      __syncwarp();
      for (int c = lane; c < dh; c += 32) {
        float acc = j0 == 0 ? 0.0f : out[(long long)i * ldo + c] * scale;
#pragma unroll 8
        for (int j = 0; j < cnt; ++j) acc = fmaf(p[j], Vs[j * dh + c], acc);
        out[(long long)i * ldo + c] = acc;
      }
      __syncwarp();
      if (lane == 0) {
        ml[2 * i] = m_new;
        ml[2 * i + 1] = l_old * scale + sum;
      }
      __syncwarp();
    }
    __syncthreads();
  }
  for (int i = warp; i < n_q; i += TF_WARPS) {
    const float l = ml[2 * i + 1];
    for (int c = lane; c < dh; c += 32) out[(long long)i * ldo + c] /= l;
  }
  __syncthreads();
}

// A task's attention: attn_whole for a window of at most TF_KT keys (one
// pass; the tiles' bookkeeping costs ~1 us a call at rf 64 on an H100,
// tools/profile_transformer_decode.py), else attn_tiled.
__device__ __forceinline__ void attn_block(const float* Q, int ldq, const float* K, int ldk,
                                           const float* V, int ldv, float* out, int ldo,
                                           int n_q, int n_keys, int q_offset, bool causal,
                                           int dh, float inv, bool q_first, float* smem) {
  if (n_keys <= TF_KT)
    attn_whole(Q, ldq, K, ldk, V, ldv, out, ldo, n_q, n_keys, q_offset, causal, dh, inv, q_first,
               smem);
  else
    attn_tiled(Q, ldq, K, ldk, V, ldv, out, ldo, n_q, n_keys, q_offset, causal, dh, inv, q_first,
               smem);
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
template <class WT>
__device__ __forceinline__ void tf_block_ln(float* x, int d, const WT* g, const WT* b,
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
    x[k] = (x[k] - mu) * rs * tf_wldg(g + k) + tf_wldg(b + k);
  __syncthreads();
}

// out[c] = act(in . W[:, c] + bias[c]) for c < N, W (K, N) row-major, by the
// block: the contraction split over as many thread groups as fit (at least
// 32 terms a group), the groups' partial sums added in group order.
template <class WT>
__device__ __forceinline__ void tf_block_dense(const float* in, int K, int N, const WT* W,
                                               const WT* bias, bool mish, float* out,
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
    for (int k = g * kc; k < k1; ++k)
      acc = fmaf(tf_in<WT>(in[k]), tf_wldg(W + (long long)k * N + c), acc);
    red[g * Np + c] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < N; c += TF_THREADS) {
    float v = red[c];
    for (int g = 1; g < groups; ++g) v += red[g * Np + c];
    v += tf_wldg(bias + c);
    out[c] = mish ? tf_mish(v) : v;
  }
  __syncthreads();
}

// The token after one stream's last row: `smem` starts with that row (d
// floats, after the last layer's third norm), read from either kernel's
// arguments `a`.  The optional final norm, the Mish MLP, logits[:Q] /
// max(sigmoid(logits[Q]), min_temperature), / stream b's temperature + the
// noise of (seed, t, b) when sampling, argmax with ties to the lowest index.  Every
// thread returns the token.
template <class WT = float, class A>
__device__ __forceinline__ int tf_head_token(const A& a, long long t, int b, float* smem) {
  const int d = a.d;
  const int w = tf_head_width(a.n_head, a.head_in, a.head_out);
  float* x = smem;
  float* h0 = x + tf_round4(d);
  float* h1 = h0 + tf_round4(w);
  float* red = h1 + tf_round4(w);  // max(TF_THREADS, 32-rounded w) floats
  if (a.final_ln)
    tf_block_ln(x, d, tf_wbase<WT>(a) + a.off_lnf_w, tf_wbase<WT>(a) + a.off_lnf_b, red);
  const float* in = x;
  for (int k = 0; k < a.n_head; ++k) {
    float* out = (k & 1) ? h1 : h0;
    tf_block_dense(in, a.head_in[k], a.head_out[k], tf_wbase<WT>(a) + a.off_wh[k],
                   tf_wbase<WT>(a) + a.off_bh[k], k < a.n_head - 1, out, red);
    in = out;
  }
  const int Q = a.Q;
  const float lt = fmaxf(tf_sigmoid(in[Q]), a.min_temperature);
  const uint32_t key = a.argmax ? 0u : decode_noise_key(a.seed, t, b);
  const float temp = a.argmax ? 1.0f : a.temperature[b];
  float best = -INFINITY;
  int bestq = 0x7fffffff;
  for (int q = threadIdx.x; q < Q; q += TF_THREADS) {
    float v = in[q] / lt;
    if (!a.argmax) v = v / temp + gumbel_from_bits(mix32(key ^ (uint32_t)q));
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
