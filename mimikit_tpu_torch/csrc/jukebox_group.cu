// JukeBox tier-pyramid decode on thread-block clusters, a group of S streams
// a cluster: S streams' whole autoregressive loops in one launch, spread over
// the CL blocks of a cluster (CL = 4, 8 or 16), every product and every
// exchange of a step shared by the group.
//
// Replaces, beside the block-per-stream kernel of jukebox_decode.cu and the
// stream-per-cluster kernel of jukebox_cluster.cu, the TPU kernel
// make_jukebox_pallas_decoder (K8, mimikit_tpu/ops/pallas_decode.py:2386).
// It computes what both compute (jukebox_decode.cu's note gives the step):
// the same weights (jukebox_weight_pack, each block's slices laid out again on
// the host by ops/jukebox_decode.cluster_layout for its group size), the same
// (B, W) lead window as the only state, advanced in place, the same noise
// keys (noise.cuh) and the same argmax rule, ties to the lowest index.  The
// route (ops/jukebox_decode.decode_pyramid, K8_GROUP_ROUTE) sends it the
// batches wider than the cluster kernel's (B > 15).
//
// Bound.  jukebox3 (d 128, 8 heads, ff 256, 2 layers a tier, W 128, frames
// (32, 16, 4)) needs 6.19 MFLOP a stream-step: 6.05 ms for B=16 x 4,096 at
// the card's 67 TFLOP/s of f32.  The block kernel decodes one stream on one
// SM (~188 us a step whatever B up to the SMs, 16 of 132 busy at B=16); the
// cluster kernel one stream on a cluster (~128-144 us a step; 15 clusters of
// 8 fit), its step a chain of 29 exchanges (~1.0 us each at CL = 8) behind
// stages of small products whose cost hardly depends on their rows.
//
// Design: jukebox_cluster.cu's, for a group.  The S streams' rows are stacked
// (stream s's n frames of a tier at rows s n .. s n + n - 1 of every
// activation buffer), so each product runs S n rows against the block's
// weight slice, resident or streamed once a step for the whole group through
// the ring of bulk copies (16 KB slots here: half the pieces of the cluster
// kernel's 8 KB ones, each piece a product call); each exchange pushes the S
// streams' rows and passes one cluster barrier.  A product runs as warp
// tasks of 8 rows, 4 column quads and a share of K, its lanes' partial sums
// added by shuffles (jg_quads), so that a group's rows run side by side
// instead of in passes one after another; the norms take a half warp a row
// and the attentions a half warp a (stream, row, head) for the same reason.
// The bottom's framed conv, its last up-sampled chunk, the head and the
// pick run per stream within the same stages.  The cluster barriers a step
// do not depend on S: n_up (1 + 6 L) + 1 + n_head, 29 at jukebox3.  The
// residency plan (ops/jukebox_decode.group_plan) gives up resident weights
// for the group's activations, which grow with S (~23 KB a stream at
// jukebox3); S comes from the clusters that fit
// (ops/jukebox_decode.streams_a_group), and groups beyond them wait for a
// cluster.  On an NVIDIA H100 80GB HBM3 (700 W) groups of 2 on clusters of
// 8 (B = 16 .. 30) step in ~153 us against the block kernel's ~190, groups
// of 3 in ~180 and of 4 in ~184; groups of 5 lose, so the route
// (K8_GROUP_ROUTE) stops at 60 streams (chip_smoke.py's route sweep;
// tools/profile_jukebox_group.py splits a step by phase).
//
// Sum order: a product's sums run over K in slices whose number depends on
// K and the slice's width only, each in k order, the slices added by a
// fixed tree, so a stream's tokens do not depend on B, S, the chunking or
// the group it ran in.  They may part from the other K8 kernels' at
// near-ties; the route keeps a stream on one kernel.
//
// Randomness: the port's counter hash of (seed, absolute position, stream,
// class) (noise.cuh), the stream its index in the batch.

#include "transformer_common.cuh"

// Profiling hook, empty here: tools/profile_jukebox_group.py defines it in
// its copy of this source to stamp block 0's clock at each phase of a step
// (0 step start, 1 product end, 2 push end, 3 exchange end, 4 norm end,
// 5 attention end, 6 pick end, 7 a streamed piece arrived).
#ifndef JG_MARK
#define JG_MARK(phase)
#endif

#define JG_THREADS 256
#define JG_WARPS (JG_THREADS / 32)
#define JG_MAXR 8  // rows a product task keeps in registers
#define JG_MAX_TIERS 4
#define JG_MAX_HEAD 8
#define JG_TAB_HEADER 4
#define JG_RED 4096    // floats of a product's partial sums
#define JG_KSPLIT 2    // warps a product's K is split over, for one group of quads

// Mirrors _GpArgs in mimikit_tpu_torch/ops/jukebox_decode.py.
struct JgArgs {
  const float* cw;       // every rank's relaid weights (ops/jukebox_decode.cluster_layout)
  const int* tab;        // (CL, tab_ints) each rank's unit and piece table
  int* window;           // (B, W) lead windows, advanced in place
  int* out;              // (B, n_steps) tokens
  long long* barriers;   // (1,): cluster barriers block 0 passed in its first group's steps
  long long t0;
  int frame[JG_MAX_TIERS + 1];
  int n_frames[JG_MAX_TIERS];
  int t_up[JG_MAX_TIERS];
  int head_in[JG_MAX_HEAD];
  int head_out[JG_MAX_HEAD];
  int n_up;
  int B;
  int S;             // streams a group
  int n_steps;
  int W;
  int d;
  int n_heads;
  int ff;
  int n_layers;
  int Q;
  int n_head;
  int rows;          // the most frames of a tier
  int head_width;    // the widest head layer (padded)
  int ymax;          // the widest slice a block computes
  int tab_ints;
  int wreg_floats;   // the resident region: small parameters, then the resident slices
  int n_slots;
  int slot_floats;
  int smem_bytes;
  int mish_ffn;
  int argmax;
  unsigned int seed;
  const float* temperature;  // (B,) a stream's temperature, read when sampling
  float min_temperature;
  float inv_sqrt_dh;
};

// A block's shared memory; the first six buffers receive the peers' stores,
// so every block lays them out alike (the same sizes, from the arguments).
// The activation buffers hold S streams' rows, stream after stream.
struct JgSmem {
  float* x0;    // (S rows, d) a tier's PE'd input
  float* h;     // (S rows, d) a residual sum before its norm
  float* att;   // (S rows, d) an attention's output
  float* ffh;   // (S rows, ff) the FFN's hidden rows
  float* hb0;   // (S, hw) head rows
  float* hb1;
  float* xn;    // (S rows, d) normed rows (tanh'd before an up-sampler)
  float* qkv;   // (S rows, 3 dHo) the block's q | k | v, or its cross q
  float* ckv;   // (S rows, 2 L dHo) the block's cross k | v of every layer
  float* y1;    // (S rows, ymax) product outputs
  float* y2;
  float* red;   // per-warp partial sums
  float* lin;   // (S, Wr) the linearised windows
  int* ring;    // (S, Wr) the windows as rings
  float* ared;  // the argmax's partials
  int* tab;     // the rank's table
  uint64_t* bars;  // [0] the resident load, [1 + s] ring slot s
  float* wreg;  // small parameters, then the resident slices
  float* slots; // the ring
  int hw;       // a head row's floats
  int wr;       // a window's floats
};

__device__ inline JgSmem jg_carve(float* s, const JgArgs& a, int dHo) {
  JgSmem m;
  const int R = a.rows * a.S, d = a.d;
  m.hw = tf_round4(a.d > a.head_width ? a.d : a.head_width);
  m.wr = tf_round4(a.W);
  m.x0 = s;
  m.h = m.x0 + R * d;
  m.att = m.h + R * d;
  m.xn = m.att + R * d;
  m.ffh = m.xn + R * d;
  m.hb0 = m.ffh + R * a.ff;
  m.hb1 = m.hb0 + a.S * m.hw;
  m.qkv = m.hb1 + a.S * m.hw;
  m.ckv = m.qkv + R * 3 * dHo;
  m.y1 = m.ckv + R * 2 * a.n_layers * dHo;
  m.y2 = m.y1 + R * a.ymax;
  m.red = m.y2 + R * a.ymax;
  m.lin = m.red + JG_RED;
  m.ring = reinterpret_cast<int*>(m.lin + a.S * m.wr);
  m.ared = reinterpret_cast<float*>(m.ring) + a.S * m.wr;
  m.tab = reinterpret_cast<int*>(m.ared + 32);
  m.bars = reinterpret_cast<uint64_t*>(m.tab + tf_round4(a.tab_ints));
  m.wreg = reinterpret_cast<float*>(m.bars) + tf_round4(2 * (a.n_slots + 1));
  m.slots = m.wreg + a.wreg_floats;
  return m;
}

__device__ __forceinline__ float4 jg_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 jg_add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Rank r's share [lo, hi) of n items over CL ranks (_split in the .py).
__device__ __forceinline__ int jg_lo(int n, int cl, int r) { return r * n / cl; }

__device__ __forceinline__ void jg_mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(tf_smem_addr(bar)), "r"(parity) : "memory");
}

// Thread 0: copy n floats from global src to shared dst (16-byte aligned, a
// multiple of 4) through the bulk copy engine, reported to `bar`.
__device__ __forceinline__ void jg_copy(float* dst, const float* src, int n, uint64_t* bar) {
  const unsigned bytes = 4u * (unsigned)n;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(tf_smem_addr(bar)), "r"(bytes) : "memory");
  for (unsigned off = 0; off < bytes; off += TF_BULK_MAX)
    tf_bulk_copy(dst + off / 4, src + off / 4, min((unsigned)TF_BULK_MAX, bytes - off), bar);
}

// The walk over a step's products (units) and the ring of streamed pieces.
// Every thread keeps the counters; thread 0 issues the copies.
struct JgWalk {
  const float* gsrc;   // this rank's region of the relaid weights
  int unit;            // the next unit of the step
  int n_units, n_pieces;
  int issued, consumed;  // pieces, counted over the launch
};

__device__ __forceinline__ void jg_issue(const JgArgs& a, const JgSmem& m, JgWalk& w) {
  if (threadIdx.x == 0) {
    const int p = w.issued % w.n_pieces, s = w.issued % a.n_slots;
    const int* pt = m.tab + JG_TAB_HEADER + 3 * w.n_units + 2 * p;
    jg_copy(m.slots + (long long)s * a.slot_floats, w.gsrc + pt[0], pt[1], m.bars + 1 + s);
  }
  ++w.issued;
}

// A product's rows: row r of M lies at X + (r / rps) lds + (r % rps) ldx (a
// stream's rps rows ldx apart, the streams lds apart).
struct JgRows {
  const float* X;
  int ldx, rps, lds;
};

__device__ __forceinline__ JgRows jg_rows(const float* X, int ldx, int M) {
  JgRows x;
  x.X = X;
  x.ldx = ldx;
  x.rps = M > 0 ? M : 1;
  x.lds = 0;
  return x;
}

// Y[r * ldy + 4 j + e] = sum_k X(r)[k] Wq[k][j][e] for r < M and the qn
// quads of Wq (k-major: row k's qn float4s are contiguous).  The nqg groups
// of four quads split K over KW = JG_KSPLIT / nqg warps (at least one), 8 KW
// slices of K in all: a
// warp takes a task of JG_MAXR rows, four quads and one of its KW parts of
// K; lane (slice s, quad jj) sums the k = 8 kw + s, 8 kw + s + 8 KW, ... of
// its quad for the task's rows in registers, the warp's eight slices are
// added by a reduce-scatter over the lanes (xor 4, 2, 1: each step halves
// the rows a lane keeps), after which lane s holds row s's part, and the KW
// parts are added in order through the partial sums.  The tasks of up to 32
// rows run side by side on the block's warps, so a product's time barely
// grows with its rows; the slices and their sum tree depend on K and qn
// only, so every row is summed alike whatever the group.  Ends with a block
// barrier.
__device__ __forceinline__ float4 jg_shfl4(float4 v, int mask) {
  v.x = __shfl_xor_sync(0xffffffffu, v.x, mask);
  v.y = __shfl_xor_sync(0xffffffffu, v.y, mask);
  v.z = __shfl_xor_sync(0xffffffffu, v.z, mask);
  v.w = __shfl_xor_sync(0xffffffffu, v.w, mask);
  return v;
}

__device__ __noinline__ void jg_quads(const float* Wq, int qn, const JgRows x, int M, int K,
                                      float* Y, int ldy, float* red) {
  const float4* w4 = reinterpret_cast<const float4*>(Wq);
  float4* rp = reinterpret_cast<float4*>(red);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sl = lane & 7, jj = lane >> 3;
  const int nqg = (qn + 3) / 4, KW = max(1, JG_KSPLIT / nqg), G = 8 * KW;
  // rows a round of tasks covers: its partial sums fit in JG_RED floats
  const int chunk = min(4 * JG_MAXR, JG_RED / (4 * KW * qn) / JG_MAXR * JG_MAXR);
  for (int c0 = 0; c0 < M; c0 += chunk) {
    const int mc = min(chunk, M - c0), n_tasks = (mc + JG_MAXR - 1) / JG_MAXR * nqg * KW;
    for (int task = warp; task < n_tasks; task += JG_WARPS) {
      const int kw = task % KW, rest = task / KW, rg = rest / nqg;
      const int j = (rest - rg * nqg) * 4 + jj, jc = min(j, qn - 1);
      const int r0 = rg * JG_MAXR, m = min(JG_MAXR, mc - r0);
      int xo[JG_MAXR];
      if (x.rps >= M) {  // one run of rows
#pragma unroll
        for (int r = 0; r < JG_MAXR; ++r) xo[r] = (c0 + r0 + min(r, m - 1)) * x.ldx;
      } else {
#pragma unroll
        for (int r = 0; r < JG_MAXR; ++r) {
          const int row = c0 + r0 + min(r, m - 1);
          xo[r] = (row / x.rps) * x.lds + (row % x.rps) * x.ldx;
        }
      }
      float4 acc[JG_MAXR];
#pragma unroll
      for (int r = 0; r < JG_MAXR; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int k = 8 * kw + sl; k < K; k += G) {
        // all JG_MAXR rows without a branch (the rows past m repeat row m - 1
        // and are not stored), so the loads issue together
        const float4 wv = w4[k * qn + jc];
        float xv[JG_MAXR];
#pragma unroll
        for (int r = 0; r < JG_MAXR; ++r) xv[r] = x.X[xo[r] + k];
#pragma unroll
        for (int r = 0; r < JG_MAXR; ++r) {
          acc[r].x = fmaf(xv[r], wv.x, acc[r].x);
          acc[r].y = fmaf(xv[r], wv.y, acc[r].y);
          acc[r].z = fmaf(xv[r], wv.z, acc[r].z);
          acc[r].w = fmaf(xv[r], wv.w, acc[r].w);
        }
      }
      // reduce-scatter over the slices: keep the low or high half of the rows
      const bool b2 = sl & 4, b1 = sl & 2, b0 = sl & 1;
      float4 t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 send = b2 ? acc[i] : acc[4 + i], keep = b2 ? acc[4 + i] : acc[i];
        t[i] = jg_add4(keep, jg_shfl4(send, 4));
      }
      float4 u[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 send = b1 ? t[i] : t[2 + i], keep = b1 ? t[2 + i] : t[i];
        u[i] = jg_add4(keep, jg_shfl4(send, 2));
      }
      const float4 send = b0 ? u[0] : u[1], keep = b0 ? u[1] : u[0];
      const float4 v = jg_add4(keep, jg_shfl4(send, 1));
      if (j < qn && sl < m) rp[(kw * chunk + r0 + sl) * qn + j] = v;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < mc * qn; idx += JG_THREADS) {
      float4 v = rp[idx];
      for (int kw = 1; kw < KW; ++kw) v = jg_add4(v, rp[kw * chunk * qn + idx]);
      const int r = idx / qn, j = idx - r * qn;
      *reinterpret_cast<float4*>(Y + (long long)(c0 + r) * ldy + 4 * j) = v;
    }
    __syncthreads();
  }
}

// The step's next unit: Y (M rows, ldy) = the M rows of K of x times the
// block's slice of q quads, from its resident copy or piece by piece from the
// ring.  Returns the offset of the unit's bias slice in the small parameters.
__device__ __forceinline__ int jg_product(const JgArgs& a, const JgSmem& m, JgWalk& w,
                                          const JgRows x, int M, int K, int q, float* Y,
                                          int ldy) {
  const int* ut = m.tab + JG_TAB_HEADER + 3 * w.unit;
  ++w.unit;
  if (ut[2] != q) __trap();  // the host's plan and this walk disagree
  if (ut[0] >= 0) {
    if (q > 0) jg_quads(m.wreg + ut[0], q, x, M, K, Y, ldy, m.red);
    JG_MARK(1);
    return ut[1];
  }
  for (int q0 = 0; q0 < q;) {
    const int s = w.consumed % a.n_slots;
    jg_mbar_wait(m.bars + 1 + s, (unsigned)((w.consumed / a.n_slots) & 1));
    JG_MARK(7);
    const int p = w.consumed % w.n_pieces;
    const int qn = m.tab[JG_TAB_HEADER + 3 * w.n_units + 2 * p + 1] / (4 * K);
    jg_quads(m.slots + (long long)s * a.slot_floats, qn, x, M, K, Y + 4 * q0, ldy, m.red);
    ++w.consumed;  // jg_quads ended on a block barrier: the slot is free
    jg_issue(a, m, w);
    q0 += qn;
  }
  JG_MARK(1);
  return ut[1];
}

// A stage's epilogue: v = y1[r][4j] (+ b1[4j]), + (y2[r / t][(r % t) 4q + 4j]
// + b2[(r % t) 4q + 4j]) where y2 is given, + pe[r % pe_rows][4j] where pe is
// given, then act (1 ReLU, 2 Mish), then res[r][c0 + 4j] + v where res is
// given.
struct JgEpi {
  const float* y1;
  int ld1;
  const float* b1;
  const float* y2;
  int ld2;
  const float* b2;
  int t;
  const float* pe;
  int pe_rows;
  int act;
  const float* res;
  int ldr;
};

// dst[row(r) ld + c0 + 4 j] = the epilogue's v(r, j) for r < M, j < q, in
// every block of the cluster (16-byte distributed-shared-memory stores, a
// thread a (row, quad): the epilogue once, then a store to each peer; a
// thread a (row, quad, peer) computed it CL times and cost ~10 us a step at
// groups of 3), row(r) = (r / nr) n + sub + (r % nr) rph: the
// nr rows of each stream that this block computed, of its n; then the
// cluster barrier (release / acquire), after which every block holds the
// full rows.
template <int CL>
__device__ __noinline__ void jg_push(float* dst, int ld, int M, int nr, int n, int sub, int rph,
                                     int q, int c0, const JgEpi e) {
  cg::cluster_group cl = cg::this_cluster();
  for (int idx = threadIdx.x; idx < M * q; idx += JG_THREADS) {
    const int r = idx / q, j = idx - r * q;
    float4 v = jg_ld4(e.y1 + r * e.ld1 + 4 * j);
    if (e.b1 != nullptr) v = jg_add4(v, jg_ld4(e.b1 + 4 * j));
    if (e.y2 != nullptr) {
      const int ch = (r % e.t) * 4 * q + 4 * j;
      v = jg_add4(v, jg_add4(jg_ld4(e.y2 + (r / e.t) * e.ld2 + ch), jg_ld4(e.b2 + ch)));
    }
    if (e.pe != nullptr) v = jg_add4(v, jg_ld4(e.pe + (r % e.pe_rows) * 4 * q + 4 * j));
    if (e.act == 1) {
      v.x = fmaxf(v.x, 0.0f);
      v.y = fmaxf(v.y, 0.0f);
      v.z = fmaxf(v.z, 0.0f);
      v.w = fmaxf(v.w, 0.0f);
    } else if (e.act == 2) {
      v.x = tf_mish(v.x);
      v.y = tf_mish(v.y);
      v.z = tf_mish(v.z);
      v.w = tf_mish(v.w);
    }
    if (e.res != nullptr) v = jg_add4(jg_ld4(e.res + r * e.ldr + c0 + 4 * j), v);
    const int row = (r / nr) * n + sub + (r % nr) * rph;
    float4* p = reinterpret_cast<float4*>(dst + (long long)row * ld + c0 + 4 * j);
    // every peer, the first one turning with the thread so that the stores
    // spread over the peers
#pragma unroll
    for (int i = 0; i < CL; ++i) *cl.map_shared_rank(p, (i + idx) % CL) = v;
  }
  JG_MARK(2);
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  JG_MARK(3);
}

__device__ __forceinline__ JgEpi jg_epi(const float* y1, int ld1, const float* b1) {
  JgEpi e;
  e.y1 = y1;
  e.ld1 = ld1;
  e.b1 = b1;
  e.y2 = e.b2 = e.pe = e.res = nullptr;
  e.ld2 = e.ldr = e.act = 0;
  e.t = e.pe_rows = 1;
  return e;
}

// dst[r] = LayerNorm(src[r]) for M rows of d (flax's formula, as
// jb_norm_rows), the scale and offset in shared memory; tanh after it when
// asked.  A half warp a row (its sums over the half warp's lanes), so that
// a group's rows take half the rounds.  Ends with a block barrier.
__device__ __noinline__ void jg_norm_rows(const float* src, float* dst, int M, int d,
                                          const float* gb, bool tanh_after) {
  const int half = threadIdx.x >> 4, lane = threadIdx.x & 15;
  for (int r0 = half - (half & 1); r0 < M; r0 += 2 * JG_WARPS) {
    // both halves of a warp run the loop alike; a half past the rows idles
    const int r = r0 + (half & 1);
    const bool live = r < M;
    const float* x = src + (live ? r : 0) * d;
    float s = 0.0f, s2 = 0.0f;
    for (int k = lane; k < d; k += 16) {
      s += x[k];
      s2 = fmaf(x[k], x[k], s2);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mu = s / (float)d;
    const float var = fmaxf(s2 / (float)d - mu * mu, 0.0f);
    const float rs = 1.0f / sqrtf(var + 1e-5f);
    if (live)
      for (int k = lane; k < d; k += 16) {
        const float v = (x[k] - mu) * rs * gb[k] + gb[d + k];
        dst[r * d + k] = tanh_after ? tanhf(v) : v;
      }
  }
  __syncthreads();
  JG_MARK(4);
}

// Causal attention of the block's heads for each of S streams (as
// jb_attend): stream s's query rows i = sub, sub + rph, ... of its n (n <=
// 32) at rows s n + i of Qm (ldq), head j < hpr at column j dH, its keys and
// values at rows s n .. of Km / Vm (ldkv); the output rows s nr + ri into out
// (ld ldo).  A task (stream, row, head) takes a half warp where n <= 16, a
// warp otherwise: lane j scores key j once, the softmax takes the row's max,
// each lane c sums the weighted values of column c.
__device__ __noinline__ void jg_attend(const float* Qm, int ldq, const float* Km,
                                       const float* Vm, int ldkv, float* out, int ldo, int S,
                                       int n, int hpr, int dH, int rph, int sub, float inv) {
  const int sw = n <= 16 ? 16 : 32, per = 32 / sw;  // lanes a task, tasks a warp
  const int seg = (threadIdx.x & 31) / sw, lane = threadIdx.x & (sw - 1);
  const int warp = threadIdx.x >> 5;
  const int nr = (n - sub + rph - 1) / rph, n_tasks = S * nr * hpr;
  for (int t0 = warp * per; t0 < n_tasks; t0 += JG_WARPS * per) {
    // the segments of a warp run the loop alike; one past the tasks idles
    const int task = t0 + seg;
    const bool live = task < n_tasks;
    const int tk = live ? task : 0;
    const int s = tk / (nr * hpr), rest = tk - s * nr * hpr;
    const int ri = rest / hpr, hh = rest - ri * hpr, i = sub + ri * rph, cnt = i + 1;
    const float* q = Qm + (s * n + i) * ldq + hh * dH;
    const float* kb = Km + s * n * ldkv;
    const float* vb = Vm + s * n * ldkv + hh * dH;
    float sc = -INFINITY;
    if (lane < cnt) {  // dH is a multiple of 4: four running sums, then ((0 + 1) + (2 + 3))
      const float* k = kb + lane * ldkv + hh * dH;
      float p4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int c = 0; c < dH; c += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) p4[u] = fmaf(q[c + u] * inv, k[c + u], p4[u]);
      }
      sc = (p4[0] + p4[1]) + (p4[2] + p4[3]);
    }
    float mx = sc;
    for (int o = sw / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float e = lane < cnt ? expf(sc - mx) : 0.0f;
    float sum = e;
    for (int o = sw / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float p = e / sum;
    for (int c0 = 0; c0 < dH; c0 += sw) {
      const int c = c0 + lane;
      float acc = 0.0f;
      // over all n keys, so that the warp's segments shuffle alike (a key
      // past the row's last has weight 0 and adds nothing)
      for (int jj = 0; jj < n; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj, sw);
        if (c < dH) acc = fmaf(pj, vb[jj * ldkv + c], acc);
      }
      if (live && c < dH) out[(s * nr + ri) * ldo + hh * dH + c] = acc;
    }
  }
  __syncthreads();
  JG_MARK(5);
}

// The token from the logits (as jb_pick); every thread of every block of the
// cluster computes it from the same values.
__device__ __noinline__ int jg_pick(const float* logits, int Q, float min_temperature, int argmax,
                                    unsigned seed, float temperature, long long t, int s,
                                    float* ared) {
  const float lt = fmaxf(tf_sigmoid(logits[Q]), min_temperature);
  const uint32_t key = argmax ? 0u : decode_noise_key(seed, t, s);
  float best = -INFINITY;
  int bestq = 0x7fffffff;
  for (int q = threadIdx.x; q < Q; q += JG_THREADS) {
    float v = logits[q] / lt;
    if (!argmax) v = v / temperature + gumbel_from_bits(mix32(key ^ (uint32_t)q));
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
    ired[JG_WARPS + warp] = bestq;
  }
  __syncthreads();
  float bv = ared[0];
  int bq = ired[JG_WARPS];
  for (int k = 1; k < JG_WARPS; ++k) {
    const float ov = ared[k];
    const int oq = ired[JG_WARPS + k];
    if (ov > bv || (ov == bv && oq < bq)) {
      bv = ov;
      bq = oq;
    }
  }
  __syncthreads();
  JG_MARK(6);
  return bq == 0x7fffffff ? 0 : bq;
}

// A layer norm's scale and offset (tier ti, layer l, norm k) in the small
// parameters.
__device__ __forceinline__ const float* jg_ln(const JgArgs& a, const JgSmem& m, int ti, int l,
                                              int k) {
  return m.wreg + (long long)((ti * a.n_layers + l) * 3 + k) * 2 * a.d;
}

template <int CL>
__global__ void __launch_bounds__(JG_THREADS, 1) jg_group_kernel(const JgArgs a) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int d = a.d, ff = a.ff, L = a.n_layers, nH = a.n_heads, dH = d / nH, W = a.W;
  const int hpr = nH / CL > 1 ? nH / CL : 1, rph = CL / nH > 1 ? CL / nH : 1;
  const int h0 = (rank / rph) * hpr, sub = rank % rph, dHo = hpr * dH, hq = dHo / 4;
  const int qd0 = jg_lo(d / 4, CL, rank), qdn = jg_lo(d / 4, CL, rank + 1) - qd0, c0 = 4 * qd0;
  const int qf0 = jg_lo(ff / 4, CL, rank), qfn = jg_lo(ff / 4, CL, rank + 1) - qf0;
  extern __shared__ __align__(16) float smem[];
  const JgSmem m = jg_carve(smem, a, dHo);
  const int wr = m.wr, hw = m.hw;

  const int* gtab = a.tab + (long long)rank * a.tab_ints;
  for (int i = threadIdx.x; i < a.tab_ints; i += JG_THREADS) m.tab[i] = gtab[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s <= a.n_slots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(tf_smem_addr(m.bars + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  JgWalk w;
  w.gsrc = a.cw + m.tab[0];
  w.n_units = m.tab[3];
  w.n_pieces = m.tab[2];
  w.issued = w.consumed = 0;
  // the small parameters and the resident slices, once for the launch
  if (threadIdx.x == 0) jg_copy(m.wreg, w.gsrc, m.tab[1], m.bars);
  if (w.n_pieces > 0)
    for (int s = 0; s < a.n_slots; ++s) jg_issue(a, m, w);
  jg_mbar_wait(m.bars, 0);
  cl.sync();  // every block's buffers and barriers ready before the first remote store

  long long n_sync = 0;  // exchanges passed (block 0 records them after its first group)
  const int n_clusters = gridDim.x / CL, n_groups = (a.B + a.S - 1) / a.S;
  for (int g = blockIdx.x / CL; g < n_groups; g += n_clusters) {
    const int s0 = g * a.S, S = min(a.S, a.B - s0);  // this group's streams
    for (int j = threadIdx.x; j < S * W; j += JG_THREADS) {
      const int s = j / W, c = j - s * W;
      m.ring[s * wr + c] = a.window[(long long)(s0 + s) * W + c];
    }
    int head = 0;
    __syncthreads();
    for (int step = 0; step < a.n_steps; ++step) {
      w.unit = 0;
      for (int j = threadIdx.x; j < S * W; j += JG_THREADS) {
        const int s = j / W, c = j - s * W, p = head + c;
        m.lin[s * wr + c] = ((float)m.ring[s * wr + (p < W ? p : p - W)] / (float)a.Q - 0.5f) *
                            2.0f;
      }
      __syncthreads();
      JG_MARK(0);
      for (int ti = 0; ti < a.n_up; ++ti) {
        const int f = a.frame[ti], n = a.n_frames[ti], M = S * n;
        // framed dense (+ the tier above's up-sampled rows, this block's columns) + PE
        JgEpi e = jg_epi(m.y1, a.ymax, nullptr);
        int n_prev = 0;
        if (ti > 0) {
          n_prev = a.n_frames[ti - 1];
          e.t = a.t_up[ti - 1];
          jg_norm_rows(m.h, m.xn, S * n_prev, d, jg_ln(a, m, ti - 1, L - 1, 2), true);
        }
        JgRows fr;
        fr.X = m.lin + (a.frame[0] - f);
        fr.ldx = f;
        fr.rps = n;
        fr.lds = wr;
        e.b1 = m.wreg + jg_product(a, m, w, fr, M, f, qdn, m.y1, a.ymax);
        e.pe = e.b1 + 4 * qdn;
        e.pe_rows = n;
        if (ti > 0) {
          e.b2 = m.wreg + jg_product(a, m, w, jg_rows(m.xn, d, S * n_prev), S * n_prev, d,
                                     e.t * qdn, m.y2, a.ymax);
          e.y2 = m.y2;
          e.ld2 = a.ymax;
        }
        jg_push<CL>(m.x0, d, M, M, M, 0, 1, qdn, c0, e);
        ++n_sync;
        for (int l = 0; l < L; ++l) {
          const float* xin = l == 0 ? m.x0 : m.xn;
          if (l > 0) jg_norm_rows(m.h, m.xn, M, d, jg_ln(a, m, ti, l - 1, 2), false);
          if (l == 0) {
            // the block's heads' cross k | v of every layer, from the PE'd input
            for (int l2 = 0; l2 < L; ++l2) {
              const float* b = m.wreg + jg_product(a, m, w, jg_rows(m.x0, d, M), M, d, 2 * hq,
                                                   m.y1, a.ymax);
              for (int idx = threadIdx.x; idx < M * 2 * dHo; idx += JG_THREADS) {
                const int r = idx / (2 * dHo), cc = idx - r * 2 * dHo;
                m.ckv[r * 2 * L * dHo + l2 * 2 * dHo + cc] = m.y1[r * a.ymax + cc] + b[cc];
              }
            }
          }
          const int nr = (n - sub + rph - 1) / rph;
          // self-attention of the block's heads
          {
            const float* b = m.wreg + jg_product(a, m, w, jg_rows(xin, d, M), M, d, 3 * hq, m.y1,
                                                 a.ymax);
            for (int idx = threadIdx.x; idx < M * 3 * dHo; idx += JG_THREADS) {
              const int r = idx / (3 * dHo), cc = idx - r * 3 * dHo;
              m.qkv[r * 3 * dHo + cc] = m.y1[r * a.ymax + cc] + b[cc];
            }
            __syncthreads();
            jg_attend(m.qkv, 3 * dHo, m.qkv + dHo, m.qkv + 2 * dHo, 3 * dHo, m.y2, dHo, S, n,
                      hpr, dH, rph, sub, a.inv_sqrt_dh);
            jg_push<CL>(m.att, d, S * nr, nr, n, sub, rph, hq, h0 * dH,
                        jg_epi(m.y2, dHo, nullptr));
            ++n_sync;
          }
          // out product + residual
          {
            JgEpi e2 = jg_epi(m.y1, a.ymax,
                              m.wreg + jg_product(a, m, w, jg_rows(m.att, d, M), M, d, qdn, m.y1,
                                                  a.ymax));
            e2.res = xin;
            e2.ldr = d;
            jg_push<CL>(m.h, d, M, M, M, 0, 1, qdn, c0, e2);
            ++n_sync;
          }
          // norm 1, cross attention of the block's heads on the tier's input
          {
            jg_norm_rows(m.h, m.xn, M, d, jg_ln(a, m, ti, l, 0), false);
            const float* b = m.wreg + jg_product(a, m, w, jg_rows(m.xn, d, M), M, d, hq, m.y1,
                                                 a.ymax);
            for (int idx = threadIdx.x; idx < M * dHo; idx += JG_THREADS) {
              const int r = idx / dHo, cc = idx - r * dHo;
              m.qkv[r * dHo + cc] = m.y1[r * a.ymax + cc] + b[cc];
            }
            __syncthreads();
            const float* kv = m.ckv + l * 2 * dHo;
            jg_attend(m.qkv, dHo, kv, kv + dHo, 2 * L * dHo, m.y2, dHo, S, n, hpr, dH, rph, sub,
                      a.inv_sqrt_dh);
            jg_push<CL>(m.att, d, S * nr, nr, n, sub, rph, hq, h0 * dH,
                        jg_epi(m.y2, dHo, nullptr));
            ++n_sync;
          }
          // cross out product + residual
          {
            JgEpi e2 = jg_epi(m.y1, a.ymax,
                              m.wreg + jg_product(a, m, w, jg_rows(m.att, d, M), M, d, qdn, m.y1,
                                                  a.ymax));
            e2.res = m.xn;
            e2.ldr = d;
            jg_push<CL>(m.h, d, M, M, M, 0, 1, qdn, c0, e2);
            ++n_sync;
          }
          // norm 2, FFN 1 with its activation
          {
            jg_norm_rows(m.h, m.xn, M, d, jg_ln(a, m, ti, l, 1), false);
            JgEpi e2 = jg_epi(m.y1, a.ymax,
                              m.wreg + jg_product(a, m, w, jg_rows(m.xn, d, M), M, d, qfn, m.y1,
                                                  a.ymax));
            e2.act = a.mish_ffn ? 2 : 1;
            jg_push<CL>(m.ffh, ff, M, M, M, 0, 1, qfn, 4 * qf0, e2);
            ++n_sync;
          }
          // FFN 2 + residual
          {
            JgEpi e2 = jg_epi(m.y1, a.ymax,
                              m.wreg + jg_product(a, m, w, jg_rows(m.ffh, ff, M), M, ff, qdn, m.y1,
                                                  a.ymax));
            e2.res = m.xn;
            e2.ldr = d;
            jg_push<CL>(m.h, d, M, M, M, 0, 1, qdn, c0, e2);
            ++n_sync;
          }
        }
      }
      // the bottom's framed conv + the last up-sampled chunk of each stream's last frame
      {
        const int ti = a.n_up - 1, n = a.n_frames[ti], fb = a.frame[a.n_up];
        jg_norm_rows(m.h, m.xn, S * n, d, jg_ln(a, m, ti, L - 1, 2), true);
        JgRows xb;
        xb.X = m.lin + (W - 1 - fb);
        xb.ldx = 0;
        xb.rps = 1;
        xb.lds = wr;
        JgEpi e = jg_epi(m.y1, a.ymax, m.wreg + jg_product(a, m, w, xb, S, fb, qdn, m.y1, a.ymax));
        JgRows xl;
        xl.X = m.xn + (n - 1) * d;
        xl.ldx = 0;
        xl.rps = 1;
        xl.lds = n * d;
        e.b2 = m.wreg + jg_product(a, m, w, xl, S, d, qdn, m.y2, a.ymax);
        e.y2 = m.y2;
        e.ld2 = a.ymax;
        jg_push<CL>(m.hb0, hw, S, S, S, 0, 1, qdn, c0, e);
        ++n_sync;
      }
      const float* in = m.hb0;
      for (int k = 0; k < a.n_head; ++k) {
        float* o = (k & 1) ? m.hb0 : m.hb1;
        const int nq = a.head_out[k] / 4, hq0 = jg_lo(nq, CL, rank);
        const int hqn = jg_lo(nq, CL, rank + 1) - hq0;
        JgEpi e = jg_epi(m.y1, a.ymax,
                         m.wreg + jg_product(a, m, w, jg_rows(in, hw, S), S, a.head_in[k], hqn,
                                             m.y1, a.ymax));
        e.act = k < a.n_head - 1 ? 2 : 0;
        jg_push<CL>(o, hw, S, S, S, 0, 1, hqn, 4 * hq0, e);
        ++n_sync;
        in = o;
      }
      if (w.unit != w.n_units) __trap();
      for (int s = 0; s < S; ++s) {
        const int tok = jg_pick(in + s * hw, a.Q, a.min_temperature, a.argmax, a.seed,
                                a.argmax ? 1.0f : a.temperature[s0 + s], a.t0 + step, s0 + s,
                                m.ared);
        if (threadIdx.x == 0) {
          if (rank == 0) a.out[(long long)(s0 + s) * a.n_steps + step] = tok;
          const int p = head + W - 1;
          m.ring[s * wr + (p < W ? p : p - W)] = tok;
          m.ring[s * wr + head] = 0;
        }
      }
      head = head + 1 < W ? head + 1 : 0;
      __syncthreads();
    }
    if (rank == 0)
      for (int j = threadIdx.x; j < S * W; j += JG_THREADS) {
        const int s = j / W, c = j - s * W, p = head + c;
        a.window[(long long)(s0 + s) * W + c] = m.ring[s * wr + (p < W ? p : p - W)];
      }
    if (blockIdx.x == 0 && threadIdx.x == 0 && a.barriers != nullptr && g == 0)
      *a.barriers = n_sync;
    __syncthreads();
  }
  // the copies still in flight land before the block leaves
  for (; w.consumed < w.issued; ++w.consumed)
    jg_mbar_wait(m.bars + 1 + w.consumed % a.n_slots,
                 (unsigned)((w.consumed / a.n_slots) & 1));
  // no block may leave while a peer may still store into its shared memory
  cl.sync();
}

template <int CL>
static int jg_config(const JgArgs& a, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                     cudaLaunchAttribute* attr, int* clusters) {
  const void* k = (const void*)jg_group_kernel<CL>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CL);
  cfg->blockDim = dim3(JG_THREADS);
  cfg->dynamicSmemBytes = (size_t)a.smem_bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(clusters, jg_group_kernel<CL>, cfg);
  if (e != cudaSuccess) return (int)e;
  return *clusters < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <int CL>
static int jg_launch(const JgArgs& a, cudaStream_t stream, int* clusters, int query) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = jg_config<CL>(a, stream, &cfg, attr, clusters);
  if (err != 0 || query) return err;
  const int groups = (a.B + a.S - 1) / a.S;
  const int n = groups < *clusters ? groups : *clusters;
  cfg.gridDim = dim3(n * CL);
  cudaError_t e = cudaLaunchKernelEx(&cfg, jg_group_kernel<CL>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

int mmk_jg_args_size(void) { return (int)sizeof(JgArgs); }

// Launch on `stream` (PyTorch's current stream) with clusters of `cl`
// blocks, groups of args->S streams; does not synchronise.  *clusters: the
// clusters that fit on the card at this shared memory (groups beyond them
// wait for a cluster).  With `query` set nothing is launched: only *clusters
// is filled.  Returns the cudaError_t (0 on success).
int mmk_jg_decode(const JgArgs* args, int cl, void* stream, int* clusters, int query) {
  switch (cl) {
    case 4: return jg_launch<4>(*args, (cudaStream_t)stream, clusters, query);
    case 8: return jg_launch<8>(*args, (cudaStream_t)stream, clusters, query);
    case 16: return jg_launch<16>(*args, (cudaStream_t)stream, clusters, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mmk_jg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
