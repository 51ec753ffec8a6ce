// JukeBox tier-pyramid decode on a thread-block cluster: one stream's whole
// autoregressive loop in one launch, spread over the CL blocks of a cluster
// (CL = 8 or 16).
//
// Replaces, beside the block-per-stream kernel of jukebox_decode.cu, the TPU
// kernel make_jukebox_pallas_decoder (K8, mimikit_tpu/ops/pallas_decode.py:2386).
// It computes what jb_pyramid_kernel computes (that file's note gives the
// step): the same weights (jukebox_weight_pack, each block's slices laid out
// again on the host by ops/jukebox_decode.cluster_layout), the same (B, W)
// lead window as the only state, advanced in place, the same noise keys
// (noise.cuh) and the same argmax rule, ties to the lowest index.  The route
// (ops/jukebox_decode.decode_pyramid, K8_CLUSTER_ROUTE) sends it up to 7
// streams in clusters of 16 blocks and up to 15 in clusters of 8; the block
// kernel takes wider batches.
//
// Bound.  jukebox3 (d 128, 8 heads, ff 256, 2 layers a tier, W 128, frames
// (32, 16, 4)) needs 6.19 MFLOP a stream-step: 0.378 ms for B=1 x 4,096 at the
// card's 67 TFLOP/s of f32.  The block kernel spends ~185 us a step on one
// SM: 94 block barriers and 33 products, each opening on an L2 round trip for
// its weights (3.6 MB a step).  Here a step is a chain of 29 exchanges, each
// behind a stage of a few small products: latency, not arithmetic or bytes,
// bounds it (tools/profile_jukebox_cluster.py gives the split).
//
// Design.  A stream is decoded by one cluster.  Every block owns a slice of
// every product's output columns: whole heads for q|k|v, the cross q and the
// cross k|v (at CL = 8 with 8 heads a block a head, so both attentions run
// without an exchange; with more blocks than heads, CL / n_heads blocks
// compute a head's q|k|v alike and split its query rows), an even share of
// column quads for the rest.  Its slices of the weights are copied into its
// shared memory once, at the start of the launch, where they stay; what the
// residency plan (ops/jukebox_decode.cluster_plan) cannot keep streams, kind
// by kind (every layer's q|k|v first) so that the streamed pieces spread over
// the step, through a ring of RING_SLOTS bulk copies (cp.async.bulk on an
// mbarrier), each issued RING_SLOTS pieces ahead of its use: the weights are
// constant, so a copy never waits on the step's data.  Every block holds the
// full rows of each activation.  A stage ends with an exchange: each block
// stores its output slice into every peer's copy of the rows with 16-byte
// distributed-shared-memory stores, then the cluster barriers once
// (barrier.cluster arrive.release / wait.acquire); the next stage reads only
// its own shared memory.  Layer norms are folded into the next stage: each
// block normalises the full rows it holds, in the same order in every block,
// so the blocks stay bitwise alike.  The up-sampler of tier i - 1 is folded
// into tier i's framed dense, the last one into the bottom's conv: a block
// computes the columns of its own slice only.  The pick runs in every block
// on the same logits.
//
// Cluster barriers a step: one for each tier's framed dense, six for each
// layer (the self-attention's output, its residual sum, the cross
// attention's output, its residual sum, the FFN's hidden rows, its residual
// sum), one for the bottom and one for each head layer: n_up (1 + 6 L) + 1 +
// n_head, 29 at jukebox3 (94 block barriers a step in the block kernel).
// One exchange costs 1.0 us at CL = 8 and 1.2 us at CL = 16
// (tools/cluster_exchange_probe.py; NVIDIA H100 80GB HBM3, 700 W): the
// exchanges alone set a floor of ~29-35 us a step.
//
// A block has 256 threads: at 512 the kernel needed more than 128 registers a
// thread and spilled, and with ~227 KB of shared memory the spills live in
// the small L1 left and cost L2 round trips.  The product, the epilogue and
// push, the norm, the attention and the pick are each one function, not
// inlined into every stage; a product's rows are loaded without branches so
// that the loads issue together.
//
// Shared memory at jukebox3 (ops/jukebox_decode.cluster_plan): at CL = 16 (a
// head's q|k|v computed by two blocks) a block's slices are ~314 KB a step,
// of which ~122 KB stay resident and ~192 KB stream in 24 pieces; at CL = 8
// ~435 KB, ~131 KB resident and ~304 KB streamed in 38 pieces; the
// activations, the partial sums, the table and the ring take ~75 KB.  A net
// whose plan does not fit takes the block kernel.
//
// Sum order: a product's sums run over K in a fixed order (slices of K, each
// in k order, then the slices in a fixed order), so the tokens do not depend
// on B, the chunking or the cluster that ran a stream.  They may part from
// the block kernel's at near-ties; the route keeps a stream on one kernel.
//
// Randomness: the port's counter hash of (seed, absolute position, stream,
// class) (noise.cuh), as in the block kernel.

#include "transformer_common.cuh"

// Profiling hook, empty here: tools/profile_jukebox_cluster.py defines it in
// its copy of this source to stamp block 0's clock at each phase of a step
// (0 step start, 1 product end, 2 push end, 3 exchange end, 4 norm end,
// 5 attention end, 6 pick end, 7 a streamed piece arrived).
#ifndef JC_MARK
#define JC_MARK(phase)
#endif

#define JC_THREADS 256
#define JC_WARPS (JC_THREADS / 32)
#define JC_MAXR 8  // rows one pass of a product keeps in registers
#define JC_MAX_TIERS 4
#define JC_MAX_HEAD 8
#define JC_TAB_HEADER 4
#define JC_RED 4096    // floats of a product's partial sums
#define JC_PMAX 16     // K slices of a product at most
#define JC_TASKS 256   // threads a product aims at

// Mirrors _ClArgs in mimikit_tpu_torch/ops/jukebox_decode.py.
struct JcArgs {
  const float* cw;       // every rank's relaid weights (ops/jukebox_decode.cluster_layout)
  const int* tab;        // (CL, tab_ints) each rank's unit and piece table
  int* window;           // (B, W) lead windows, advanced in place
  int* out;              // (B, n_steps) tokens
  long long* barriers;   // (1,): cluster barriers block 0 passed in its first stream's steps
  long long t0;
  int frame[JC_MAX_TIERS + 1];
  int n_frames[JC_MAX_TIERS];
  int t_up[JC_MAX_TIERS];
  int head_in[JC_MAX_HEAD];
  int head_out[JC_MAX_HEAD];
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
  float temperature;
  float min_temperature;
  float inv_sqrt_dh;
};

// A block's shared memory; the first six buffers receive the peers' stores,
// so every block lays them out alike (the same sizes, from the arguments).
struct JcSmem {
  float* x0;    // (rows, d) a tier's PE'd input
  float* h;     // (rows, d) a residual sum before its norm
  float* att;   // (rows, d) an attention's output
  float* ffh;   // (rows, ff) the FFN's hidden rows
  float* hb0;   // head rows
  float* hb1;
  float* xn;    // (rows, d) normed rows (tanh'd before an up-sampler)
  float* qkv;   // (rows, 3 dHo) the block's q | k | v, or its cross q
  float* ckv;   // (rows, 2 L dHo) the block's cross k | v of every layer
  float* y1;    // (rows, ymax) product outputs
  float* y2;
  float* red;   // per-warp partial sums
  float* lin;   // (W) the linearised window
  int* ring;    // (W) the window as a ring
  float* ared;  // the argmax's partials
  int* tab;     // the rank's table
  uint64_t* bars;  // [0] the resident load, [1 + s] ring slot s
  float* wreg;  // small parameters, then the resident slices
  float* slots; // the ring
};

__device__ inline JcSmem jc_carve(float* s, const JcArgs& a, int dHo) {
  JcSmem m;
  const int R = a.rows, d = a.d;
  const int hw = tf_round4(a.d > a.head_width ? a.d : a.head_width);
  m.x0 = s;
  m.h = m.x0 + R * d;
  m.att = m.h + R * d;
  m.xn = m.att + R * d;
  m.ffh = m.xn + R * d;
  m.hb0 = m.ffh + R * a.ff;
  m.hb1 = m.hb0 + hw;
  m.qkv = m.hb1 + hw;
  m.ckv = m.qkv + R * 3 * dHo;
  m.y1 = m.ckv + R * 2 * a.n_layers * dHo;
  m.y2 = m.y1 + R * a.ymax;
  m.red = m.y2 + R * a.ymax;
  m.lin = m.red + JC_RED;
  m.ring = reinterpret_cast<int*>(m.lin + tf_round4(a.W));
  m.ared = reinterpret_cast<float*>(m.ring) + tf_round4(a.W);
  m.tab = reinterpret_cast<int*>(m.ared + 32);
  m.bars = reinterpret_cast<uint64_t*>(m.tab + tf_round4(a.tab_ints));
  m.wreg = reinterpret_cast<float*>(m.bars) + tf_round4(2 * (a.n_slots + 1));
  m.slots = m.wreg + a.wreg_floats;
  return m;
}

__device__ __forceinline__ float4 jc_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 jc_add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Rank r's share [lo, hi) of n items over CL ranks (_split in the .py).
__device__ __forceinline__ int jc_lo(int n, int cl, int r) { return r * n / cl; }

__device__ __forceinline__ void jc_mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(tf_smem_addr(bar)), "r"(parity) : "memory");
}

// Thread 0: copy n floats from global src to shared dst (16-byte aligned, a
// multiple of 4) through the bulk copy engine, reported to `bar`.
__device__ __forceinline__ void jc_copy(float* dst, const float* src, int n, uint64_t* bar) {
  const unsigned bytes = 4u * (unsigned)n;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(tf_smem_addr(bar)), "r"(bytes) : "memory");
  for (unsigned off = 0; off < bytes; off += TF_BULK_MAX)
    tf_bulk_copy(dst + off / 4, src + off / 4, min((unsigned)TF_BULK_MAX, bytes - off), bar);
}

// The walk over a step's products (units) and the ring of streamed pieces.
// Every thread keeps the counters; thread 0 issues the copies.
struct JcWalk {
  const float* gsrc;   // this rank's region of the relaid weights
  int unit;            // the next unit of the step
  int n_units, n_pieces;
  int issued, consumed;  // pieces, counted over the launch
};

__device__ __forceinline__ void jc_issue(const JcArgs& a, const JcSmem& m, JcWalk& w) {
  if (threadIdx.x == 0) {
    const int p = w.issued % w.n_pieces, s = w.issued % a.n_slots;
    const int* pt = m.tab + JC_TAB_HEADER + 3 * w.n_units + 2 * p;
    jc_copy(m.slots + (long long)s * a.slot_floats, w.gsrc + pt[0], pt[1], m.bars + 1 + s);
  }
  ++w.issued;
}

// Y[r * ldy + 4 j + e] = sum_k X[r * ldx + k] Wq[k][j][e] for r < M and the
// qn quads of Wq (k-major: row k's qn float4s are contiguous).  Thread t < qn
// P owns quad j = t % qn and the k = s, s + P, ... of slice s = t / qn (so a
// warp reads contiguous float4s of Wq), keeps up to JC_MAXR rows in
// registers, and writes its partial sums; the P slices are then added in a
// fixed order (four running sums over the slices, then pairwise).  P
// balances the slices' length against their number within JC_RED floats of
// partial sums.  Ends with a block barrier.
__device__ __noinline__ void jc_quads(const float* Wq, int qn, const float* X, int ldx, int M,
                                      int K, float* Y, int ldy, float* red) {
  const float4* w4 = reinterpret_cast<const float4*>(Wq);
  float4* rp = reinterpret_cast<float4*>(red);
  for (int r0 = 0; r0 < M; r0 += JC_MAXR) {
    const int m = min(JC_MAXR, M - r0);
    int P = min(JC_PMAX, max(1, K / 2));
    P = min(P, max(1, JC_TASKS / qn));
    P = min(P, max(1, JC_RED / (4 * m * qn)));
    const float* xr = X + (long long)r0 * ldx;
    for (int t = threadIdx.x; t < qn * P; t += JC_THREADS) {
      const int j = t % qn, sl = t / qn;
      float4 acc[JC_MAXR];
#pragma unroll
      for (int r = 0; r < JC_MAXR; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int k = sl; k < K; k += P) {
        // all JC_MAXR rows without a branch (the rows past m repeat row m - 1
        // and are not stored), so the loads issue together
        const float4 wv = w4[k * qn + j];
        float xv[JC_MAXR];
#pragma unroll
        for (int r = 0; r < JC_MAXR; ++r) xv[r] = xr[min(r, m - 1) * ldx + k];
#pragma unroll
        for (int r = 0; r < JC_MAXR; ++r) {
          acc[r].x = fmaf(xv[r], wv.x, acc[r].x);
          acc[r].y = fmaf(xv[r], wv.y, acc[r].y);
          acc[r].z = fmaf(xv[r], wv.z, acc[r].z);
          acc[r].w = fmaf(xv[r], wv.w, acc[r].w);
        }
      }
#pragma unroll
      for (int r = 0; r < JC_MAXR; ++r)
        if (r < m) rp[(sl * m + r) * qn + j] = acc[r];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < m * qn; idx += JC_THREADS) {
      // slices sl = i, i + 4, ... in four running sums, then ((0 + 1) + (2 + 3))
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int sl = 0; sl < P; sl += 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (sl + i < P) v[i] = jc_add4(v[i], rp[(sl + i) * m * qn + idx]);
      }
      const int r = idx / qn, j = idx - r * qn;
      *reinterpret_cast<float4*>(Y + (long long)(r0 + r) * ldy + 4 * j) =
          jc_add4(jc_add4(v[0], v[1]), jc_add4(v[2], v[3]));
    }
    __syncthreads();
  }
}

// The step's next unit: Y (M rows, ldy) = X (M rows of K, ldx) times the
// block's slice of q quads, from its resident copy or piece by piece from the
// ring.  Returns the offset of the unit's bias slice in the small parameters.
__device__ __forceinline__ int jc_product(const JcArgs& a, const JcSmem& m, JcWalk& w,
                                          const float* X, int ldx, int M, int K, int q,
                                          float* Y, int ldy) {
  const int* ut = m.tab + JC_TAB_HEADER + 3 * w.unit;
  ++w.unit;
  if (ut[2] != q) __trap();  // the host's plan and this walk disagree
  if (ut[0] >= 0) {
    if (q > 0) jc_quads(m.wreg + ut[0], q, X, ldx, M, K, Y, ldy, m.red);
    JC_MARK(1);
    return ut[1];
  }
  for (int q0 = 0; q0 < q;) {
    const int s = w.consumed % a.n_slots;
    jc_mbar_wait(m.bars + 1 + s, (unsigned)((w.consumed / a.n_slots) & 1));
    JC_MARK(7);
    const int p = w.consumed % w.n_pieces;
    const int qn = m.tab[JC_TAB_HEADER + 3 * w.n_units + 2 * p + 1] / (4 * K);
    jc_quads(m.slots + (long long)s * a.slot_floats, qn, X, ldx, M, K, Y + 4 * q0, ldy, m.red);
    ++w.consumed;  // jc_quads ended on a block barrier: the slot is free
    jc_issue(a, m, w);
    q0 += qn;
  }
  JC_MARK(1);
  return ut[1];
}

// A stage's epilogue: v = y1[r][4j] (+ b1[4j]), + (y2[r / t][(r % t) 4q + 4j]
// + b2[(r % t) 4q + 4j]) where y2 is given, + pe[r][4j] where pe is given,
// then act (1 ReLU, 2 Mish), then res[r][c0 + 4j] + v where res is given.
struct JcEpi {
  const float* y1;
  int ld1;
  const float* b1;
  const float* y2;
  int ld2;
  const float* b2;
  int t;
  const float* pe;
  int act;
  const float* res;
  int ldr;
};

// dst[(rbeg + r rstep) ld + c0 + 4 j] = the epilogue's v(r, j) for r < M,
// j < q, in every block of the cluster (16-byte distributed-shared-memory
// stores, a thread a (row, quad, peer)); then the cluster barrier (release /
// acquire), after which every block holds the full rows.
template <int CL>
__device__ __noinline__ void jc_push(float* dst, int ld, int M, int rbeg, int rstep, int q,
                                       int c0, const JcEpi e) {
  cg::cluster_group cl = cg::this_cluster();
  for (int idx = threadIdx.x; idx < M * q * CL; idx += JC_THREADS) {
    const int peer = idx % CL, it = idx / CL, r = it / q, j = it - r * q;
    float4 v = jc_ld4(e.y1 + r * e.ld1 + 4 * j);
    if (e.b1 != nullptr) v = jc_add4(v, jc_ld4(e.b1 + 4 * j));
    if (e.y2 != nullptr) {
      const int ch = (r % e.t) * 4 * q + 4 * j;
      v = jc_add4(v, jc_add4(jc_ld4(e.y2 + (r / e.t) * e.ld2 + ch), jc_ld4(e.b2 + ch)));
    }
    if (e.pe != nullptr) v = jc_add4(v, jc_ld4(e.pe + r * 4 * q + 4 * j));
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
    if (e.res != nullptr) v = jc_add4(jc_ld4(e.res + r * e.ldr + c0 + 4 * j), v);
    float4* p = reinterpret_cast<float4*>(dst + (long long)(rbeg + r * rstep) * ld + c0 + 4 * j);
    *cl.map_shared_rank(p, peer) = v;
  }
  JC_MARK(2);
asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  JC_MARK(3);
}

__device__ __forceinline__ JcEpi jc_epi(const float* y1, int ld1, const float* b1) {
  JcEpi e;
  e.y1 = y1;
  e.ld1 = ld1;
  e.b1 = b1;
  e.y2 = e.b2 = e.pe = e.res = nullptr;
  e.ld2 = e.ldr = e.act = 0;
  e.t = 1;
  return e;
}

// dst[r] = LayerNorm(src[r]) for M rows of d (flax's formula, as
// jb_norm_rows), the scale and offset in shared memory; tanh after it when
// asked.  Ends with a block barrier.
__device__ __noinline__ void jc_norm_rows(const float* src, float* dst, int M, int d,
                                          const float* gb, bool tanh_after) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < M; r += JC_WARPS) {
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
    for (int k = lane; k < d; k += 32) {
      const float v = (x[k] - mu) * rs * gb[k] + gb[d + k];
      dst[r * d + k] = tanh_after ? tanhf(v) : v;
    }
  }
  __syncthreads();
  JC_MARK(4);
}

// Causal attention of the block's heads (as jb_attend): query rows i = sub,
// sub + rph, ... of n (n <= 32), head j < hpr at column j dH of Qm (ldq),
// keys and values at column j dH of Km / Vm (ldkv); the output rows into out
// (ld ldo).  A warp a (row, head): lane j scores key j once, the softmax
// takes the row's max, each lane c sums the weighted values of column c.
__device__ __noinline__ void jc_attend(const float* Qm, int ldq, const float* Km,
                                       const float* Vm, int ldkv, float* out, int ldo, int n,
                                       int hpr, int dH, int rph, int sub, float inv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nr = (n - sub + rph - 1) / rph;
  for (int task = warp; task < nr * hpr; task += JC_WARPS) {
    const int ri = task / hpr, hh = task - ri * hpr, i = sub + ri * rph, cnt = i + 1;
    const float* q = Qm + i * ldq + hh * dH;
    const float* vb = Vm + hh * dH;
    float sc = -INFINITY;
    if (lane < cnt) {  // dH is a multiple of 4: four running sums, then ((0 + 1) + (2 + 3))
      const float* k = Km + lane * ldkv + hh * dH;
      float p4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int c = 0; c < dH; c += 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) p4[i] = fmaf(q[c + i] * inv, k[c + i], p4[i]);
      }
      sc = (p4[0] + p4[1]) + (p4[2] + p4[3]);
    }
    const float mx = tf_warp_max(sc);
    const float e = lane < cnt ? expf(sc - mx) : 0.0f;
    const float sum = tf_warp_sum(e);
    const float p = e / sum;
    for (int c0 = 0; c0 < dH; c0 += 32) {
      const int c = c0 + lane;
      float acc = 0.0f;
      for (int jj = 0; jj < cnt; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        if (c < dH) acc = fmaf(pj, vb[jj * ldkv + c], acc);
      }
      if (c < dH) out[ri * ldo + hh * dH + c] = acc;
    }
  }
  __syncthreads();
  JC_MARK(5);
}

// The token from the logits (as jb_pick); every thread of every block of the
// cluster computes it from the same values.
__device__ __noinline__ int jc_pick(const float* logits, int Q, float min_temperature, int argmax,
                                    unsigned seed, float temperature, long long t, int s,
                                    float* ared) {
  const float lt = fmaxf(tf_sigmoid(logits[Q]), min_temperature);
  const uint32_t key = argmax ? 0u : decode_noise_key(seed, t, s);
  float best = -INFINITY;
  int bestq = 0x7fffffff;
  for (int q = threadIdx.x; q < Q; q += JC_THREADS) {
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
    ired[JC_WARPS + warp] = bestq;
  }
  __syncthreads();
  float bv = ared[0];
  int bq = ired[JC_WARPS];
  for (int k = 1; k < JC_WARPS; ++k) {
    const float ov = ared[k];
    const int oq = ired[JC_WARPS + k];
    if (ov > bv || (ov == bv && oq < bq)) {
      bv = ov;
      bq = oq;
    }
  }
  __syncthreads();
  JC_MARK(6);
  return bq == 0x7fffffff ? 0 : bq;
}

// A layer norm's scale and offset (tier ti, layer l, norm k) in the small
// parameters.
__device__ __forceinline__ const float* jc_ln(const JcArgs& a, const JcSmem& m, int ti, int l,
                                              int k) {
  return m.wreg + (long long)((ti * a.n_layers + l) * 3 + k) * 2 * a.d;
}

template <int CL>
__global__ void __launch_bounds__(JC_THREADS, 1) jc_pyramid_kernel(const JcArgs a) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int d = a.d, ff = a.ff, L = a.n_layers, nH = a.n_heads, dH = d / nH, W = a.W;
  const int hpr = nH / CL > 1 ? nH / CL : 1, rph = CL / nH > 1 ? CL / nH : 1;
  const int h0 = (rank / rph) * hpr, sub = rank % rph, dHo = hpr * dH, hq = dHo / 4;
  const int qd0 = jc_lo(d / 4, CL, rank), qdn = jc_lo(d / 4, CL, rank + 1) - qd0, c0 = 4 * qd0;
  const int qf0 = jc_lo(ff / 4, CL, rank), qfn = jc_lo(ff / 4, CL, rank + 1) - qf0;
  extern __shared__ __align__(16) float smem[];
  const JcSmem m = jc_carve(smem, a, dHo);

  const int* gtab = a.tab + (long long)rank * a.tab_ints;
  for (int i = threadIdx.x; i < a.tab_ints; i += JC_THREADS) m.tab[i] = gtab[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s <= a.n_slots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(tf_smem_addr(m.bars + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  JcWalk w;
  w.gsrc = a.cw + m.tab[0];
  w.n_units = m.tab[3];
  w.n_pieces = m.tab[2];
  w.issued = w.consumed = 0;
  // the small parameters and the resident slices, once for the launch
  if (threadIdx.x == 0) jc_copy(m.wreg, w.gsrc, m.tab[1], m.bars);
  if (w.n_pieces > 0)
    for (int s = 0; s < a.n_slots; ++s) jc_issue(a, m, w);
  jc_mbar_wait(m.bars, 0);
  cl.sync();  // every block's buffers and barriers ready before the first remote store

  long long n_sync = 0;  // exchanges passed (block 0 records them after its first stream)
  const int n_clusters = gridDim.x / CL;
  for (int s = blockIdx.x / CL; s < a.B; s += n_clusters) {
    for (int j = threadIdx.x; j < W; j += JC_THREADS) m.ring[j] = a.window[(long long)s * W + j];
    int head = 0;
    __syncthreads();
    for (int step = 0; step < a.n_steps; ++step) {
      w.unit = 0;
      for (int j = threadIdx.x; j < W; j += JC_THREADS) {
        const int p = head + j;
        m.lin[j] = ((float)m.ring[p < W ? p : p - W] / (float)a.Q - 0.5f) * 2.0f;
      }
      __syncthreads();
      JC_MARK(0);
      for (int ti = 0; ti < a.n_up; ++ti) {
        const int f = a.frame[ti], n = a.n_frames[ti];
        // framed dense (+ the tier above's up-sampled rows, this block's columns) + PE
        JcEpi e = jc_epi(m.y1, a.ymax, nullptr);
        int n_prev = 0;
        if (ti > 0) {
          n_prev = a.n_frames[ti - 1];
          e.t = a.t_up[ti - 1];
          jc_norm_rows(m.h, m.xn, n_prev, d, jc_ln(a, m, ti - 1, L - 1, 2), true);
        }
        e.b1 = m.wreg + jc_product(a, m, w, m.lin + (a.frame[0] - f), f, n, f, qdn, m.y1, a.ymax);
        e.pe = e.b1 + 4 * qdn;
        if (ti > 0) {
          e.b2 = m.wreg + jc_product(a, m, w, m.xn, d, n_prev, d, e.t * qdn, m.y2, a.ymax);
          e.y2 = m.y2;
          e.ld2 = a.ymax;
        }
        jc_push<CL>(m.x0, d, n, 0, 1, qdn, c0, e);
        ++n_sync;
        for (int l = 0; l < L; ++l) {
          const float* xin = l == 0 ? m.x0 : m.xn;
          if (l > 0) jc_norm_rows(m.h, m.xn, n, d, jc_ln(a, m, ti, l - 1, 2), false);
          if (l == 0) {
            // the block's heads' cross k | v of every layer, from the PE'd input
            for (int l2 = 0; l2 < L; ++l2) {
              const float* b = m.wreg + jc_product(a, m, w, m.x0, d, n, d, 2 * hq, m.y1, a.ymax);
              for (int idx = threadIdx.x; idx < n * 2 * dHo; idx += JC_THREADS) {
                const int r = idx / (2 * dHo), cc = idx - r * 2 * dHo;
                m.ckv[r * 2 * L * dHo + l2 * 2 * dHo + cc] = m.y1[r * a.ymax + cc] + b[cc];
              }
            }
          }
          const int nr = (n - sub + rph - 1) / rph;
          // self-attention of the block's heads
          {
            const float* b = m.wreg + jc_product(a, m, w, xin, d, n, d, 3 * hq, m.y1, a.ymax);
            for (int idx = threadIdx.x; idx < n * 3 * dHo; idx += JC_THREADS) {
              const int r = idx / (3 * dHo), cc = idx - r * 3 * dHo;
              m.qkv[r * 3 * dHo + cc] = m.y1[r * a.ymax + cc] + b[cc];
            }
            __syncthreads();
            jc_attend(m.qkv, 3 * dHo, m.qkv + dHo, m.qkv + 2 * dHo, 3 * dHo, m.y2, dHo, n, hpr,
                      dH, rph, sub, a.inv_sqrt_dh);
            jc_push<CL>(m.att, d, nr, sub, rph, hq, h0 * dH, jc_epi(m.y2, dHo, nullptr));
            ++n_sync;
          }
          // out product + residual
          {
            JcEpi e2 = jc_epi(m.y1, a.ymax,
                              m.wreg + jc_product(a, m, w, m.att, d, n, d, qdn, m.y1, a.ymax));
            e2.res = xin;
            e2.ldr = d;
            jc_push<CL>(m.h, d, n, 0, 1, qdn, c0, e2);
            ++n_sync;
          }
          // norm 1, cross attention of the block's heads on the tier's input
          {
            jc_norm_rows(m.h, m.xn, n, d, jc_ln(a, m, ti, l, 0), false);
            const float* b = m.wreg + jc_product(a, m, w, m.xn, d, n, d, hq, m.y1, a.ymax);
            for (int idx = threadIdx.x; idx < n * dHo; idx += JC_THREADS) {
              const int r = idx / dHo, cc = idx - r * dHo;
              m.qkv[r * dHo + cc] = m.y1[r * a.ymax + cc] + b[cc];
            }
            __syncthreads();
            const float* kv = m.ckv + l * 2 * dHo;
            jc_attend(m.qkv, dHo, kv, kv + dHo, 2 * L * dHo, m.y2, dHo, n, hpr, dH, rph, sub,
                      a.inv_sqrt_dh);
            jc_push<CL>(m.att, d, nr, sub, rph, hq, h0 * dH, jc_epi(m.y2, dHo, nullptr));
            ++n_sync;
          }
          // cross out product + residual
          {
            JcEpi e2 = jc_epi(m.y1, a.ymax,
                              m.wreg + jc_product(a, m, w, m.att, d, n, d, qdn, m.y1, a.ymax));
            e2.res = m.xn;
            e2.ldr = d;
            jc_push<CL>(m.h, d, n, 0, 1, qdn, c0, e2);
            ++n_sync;
          }
          // norm 2, FFN 1 with its activation
          {
            jc_norm_rows(m.h, m.xn, n, d, jc_ln(a, m, ti, l, 1), false);
            JcEpi e2 = jc_epi(m.y1, a.ymax,
                              m.wreg + jc_product(a, m, w, m.xn, d, n, d, qfn, m.y1, a.ymax));
            e2.act = a.mish_ffn ? 2 : 1;
            jc_push<CL>(m.ffh, ff, n, 0, 1, qfn, 4 * qf0, e2);
            ++n_sync;
          }
          // FFN 2 + residual
          {
            JcEpi e2 = jc_epi(m.y1, a.ymax,
                              m.wreg + jc_product(a, m, w, m.ffh, ff, n, ff, qdn, m.y1, a.ymax));
            e2.res = m.xn;
            e2.ldr = d;
            jc_push<CL>(m.h, d, n, 0, 1, qdn, c0, e2);
            ++n_sync;
          }
        }
      }
      // the bottom's framed conv + the last up-sampled chunk of the last frame
      {
        const int ti = a.n_up - 1, n = a.n_frames[ti], fb = a.frame[a.n_up];
        jc_norm_rows(m.h, m.xn, n, d, jc_ln(a, m, ti, L - 1, 2), true);
        JcEpi e = jc_epi(m.y1, a.ymax,
                         m.wreg + jc_product(a, m, w, m.lin + (W - 1 - fb), fb, 1, fb, qdn, m.y1,
                                             a.ymax));
        e.b2 = m.wreg + jc_product(a, m, w, m.xn + (n - 1) * d, d, 1, d, qdn, m.y2, a.ymax);
        e.y2 = m.y2;
        e.ld2 = a.ymax;
        jc_push<CL>(m.hb0, d, 1, 0, 1, qdn, c0, e);
        ++n_sync;
      }
      const float* in = m.hb0;
      for (int k = 0; k < a.n_head; ++k) {
        float* o = (k & 1) ? m.hb0 : m.hb1;
        const int nq = a.head_out[k] / 4, hq0 = jc_lo(nq, CL, rank);
        const int hqn = jc_lo(nq, CL, rank + 1) - hq0;
        JcEpi e = jc_epi(m.y1, a.ymax,
                         m.wreg + jc_product(a, m, w, in, a.head_in[k], 1, a.head_in[k], hqn, m.y1,
                                             a.ymax));
        e.act = k < a.n_head - 1 ? 2 : 0;
        jc_push<CL>(o, 0, 1, 0, 1, hqn, 4 * hq0, e);
        ++n_sync;
        in = o;
      }
      if (w.unit != w.n_units) __trap();
      const int tok = jc_pick(in, a.Q, a.min_temperature, a.argmax, a.seed, a.temperature,
                              a.t0 + step, s, m.ared);
      if (threadIdx.x == 0) {
        if (rank == 0) a.out[(long long)s * a.n_steps + step] = tok;
        const int p = head + W - 1;
        m.ring[p < W ? p : p - W] = tok;
        m.ring[head] = 0;
      }
      head = head + 1 < W ? head + 1 : 0;
      __syncthreads();
    }
    if (rank == 0)
      for (int j = threadIdx.x; j < W; j += JC_THREADS) {
        const int p = head + j;
        a.window[(long long)s * W + j] = m.ring[p < W ? p : p - W];
      }
    if (blockIdx.x == 0 && threadIdx.x == 0 && a.barriers != nullptr && s == 0)
      *a.barriers = n_sync;
    __syncthreads();
  }
  // the copies still in flight land before the block leaves
  for (; w.consumed < w.issued; ++w.consumed)
    jc_mbar_wait(m.bars + 1 + w.consumed % a.n_slots,
                 (unsigned)((w.consumed / a.n_slots) & 1));
  // no block may leave while a peer may still store into its shared memory
  cl.sync();
}

template <int CL>
static int jc_config(const JcArgs& a, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                     cudaLaunchAttribute* attr, int* clusters) {
  const void* k = (const void*)jc_pyramid_kernel<CL>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CL);
  cfg->blockDim = dim3(JC_THREADS);
  cfg->dynamicSmemBytes = (size_t)a.smem_bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(clusters, jc_pyramid_kernel<CL>, cfg);
  if (e != cudaSuccess) return (int)e;
  return *clusters < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <int CL>
static int jc_launch(const JcArgs& a, cudaStream_t stream, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = jc_config<CL>(a, stream, &cfg, attr, clusters);
  if (err != 0) return err;
  const int n = a.B < *clusters ? a.B : *clusters;
  cfg.gridDim = dim3(n * CL);
  cudaError_t e = cudaLaunchKernelEx(&cfg, jc_pyramid_kernel<CL>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

int mmk_jc_args_size(void) { return (int)sizeof(JcArgs); }

// Launch on `stream` (PyTorch's current stream) with clusters of `cl`
// blocks; does not synchronise.  *clusters: the clusters that fit on the
// card at this shared memory (streams beyond them wait for a cluster).
// Returns the cudaError_t of the launch (0 on success).
int mmk_jc_decode(const JcArgs* args, int cl, void* stream, int* clusters) {
  switch (cl) {
    case 8: return jc_launch<8>(*args, (cudaStream_t)stream, clusters);
    case 16: return jc_launch<16>(*args, (cudaStream_t)stream, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mmk_jc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
