// WaveNet autoregressive decode on thread-block clusters, a group of S
// streams a cluster: S streams' whole step loops in one launch, every layer
// spread over the CL blocks of a cluster (CL = 16), every product and
// every exchange of a step shared by the group.
//
// Replaces, beside the block-per-streams kernel of wavenet_decode.cu, the TPU
// kernels make_wavenet_pallas_decoder (K4, mimikit_tpu/ops/pallas_decode.py:402)
// and make_wavenet_pallas_chunked (K5, pallas_decode.py:559).  It computes
// what wavenet_decode.cu computes (its note gives the step): the same weights
// (wavenet_weight_pack, each block's column slices laid out again on the host
// by ops/wavenet_decode.cluster_layout), the same token carry and (sum(d), B,
// D) rings in device memory, advanced in place, so a stream can move between
// chunks, the same noise keys (noise.cuh), the learned temperature, argmax
// with ties to the lowest class, and the prompt's tokens while t < prior_t.
// The route (ops/wavenet_decode.route, WN_CLUSTER_ROUTE) picks it by B.
//
// Bound.  WaveNet-10 (D = skips = 128, 10 layers, a 128-wide Mish head, Q =
// 256) needs 2.03 MFLOP a stream-step: 7.8 us a step at B = 256 on the card's
// 67 TFLOP/s of f32.  The block kernel owns 1 or 2 streams a block and runs
// each product over 1,024 threads, one weight load per FMA: ~76 us a step at
// B = 8 and ~95 at B = 256, of which its weight loads from L2 take only ~6-8
// us (tools/profile_wavenet_decode.py): the FMAs with their operand loads and
// ~80 block barriers set the pace.
//
// Design.  Each block owns matched columns of every layer: D / 2 / CL quads
// of gate units (a quad holds the tanh and sigmoid columns of two units, so
// the gate stays in the block), S / 4 / CL quads of the skip columns and D /
// 4 / CL of the residual ones, and its share of each head layer's quads (the
// last layer's: its share of the Q logits, and the temperature column, which
// every block computes).  A product runs as warp tasks of R rows and one
// quad; lane l sums k = 4 l .. 4 l + 3 of each 128 for R rows in registers
// from shared memory, 16-byte loads of its rows and four weight rows for
// 16 R FMAs, and the 32 lanes meet by shuffles; the lane that ends with a
// row's quad computes its epilogue and stores it into every block of the
// cluster (distributed shared memory), then one cluster barrier (release /
// acquire) makes the rows whole everywhere.  The exchanges a step: y after
// each layer's gate, x after each residual (none after the last layer), the
// skips before the head, each hidden head layer, and the pick's (max, class)
// of each block: 22 for WaveNet-10.  The skips accumulate in their owner.
// The weights a block needs (WaveNet-10: 254 KB at CL = 16) do
// not all fit beside the group's rows, so the plan (ops/wavenet_decode.
// cluster_plan) keeps as many slices resident as fit and streams the rest in
// 16 KB pieces through a ring of bulk copies; the weights are constant, so a
// piece is fetched up to n_slots pieces ahead, across steps.  Each block
// reads the full x(s - d) rows of its group from the rings by cp.async, two
// layers ahead, and writes back only the x(s) columns it owns, after the
// layer's first cluster barrier (by then every block has read the slot), in
// the residual's epilogue, which reads them anyway.
//
// Sum order: a product's sums run over K in 32 lanes' slices, each in k order,
// added by the shuffles' fixed tree, whatever R, S, CL or B: a stream's
// tokens do not depend on its batch, its group or the chunking.  They may
// part from the block kernel's at near-ties; the route keeps a stream on one
// kernel.
//
// Randomness: the port's counter hash of (seed, absolute t, stream, class)
// (noise.cuh), the stream its index in the batch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "noise.cuh"

namespace cg = cooperative_groups;

// Profiling hook, empty here: a profiler may define it in its copy of this
// source to stamp block 0's clock at each phase of a step (0 step start, 1
// product end, 2 push end, 3 exchange end, 4 ring write, 5 pick end, 6 a
// streamed piece arrived, 7 ring rows arrived).
#ifndef WC_MARK
#define WC_MARK(phase)
#endif

#define WC_THREADS 256
#define WC_WARPS (WC_THREADS / 32)
#define WC_MAX_LAYERS 64
#define WC_MAX_HEAD 8
#define WC_TAB_HEADER 4
#define WC_BULK_MAX 32768  // bytes a single bulk copy at most
// a product's warp tasks a round, at most: the rows a task follow from it (a
// task a warp beat two at 32 and 64 streams on an NVIDIA H100)
#define WC_TASKS 8

// Mirrors _ClArgs in mimikit_tpu_torch/ops/wavenet_decode.py: pointers, then
// 64-bit integers, then 32-bit fields.
struct WcArgs {
  const float* cw;       // every rank's relaid weights (ops/wavenet_decode.cluster_layout)
  const int* tab;        // (CL, tab_ints) each rank's unit and piece table
  const float* emb;      // (Q, D) the embedding (the pack's)
  const int* prompt;     // (B, prior_t)
  int* tok;              // (B,) token at position t0 - 1; in/out
  float* rings;          // (sum(d), B, D); in/out
  int* out;              // (B, out_len)
  long long* barriers;   // (1,): cluster barriers block 0 passed in its first group's steps
  long long t0;          // absolute step of the first iteration
  long long out_t0;      // absolute step written to out[:, 0]
  long long ring_row[WC_MAX_LAYERS];  // first ring row of layer l
  int n_steps;
  int out_len;
  int B;
  int D;
  int Sk;                // skips
  int Q;
  int prior_t;
  int n_layers;
  int n_head;
  int S;                 // streams a group
  int ow;                // floats of a row of the ring-row and head buffers
  int skw;               // floats of a row of the skip accumulators
  int lgw;               // floats of a row of the block's logits
  int tab_ints;
  int wreg_floats;       // the resident region: the biases, then the resident slices
  int n_slots;
  int slot_floats;
  int smem_bytes;
  int argmax;
  unsigned int seed;
  const float* temperature;  // (B,) a stream's temperature, read when sampling
  float min_temperature;
  int dil[WC_MAX_LAYERS];
  int has_res[WC_MAX_LAYERS];
  int head_in[WC_MAX_HEAD];
  int head_out[WC_MAX_HEAD];
};

__device__ __forceinline__ int wc_r4(int n) { return (n + 3) & ~3; }

// Rank r's first item of n items over cl ranks (_split in the .py).
__device__ __forceinline__ int wc_lo(int n, int cl, int r) { return r * n / cl; }

__device__ __forceinline__ float wc_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float wc_mish(float x) {
  const float sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

__device__ __forceinline__ float4 wc_add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 wc_shfl4(float4 v, int mask) {
  v.x = __shfl_xor_sync(0xffffffffu, v.x, mask);
  v.y = __shfl_xor_sync(0xffffffffu, v.y, mask);
  v.z = __shfl_xor_sync(0xffffffffu, v.z, mask);
  v.w = __shfl_xor_sync(0xffffffffu, v.w, mask);
  return v;
}

__device__ __forceinline__ unsigned wc_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void wc_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wc_mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(wc_smem_addr(bar)), "r"(parity) : "memory");
}

// Thread 0: copy n floats from global src to shared dst (16-byte aligned, a
// multiple of 4) through the bulk copy engine, reported to `bar`.
__device__ __forceinline__ void wc_copy(float* dst, const float* src, int n, uint64_t* bar) {
  const unsigned bytes = 4u * (unsigned)n;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(wc_smem_addr(bar)), "r"(bytes) : "memory");
  for (unsigned off = 0; off < bytes; off += WC_BULK_MAX)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(wc_smem_addr(dst + off / 4)), "l"(src + off / 4),
        "r"(min((unsigned)WC_BULK_MAX, bytes - off)), "r"(wc_smem_addr(bar))
        : "memory");
}

// 16 bytes from global memory (L2, not L1: the rings change) to shared memory.
__device__ __forceinline__ void wc_cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(wc_smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void wc_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wc_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A block's shared memory; the buffers up to `pick` receive the peers'
// stores, so every block lays them out alike (the same sizes, from the
// arguments).  Rows are the group's streams.
struct WcSmem {
  float* xcur;   // (S, D) the layer's input x(s)
  float* y;      // (S, D) the gate's output
  float* ob0;    // (S, ow) ring rows x(s - d) of the even layers; the head's ping
  float* ob1;    // (S, ow) of the odd layers; the head's pong
  float* pick;   // (CL, S, 2) each block's best (score, class) of each stream
  float* skacc;  // (S, skw) the block's skip columns, accumulated
  float* lg;     // (S, lgw) the block's logits, then its temperature quad
  int* tok;      // (S,) the token carry
  int* tab;      // the rank's table
  uint64_t* bars;  // [0] the resident load, [1 + s] ring slot s
  float* wreg;   // the biases, then the resident slices
  float* slots;  // the ring
};

__device__ inline WcSmem wc_carve(float* s, const WcArgs& a, int cl) {
  WcSmem m;
  const int S = a.S;
  m.xcur = s;
  m.y = m.xcur + S * a.D;
  m.ob0 = m.y + S * a.D;
  m.ob1 = m.ob0 + S * a.ow;
  m.pick = m.ob1 + S * a.ow;
  m.skacc = m.pick + wc_r4(2 * cl * S);
  m.lg = m.skacc + S * a.skw;
  m.tok = reinterpret_cast<int*>(m.lg + S * a.lgw);
  m.tab = m.tok + wc_r4(S);
  m.bars = reinterpret_cast<uint64_t*>(m.tab + wc_r4(a.tab_ints));
  m.wreg = reinterpret_cast<float*>(m.bars) + wc_r4(2 * (a.n_slots + 1));
  m.slots = m.wreg + a.wreg_floats;
  return m;
}

// The walk over a step's products (units) and the ring of streamed pieces.
// Every thread keeps the counters; thread 0 issues the copies.
struct WcWalk {
  const float* gsrc;     // this rank's region of the relaid weights
  int unit;              // the next unit of the step
  int n_units, n_pieces;
  int issued, consumed;  // pieces, counted over the launch
};

__device__ __forceinline__ void wc_issue(const WcArgs& a, const WcSmem& m, WcWalk& w) {
  if (threadIdx.x == 0) {
    const int p = w.issued % w.n_pieces, s = w.issued % a.n_slots;
    const int* pt = m.tab + WC_TAB_HEADER + 3 * w.n_units + 2 * p;
    wc_copy(m.slots + (long long)s * a.slot_floats, w.gsrc + pt[0], pt[1], m.bars + 1 + s);
  }
  ++w.issued;
}

// What a product's lanes do with a row's quad of sums v (bias added).
enum { WC_GATE = 0, WC_SKIPRES = 1, WC_HIDDEN = 2, WC_LOGITS = 3 };

struct WcEpi {
  int kind;
  const float* bias;  // the unit's bias slice, 4 floats a quad of the block
  int q0;             // the piece's first quad among the unit's
  int g0;             // the block's first quad of the output (gate, skip or head quads)
  int nsq;            // WC_SKIPRES: the skip quads, before the residual ones
  int rq0;            // WC_SKIPRES: the block's first residual quad
  int first;          // WC_SKIPRES: the first layer (the skips start here)
  float* dst;         // WC_GATE: y; WC_SKIPRES: xcur; WC_HIDDEN: the next head rows
  int ldd;
  float* loc;         // WC_SKIPRES: skacc; WC_LOGITS: lg
  int ldl;
  float* ring;        // WC_SKIPRES: the layer's ring slot of the group's first stream
};

// The epilogue of one row's quad v (bias not yet added), run by the G lanes
// of a warp that hold it (g = 0 .. G - 1; every lane of the warp calls it,
// `live` for those with a row): each computes the quad's output and stores it
// into the peers g, g + G, ... of the cluster, so that a row's stores spread
// over its lanes; the block's own buffers (the skips, the logits) are
// written by g = 0.
template <int CL>
__device__ __forceinline__ void wc_epilogue(const WcEpi& e, int row, int j, float4 v, bool live,
                                            int g, int G, cg::cluster_group& cl) {
  const int ju = e.q0 + j;  // the quad among the unit's
  v = wc_add4(v, *reinterpret_cast<const float4*>(e.bias + 4 * ju));
  if (e.kind == WC_GATE) {
    const float2 y = make_float2(tanhf(v.x) * wc_sigmoid(v.y), tanhf(v.z) * wc_sigmoid(v.w));
    float2* p = reinterpret_cast<float2*>(e.dst + row * e.ldd + 2 * (e.g0 + ju));
    if (live)
      for (int i = g; i < CL; i += G) *cl.map_shared_rank(p, i) = y;
  } else if (e.kind == WC_SKIPRES) {
    if (ju < e.nsq) {
      float4* p = reinterpret_cast<float4*>(e.loc + row * e.ldl + 4 * ju);
      if (live && g == 0) *p = e.first ? v : wc_add4(*p, v);
    } else {
      const int c = 4 * (e.rq0 + ju - e.nsq);
      float4* p = reinterpret_cast<float4*>(e.dst + row * e.ldd + c);
      const float4 x0 = *p;  // x(s), the layer's input: the ring's slot
      __syncwarp();  // every lane has read the old x before one stores the new
      if (live) {
        const float4 x = wc_add4(x0, v);
        for (int i = g; i < CL; i += G) *cl.map_shared_rank(p, i) = x;
        if (g == 0) *reinterpret_cast<float4*>(e.ring + row * e.ldd + c) = x0;
      }
    }
  } else if (e.kind == WC_HIDDEN) {
    const float4 h = make_float4(wc_mish(v.x), wc_mish(v.y), wc_mish(v.z), wc_mish(v.w));
    float4* p = reinterpret_cast<float4*>(e.dst + row * e.ldd + 4 * (e.g0 + ju));
    if (live)
      for (int i = g; i < CL; i += G) *cl.map_shared_rank(p, i) = h;
  } else if (live && g == 0) {
    *reinterpret_cast<float4*>(e.loc + row * e.ldl + 4 * ju) = v;
  }
}

// The M rows of X times the qn quads of the slice W, K deep: k < ka from xa
// (row stride lda), the rest from xb (row stride ldb); ka, K, lda and ldb
// multiples of 4.  Each segment runs in blocks of 128 k (the last one
// shorter); in a block of nb, lane l takes k = 4 l .. 4 l + 3, one 16-byte
// load of each of R rows and four of the quad's weights for 16 R FMAs; the
// slice stores a block's k rows of the quad (float4s) as e nb / 4 + l for k
// = 4 l + e (ops/wavenet_decode._k_order), so that the lanes' loads of each
// e read consecutive 16-byte words.  Warp tasks of R rows and one quad (the
// rows past M repeat row M - 1 and are not kept).  The 32 lanes' sums meet
// by a reduce-scatter over the rows (lane masks 16, 8, 4) while there are
// rows to halve, then by an all-reduce: the same sum tree for every R.
template <int CL, int R>
__device__ __forceinline__ void wc_quads(const float* W, int qn, const float* xa, int lda,
                                         int ka, const float* xb, int ldb, int K, int M,
                                         const WcEpi& e, cg::cluster_group& cl) {
  const float4* w4 = reinterpret_cast<const float4*>(W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tasks = (M + R - 1) / R * qn;
  for (int task = warp; task < n_tasks; task += WC_WARPS) {
    const int rg = task / qn, j = task - rg * qn;
    const int r0 = rg * R;
    const float4* wq = w4 + (long long)j * K;
    float4 acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int seg = 0; seg < 2; ++seg) {
      const float* X = seg ? xb : xa;
      const int ld = seg ? ldb : lda, k_lo = seg ? ka : 0, k_hi = seg ? K : ka;
      int o[R];
#pragma unroll
      for (int i = 0; i < R; ++i) o[i] = min(r0 + i, M - 1) * ld - k_lo;
      for (int k0 = k_lo; k0 < k_hi; k0 += 128) {
        const int q4 = min(128, k_hi - k0) >> 2;
        if (lane < q4) {
          const float4* wb = wq + k0 + lane;
          const float4 w0 = wb[0], w1 = wb[q4], w2 = wb[2 * q4], w3 = wb[3 * q4];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float4 xv = *reinterpret_cast<const float4*>(X + o[i] + k0 + 4 * lane);
            acc[i].x = fmaf(xv.x, w0.x, acc[i].x);
            acc[i].y = fmaf(xv.x, w0.y, acc[i].y);
            acc[i].z = fmaf(xv.x, w0.z, acc[i].z);
            acc[i].w = fmaf(xv.x, w0.w, acc[i].w);
            acc[i].x = fmaf(xv.y, w1.x, acc[i].x);
            acc[i].y = fmaf(xv.y, w1.y, acc[i].y);
            acc[i].z = fmaf(xv.y, w1.z, acc[i].z);
            acc[i].w = fmaf(xv.y, w1.w, acc[i].w);
            acc[i].x = fmaf(xv.z, w2.x, acc[i].x);
            acc[i].y = fmaf(xv.z, w2.y, acc[i].y);
            acc[i].z = fmaf(xv.z, w2.z, acc[i].z);
            acc[i].w = fmaf(xv.z, w2.w, acc[i].w);
            acc[i].x = fmaf(xv.w, w3.x, acc[i].x);
            acc[i].y = fmaf(xv.w, w3.y, acc[i].y);
            acc[i].z = fmaf(xv.w, w3.z, acc[i].z);
            acc[i].w = fmaf(xv.w, w3.w, acc[i].w);
          }
        }
      }
    }
    int rb = 0;
#pragma unroll
    for (int round = 0; round < 5; ++round) {
      const int mask = 16 >> round, n = R >> round;
      const bool hi = lane & mask;
      if (n >= 2) {
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          if (i < n / 2) {
            const float4 send = hi ? acc[i] : acc[n / 2 + i];
            const float4 keep = hi ? acc[n / 2 + i] : acc[i];
            acc[i] = wc_add4(keep, wc_shfl4(send, mask));
          }
        }
        rb += hi ? n / 2 : 0;
      } else {
        acc[0] = wc_add4(acc[0], wc_shfl4(acc[0], mask));
      }
    }
    // the 32 / R lanes that hold row r0 + rb share its epilogue
    const int row = r0 + rb;
    wc_epilogue<CL>(e, min(row, M - 1), j, acc[0], row < M, lane & (32 / R - 1), 32 / R, cl);
  }
}

// Rows a task: the fewest (a power of 2, at most 8) that keep a product's
// tasks within WC_TASKS.
__device__ __forceinline__ int wc_rows_a_task(int M, int qn) {
  int R = 1;
  while (R < 8 && (M + R - 1) / R * qn > WC_TASKS) R <<= 1;
  return R;
}

template <int CL>
__device__ __forceinline__ void wc_product(const float* W, int qn, const float* xa, int lda,
                                           int ka, const float* xb, int ldb, int K, int M,
                                           const WcEpi& e, cg::cluster_group& cl) {
  switch (wc_rows_a_task(M, qn)) {
    case 1: wc_quads<CL, 1>(W, qn, xa, lda, ka, xb, ldb, K, M, e, cl); break;
    case 2: wc_quads<CL, 2>(W, qn, xa, lda, ka, xb, ldb, K, M, e, cl); break;
    case 4: wc_quads<CL, 4>(W, qn, xa, lda, ka, xb, ldb, K, M, e, cl); break;
    default: wc_quads<CL, 8>(W, qn, xa, lda, ka, xb, ldb, K, M, e, cl); break;
  }
}

// The step's next unit: its slice from the resident copy, or piece by piece
// from the ring (a piece holds whole quads).
template <int CL>
__device__ __forceinline__ void wc_unit(const WcArgs& a, const WcSmem& m, WcWalk& w,
                                        const float* xa, int lda, int ka, const float* xb,
                                        int ldb, int K, int M, WcEpi e, cg::cluster_group& cl) {
  const int* ut = m.tab + WC_TAB_HEADER + 3 * w.unit;
  ++w.unit;
  const int qn = ut[2];
  e.bias = m.wreg + ut[1];
  const bool resident = ut[0] >= 0;
  for (int q0 = 0; q0 < qn;) {
    const float* W = m.wreg + ut[0];
    int pq = qn;
    if (!resident) {
      const int s = w.consumed % a.n_slots;
      wc_mbar_wait(m.bars + 1 + s, (unsigned)((w.consumed / a.n_slots) & 1));
      WC_MARK(6);
      W = m.slots + (long long)s * a.slot_floats;
      pq = m.tab[WC_TAB_HEADER + 3 * w.n_units + 2 * (w.consumed % w.n_pieces) + 1] / (4 * K);
    }
    e.q0 = q0;
    wc_product<CL>(W, pq, xa, lda, ka, xb, ldb, K, M, e, cl);
    if (!resident) {
      ++w.consumed;
      __syncthreads();  // every thread is done with the slot before it is refilled
      wc_issue(a, m, w);
    }
    q0 += pq;
  }
  WC_MARK(1);
}

// Issue the cp.async copies of layer l's ring rows x(s - d) of the group's M
// streams into `buf` (row stride ow), as one commit group.
__device__ __forceinline__ void wc_fetch_rows(const WcArgs& a, float* buf, int l, long long s,
                                             int b0, int M) {
  const long long row = a.ring_row[l] + s % a.dil[l];
  const int d4 = a.D >> 2;
  for (int idx = threadIdx.x; idx < M * d4; idx += WC_THREADS) {
    const int r = idx / d4, c = idx - r * d4;
    wc_cp16(buf + r * a.ow + 4 * c, a.rings + ((row * a.B + b0 + r) * a.D + 4 * c));
  }
  wc_cp_commit();
}

template <int CL>
__global__ void __launch_bounds__(WC_THREADS, 1) wc_cluster_kernel(const WcArgs a) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int D = a.D, L = a.n_layers;
  // the block's quads: gate (two units each), skip, residual, logits
  const int cq0 = wc_lo(D / 2, CL, rank);
  const int sq0 = wc_lo(a.Sk / 4, CL, rank), nsq = wc_lo(a.Sk / 4, CL, rank + 1) - sq0;
  const int rq0 = wc_lo(D / 4, CL, rank), nrq = wc_lo(D / 4, CL, rank + 1) - rq0;
  const int qq0 = wc_lo(a.Q / 4, CL, rank), nqq = wc_lo(a.Q / 4, CL, rank + 1) - qq0;
  extern __shared__ __align__(16) float smem[];
  const WcSmem m = wc_carve(smem, a, CL);

  const int* gtab = a.tab + (long long)rank * a.tab_ints;
  for (int i = threadIdx.x; i < a.tab_ints; i += WC_THREADS) m.tab[i] = gtab[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s <= a.n_slots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(wc_smem_addr(m.bars + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  WcWalk w;
  w.gsrc = a.cw + m.tab[0];
  w.n_units = m.tab[3];
  w.n_pieces = m.tab[2];
  w.issued = w.consumed = 0;
  // the biases and the resident slices, once for the launch
  if (threadIdx.x == 0) wc_copy(m.wreg, w.gsrc, m.tab[1], m.bars);
  if (w.n_pieces > 0)
    for (int s = 0; s < a.n_slots; ++s) wc_issue(a, m, w);
  wc_mbar_wait(m.bars, 0);
  cl.sync();  // every block's buffers and barriers ready before the first remote store

  long long n_sync = 0;
  const int n_clusters = gridDim.x / CL, n_groups = (a.B + a.S - 1) / a.S;
  for (int g = blockIdx.x / CL; g < n_groups; g += n_clusters) {
    const int b0 = g * a.S, M = min(a.S, a.B - b0);  // this group's streams
    for (int r = threadIdx.x; r < M; r += WC_THREADS) m.tok[r] = a.tok[b0 + r];
    __syncthreads();
    for (int step = 0; step < a.n_steps; ++step) {
      const long long t = a.t0 + step, s = t - 1;
      w.unit = 0;
      WC_MARK(0);
      // the sample at s, embedded, is layer 0's input; the first two layers'
      // ring rows are fetched now (every block has passed the last step's
      // pick, so none still reads or fills these buffers)
      wc_fetch_rows(a, m.ob0, 0, s, b0, M);
      if (L > 1) wc_fetch_rows(a, m.ob1, 1, s, b0, M);
      for (int idx = threadIdx.x; idx < M * D; idx += WC_THREADS) {
        const int r = idx / D, j = idx - r * D;
        const int tk = s < a.prior_t ? a.prompt[(long long)(b0 + r) * a.prior_t + s] : m.tok[r];
        m.xcur[r * D + j] = __ldg(a.emb + (long long)tk * D + j);
      }
      if (L > 1) wc_cp_wait<1>(); else wc_cp_wait<0>();
      __syncthreads();
      for (int l = 0; l < L; ++l) {
        float* ob = (l & 1) ? m.ob1 : m.ob0;
        WC_MARK(7);
        // the gated conv: [x(s - d) | x(s)] . [K0; K1] + b, then the gate, into y everywhere
        WcEpi e;
        e.kind = WC_GATE;
        e.g0 = cq0;
        e.dst = m.y;
        e.ldd = D;
        wc_unit<CL>(a, m, w, ob, a.ow, D, m.xcur, D, 2 * D, M, e, cl);
        WC_MARK(2);
        wc_cluster_sync();
        ++n_sync;
        WC_MARK(3);
        // every block has read layer l's slot: the x(s) columns this block owns
        // go to the ring, by the residual's epilogue where the layer has one
        const bool res = a.has_res[l], res_cols = res && l + 1 < L;
        float* ring = a.rings + ((a.ring_row[l] + s % a.dil[l]) * a.B + b0) * D;
        if (!res_cols) {
          for (int idx = threadIdx.x; idx < M * nrq; idx += WC_THREADS) {
            const int r = idx / nrq, c = 4 * (rq0 + idx - r * nrq);
            *reinterpret_cast<float4*>(ring + r * D + c) =
                *reinterpret_cast<const float4*>(m.xcur + r * D + c);
          }
          __syncthreads();
          WC_MARK(4);
        }
        if (l + 2 < L) wc_fetch_rows(a, ob, l + 2, s, b0, M);
        // skips += y . Wsk + bsk; x += y . Wr + br, into x everywhere (the
        // plan gives the last layer no residual columns: its x is not used)
        e.kind = WC_SKIPRES;
        e.nsq = nsq;
        e.rq0 = rq0;
        e.first = l == 0;
        e.dst = m.xcur;
        e.ldd = D;
        e.loc = m.skacc;
        e.ldl = a.skw;
        e.ring = ring;
        wc_unit<CL>(a, m, w, m.y, D, D, m.y, D, D, M, e, cl);
        WC_MARK(2);
        if (l + 1 < L) {
          // layer l + 1's ring rows, fetched a layer back, land before the
          // barrier, which makes them visible to the block
          if (l + 2 < L) wc_cp_wait<1>(); else wc_cp_wait<0>();
          if (res) {
            wc_cluster_sync();
            ++n_sync;
            WC_MARK(3);
          } else {  // a layer without a residual: x = y, whole in every block
            __syncthreads();
            for (int idx = threadIdx.x; idx < M * D; idx += WC_THREADS) m.xcur[idx] = m.y[idx];
            __syncthreads();
          }
        }
      }
      // the skips, whole in every block: the head's input
      __syncthreads();
      for (int idx = threadIdx.x; idx < M * nsq; idx += WC_THREADS) {
        const int r = idx / nsq, c = idx - r * nsq;
        const float4 v = *reinterpret_cast<const float4*>(m.skacc + r * a.skw + 4 * c);
        float4* p = reinterpret_cast<float4*>(m.ob0 + r * a.ow + 4 * (sq0 + c));
#pragma unroll
        for (int i = 0; i < CL; ++i) *cl.map_shared_rank(p, (i + idx) % CL) = v;
      }
      __syncthreads();
      WC_MARK(2);
      wc_cluster_sync();
      ++n_sync;
      WC_MARK(3);
      // the Mish MLP head; its last layer's logits stay in the block
      const float* hin = m.ob0;
      for (int k = 0; k < a.n_head; ++k) {
        float* hout = (k & 1) ? m.ob0 : m.ob1;
        WcEpi e;
        if (k + 1 < a.n_head) {
          e.kind = WC_HIDDEN;
          e.g0 = wc_lo(a.head_out[k] / 4, CL, rank);
          e.dst = hout;
          e.ldd = a.ow;
        } else {
          e.kind = WC_LOGITS;
          e.loc = m.lg;
          e.ldl = a.lgw;
        }
        wc_unit<CL>(a, m, w, hin, a.ow, a.head_in[k], hin, a.ow, a.head_in[k], M, e, cl);
        if (k + 1 < a.n_head) {
          WC_MARK(2);
          wc_cluster_sync();
          ++n_sync;
          WC_MARK(3);
          hin = hout;
        }
      }
      if (w.unit != w.n_units) __trap();  // the host's plan and this walk disagree
      __syncthreads();
      // the learned temperature, tempering, Gumbel noise and each block's
      // best class of each stream, to every block: a group of gs lanes a
      // stream, lane i of the group taking the block's classes i, i + gs, ...
      {
        const int per = 4 * nqq;
        int gs = 1;
        while (gs < per && gs < 32) gs <<= 1;
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, i0 = lane & (gs - 1);
        const int rpw = 32 / gs;  // streams a warp at once
        for (int r0 = warp * rpw; r0 < M; r0 += WC_WARPS * rpw) {
          const int r = r0 + lane / gs;
          const bool live = r < M;
          const float* lr = m.lg + (live ? r : 0) * a.lgw;
          const float lt = fmaxf(wc_sigmoid(lr[per]), a.min_temperature);
          const uint32_t key = a.argmax ? 0u : decode_noise_key(a.seed, t, b0 + r);
          const float temp = a.argmax ? 1.0f : a.temperature[b0 + (live ? r : 0)];
          float best = -INFINITY;
          int bestq = 0x7fffffff;
          for (int i = i0; i < per; i += gs) {
            const int q = 4 * qq0 + i;
            float v = lr[i] / lt;
            if (!a.argmax) v = v / temp + gumbel_from_bits(mix32(key ^ (uint32_t)q));
            if (v > best) {
              best = v;
              bestq = q;
            }
          }
          for (int off = gs >> 1; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, best, off);
            const int oq = __shfl_xor_sync(0xffffffffu, bestq, off);
            if (ov > best || (ov == best && oq < bestq)) {
              best = ov;
              bestq = oq;
            }
          }
          if (live) {
            float2* p = reinterpret_cast<float2*>(m.pick + 2 * (rank * a.S + r));
            for (int i = i0; i < CL; i += gs)
              *cl.map_shared_rank(p, i) = make_float2(best, __int_as_float(bestq));
          }
        }
      }
      wc_cluster_sync();
      ++n_sync;
      for (int r = threadIdx.x; r < M; r += WC_THREADS) {
        float best = -INFINITY;
        int bestq = 0x7fffffff;
        for (int k = 0; k < CL; ++k) {
          const float2 c = *reinterpret_cast<const float2*>(m.pick + 2 * (k * a.S + r));
          const int q = __float_as_int(c.y);
          if (c.x > best || (c.x == best && q < bestq)) {
            best = c.x;
            bestq = q;
          }
        }
        int tk = bestq == 0x7fffffff ? 0 : bestq;
        const int b = b0 + r;
        if (t < a.prior_t) tk = a.prompt[(long long)b * a.prior_t + t];
        m.tok[r] = tk;
        const long long o = t - a.out_t0;
        if (rank == 0 && o >= 0 && o < a.out_len) a.out[(long long)b * a.out_len + o] = tk;
      }
      __syncthreads();
      WC_MARK(5);
    }
    if (rank == 0)
      for (int r = threadIdx.x; r < M; r += WC_THREADS) a.tok[b0 + r] = m.tok[r];
    if (blockIdx.x == 0 && threadIdx.x == 0 && a.barriers != nullptr && g == 0)
      *a.barriers = n_sync;
    __syncthreads();
  }
  // the copies still in flight land before the block leaves
  for (; w.consumed < w.issued; ++w.consumed)
    wc_mbar_wait(m.bars + 1 + w.consumed % a.n_slots, (unsigned)((w.consumed / a.n_slots) & 1));
  // no block may leave while a peer may still store into its shared memory
  cl.sync();
}

template <int CL>
static int wc_config(const WcArgs& a, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                     cudaLaunchAttribute* attr, int* clusters) {
  const void* k = (const void*)wc_cluster_kernel<CL>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CL);
  cfg->blockDim = dim3(WC_THREADS);
  cfg->dynamicSmemBytes = (size_t)a.smem_bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(clusters, wc_cluster_kernel<CL>, cfg);
  if (e != cudaSuccess) return (int)e;
  return *clusters < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <int CL>
static int wc_launch(const WcArgs& a, cudaStream_t stream, int* clusters, int query) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = wc_config<CL>(a, stream, &cfg, attr, clusters);
  if (err != 0 || query) return err;
  const int groups = (a.B + a.S - 1) / a.S;
  const int n = groups < *clusters ? groups : *clusters;
  cfg.gridDim = dim3(n * CL);
  cudaError_t e = cudaLaunchKernelEx(&cfg, wc_cluster_kernel<CL>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

int mmk_wc_args_size(void) { return (int)sizeof(WcArgs); }

// Launch on `stream` (PyTorch's current stream) with clusters of `cl`
// blocks, groups of args->S streams; does not synchronise.  *clusters: the
// clusters that fit on the card at this shared memory (groups beyond them
// wait for a cluster).  With `query` set nothing is launched: only *clusters
// is filled.  Returns the cudaError_t (0 on success).
int mmk_wc_decode(const WcArgs* args, int cl, void* stream, int* clusters, int query) {
  switch (cl) {
    case 16: return wc_launch<16>(*args, (cudaStream_t)stream, clusters, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mmk_wc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
