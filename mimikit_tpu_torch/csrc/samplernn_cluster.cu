// SampleRNN chunked decode on thread-block clusters: a group of S streams
// shares a cluster of CL blocks (CL = 8 or 16), each block owning 1/CL of
// every product's output columns.
//
// Replaces, beside the block-per-group kernel of samplernn_decode.cu, the
// TPU kernel make_samplernn_pallas_chunked (K2,
// mimikit_tpu/ops/pallas_decode.py:868).  It computes what
// samplernn_decode_kernel computes (that file's note gives the step): the
// same state (DecodeState: the window, h, c and the tier caches, read at the
// start of a launch and written back at its end), the same noise keys
// (noise.cuh), the same argmax rule, ties to the lowest index, the same
// teacher forcing while t < prior_t, and the same two instantiations: float
// weights, and __nv_bfloat16 weights with each product's input rounded where
// JAX's wdot rounds it (the framed samples, x and h of the gates, h of the
// up-sampler, each head layer's input).  The route
// (ops/samplernn_decode.decode_chunk, K2_CLUSTER_ROUTE) sends it the batches
// where it wins; decode_single (K1) stays on the block kernel.
//
// Bound.  SampleRNN-3 (frames (16, 8, 8), H 256, Q 256, a 256-wide Mish
// head) needs ~0.61 MFLOP a stream-step: at B=256 the card's f32 rate bounds
// a step at ~2.3 us.  The block kernel takes ~28 us: 128 blocks each walk
// every step alone, re-read from L2 every weight the step uses (~1.2 MB, so
// ~157 MB of L2 reads a step over the card), and each thread walks K in
// rounds of dependent loads (~53 rounds a step).  Here a block holds its
// slice of the every-step weights (the bottom's framed dense whole, its
// columns of each head layer) in shared memory for the whole launch, and
// streams its slice of a tier's weights from L2 only when the tier fires.
//
// Design.  Each block owns: H / CL hidden units of every LSTM tier (their
// four gates' columns, so the cell update is local to the block, and their
// columns of every row of the tier's up-sampled cache), and 1 / CL of each
// head layer's columns (the last layer's share of the Q logits, plus the
// learned-temperature logit, which every block computes).  Every block
// holds the full rows of a product's input (S rows); a product's output
// slice is pushed into every peer's copy of the rows with 16-byte
// distributed-shared-memory stores, then the cluster barriers once
// (barrier.cluster arrive.release / wait.acquire).  A step is:
//   * each tier that fires (t % fs[i] == 0; every tier below it fires too):
//     push h (and the slice of the tier above's cache row) -> barrier ->
//     framed dense, whole, in every block -> the gates of the block's units
//     (K = 2H, streamed) -> the cell, local -> barrier (every peer done with
//     [x | h]) -> push the new h -> barrier -> the up-sampler's columns of
//     the block's units (streamed) into its cache slice; after the last
//     tier, push the cache row this step reads -> barrier;
//   * the bottom's framed dense + the cache row, whole, in every block;
//   * each hidden head layer: its columns, Mish, push -> barrier;
//   * the last head layer's columns (and the temperature logit), tempered,
//     noised and reduced to each stream's best (value, class) in the block;
//     push those candidates (and the slice of the next step's cache row) ->
//     barrier -> every block reduces the CL candidates in rank order.
// So a step without a tier is 2 cluster barriers at SampleRNN-3's widths; a
// step where tier 1 fires 6 more, and where both fire 10 more.
//
// Products.  A thread owns a quad of output columns for R rows (R <= 8 of
// the S, balanced) over a slice of K; the slices of K run in parallel warps
// so that all of a block's loads of a product are in flight at once, and
// are added in a fixed order (no atomics), so the tokens do not depend on
// timing, the chunking or the cluster that ran a stream.  The weights of a
// tier's product stream through a ring of 16 KB slots in pieces of whole
// rows of K, every thread copying its 16-byte chunks with cp.async; the
// firing steps are known in advance, so the ring is refilled with the next
// firing's first pieces while the steps before it run.  The products are
// inlined and the step's arithmetic is 32-bit (t % rf, kept as a counter):
// with ~227 KB of shared memory a block has ~28 KB of L1 left, and a
// non-inlined product's 240-byte stack, or a 64-bit remainder's call, went
// through it to L2 (chip_smoke.py's sweep, tools/profile_samplernn_cluster.py).
//
// Randomness: the port's counter hash of (seed, absolute t, stream, class)
// (noise.cuh), as in the block kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "noise.cuh"

namespace cg = cooperative_groups;

// Profiling hook, empty here: tools/profile_samplernn_cluster.py defines it
// in its copy of this source to stamp block 0's clock at each phase of a
// step (0 step start, 1 product end, 2 push end, 3 barrier end, 4 framed
// dense or cell end, 5 pick end, 6 a streamed piece arrived, 7 block 0's
// thread 0 done with a streamed piece).
#ifndef SC_MARK
#define SC_MARK(phase)
#endif

#define SC_THREADS 256
#define SC_WARPS (SC_THREADS / 32)
#define SC_MAX_TIERS 8
#define SC_MAX_HEAD 4
#define SC_PMAX 16          // slices of K a product at most
#define SC_BULK_MAX 32768   // bytes a single bulk copy at most

// Mirrors _ScArgs in mimikit_tpu_torch/ops/samplernn_decode.py.
struct ScArgs {
  const void* w;       // the pack's flat weights (the tiers' framed dense)
  const void* cw;      // every rank's region of relaid weights (cluster_layout)
  const int* prompt;   // (B, prior_t)
  int* win;            // (B, rf), oldest sample first; in/out
  float* h;            // (n_tiers-1, B, H); in/out
  float* c;            // (n_tiers-1, B, H); in/out
  float* cache;        // (B, cache_rows, H); in/out
  int* out;            // (B, out_len)
  long long t0;
  long long out_t0;
  long long off_win[SC_MAX_TIERS];  // in w: W_in (fs[i], H)
  long long off_bin[SC_MAX_TIERS];  // in w: (H)
  long long region;    // elements of a rank's region of cw
  // offsets in a rank's region (elements, multiples of 16 bytes)
  int o_wbot, o_bbot;
  int o_bx[SC_MAX_TIERS], o_bup[SC_MAX_TIERS], o_wx[SC_MAX_TIERS], o_wup[SC_MAX_TIERS];
  int o_bh[SC_MAX_HEAD], o_wh[SC_MAX_HEAD];
  int n_resident;      // elements at the region's start, loaded once for the launch
  int n_steps, out_len, B, H, Q, rf, prior_t, n_tiers, n_head, argmax;
  int S;               // streams a group
  int red_floats;      // the partial sums' floats
  int n_slots, slot_elems;
  int smem_bytes;
  int cache_rows;
  unsigned int seed;
  float temperature, min_temperature;
  int bf16;
  int fs[SC_MAX_TIERS], up[SC_MAX_TIERS], cache_row[SC_MAX_TIERS];
  int head_in[SC_MAX_HEAD], head_out[SC_MAX_HEAD];
};

// A block's shared memory, laid out alike in every block: the peers store
// into ab and cand.
struct ScSmem {
  float* ab;      // (S, 2H + 4): [x | h] of a tier; the head's two row buffers
  float* red;     // a product's partial sums, then its output slice
  float* csl;     // (n_t, S, Hb) the block's units' c
  float* hsl;     // (n_t, S, Hb) the block's units' h
  float* cache;   // tier i: (S, up[i] Hb) the block's columns of its cache rows
  float* cand;    // (CL, S, 2) each rank's best (value, class) a stream
  int* ring;      // (S, rf) the window as a ring, by absolute step
  float* vring;   // (S, rf) the same samples as a product reads them: (q / Q - 0.5) 2, rounded
  uint64_t* bar;  // the resident load
  unsigned char* wreg;   // the resident elements of the region
  unsigned char* slots;  // the ring of streamed pieces
};

// The first float of tier i's columns in ScSmem::cache.
__device__ __forceinline__ int sc_cache_off(const ScArgs& a, int i, int Hb) {
  int off = 0;
  for (int j = 0; j < i; ++j) off += a.up[j];
  return off * a.S * Hb;
}

__device__ __forceinline__ int sc_r4(int n) { return (n + 3) & ~3; }

__device__ inline ScSmem sc_carve(unsigned char* base, const ScArgs& a, int cl, int esize,
                                  int* total) {
  ScSmem m;
  const int S = a.S, H = a.H, Hb = H / cl, nt = a.n_tiers - 1;
  float* f = reinterpret_cast<float*>(base);
  m.ab = f;
  f += S * (2 * H + 4);
  m.red = f;
  f += sc_r4(a.red_floats);
  m.csl = f;
  f += sc_r4(nt * S * Hb);
  m.hsl = f;
  f += sc_r4(nt * S * Hb);
  m.cache = f;
  f += sc_r4(sc_cache_off(a, nt, Hb));
  m.cand = f;
  f += sc_r4(cl * S * 2);
  m.ring = reinterpret_cast<int*>(f);
  f += sc_r4(S * a.rf);
  m.vring = f;
  f += sc_r4(S * a.rf);
  m.bar = reinterpret_cast<uint64_t*>(f);
  f += 4;
  unsigned char* b = reinterpret_cast<unsigned char*>(f);
  m.wreg = b;
  b += (((size_t)a.n_resident * esize + 15) / 16) * 16;
  m.slots = b;
  b += (size_t)a.n_slots * a.slot_elems * esize;
  *total = (int)(b - base);
  return m;
}

__device__ __forceinline__ unsigned sc_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void sc_mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(sc_smem_addr(bar)), "r"(parity) : "memory");
}

// Thread 0: copy `bytes` (a multiple of 16) from global src to shared dst
// through the bulk copy engine, reported to `bar`.
__device__ __forceinline__ void sc_copy(void* dst, const void* src, unsigned bytes,
                                        uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(sc_smem_addr(bar)), "r"(bytes) : "memory");
  for (unsigned off = 0; off < bytes; off += SC_BULK_MAX)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(sc_smem_addr(static_cast<unsigned char*>(dst) + off)),
        "l"(static_cast<const unsigned char*>(src) + off),
        "r"(min((unsigned)SC_BULK_MAX, bytes - off)), "r"(sc_smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void sc_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void sc_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void sc_cluster_sync() {
  sc_cluster_arrive();
  sc_cluster_wait();
  SC_MARK(3);
}

// Weights as f32: four consecutive elements (16 bytes of f32, 8 of bf16),
// one element; and a product input as the weight type rounds it.
__device__ __forceinline__ float4 sc_w4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 sc_w4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 sc_w4g(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 sc_w4g(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float sc_w1(const float* p) { return *p; }
__device__ __forceinline__ float sc_w1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <class WT>
__device__ __forceinline__ float sc_round(float x) {
  return x;
}
template <>
__device__ __forceinline__ float sc_round<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <class WT>
__device__ __forceinline__ float4 sc_round4(float4 v) {
  return make_float4(sc_round<WT>(v.x), sc_round<WT>(v.y), sc_round<WT>(v.z), sc_round<WT>(v.w));
}

__device__ __forceinline__ float4 sc_add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float sc_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float sc_mish(float x) {
  const float sp = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
  return x * tanhf(sp);
}

// The walk over the launch's streamed pieces: every piece of every tier's
// gates then up-sampler, tier by tier, at each step where tiers fire, in
// the order the step loop consumes them.  Every thread keeps the same walk
// and copies its share of each piece.
struct ScWalk {
  long long t;       // the step of the next piece to issue
  long long t_end;   // the launch's end
  int ph;            // t % rf (every frame size divides rf)
  int tier, kind, piece;
  int issued;        // pieces issued over the launch
};

// The rows of K a ring slot holds for nb columns: a multiple of 4.
__device__ __forceinline__ int sc_rows_a_piece(int slot_elems, int nb) {
  return 4 * max(1, slot_elems / nb / 4);
}

// The pieces of a streamed product.
__device__ __forceinline__ int sc_n_pieces(int K, int nb, int slot_elems) {
  const int kp = sc_rows_a_piece(slot_elems, nb);
  return (K + kp - 1) / kp;
}

// A tier's streamed product: kind 0 its gates (K = 2H, 4 Hb columns), kind 1
// its up-sampler (K = H, up Hb columns); pieces of `kp` whole rows.
__device__ __forceinline__ int sc_pieces(const ScArgs& a, int cl, int tier, int kind, int* K,
                                         int* nb, int* kp, int* off) {
  const int Hb = a.H / cl;
  *K = kind == 0 ? 2 * a.H : a.H;
  *nb = kind == 0 ? 4 * Hb : a.up[tier] * Hb;
  *kp = sc_rows_a_piece(a.slot_elems, *nb);
  *off = kind == 0 ? a.o_wx[tier] : a.o_wup[tier];
  return (*K + *kp - 1) / *kp;
}

__device__ __forceinline__ int sc_first_tier(const ScArgs& a, int ph) {
  int i = 0;
  while (ph % a.fs[i] != 0) ++i;
  return i;
}

// Issue the walk's next piece into the next ring slot (nothing past the
// launch's last step): every thread copies its 16-byte chunks with
// cp.async and commits one group, so that each piece is one group of every
// thread (sc_wait_piece counts them).
template <class WT>
__device__ __forceinline__ void sc_issue(const ScArgs& a, ScWalk* w, unsigned char* slots, const WT* region,
                         int cl) {
  if (w->t >= w->t_end) return;
  int K, nb, kp, off;
  const int np = sc_pieces(a, cl, w->tier, w->kind, &K, &nb, &kp, &off);
  const int s = w->issued % a.n_slots;
  const int rows = min(kp, K - w->piece * kp);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(
      region + off + (size_t)w->piece * kp * nb);
  unsigned char* dst = slots + (size_t)s * a.slot_elems * sizeof(WT);
  const int chunks = (int)((size_t)rows * nb * sizeof(WT) / 16);
  for (int c = threadIdx.x; c < chunks; c += SC_THREADS)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(sc_smem_addr(dst + 16 * c)), "l"(src + 16 * c) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  ++w->issued;
  if (++w->piece == np) {
    w->piece = 0;
    if (++w->kind == 2) {
      w->kind = 0;
      if (++w->tier == a.n_tiers - 1) {
        w->t += a.fs[a.n_tiers - 2];
        w->ph = (w->ph + a.fs[a.n_tiers - 2]) % a.rf;
        w->tier = sc_first_tier(a, w->ph);
      }
    }
  }
}

// Wait for this thread's copies of the launch's `n`-th piece (the groups
// issued after it may stay in flight), then for every thread's.
__device__ __forceinline__ void sc_wait_piece(int n, int issued) {
  switch (issued - n - 1) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
  __syncthreads();
}

// red[s][j] = sum_k X[s][k] W[k][j] for s < S, j < nb (nb a multiple of 4),
// W k-major (row k's nb columns together): resident in `res`, or (res null)
// streamed piece by piece through the ring, the first piece the launch's
// `consumed`-th.  Thread t < T P owns the column quad q and the rows of row
// group g (R at most) of task t % T (T = nb / 4 groups), and the slice t / T
// of each piece's rows; it keeps its sums in registers across the pieces,
// then the P slices are added in order.  Ends with a block barrier.
template <class WT, int R>
__device__ __forceinline__ void sc_product(const ScArgs& a, ScWalk* w, unsigned char* slots,
                                        const WT* region, int cl, const WT* res, int K, int nb,
                                        int consumed, const float* X, int ldx, float* red) {
  const int S = a.S, nq = nb / 4, G = (S + R - 1) / R, T = nq * G;
  int P = max(1, min(SC_THREADS / T, a.red_floats / (S * nb)));
  P = min(P, SC_PMAX);
  const int tid = threadIdx.x;
  const bool active = tid < T * P;
  const int task = tid % T, sl = tid / T;
  const int q = task % nq, g = task / nq;
  const int row0 = (g * S) / G, m_rows = ((g + 1) * S) / G - row0;
  int roff[R];
#pragma unroll
  for (int r = 0; r < R; ++r) roff[r] = (row0 + min(r, max(m_rows, 1) - 1)) * ldx;
  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int kp = res != nullptr ? K : sc_rows_a_piece(a.slot_elems, nb);
  const int np = (K + kp - 1) / kp;
  for (int p = 0; p < np; ++p) {
    const WT* Wp = res;
    if (res == nullptr) {
      sc_wait_piece(consumed + p, w->issued);
      SC_MARK(6);
      Wp = reinterpret_cast<const WT*>(slots + (size_t)((consumed + p) % a.n_slots) *
                                                   a.slot_elems * sizeof(WT));
    }
    const int k0 = p * kp, len4 = (min(K, k0 + kp) - k0) / 4;
    if (active && m_rows > 0) {
      const int lo = 4 * ((sl * len4) / P), hi = 4 * (((sl + 1) * len4) / P);
      const WT* wq = Wp + (size_t)lo * nb + 4 * q;
      const float* xk = X + k0 + lo;
      for (int k = lo; k < hi; k += 4, wq += 4 * nb, xk += 4) {
        float4 wv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) wv[e] = sc_w4(wq + e * nb);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xk + roff[r]);
          const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[r].x = fmaf(x4[e], wv[e].x, acc[r].x);
            acc[r].y = fmaf(x4[e], wv[e].y, acc[r].y);
            acc[r].z = fmaf(x4[e], wv[e].z, acc[r].z);
            acc[r].w = fmaf(x4[e], wv[e].w, acc[r].w);
          }
        }
      }
    }
    if (res == nullptr) {
      SC_MARK(7);
      __syncthreads();  // every thread is done with the slot
      sc_issue<WT>(a, w, slots, region, cl);
    }
  }
  float4* red4 = reinterpret_cast<float4*>(red);
  if (active) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < m_rows) red4[((size_t)sl * S + row0 + r) * nq + q] = acc[r];
  }
  __syncthreads();
  if (P > 1) {
    for (int idx = tid; idx < S * nq; idx += SC_THREADS) {
      float4 v = red4[idx];
      for (int s2 = 1; s2 < P; ++s2) v = sc_add4(v, red4[(size_t)s2 * S * nq + idx]);
      red4[idx] = v;
    }
    __syncthreads();
  }
  SC_MARK(1);
}

// Store v at the local address p in every block of the cluster.
template <int CL>
__device__ __forceinline__ void sc_push4(float* p, float4 v) {
  cg::cluster_group cl = cg::this_cluster();
#pragma unroll
  for (int r = 0; r < CL; ++r) *reinterpret_cast<float4*>(cl.map_shared_rank(p, r)) = v;
}

// Push this block's columns of row `row` of a tier's cache (c: S rows of
// ldc) into every peer's ab at column rank Hb.
template <int CL>
__device__ __forceinline__ void sc_push_row(const float* c, int ldc, int row, int S, int Hb,
                                            int ld, float* ab, int rank) {
  const int nq = Hb / 4;
  for (int idx = threadIdx.x; idx < S * nq; idx += SC_THREADS) {
    const int s = idx / nq, q = idx - s * nq;
    sc_push4<CL>(ab + (size_t)s * ld + rank * Hb + 4 * q,
                 *reinterpret_cast<const float4*>(c + (size_t)s * ldc + row * Hb + 4 * q));
  }
  SC_MARK(2);
}

// x[s][j] = sum_kk v(s, t - f + kk) W[kk][j] + b[j] (+ row[s][j]) for the S
// rows, whole (H columns), rounded as a product input: the framed dense of a
// tier (W, b in the pack, read through L2) or of the bottom (resident); v
// the window's samples as products read them (vring).
template <class WT, bool GLOBAL>
__device__ __forceinline__ void sc_framed(const float* vring, int S, int H, int rf, int tm,
                                          const WT* W, const WT* b, int f, const float* row,
                                          float* x) {
  const int nq = H / 4, ld = 2 * H + 4;
  const int G = max(1, min(S, SC_THREADS / nq));  // row groups
  for (int idx = threadIdx.x; idx < nq * G; idx += SC_THREADS) {
    const int q = idx % nq, g = idx / nq;
    const float4 bv = GLOBAL ? sc_w4g(b + 4 * q) : sc_w4(b + 4 * q);
    for (int s = (g * S) / G; s < ((g + 1) * S) / G; ++s) {
      const float* v = vring + s * rf;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int pos = tm - f;
      if (pos < 0) pos += rf;
      for (int kk = 0; kk < f; ++kk) {
        const float xv = v[pos];
        pos = pos + 1 == rf ? 0 : pos + 1;
        const float4 wv =
            GLOBAL ? sc_w4g(W + (size_t)kk * H + 4 * q) : sc_w4(W + (size_t)kk * H + 4 * q);
        acc.x = fmaf(xv, wv.x, acc.x);
        acc.y = fmaf(xv, wv.y, acc.y);
        acc.z = fmaf(xv, wv.z, acc.z);
        acc.w = fmaf(xv, wv.w, acc.w);
      }
      acc = sc_add4(acc, bv);
      if (row != nullptr)
        acc = sc_add4(acc, *reinterpret_cast<const float4*>(row + (size_t)s * ld + 4 * q));
      *reinterpret_cast<float4*>(x + (size_t)s * ld + 4 * q) = sc_round4<WT>(acc);
    }
  }
  __syncthreads();
  SC_MARK(4);
}

template <class WT>
__device__ __forceinline__ float sc_sample(int tok, int Q) {
  return sc_round<WT>(((float)tok / (float)Q - 0.5f) * 2.0f);
}

template <int CL, class WT, int R>
__global__ void __launch_bounds__(SC_THREADS, 1)
    sc_decode_kernel(const __grid_constant__ ScArgs a) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  extern __shared__ __align__(16) unsigned char smem[];
  int total = 0;
  const ScSmem m = sc_carve(smem, a, CL, (int)sizeof(WT), &total);
  if (total > a.smem_bytes) __trap();  // the host's plan and this carve disagree
  const int H = a.H, Hb = H / CL, S = a.S, nt = a.n_tiers - 1, ld = 2 * H + 4, rf = a.rf;
  const int tid = threadIdx.x;
  const WT* region = static_cast<const WT*>(a.cw) + (size_t)rank * a.region;
  const WT* wg = static_cast<const WT*>(a.w);
  const WT* wreg = reinterpret_cast<const WT*>(m.wreg);
  float* A = m.ab;
  float* Bb = m.ab + H;

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sc_smem_addr(m.bar)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the every-step weights and the slices' biases, once for the launch
  if (tid == 0)
    sc_copy(m.wreg, region, (unsigned)((((size_t)a.n_resident * sizeof(WT)) + 15) / 16 * 16),
            m.bar);
  ScWalk walk;
  walk.issued = 0;
  int consumed = 0;  // streamed pieces consumed over the launch (alike in every thread)
  sc_mbar_wait(m.bar, 0);
  cl.sync();  // every block's buffers and barriers ready before the first remote store

  const int n_groups = (a.B + S - 1) / S;
  const int n_clusters = gridDim.x / CL;
  const int f_last = a.fs[nt - 1], up_last = a.up[nt - 1];
  const int nl = a.n_head - 1, nbl = a.Q / CL + 4, ql = a.Q / CL;
  const float* c_last = m.cache + sc_cache_off(a, nt - 1, Hb);
  for (int grp = blockIdx.x / CL; grp < n_groups; grp += n_clusters) {
    const int b0 = grp * S, n_valid = min(S, a.B - b0);
    // the group's state: the window, its units' carries and cache columns
    const int ph0 = (int)(a.t0 % rf);
    for (int idx = tid; idx < S * rf; idx += SC_THREADS) {
      const int s = idx / rf, p = idx - s * rf;
      const int b = min(b0 + s, a.B - 1);
      const int tok = a.win[(size_t)b * rf + p], pos = (ph0 + p) % rf;
      m.ring[s * rf + pos] = tok;
      m.vring[s * rf + pos] = sc_sample<WT>(tok, a.Q);
    }
    for (int idx = tid; idx < nt * S * Hb; idx += SC_THREADS) {
      const int i = idx / (S * Hb), s = (idx / Hb) % S, u = idx % Hb;
      const size_t g = ((size_t)i * a.B + min(b0 + s, a.B - 1)) * H + rank * Hb + u;
      m.csl[idx] = a.c[g];
      m.hsl[idx] = a.h[g];
    }
    for (int i = 0; i < nt; ++i) {
      const int ldc = a.up[i] * Hb;
      for (int idx = tid; idx < S * ldc; idx += SC_THREADS) {
        const int s = idx / ldc, j = idx - s * ldc, row = j / Hb, u = j - row * Hb;
        m.cache[sc_cache_off(a, i, Hb) + idx] =
            a.cache[((size_t)min(b0 + s, a.B - 1) * a.cache_rows + a.cache_row[i] + row) * H +
                    rank * Hb + u];
      }
    }
    // the walk starts at the group's first firing step
    walk.t_end = a.t0 + a.n_steps;
    walk.t = ((a.t0 + f_last - 1) / f_last) * f_last;
    walk.ph = (int)(walk.t % rf);
    walk.tier = sc_first_tier(a, walk.ph);
    walk.kind = walk.piece = 0;
    for (int s = 0; s < a.n_slots; ++s) sc_issue<WT>(a, &walk, m.slots, region, CL);
    __syncthreads();
    float* rowbuf = (nl % 2 == 0) ? Bb : A;  // the buffer the last head layer does not read
    if (a.t0 % f_last != 0) {  // the first step's cache row
      sc_push_row<CL>(c_last, up_last * Hb, (int)(a.t0 % up_last), S, Hb, ld, rowbuf, rank);
      sc_cluster_sync();
    }

    int ph = ph0;  // t % rf: every frame size divides rf
    for (int step = 0; step < a.n_steps; ++step) {
      const long long t = a.t0 + step;
      const int ph1 = ph + 1 == rf ? 0 : ph + 1;
      SC_MARK(0);
      bool fired = false;
      for (int i = 0; i < nt; ++i) {
        if (ph % a.fs[i] != 0) continue;
        if (fired) sc_cluster_sync();  // every peer done reading h in the tier above's up-sampler
        float* cs = m.csl + (size_t)i * S * Hb;
        float* hs = m.hsl + (size_t)i * S * Hb;
        // [x | h]: the tier above's cache row slice and this tier's h slice from every block
        for (int idx = tid; idx < S * Hb / 4; idx += SC_THREADS) {
          const int s = idx / (Hb / 4), u = 4 * (idx - s * (Hb / 4));
          sc_push4<CL>(Bb + (size_t)s * ld + rank * Hb + u,
                       sc_round4<WT>(*reinterpret_cast<const float4*>(hs + s * Hb + u)));
        }
        if (i > 0)
          sc_push_row<CL>(m.cache + sc_cache_off(a, i - 1, Hb), a.up[i - 1] * Hb,
                          (ph / a.fs[i]) % a.up[i - 1], S, Hb, ld, A, rank);
        SC_MARK(2);
        sc_cluster_sync();
        sc_framed<WT, true>(m.vring, S, H, rf, ph, wg + a.off_win[i], wg + a.off_bin[i], a.fs[i],
                            i > 0 ? A : nullptr, A);
        sc_product<WT, R>(a, &walk, m.slots, region, CL, nullptr, 2 * H, 4 * Hb, consumed,
                          m.ab, ld, m.red);
        consumed += sc_n_pieces(2 * H, 4 * Hb, a.slot_elems);
        sc_cluster_arrive();  // this block is done with [x | h]
        // the cell of the block's units (gate order i|f|g|o), four units a thread
        const WT* bx = wreg + a.o_bx[i];
        for (int idx = tid; idx < S * Hb / 4; idx += SC_THREADS) {
          const int s = idx / (Hb / 4), u = 4 * (idx - s * (Hb / 4));
          const float* gt = m.red + (size_t)s * 4 * Hb;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gi = sc_sigmoid(gt[u + e] + sc_w1(bx + u + e));
            const float gf = sc_sigmoid(gt[Hb + u + e] + sc_w1(bx + Hb + u + e));
            const float gg = tanhf(gt[2 * Hb + u + e] + sc_w1(bx + 2 * Hb + u + e));
            const float go = sc_sigmoid(gt[3 * Hb + u + e] + sc_w1(bx + 3 * Hb + u + e));
            const float c2 = gf * cs[s * Hb + u + e] + gi * gg;
            cs[s * Hb + u + e] = c2;
            hs[s * Hb + u + e] = go * tanhf(c2);
          }
        }
        SC_MARK(4);
        sc_cluster_wait();  // every peer is done with [x | h]
        SC_MARK(3);
        // push the new h (each thread the units it updated)
        for (int idx = tid; idx < S * Hb / 4; idx += SC_THREADS) {
          const int s = idx / (Hb / 4), u = 4 * (idx - s * (Hb / 4));
          sc_push4<CL>(Bb + (size_t)s * ld + rank * Hb + u,
                       sc_round4<WT>(*reinterpret_cast<const float4*>(hs + s * Hb + u)));
        }
        SC_MARK(2);
        sc_cluster_sync();
        // the up-sampler's columns of the block's units, into its cache slice
        const int nb = a.up[i] * Hb;
        sc_product<WT, R>(a, &walk, m.slots, region, CL, nullptr, H, nb, consumed, Bb, ld,
                          m.red);
        consumed += sc_n_pieces(H, nb, a.slot_elems);
        {
          const WT* bup = wreg + a.o_bup[i];
          float* c = m.cache + sc_cache_off(a, i, Hb);
          for (int idx = tid; idx < S * nb / 4; idx += SC_THREADS) {
            const int j = 4 * (idx % (nb / 4));
            *reinterpret_cast<float4*>(c + 4 * idx) =
                sc_add4(*reinterpret_cast<const float4*>(m.red + 4 * idx), sc_w4(bup + j));
          }
        }
        __syncthreads();
        fired = true;
      }
      const float* row = rowbuf;
      if (fired) {  // this step's row of the last tier's new cache
        sc_push_row<CL>(c_last, up_last * Hb, ph % up_last, S, Hb, ld, A, rank);
        sc_cluster_sync();
        row = A;
      }
      // the bottom: framed dense + the cache row, whole rows
      sc_framed<WT, false>(m.vring, S, H, rf, ph, wreg + a.o_wbot, wreg + a.o_bbot, a.fs[nt], row,
                           A);
      // the head's hidden layers: Mish, pushed
      float* in = A;
      float* nx = Bb;
      for (int l = 0; l < nl; ++l) {
        const int nb = a.head_out[l] / CL;
        sc_product<WT, R>(a, &walk, m.slots, region, CL, wreg + a.o_wh[l], a.head_in[l], nb,
                          0, in, ld, m.red);
        const WT* bh = wreg + a.o_bh[l];
        for (int idx = tid; idx < S * nb / 4; idx += SC_THREADS) {
          const int s = idx / (nb / 4), j = 4 * (idx - s * (nb / 4));
          float4 v = sc_add4(*reinterpret_cast<const float4*>(m.red + 4 * idx), sc_w4(bh + j));
          v = make_float4(sc_mish(v.x), sc_mish(v.y), sc_mish(v.z), sc_mish(v.w));
          sc_push4<CL>(nx + (size_t)s * ld + rank * nb + j, sc_round4<WT>(v));
        }
        SC_MARK(2);
        sc_cluster_sync();
        float* tmp = in;
        in = nx;
        nx = tmp;
      }
      // the last layer's columns and the temperature logit; each stream's best in the block
      sc_product<WT, R>(a, &walk, m.slots, region, CL, wreg + a.o_wh[nl], a.head_in[nl],
                        nbl, 0, in, ld, m.red);
      {
        const WT* bh = wreg + a.o_bh[nl];
        const int warp = tid >> 5, lane = tid & 31;
        for (int s = warp; s < S; s += SC_WARPS) {
          const float* L = m.red + (size_t)s * nbl;
          const float lt = fmaxf(sc_sigmoid(L[ql] + sc_w1(bh + ql)), a.min_temperature);
          const int b = b0 + s;
          const uint32_t key = a.argmax ? 0u : decode_noise_key(a.seed, t, b);
          float best = -INFINITY;
          int bestq = 0x7fffffff;
          for (int j = lane; j < ql; j += 32) {
            const int qg = rank * ql + j;
            float v = (L[j] + sc_w1(bh + j)) / lt;
            if (!a.argmax) v = v / a.temperature + gumbel_from_bits(mix32(key ^ (uint32_t)qg));
            if (v > best) {
              best = v;
              bestq = qg;
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
          if (lane < CL) {
            float* rp = cl.map_shared_rank(m.cand + ((size_t)rank * S + s) * 2, lane);
            rp[0] = best;
            rp[1] = __int_as_float(bestq);
          }
        }
      }
      if (step + 1 < a.n_steps && ph1 % f_last != 0)  // the next step's cache row
        sc_push_row<CL>(c_last, up_last * Hb, ph1 % up_last, S, Hb, ld, rowbuf, rank);
      SC_MARK(2);
      sc_cluster_sync();
      // every block: the CL candidates in rank order, ties to the lowest class
      const int tm = ph;
      for (int s = tid; s < S; s += SC_THREADS) {
        float bv = -INFINITY;
        int bq = 0x7fffffff;
        for (int r = 0; r < CL; ++r) {
          const float ov = m.cand[((size_t)r * S + s) * 2];
          const int oq = __float_as_int(m.cand[((size_t)r * S + s) * 2 + 1]);
          if (ov > bv || (ov == bv && oq < bq)) {
            bv = ov;
            bq = oq;
          }
        }
        const int b = b0 + s;
        int tok = bq == 0x7fffffff ? 0 : bq;
        if (t < a.prior_t) tok = a.prompt[(size_t)min(b, a.B - 1) * a.prior_t + t];
        m.ring[s * rf + tm] = tok;
        m.vring[s * rf + tm] = sc_sample<WT>(tok, a.Q);
        const long long o = t - a.out_t0;
        if (rank == 0 && s < n_valid && o >= 0 && o < a.out_len)
          a.out[(size_t)b * a.out_len + o] = tok;
      }
      __syncthreads();
      SC_MARK(5);
      ph = ph1;
    }
    // write the group's state back
    for (int idx = tid; idx < S * rf; idx += SC_THREADS) {
      const int s = idx / rf, p = idx - s * rf;
      if (rank == 0 && s < n_valid) a.win[(size_t)(b0 + s) * rf + p] = m.ring[s * rf + (ph + p) % rf];
    }
    for (int idx = tid; idx < nt * S * Hb; idx += SC_THREADS) {
      const int i = idx / (S * Hb), s = (idx / Hb) % S, u = idx % Hb;
      if (s < n_valid) {
        const size_t g = ((size_t)i * a.B + b0 + s) * H + rank * Hb + u;
        a.c[g] = m.csl[idx];
        a.h[g] = m.hsl[idx];
      }
    }
    for (int i = 0; i < nt; ++i) {
      const int ldc = a.up[i] * Hb;
      for (int idx = tid; idx < S * ldc; idx += SC_THREADS) {
        const int s = idx / ldc, j = idx - s * ldc, row = j / Hb, u = j - row * Hb;
        if (s < n_valid)
          a.cache[((size_t)(b0 + s) * a.cache_rows + a.cache_row[i] + row) * H + rank * Hb + u] =
              m.cache[sc_cache_off(a, i, Hb) + idx];
      }
    }
    __syncthreads();
  }
  // every issued copy has been consumed (the walk ends with the launch's steps)
  if (consumed != walk.issued) __trap();
  // no block may leave while a peer may still store into its shared memory
  cl.sync();
}

template <int CL, class WT, int R>
static int sc_config(const ScArgs& a, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                     cudaLaunchAttribute* attr, int* clusters) {
  const void* k = (const void*)sc_decode_kernel<CL, WT, R>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CL);
  cfg->blockDim = dim3(SC_THREADS);
  cfg->dynamicSmemBytes = (size_t)a.smem_bytes;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(clusters, sc_decode_kernel<CL, WT, R>, cfg);
  if (e != cudaSuccess) return (int)e;
  return *clusters < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

template <int CL, class WT, int R>
static int sc_launch(const ScArgs& a, cudaStream_t stream, int* clusters, int query) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = sc_config<CL, WT, R>(a, stream, &cfg, attr, clusters);
  if (err != 0 || query) return err;
  const int groups = (a.B + a.S - 1) / a.S;
  const int n = groups < *clusters ? groups : *clusters;
  cfg.gridDim = dim3(n * CL);
  cudaError_t e = cudaLaunchKernelEx(&cfg, sc_decode_kernel<CL, WT, R>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The rows a product task owns: S streams in ceil(S / 8) groups, rounded up
// to an even count (2, 4, 6 or 8).
static int sc_rows(int S) {
  const int G = (S + 7) / 8;
  return (((S + G - 1) / G) + 1) & ~1;
}

template <int CL, class WT>
static int sc_by_rows(const ScArgs& a, cudaStream_t s, int* clusters, int query) {
  switch (sc_rows(a.S)) {
    case 2: return sc_launch<CL, WT, 2>(a, s, clusters, query);
    case 4: return sc_launch<CL, WT, 4>(a, s, clusters, query);
    case 6: return sc_launch<CL, WT, 6>(a, s, clusters, query);
    case 8: return sc_launch<CL, WT, 8>(a, s, clusters, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class WT>
static int sc_dispatch(const ScArgs& a, int cl, cudaStream_t s, int* clusters, int query) {
  switch (cl) {
    case 8: return sc_by_rows<8, WT>(a, s, clusters, query);
    case 16: return sc_by_rows<16, WT>(a, s, clusters, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int mmk_sc_args_size(void) { return (int)sizeof(ScArgs); }

// Launch on `stream` (PyTorch's current stream) with clusters of `cl`
// blocks; does not synchronise.  *clusters: the clusters that fit on the
// card at this shared memory (groups beyond them wait for a cluster).  With
// `query` set nothing is launched: only *clusters is filled.  Returns the
// cudaError_t (0 on success).
int mmk_sc_decode(const ScArgs* args, int cl, void* stream, int* clusters, int query) {
  cudaStream_t s = (cudaStream_t)stream;
  return args->bf16 ? sc_dispatch<__nv_bfloat16>(*args, cl, s, clusters, query)
                    : sc_dispatch<float>(*args, cl, s, clusters, query);
}

const char* mmk_sc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
