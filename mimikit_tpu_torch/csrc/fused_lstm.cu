// One LSTM layer over time for training: the forward recurrence, the
// reverse-time backward, and the recurrent weight gradient.
//
// Replaces the TPU kernels of mimikit_tpu/ops/pallas_lstm.py:76
// `_make_fused_calls`: the forward `pallas_call` (:111, K3a) and the backward
// `pallas_call` (:197, K3b).  As there, the input projection xi = x @ Wi + b,
// and db, dWi and dx from dxi, are products outside the kernels
// (ops/fused_lstm.py); everything the Pallas kernels computed in their bodies
// is here: the recurrence with h/c carried on chip, the stored h, c and
// post-activation gates, the reverse-time walk that yields dxi, dh0 and dc0,
// and dWh.  Layout: time-major, gate order i|f|g|o (flax OptimizedLSTMCell),
// xi (T, B, 4H), Wh (H, 4H), every tensor contiguous and of one stream type:
// float, or __nv_bfloat16 (the `param_dtype="bfloat16"` training policy).
//
// Per step (pallas_lstm.py:95-109):
//   z = xi[t] + h @ Wh;  i, f, o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)
//   c = f*c + i*g;  h = o*tanh(c);  store h, c and (i, f, g, o).
// Backward per step, t = T-1 .. 0 (pallas_lstm.py:154-189):
//   dh = dh_all[t] + dh_carry;  dc = dc_carry + dh*o*(1 - tanh(c)^2)
//   dz = (dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2), dh*tanh(c)*o*(1-o))
//   dxi[t] = dz;  dh_carry = dz @ Wh^T;  dc_carry = dc*f
// and dWh = sum_t h_{t-1}^T dz_t, a reduction over time and batch that runs
// after the walk, over the stored dxi (lstm_dwh_kernel).
//
// Design.  The TPU kept Wh (1 MB at H=256) in one core's VMEM and ran the
// time loop in order.  Here the chain of T dependent steps is the bound: the
// work of a step (2*B*H*4H flops, 16.8 MFLOP at B=32, H=256) is a fraction
// of a microsecond for the whole card, so what costs is the latency of each
// step, and every gate column needs all of h_{t-1}.  A thread block cluster
// shares one group of batch rows; each block owns H/CL hidden units and keeps
// its slice of Wh (the Wh columns of its units' four gates) in shared memory
// for the whole walk.  The time loop runs inside one launch; clusters
// (groups of batch rows) are independent.
//
// Forward (8 blocks a cluster): each block computes its units' gates for the
// group's rows from the whole h_{t-1}, and after each step the blocks gather
// the new h from each other through distributed shared memory, with one
// cluster barrier a step.  Limits: H a multiple of 8, the Wh slice (2*H*H
// bytes in f32) plus buffers within a block's 227 KB of shared memory (up to
// H = 336 in f32).
//
// Backward walk (8 or 16 blocks a cluster, ops/fused_lstm.py's
// LSTM_BWD_ROUTE): dh_{t-1} = dz_t Wh^T needs every block's dz.  Gathering
// the whole dz (BC x 4H) into every block before the product, as a version
// of this kernel did, put a pull of 4H floats a row from remote shared
// memory, a scalar at a time, on each step's chain.  Instead each block
// multiplies its own dz (BC x 4H/CL, at hand) by its slice into a partial
// dh_{t-1} over all H units and stores each (BC x H/CL) piece of it into the
// shared memory of the block that owns those units; after one cluster
// barrier the owner adds its CL pieces in rank order.  A step moves BC x H
// floats a block instead of BC x 4H.  The cluster barrier is split: step
// t-2's gates, c and dh_all load, and dxi[t] stores, between its arrive and
// its wait (a device-memory access issued before a release arrive holds the
// arrive until the access completes), two steps ahead so that no step
// waits for its inputs.  Limits: H a multiple of the cluster size and of 4,
// and the slice (4H/CL rows of H + 4 elements) plus buffers within 227 KB.
//
// dWh is a product hprev^T (H x T*B) times dxi (T*B x 4H) after the walk, on
// the tensor cores (WMMA): 64 x 64 tiles of dWh, each summed over one of
// `splits` ranges of the T*B rows (enough blocks to fill the card); a second
// kernel adds the partial tiles in a fixed order.  f32 streams take 3xTF32
// (each operand split into a TF32 high part and the TF32 of the rest, three
// products a pair), which is about as close to the f32 sum as f32 products;
// bf16 streams multiply bf16 with f32 sums.  No atomics, so the result does
// not depend on the run.
//
// bf16 streams (pallas_lstm.py:87-195 with dt = bf16).  Every tensor in and
// out is bf16 (Wh too, which then takes half the shared memory); the
// arithmetic and the carries stay f32 (c in a register, dh and dc in the
// backward).  The kernels round where the Pallas kernels round: the new h to
// bf16 once, and that rounded h is both the stored h_all and the input of the
// next step's product (`h_scr.astype(dt)`), so the distributed-shared-memory
// exchange carries bf16 values; c and the gates are rounded only where they
// are stored, and the backward reads those stored values (tanh(c), c_prev, the
// gates); the backward's dz is rounded to bf16 once, and that value is the
// stored dxi and the input of dz @ Wh^T, while the dc carry (dc*f) stays f32.
// dWh multiplies the bf16 hprev and dxi on the tensor cores with f32 sums,
// adds the partial tiles in their fixed order, and rounds once.  The bf16 instantiation is bound by the same serial
// chain as the f32 one: halving the bytes moves no bound that sets its pace.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <string.h>

namespace cg = cooperative_groups;
using namespace nvcuda;

#define MMK_LSTM_CLUSTER 8
#define MMK_LSTM_THREADS 256

__device__ __forceinline__ float mmk_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Loads and stores of the stream type S, in f32 registers; `mmk_round<S>`
// rounds an f32 value to S and back (the identity for float).
__device__ __forceinline__ float mmk_ld(const float* p) { return *p; }
__device__ __forceinline__ float mmk_ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void mmk_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void mmk_st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
template <typename S>
__device__ __forceinline__ float mmk_round(float v) { return v; }
template <>
__device__ __forceinline__ float mmk_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// Four consecutive elements of the stream type (16- or 8-byte aligned), in f32.
__device__ __forceinline__ void mmk_ld4(const float* p, float* w) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}
__device__ __forceinline__ void mmk_ld4(const __nv_bfloat16* p, float* w) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = lo.x, w[1] = lo.y, w[2] = hi.x, w[3] = hi.y;
}
// N consecutive f32 of shared memory, aligned to 4 * N bytes (N = 1, 2, 4, 8).
template <int N>
__device__ __forceinline__ void mmk_lds_rows(const float* p, float* d) {
  if (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      d[i] = v.x, d[i + 1] = v.y, d[i + 2] = v.z, d[i + 3] = v.w;
    }
  } else if (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x, d[1] = v.y;
  } else {
    d[0] = p[0];
  }
}

// Forward.  Cluster `blockIdx.x / 8` owns batch rows [b0, b0 + BC); block
// rank q owns hidden units [q*U, (q+1)*U), U = H/8, i.e. gate columns
// g*H + q*U + u of Wh.  Thread p < BC*U owns the pair (row p/U, unit p%U) and
// keeps its c in a register; for the recurrent product, thread
// (j, s) = (tid % NC, tid / NC) sums column j over k = s, s+KS, ...
template <typename S, int BC>
__global__ void __cluster_dims__(MMK_LSTM_CLUSTER, 1, 1) __launch_bounds__(MMK_LSTM_THREADS)
lstm_fwd_kernel(const S* __restrict__ xi, const S* __restrict__ wh,
                const S* __restrict__ h0, const S* __restrict__ c0,
                S* __restrict__ h_all, S* __restrict__ c_all,
                S* __restrict__ gates, int T, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int b0 = (int)(blockIdx.x / MMK_LSTM_CLUSTER) * BC;
  const int U = H / MMK_LSTM_CLUSTER, NC = 4 * U, H4 = 4 * H;
  const int KS = MMK_LSTM_THREADS / NC;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  S* ws = reinterpret_cast<S*>(smem);   // (H, NC): ws[k*NC + j] = Wh[k, col(j)]
  float* hs = reinterpret_cast<float*>(ws + (size_t)H * NC);  // (BC, H): h_{t-1} of the group's rows
  float* hown = hs + BC * H;            // (2, BC, U): this block's new h, by step parity
  float* red = hown + 2 * BC * U;       // (KS, BC, NC): partial recurrent sums

  for (int idx = tid; idx < H * NC; idx += MMK_LSTM_THREADS) {
    const int k = idx / NC, j = idx % NC;
    ws[idx] = wh[(size_t)k * H4 + (j / U) * H + q * U + (j % U)];
  }
  for (int idx = tid; idx < BC * H; idx += MMK_LSTM_THREADS) {
    const int b = b0 + idx / H;
    hs[idx] = b < B ? mmk_ld(h0 + (size_t)b * H + idx % H) : 0.0f;
  }
  const bool own = tid < BC * U;
  const int r = own ? tid / U : 0, u = own ? tid % U : 0;
  const int b = b0 + r, hu = q * U + u;
  const bool valid = own && b < B;
  float c = valid ? mmk_ld(c0 + (size_t)b * H + hu) : 0.0f;
  float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (valid)
    for (int g = 0; g < 4; ++g) xv[g] = mmk_ld(xi + (size_t)b * H4 + g * H + hu);
  const int j = tid % NC, s = tid / NC;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (s < KS) {
      float acc[BC];
#pragma unroll
      for (int rr = 0; rr < BC; ++rr) acc[rr] = 0.0f;
      for (int k = s; k < H; k += KS) {
        const float w = mmk_ld(ws + k * NC + j);
#pragma unroll
        for (int rr = 0; rr < BC; ++rr) acc[rr] = fmaf(hs[rr * H + k], w, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < BC; ++rr) red[(s * BC + rr) * NC + j] = acc[rr];
    }
    __syncthreads();
    float* hnew = hown + (t & 1) * BC * U;
    if (own) {
      float z[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float v = xv[g];
        for (int ss = 0; ss < KS; ++ss) v += red[(ss * BC + r) * NC + g * U + u];
        z[g] = v;
      }
      const float ig = mmk_sigmoid(z[0]), fg = mmk_sigmoid(z[1]);
      const float gg = tanhf(z[2]), og = mmk_sigmoid(z[3]);
      c = fg * c + ig * gg;
      const float h = mmk_round<S>(og * tanhf(c));
      hnew[tid] = h;
      if (valid) {
        const size_t row = (size_t)t * B + b;
        mmk_st(h_all + row * H + hu, h);
        mmk_st(c_all + row * H + hu, c);
        S* gr = gates + row * H4 + hu;
        mmk_st(gr, ig);
        mmk_st(gr + H, fg);
        mmk_st(gr + 2 * H, gg);
        mmk_st(gr + 3 * H, og);
        if (t + 1 < T)
          for (int g = 0; g < 4; ++g) xv[g] = mmk_ld(xi + (row + B) * H4 + g * H + hu);
      }
    }
    cluster.sync();
    for (int idx = tid; idx < BC * H; idx += MMK_LSTM_THREADS) {
      const int rr = idx / H, k = idx % H;
      const float* src = cluster.map_shared_rank(hnew, k / U);
      hs[idx] = src[rr * U + k % U];
    }
    __syncthreads();
  }
  // no block may leave while another still reads its shared memory
  cluster.sync();
}

// Backward: the reverse-time walk.  A cluster of CL blocks (8 or 16) owns
// BC batch rows; block rank q owns hidden units [q*U, (q+1)*U), U = H/CL, and
// keeps the Wh columns of its 4U gates (the forward's slice), transposed:
// ws[j*HP + k] = Wh[k, col(j)], col(j) = (j/U)*H + q*U + j%U, rows padded to
// HP = H + 4 floats.  A step exchanges the reduction, not the input: each
// block multiplies its own dz (BC x 4U) by its slice into a partial dh over
// all H units, pushes each (BC x U) piece of it into the owner block's
// receive area (by step parity), and after one cluster barrier each owner
// adds its CL pieces in rank order.  Product task (kq, js): four consecutive
// units 4kq..4kq+3 (a float4 of a ws row: lanes of a warp read one row side
// by side) for every row, over the gate columns j = js, js + JS, ...; the JS
// slices meet in shared memory in slice order.  Pair owner p < BC*U (row
// p/U, unit p%U) carries dh and dc, and loads step t-2's gates, c and dh_all
// while it waits at step t's cluster barrier.  The sum order of
// dh_{t-1}[r, k] = sum_c dz[r, c] Wh[k, c] depends on H and CL only: every
// batch and cluster count sums alike.

// A walk step's inputs for one pair: its four gates, c_t, c_{t-1} and
// dh_all[t].
struct BwdIn {
  float ig, fg, gg, og, c, cp, dha;
};

// What a block's walk steps share: the stream pointers, the widths, the
// thread's roles and the block's shared memory (the kernel below says what
// each is).
template <typename S>
struct BwdCtx {
  const S *dh_all, *gates, *c_all, *c0;
  S* dxi;
  int B, H, U, NC, H4, HP, KQ, JS, q, b, hu, r, u, kq, js;
  bool own, valid, task;
  const S* ws;
  float *dzs, *red, *recv;
};

template <typename S>
__device__ __forceinline__ void bwd_load(const BwdCtx<S>& x, int t, BwdIn& in) {
  if (!x.valid || t < 0) return;
  const size_t row = (size_t)t * x.B + x.b;
  const S* gr = x.gates + row * x.H4 + x.hu;
  in.ig = mmk_ld(gr), in.fg = mmk_ld(gr + x.H), in.gg = mmk_ld(gr + 2 * x.H);
  in.og = mmk_ld(gr + 3 * x.H);
  in.c = mmk_ld(x.c_all + row * x.H + x.hu);
  in.cp = t > 0 ? mmk_ld(x.c_all + (row - x.B) * x.H + x.hu)
                : mmk_ld(x.c0 + (size_t)x.b * x.H + x.hu);
  in.dha = mmk_ld(x.dh_all + row * x.H + x.hu);
}

// Step t of the walk: dz from `in` and the carries, the partial product,
// the pushes, the split cluster barrier (with dxi[t]'s stores and step t-2's
// loads into `in` between its arrive and its wait), the owner's sum.
template <typename S, int CL, int BC>
__device__ __forceinline__ void bwd_step(const BwdCtx<S>& x, int t, BwdIn& in, float& dhc,
                                         float& dcc) {
  cg::cluster_group cluster = cg::this_cluster();
  const int par = t & 1, U = x.U, H = x.H;
  float dz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (x.own) {
    if (x.valid) {
      const float tc = tanhf(in.c);
      const float dh = in.dha + dhc;
      const float dc = dcc + dh * in.og * (1.0f - tc * tc);
      dz[0] = mmk_round<S>(dc * in.gg * in.ig * (1.0f - in.ig));
      dz[1] = mmk_round<S>(dc * in.cp * in.fg * (1.0f - in.fg));
      dz[2] = mmk_round<S>(dc * in.ig * (1.0f - in.gg * in.gg));
      dz[3] = mmk_round<S>(dh * tc * in.og * (1.0f - in.og));
      dcc = dc * in.fg;
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) x.dzs[(g * U + x.u) * BC + x.r] = dz[g];
  }
  __syncthreads();
  if (x.task) {
    float acc[BC][4];
#pragma unroll
    for (int rr = 0; rr < BC; ++rr)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[rr][i] = 0.0f;
#pragma unroll 4
    for (int j = x.js; j < x.NC; j += x.JS) {
      float w[4];
      mmk_ld4(x.ws + j * x.HP + 4 * x.kq, w);
      float d[BC];
      mmk_lds_rows<BC>(x.dzs + j * BC, d);
#pragma unroll
      for (int rr = 0; rr < BC; ++rr)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[rr][i] = fmaf(d[rr], w[i], acc[rr][i]);
    }
#pragma unroll
    for (int rr = 0; rr < BC; ++rr)
      *reinterpret_cast<float4*>(x.red + (size_t)(x.js * BC + rr) * H + 4 * x.kq) =
          make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < BC * x.KQ; p += MMK_LSTM_THREADS) {
    const int rr = p / x.KQ, k = 4 * (p % x.KQ);
    float4 v = *reinterpret_cast<const float4*>(x.red + (size_t)rr * H + k);
    for (int ss = 1; ss < x.JS; ++ss) {
      const float4 w = *reinterpret_cast<const float4*>(x.red + (size_t)(ss * BC + rr) * H + k);
      v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
    }
    float* piece = x.recv + ((par * CL + x.q) * BC + rr) * U;
    if (U % 4 == 0) {
      float* dst = cluster.map_shared_rank(piece, k / U) + k % U;
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cluster.map_shared_rank(piece, (k + i) / U)[(k + i) % U] = vv[i];
    }
  }
  // the cluster barrier, split: arrive (release: the pushes are seen after
  // the wait), store dxi[t] and load step t-2's inputs, wait (acquire).  A
  // device-memory access issued before the arrive would hold the arrive
  // until it completes; one whose value the next step needs would hold that
  // step.
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  if (x.valid) {
    S* dr = x.dxi + ((size_t)t * x.B + x.b) * x.H4 + x.hu;
    mmk_st(dr, dz[0]);
    mmk_st(dr + H, dz[1]);
    mmk_st(dr + 2 * H, dz[2]);
    mmk_st(dr + 3 * H, dz[3]);
  }
  bwd_load(x, t - 2, in);
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (x.own) {
    const float* rv = x.recv + (size_t)par * CL * BC * U + x.r * U + x.u;
    float v = 0.0f;
#pragma unroll
    for (int qq = 0; qq < CL; ++qq) v += rv[qq * BC * U];
    dhc = v;
  }
}

template <typename S, int CL, int BC>
__global__ void __launch_bounds__(MMK_LSTM_THREADS, 1)
lstm_bwd_kernel(const S* __restrict__ dh_all, const S* __restrict__ dh_T,
                const S* __restrict__ dc_T, const S* __restrict__ gates,
                const S* __restrict__ c_all, const S* __restrict__ c0,
                const S* __restrict__ wh, S* __restrict__ dxi,
                S* __restrict__ dh0, S* __restrict__ dc0, int T, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  BwdCtx<S> x;
  x.dh_all = dh_all, x.gates = gates, x.c_all = c_all, x.c0 = c0, x.dxi = dxi;
  x.B = B, x.H = H, x.U = H / CL, x.NC = 4 * x.U, x.H4 = 4 * H, x.HP = H + 4, x.KQ = H / 4;
  x.JS = MMK_LSTM_THREADS / x.KQ;
  x.q = (int)cluster.block_rank();
  const int tid = threadIdx.x, U = x.U, NC = x.NC;
  x.own = tid < BC * U;
  x.r = x.own ? tid / U : 0, x.u = x.own ? tid % U : 0;
  x.b = (int)(blockIdx.x / CL) * BC + x.r, x.hu = x.q * U + x.u;
  x.valid = x.own && x.b < B;
  x.kq = tid % x.KQ, x.js = tid / x.KQ;
  x.task = x.js < x.JS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ws = reinterpret_cast<S*>(smem_raw);                         // (NC, HP)
  x.ws = ws;
  x.dzs = reinterpret_cast<float*>(ws + (size_t)NC * x.HP);      // (NC, BC): this block's dz
  x.red = x.dzs + NC * BC;                                        // (JS, BC, H): partial dh
  x.recv = x.red + (size_t)x.JS * BC * H;                         // (2, CL, BC, U): pieces by parity

  for (int idx = tid; idx < H * NC; idx += MMK_LSTM_THREADS) {
    const int k = idx / NC, j = idx % NC;
    ws[j * x.HP + k] = wh[(size_t)k * x.H4 + (j / U) * H + x.q * U + (j % U)];
  }
  float dhc = x.valid ? mmk_ld(dh_T + (size_t)x.b * H + x.hu) : 0.0f;
  float dcc = x.valid ? mmk_ld(dc_T + (size_t)x.b * H + x.hu) : 0.0f;
  // steps T-1 and T-2 load before the walk; each step loads the inputs of the
  // step two on into the registers it has used, during its cluster barrier
  BwdIn ea = {}, eb = {};
  bwd_load(x, T - 1, ea);
  bwd_load(x, T - 2, eb);
  // every block has started (its shared memory may be written) and holds its slice
  cluster.sync();

  for (int t = T - 1; t >= 0; t -= 2) {
    bwd_step<S, CL, BC>(x, t, ea, dhc, dcc);
    if (t >= 1) bwd_step<S, CL, BC>(x, t - 1, eb, dhc, dcc);
  }
  if (x.valid) {
    mmk_st(dh0 + (size_t)x.b * H + x.hu, dhc);
    mmk_st(dc0 + (size_t)x.b * H + x.hu, dcc);
  }
}

// Partial dWh of rows [z*rows, (z+1)*rows) for z = blockIdx.z, on the tensor
// cores: part[z][m, n] = sum_r hprev[r, m] * dxi[r, n], where hprev row r is
// h0[r] for r < B and h_all[r - B] after (h_{t-1} of row (t, b)).  A block
// computes a 64 x 64 tile with 8 warps (16 x 32 each, two 16 x 16
// accumulators), stepping through its rows 32 at a time.  bf16 streams:
// bf16 products, f32 sums.  f32 streams: 3xTF32 (each operand split into a
// TF32 high part and the TF32 of what is left; hi*lo, lo*hi and hi*hi summed
// in f32), about as close as f32 products.  The partial tiles are f32
// whatever the stream type; the order of every sum is fixed, no atomics.
#define DWH_TM 64
#define DWH_TN 64
#define DWH_TK 32

// Four consecutive elements of a tile row from device memory, zero past `n`.
__device__ __forceinline__ void dwh_ld4(const float* p, int n, float* out) {
  if (n >= 4 && (reinterpret_cast<size_t>(p) & 15) == 0) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = i < n ? p[i] : 0.0f;
  }
}
__device__ __forceinline__ void dwh_ld4(const __nv_bfloat16* p, int n, __nv_bfloat16* out) {
  if (n >= 4 && (reinterpret_cast<size_t>(p) & 7) == 0) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    memcpy(out, &v, 8);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = i < n ? p[i] : __float2bfloat16(0.0f);
  }
}

// Four elements into a tile row of shared memory (16- or 8-byte aligned).
__device__ __forceinline__ void dwh_st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void dwh_st4(__nv_bfloat16* p, const __nv_bfloat16* v) {
  uint2 u;
  memcpy(&u, v, 8);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename S>
struct DwhMma;

template <>
struct DwhMma<float> {
  static constexpr int KSTEP = 8, PAD = 4;
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::col_major>;
  using Bf = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using C = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  template <class F>
  __device__ static void split(F& hi, F& lo) {
#pragma unroll
    for (int i = 0; i < hi.num_elements; ++i) {
      const float v = hi.x[i], h = wmma::__float_to_tf32(v);
      hi.x[i] = h;
      lo.x[i] = wmma::__float_to_tf32(v - h);
    }
  }
  __device__ static void step(C* acc, const float* a, int lda, const float* b, int ldb) {
    A ah, al;
    wmma::load_matrix_sync(ah, a, lda);
    split(ah, al);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      Bf bh, bl;
      wmma::load_matrix_sync(bh, b + 16 * f, ldb);
      split(bh, bl);
      wmma::mma_sync(acc[f], al, bh, acc[f]);
      wmma::mma_sync(acc[f], ah, bl, acc[f]);
      wmma::mma_sync(acc[f], ah, bh, acc[f]);
    }
  }
};

template <>
struct DwhMma<__nv_bfloat16> {
  static constexpr int KSTEP = 16, PAD = 8;
  using A = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
  using Bf = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using C = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  __device__ static void step(C* acc, const __nv_bfloat16* a, int lda, const __nv_bfloat16* b,
                              int ldb) {
    A af;
    wmma::load_matrix_sync(af, a, lda);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      Bf bf;
      wmma::load_matrix_sync(bf, b + 16 * f, ldb);
      wmma::mma_sync(acc[f], af, bf, acc[f]);
    }
  }
};

template <typename S>
__global__ void __launch_bounds__(256)
lstm_dwh_kernel(const S* __restrict__ h0, const S* __restrict__ h_all,
                const S* __restrict__ dxi, float* __restrict__ part, int R, int B, int M,
                int N, int rows) {
  using Mma = DwhMma<S>;
  constexpr int LD = DWH_TM + Mma::PAD;
  __shared__ __align__(32) unsigned char ab_raw[2 * DWH_TK * LD * sizeof(S)];
  __shared__ __align__(32) float Cs[DWH_TM][DWH_TN + 4];
  S(*As)[LD] = reinterpret_cast<S(*)[LD]>(ab_raw);  // As[k][m] = hprev[r0 + k, m0 + m]
  S(*Bs)[LD] = As + DWH_TK;                         // Bs[k][n] = dxi[r0 + k, n0 + n]
  const int m0 = blockIdx.y * DWH_TM, n0 = blockIdx.x * DWH_TN;
  const int r_begin = blockIdx.z * rows, r_end = min(R, r_begin + rows);
  const int tid = threadIdx.x, warp = tid / 32, wm = warp % 4, wn = warp / 4;
  typename Mma::C acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  // 32 rows x 16 quads of each tile, two quads a thread: the next rows load
  // into registers while the tensor cores work on these
  S ra[2][4], rb[2][4];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + 256 * i, kk = idx / (DWH_TM / 4), c4 = 4 * (idx % (DWH_TM / 4));
      const int rw = r0 + kk;
      const bool in = rw < r_end;
      const S* hrow = rw < B ? h0 + (size_t)rw * M : h_all + (size_t)(rw - B) * M;
      dwh_ld4(hrow + m0 + c4, in ? M - m0 - c4 : 0, ra[i]);
      dwh_ld4(dxi + (size_t)rw * N + n0 + c4, in ? N - n0 - c4 : 0, rb[i]);
    }
  };
  if (r_begin < r_end) fetch(r_begin);
  for (int r0 = r_begin; r0 < r_end; r0 += DWH_TK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + 256 * i, kk = idx / (DWH_TM / 4), c4 = 4 * (idx % (DWH_TM / 4));
      dwh_st4(&As[kk][c4], ra[i]);
      dwh_st4(&Bs[kk][c4], rb[i]);
    }
    __syncthreads();
    if (r0 + DWH_TK < r_end) fetch(r0 + DWH_TK);
#pragma unroll
    for (int kk = 0; kk < DWH_TK; kk += Mma::KSTEP)
      Mma::step(acc, &As[kk][16 * wm], LD, &Bs[kk][32 * wn], LD);
    __syncthreads();
  }
  wmma::store_matrix_sync(&Cs[16 * wm][32 * wn], acc[0], DWH_TN + 4, wmma::mem_row_major);
  wmma::store_matrix_sync(&Cs[16 * wm][32 * wn + 16], acc[1], DWH_TN + 4, wmma::mem_row_major);
  __syncthreads();
  float* out = part + (size_t)blockIdx.z * M * N;
  for (int idx = tid; idx < DWH_TM * DWH_TN; idx += 256) {
    const int mm = idx / DWH_TN, nn = idx % DWH_TN;
    if (m0 + mm < M && n0 + nn < N) out[(size_t)(m0 + mm) * N + n0 + nn] = Cs[mm][nn];
  }
}

// dwh[i] = sum_z part[z][i], z = 0 .. splits-1 in order, rounded once to S.
template <typename S>
__global__ void __launch_bounds__(256)
lstm_dwh_sum_kernel(const float* __restrict__ part, S* __restrict__ dwh, int splits,
                    int MN) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= MN) return;
  float v = 0.0f;
  for (int z = 0; z < splits; ++z) v += part[(size_t)z * MN + i];
  mmk_st(dwh + i, v);
}

// Shared memory of the forward for hidden size H, `bc` batch rows per
// cluster and `es` bytes a stream element (the Wh slice's type; the other
// buffers are f32); of the backward on clusters of `cl` blocks.
static size_t fwd_smem(int H, int bc, int es) {
  const int U = H / MMK_LSTM_CLUSTER, NC = 4 * U, KS = MMK_LSTM_THREADS / NC;
  return (size_t)es * H * NC +
         sizeof(float) * ((size_t)bc * H + 2 * bc * U + (size_t)KS * bc * NC);
}

static size_t bwd_smem(int H, int bc, int cl, int es) {
  const int U = H / cl, NC = 4 * U, JS = MMK_LSTM_THREADS / (H / 4);
  return (size_t)es * NC * (H + 4) +
         sizeof(float) * ((size_t)NC * bc + (size_t)JS * bc * H + 2 * (size_t)cl * bc * U);
}

template <typename K>
static int launch_cluster(K kernel, size_t smem, int B, int bc, cudaStream_t stream,
                          void** args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int clusters = (B + bc - 1) / bc;
  e = cudaLaunchKernel((const void*)kernel, dim3(clusters * MMK_LSTM_CLUSTER),
                       dim3(MMK_LSTM_THREADS), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename S>
static int forward(const void* xi_, const void* wh_, const void* h0_, const void* c0_,
                   void* h_all_, void* c_all_, void* gates_, int T, int B, int H, int bc,
                   cudaStream_t s) {
  const S *xi = (const S*)xi_, *wh = (const S*)wh_, *h0 = (const S*)h0_, *c0 = (const S*)c0_;
  S *h_all = (S*)h_all_, *c_all = (S*)c_all_, *gates = (S*)gates_;
  void* args[] = {&xi, &wh, &h0, &c0, &h_all, &c_all, &gates, &T, &B, &H};
  const size_t smem = fwd_smem(H, bc, sizeof(S));
  switch (bc) {
    case 1: return launch_cluster(lstm_fwd_kernel<S, 1>, smem, B, bc, s, args);
    case 2: return launch_cluster(lstm_fwd_kernel<S, 2>, smem, B, bc, s, args);
    case 4: return launch_cluster(lstm_fwd_kernel<S, 4>, smem, B, bc, s, args);
    case 8: return launch_cluster(lstm_fwd_kernel<S, 8>, smem, B, bc, s, args);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The walk on clusters of CL blocks launched with cudaLaunchKernelEx (16 is a
// non-portable cluster size); with `query` set, only the clusters of the
// card can hold at once, in *clusters.
template <typename S, int CL, int BC>
static int walk(void** args, int B, int H, cudaStream_t s, int* clusters, int query) {
  auto kernel = lstm_bwd_kernel<S, CL, BC>;
  const size_t smem = bwd_smem(H, BC, CL, sizeof(S));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(((B + BC - 1) / BC) * CL);
  cfg.blockDim = dim3(MMK_LSTM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (query) return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  e = cudaLaunchKernelExC(&cfg, (const void*)kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename S, int CL>
static int walk_rows(void** args, int B, int H, int bc, cudaStream_t s, int* clusters,
                     int query) {
  switch (bc) {
    case 1: return walk<S, CL, 1>(args, B, H, s, clusters, query);
    case 2: return walk<S, CL, 2>(args, B, H, s, clusters, query);
    case 4: return walk<S, CL, 4>(args, B, H, s, clusters, query);
    case 8: return walk<S, CL, 8>(args, B, H, s, clusters, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename S>
static int walk_any(void** args, int B, int H, int bc, int cl, cudaStream_t s, int* clusters,
                    int query) {
  switch (cl) {
    case 8: return walk_rows<S, 8>(args, B, H, bc, s, clusters, query);
    case 16: return walk_rows<S, 16>(args, B, H, bc, s, clusters, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename S>
static int backward(const void* dh_all_, const void* dh_T_, const void* dc_T_,
                    const void* gates_, const void* c_all_, const void* h_all_,
                    const void* h0_, const void* c0_, const void* wh_, void* dxi_, void* dwh_,
                    float* dwh_part, void* dh0_, void* dc0_, int T, int B, int H, int bc,
                    int cl, int splits, cudaStream_t s) {
  const S *dh_all = (const S*)dh_all_, *dh_T = (const S*)dh_T_, *dc_T = (const S*)dc_T_;
  const S *gates = (const S*)gates_, *c_all = (const S*)c_all_, *h_all = (const S*)h_all_;
  const S *h0 = (const S*)h0_, *c0 = (const S*)c0_, *wh = (const S*)wh_;
  S *dxi = (S*)dxi_, *dwh = (S*)dwh_, *dh0 = (S*)dh0_, *dc0 = (S*)dc0_;
  void* args[] = {&dh_all, &dh_T, &dc_T, &gates, &c_all, &c0, &wh, &dxi, &dh0, &dc0,
                  &T, &B, &H};
  int clusters = 0;
  int err = walk_any<S>(args, B, H, bc, cl, s, &clusters, 0);
  if (err != 0) return err;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const int M = H, N = 4 * H, R = T * B;
  const int rows = (R + splits - 1) / splits;
  const dim3 grid((N + DWH_TN - 1) / DWH_TN, (M + DWH_TM - 1) / DWH_TM, splits);
  // f32 with one split writes dWh directly; otherwise partial tiles, summed
  // (and, for bf16, rounded) by the second kernel
  const bool direct = splits == 1 && sizeof(S) == sizeof(float);
  lstm_dwh_kernel<S><<<grid, 256, 0, s>>>(h0, h_all, dxi, direct ? (float*)dwh : dwh_part, R, B,
                                          M, N, rows);
  if (!direct) {
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    lstm_dwh_sum_kernel<S><<<(M * N + 255) / 256, 256, 0, s>>>(dwh_part, dwh, splits, M * N);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// Shared memory (bytes) the forward needs for hidden size H, `bc` batch rows
// per cluster and `es` bytes a stream element (4 or 2), and the backward on
// clusters of `cl` blocks; the wrapper checks them against the card.
long long mmk_lstm_fwd_smem(int H, int bc, int es) { return (long long)fwd_smem(H, bc, es); }
long long mmk_lstm_bwd_smem(int H, int bc, int cl, int es) {
  return (long long)bwd_smem(H, bc, cl, es);
}

// The clusters of `cl` blocks (`bc` rows each) the card holds at once for
// the backward walk at hidden size H, or minus the cudaError_t of the query.
int mmk_lstm_bwd_clusters(int H, int bc, int cl, int bf16) {
  int n = 0;
  const int err = bf16 ? walk_any<__nv_bfloat16>(nullptr, bc, H, bc, cl, 0, &n, 1)
                       : walk_any<float>(nullptr, bc, H, bc, cl, 0, &n, 1);
  return err != 0 ? -err : n;
}

// Each entry launches on `stream` (PyTorch's current stream), does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
// `bf16` picks the stream type: every tensor argument is __nv_bfloat16 if it
// is set, float otherwise (dwh_part is f32 either way).
int mmk_lstm_forward(const void* xi, const void* wh, const void* h0, const void* c0,
                     void* h_all, void* c_all, void* gates, int T, int B, int H, int bc,
                     int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? forward<__nv_bfloat16>(xi, wh, h0, c0, h_all, c_all, gates, T, B, H, bc, s)
              : forward<float>(xi, wh, h0, c0, h_all, c_all, gates, T, B, H, bc, s);
}

// The reverse-time walk (dxi, dh0, dc0) on clusters of `cl` blocks, `bc`
// rows each, then dWh over the stored dxi in `splits` row ranges (partial
// tiles in `dwh_part`, splits x H x 4H f32, summed into dwh; with one split
// and f32 streams dwh is written directly and dwh_part unused).
int mmk_lstm_backward(const void* dh_all, const void* dh_T, const void* dc_T,
                      const void* gates, const void* c_all, const void* h_all,
                      const void* h0, const void* c0, const void* wh, void* dxi, void* dwh,
                      float* dwh_part, void* dh0, void* dc0, int T, int B, int H, int bc,
                      int cl, int splits, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? backward<__nv_bfloat16>(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, wh,
                                        dxi, dwh, dwh_part, dh0, dc0, T, B, H, bc, cl, splits,
                                        s)
              : backward<float>(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, wh, dxi, dwh,
                                dwh_part, dh0, dc0, T, B, H, bc, cl, splits, s);
}

const char* mmk_lstm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
