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
// Forward (8 or 16 blocks a cluster, ops/fused_lstm.py's LSTM_FWD_ROUTE):
// each block computes its units' gates for the group's rows from the whole
// h_{t-1}.  A version of this kernel gathered the new h after each step, a
// scalar remote load at a time after a full cluster barrier, and summed its
// products with a scalar load of the slice and of h for every FMA, the
// partial sums meeting in shared memory behind a block barrier: ~5.7 us a
// step.  Now each block pushes its new h (BC x H/CL) into every block's
// buffer for the next step (two buffers, by step parity), so one split
// cluster barrier a step is safe, with the step's device stores and the load
// of the xi two steps on between its arrive and its wait; f32 products read
// the slice and h 16 bytes at a time without bank conflicts, the partial
// sums meeting by shuffles inside a warp; bf16 products run on the tensor
// cores (mma.sync, bf16 in, f32 sums).  Limits: H a multiple of the cluster
// size and of 4, BC x H/CL <= 256, bf16 at most 32 units a block, and the
// slice (4H/CL rows of about H + 8 elements) plus the h buffers within 227 KB.
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
// The wide route (K3a-wide, K3b-wide; ops/fused_lstm.py's lstm_route sends a
// layer there where the cluster plans refuse it and H is a multiple of 128 up
// to 1,024): Wh no longer fits a cluster (4 MiB at H = 512 in f32), so one
// cooperative launch of 128 blocks in clusters of 2 spreads it over the
// card's shared memory (H/128 units a block) and a grid barrier ends each
// step; the forward fetches h once a cluster by multicast bulk copies, the
// backward reduce-scatters each block's partial dh through the cluster and a
// small exchange in device memory.  The section "the wide route" below says
// more.

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

#define MMK_LSTM_THREADS 256

__device__ __forceinline__ float mmk_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Loads and stores of the stream type S, in f32 registers; `mmk_round<S>`
// rounds an f32 value to S and back (the identity for float).
__device__ __forceinline__ float mmk_ld(const float* p) { return *p; }
__device__ __forceinline__ float mmk_ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void mmk_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void mmk_st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
template <typename S>
__device__ __forceinline__ S mmk_from_float(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 mmk_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
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

// Forward.  A cluster of CL blocks (8 or 16) owns batch rows [b0, b0 + BC);
// block rank q owns hidden units [q*U, (q+1)*U), U = H/CL, i.e. the gate
// columns g*H + q*U + u of Wh, and keeps them in shared memory for the whole
// walk.  Every block holds the whole h_{t-1} of the group's rows in one of
// two buffers (by step parity).  Step t: the block's product z = h_{t-1} Wh
// over its columns, the cell of each (row, unit) it owns, then its new h
// pushed into the other parity's buffer of every block of the cluster
// (itself too), and one cluster barrier, split: h, c and the gates of step t
// are stored and xi of step t+2 is loaded between its arrive and its wait.
// A block pushing at step t has passed barrier t-1, so every peer has
// finished step t-1's product, the last reader of that buffer.
//
// f32 streams: the product on the CUDA cores.  The slice is stored gate-major
// and transposed, ws[(g*U + u)*HP + k] = Wh[k, g*H + q*U + u]; a warp owns
// UW units and splits k among KSW = 32/UW lanes a unit (lane = ks*UW + uw),
// each lane summing the four gates of its unit for every row over the float4
// chunks c = ks, ks + KSW, ... of k: per chunk four 16-byte loads of the
// slice (row pitch HP puts a phase's eight lanes on distinct banks) and one
// of h a row (a broadcast).  The KSW partial sums of a unit meet by shuffles
// inside the warp: the rows are split among the lanes first (log2 BC
// halving steps), the rest is a butterfly, so that each of the KSW/BC lanes
// of a (row, unit) holds its four sums; the first of them owns the pair.
// bf16 streams: the product on the tensor cores, mma.sync m16n8k16 (bf16
// in, f32 sums): warp w's 16 gate columns (units 4w .. 4w+3, m = g*4 + u%4)
// are M, the cluster's rows (BC padded to 8) N, k in tiles of 16; the A
// fragments of the first 16 tiles (8 on clusters of 16) stay in registers,
// the B fragments come from the bf16 h buffer (rows padded to 8, zero).
// Lane l holds two gates of (unit (l>>2)&3, rows 2(l&3) and 2(l&3)+1); one
// exchange with lane l^16 gives it the four gates of one of them.
// The stream type's h (bf16: rounded once) is what the buffers carry.


__host__ __device__ inline int mmk_pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// The forward's layout for hidden size H on clusters of `cl` blocks.  f32:
// lanes a unit KSW (a power of two, U*KSW <= 256 threads), units a warp UW,
// the slice's row pitch HP.  bf16: warps with columns NWM (4 units each),
// k padded to KP, the pitch HB of the slice's rows and of the h buffers'
// (in elements; HB/2 = 4 mod 32 words keeps a fragment load on 32 banks).
struct FwdShape {
  int U, KSW, UW, HP, NWM, KP, HB;
};

__host__ __device__ inline FwdShape fwd_shape(int H, int cl) {
  FwdShape s;
  s.U = H / cl;
  const int per = s.U > 0 ? MMK_LSTM_THREADS / s.U : 1;
  s.KSW = mmk_pow2_floor(per < 1 ? 1 : (per > 32 ? 32 : per));
  s.UW = 32 / s.KSW;
  s.HP = (H + 31) / 32 * 32 + (s.UW >= 8 ? 4 : (32 / s.UW) % 32);
  s.NWM = (s.U + 3) / 4;
  s.KP = (H + 15) / 16 * 16;
  s.HB = (s.KP + 63) / 64 * 64 + 8;
  return s;
}

// The product of one step for the lane's (row, unit): z[g] = sum_k h[r, k]
// Wh[k, g*H + q*U + u], g = i, f, g, o.
template <typename S, int CL, int BC>
struct FwdProduct;

template <int CL, int BC>
struct FwdProduct<float, CL, BC> {
  const float* w0;  // the lane's unit's row of gate i in the slice
  int H, HP, U, UW, KSW, lane, u, cs;
  // which (row, unit) the lane's sums are for, and whether it owns the pair
  __device__ void init(const FwdShape& sh, int H_, int warp, int lane_, int* r, int* u_,
                       bool* own) {
    H = H_, HP = sh.HP, U = sh.U, UW = sh.UW, KSW = sh.KSW, lane = lane_;
    const int uw = lane % UW, ks = lane / UW, per = KSW / BC;
    u = warp * UW + uw;
    cs = u < U ? ks : H;  // lanes past the units sum nothing but join the shuffles
    *u_ = u, *r = ks / per;
    *own = u < U && ks % per == 0;
  }
  __device__ void load(const float* ws, int) { w0 = ws + (size_t)(u < U ? u : 0) * HP; }
  __device__ __forceinline__ void run(const float* hs, float* z) const {
    float v[4 * BC];
#pragma unroll
    for (int i = 0; i < 4 * BC; ++i) v[i] = 0.0f;
    const size_t gs = (size_t)U * HP;
    const int nch = H / 4;
#pragma unroll 2
    for (int c = cs; c < nch; c += KSW) {
      float4 w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = *reinterpret_cast<const float4*>(w0 + g * gs + 4 * c);
#pragma unroll
      for (int rr = 0; rr < BC; ++rr) {
        const float4 h = *reinterpret_cast<const float4*>(hs + rr * H + 4 * c);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float& a = v[rr * 4 + g];
          a = fmaf(h.x, w[g].x, a);
          a = fmaf(h.y, w[g].y, a);
          a = fmaf(h.z, w[g].z, a);
          a = fmaf(h.w, w[g].w, a);
        }
      }
    }
    // split the rows among the lanes of a unit (high ks bits first) ...
#pragma unroll
    for (int l = 0; (BC >> (l + 1)) > 0; ++l) {
      constexpr int n = 4 * BC;
      const int half = 4 * (BC >> (l + 1)), off = (KSW >> (l + 1)) * UW;
      const bool up = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        if (i < half) {
          const float keep = up ? v[i + half] : v[i], send = up ? v[i] : v[i + half];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
    }
    // ... then sum the four gates over the lanes left
    for (int off = (KSW / BC / 2) * UW; off >= UW && off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < 4; ++g) v[g] += __shfl_xor_sync(0xffffffffu, v[g], off);
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g] = v[g];
  }
};

__device__ __forceinline__ void mmk_mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7},"
      " {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CL, int BC>
struct FwdProduct<__nv_bfloat16, CL, BC> {
  // k tiles whose A fragments stay in registers: 16 (H <= 256) on clusters of
  // 8; 8 on 16, whose blocks share an SM two by two only within 128 registers
  static constexpr int KTR = CL == 8 ? 16 : 8;
  uint32_t af[KTR][4];
  const uint32_t* wsw;  // the lane's first A word in the slice
  int KT, HBW, lane, G, boff;
  bool active;
  __device__ void init(const FwdShape& sh, int H, int warp, int lane_, int* r, int* u,
                       bool* own) {
    lane = lane_, KT = sh.KP / 16, HBW = sh.HB / 2, G = (lane >> 4) & 1;
    active = warp < sh.NWM;
    *u = 4 * warp + ((lane >> 2) & 3), *r = 2 * (lane & 3) + G;
    *own = active && *u < sh.U && *r < BC;
    boff = (lane >> 2) * HBW + (lane & 3);
    (void)H;
  }
  // after the slice is in shared memory: the A fragments into registers
  __device__ void load(const __nv_bfloat16* ws, int warp) {
    wsw = reinterpret_cast<const uint32_t*>(ws) + (size_t)(warp * 16 + (lane >> 2)) * HBW +
          (lane & 3);
    if (!active) return;
#pragma unroll
    for (int kt = 0; kt < KTR; ++kt) {
      if (kt < KT) {
        const uint32_t* p = wsw + kt * 8;
        af[kt][0] = p[0], af[kt][1] = p[8 * HBW], af[kt][2] = p[4], af[kt][3] = p[8 * HBW + 4];
      }
    }
  }
  __device__ __forceinline__ void run(const __nv_bfloat16* hs, float* z) const {
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    if (active) {
      const uint32_t* hw = reinterpret_cast<const uint32_t*>(hs) + boff;
#pragma unroll
      for (int kt = 0; kt < KTR; ++kt)
        if (kt < KT) mmk_mma_bf16(acc[kt & 3], af[kt], hw[kt * 8], hw[kt * 8 + 4]);
      for (int kt = KTR; kt < KT; kt += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kt + j < KT) {
            const uint32_t* p = wsw + (kt + j) * 8;
            const uint32_t a[4] = {p[0], p[8 * HBW], p[4], p[8 * HBW + 4]};
            mmk_mma_bf16(acc[j], a, hw[(kt + j) * 8], hw[(kt + j) * 8 + 4]);
          }
        }
      }
    }
    float c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
    // c0, c1: gate G of rows 2(l&3), +1; c2, c3: gate G + 2.  Lane l^16 holds
    // gates 1 - G and 3 - G of the same rows.
    const float s0 = G ? c[0] : c[1], s1 = G ? c[2] : c[3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 16);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 16);
    z[0] = G ? r0 : c[0];
    z[1] = G ? c[1] : r0;
    z[2] = G ? r1 : c[2];
    z[3] = G ? c[3] : r1;
  }
};

// The inputs of a step for the lane's pair: xi's four gates.
struct FwdIn {
  float x[4];
};

// What a block's forward steps share (the kernel below says what each is).
template <typename S, int CL, int BC>
struct FwdCtx {
  const S* xi;
  S *h_all, *c_all, *gates, *hst;
  S* hs;  // the h buffers, (2, rows, HS)
  int B, H, H4, U, HS, q, b, hu, r, u, u0, nu, vb;
  bool own, valid, pusher;
  FwdProduct<S, CL, BC> prod;
};

template <typename S, int CL, int BC>
__device__ __forceinline__ void fwd_load(const FwdCtx<S, CL, BC>& x, int t, int T, FwdIn& in) {
  if (!x.valid || t >= T) return;
  const S* p = x.xi + ((size_t)t * x.B + x.b) * x.H4 + x.hu;
#pragma unroll
  for (int g = 0; g < 4; ++g) in.x[g] = mmk_ld(p + g * x.H);
}

// Copies `bytes` bytes from local shared memory to (a peer's) shared memory
// in pieces of `vb` bytes (16, 8, 4 or 2; both addresses aligned to it).
__device__ __forceinline__ void fwd_copy(void* dst, const void* src, int bytes, int vb) {
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  for (int o = 0; o < bytes; o += vb) {
    if (vb == 16)
      *reinterpret_cast<uint4*>(d + o) = *reinterpret_cast<const uint4*>(s + o);
    else if (vb == 8)
      *reinterpret_cast<uint2*>(d + o) = *reinterpret_cast<const uint2*>(s + o);
    else if (vb == 4)
      *reinterpret_cast<uint32_t*>(d + o) = *reinterpret_cast<const uint32_t*>(s + o);
    else
      *reinterpret_cast<unsigned short*>(d + o) = *reinterpret_cast<const unsigned short*>(s + o);
  }
}

// Step t: the product over h_{t-1} (buffer t&1), the cell, the push of the
// new h into every block's buffer (t+1)&1, the split cluster barrier with
// step t's stores and step t+2's loads (into `in`) between arrive and wait.
template <typename S, int CL, int BC>
__device__ __forceinline__ void fwd_step(FwdCtx<S, CL, BC>& x, int t, int T, FwdIn& in,
                                         float& c) {
  cg::cluster_group cluster = cg::this_cluster();
  const int par = t & 1;
  const S* hcur = x.hs + (size_t)par * (sizeof(S) == 2 ? 8 : BC) * x.HS;
  S* hnext = x.hs + (size_t)(par ^ 1) * (sizeof(S) == 2 ? 8 : BC) * x.HS;
  float z[4];
  x.prod.run(hcur, z);
  float ig = 0.0f, fg = 0.0f, gg = 0.0f, og = 0.0f, h = 0.0f;
  if (x.own) {
    ig = mmk_sigmoid(in.x[0] + z[0]);
    fg = mmk_sigmoid(in.x[1] + z[1]);
    gg = tanhf(in.x[2] + z[2]);
    og = mmk_sigmoid(in.x[3] + z[3]);
    c = fg * c + ig * gg;
    h = mmk_round<S>(og * tanhf(c));
    mmk_st(x.hst + x.r * x.U + x.u, h);
  }
  __syncwarp();
  if (x.pusher) {
    // the warp's units [u0, u0 + nu) of every row, to every block
    const int lane = threadIdx.x & 31, bytes = x.nu * (int)sizeof(S);
    for (int e = lane; e < BC * CL; e += 32) {
      const int rr = e / CL, pq = e % CL;
      S* dst = cluster.map_shared_rank(hnext + rr * x.HS + x.q * x.U + x.u0, pq);
      fwd_copy(dst, x.hst + rr * x.U + x.u0, bytes, x.vb);
    }
  }
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  if (x.valid) {
    const size_t row = (size_t)t * x.B + x.b;
    mmk_st(x.h_all + row * x.H + x.hu, h);
    mmk_st(x.c_all + row * x.H + x.hu, c);
    S* gr = x.gates + row * x.H4 + x.hu;
    mmk_st(gr, ig);
    mmk_st(gr + x.H, fg);
    mmk_st(gr + 2 * x.H, gg);
    mmk_st(gr + 3 * x.H, og);
  }
  fwd_load(x, t + 2, T, in);
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <typename S, int CL, int BC>
__global__ void __launch_bounds__(MMK_LSTM_THREADS, CL == 16 ? 2 : 1)
lstm_fwd_kernel(const S* __restrict__ xi, const S* __restrict__ wh,
                const S* __restrict__ h0, const S* __restrict__ c0,
                S* __restrict__ h_all, S* __restrict__ c_all,
                S* __restrict__ gates, int T, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr bool BF = sizeof(S) == 2;
  constexpr int HR = BF ? 8 : BC;  // rows of an h buffer
  const FwdShape sh = fwd_shape(H, CL);
  const int U = sh.U, H4 = 4 * H;
  const int q = (int)cluster.block_rank(), b0 = (int)(blockIdx.x / CL) * BC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  FwdCtx<S, CL, BC> x;
  x.xi = xi, x.h_all = h_all, x.c_all = c_all, x.gates = gates;
  x.B = B, x.H = H, x.H4 = H4, x.U = U, x.q = q;
  x.HS = BF ? sh.HB : H;
  const int wrows = BF ? 16 * sh.NWM : 4 * U;  // rows of the slice
  const int wpitch = BF ? sh.HB : sh.HP;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ws = reinterpret_cast<S*>(smem_raw);              // the slice, (wrows, wpitch)
  x.hs = ws + (size_t)wrows * wpitch;                   // (2, HR, HS): h by step parity
  x.hst = x.hs + (size_t)2 * HR * x.HS;                 // (BC, U): this block's new h

  int r, u;
  bool own;
  x.prod.init(sh, H, warp, lane, &r, &u, &own);
  x.r = r < BC ? r : 0, x.u = u < U ? u : 0, x.own = own;
  x.b = b0 + x.r, x.hu = q * U + x.u;
  x.valid = own && x.b < B;
  // the units whose new h this warp pushes
  x.u0 = warp * (BF ? 4 : sh.UW);
  x.nu = x.u0 < U ? min(U - x.u0, BF ? 4 : sh.UW) : 0;
  x.pusher = x.nu > 0;
  {
    const int es = (int)sizeof(S);
    const int al = (x.nu * es) | (x.u0 * es) | (U * es) | (x.HS * es) | 16;
    x.vb = al & -al;  // the largest power of two (<= 16) dividing them all
  }

  // the slice (loads unrolled: each waits on L2 otherwise, ~50 us a launch)
  if (BF) {
#pragma unroll 8
    for (int idx = tid; idx < wrows * wpitch; idx += MMK_LSTM_THREADS) {
      const int k = idx / wrows, jj = idx % wrows;
      const int w = jj / 16, m = jj % 16, uu = 4 * w + (m & 3), g = m >> 2;
      ws[(size_t)jj * wpitch + k] = (uu < U && k < H)
                                        ? wh[(size_t)k * H4 + g * H + q * U + uu]
                                        : mmk_from_float<S>(0.0f);
    }
  } else {
#pragma unroll 8
    for (int idx = tid; idx < H * 4 * U; idx += MMK_LSTM_THREADS) {
      const int k = idx / (4 * U), j = idx % (4 * U), g = j / U, uu = j % U;
      ws[(size_t)j * wpitch + k] = wh[(size_t)k * H4 + g * H + q * U + uu];
    }
  }
  for (int idx = tid; idx < 2 * HR * x.HS; idx += MMK_LSTM_THREADS) {
    const int p = idx / (HR * x.HS), rr = (idx / x.HS) % HR, k = idx % x.HS;
    x.hs[idx] = (p == 0 && rr < BC && k < H && b0 + rr < B) ? h0[(size_t)(b0 + rr) * H + k]
                                                            : mmk_from_float<S>(0.0f);
  }
  float c = x.valid ? mmk_ld(c0 + (size_t)x.b * H + x.hu) : 0.0f;
  FwdIn xa = {}, xb = {};
  fwd_load(x, 0, T, xa);
  fwd_load(x, 1, T, xb);
  __syncthreads();
  x.prod.load(ws, warp);
  // every block has started (its shared memory may be written) and holds its slice
  cluster.sync();

  for (int t = 0; t < T; t += 2) {
    fwd_step<S, CL, BC>(x, t, T, xa, c);
    if (t + 1 < T) fwd_step<S, CL, BC>(x, t + 1, T, xb, c);
  }
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
// cluster, clusters of `cl` blocks and `es` bytes a stream element: the
// slice, the two h buffers and the block's new h, all of the stream type;
// of the backward likewise.
static size_t fwd_smem(int H, int bc, int cl, int es) {
  const FwdShape s = fwd_shape(H, cl);
  if (es == 4)
    return sizeof(float) * ((size_t)4 * s.U * s.HP + 2 * (size_t)bc * H + (size_t)bc * s.U);
  return 2 * ((size_t)16 * s.NWM * s.HB + 2 * 8 * (size_t)s.HB + (size_t)bc * s.U);
}

static size_t bwd_smem(int H, int bc, int cl, int es) {
  const int U = H / cl, NC = 4 * U, JS = MMK_LSTM_THREADS / (H / 4);
  return (size_t)es * NC * (H + 4) +
         sizeof(float) * ((size_t)NC * bc + (size_t)JS * bc * H + 2 * (size_t)cl * bc * U);
}

// Launches `kernel` on clusters of CL blocks, `bc` rows each, with
// cudaLaunchKernelEx (16 is a non-portable cluster size); with `query` set,
// only the clusters the card can hold at once, in *clusters.
template <int CL, typename K>
static int launch_clusters(K kernel, size_t smem, void** args, int B, int bc, cudaStream_t s,
                           int* clusters, int query) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(((B + bc - 1) / bc) * CL);
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

// The forward's limits (ops/fused_lstm.py's lstm_fwd_plan raises outside
// them): H a multiple of the cluster size and of 4, a lane a (row, unit)
// after the product (bc * U <= 256), bf16 at most 8 warps of 4 units.
static bool fwd_fits(int H, int bc, int cl, int es) {
  const int U = H / cl;
  return H >= cl && H % cl == 0 && H % 4 == 0 && bc * U <= MMK_LSTM_THREADS &&
         (es == 4 || U <= 32);
}

template <typename S, int CL>
static int fwd_rows(void** args, int B, int H, int bc, cudaStream_t s, int* clusters,
                    int query) {
  const size_t smem = fwd_smem(H, bc, CL, sizeof(S));
  switch (bc) {
    case 1: return launch_clusters<CL>(lstm_fwd_kernel<S, CL, 1>, smem, args, B, bc, s, clusters, query);
    case 2: return launch_clusters<CL>(lstm_fwd_kernel<S, CL, 2>, smem, args, B, bc, s, clusters, query);
    case 4: return launch_clusters<CL>(lstm_fwd_kernel<S, CL, 4>, smem, args, B, bc, s, clusters, query);
    case 8: return launch_clusters<CL>(lstm_fwd_kernel<S, CL, 8>, smem, args, B, bc, s, clusters, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename S>
static int fwd_any(void** args, int B, int H, int bc, int cl, cudaStream_t s, int* clusters,
                   int query) {
  if (!fwd_fits(H, bc, cl, sizeof(S))) return (int)cudaErrorInvalidValue;
  switch (cl) {
    case 8: return fwd_rows<S, 8>(args, B, H, bc, s, clusters, query);
    case 16: return fwd_rows<S, 16>(args, B, H, bc, s, clusters, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename S>
static int forward(const void* xi_, const void* wh_, const void* h0_, const void* c0_,
                   void* h_all_, void* c_all_, void* gates_, int T, int B, int H, int bc,
                   int cl, cudaStream_t s) {
  const S *xi = (const S*)xi_, *wh = (const S*)wh_, *h0 = (const S*)h0_, *c0 = (const S*)c0_;
  S *h_all = (S*)h_all_, *c_all = (S*)c_all_, *gates = (S*)gates_;
  void* args[] = {&xi, &wh, &h0, &c0, &h_all, &c_all, &gates, &T, &B, &H};
  return fwd_any<S>(args, B, H, bc, cl, s, nullptr, 0);
}

// The walk on clusters of CL blocks (see launch_clusters).
template <typename S, int CL, int BC>
static int walk(void** args, int B, int H, cudaStream_t s, int* clusters, int query) {
  return launch_clusters<CL>(lstm_bwd_kernel<S, CL, BC>, bwd_smem(H, BC, CL, sizeof(S)), args,
                             B, BC, s, clusters, query);
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

// dWh = hprev^T dxi over the stored dxi (lstm_dwh_kernel), in `splits` row
// ranges whose partial tiles lstm_dwh_sum_kernel adds (f32 with one
// split writes dwh directly).
template <typename S>
static int dwh_product(const S* h0, const S* h_all, const S* dxi, S* dwh, float* dwh_part, int T,
                       int B, int H, int splits, cudaStream_t s) {
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
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    lstm_dwh_sum_kernel<S><<<(M * N + 255) / 256, 256, 0, s>>>(dwh_part, dwh, splits, M * N);
  }
  return (int)cudaGetLastError();
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
  return dwh_product<S>(h0, h_all, dxi, dwh, dwh_part, T, B, H, splits, s);
}

// -- the wide route: K3a-wide and K3b-wide ------------------------------------------
//
// H a multiple of 128 up to 1,024, where a cluster's 16 x 227 KB cannot hold
// Wh (4 MiB in f32 at H = 512, 16 MiB at 1,024).  One launch of
// MMK_WIDE_BLOCKS blocks, one a streaming multiprocessor, in thread-block
// clusters of MMK_WIDE_CL: block q owns the U = H/128 hidden units
// [q*U, (q+1)*U) of every batch row and keeps the Wh columns of its units'
// four gates in shared memory for the whole walk (the forward as ws[j][k],
// the backward as wt[k][j], Wh[k, (j/U)*H + q*U + j%U], j < NJ = 4U); a grid
// barrier (cooperative groups') ends each step.  The launch carries the
// cluster dimension and the cooperative attribute (cudaLaunchKernelEx), so
// that every block is resident at once or the launch is refused.  Clusters
// of 2: an H100's 132 SMs hold 66 clusters of 2 blocks of this size but only
// 30 of 4 and 15 of 8 (120 blocks; tools/wide_cluster_probe.py).
//
// Where the previous wide kernels spent a step on an H100 (f32 at (T, B,
// H) = (256, 32, 512), tools/profile_lstm_wide.py: ~9.4 us forward, ~16
// walk): every block staged the whole previous h (dz in the walk: 4H a row)
// from L2 through its registers in tiles of 16 rows, multiplied on the CUDA
// cores (bf16 too), and one thread added each sum's 16 partials in a chain.
// Here:
//
// A step takes the batch in passes of RP rows (32, or 16 where 32 do not fit
// in shared memory; B = 32 is one pass, and more rows only take more passes)
// and runs its products on the tensor cores: mma.sync m16n8k16 on bf16
// streams (bf16 in, f32 sums), m16n8k8 in 3xTF32 on f32 streams (each
// operand split into a TF32 high part, rounded by an integer add, and the
// rest; lo*hi and hi*lo summed apart from hi*hi, then added: about as close
// as f32 products), the batch rows as M.  Every row of a 32-bit word pitch 4
// mod 32 (H + 4 floats, H + 8 bf16) keeps a fragment's loads on 32 banks.
// The tile counts are template arguments: predicated tiles were serialised
// by the compiler through one accumulator.
//
// Forward: the product z = h_{t-1} Wh over the block's gate columns (M rows,
// N the columns in tiles of 8, K = H split among the 8 warps, each warp's
// partial sums into shared memory; the cell thread of a (row, unit) adds the
// 8 warps' in a fixed tree, then runs the cell).  h_{t-1} comes from h_all
// (h0 at t = 0) through L2 once a cluster: after the step's grid barrier
// each block copies its share of the pass's rows with the bulk copy engine
// (cp.async.bulk, multicast to the cluster's blocks), each block's mbarrier
// counting the bytes of all rows.  A pass after another first waits at a
// cluster barrier for every peer to be done with the buffer.  With one pass
// a step the cell keeps c in a register and stores c and the gates after the
// next grid barrier, which then waits for the h stores alone.
//
// Backward: dh_{t-1}[b, k] = sum_c dz_t[b, c] Wh[k, c] needs every gate
// column's dz; a block holds its own (B x 4U) where it makes it, and the
// columns of Wh that multiply it.  Its product (M rows, N = H in tiles of 8
// split among the warps, K = 4U) is a partial dh over all H units, which is
// reduce-scattered: each block stores the columns that rank r of its cluster
// sums into r's shared memory (st.async, 16 bytes a lane, counted on r's
// mbarrier; its own piece with plain stores), rank r adds the CL pieces in
// rank order and stores the cluster's sum of its H/CL columns into a device
// exchange (two parities by step, laid out by owner block, consecutive
// threads on consecutive addresses); after the grid barrier the owner of a
// unit adds the 128/CL clusters' sums in up to eight groups, each in
// cluster order, then the groups in order.  A step moves B x H x 4 bytes a
// block through the cluster and B x H x 4 x 128/CL through L2 (the whole dz,
// 4H a row, is never read back).  With one pass a step the cell keeps dc in
// a register and loads step t-1's inputs during step t.  dWh runs after the
// walk on K3b's WMMA kernel.
//
// The cell rounds each operation where the plain version does, in its order
// (__fmul_rn, __fadd_rn: no contraction into FMAs), so that only the
// products' sums part from it; on bf16 streams every rounding flipped by a
// sum in another order feeds the later steps.  With more than one pass a
// step the f32 carries (c forward, dc backward) live in a workspace in device
// memory that only the thread of the (row, unit) reads and writes.  No
// atomics: every sum's order depends on H, the stream type and the cluster
// size only.
#ifndef MMK_WIDE_OFF
// parts of the step taken out (bits, tools/profile_lstm_wide.py): 1 the
// product, 2 the L2 traffic, 4 the cluster exchange, 8 the partial sums'
// reduction, 16 the cell, 32 the grid barrier, 64 the dWh product
#define MMK_WIDE_OFF 0
#endif
#define MMK_WIDE_BLOCKS 128
#ifndef MMK_WIDE_CL
// blocks a cluster (tools/profile_lstm_wide.py times a copy built with 1)
#define MMK_WIDE_CL 2
#endif
#define MMK_WIDE_RP 32
#define MMK_WIDE_GROUPS 8
#define MMK_WIDE_WARPS (MMK_LSTM_THREADS / 32)

// The wide route's layout for hidden size H on `es`-byte streams: units a
// block U, gate columns NJ = 4U, padded to an mma's N (NJP, forward) and K
// (KJ, backward); the row pitch of h and the forward's slice P, of the
// backward's slice and dz PJ (elements); batch rows a pass RP; the
// backward's 128/CL clusters' sums of partial dh added in G groups of CPG
// (G from U and RP only: at most 8, and about one group a thread).
struct WideShape {
  int U, NJ, NJP, KJ, P, PJ, RP, G, CPG;
};

__host__ __device__ inline size_t wide_round16(size_t n) { return (n + 15) / 16 * 16; }

// Shared memory of a wide kernel: forward, the slice (NJP x P), the h rows of
// a pass (RP x P), the warps' partial sums (8 x RP x NJP f32) and an mbarrier;
// backward, the slice (H x PJ), the pass's dz (RP x PJ), the cluster's
// pieces of partial dh (CL x RP x (H/CL + 4) f32: rows of 4 mod 32 words)
// the exchange's partial sums (8 x RP x U f32) and an mbarrier.
__host__ __device__ inline size_t wide_bytes(int H, int es, int backward, const WideShape& s) {
  if (backward)
    return wide_round16((size_t)es * H * s.PJ) + wide_round16((size_t)es * s.RP * s.PJ) +
           sizeof(float) * ((size_t)s.RP * (H + 4 * MMK_WIDE_CL) +
                            (size_t)MMK_WIDE_GROUPS * s.RP * s.U) + 16;
  return wide_round16((size_t)es * s.NJP * s.P) + wide_round16((size_t)es * s.RP * s.P) +
         sizeof(float) * (size_t)MMK_WIDE_WARPS * s.RP * s.NJP + 16;
}

__host__ __device__ inline WideShape wide_shape(int H, int es, int backward) {
  WideShape s;
  s.U = H / MMK_WIDE_BLOCKS;
  s.NJ = 4 * s.U;
  s.NJP = (s.NJ + 7) / 8 * 8;
  const int kd = es == 2 ? 16 : 8;  // an mma's depth
  s.KJ = (s.NJ + kd - 1) / kd * kd;
  s.P = H + 16 / es;
  s.PJ = s.KJ + 16 / es;
  s.RP = MMK_WIDE_RP;
  if (wide_bytes(H, es, backward, s) > 232448) s.RP = MMK_WIDE_RP / 2;
  const int G = 4 * MMK_LSTM_THREADS / (s.RP * s.U);
  s.G = G < 1 ? 1 : (G > MMK_WIDE_GROUPS ? MMK_WIDE_GROUPS : G);
  s.CPG = (MMK_WIDE_BLOCKS / MMK_WIDE_CL + s.G - 1) / s.G;
  return s;
}

static size_t wide_smem(int H, int es, int backward) {
  return wide_bytes(H, es, backward, wide_shape(H, es, backward));
}

// The f32 workspace of a wide kernel at (B, H), in floats: the carry (B x H)
// and, backward, the exchange of the clusters' sums (2 x 128/CL x B x H).
static size_t wide_work(int B, int H, int backward) {
  return (size_t)B * H * (backward ? 1 + 2 * MMK_WIDE_BLOCKS / MMK_WIDE_CL : 1);
}
// -- end of the wide layout

__device__ __forceinline__ unsigned wide_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mmk_mma_tf32(float* d, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7},"
      " {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The wide kernels' mma on stream type S: A a 16 x KD tile (element (r, k) at
// a[r*pa + k]), B a KD x 8 tile (element (k, n) at b[n*pb + k]), lane l's
// fragments (g = l/4, t = l%4).
template <typename S>
struct WideMma;

template <>
struct WideMma<float> {
  static constexpr int KD = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct Bf {
    uint32_t hi[2], lo[2];
  };
  // hi: v rounded to TF32 (to nearest, ties away: the bits below TF32's 10
  // mantissa bits rounded off with an integer add); lo: v - hi, exact in
  // f32, whose bits below TF32's the tensor cores ignore (two integer
  // operations and an add where two cvt.rna.tf32.f32 would do).
  __device__ static void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  }
  __device__ static void load_a(A& f, const float* a, int pa, int lane) {
    const float* p = a + (lane >> 2) * pa + (lane & 3);
    split(p[0], f.hi[0], f.lo[0]);
    split(p[8 * pa], f.hi[1], f.lo[1]);
    split(p[4], f.hi[2], f.lo[2]);
    split(p[8 * pa + 4], f.hi[3], f.lo[3]);
  }
  __device__ static void load_b(Bf& f, const float* b, int pb, int lane) {
    const float* p = b + (lane >> 2) * pb + (lane & 3);
    split(p[0], f.hi[0], f.lo[0]);
    split(p[4], f.hi[1], f.lo[1]);
  }
  __device__ static void mma(float* d, const A& a, const Bf& b) {
    mmk_mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
    mmk_mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
    mmk_mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
  }
  // the same into two sums: d the hi*hi products, dl the small ones (two
  // chains a step instead of one of three), added at the end by `join`
  __device__ static void mma2(float* d, float* dl, const A& a, const Bf& b) {
    mmk_mma_tf32(dl, a.lo, b.hi[0], b.hi[1]);
    mmk_mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
    mmk_mma_tf32(dl, a.hi, b.lo[0], b.lo[1]);
  }
  __device__ static void join(float* d, const float* dl) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += dl[e];
  }
};

template <>
struct WideMma<__nv_bfloat16> {
  static constexpr int KD = 16;
  struct A {
    uint32_t w[4];
  };
  struct Bf {
    uint32_t w[2];
  };
  __device__ static void load_a(A& f, const __nv_bfloat16* a, int pa, int lane) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(a + (lane >> 2) * pa) + (lane & 3);
    const int pw = 4 * pa;  // eight rows, in words
    f.w[0] = p[0], f.w[1] = p[pw], f.w[2] = p[4], f.w[3] = p[pw + 4];
  }
  __device__ static void load_b(Bf& f, const __nv_bfloat16* b, int pb, int lane) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(b + (lane >> 2) * pb) + (lane & 3);
    f.w[0] = p[0], f.w[1] = p[4];
  }
  __device__ static void mma(float* d, const A& a, const Bf& b) {
    mmk_mma_bf16(d, a.w, b.w[0], b.w[1]);
  }
  __device__ static void mma2(float* d, float*, const A& a, const Bf& b) { mma(d, a, b); }
  __device__ static void join(float*, const float*) {}
};

// The grid barrier: every block's threads' earlier writes are seen by every
// block's after it.
__device__ __forceinline__ void wide_grid_sync() {
  if (MMK_WIDE_OFF & 32)
    __syncthreads();
  else
    cg::this_grid().sync();
}

// Waits for the mbarrier's phase `parity`; a wait of more than ~2^32 cycles
// (a copy that never lands) ends the kernel with an error, not a hung card.
__device__ __forceinline__ void wide_mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(wide_smem_addr(bar)), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1LL << 32)) __trap();
  }
}

// The shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank` of the cluster.
__device__ __forceinline__ unsigned wide_mapa(const void* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(wide_smem_addr(p)), "r"(rank));
  return r;
}

// Four floats into a peer's shared memory (shared::cluster address, 16-byte
// aligned), their bytes counted on the peer's mbarrier.
__device__ __forceinline__ void wide_st_async4(unsigned addr, float4 v, unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar) : "memory");
}

// Warp 0 of every block of the cluster: rows [0, rows) of src (a (rows, H)
// of the stream type in device memory) into hs (rows of pitch P) of every
// block, the block of rank `rank` copying rows rank, rank + CL, ... by
// multicast bulk copies; each block's mbarrier counts all rows' bytes.
template <typename S>
__device__ __forceinline__ void wide_fetch(S* hs, const S* src, int rows, int H, int P,
                                           uint64_t* mbar, int rank) {
  if (MMK_WIDE_OFF & 2) return;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  const unsigned bytes = (unsigned)(H * sizeof(S));
  // the rows were written by generic stores behind the grid barrier
  asm volatile("fence.proxy.async.global;" ::: "memory");
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(wide_smem_addr(mbar)), "r"(bytes * rows) : "memory");
  const unsigned short mask = (unsigned short)((1u << MMK_WIDE_CL) - 1);
  for (int i = rank + lane * MMK_WIDE_CL; i < rows; i += 32 * MMK_WIDE_CL)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;\n"
        ::"r"(wide_smem_addr(hs + (size_t)i * P)), "l"(src + (size_t)i * H), "r"(bytes),
        "r"(wide_smem_addr(mbar)), "h"(mask)
        : "memory");
}

// K3a-wide: the forward over T steps (the step formulas at the top).
// cbuf (B, H) f32 carries c between steps.  MT = RP/16 row tiles and NT =
// NJP/8 column tiles are template arguments: predicated mma.sync tiles
// (runtime counts) were serialised by the compiler through one scratch
// accumulator, which cost ~4 us a step in f32 at (32, 512) on an H100.
template <typename S, int MT, int NT>
__global__ void __launch_bounds__(MMK_LSTM_THREADS, 1)
lstm_wide_fwd_kernel(const S* __restrict__ xi, const S* __restrict__ wh,
                     const S* __restrict__ h0, const S* __restrict__ c0, S* h_all,
                     S* __restrict__ c_all, S* __restrict__ gates, float* __restrict__ cbuf,
                     int T, int B, int H) {
  using M = WideMma<S>;
  cg::cluster_group cluster = cg::this_cluster();
  const WideShape s = wide_shape(H, sizeof(S), 0);
  const int U = s.U, H4 = 4 * H, P = s.P, NJP = s.NJP, RP = s.RP;
  const int q = blockIdx.x, rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ws = reinterpret_cast<S*>(smem_raw);  // (NJP, P): the slice
  S* hs = reinterpret_cast<S*>(smem_raw + wide_round16(sizeof(S) * NJP * P));  // (RP, P)
  float* red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(hs) +
                                        wide_round16(sizeof(S) * RP * P));  // (8, RP, NJP)
  uint64_t* mbar = reinterpret_cast<uint64_t*>(red + MMK_WIDE_WARPS * RP * NJP);
#pragma unroll 8
  for (int idx = tid; idx < H * NJP; idx += MMK_LSTM_THREADS) {
    const int k = idx / NJP, j = idx % NJP;
    ws[(size_t)j * P + k] = j < s.NJ ? wh[(size_t)k * H4 + (j / U) * H + q * U + j % U]
                                     : mmk_from_float<S>(0.0f);
  }
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(wide_smem_addr(mbar)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster.sync();  // every block of the cluster holds its slice and its mbarrier
  // the warp's share of K and the pass's tiles: rows M (16 each), columns N (8)
  const int kw = H / MMK_WIDE_WARPS, kb = warp * kw;
  unsigned phase = 0;
  wide_fetch<S>(hs, h0, min(RP, B), H, P, mbar, rank);
  // one pass a step (B <= RP): the cell thread keeps c in a register and
  // stores step t's c and gates after the grid barrier that ends it, so that
  // the barrier waits for the h stores alone
  const bool one = B <= RP;
  float cr = 0.0f, st[5];
  size_t srow = 0;
  bool pending = false;
  auto store_rest = [&](size_t row, int hu) {
    mmk_st(c_all + row * H + hu, st[4]);
    S* gr = gates + row * H4 + hu;
#pragma unroll
    for (int g = 0; g < 4; ++g) mmk_st(gr + g * H, st[g]);
  };

  for (int t = 0; t < T; ++t) {
    const S* hsrc = t == 0 ? h0 : h_all + (size_t)(t - 1) * B * H;
    for (int r0 = 0; r0 < B; r0 += RP) {
      const int rows = min(RP, B - r0);
      const bool more = r0 + RP < B;
      const bool cell = !(MMK_WIDE_OFF & 16) && tid < rows * U;
      const int r = tid / U, u = tid % U, b = r0 + r, hu = q * U + u;
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c = 0.0f;
      if (cell) {  // the cell's inputs, in flight during the wait and the product
        const S* xr = xi + ((size_t)t * B + b) * H4 + hu;
#pragma unroll
        for (int g = 0; g < 4; ++g) x[g] = mmk_ld(xr + g * H);
        c = t == 0 ? mmk_ld(c0 + (size_t)b * H + hu) : (one ? cr : cbuf[(size_t)b * H + hu]);
      }
      if (!(MMK_WIDE_OFF & 2)) wide_mbar_wait(mbar, phase);
      phase ^= 1;
      // the product over the warp's share of K, every tile of the pass
      float acc[MT][NT][4], accl[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] = accl[i][n][e] = 0.0f;
      if (!(MMK_WIDE_OFF & 1)) {
#pragma unroll 2
        for (int k = kb; k < kb + kw; k += M::KD) {
          typename M::A a[MT];
          typename M::Bf w[NT];
#pragma unroll
          for (int i = 0; i < MT; ++i) M::load_a(a[i], hs + (size_t)(16 * i) * P + k, P, lane);
#pragma unroll
          for (int n = 0; n < NT; ++n) M::load_b(w[n], ws + (size_t)(8 * n) * P + k, P, lane);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int n = 0; n < NT; ++n) M::mma2(acc[i][n], accl[i][n], a[i], w[n]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n) M::join(acc[i][n], accl[i][n]);
      }
      {
        const int g = lane >> 2, tc = 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float* p = red + ((size_t)warp * RP + 16 * i + g) * NJP + 8 * n + tc;
            *reinterpret_cast<float2*>(p) = make_float2(acc[i][n][0], acc[i][n][1]);
            *reinterpret_cast<float2*>(p + 8 * NJP) = make_float2(acc[i][n][2], acc[i][n][3]);
          }
      }
      __syncthreads();
      // a next pass reuses the h buffer: every block of the cluster is done with it
      if (more) asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
      if (cell) {  // the cell, each operation rounded as the plain version's
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float* p = red + (size_t)r * NJP + g * U + u;
          const size_t ws8 = (size_t)RP * NJP;
          if (MMK_WIDE_OFF & 8) {
            z[g] = p[0];
          } else {
            z[g] = ((p[0] + p[ws8]) + (p[2 * ws8] + p[3 * ws8])) +
                   ((p[4 * ws8] + p[5 * ws8]) + (p[6 * ws8] + p[7 * ws8]));
          }
        }
        const float ig = mmk_sigmoid(x[0] + z[0]);
        const float fg = mmk_sigmoid(x[1] + z[1]);
        const float gg = tanhf(x[2] + z[2]);
        const float og = mmk_sigmoid(x[3] + z[3]);
        c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, gg));
        const float h = mmk_round<S>(__fmul_rn(og, tanhf(c)));
        const size_t row = (size_t)t * B + b;
        mmk_st(h_all + row * H + hu, h);
        st[0] = ig, st[1] = fg, st[2] = gg, st[3] = og, st[4] = c;
        if (one) {
          cr = c, srow = row, pending = true;
        } else {
          store_rest(row, hu);
          cbuf[(size_t)b * H + hu] = c;
        }
      }
      if (more) {
        asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
        wide_fetch<S>(hs, hsrc + (size_t)(r0 + RP) * H, min(RP, B - r0 - RP), H, P, mbar, rank);
        __syncthreads();  // the cell's reads of red come before the next pass's writes
      }
    }
    if (t + 1 < T) {
      wide_grid_sync();
      wide_fetch<S>(hs, h_all + (size_t)t * B * H, min(RP, B), H, P, mbar, rank);
    }
    if (pending) {
      store_rest(srow, q * U + tid % U);
      pending = false;
    }
  }
  cluster.sync();  // no block leaves while a peer's copies may still reach it
}

// K3b-wide: the reverse-time walk (dxi, dh0, dc0).  work: dcbuf (B, H) f32
// (the dc carry), then the exchange xch (2, 128, 128/CL, B, U) f32: by step
// parity, for each owner block q, each cluster's sum of its blocks' partial
// dh over q's units.  MT = RP/16 row tiles and KS = KJ/KD depth steps are
// template arguments (the forward says why).
template <typename S, int MT, int KS>
__global__ void __launch_bounds__(MMK_LSTM_THREADS, 1)
lstm_wide_bwd_kernel(const S* __restrict__ dh_all, const S* __restrict__ dh_T,
                     const S* __restrict__ dc_T, const S* __restrict__ gates,
                     const S* __restrict__ c_all, const S* __restrict__ c0,
                     const S* __restrict__ wh, S* __restrict__ dxi, S* __restrict__ dh0,
                     S* __restrict__ dc0, float* __restrict__ work, int T, int B, int H) {
  using M = WideMma<S>;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int CL = MMK_WIDE_CL, NCL = MMK_WIDE_BLOCKS / MMK_WIDE_CL;
  const WideShape s = wide_shape(H, sizeof(S), 1);
  const int U = s.U, H4 = 4 * H, PJ = s.PJ, RP = s.RP, HC = H / CL, HCP = HC + 4;
  const int q = blockIdx.x, rank = (int)cluster.block_rank(), cid = q / CL;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* dcbuf = work;
  float* xch = dcbuf + (size_t)B * H;
  // the exchange: an owner's (rows, U) of a cluster taken V floats at a time
  // (4, 2 or 1, dividing B*U), the clusters added in G groups of CPG
  const int V = (B * U) % 4 == 0 ? 4 : ((B * U) % 2 == 0 ? 2 : 1);
  const int G = s.G, CPG = s.CPG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* wt = reinterpret_cast<S*>(smem_raw);  // (H, PJ): the slice, k-major
  S* dzs = reinterpret_cast<S*>(smem_raw + wide_round16(sizeof(S) * H * PJ));  // (RP, PJ)
  float* recv = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(dzs) +
                                         wide_round16(sizeof(S) * RP * PJ));  // (CL, RP, HCP)
  float* part = recv + (size_t)CL * RP * HCP;  // (WIDE_GROUPS, RP, U): the exchange's partial sums
  // counts the bytes the peers' pieces bring (st.async)
  uint64_t* mbar = reinterpret_cast<uint64_t*>(part + (size_t)MMK_WIDE_GROUPS * RP * U);
#pragma unroll 8
  for (int idx = tid; idx < H * s.KJ; idx += MMK_LSTM_THREADS) {
    const int k = idx / s.KJ, j = idx % s.KJ;
    wt[(size_t)k * PJ + j] = j < s.NJ ? wh[(size_t)k * H4 + (j / U) * H + q * U + j % U]
                                      : mmk_from_float<S>(0.0f);
  }
  for (int idx = tid; idx < RP * PJ; idx += MMK_LSTM_THREADS) dzs[idx] = mmk_from_float<S>(0.0f);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(wide_smem_addr(mbar)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster.sync();  // every block of the cluster has started and holds its mbarrier
  // the warp's columns of dh: n tiles [nb, nb + NW) of 8 (H/64 a warp), all in
  // the piece of rank nb*8 / HC
  const int NW = H / (8 * MMK_WIDE_WARPS), nb = warp * NW;
  const int dest = nb * 8 / HC;
  float* dst_piece = recv + (size_t)rank * RP * HCP - dest * HC;
  // a remote piece: its address and its mbarrier's in the peer's shared memory
  const unsigned rdst = wide_mapa(dst_piece, dest), rbar = wide_mapa(mbar, dest);
  // the bytes of the peers' pieces (the rows of every row tile) a pass
  const unsigned peer_bytes = (unsigned)((CL - 1) * MT * 16 * HC * sizeof(float));
  unsigned phase = 0;
  // one pass a step (B <= RP): the cell thread keeps dc in a register and
  // loads step t-1's inputs while step t's product and exchange run
  const bool one = B <= RP;
  float dcr = 0.0f;
  BwdIn nxt = {};
  auto load_in = [&](int t, int b, int hu, BwdIn& in) {
    const size_t row = (size_t)t * B + b;
    const S* gr = gates + row * H4 + hu;
    in.ig = mmk_ld(gr), in.fg = mmk_ld(gr + H), in.gg = mmk_ld(gr + 2 * H);
    in.og = mmk_ld(gr + 3 * H);
    in.c = mmk_ld(c_all + row * H + hu);
    in.cp = t > 0 ? mmk_ld(c_all + (row - B) * H + hu) : mmk_ld(c0 + (size_t)b * H + hu);
    in.dha = mmk_ld(dh_all + row * H + hu);
  };
  if (one && tid < B * U && !(MMK_WIDE_OFF & 16)) load_in(T - 1, tid / U, q * U + tid % U, nxt);

  for (int t = T - 1; t >= -1; --t) {
    const int par = t & 1;
    for (int r0 = 0; r0 < B; r0 += RP) {
      const int rows = min(RP, B - r0);
      const bool own = tid < rows * U;
      const bool cell = own && !(MMK_WIDE_OFF & 16);
      const int r = tid / U, u = tid % U, b = r0 + r, hu = q * U + u;
      const size_t at = (size_t)b * H + hu;
      BwdIn in = {};
      float dcc = 0.0f, dhc = 0.0f;
      if (cell && t >= 0) {  // the cell's inputs
        if (one)
          in = nxt;
        else
          load_in(t, b, hu, in);
        dcc = t == T - 1 ? mmk_ld(dc_T + at) : (one ? dcr : dcbuf[at]);
        if (t == T - 1) dhc = mmk_ld(dh_T + at);
      }
      if (t < T - 1) {  // dz_{t+1} Wh^T: the clusters' sums, in a fixed order
        // the owner's (rows, U) of each cluster is contiguous, taken V floats
        // at a time; group gi adds clusters [gi*CPG, (gi+1)*CPG) in order, the
        // cell thread the groups in order
        const int E = rows * U, NE = E / V;
        const float* xp = xch + ((size_t)(par ^ 1) * MMK_WIDE_BLOCKS + q) * NCL * B * U +
                          (size_t)r0 * U;
        for (int task = tid; task < NE * G; task += MMK_LSTM_THREADS) {
          const int e = V * (task % NE), gi = task / NE;
          const int c1 = min(NCL, (gi + 1) * CPG);
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (!(MMK_WIDE_OFF & 2)) {
            // up to 16 clusters' loads in flight before their sums
            for (int cb = gi * CPG; cb < c1; cb += 16) {
              float4 w[16];
#pragma unroll
              for (int j = 0; j < 16; ++j) {
                w[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                if (cb + j < c1) {
                  const float* p = xp + (size_t)(cb + j) * B * U + e;
                  if (V == 4) {
                    w[j] = __ldcg(reinterpret_cast<const float4*>(p));
                  } else if (V == 2) {
                    const float2 x = __ldcg(reinterpret_cast<const float2*>(p));
                    w[j].x = x.x, w[j].y = x.y;
                  } else {
                    w[j].x = __ldcg(p);
                  }
                }
              }
#pragma unroll
              for (int j = 0; j < 16; ++j)
                if (cb + j < c1) v[0] += w[j].x, v[1] += w[j].y, v[2] += w[j].z, v[3] += w[j].w;
            }
          }
          for (int i = 0; i < V; ++i) part[(size_t)gi * E + e + i] = v[i];
        }
        __syncthreads();
        if (cell) {
          float sum = 0.0f;
          for (int gi = 0; gi < G; ++gi) sum += part[(size_t)gi * E + tid];
          dhc = sum;
        }
      }
      if (t < 0) {  // after step 0: dh0 and dc0
        if (cell) {
          mmk_st(dh0 + at, dhc);
          mmk_st(dc0 + at, one ? dcr : dcbuf[at]);
        }
        // a next pass writes part: every cell thread has read it
        if (r0 + RP < B) __syncthreads();
        continue;
      }
      if (cell) {  // the cell, each operation rounded as the plain version's, in its order
        const float ig = in.ig, fg = in.fg, gg = in.gg, og = in.og;
        const float tc = tanhf(in.c);
        const float dh = __fadd_rn(in.dha, dhc);
        const float dc =
            __fadd_rn(dcc, __fmul_rn(__fmul_rn(dh, og), __fsub_rn(1.0f, __fmul_rn(tc, tc))));
        float dz[4];
        dz[0] = mmk_round<S>(__fmul_rn(__fmul_rn(__fmul_rn(dc, gg), ig), __fsub_rn(1.0f, ig)));
        dz[1] = mmk_round<S>(__fmul_rn(__fmul_rn(__fmul_rn(dc, in.cp), fg), __fsub_rn(1.0f, fg)));
        dz[2] = mmk_round<S>(__fmul_rn(__fmul_rn(dc, ig), __fsub_rn(1.0f, __fmul_rn(gg, gg))));
        dz[3] = mmk_round<S>(__fmul_rn(__fmul_rn(__fmul_rn(dh, tc), og), __fsub_rn(1.0f, og)));
        S* dr = dxi + ((size_t)t * B + b) * H4 + hu;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          mmk_st(dr + g * H, dz[g]);
          dzs[(size_t)r * PJ + g * U + u] = mmk_from_float<S>(dz[g]);
        }
        if (one) {
          dcr = __fmul_rn(dc, fg);
          if (t > 0) load_in(t - 1, b, hu, nxt);
        } else {
          dcbuf[at] = __fmul_rn(dc, fg);
        }
      } else if (own) {
#pragma unroll
        for (int g = 0; g < 4; ++g) dzs[(size_t)r * PJ + g * U + u] = mmk_from_float<S>(0.0f);
      }
      __syncthreads();
      // the partial dh over the warp's columns, pushed to the rank that sums them
      if (!(MMK_WIDE_OFF & 1)) {
        typename M::A a[MT][KS];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            M::load_a(a[i][kk], dzs + (size_t)(16 * i) * PJ + kk * M::KD, PJ, lane);
        const int g = lane >> 2, tc = 2 * (lane & 3);
        // two column tiles at a time (NW = 2U is even)
        for (int n = nb; n < nb + NW; n += 2) {
          float acc[2][MT][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.0f;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            typename M::Bf w[2];
#pragma unroll
            for (int m = 0; m < 2; ++m)
              M::load_b(w[m], wt + (size_t)(8 * (n + m)) * PJ + kk * M::KD, PJ, lane);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int i = 0; i < MT; ++i) M::mma(acc[m][i], a[i][kk], w[m]);
          }
          if (!(MMK_WIDE_OFF & 4)) {
            // lanes t, t^1 swap halves: an even t holds columns 2t .. 2t+3 of
            // row g, an odd t columns 2t-2 .. 2t+1 of row g+8 (16 bytes)
            const bool odd = lane & 1;
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int i = 0; i < MT; ++i) {
                const float* a4 = acc[m][i];
                const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a4[0] : a4[2], 1);
                const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a4[1] : a4[3], 1);
                const float4 v = odd ? make_float4(x0, x1, a4[2], a4[3])
                                     : make_float4(a4[0], a4[1], x0, x1);
                const size_t o = (size_t)(16 * i + g + (odd ? 8 : 0)) * HCP + 8 * (n + m) + tc -
                                 (odd ? 2 : 0);
                if (dest == rank)
                  *reinterpret_cast<float4*>(dst_piece + o) = v;
                else
                  wide_st_async4(rdst + 4 * (unsigned)o, v, rbar);
              }
          }
        }
      }
      // the local piece behind the block barrier, the peers' on the mbarrier
      __syncthreads();
      if (!(MMK_WIDE_OFF & 5)) {
        if (tid == 0)
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                       ::"r"(wide_smem_addr(mbar)), "r"(peer_bytes) : "memory");
        wide_mbar_wait(mbar, phase);
        phase ^= 1;
      }
      // this rank's columns [rank*HC, (rank+1)*HC): the CL pieces in rank order,
      // into the exchange by owner block (an owner's (rows, U) contiguous, V
      // floats a store); thread t takes vector t % nv of every (QS)th owner
      {
        const int nv = rows * U / V, QS = MMK_LSTM_THREADS / nv, e = V * (tid % nv);
        int off[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) off[i] = ((e + i) / U) * HCP + (e + i) % U;
        float* x0 = xch + (((size_t)par * MMK_WIDE_BLOCKS + (rank * HC) / U) * NCL + cid) * B * U +
                    (size_t)r0 * U + e;
        if (tid < QS * nv && !(MMK_WIDE_OFF & 2)) {
#pragma unroll 4
          for (int qo = tid / nv; qo < HC / U; qo += QS) {
            float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (i < V) {
                const float* p = recv + off[i] + qo * U;
                v[i] = p[0];
                if (!(MMK_WIDE_OFF & 8))
#pragma unroll
                  for (int sr = 1; sr < CL; ++sr) v[i] += p[(size_t)sr * RP * HCP];
              }
            }
            float* xo = x0 + (size_t)qo * NCL * B * U;
            if (V == 4)
              __stcg(reinterpret_cast<float4*>(xo), make_float4(v[0], v[1], v[2], v[3]));
            else if (V == 2)
              __stcg(reinterpret_cast<float2*>(xo), make_float2(v[0], v[1]));
            else
              __stcg(xo, v[0]);
          }
        }
      }
      // a next pass pushes into the pieces: every block of the cluster has summed them
      if (r0 + RP < B) cluster.sync();
    }
    if (t >= 0) wide_grid_sync();
  }
  cluster.sync();  // no block leaves while a peer may still push into it
}

// The wide route's limits (ops/fused_lstm.py's lstm_wide_plan raises outside
// them): H a multiple of 128 up to 1,024, and each kernel's shared memory.
static bool wide_fits(int H, int es) {
  return H >= MMK_WIDE_BLOCKS && H % MMK_WIDE_BLOCKS == 0 && H <= 8 * MMK_WIDE_BLOCKS &&
         wide_smem(H, es, 0) <= 232448 && wide_smem(H, es, 1) <= 232448;
}

// One launch of MMK_WIDE_BLOCKS blocks on clusters of MMK_WIDE_CL with the
// cooperative attribute (the grid barriers need every block resident: the
// launch is refused on a card that cannot hold them at once); with
// `clusters` set, only the clusters the card holds at once, in *clusters.
static int wide_launch(const void* fn, void** args, size_t smem, cudaStream_t s, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  cfg.gridDim = dim3(MMK_WIDE_BLOCKS);
  cfg.blockDim = dim3(MMK_LSTM_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = MMK_WIDE_CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = clusters ? 1 : 2;
  if (clusters) return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The kernels' instantiation for H (MT, NT or KS from the layout: f32
// halves RP at H = 896 and 1,024), or null.
template <typename S>
static const void* wide_fwd_fn(int H) {
  const WideShape s = wide_shape(H, sizeof(S), 0);
  const int mt = s.RP / 16, nt = s.NJP / 8;
  if (mt == 2 && nt == 1) return (const void*)lstm_wide_fwd_kernel<S, 2, 1>;
  if (mt == 2 && nt == 2) return (const void*)lstm_wide_fwd_kernel<S, 2, 2>;
  if (mt == 2 && nt == 3) return (const void*)lstm_wide_fwd_kernel<S, 2, 3>;
  if constexpr (sizeof(S) == 2) {
    if (mt == 2 && nt == 4) return (const void*)lstm_wide_fwd_kernel<S, 2, 4>;
  } else {
    if (mt == 1 && nt == 4) return (const void*)lstm_wide_fwd_kernel<S, 1, 4>;
  }
  return nullptr;
}

template <typename S>
static const void* wide_bwd_fn(int H) {
  const WideShape s = wide_shape(H, sizeof(S), 1);
  const int mt = s.RP / 16, ks = s.KJ / WideMma<S>::KD;
  if (mt == 2 && ks == 1) return (const void*)lstm_wide_bwd_kernel<S, 2, 1>;
  if (mt == 2 && ks == 2) return (const void*)lstm_wide_bwd_kernel<S, 2, 2>;
  if constexpr (sizeof(S) == 4) {
    if (mt == 2 && ks == 3) return (const void*)lstm_wide_bwd_kernel<S, 2, 3>;
    if (mt == 1 && ks == 4) return (const void*)lstm_wide_bwd_kernel<S, 1, 4>;
  }
  return nullptr;
}

template <typename S>
static int wide_forward(const void* xi_, const void* wh_, const void* h0_, const void* c0_,
                        void* h_all_, void* c_all_, void* gates_, float* cbuf, int T, int B,
                        int H, cudaStream_t s, int* clusters) {
  if (!wide_fits(H, sizeof(S)) || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const S *xi = (const S*)xi_, *wh = (const S*)wh_, *h0 = (const S*)h0_, *c0 = (const S*)c0_;
  S *h_all = (S*)h_all_, *c_all = (S*)c_all_, *gates = (S*)gates_;
  void* args[] = {&xi, &wh, &h0, &c0, &h_all, &c_all, &gates, &cbuf, &T, &B, &H};
  const void* fn = wide_fwd_fn<S>(H);
  if (!fn) return (int)cudaErrorInvalidValue;
  return wide_launch(fn, args, wide_smem(H, sizeof(S), 0), s, clusters);
}

template <typename S>
static int wide_backward(const void* dh_all_, const void* dh_T_, const void* dc_T_,
                         const void* gates_, const void* c_all_, const void* h_all_,
                         const void* h0_, const void* c0_, const void* wh_, void* dxi_,
                         void* dwh_, float* dwh_part, void* dh0_, void* dc0_, float* work, int T,
                         int B, int H, int splits, cudaStream_t s, int* clusters) {
  if (!wide_fits(H, sizeof(S)) || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const S *dh_all = (const S*)dh_all_, *dh_T = (const S*)dh_T_, *dc_T = (const S*)dc_T_;
  const S *gates = (const S*)gates_, *c_all = (const S*)c_all_, *h_all = (const S*)h_all_;
  const S *h0 = (const S*)h0_, *c0 = (const S*)c0_, *wh = (const S*)wh_;
  S *dxi = (S*)dxi_, *dwh = (S*)dwh_, *dh0 = (S*)dh0_, *dc0 = (S*)dc0_;
  void* args[] = {&dh_all, &dh_T, &dc_T, &gates, &c_all, &c0, &wh, &dxi, &dh0, &dc0, &work,
                  &T, &B, &H};
  const void* fn = wide_bwd_fn<S>(H);
  if (!fn) return (int)cudaErrorInvalidValue;
  const int err = wide_launch(fn, args, wide_smem(H, sizeof(S), 1), s, clusters);
  if (err != 0 || clusters || (MMK_WIDE_OFF & 64)) return err;
  return dwh_product<S>(h0, h_all, dxi, dwh, dwh_part, T, B, H, splits, s);
}

extern "C" {

// Shared memory (bytes) the forward and the backward need for hidden size H,
// `bc` batch rows per cluster, clusters of `cl` blocks and `es` bytes a
// stream element (4 or 2); the wrapper checks them against the card.
long long mmk_lstm_fwd_smem(int H, int bc, int cl, int es) {
  return (long long)fwd_smem(H, bc, cl, es);
}
long long mmk_lstm_bwd_smem(int H, int bc, int cl, int es) {
  return (long long)bwd_smem(H, bc, cl, es);
}

// The clusters of `cl` blocks (`bc` rows each) the card holds at once for
// the forward or the backward walk at hidden size H, or minus the
// cudaError_t of the query.
int mmk_lstm_fwd_clusters(int H, int bc, int cl, int bf16) {
  int n = 0;
  const int err = bf16 ? fwd_any<__nv_bfloat16>(nullptr, bc, H, bc, cl, 0, &n, 1)
                       : fwd_any<float>(nullptr, bc, H, bc, cl, 0, &n, 1);
  return err != 0 ? -err : n;
}
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
// The forward runs on clusters of `cl` blocks, `bc` rows each.
int mmk_lstm_forward(const void* xi, const void* wh, const void* h0, const void* c0,
                     void* h_all, void* c_all, void* gates, int T, int B, int H, int bc,
                     int cl, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? forward<__nv_bfloat16>(xi, wh, h0, c0, h_all, c_all, gates, T, B, H, bc, cl, s)
              : forward<float>(xi, wh, h0, c0, h_all, c_all, gates, T, B, H, bc, cl, s);
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

// The wide route (K3a-wide, K3b-wide): shared memory (bytes) of its forward
// (backward = 0) or backward walk on `es`-byte streams, and the floats of
// its f32 workspace at (B, H).
long long mmk_lstm_wide_smem(int H, int es, int backward) {
  return (long long)wide_smem(H, es, backward);
}
long long mmk_lstm_wide_work(int B, int H, int backward) {
  return (long long)wide_work(B, H, backward);
}
// Its layout (wide_shape) in out: U, NJ, NJP, KJ, P, PJ, RP, G, CPG.
void mmk_lstm_wide_layout(int H, int es, int backward, int* out) {
  const WideShape s = wide_shape(H, es, backward);
  const int v[] = {s.U, s.NJ, s.NJP, s.KJ, s.P, s.PJ, s.RP, s.G, s.CPG};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// The clusters of MMK_WIDE_CL blocks of the forward (backward = 0) or the
// walk at hidden size H that the card holds at once, or minus the
// cudaError_t of the query.
int mmk_lstm_wide_clusters(int H, int backward, int bf16) {
  int n = 0, err;
  if (backward)
    err = bf16 ? wide_backward<__nv_bfloat16>(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                              H, 1, 0, &n)
               : wide_backward<float>(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, H, 1, 0,
                                      &n);
  else
    err = bf16 ? wide_forward<__nv_bfloat16>(0, 0, 0, 0, 0, 0, 0, 0, 1, 1, H, 0, &n)
               : wide_forward<float>(0, 0, 0, 0, 0, 0, 0, 0, 1, 1, H, 0, &n);
  return err != 0 ? -err : n;
}

// The forward on MMK_WIDE_BLOCKS blocks; cbuf is a (B, H) f32 workspace
// (mmk_lstm_wide_work floats).
int mmk_lstm_wide_forward(const void* xi, const void* wh, const void* h0, const void* c0,
                          void* h_all, void* c_all, void* gates, float* cbuf, int T, int B,
                          int H, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? wide_forward<__nv_bfloat16>(xi, wh, h0, c0, h_all, c_all, gates, cbuf, T, B, H, s,
                                            nullptr)
              : wide_forward<float>(xi, wh, h0, c0, h_all, c_all, gates, cbuf, T, B, H, s,
                                    nullptr);
}

// The walk on MMK_WIDE_BLOCKS blocks (work: mmk_lstm_wide_work floats), then
// dWh as mmk_lstm_backward computes it.
int mmk_lstm_wide_backward(const void* dh_all, const void* dh_T, const void* dc_T,
                           const void* gates, const void* c_all, const void* h_all,
                           const void* h0, const void* c0, const void* wh, void* dxi, void* dwh,
                           float* dwh_part, void* dh0, void* dc0, float* work, int T, int B,
                           int H, int splits, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? wide_backward<__nv_bfloat16>(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, wh,
                                             dxi, dwh, dwh_part, dh0, dc0, work, T, B, H,
                                             splits, s, nullptr)
              : wide_backward<float>(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, wh, dxi,
                                     dwh, dwh_part, dh0, dc0, work, T, B, H, splits, s, nullptr);
}

const char* mmk_lstm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
