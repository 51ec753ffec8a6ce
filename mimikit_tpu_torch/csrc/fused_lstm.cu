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
// of 8 blocks shares one group of batch rows; each block owns H/8 hidden
// units, keeps its slice of Wh (its 4*H/8 gate columns; in the backward its
// H/8 rows) in shared memory for the whole walk, and computes those units
// for the group's rows.  After each step the blocks exchange the new h (the
// backward: the new dz) through distributed shared memory, with one cluster
// barrier a step.  The time loop runs inside one launch; clusters (groups of
// batch rows) are independent.  Limits: f32, H a multiple of 8, the Wh slice
// (2*H*H bytes) plus buffers within a block's 227 KB of shared memory, which
// holds up to H = 328; the wrapper checks them and raises outside them.
//
// dWh is a tiled f32 product hprev^T (H x T*B) times dxi (T*B x 4H).  Each
// block sums a 64 x 64 tile of dWh over one of `splits` ranges of the T*B
// rows in registers (the rows are split so that enough blocks fill the
// card); a second kernel adds the partial tiles in a fixed order.  No
// atomics, so the result does not depend on the run.
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
// dWh sums the bf16 hprev and dxi in f32 partial tiles, in the same fixed
// order, and rounds once.  The bf16 instantiation is bound by the same serial
// chain as the f32 one: halving the bytes moves no bound that sets its pace.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

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

// Backward.  Same ownership as the forward.  Block q keeps rows q*U .. of
// Wh, transposed: wt[col*U + u] = Wh[q*U + u, col].  Thread p < BC*U carries
// dh and dc of its pair; for dh_{t-1} = dz @ Wh^T, thread (u, s) =
// (tid % U, tid / U) sums unit u over columns col = s, s+KS2, ...
template <typename S, int BC>
__global__ void __cluster_dims__(MMK_LSTM_CLUSTER, 1, 1) __launch_bounds__(MMK_LSTM_THREADS)
lstm_bwd_kernel(const S* __restrict__ dh_all, const S* __restrict__ dh_T,
                const S* __restrict__ dc_T, const S* __restrict__ gates,
                const S* __restrict__ c_all, const S* __restrict__ c0,
                const S* __restrict__ wh, S* __restrict__ dxi,
                S* __restrict__ dh0, S* __restrict__ dc0, int T, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int b0 = (int)(blockIdx.x / MMK_LSTM_CLUSTER) * BC;
  const int U = H / MMK_LSTM_CLUSTER, NC = 4 * U, H4 = 4 * H;
  const int KS2 = MMK_LSTM_THREADS / U;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  S* wt = reinterpret_cast<S*>(smem);   // (4H, U)
  float* dgs = reinterpret_cast<float*>(wt + (size_t)H4 * U);  // (BC, 4H): dz of the group's rows, global columns
  float* dgown = dgs + BC * H4;         // (2, BC, NC): this block's dz, by step parity
  float* red = dgown + 2 * BC * NC;     // (KS2, BC, U): partial sums of dz @ Wh^T

  for (int idx = tid; idx < H4 * U; idx += MMK_LSTM_THREADS) {
    const int col = idx / U, uu = idx % U;
    wt[idx] = wh[(size_t)(q * U + uu) * H4 + col];
  }
  const bool own = tid < BC * U;
  const int r = own ? tid / U : 0, u = own ? tid % U : 0;
  const int b = b0 + r, hu = q * U + u;
  const bool valid = own && b < B;
  float dhc = valid ? mmk_ld(dh_T + (size_t)b * H + hu) : 0.0f;
  float dcc = valid ? mmk_ld(dc_T + (size_t)b * H + hu) : 0.0f;
  const int uj = tid % U, s = tid / U;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    float* dgnew = dgown + (t & 1) * BC * NC;
    if (own) {
      float dz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (valid) {
        const size_t row = (size_t)t * B + b;
        const S* gr = gates + row * H4 + hu;
        const float ig = mmk_ld(gr), fg = mmk_ld(gr + H), gg = mmk_ld(gr + 2 * H),
                    og = mmk_ld(gr + 3 * H);
        const float tc = tanhf(mmk_ld(c_all + row * H + hu));
        const float cp =
            t > 0 ? mmk_ld(c_all + (row - B) * H + hu) : mmk_ld(c0 + (size_t)b * H + hu);
        const float dh = mmk_ld(dh_all + row * H + hu) + dhc;
        const float dc = dcc + dh * og * (1.0f - tc * tc);
        dz[0] = mmk_round<S>(dc * gg * ig * (1.0f - ig));
        dz[1] = mmk_round<S>(dc * cp * fg * (1.0f - fg));
        dz[2] = mmk_round<S>(dc * ig * (1.0f - gg * gg));
        dz[3] = mmk_round<S>(dh * tc * og * (1.0f - og));
        S* dr = dxi + row * H4 + hu;
        mmk_st(dr, dz[0]);
        mmk_st(dr + H, dz[1]);
        mmk_st(dr + 2 * H, dz[2]);
        mmk_st(dr + 3 * H, dz[3]);
        dcc = dc * fg;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) dgnew[r * NC + g * U + u] = dz[g];
    }
    cluster.sync();
    for (int idx = tid; idx < BC * H4; idx += MMK_LSTM_THREADS) {
      const int rr = idx / H4, col = idx % H4;
      const int g = col / H, k = col % H;
      const float* src = cluster.map_shared_rank(dgnew, k / U);
      dgs[idx] = src[rr * NC + g * U + k % U];
    }
    __syncthreads();
    if (s < KS2) {
      float acc[BC];
#pragma unroll
      for (int rr = 0; rr < BC; ++rr) acc[rr] = 0.0f;
      for (int col = s; col < H4; col += KS2) {
        const float w = mmk_ld(wt + col * U + uj);
#pragma unroll
        for (int rr = 0; rr < BC; ++rr) acc[rr] = fmaf(dgs[rr * H4 + col], w, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < BC; ++rr) red[(s * BC + rr) * U + uj] = acc[rr];
    }
    __syncthreads();
    if (own) {
      float v = 0.0f;
      for (int ss = 0; ss < KS2; ++ss) v += red[(ss * BC + r) * U + u];
      dhc = v;
    }
  }
  if (valid) {
    mmk_st(dh0 + (size_t)b * H + hu, dhc);
    mmk_st(dc0 + (size_t)b * H + hu, dcc);
  }
  cluster.sync();
}

// Partial dWh of rows [z*rows, (z+1)*rows) for z = blockIdx.z:
// part[z][m, n] = sum_r hprev[r, m] * dxi[r, n], where hprev row r is h0[r]
// for r < B and h_all[r - B] after (h_{t-1} of row (t, b)).  The partial
// tiles are f32 whatever the stream type.
#define DWH_TM 64
#define DWH_TN 64
#define DWH_TK 16

template <typename S>
__global__ void __launch_bounds__(256)
lstm_dwh_kernel(const S* __restrict__ h0, const S* __restrict__ h_all,
                const S* __restrict__ dxi, float* __restrict__ part, int R, int B, int M,
                int N, int rows) {
  __shared__ __align__(16) float As[DWH_TK][DWH_TM];
  __shared__ __align__(16) float Bs[DWH_TK][DWH_TN];
  const int m0 = blockIdx.y * DWH_TM, n0 = blockIdx.x * DWH_TN;
  const int r_begin = blockIdx.z * rows, r_end = min(R, r_begin + rows);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float* dwh = part + (size_t)blockIdx.z * M * N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += DWH_TK) {
    for (int idx = tid; idx < DWH_TK * DWH_TM; idx += 256) {
      const int rr = idx / DWH_TM, mm = idx % DWH_TM;
      const int rw = r0 + rr, m = m0 + mm;
      float v = 0.0f;
      if (rw < r_end && m < M)
        v = rw < B ? mmk_ld(h0 + (size_t)rw * M + m) : mmk_ld(h_all + (size_t)(rw - B) * M + m);
      As[rr][mm] = v;
    }
    for (int idx = tid; idx < DWH_TK * DWH_TN; idx += 256) {
      const int rr = idx / DWH_TN, nn = idx % DWH_TN;
      const int rw = r0 + rr, n = n0 + nn;
      Bs[rr][nn] = (rw < r_end && n < N) ? mmk_ld(dxi + (size_t)rw * N + n) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DWH_TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bw[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (n < N) dwh[(size_t)m * N + n] = acc[i][jj];
    }
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

// Shared memory of the forward and backward for hidden size H, `bc` batch
// rows per cluster and `es` bytes a stream element (the Wh slice's type; the
// other buffers are f32).
static size_t fwd_smem(int H, int bc, int es) {
  const int U = H / MMK_LSTM_CLUSTER, NC = 4 * U, KS = MMK_LSTM_THREADS / NC;
  return (size_t)es * H * NC +
         sizeof(float) * ((size_t)bc * H + 2 * bc * U + (size_t)KS * bc * NC);
}

static size_t bwd_smem(int H, int bc, int es) {
  const int U = H / MMK_LSTM_CLUSTER, NC = 4 * U, KS2 = MMK_LSTM_THREADS / U;
  return (size_t)es * 4 * H * U +
         sizeof(float) * ((size_t)bc * 4 * H + 2 * bc * NC + (size_t)KS2 * bc * U);
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

template <typename S>
static int backward(const void* dh_all_, const void* dh_T_, const void* dc_T_,
                    const void* gates_, const void* c_all_, const void* h_all_,
                    const void* h0_, const void* c0_, const void* wh_, void* dxi_, void* dwh_,
                    float* dwh_part, void* dh0_, void* dc0_, int T, int B, int H, int bc,
                    int splits, cudaStream_t s) {
  const S *dh_all = (const S*)dh_all_, *dh_T = (const S*)dh_T_, *dc_T = (const S*)dc_T_;
  const S *gates = (const S*)gates_, *c_all = (const S*)c_all_, *h_all = (const S*)h_all_;
  const S *h0 = (const S*)h0_, *c0 = (const S*)c0_, *wh = (const S*)wh_;
  S *dxi = (S*)dxi_, *dwh = (S*)dwh_, *dh0 = (S*)dh0_, *dc0 = (S*)dc0_;
  void* args[] = {&dh_all, &dh_T, &dc_T, &gates, &c_all, &c0, &wh, &dxi, &dh0, &dc0,
                  &T, &B, &H};
  const size_t smem = bwd_smem(H, bc, sizeof(S));
  int err;
  switch (bc) {
    case 1: err = launch_cluster(lstm_bwd_kernel<S, 1>, smem, B, bc, s, args); break;
    case 2: err = launch_cluster(lstm_bwd_kernel<S, 2>, smem, B, bc, s, args); break;
    case 4: err = launch_cluster(lstm_bwd_kernel<S, 4>, smem, B, bc, s, args); break;
    case 8: err = launch_cluster(lstm_bwd_kernel<S, 8>, smem, B, bc, s, args); break;
    default: return (int)cudaErrorInvalidValue;
  }
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

// Shared memory (bytes) the forward and backward need for hidden size H,
// `bc` batch rows per cluster and `es` bytes a stream element (4 or 2); the
// wrapper checks them against the card.
long long mmk_lstm_fwd_smem(int H, int bc, int es) { return (long long)fwd_smem(H, bc, es); }
long long mmk_lstm_bwd_smem(int H, int bc, int es) { return (long long)bwd_smem(H, bc, es); }

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

// The reverse-time walk (dxi, dh0, dc0), then dWh over the stored dxi in
// `splits` row ranges (partial tiles in `dwh_part`, splits x H x 4H f32,
// summed into dwh; with one split and f32 streams dwh is written directly and
// dwh_part unused).
int mmk_lstm_backward(const void* dh_all, const void* dh_T, const void* dc_T,
                      const void* gates, const void* c_all, const void* h_all,
                      const void* h0, const void* c0, const void* wh, void* dxi, void* dwh,
                      float* dwh_part, void* dh0, void* dc0, int T, int B, int H, int bc,
                      int splits, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? backward<__nv_bfloat16>(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, wh,
                                        dxi, dwh, dwh_part, dh0, dc0, T, B, H, bc, splits, s)
              : backward<float>(dh_all, dh_T, dc_T, gates, c_all, h_all, h0, c0, wh, dxi, dwh,
                                dwh_part, dh0, dc0, T, B, H, bc, splits, s);
}

const char* mmk_lstm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
