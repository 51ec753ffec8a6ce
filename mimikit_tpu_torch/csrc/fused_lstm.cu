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
// xi (T, B, 4H), Wh (H, 4H), every tensor f32 and contiguous.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#define MMK_LSTM_CLUSTER 8
#define MMK_LSTM_THREADS 256

__device__ __forceinline__ float mmk_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Forward.  Cluster `blockIdx.x / 8` owns batch rows [b0, b0 + BC); block
// rank q owns hidden units [q*U, (q+1)*U), U = H/8, i.e. gate columns
// g*H + q*U + u of Wh.  Thread p < BC*U owns the pair (row p/U, unit p%U) and
// keeps its c in a register; for the recurrent product, thread
// (j, s) = (tid % NC, tid / NC) sums column j over k = s, s+KS, ...
template <int BC>
__global__ void __cluster_dims__(MMK_LSTM_CLUSTER, 1, 1) __launch_bounds__(MMK_LSTM_THREADS)
lstm_fwd_kernel(const float* __restrict__ xi, const float* __restrict__ wh,
                const float* __restrict__ h0, const float* __restrict__ c0,
                float* __restrict__ h_all, float* __restrict__ c_all,
                float* __restrict__ gates, int T, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int b0 = (int)(blockIdx.x / MMK_LSTM_CLUSTER) * BC;
  const int U = H / MMK_LSTM_CLUSTER, NC = 4 * U, H4 = 4 * H;
  const int KS = MMK_LSTM_THREADS / NC;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* ws = smem;                     // (H, NC): ws[k*NC + j] = Wh[k, col(j)]
  float* hs = ws + (size_t)H * NC;      // (BC, H): h_{t-1} of the group's rows
  float* hown = hs + BC * H;            // (2, BC, U): this block's new h, by step parity
  float* red = hown + 2 * BC * U;       // (KS, BC, NC): partial recurrent sums

  for (int idx = tid; idx < H * NC; idx += MMK_LSTM_THREADS) {
    const int k = idx / NC, j = idx % NC;
    ws[idx] = wh[(size_t)k * H4 + (j / U) * H + q * U + (j % U)];
  }
  for (int idx = tid; idx < BC * H; idx += MMK_LSTM_THREADS) {
    const int b = b0 + idx / H;
    hs[idx] = b < B ? h0[(size_t)b * H + idx % H] : 0.0f;
  }
  const bool own = tid < BC * U;
  const int r = own ? tid / U : 0, u = own ? tid % U : 0;
  const int b = b0 + r, hu = q * U + u;
  const bool valid = own && b < B;
  float c = valid ? c0[(size_t)b * H + hu] : 0.0f;
  float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (valid)
    for (int g = 0; g < 4; ++g) xv[g] = xi[(size_t)b * H4 + g * H + hu];
  const int j = tid % NC, s = tid / NC;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (s < KS) {
      float acc[BC];
#pragma unroll
      for (int rr = 0; rr < BC; ++rr) acc[rr] = 0.0f;
      for (int k = s; k < H; k += KS) {
        const float w = ws[k * NC + j];
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
      const float h = og * tanhf(c);
      hnew[tid] = h;
      if (valid) {
        const size_t row = (size_t)t * B + b;
        h_all[row * H + hu] = h;
        c_all[row * H + hu] = c;
        float* gr = gates + row * H4 + hu;
        gr[0] = ig;
        gr[H] = fg;
        gr[2 * H] = gg;
        gr[3 * H] = og;
        if (t + 1 < T)
          for (int g = 0; g < 4; ++g) xv[g] = xi[(row + B) * H4 + g * H + hu];
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
template <int BC>
__global__ void __cluster_dims__(MMK_LSTM_CLUSTER, 1, 1) __launch_bounds__(MMK_LSTM_THREADS)
lstm_bwd_kernel(const float* __restrict__ dh_all, const float* __restrict__ dh_T,
                const float* __restrict__ dc_T, const float* __restrict__ gates,
                const float* __restrict__ c_all, const float* __restrict__ c0,
                const float* __restrict__ wh, float* __restrict__ dxi,
                float* __restrict__ dh0, float* __restrict__ dc0, int T, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int b0 = (int)(blockIdx.x / MMK_LSTM_CLUSTER) * BC;
  const int U = H / MMK_LSTM_CLUSTER, NC = 4 * U, H4 = 4 * H;
  const int KS2 = MMK_LSTM_THREADS / U;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* wt = smem;                     // (4H, U)
  float* dgs = wt + (size_t)H4 * U;     // (BC, 4H): dz of the group's rows, global columns
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
  float dhc = valid ? dh_T[(size_t)b * H + hu] : 0.0f;
  float dcc = valid ? dc_T[(size_t)b * H + hu] : 0.0f;
  const int uj = tid % U, s = tid / U;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    float* dgnew = dgown + (t & 1) * BC * NC;
    if (own) {
      float dz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (valid) {
        const size_t row = (size_t)t * B + b;
        const float* gr = gates + row * H4 + hu;
        const float ig = gr[0], fg = gr[H], gg = gr[2 * H], og = gr[3 * H];
        const float tc = tanhf(c_all[row * H + hu]);
        const float cp = t > 0 ? c_all[(row - B) * H + hu] : c0[(size_t)b * H + hu];
        const float dh = dh_all[row * H + hu] + dhc;
        const float dc = dcc + dh * og * (1.0f - tc * tc);
        dz[0] = dc * gg * ig * (1.0f - ig);
        dz[1] = dc * cp * fg * (1.0f - fg);
        dz[2] = dc * ig * (1.0f - gg * gg);
        dz[3] = dh * tc * og * (1.0f - og);
        float* dr = dxi + row * H4 + hu;
        dr[0] = dz[0];
        dr[H] = dz[1];
        dr[2 * H] = dz[2];
        dr[3 * H] = dz[3];
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
        const float w = wt[col * U + uj];
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
    dh0[(size_t)b * H + hu] = dhc;
    dc0[(size_t)b * H + hu] = dcc;
  }
  cluster.sync();
}

// Partial dWh of rows [z*rows, (z+1)*rows) for z = blockIdx.z:
// part[z][m, n] = sum_r hprev[r, m] * dxi[r, n], where hprev row r is h0[r]
// for r < B and h_all[r - B] after (h_{t-1} of row (t, b)).
#define DWH_TM 64
#define DWH_TN 64
#define DWH_TK 16

__global__ void __launch_bounds__(256)
lstm_dwh_kernel(const float* __restrict__ h0, const float* __restrict__ h_all,
                const float* __restrict__ dxi, float* __restrict__ part, int R, int B, int M,
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
        v = rw < B ? h0[(size_t)rw * M + m] : h_all[(size_t)(rw - B) * M + m];
      As[rr][mm] = v;
    }
    for (int idx = tid; idx < DWH_TK * DWH_TN; idx += 256) {
      const int rr = idx / DWH_TN, nn = idx % DWH_TN;
      const int rw = r0 + rr, n = n0 + nn;
      Bs[rr][nn] = (rw < r_end && n < N) ? dxi[(size_t)rw * N + n] : 0.0f;
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

// dwh[i] = sum_z part[z][i], z = 0 .. splits-1 in order.
__global__ void __launch_bounds__(256)
lstm_dwh_sum_kernel(const float* __restrict__ part, float* __restrict__ dwh, int splits,
                    int MN) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= MN) return;
  float v = 0.0f;
  for (int z = 0; z < splits; ++z) v += part[(size_t)z * MN + i];
  dwh[i] = v;
}

static size_t fwd_smem(int H, int bc) {
  const int U = H / MMK_LSTM_CLUSTER, NC = 4 * U, KS = MMK_LSTM_THREADS / NC;
  return sizeof(float) * ((size_t)H * NC + (size_t)bc * H + 2 * bc * U + (size_t)KS * bc * NC);
}

static size_t bwd_smem(int H, int bc) {
  const int U = H / MMK_LSTM_CLUSTER, NC = 4 * U, KS2 = MMK_LSTM_THREADS / U;
  return sizeof(float) *
         ((size_t)4 * H * U + (size_t)bc * 4 * H + 2 * bc * NC + (size_t)KS2 * bc * U);
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

extern "C" {

// Shared memory (bytes) the forward and backward need for hidden size H and
// `bc` batch rows per cluster; the wrapper checks them against the card.
long long mmk_lstm_fwd_smem(int H, int bc) { return (long long)fwd_smem(H, bc); }
long long mmk_lstm_bwd_smem(int H, int bc) { return (long long)bwd_smem(H, bc); }

// Each entry launches on `stream` (PyTorch's current stream), does not
// synchronise, and returns the cudaError_t of the launch (0 on success).
int mmk_lstm_forward(const float* xi, const float* wh, const float* h0, const float* c0,
                     float* h_all, float* c_all, float* gates, int T, int B, int H, int bc,
                     void* stream) {
  void* args[] = {&xi, &wh, &h0, &c0, &h_all, &c_all, &gates, &T, &B, &H};
  const size_t smem = fwd_smem(H, bc);
  cudaStream_t s = (cudaStream_t)stream;
  switch (bc) {
    case 1: return launch_cluster(lstm_fwd_kernel<1>, smem, B, bc, s, args);
    case 2: return launch_cluster(lstm_fwd_kernel<2>, smem, B, bc, s, args);
    case 4: return launch_cluster(lstm_fwd_kernel<4>, smem, B, bc, s, args);
    case 8: return launch_cluster(lstm_fwd_kernel<8>, smem, B, bc, s, args);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The reverse-time walk (dxi, dh0, dc0), then dWh over the stored dxi in
// `splits` row ranges (partial tiles in `dwh_part`, splits x H x 4H, summed
// into dwh; with one split dwh is written directly and dwh_part unused).
int mmk_lstm_backward(const float* dh_all, const float* dh_T, const float* dc_T,
                      const float* gates, const float* c_all, const float* h_all,
                      const float* h0, const float* c0, const float* wh, float* dxi,
                      float* dwh, float* dwh_part, float* dh0, float* dc0, int T, int B,
                      int H, int bc, int splits, void* stream) {
  void* args[] = {&dh_all, &dh_T, &dc_T, &gates, &c_all, &c0, &wh, &dxi, &dh0, &dc0,
                  &T, &B, &H};
  const size_t smem = bwd_smem(H, bc);
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (bc) {
    case 1: err = launch_cluster(lstm_bwd_kernel<1>, smem, B, bc, s, args); break;
    case 2: err = launch_cluster(lstm_bwd_kernel<2>, smem, B, bc, s, args); break;
    case 4: err = launch_cluster(lstm_bwd_kernel<4>, smem, B, bc, s, args); break;
    case 8: err = launch_cluster(lstm_bwd_kernel<8>, smem, B, bc, s, args); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const int M = H, N = 4 * H, R = T * B;
  const int rows = (R + splits - 1) / splits;
  const dim3 grid((N + DWH_TN - 1) / DWH_TN, (M + DWH_TM - 1) / DWH_TM, splits);
  lstm_dwh_kernel<<<grid, 256, 0, s>>>(h0, h_all, dxi, splits > 1 ? dwh_part : dwh, R, B, M,
                                       N, rows);
  if (splits > 1) {
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    lstm_dwh_sum_kernel<<<(M * N + 255) / 256, 256, 0, s>>>(dwh_part, dwh, splits, M * N);
  }
  return (int)cudaGetLastError();
}

const char* mmk_lstm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
