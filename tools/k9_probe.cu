// Variants of the categorical sampler's kernel (K9, csrc/categorical.cu) at
// f32 logits, to split its device time: tools/k9_probe.py builds this file,
// times each variant in a CUDA graph and digests its SASS beside the Triton
// kernel's.  The file includes the production source, so variant 0 is the
// production kernel itself.
//
// Variants (mmk_k9_probe's `variant`):
//   0  the production launch (categorical_launch<float>)
//   1  an empty kernel on the production launch's grid and block
//   2  the production kernel's shape and loads, the argmax of x alone
//   3  as 2, of x / t (the division, no noise)
//   4  as 2, of x / t + Gumbel with __fdividef and __logf (fast arithmetic)
//   5  the production kernel on one warp a row, one row a block (Triton's
//      launch shape: num_warps=1 at Q <= 256)
//   6  as 5, rows of 8 a block
//   7  the kernel before its division was hoisted and its passes
//      straightened: a loop of two four-logit loads in flight, `/` for every
//      logit, on the production launch's grid (a row of 64 threads a block)
//   8  Q = 256 unrolled: 8 logits a thread on one warp a row, one row a block,
//      every noise drawn before the loads are used (Triton's order)
//   9  as 8, the loads first
//  10  as 8 on 64 threads a row (4 logits a thread)
//  11  as 8, 4 rows a block
//  12  as 2 on one warp a row, one row a block (no shared memory)
//  13  the Triton kernel's own cubin (mmk_k9_load_cubin), launched from here
//      through the driver API on its grid (a warp a row, a row a block)
//  14  the production kernel launched through the driver API (cuLaunchKernel)
//      on the production grid
//
// mmk_k9_div_check counts, over every significand of x in [1, 2) (and its
// negation) at each of `nt` temperatures, the quotients in which the
// production kernel's division (cat_quot) differs in a bit from `/`.
#include "../mimikit_tpu_torch/csrc/categorical.cu"

#include <cuda.h>
#include <dlfcn.h>

// Driver entry points, from libcuda by dlopen (the library links no libcuda).
typedef CUresult (*k9_load_t)(CUmodule*, const void*);
typedef CUresult (*k9_get_t)(CUfunction*, CUmodule, const char*);
typedef CUresult (*k9_launch_t)(CUfunction, unsigned, unsigned, unsigned, unsigned, unsigned,
                                unsigned, unsigned, CUstream, void**, void**);
static void* k9_libcuda = nullptr;
static k9_launch_t k9_launch = nullptr;
static CUfunction k9_triton = nullptr;

static int k9_driver() {
  if (k9_launch) return 0;
  k9_libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
  if (!k9_libcuda) return -1;
  typedef CUresult (*k9_init_t)(unsigned);
  void* init = dlsym(k9_libcuda, "cuInit");
  if (!init || ((k9_init_t)init)(0) != CUDA_SUCCESS) return -4;
  k9_launch = (k9_launch_t)dlsym(k9_libcuda, "cuLaunchKernel");
  return k9_launch ? 0 : -2;
}

__global__ void k9_empty_kernel() {}

// Variant 7: the kernel before its division was hoisted and its passes
// straightened: a loop of two four-logit loads in flight, `/` for every logit.
template <int TPR>
__global__ void __launch_bounds__(CAT_THREADS)
k9_before_kernel(const float* __restrict__ logits, int32_t* __restrict__ out, int rows, int Q,
                 float temperature, uint32_t seed) {
  const int j = threadIdx.x % TPR;
  const int r = blockIdx.x * (blockDim.x / TPR) + threadIdx.x / TPR;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  if (r < rows) {
    const float* row = logits + (long long)r * Q;
    const uint32_t key = mix32(mix32(seed) ^ (uint32_t)r);
    const int nv = Q / 4;
    for (int c = j; c < nv; c += 2 * TPR) {
      const bool two = c + TPR < nv;
      float v[8];
      cat_ld4(row + 4 * c, v);
      if (two) cat_ld4(row + 4 * (c + TPR), v + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cat_keep(v[i] / temperature + gumbel_from_bits(mix32(key ^ (uint32_t)(4 * c + i))),
                 4 * c + i, bv, bi);
      if (two)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cat_keep(v[4 + i] / temperature +
                       gumbel_from_bits(mix32(key ^ (uint32_t)(4 * (c + TPR) + i))),
                   4 * (c + TPR) + i, bv, bi);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, bv, off);
    const int i = __shfl_xor_sync(0xffffffffu, bi, off);
    cat_keep(v, i, bv, bi);
  }
  if constexpr (TPR > 32) {
    __shared__ float sv[CAT_THREADS / 32];
    __shared__ int si[CAT_THREADS / 32];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) sv[warp] = bv, si[warp] = bi;
    __syncthreads();
    if (j == 0)
      for (int w = 1; w < TPR / 32; ++w) cat_keep(sv[warp + w], si[warp + w], bv, bi);
  }
  if (j == 0 && r < rows) out[r] = bi == 0x7fffffff ? 0 : bi;
}

// Variants 8-11: a row of Q = TPR * EPT logits, thread j holding the four at
// 4 (j + TPR k) + i for k < EPT / 4, every loop unrolled.
template <int TPR, int EPT, bool NOISE_FIRST>
__global__ void __launch_bounds__(CAT_THREADS)
k9_unrolled_kernel(const float* __restrict__ logits, int32_t* __restrict__ out, int rows,
                   float temperature, uint32_t seed) {
  const int j = threadIdx.x % TPR;
  const int r = blockIdx.x * (blockDim.x / TPR) + threadIdx.x / TPR;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  if (r < rows) {
    const float* row = logits + (long long)r * (TPR * EPT);
    const uint32_t key = mix32(mix32(seed) ^ (uint32_t)r);
    const CatDiv d = cat_div(temperature);
    float g[EPT], v[EPT];
    if (NOISE_FIRST)
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        g[e] = gumbel_from_bits(mix32(key ^ (uint32_t)(4 * (j + TPR * (e / 4)) + e % 4)));
#pragma unroll
    for (int k = 0; k < EPT / 4; ++k) cat_ld4(row + 4 * (j + TPR * k), v + 4 * k);
    if (!NOISE_FIRST)
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        g[e] = gumbel_from_bits(mix32(key ^ (uint32_t)(4 * (j + TPR * (e / 4)) + e % 4)));
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      cat_keep(cat_quot(d, v[e]) + g[e], 4 * (j + TPR * (e / 4)) + e % 4, bv, bi);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, bv, off);
    const int i = __shfl_xor_sync(0xffffffffu, bi, off);
    cat_keep(v, i, bv, bi);
  }
  if constexpr (TPR > 32) {
    __shared__ float sv[CAT_THREADS / 32];
    __shared__ int si[CAT_THREADS / 32];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) sv[warp] = bv, si[warp] = bi;
    __syncthreads();
    if (j == 0)
      for (int w = 1; w < TPR / 32; ++w) cat_keep(sv[warp + w], si[warp + w], bv, bi);
  }
  if (j == 0 && r < rows) out[r] = bi == 0x7fffffff ? 0 : bi;
}

__global__ void k9_div_check_kernel(const float* __restrict__ ts,
                                    unsigned long long* __restrict__ bad) {
  const uint32_t m = blockIdx.x * blockDim.x + threadIdx.x;  // a significand
  const float t = ts[blockIdx.y];
  const CatDiv d = cat_div(t);
  const float x = __uint_as_float(0x3f800000u | (m & 0x7fffffu));
  const int n = (__float_as_uint(cat_quot(d, x)) != __float_as_uint(x / t)) +
                (__float_as_uint(cat_quot(d, -x)) != __float_as_uint(-x / t));
  if (n) atomicAdd(bad, (unsigned long long)n);
}

template <int TPR, int MODE>
__global__ void __launch_bounds__(CAT_THREADS)
k9_part_kernel(const float* __restrict__ logits, int32_t* __restrict__ out, int rows, int Q,
               float temperature, uint32_t seed) {
  const int j = threadIdx.x % TPR;
  const int r = blockIdx.x * (blockDim.x / TPR) + threadIdx.x / TPR;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  if (r < rows) {
    const float* row = logits + (long long)r * Q;
    const uint32_t key = mix32(mix32(seed) ^ (uint32_t)r);
    for (int c = j; c < Q / 4; c += TPR) {
      float v[4];
      cat_ld4(row + 4 * c, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * c + i;
        float s = v[i];
        if (MODE >= 1) s = MODE == 2 ? __fdividef(s, temperature) : s / temperature;
        if (MODE == 2) {
          const float u = (float)(mix32(key ^ (uint32_t)q) >> 8) * (1.0f / 16777216.0f) + 1e-12f;
          s += -__logf(-__logf(u));
        }
        cat_keep(s, q, bv, bi);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, bv, off);
    const int i = __shfl_xor_sync(0xffffffffu, bi, off);
    cat_keep(v, i, bv, bi);
  }
  if constexpr (TPR > 32) {
    __shared__ float sv[CAT_THREADS / 32];
    __shared__ int si[CAT_THREADS / 32];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) sv[warp] = bv, si[warp] = bi;
    __syncthreads();
    if (j == 0)
      for (int w = 1; w < TPR / 32; ++w) cat_keep(sv[warp + w], si[warp + w], bv, bi);
  }
  if (j == 0 && r < rows) out[r] = bi == 0x7fffffff ? 0 : bi;
}

extern "C" {

// Loads the Triton kernel's cubin `image` (its function `name`) for variant 13.
int mmk_k9_load_cubin(const void* image, const char* name) {
  if (int e = k9_driver()) return e;
  void* load = dlsym(k9_libcuda, "cuModuleLoadData");
  void* get = dlsym(k9_libcuda, "cuModuleGetFunction");
  if (!load || !get) return -3;
  cudaFree(nullptr);  // the runtime makes the device's primary context current
  CUmodule mod;
  CUresult r = ((k9_load_t)load)(&mod, image);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  r = ((k9_get_t)get)(&k9_triton, mod, name);
  return r == CUDA_SUCCESS ? 0 : 2000 + (int)r;
}

// Launches the division check over `nt` temperatures `ts` (on the card),
// adding the quotients that differ to `*bad`.
int mmk_k9_div_check(const float* ts, int nt, unsigned long long* bad, void* stream) {
  k9_div_check_kernel<<<dim3((1u << 23) / 256, nt), 256, 0, (cudaStream_t)stream>>>(ts, bad);
  return (int)cudaGetLastError();
}

// One launch of `variant` on rows x Q f32 logits (rows contiguous, Q a
// multiple of 4, at most 256) into `out`; returns the launch's cudaError_t.
int mmk_k9_probe(int variant, const float* logits, int* out, int rows, int Q,
                 float temperature, unsigned int seed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 one_a_row(rows), block(64);
  switch (variant) {
    case 0:
      categorical_launch<float>(logits, out, rows, Q, Q, temperature, seed, 1, s);
      break;
    case 1:
      k9_empty_kernel<<<one_a_row, block, 0, s>>>();
      break;
    case 2:
      k9_part_kernel<64, 0><<<one_a_row, block, 0, s>>>(logits, out, rows, Q, temperature, seed);
      break;
    case 3:
      k9_part_kernel<64, 1><<<one_a_row, block, 0, s>>>(logits, out, rows, Q, temperature, seed);
      break;
    case 4:
      k9_part_kernel<64, 2><<<one_a_row, block, 0, s>>>(logits, out, rows, Q, temperature, seed);
      break;
    case 5:
      categorical_kernel<float, 32><<<rows, 32, 0, s>>>(logits, out, rows, Q, Q, temperature,
                                                         seed, 1);
      break;
    case 6:
      categorical_kernel<float, 32><<<(rows + 7) / 8, 256, 0, s>>>(logits, out, rows, Q, Q,
                                                                   temperature, seed, 1);
      break;
    case 7:
      k9_before_kernel<64><<<one_a_row, block, 0, s>>>(logits, out, rows, Q, temperature, seed);
      break;
    case 8:
      if (Q != 256) return (int)cudaErrorInvalidValue;
      k9_unrolled_kernel<32, 8, true><<<rows, 32, 0, s>>>(logits, out, rows, temperature, seed);
      break;
    case 9:
      if (Q != 256) return (int)cudaErrorInvalidValue;
      k9_unrolled_kernel<32, 8, false><<<rows, 32, 0, s>>>(logits, out, rows, temperature, seed);
      break;
    case 10:
      if (Q != 256) return (int)cudaErrorInvalidValue;
      k9_unrolled_kernel<64, 4, true><<<rows, 64, 0, s>>>(logits, out, rows, temperature, seed);
      break;
    case 11:
      if (Q != 256) return (int)cudaErrorInvalidValue;
      k9_unrolled_kernel<32, 8, true><<<(rows + 3) / 4, 128, 0, s>>>(logits, out, rows,
                                                                      temperature, seed);
      break;
    case 12:
      k9_part_kernel<32, 0><<<rows, 32, 0, s>>>(logits, out, rows, Q, temperature, seed);
      break;
    case 13: {  // (logits, out, Q, stride, temperature, mix32(seed), two scratch pointers)
      if (!k9_triton || !k9_launch) return (int)cudaErrorInvalidValue;
      uint32_t q = Q, stride = Q, key = seed;
      key ^= key >> 16, key *= 0x7feb352du, key ^= key >> 15, key *= 0x846ca68bu, key ^= key >> 16;
      void* none = nullptr;
      void* args[] = {&logits, &out, &q, &stride, &temperature, &key, &none, &none};
      return (int)k9_launch(k9_triton, rows, 1, 1, 32, 1, 1, 0, (CUstream)s, args, nullptr);
    }
    case 14: {
      if (int e = k9_driver()) return e;
      cudaFunction_t f;
      if (cudaGetFuncBySymbol(&f, (const void*)categorical_kernel<float, 64>) != cudaSuccess)
        return (int)cudaErrorInvalidValue;
      long long stride = Q;
      int vec = 1;
      void* args[] = {&logits, &out, &rows, &Q, &stride, &temperature, &seed, &vec};
      return (int)k9_launch((CUfunction)f, rows, 1, 1, 64, 1, 1, 0, (CUstream)s, args, nullptr);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
