// The port's sampling noise, shared by every decode kernel.
//
// A counter hash, not a generator: mix32 chained over the seed and the
// draw's keys (decode: seed, absolute step, stream, then the class), 24 bits
// kept, u = bits / 2^24 + 1e-12, g = -log(-log u).  The plain PyTorch twins
// compute the same hash (mimikit_tpu_torch/ops/noise.py), so a kernel and
// its twin draw identical noise, and a decode's noise does not depend on how
// its steps are split into launches.
#pragma once

#include <math.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// The key of one decode stream at absolute step t; a class q's bits are
// mix32(key ^ q).
__device__ __forceinline__ uint32_t decode_noise_key(uint32_t seed, long long t, int b) {
  return mix32(mix32(mix32(seed) ^ (uint32_t)t) ^ (uint32_t)b);
}

__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f) + 1e-12f;
  return -logf(-logf(u));
}
