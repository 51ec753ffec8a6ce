/* f32 rsqrt as XLA's CPU backend computes it, for the CPU's ops below f32.
 *
 * XLA lowers an f32 rsqrt on x86 to the CPU's approximation instruction and
 * two Newton steps, y' = fma(-y / 2, fma(x y, y, -1), y), and keeps the bare
 * approximation where x is not a positive normal number (0, subnormals,
 * infinities, negatives).  With XLA's default vector width of 256 bits (on
 * AVX-512 hosts too) the approximation is `vrsqrtps` on 8 floats and
 * `rsqrtss` on a loop's tail; on a host without AVX, `rsqrtps` on 4.  These
 * read one table on a given CPU, so an element's value does not depend on
 * its place in the array; the table itself differs between CPU vendors,
 * which is why the instruction is called here and not emulated.
 *
 * Built with the host's C compiler at first use (modules/xla_cpu_rsqrt.py).
 */
#include <immintrin.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

static float newton2(float x, float y0) {
  uint32_t bits;
  memcpy(&bits, &x, sizeof bits);
  uint32_t exp = (bits >> 23) & 0xffu;
  /* a positive normal number, or a NaN: refined; anything else: y0 */
  int refine = (!(bits >> 31) && exp != 0 && exp != 0xffu) || isnan(x);
  if (!refine) return y0;
  float y = y0;
  for (int i = 0; i < 2; ++i) {
    float e = fmaf(x * y, y, -1.0f);
    y = fmaf(y * -0.5f, e, y);
  }
  return y;
}

__attribute__((target("avx")))
static void approx_avx(const float* x, float* y, long n) {
  long i = 0;
  for (; i + 8 <= n; i += 8) _mm256_storeu_ps(y + i, _mm256_rsqrt_ps(_mm256_loadu_ps(x + i)));
  for (; i < n; ++i) y[i] = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set_ss(x[i])));
}

static void approx_sse(const float* x, float* y, long n) {
  long i = 0;
  for (; i + 4 <= n; i += 4) _mm_storeu_ps(y + i, _mm_rsqrt_ps(_mm_loadu_ps(x + i)));
  for (; i < n; ++i) y[i] = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set_ss(x[i])));
}

/* y[i] = XLA's rsqrt(x[i]) for i < n. */
void mmk_xla_cpu_rsqrt(const float* x, float* y, long n) {
  if (__builtin_cpu_supports("avx"))
    approx_avx(x, y, n);
  else
    approx_sse(x, y, n);
  for (long i = 0; i < n; ++i) y[i] = newton2(x[i], y[i]);
}
