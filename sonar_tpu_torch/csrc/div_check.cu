// Self-check of the softmax division of the bf16 attention core
// (attention.cuh: tc_normalise, which divides with tc_div and sends
// numerators below 2^-100 to __fdiv_rn) against __fdiv_rn, bit for bit, over
// the operands a softmax row gives it: numerators expf(-x) with x in
// [0, 110] (down through the subnormals to 0) and numerators of random bits
// in (0, 1); denominators in [1, 1279], every 16th with an all-ones mantissa.
// chip_smoke.py's phase (c) and the GPU tests run it.
#include "attention.cuh"

__device__ __forceinline__ uint32_t dc_hash(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  return x ^ (x >> 16);
}

// counts[0] += pairs checked, counts[1] += tc_normalise's quotients that
// differ from __fdiv_rn's, counts[2] += tc_div's alone that differ with a
// numerator >= 2^-100 (where tc_normalise uses it).
__global__ void div_check_kernel(unsigned long long iters, unsigned long long seed,
                                 unsigned long long* counts) {
  unsigned long long c[3] = {0, 0, 0};
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  // Every lane runs every round (tc_normalise votes across the warp); lanes
  // past `iters` do not count.
  for (unsigned long long base = 0; base < iters; base += stride) {
    const unsigned long long i =
        base + blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
    const bool counted = i < iters;
    uint32_t h = dc_hash((uint32_t)i ^ dc_hash((uint32_t)(i >> 32) + (uint32_t)seed));
    float x[1][4], s[2], r[2], e[4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      h = dc_hash(h + 0x9e3779b9U);
      s[k] = 1.f + (h & 0xffffff) * (1023.f / 16777216.f) + (h >> 24);
      if (((i >> k) & 15) == 1)
        s[k] = __uint_as_float((__float_as_uint(s[k]) & 0xff800000u) | 0x7fffffu);
      r[k] = __frcp_rn(s[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h = dc_hash(h + 0x9e3779b9U);
      e[k] = (h & 7) == 0 ? __uint_as_float(dc_hash(h) & 0x3f7fffffu)
                          : expf(-(float)(h >> 8) * (110.f / 16777216.f));
      x[0][k] = e[k];
    }
    tc_normalise(x, s, r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t want = __float_as_uint(__fdiv_rn(e[k], s[k >> 1]));
      c[1] += counted && __float_as_uint(x[0][k]) != want;
      c[2] += counted && e[k] >= 0x1p-100f &&
              __float_as_uint(tc_div(e[k], s[k >> 1], r[k >> 1])) != want;
    }
    c[0] += counted ? 4 : 0;
  }
  for (int k = 0; k < 3; ++k) atomicAdd(counts + k, c[k]);
}

extern "C" int sonar_check_softmax_division(unsigned long long iters, unsigned long long seed,
                                            unsigned long long* counts, void* stream) {
  div_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(iters, seed, counts);
  return cudaGetLastError();
}
