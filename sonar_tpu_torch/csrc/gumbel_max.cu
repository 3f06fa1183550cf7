// The sampling step's draw and choice in one kernel, for Hopper: Gumbel-max
// with JAX's own counter-based noise.
//
// Replaces no Pallas kernel. The JAX package samples a token with
// jax.random.categorical(fold_in(PRNGKey(seed), step), filtered), which XLA
// computes (sonar_tpu/generation/sampling.py:123-124); this kernel computes
// the same function on the card, so that the port samples the tokens JAX
// samples from the same seed, and so that the draw can run inside a CUDA
// graph looped on the device: a generator's offset is fixed at capture, while
// this draw depends only on the key words and the device step counter.
//
// What it computes (JAX 0.9's threefry-2x32 in its partitionable mode,
// M = 2^32 - 1), for each row r of filtered [B, V] (fp32):
//   k_t = threefry2x32(key, (0, step))                 fold_in(key, step)
//   c = (row0 + r) * V + v;  (x0, x1) = threefry2x32(k_t, (c >> 32, c & M))
//   bits = x0 ^ x1
//   u = max(tiny, bitcast_f32((bits >> 9) | 0x3f800000) - 1 + tiny)
//   g = -logf(-logf(u))
//   tok[r] = argmax_v(filtered[r, v] + g), the lowest index on ties
// row0 is the row's global index: a rank of a data split draws the rows the
// whole batch would give it. logf, not __logf, and no fast-math flags: the
// noise is the plain PyTorch version's (torch.log) bit for bit.
//
// What bounds it on the H100: integer operations. Each element costs one
// threefry-2x32 (20 rounds of add, rotate, xor and 5 key injections: ~70
// 32-bit integer operations) against 4 bytes read: at [32, 256206], 8.2 M
// elements, ~0.6 G integer operations take ~35 us on the card's 64 INT32
// lanes an SM, the 32.8 MB of logits ~9.8 us at 3.35 TB/s.
//
// Design: a grid of (chunks of GM_CHUNK columns, rows) of 256 threads, 16
// columns a thread, neighbouring threads on neighbouring columns. Each
// thread keeps the largest (score, index) pair as one 64-bit key whose
// unsigned order is the argmax order (score bits made orderable in the high
// word, the index reversed in the low word, so the lower index wins a tie;
// -0.0 is taken as +0.0 and every NaN as above every number, as jnp.argmax
// orders them). A block reduces its keys and folds them into the row's slot
// with atomicMax; the last block of the row to arrive (a ticket counter)
// writes tok[r]. The wrapper zeroes the slots and tickets before each launch.
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int GM_THREADS = 256;
constexpr int GM_PER_THREAD = 16;
constexpr int GM_CHUNK = GM_THREADS * GM_PER_THREAD;

#define GM_ROUND(r)                   \
  x0 += x1;                           \
  x1 = __funnelshift_l(x1, x1, (r));  \
  x1 ^= x0;

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  GM_ROUND(13) GM_ROUND(15) GM_ROUND(26) GM_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  GM_ROUND(17) GM_ROUND(29) GM_ROUND(16) GM_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  GM_ROUND(13) GM_ROUND(15) GM_ROUND(26) GM_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  GM_ROUND(17) GM_ROUND(29) GM_ROUND(16) GM_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  GM_ROUND(13) GM_ROUND(15) GM_ROUND(26) GM_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// The argmax order as an unsigned 64-bit order: larger score first, then the
// lower index.
__device__ __forceinline__ unsigned long long order_key(float s, uint32_t v) {
  uint32_t u;
  if (s != s) {
    u = 0xffffffffu;
  } else {
    u = s == 0.0f ? 0u : __float_as_uint(s);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return ((unsigned long long)u << 32) | (unsigned long long)(0xffffffffu - v);
}

__global__ void __launch_bounds__(GM_THREADS)
gumbel_max_kernel(const float* __restrict__ filtered, const long long* __restrict__ key,
                  const long long* __restrict__ step, long long row0, int V,
                  unsigned long long* __restrict__ best, unsigned int* __restrict__ arrived,
                  long long* __restrict__ tok, float* __restrict__ noise) {
  const int r = blockIdx.y;
  const uint2 kt = threefry2x32((uint32_t)key[0], (uint32_t)key[1], 0u, (uint32_t)*step);
  const unsigned long long base = (unsigned long long)(row0 + r) * (unsigned long long)V;
  const float* row = filtered + (size_t)r * V;
  unsigned long long mine = 0ull;
  const int v0 = blockIdx.x * GM_CHUNK + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < GM_PER_THREAD; ++i) {
    const int v = v0 + i * GM_THREADS;
    if (v < V) {
      const unsigned long long c = base + (unsigned long long)v;
      const uint2 x = threefry2x32(kt.x, kt.y, (uint32_t)(c >> 32), (uint32_t)c);
      const uint32_t bits = x.x ^ x.y;
      const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
      const float u = fmaxf(FLT_MIN, f + FLT_MIN);
      const float g = -logf(-logf(u));
      if (noise != nullptr) noise[(size_t)r * V + v] = g;
      const unsigned long long k = order_key(row[v] + g, (uint32_t)v);
      mine = k > mine ? k : mine;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, mine, o);
    mine = other > mine ? other : mine;
  }
  __shared__ unsigned long long warp_best[GM_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < GM_THREADS / 32; ++w) mine = warp_best[w] > mine ? warp_best[w] : mine;
    atomicMax(best + r, mine);
    __threadfence();
    if (atomicAdd(arrived + r, 1u) == gridDim.x - 1) {
      __threadfence();
      const unsigned long long b = atomicMax(best + r, 0ull);
      tok[r] = (long long)(0xffffffffu - (uint32_t)(b & 0xffffffffull));
    }
  }
}

}  // namespace

// filtered [B, V] fp32, key [2] int64 (uint32 words), step 0-d int64, all on
// the card; scratch: 2 * B zeroed int64 words (B 64-bit slots, then B 32-bit
// tickets); tok [B] int64 out; noise [B, V] fp32 out, or null.
extern "C" int sonar_gumbel_max(const float* filtered, const long long* key,
                                const long long* step, long long row0, int B, int V,
                                void* scratch, long long* tok, float* noise, void* stream) {
  if (B < 1 || B > 65535 || V < 1 || row0 < 0) return (int)cudaErrorInvalidValue;
  unsigned long long* best = static_cast<unsigned long long*>(scratch);
  unsigned int* arrived = reinterpret_cast<unsigned int*>(best + B);
  const dim3 grid((V + GM_CHUNK - 1) / GM_CHUNK, B);
  gumbel_max_kernel<<<grid, GM_THREADS, 0, (cudaStream_t)stream>>>(
      filtered, key, step, row0, V, best, arrived, tok, noise);
  return (int)cudaGetLastError();
}
