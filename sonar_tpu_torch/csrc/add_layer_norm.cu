// Residual add + LayerNorm in one pass over each row, bf16 or fp32:
//   x_out = T(x + T(res_scale * branch))          (x when there is no branch)
//   ln    = T(((x_out - mean) * rstd) * w + b)   mean, var of x_out in fp32, eps 1e-5
//
// Replaces no Pallas kernel. The JAX Conformer block (sonar_tpu/nn/conformer.py
// conformer_block) writes its residual adds and its five LayerNorms
// (sonar_tpu/nn/core.py layer_norm) as plain jnp, which XLA fuses on the
// TPU. Eager PyTorch runs the same expression as about a dozen row-wide
// kernels an add + LN (the casts, two means, the subtractions, the square,
// the products, the bias), each reading and writing the whole row in fp32.
//
// What bounds it: bytes. With a branch and x_out it reads x and branch and
// writes x_out and ln, 4 D sizeof(T) bytes a row; without x_out 3; without a
// branch 2. That is two orders of magnitude below the card's ridge point, so
// the design's whole job is to touch each byte once: one warp a row, 8 rows
// a 256-thread block, each lane holding its share of the row in registers
// as 16-byte vectors (for D 1024 in bf16: 4 vectors of 8 values, 32 fp32
// registers), neighbouring lanes on neighbouring vectors. The statistics are
// taken from the registers by warp shuffles in two passes (the mean, then
// the mean of squared deviations), with no shared memory and no second read
// of the row. The LayerNorm's weight and bias (fp32 or T, as stored) are
// read through the read-only path, which every row of the block shares,
// and widened in registers (exact, as .float() is).
//
// Numerics: the eager path's roundings, step by step, with no contraction
// (__fmul_rn, __fadd_rn): T(res_scale * branch) is what `0.5 * f` gives in
// T; x_out is then bit-identical to `x + 0.5 * f`. The LayerNorm rounds
// where core.layer_norm does (the difference, the square, the product by
// rstd, by w, the bias); only the order of its fp32 sums differs.
#include "common.cuh"

namespace {

constexpr int ALN_THREADS = 256;  // 8 warps, one row each
constexpr int ALN_ROWS = ALN_THREADS / 32;

// Values of T in one 16-byte vector.
template <typename T> __host__ __device__ constexpr int vec_len() { return 16 / (int)sizeof(T); }

template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f);

template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// Two bf16 values in a 32-bit word, the lower address in the low half.
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

template <> __device__ __forceinline__ void unpack<bf16>(const uint4& u, float* f) {
  unpack_bf16x2(u.x, f);
  unpack_bf16x2(u.y, f + 2);
  unpack_bf16x2(u.z, f + 4);
  unpack_bf16x2(u.w, f + 6);
}

template <typename T> __device__ __forceinline__ uint4 pack(const float* f);

template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

template <> __device__ __forceinline__ uint4 pack<bf16>(const float* f) {
  return make_uint4(bf16x2_bits(f[0], f[1]), bf16x2_bits(f[2], f[3]), bf16x2_bits(f[4], f[5]),
                    bf16x2_bits(f[6], f[7]));
}

// E consecutive LayerNorm parameters from column `col`, stored as fp32 or
// bf16, widened to fp32.
template <int E>
__device__ __forceinline__ void load_params(const void* p, bool bf16_params, int col, float* f) {
  if (bf16_params) {
    const bf16* q = static_cast<const bf16*>(p) + col;
    if constexpr (E == 8) {
      unpack<bf16>(__ldg(reinterpret_cast<const uint4*>(q)), f);
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(q));
      unpack_bf16x2(u.x, f);
      unpack_bf16x2(u.y, f + 2);
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + col);
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 t = __ldg(q + i);
      f[4 * i] = t.x;
      f[4 * i + 1] = t.y;
      f[4 * i + 2] = t.z;
      f[4 * i + 3] = t.w;
    }
  }
}

// NV vectors a lane: D = NV * 32 * vec_len<T>(). Rows of up to 32 fp32
// values a lane run 4 blocks an SM (64 registers a thread), longer ones 2.
template <typename T, int NV>
__global__ void __launch_bounds__(ALN_THREADS, NV * vec_len<T>() <= 32 ? 4 : 2)
    add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ branch, long long M,
                          float res_scale, const void* __restrict__ w,
                          const void* __restrict__ b, bool bf16_params, T* __restrict__ x_out,
                          T* __restrict__ ln) {
  constexpr int E = vec_len<T>();
  constexpr int D = NV * 32 * E;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ALN_ROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t base = (size_t)row * D;

  // The row, in registers: vector j of a lane is the row's vector j * 32 + lane.
  float v[NV][E];
  {
    uint4 xr[NV];
    const uint4* xp = reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int j = 0; j < NV; ++j) xr[j] = xp[j * 32 + lane];
    if (branch != nullptr) {
      uint4 br[NV];
      const uint4* bp = reinterpret_cast<const uint4*>(branch + base);
#pragma unroll
      for (int j = 0; j < NV; ++j) br[j] = bp[j * 32 + lane];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float bv[E];
        unpack<T>(xr[j], v[j]);
        unpack<T>(br[j], bv);
#pragma unroll
        for (int e = 0; e < E; ++e)
          v[j][e] = round_to<T>(__fadd_rn(v[j][e], round_to<T>(__fmul_rn(res_scale, bv[e]))));
      }
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) unpack<T>(xr[j], v[j]);
    }
  }
  if (x_out != nullptr) {
    uint4* op = reinterpret_cast<uint4*>(x_out + base);
#pragma unroll
    for (int j = 0; j < NV; ++j) op[j * 32 + lane] = pack<T>(v[j]);
  }

  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) sum = __fadd_rn(sum, v[j][e]);
  const float mean = __fdiv_rn(warp_sum(sum), (float)D);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = __fsub_rn(v[j][e], mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)D), 1e-5f));

  uint4* lp = reinterpret_cast<uint4*>(ln + base);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * 32 + lane) * E;
    float wv[E], bv[E], out[E];
    load_params<E>(w, bf16_params, col, wv);
    load_params<E>(b, bf16_params, col, bv);
#pragma unroll
    for (int e = 0; e < E; ++e)
      out[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j][e], mean), rstd), wv[e]), bv[e]);
    lp[j * 32 + lane] = pack<T>(out);
  }
}

template <typename T, int K>  // D = 256 K
cudaError_t launch_rows(const void* x, const void* branch, long long M, float res_scale,
                        const void* w, const void* b, bool bf16_params, void* x_out, void* ln,
                        cudaStream_t st) {
  constexpr int NV = 256 * K / (32 * vec_len<T>());
  const long long blocks = (M + ALN_ROWS - 1) / ALN_ROWS;
  add_layer_norm_kernel<T, NV><<<(unsigned)blocks, ALN_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(branch), M, res_scale, w, b,
      bf16_params, static_cast<T*>(x_out), static_cast<T*>(ln));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_add_layer_norm(int D, const void* x, const void* branch, long long M,
                                  float res_scale, const void* w, const void* b,
                                  bool bf16_params, void* x_out, void* ln, cudaStream_t st) {
  switch (D / 256) {
#define ALN_CASE(K) \
  case K:           \
    return launch_rows<T, K>(x, branch, M, res_scale, w, b, bf16_params, x_out, ln, st);
    ALN_CASE(1) ALN_CASE(2) ALN_CASE(3) ALN_CASE(4) ALN_CASE(5) ALN_CASE(6) ALN_CASE(7)
    ALN_CASE(8)
#undef ALN_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, branch (may be null), x_out (may be null), ln: [M, D] of `kind`; w, b:
// [D] of `param_kind`. D a multiple of 256, at most 2048; every pointer
// 16-byte aligned.
extern "C" int sonar_add_layer_norm(const void* x, const void* branch, int kind, long long M,
                                    int D, float res_scale, const void* w, const void* b,
                                    int param_kind, void* x_out, void* ln, void* stream) {
  if (M < 1 || D < 256 || D > 2048 || D % 256 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool bf16_params = param_kind == KIND_BF16;
  if (kind == KIND_BF16)
    return launch_add_layer_norm<bf16>(D, x, branch, M, res_scale, w, b, bf16_params, x_out, ln,
                                       st);
  return launch_add_layer_norm<float>(D, x, branch, M, res_scale, w, b, bf16_params, x_out, ln,
                                      st);
}
