// Int8 building blocks shared by the fused FFN (ffn.cu) and the int8
// attention block (attn_block.cu):
//
// - row_quant_kernel: optional LayerNorm (fp32 statistics, eps 1e-5), then
//   symmetric per-row (or per row segment, of up to 16384 values) int8
//   quantisation, the segment held in registers
//   q = clip(rint(x / s), -127, 127), s = max(absmax / 127, 1e-12): the
//   division, and round-half-to-even, of the TPU kernels.
// - gemm_s8_kernel: C = A[M, K] int8 @ B[K, N] int8 with exact int32
//   accumulation on the tensor cores, followed by a dequantising epilogue.
//   B is the JAX [in, out] kernel stored column-major (as quantize_kernel
//   makes it), i.e. B^T [N, K] row-major: both operands are K-major, which
//   is what int8 wgmma takes from shared memory.
//
// Bound: at the encoder's shapes (M = 8192 tokens, K and N of 1024..8192)
// these products do 17..137 GOP each, far above the card's ridge point, so
// they are bound by the tensor cores. The design feeds them at wgmma's rate:
// a block of two consumer warpgroups (64 rows each, wgmma m64n128k32 from
// shared memory) and one producer warp that keeps a ring of 128 x 128-byte
// A and B tiles filled by TMA (128-byte swizzle, mbarriers: full when a
// tile's bytes have landed, empty when both warpgroups' products on it are
// done). No thread spends an instruction on a load, and the products of
// one tile overlap the loads of the next ones. Rows past M are TMA's zero
// fill and are not stored. The epilogues that write a large output (fp32
// h) run with two blocks on an SM, so one block's stores overlap the other's
// products; the split-sum epilogue keeps its running sum of the dequantised
// segments in shared memory and runs one block an SM with a deeper ring.
#pragma once

#include "hopper.cuh"

constexpr int GM_BM = 128, GM_BN = 128, GM_BK = 128;  // GM_BK bytes: one swizzled row
constexpr int GM_WG = 2;                               // consumer warpgroups, 64 rows each
constexpr int GM_THREADS = 128 * GM_WG + 32;           // + the producer warp
constexpr int GM_TILE_A = GM_BM * GM_BK, GM_TILE_B = GM_BN * GM_BK;
constexpr int GM_STAGE = GM_TILE_A + GM_TILE_B;        // bytes of one ring slot

enum Epilogue {
  EPI_BIAS = 0,       // out = (acc * rs) * cs + bias
  EPI_BIAS_RELU = 1,  // out = max((acc * rs) * cs + bias, 0)
  EPI_RESIDUAL = 2,   // out = residual + ((acc * rs) * cs + bias)
  EPI_SPLIT_SUM = 3,  // per K segment s: part_s = OutT((acc_s * rs[s]) * cs); out = OutT(sum parts + OutT(bias))
};

template <int EPI> struct GemmShape {
  static constexpr bool SPLIT = EPI == EPI_SPLIT_SUM;
  static constexpr int STAGES = SPLIT ? 4 : 3;
  static constexpr int MIN_BLOCKS = SPLIT ? 1 : 2;
  // EPI_SPLIT_SUM keeps the running sum of the dequantised segments in
  // shared memory (64 fp32 values a consumer thread), beside the ring.
  static constexpr size_t TOT = SPLIT ? (size_t)GM_BM * GM_BN * sizeof(float) : 0;
  static constexpr size_t SMEM =
      (size_t)STAGES * GM_STAGE + TOT + 2 * STAGES * sizeof(uint64_t) + 1024;
};

struct GemmArgs {
  const int8_t* a;         // [M, K] row-major
  const int8_t* bt;        // B^T: [N, K] row-major (B [K, N] column-major)
  int M, N, K;
  int seg;                 // K-length of one segment (K unless EPI_SPLIT_SUM)
  const float* row_scale;  // [M, K / seg]
  const float* col_scale;  // [N]
  const float* bias;       // [N]
  const void* residual;    // [M, N] OutT (EPI_RESIDUAL)
  void* out;               // [M, N] OutT
};

template <typename OutT> __device__ __forceinline__ void store2(OutT* p, float v0, float v1);
template <> __device__ __forceinline__ void store2<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float v0,
                                                                  float v1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(v0);
  v.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

template <int EPI, typename OutT>
__global__ void __launch_bounds__(GM_THREADS, GemmShape<EPI>::MIN_BLOCKS)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, GemmArgs g) {
  constexpr int ST = GemmShape<EPI>::STAGES;
  extern __shared__ unsigned char gm_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: the ring starts on it.
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gm_raw) + 1023) & ~(uintptr_t)1023);
  float* tot = reinterpret_cast<float*>(ring + ST * GM_STAGE);  // [64][256 threads]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * GM_STAGE + GemmShape<EPI>::TOT);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;
  const int KT = g.K / GM_BK;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * GM_WG);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * GM_WG) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(empty + s, (kt / ST - 1) & 1);
        mbar_expect_tx(full + s, GM_STAGE);
        tma_load_2d(ring + s * GM_STAGE, &map_a, full + s, kt * GM_BK, m0);
        tma_load_2d(ring + s * GM_STAGE + GM_TILE_A, &map_b, full + s, kt * GM_BK, n0);
      }
    }
    return;
  }

  const int wg = warp >> 2;  // rows 64 wg .. 64 wg + 63 of the tile
  const int row0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), col0 = n0 + 2 * (lane & 3);
  const uint32_t ring_a = smem_u32(ring) + wg * 64 * GM_BK, ring_b = smem_u32(ring) + GM_TILE_A;
  const int nseg = g.K / g.seg;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % ST;
    mbar_wait(full + s, (kt / ST) & 1);
    const bool fresh = (kt * GM_BK) % g.seg == 0;  // a segment starts: overwrite acc
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < GM_BK / 32; ++ks)
      wgmma_s8_m64n128k32(acc, wgmma_desc_sw128(ring_a + s * GM_STAGE + ks * 32),
                          wgmma_desc_sw128(ring_b + s * GM_STAGE + ks * 32),
                          fresh && ks == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous k tile's products are done: release its slot
    if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % ST);
    if constexpr (EPI == EPI_SPLIT_SUM) {
      if (((kt + 1) * GM_BK) % g.seg != 0) continue;
      wgmma_wait<0>();
      const int sg = kt * GM_BK / g.seg;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int m = row0 + ((i >> 1) & 1) * 8, n = col0 + (i >> 2) * 8 + (i & 1);
        const float rs = m < g.M ? g.row_scale[(size_t)m * nseg + sg] : 0.f;
        const float part =
            round_to<OutT>(__fmul_rn(__fmul_rn((float)acc[i], rs), g.col_scale[n]));
        float* t = tot + i * 128 * GM_WG + tid;
        *t = sg == 0 ? part : round_to<OutT>(__fadd_rn(*t, part));
      }
    }
  }
  wgmma_wait<0>();

  OutT* out = reinterpret_cast<OutT*>(g.out);
  const OutT* res = reinterpret_cast<const OutT*>(g.residual);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int m = row0 + ((i >> 1) & 1) * 8, n = col0 + (i >> 2) * 8;
    if (m >= g.M) continue;
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (EPI == EPI_SPLIT_SUM) {
        v[e] = round_to<OutT>(
            __fadd_rn(tot[(i + e) * 128 * GM_WG + tid], round_to<OutT>(g.bias[n + e])));
      } else {
        float y = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[i + e], g.row_scale[m]),
                                      g.col_scale[n + e]),
                            g.bias[n + e]);
        if (EPI == EPI_BIAS_RELU) y = fmaxf(y, 0.f);
        if (EPI == EPI_RESIDUAL) y = __fadd_rn(to_float(res[(size_t)m * g.N + n + e]), y);
        v[e] = y;
      }
    }
    store2<OutT>(out + (size_t)m * g.N + n, v[0], v[1]);
  }
}

template <int EPI, typename OutT>
static cudaError_t launch_gemm_s8(const GemmArgs& g, cudaStream_t stream) {
  if (g.M < 1 || g.N % GM_BN || g.K % GM_BK || g.seg % GM_BK || g.K % g.seg)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!tma_map_2d(&map_a, g.a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.M, g.K, g.K, GM_BM, GM_BK) ||
      !tma_map_2d(&map_b, g.bt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.N, g.K, g.K, GM_BN, GM_BK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = GemmShape<EPI>::SMEM;
  cudaError_t err = allow_dynamic_smem(gemm_s8_kernel<EPI, OutT>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(g.N / GM_BN, (g.M + GM_BM - 1) / GM_BM);
  gemm_s8_kernel<EPI, OutT><<<grid, GM_THREADS, smem, stream>>>(map_a, map_b, g);
  return cudaGetLastError();
}

// One block of 256 threads per (row, segment) of up to 256 x VPT values
// (VPT 4 .. 64, a power of two): each thread keeps its values in registers,
// four at a time as one vector load (chunk c of thread t holds the values
// 1024 c + 4 t .. + 3, so a warp reads 32 x 4 consecutive values), and the
// chunks past the segment's end hold nothing. The segment is read from
// device memory once and stored as 4-byte vectors of int8.
template <typename T> __device__ __forceinline__ void load4(const T* p, float (&v)[4]);
template <> __device__ __forceinline__ void load4<float>(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
template <> __device__ __forceinline__ void load4<bf16>(const bf16* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
  v[0] = __bfloat162float(h[0].x); v[1] = __bfloat162float(h[0].y);
  v[2] = __bfloat162float(h[1].x); v[3] = __bfloat162float(h[1].y);
}

constexpr int RQ_MAX_VPT = 64;  // the longest segment: 256 x 64 values

template <typename T, bool LN, int VPT>
__global__ void __launch_bounds__(256) row_quant_kernel(const T* x, int width, int seg,
                                                        const float* ln_w, const float* ln_b,
                                                        int8_t* q, float* scale) {
  constexpr int C = VPT / 4;
  __shared__ float red[8];
  const int row = blockIdx.x, s = blockIdx.y, nseg = gridDim.y;
  const size_t base = (size_t)row * width + (size_t)s * seg + 4 * threadIdx.x;
  float v[C][4];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (1024 * c + 4 * (int)threadIdx.x < seg) {
      load4<T>(x + base + 1024 * c, v[c]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[c][e] = 0.f;  // adds nothing to a sum, a max
    }
  }
  float amax = 0.f;
  if (LN) {  // one segment: the whole row
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum += v[c][e];
    const float mean = __fdiv_rn(block_reduce_256<false>(sum, red), (float)width);
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (1024 * c + 4 * (int)threadIdx.x >= seg) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[c][e] - mean;
        sq = fmaf(d, d, sq);
      }
    }
    const float var = __fdiv_rn(block_reduce_256<false>(sq, red), (float)width);
    const float rstd = rsqrtf(var + 1e-5f);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = 1024 * c + 4 * threadIdx.x;
      if (i >= seg) continue;
      const float4 w = *reinterpret_cast<const float4*>(ln_w + i);
      const float4 b = *reinterpret_cast<const float4*>(ln_b + i);
      const float wv[4] = {w.x, w.y, w.z, w.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[c][e] = __fadd_rn(__fmul_rn(__fmul_rn(v[c][e] - mean, rstd), wv[e]), bv[e]);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[c][e]));
  amax = block_reduce_256<true>(amax, red);
  const float sc = fmaxf(amax / 127.f, 1e-12f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (1024 * c + 4 * (int)threadIdx.x >= seg) continue;
    char4 r;
    r.x = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v[c][0], sc)), -127.f), 127.f);
    r.y = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v[c][1], sc)), -127.f), 127.f);
    r.z = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v[c][2], sc)), -127.f), 127.f);
    r.w = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v[c][3], sc)), -127.f), 127.f);
    *reinterpret_cast<char4*>(q + base + 1024 * c) = r;
  }
  if (threadIdx.x == 0) scale[(size_t)row * nseg + s] = sc;
}

// The smallest VPT of row_quant_kernel that holds the segment.
template <typename T, bool LN, int VPT = 4>
static cudaError_t launch_row_quant_as(const T* x, int rows, int width, int seg,
                                       const float* ln_w, const float* ln_b, int8_t* q,
                                       float* scale, cudaStream_t stream) {
  if constexpr (VPT < RQ_MAX_VPT) {
    if (seg > 256 * VPT)
      return launch_row_quant_as<T, LN, 2 * VPT>(x, rows, width, seg, ln_w, ln_b, q, scale,
                                                 stream);
  }
  row_quant_kernel<T, LN, VPT><<<dim3(rows, width / seg), 256, 0, stream>>>(x, width, seg, ln_w,
                                                                            ln_b, q, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_row_quant(const T* x, int rows, int width, int seg, const float* ln_w,
                                    const float* ln_b, int8_t* q, float* scale,
                                    cudaStream_t stream) {
  // Segments of whole 4-value vectors, at most 256 x RQ_MAX_VPT long.
  if (seg < 4 || seg % 4 || seg > 256 * RQ_MAX_VPT || width % seg || (ln_w && seg != width))
    return cudaErrorInvalidValue;
  return ln_w ? launch_row_quant_as<T, true>(x, rows, width, seg, ln_w, ln_b, q, scale, stream)
              : launch_row_quant_as<T, false>(x, rows, width, seg, ln_w, ln_b, q, scale, stream);
}
