// Conformer macaron half-FFN with its LayerNorm and residual, bf16 or fp32:
//   ln  = LN(x) (fp32 statistics, eps 1e-5, fp32 affine) rounded to T
//   h_s = silu(ln @ W1[:, s] + b1[s]) in fp32, rounded to T
//   y   = sum_s h_s @ W2[s, :] (each split's partial in fp32, summed in fp32
//         in split order)
//   out = T(x + res_scale * (y + b2))
//
// Replaces the TPU kernel sonar_tpu/ops/pallas/ffn.py fused_bf16_ffn_ln_residual
// (body _bf16_ffn_half_kernel). The TPU kernel kept a bf16 W1-split and
// W2-split (8 MB at D 1024, F 4096) resident in VMEM and the [rows, F / n]
// inner activation on chip. Hopper's 227 KB of shared memory holds neither,
// so this version is three launches with the inner activation written
// through a device scratch buffer:
//   1. the LayerNorm of x, rounded to T, into ln [M, D];
//   2. a GEMM ln @ W1 with a bias + SiLU epilogue into h [M, F] (T): the
//      splits of F are independent columns here, so one launch covers all;
//   3. a GEMM h @ W2 whose K loop keeps one fp32 partial per split of F and
//      sums the partials in fp32; its epilogue adds b2 and the residual.
// The weights are read as they are given (W1 [D, F], W2 [F, D], row-major):
// nothing is copied per call.
//
// What bounds it: the two GEMMs, 4 M D F flops (67 GFLOP at M 3992, D 1024,
// F 4096, 0.068 ms at the bf16 peak), far above the ridge point. In bf16
// both GEMMs are one kernel of the shape of csrc/int8_gemm.cuh: a producer
// warp keeps a ring of 128-byte-swizzled tiles in flight by TMA on
// mbarriers (A [128 rows x 64 k] K-major; B as two boxes of [64 k x 64 n],
// N contiguous, which wgmma reads MN-major through the descriptor's
// transpose bit), and two consumer warpgroups run wgmma m64n128k16 on a
// 128 x 128 output tile, fp32 accumulators in registers. GEMM1 runs two
// blocks an SM, so one block's epilogue (bias, SiLU) overlaps the other's
// products; GEMM2 keeps its per-split sums in registers beside the
// accumulators and runs one block an SM, its producer a whole warpgroup
// that hands registers to the consumers (setmaxnreg). Both epilogues stage
// the bf16 tile in shared memory (GEMM2 over its residual tile, which TMA
// loads at the start) and write it with TMA stores, which drop the rows
// past M (row-scattered 4-byte stores of h cost GEMM1 a quarter of its
// time; PERF.md §6). Wider tiles (128 x 256), GEMM2 without setmaxnreg and
// clusters sharing tiles by multicast measured slower. In bf16 a split of F must end on the
// 64-wide k step (F / n_splits % 64). fp32 keeps plain FMA loops (64 x 64
// block tiles, 4 x 4 outputs a thread), the weights read in place too. The
// round trip of h (M F x 2 bytes each way) is the memory cost a fused
// kernel would remove.
#include "hopper.cuh"

constexpr int BG_BM = 128, BG_BN = 128, BG_BK = 64;  // BG_BK bf16: one 128-byte swizzled row
constexpr int BG_WG = 2;                         // consumer warpgroups, 64 rows each
constexpr int BG_TILE_A = BG_BM * BG_BK * 2;     // [128 rows][64 k]
constexpr int BG_BOX_B = BG_BK * 64 * 2;         // [64 k][64 n]: one TMA box of B
constexpr int BG_STAGE = BG_TILE_A + 2 * BG_BOX_B;  // bytes of one ring slot
constexpr int BG_OUT = BG_BM * BG_BN * 2;        // the bf16 output tile

constexpr int FF_BM = 64, FF_BN = 64, FF_BK = 16;
constexpr int FF_LDS = FF_BM + 4;  // floats per shared row ([k][m] and [k][n] tiles)
constexpr int FF_THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

enum FfnEpilogue {
  FFN_SILU = 0,      // out = T(silu(acc + bias))
  FFN_RESIDUAL = 1,  // per K segment s: y += acc_s (fp32); out = T(x + res_scale * (y + bias))
};

// The shape of one GEMM launch (output tile 128 x 128). GEMM1 runs two
// blocks an SM, so one block's epilogue overlaps the other's products, and
// stages its output in the ring. GEMM2 (its per-split sum in registers
// beside the accumulators) runs one, with a deeper ring, and a whole
// producer warpgroup, so that setmaxnreg can move registers from it to the
// consumers (their accumulators and the per-split sums: 128 fp32 values a
// thread); it stages the residual tile, which TMA loads at the start, and
// its output in a buffer of their own.
template <int EPI> struct BgShape {
  static constexpr bool WIDE = EPI == FFN_RESIDUAL;
  static constexpr int MIN_BLOCKS = WIDE ? 1 : 2;
  static constexpr int THREADS = WIDE ? 128 * (BG_WG + 1) : 128 * BG_WG + 32;
  static constexpr int XBUF = WIDE ? BG_OUT : 0;
  static constexpr int STAGES = WIDE ? (196608 - XBUF) / BG_STAGE : 3;
  static constexpr size_t SMEM =
      (size_t)STAGES * BG_STAGE + XBUF + (2 * STAGES + 1) * sizeof(uint64_t) + 1024;
};

struct FfnGemmArgs {
  const void* a;      // [M, K] T, row-major
  const void* b;      // [K, N] T, row-major
  int M, N, K;
  int seg;            // K-length of one split of F (FFN_RESIDUAL); K otherwise
  const float* bias;  // [N]
  const void* x;      // FFN_RESIDUAL: the residual [M, N] T
  float res_scale;
  void* out;          // [M, N] T
};

template <int EPI>
__device__ __forceinline__ float ffn_value(const FfnGemmArgs& g, float xv, int n, float v) {
  if (EPI == FFN_SILU) {
    const float h = __fadd_rn(v, g.bias[n]);
    return __fmul_rn(h, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-h))));
  }
  return __fadd_rn(xv, __fmul_rn(g.res_scale, __fadd_rn(v, g.bias[n])));
}

template <typename T, int EPI>
__device__ __forceinline__ void ffn_store(const FfnGemmArgs& g, int m, int n, float v) {
  const size_t at = (size_t)m * g.N + n;
  const float xv = EPI == FFN_SILU ? 0.f : to_float(reinterpret_cast<const T*>(g.x)[at]);
  reinterpret_cast<T*>(g.out)[at] = from_float<T>(ffn_value<EPI>(g, xv, n, v));
}

// -- bf16: TMA + wgmma ---------------------------------------------------------------

// Byte offset of (row, column) of a [128, 128] bf16 tile staged as TMA boxes
// of [128 rows][64 columns] in the 128-byte swizzle.
__device__ __forceinline__ int bg_out_at(int row, int col) {
  const int cb = (col & 63) * 2;
  return (col >> 6) * (BG_BM * 128) + row * 128 + ((((cb >> 4) ^ (row & 7))) << 4) + (cb & 15);
}

template <int EPI>
__global__ void __launch_bounds__(BgShape<EPI>::THREADS, BgShape<EPI>::MIN_BLOCKS)
    ffn_gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         const __grid_constant__ CUtensorMap map_out,
                         const __grid_constant__ CUtensorMap map_x, FfnGemmArgs g) {
  using Sh = BgShape<EPI>;
  constexpr int ST = Sh::STAGES, STAGE = BG_STAGE, NACC = BG_BN / 2;
  extern __shared__ unsigned char bg_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: the ring starts on it.
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(bg_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* xbuf = ring + ST * STAGE;  // GEMM2: the residual, then the output
  uint64_t* full = reinterpret_cast<uint64_t*>(xbuf + Sh::XBUF);
  uint64_t* empty = full + ST;
  uint64_t* xfull = empty + ST;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BG_BM, n0 = blockIdx.x * BG_BN;
  const int KT = g.K / BG_BK;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * BG_WG);  // one arrival per consumer warp
    }
    mbar_init(xfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * BG_WG) {  // the producer warp(s): one thread issues every load
    if constexpr (Sh::WIDE) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * BG_WG && lane == 0) {
      if constexpr (EPI == FFN_RESIDUAL) {
        mbar_expect_tx(xfull, Sh::XBUF);
#pragma unroll
        for (int j = 0; j < BG_BN / 64; ++j)
          tma_load_2d(xbuf + j * BG_BM * 128, &map_x, xfull, n0 + 64 * j, m0);
      }
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(empty + s, (kt / ST - 1) & 1);
        unsigned char* slot = ring + s * STAGE;
        mbar_expect_tx(full + s, STAGE);
        tma_load_2d(slot, &map_a, full + s, kt * BG_BK, m0);
#pragma unroll
        for (int j = 0; j < BG_BN / 64; ++j)
          tma_load_2d(slot + BG_TILE_A + j * BG_BOX_B, &map_b, full + s, n0 + 64 * j,
                      kt * BG_BK);
      }
    }
    return;
  }

  if constexpr (Sh::WIDE) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2;  // rows 64 wg .. 64 wg + 63 of the tile
  const uint32_t ring_a = smem_u32(ring) + wg * 64 * 128, ring_b = smem_u32(ring) + BG_TILE_A;
  float acc[NACC];
  float tot[EPI == FFN_RESIDUAL ? NACC : 1];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % ST;
    mbar_wait(full + s, (kt / ST) & 1);
    const bool fresh = (kt * BG_BK) % g.seg == 0;  // a split starts: overwrite acc
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BG_BK / 16; ++ks) {
      const uint64_t da = wgmma_desc_sw128(ring_a + s * STAGE + ks * 32);
      const uint64_t db = wgmma_desc_sw128_mn(ring_b + s * STAGE + ks * 2048, BG_BOX_B);
      wgmma_bf16_m64n128k16_ss(acc, da, db, fresh && ks == 0 ? 0 : 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous k tile's products are done: release its slot
    if (kt > 0 && lane == 0) mbar_arrive(empty + (kt - 1) % ST);
    if constexpr (EPI == FFN_RESIDUAL) {
      if (((kt + 1) * BG_BK) % g.seg != 0) continue;
      wgmma_wait<0>();  // a split is complete: fold its fp32 partial in
      const bool first = (kt + 1) * BG_BK == g.seg;
#pragma unroll
      for (int i = 0; i < NACC; ++i) tot[i] = first ? acc[i] : __fadd_rn(tot[i], acc[i]);
    }
  }
  wgmma_wait<0>();

  // The epilogue stages the bf16 tile (GEMM1 in the ring, free once both
  // warpgroups are done with it; GEMM2 over its residual tile) and one
  // thread writes it with TMA stores, which drop the rows past M.
  unsigned char* stage_out = EPI == FFN_RESIDUAL ? xbuf : ring;
  if constexpr (EPI == FFN_RESIDUAL) mbar_wait(xfull, 0);
  else asm volatile("bar.sync 1, %0;\n" :: "n"(128 * BG_WG) : "memory");
  const int rl = wg * 64 + (warp & 3) * 16 + (lane >> 2), cl = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < NACC; i += 2) {
    const int row = rl + ((i >> 1) & 1) * 8, col = cl + (i >> 2) * 8;
    uint32_t* at = reinterpret_cast<uint32_t*>(stage_out + bg_out_at(row, col));
    float v[2];
    if constexpr (EPI == FFN_RESIDUAL) {
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
      v[0] = ffn_value<EPI>(g, xv.x, n0 + col, tot[i]);
      v[1] = ffn_value<EPI>(g, xv.y, n0 + col + 1, tot[i + 1]);
    } else {
      v[0] = ffn_value<EPI>(g, 0.f, n0 + col, acc[i]);
      v[1] = ffn_value<EPI>(g, 0.f, n0 + col + 1, acc[i + 1]);
    }
    *at = bf16x2_bits(v[0], v[1]);
  }
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * BG_WG) : "memory");
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < BG_BN / 64; ++j)
      tma_store_2d(&map_out, stage_out + j * BG_BM * 128, n0 + 64 * j, m0);
    tma_store_wait_read();
  }
}

template <int EPI>
static cudaError_t launch_gemm_bf16(const FfnGemmArgs& g, cudaStream_t st) {
  using Sh = BgShape<EPI>;
  CUtensorMap map_a, map_b, map_out, map_x;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!tma_map_2d(&map_a, g.a, bf, 2, g.M, g.K, (uint64_t)g.K * 2, BG_BM, BG_BK) ||
      !tma_map_2d(&map_b, g.b, bf, 2, g.K, g.N, (uint64_t)g.N * 2, BG_BK, 64) ||
      !tma_map_2d(&map_out, g.out, bf, 2, g.M, g.N, (uint64_t)g.N * 2, BG_BM, 64) ||
      !tma_map_2d(&map_x, EPI == FFN_RESIDUAL ? g.x : g.out, bf, 2, g.M, g.N,
                  (uint64_t)g.N * 2, BG_BM, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(ffn_gemm_bf16_kernel<EPI>, Sh::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.N / BG_BN, (g.M + BG_BM - 1) / BG_BM);
  ffn_gemm_bf16_kernel<EPI><<<grid, Sh::THREADS, Sh::SMEM, st>>>(map_a, map_b, map_out, map_x,
                                                                 g);
  return cudaGetLastError();
}

// -- fp32: FMA loops --------------------------------------------------------------

template <int EPI>
__global__ void __launch_bounds__(FF_THREADS) ffn_gemm_f32_kernel(FfnGemmArgs g) {
  __shared__ __align__(16) float As[FF_BK * FF_LDS];  // [k][m]
  __shared__ __align__(16) float Bs[FF_BK * FF_LDS];  // [k][n]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * FF_BM, n0 = blockIdx.x * FF_BN;
  const int M = g.M, K = g.K;
  const float* A = reinterpret_cast<const float*>(g.a);
  const float* B = reinterpret_cast<const float*>(g.b);

  float acc[4][4], tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = tot[i][j] = 0.f;

  // One float4 of A ([m][k]) and one of B ([k][n]) per thread and K tile.
  const int lrow = tid >> 2, lcol = (tid & 3) * 4, brow = tid >> 4, bcol = (tid & 15) * 4;
  float4 a_reg, b_reg;
  auto load_tile = [&](int k0) {
    const int m = m0 + lrow;
    a_reg = m < M ? __ldg(reinterpret_cast<const float4*>(A + (size_t)m * K + k0 + lcol))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    b_reg = __ldg(reinterpret_cast<const float4*>(B + (size_t)(k0 + brow) * g.N + n0 + bcol));
  };
  auto store_tile = [&]() {
    As[(lcol + 0) * FF_LDS + lrow] = a_reg.x;
    As[(lcol + 1) * FF_LDS + lrow] = a_reg.y;
    As[(lcol + 2) * FF_LDS + lrow] = a_reg.z;
    As[(lcol + 3) * FF_LDS + lrow] = a_reg.w;
    *reinterpret_cast<float4*>(Bs + brow * FF_LDS + bcol) = b_reg;
  };

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += FF_BK) {
    __syncthreads();
    store_tile();
    __syncthreads();
    if (k0 + FF_BK < K) load_tile(k0 + FF_BK);
#pragma unroll
    for (int kk = 0; kk < FF_BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(As + kk * FF_LDS + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * FF_LDS + tx * 4);
      const float a[4] = {av.x, av.y, av.z, av.w}, b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (EPI == FFN_RESIDUAL && (k0 + FF_BK) % g.seg == 0) {
      const bool first = k0 + FF_BK == g.seg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tot[i][j] = first ? acc[i][j] : __fadd_rn(tot[i][j], acc[i][j]);
          acc[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ffn_store<float, EPI>(g, m, n0 + tx * 4 + j, EPI == FFN_RESIDUAL ? tot[i][j] : acc[i][j]);
  }
}

// -- LayerNorm ----------------------------------------------------------------------

// One block of 256 threads per row; the row stays in shared memory (fp32)
// between the statistics and the normalisation.
template <typename T>
__global__ void __launch_bounds__(256) ffn_layer_norm_kernel(const T* x, int D, const float* w,
                                                              const float* b, T* ln) {
  extern __shared__ float row_vals[];
  __shared__ float red[8];
  const T* xr = x + (size_t)blockIdx.x * D;
  float sum = 0.f;
  for (int i = threadIdx.x; i < D; i += 256) {
    const float v = to_float(xr[i]);
    row_vals[i] = v;
    sum += v;
  }
  const float mean = __fdiv_rn(block_reduce_256<false>(sum, red), (float)D);
  float sq = 0.f;
  for (int i = threadIdx.x; i < D; i += 256) {
    const float d = row_vals[i] - mean;
    sq = fmaf(d, d, sq);
  }
  const float rstd = rsqrtf(__fdiv_rn(block_reduce_256<false>(sq, red), (float)D) + 1e-5f);
  T* out = ln + (size_t)blockIdx.x * D;
  for (int i = threadIdx.x; i < D; i += 256)
    out[i] = from_float<T>(__fadd_rn(__fmul_rn(__fmul_rn(row_vals[i] - mean, rstd), w[i]), b[i]));
}

// -- entry ------------------------------------------------------------------------------

template <typename T>
static cudaError_t launch_ffn(const T* x, int M, int D, int F, int n_splits, float res_scale,
                              const float* ln_w, const float* ln_b, const T* w1,
                              const float* b1, const T* w2, const float* b2, T* ln, T* h,
                              T* out, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  const int bk = BF ? BG_BK : FF_BK, bn = BF ? BG_BN : FF_BN, bm = FF_BM;
  const int seg = F / n_splits;
  if (M < 1 || D % bn || F % bn || D % bk || seg % bk) return cudaErrorInvalidValue;

  const size_t smem = (size_t)D * sizeof(float);
  cudaError_t err = allow_dynamic_smem(ffn_layer_norm_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ffn_layer_norm_kernel<T><<<M, 256, smem, st>>>(x, D, ln_w, ln_b, ln);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const FfnGemmArgs up{ln, w1, M, F, D, D, b1, nullptr, 0.f, h};
  const FfnGemmArgs down{h, w2, M, D, F, seg, b2, x, res_scale, out};
  const int rows = (M + bm - 1) / bm;
  if constexpr (BF) {
    // GEMM1 (bias + SiLU into h), then GEMM2 (per-split sums, bias, residual).
    if ((err = launch_gemm_bf16<FFN_SILU>(up, st)) != cudaSuccess) return err;
    return launch_gemm_bf16<FFN_RESIDUAL>(down, st);
  } else {
    ffn_gemm_f32_kernel<FFN_SILU><<<dim3(F / bn, rows), FF_THREADS, 0, st>>>(up);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ffn_gemm_f32_kernel<FFN_RESIDUAL><<<dim3(D / bn, rows), FF_THREADS, 0, st>>>(down);
  }
  return cudaGetLastError();
}

extern "C" int sonar_fused_bf16_ffn(const void* x, int kind, int M, int D, int F, int n_splits,
                                    float res_scale, const float* ln_w, const float* ln_b,
                                    const void* w1, const float* b1, const void* w2,
                                    const float* b2, void* ln, void* h, void* out,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_splits < 1 || F % n_splits) return cudaErrorInvalidValue;
  if (kind == KIND_BF16)
    return launch_ffn((const bf16*)x, M, D, F, n_splits, res_scale, ln_w, ln_b,
                      (const bf16*)w1, b1, (const bf16*)w2, b2, (bf16*)ln, (bf16*)h,
                      (bf16*)out, st);
  return launch_ffn((const float*)x, M, D, F, n_splits, res_scale, ln_w, ln_b,
                    (const float*)w1, b1, (const float*)w2, b2, (float*)ln, (float*)h,
                    (float*)out, st);
}
