// Conformer macaron half-FFN with its LayerNorm and residual, bf16 or fp32:
//   ln  = LN(x) (fp32 statistics, eps 1e-5, fp32 affine) rounded to T
//   h_s = silu(ln @ W1[:, s] + b1[s]) in fp32, rounded to T
//   y   = sum_s h_s @ W2[s, :] (each split's partial in fp32, summed in fp32)
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
// The weights come transposed (B^T [N, K], row-major), so the B fragments
// load like A's. In bf16 the products run on mma.sync m16n8k16 with fp32
// accumulators (128 x 128 block tiles, 8 warps of 64 x 32); fp32 keeps
// plain FMA loops (64 x 64 block tiles, 4 x 4 outputs a thread).
// What bounds it: the two GEMMs, 4 M D F flops (67 GFLOP at M 3992, D 1024,
// F 4096), far above the ridge point; this first version feeds the tensor
// cores from a register-staged single shared-memory buffer, and the
// scratch round trip of h (M F x 2 bytes each way) is the memory cost a
// fused kernel removes.
#include "common.cuh"

constexpr int FB_BM = 128, FB_BN = 128, FB_BK = 32;
constexpr int FB_LDS = FB_BK + 8;  // bf16 per shared row: conflict-free fragment loads
constexpr int FB_THREADS = 256;    // 8 warps as 2 (M) x 4 (N), each 64 x 32

constexpr int FF_BM = 64, FF_BN = 64, FF_BK = 16;
constexpr int FF_LDS = FF_BM + 4;  // floats per shared row ([k][m] and [k][n] tiles)
constexpr int FF_THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each

enum FfnEpilogue {
  FFN_SILU = 0,      // out = T(silu(acc + bias))
  FFN_RESIDUAL = 1,  // per K segment s: y += acc_s (fp32); out = T(x + res_scale * (y + bias))
};

struct FfnGemmArgs {
  const void* a;      // [M, K] T, row-major
  const void* bt;     // B^T: [N, K] T, row-major
  int M, N, K;
  int seg;            // K-length of one split of F (FFN_RESIDUAL); K otherwise
  const float* bias;  // [N]
  const void* x;      // FFN_RESIDUAL: the residual [M, N] T
  float res_scale;
  void* out;          // [M, N] T
};

template <typename T, int EPI>
__device__ __forceinline__ void ffn_store(const FfnGemmArgs& g, int m, int n, float v) {
  const size_t at = (size_t)m * g.N + n;
  T* out = reinterpret_cast<T*>(g.out);
  if (EPI == FFN_SILU) {
    const float h = __fadd_rn(v, g.bias[n]);
    out[at] = from_float<T>(__fmul_rn(h, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-h)))));
  } else {
    const float xv = to_float(reinterpret_cast<const T*>(g.x)[at]);
    out[at] = from_float<T>(__fadd_rn(xv, __fmul_rn(g.res_scale, __fadd_rn(v, g.bias[n]))));
  }
}

// -- bf16: mma.sync ----------------------------------------------------------------

template <int EPI>
__global__ void __launch_bounds__(FB_THREADS) ffn_gemm_bf16_kernel(FfnGemmArgs g) {
  __shared__ __align__(16) bf16 As[FB_BM * FB_LDS];  // [m][k]
  __shared__ __align__(16) bf16 Bs[FB_BN * FB_LDS];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * FB_BM, n0 = blockIdx.x * FB_BN;
  const int M = g.M, K = g.K;
  const bf16* A = reinterpret_cast<const bf16*>(g.a);
  const bf16* Bt = reinterpret_cast<const bf16*>(g.bt);

  float acc[4][4][4], tot[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;

  // Global -> register staging of one K tile: 2 x 16 bytes per thread for
  // each of A [m][k] and B^T [n][k] (N is a multiple of FB_BN).
  uint4 a_reg[2], b_reg[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * FB_THREADS, row = c >> 2, col = (c & 3) * 8;
      const int m = m0 + row;
      a_reg[i] = m < M ? __ldg(reinterpret_cast<const uint4*>(A + (size_t)m * K + k0 + col))
                       : make_uint4(0u, 0u, 0u, 0u);
      b_reg[i] = __ldg(reinterpret_cast<const uint4*>(Bt + (size_t)(n0 + row) * K + k0 + col));
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * FB_THREADS, row = c >> 2, col = (c & 3) * 8;
      *reinterpret_cast<uint4*>(As + row * FB_LDS + col) = a_reg[i];
      *reinterpret_cast<uint4*>(Bs + row * FB_LDS + col) = b_reg[i];
    }
  };

  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += FB_BK) {
    __syncthreads();  // the previous tile's fragments have been read
    store_tile();
    __syncthreads();
    if (k0 + FB_BK < K) load_tile(k0 + FB_BK);  // in flight during the MMAs below
#pragma unroll
    for (int ks = 0; ks < FB_BK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const bf16* p = As + (wm * 64 + mi * 16 + grp) * FB_LDS + ks + 2 * tig;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * FB_LDS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * FB_LDS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* p = Bs + (wn * 32 + ni * 8 + grp) * FB_LDS + ks + 2 * tig;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi][0], af[mi][1], af[mi][2], af[mi][3], bfr[ni][0],
                   bfr[ni][1]);
    }
    if (EPI == FFN_RESIDUAL && (k0 + FB_BK) % g.seg == 0) {  // a split of F is complete
      const bool first = k0 + FB_BK == g.seg;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[mi][ni][e] = first ? acc[mi][ni][e] : __fadd_rn(tot[mi][ni][e], acc[mi][ni][e]);
            acc[mi][ni][e] = 0.f;
          }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 64 + mi * 16 + grp + (e >> 1) * 8;
        const int n = n0 + wn * 32 + ni * 8 + tig * 2 + (e & 1);
        if (m < M)
          ffn_store<bf16, EPI>(g, m, n, EPI == FFN_RESIDUAL ? tot[mi][ni][e] : acc[mi][ni][e]);
      }
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
  const float* Bt = reinterpret_cast<const float*>(g.bt);

  float acc[4][4], tot[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = tot[i][j] = 0.f;

  // One float4 of A and one of B^T per thread and K tile.
  const int lrow = tid >> 2, lcol = (tid & 3) * 4;
  float4 a_reg, b_reg;
  auto load_tile = [&](int k0) {
    const int m = m0 + lrow;
    a_reg = m < M ? __ldg(reinterpret_cast<const float4*>(A + (size_t)m * K + k0 + lcol))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    b_reg = __ldg(reinterpret_cast<const float4*>(Bt + (size_t)(n0 + lrow) * K + k0 + lcol));
  };
  auto store_tile = [&]() {
    As[(lcol + 0) * FF_LDS + lrow] = a_reg.x;
    As[(lcol + 1) * FF_LDS + lrow] = a_reg.y;
    As[(lcol + 2) * FF_LDS + lrow] = a_reg.z;
    As[(lcol + 3) * FF_LDS + lrow] = a_reg.w;
    Bs[(lcol + 0) * FF_LDS + lrow] = b_reg.x;
    Bs[(lcol + 1) * FF_LDS + lrow] = b_reg.y;
    Bs[(lcol + 2) * FF_LDS + lrow] = b_reg.z;
    Bs[(lcol + 3) * FF_LDS + lrow] = b_reg.w;
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
                              const float* ln_w, const float* ln_b, const T* w1t,
                              const float* b1, const T* w2t, const float* b2, T* ln, T* h,
                              T* out, cudaStream_t st) {
  constexpr bool BF = sizeof(T) == 2;
  const int bk = BF ? FB_BK : FF_BK, bn = BF ? FB_BN : FF_BN, bm = BF ? FB_BM : FF_BM;
  const int seg = F / n_splits;
  if (M < 1 || D % bn || F % bn || D % bk || seg % bk) return cudaErrorInvalidValue;

  const size_t smem = (size_t)D * sizeof(float);
  cudaError_t err = allow_dynamic_smem(ffn_layer_norm_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ffn_layer_norm_kernel<T><<<M, 256, smem, st>>>(x, D, ln_w, ln_b, ln);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const FfnGemmArgs up{ln, w1t, M, F, D, D, b1, nullptr, 0.f, h};
  const FfnGemmArgs down{h, w2t, M, D, F, seg, b2, x, res_scale, out};
  const int rows = (M + bm - 1) / bm;
  if constexpr (BF) {
    ffn_gemm_bf16_kernel<FFN_SILU><<<dim3(F / bn, rows), FB_THREADS, 0, st>>>(up);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ffn_gemm_bf16_kernel<FFN_RESIDUAL><<<dim3(D / bn, rows), FB_THREADS, 0, st>>>(down);
  } else {
    ffn_gemm_f32_kernel<FFN_SILU><<<dim3(F / bn, rows), FF_THREADS, 0, st>>>(up);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ffn_gemm_f32_kernel<FFN_RESIDUAL><<<dim3(D / bn, rows), FF_THREADS, 0, st>>>(down);
  }
  return cudaGetLastError();
}

extern "C" int sonar_fused_bf16_ffn(const void* x, int kind, int M, int D, int F, int n_splits,
                                    float res_scale, const float* ln_w, const float* ln_b,
                                    const void* w1t, const float* b1, const void* w2t,
                                    const float* b2, void* ln, void* h, void* out,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_splits < 1 || F % n_splits) return cudaErrorInvalidValue;
  if (kind == KIND_BF16)
    return launch_ffn((const bf16*)x, M, D, F, n_splits, res_scale, ln_w, ln_b,
                      (const bf16*)w1t, b1, (const bf16*)w2t, b2, (bf16*)ln, (bf16*)h,
                      (bf16*)out, st);
  return launch_ffn((const float*)x, M, D, F, n_splits, res_scale, ln_w, ln_b,
                    (const float*)w1t, b1, (const float*)w2t, b2, (float*)ln, (float*)h,
                    (float*)out, st);
}
