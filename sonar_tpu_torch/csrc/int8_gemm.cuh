// Int8 building blocks shared by the fused FFN (ffn.cu) and the int8
// attention block (attn_block.cu):
//
// - row_quant_kernel: optional LayerNorm (fp32 statistics, eps 1e-5), then
//   symmetric per-row (or per row segment) int8 quantisation
//   q = clip(rint(x / s), -127, 127), s = max(absmax / 127, 1e-12): the
//   division, and round-half-to-even, of the TPU kernels.
// - gemm_s8_kernel: C = A[M, K] int8 @ B[K, N] int8 with exact int32
//   accumulation on the tensor cores (mma.sync m16n8k32), followed by a
//   dequantising epilogue. B is the JAX [in, out] kernel stored
//   column-major (as quantize_kernel makes it), so its rows of K bytes are
//   the col-major fragments mma.sync takes and load like A's.
//
// Bound: at the encoder's shapes (M = 8192 tokens, K and N of 1024..8192)
// these products do 17..137 GOP each, far above the card's ridge point, so
// they are compute bound; this first version feeds mma.sync from a
// register-staged single shared-memory buffer (global loads of the next
// tile overlap the current tile's MMAs) and reaches a fraction of the
// int8 peak. wgmma, TMA and a deeper pipeline are later work.
#pragma once

#include "common.cuh"

constexpr int GM_BM = 128, GM_BN = 128, GM_BK = 64;
constexpr int GM_LDS = GM_BK + 16;  // bytes per shared-memory row (conflict-free fragment loads)
constexpr int GM_THREADS = 256;     // 8 warps as 2 (M) x 4 (N), each 64 x 32

enum Epilogue {
  EPI_BIAS = 0,       // out = (acc * rs) * cs + bias
  EPI_BIAS_RELU = 1,  // out = max((acc * rs) * cs + bias, 0)
  EPI_RESIDUAL = 2,   // out = residual + ((acc * rs) * cs + bias)
  EPI_SPLIT_SUM = 3,  // per K segment s: part_s = OutT((acc_s * rs[s]) * cs); out = OutT(sum parts + OutT(bias))
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

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
__global__ void __launch_bounds__(GM_THREADS) gemm_s8_kernel(GemmArgs g) {
  __shared__ __align__(16) int8_t As[GM_BM * GM_LDS];  // [m][k]
  __shared__ __align__(16) int8_t Bs[GM_BN * GM_LDS];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int grp = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int m0 = blockIdx.y * GM_BM, n0 = blockIdx.x * GM_BN;
  const int M = g.M, N = g.N, K = g.K;

  int acc[4][4][4];
  float tot[4][4][4];  // EPI_SPLIT_SUM: running sum of the dequantised segments
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        tot[i][j][e] = 0.f;
      }

  // Global -> register staging of one K tile, 2 x 16 bytes per thread for
  // each of A [m][k] and B^T [n][k] (N is a multiple of GM_BN).
  int4 a_reg[2], b_reg[2];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GM_THREADS, row = c >> 2, col = (c & 3) * 16;
      const int m = m0 + row;
      a_reg[i] = m < M ? *reinterpret_cast<const int4*>(g.a + (size_t)m * K + k0 + col)
                       : make_int4(0, 0, 0, 0);
      b_reg[i] = *reinterpret_cast<const int4*>(g.bt + (size_t)(n0 + row) * K + k0 + col);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GM_THREADS, row = c >> 2, col = (c & 3) * 16;
      *reinterpret_cast<int4*>(As + row * GM_LDS + col) = a_reg[i];
      *reinterpret_cast<int4*>(Bs + row * GM_LDS + col) = b_reg[i];
    }
  };

  const int nseg = K / g.seg;
  load_tile(0);
  for (int k0 = 0; k0 < K; k0 += GM_BK) {
    __syncthreads();  // the previous tile's fragments have been read
    store_tile();
    __syncthreads();
    if (k0 + GM_BK < K) load_tile(k0 + GM_BK);  // in flight during the MMAs below
#pragma unroll
    for (int ks = 0; ks < GM_BK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = As + (wm * 64 + mi * 16 + grp) * GM_LDS + ks + tig * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * GM_LDS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * GM_LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = Bs + (wn * 32 + ni * 8 + grp) * GM_LDS + ks + tig * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    if (EPI == EPI_SPLIT_SUM && (k0 + GM_BK) % g.seg == 0) {
      const int s = k0 / g.seg;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + wm * 64 + mi * 16 + grp + (e >> 1) * 8;
            const int n = n0 + wn * 32 + ni * 8 + tig * 2 + (e & 1);
            const float rs = m < M ? g.row_scale[(size_t)m * nseg + s] : 0.f;
            const float part =
                round_to<OutT>(__fmul_rn(__fmul_rn((float)acc[mi][ni][e], rs), g.col_scale[n]));
            tot[mi][ni][e] = s == 0 ? part : round_to<OutT>(__fadd_rn(tot[mi][ni][e], part));
            acc[mi][ni][e] = 0;
          }
    }
  }

  OutT* out = reinterpret_cast<OutT*>(g.out);
  const OutT* res = reinterpret_cast<const OutT*>(g.residual);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 64 + mi * 16 + grp + half * 8;
        const int n = n0 + wn * 32 + ni * 8 + tig * 2;
        if (m >= M) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = half * 2 + e;
          if (EPI == EPI_SPLIT_SUM) {
            v[e] = round_to<OutT>(__fadd_rn(tot[mi][ni][idx], round_to<OutT>(g.bias[n + e])));
          } else {
            const float rs = g.row_scale[m];
            float y = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[mi][ni][idx], rs), g.col_scale[n + e]),
                                g.bias[n + e]);
            if (EPI == EPI_BIAS_RELU) y = fmaxf(y, 0.f);
            if (EPI == EPI_RESIDUAL) y = __fadd_rn(to_float(res[(size_t)m * N + n + e]), y);
            v[e] = y;
          }
        }
        store2<OutT>(out + (size_t)m * N + n, v[0], v[1]);
      }
}

template <int EPI, typename OutT>
static cudaError_t launch_gemm_s8(const GemmArgs& g, cudaStream_t stream) {
  if (g.N % GM_BN || g.K % GM_BK || g.seg % GM_BK || g.K % g.seg) return cudaErrorInvalidValue;
  dim3 grid(g.N / GM_BN, (g.M + GM_BM - 1) / GM_BM);
  gemm_s8_kernel<EPI, OutT><<<grid, GM_THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}

// One block of 256 threads per (row, segment). The fp32 values (after the
// optional LayerNorm) stay in shared memory between the absmax and the
// quantisation.
template <typename T, bool LN>
__global__ void __launch_bounds__(256) row_quant_kernel(const T* x, int width, int seg,
                                                        const float* ln_w, const float* ln_b,
                                                        int8_t* q, float* scale) {
  extern __shared__ float vals[];
  __shared__ float red[8];
  const int row = blockIdx.x, s = blockIdx.y, nseg = gridDim.y;
  const size_t base = (size_t)row * width + (size_t)s * seg;
  const T* xr = x + base;
  float amax = 0.f;
  if (LN) {  // seg == width
    float sum = 0.f;
    for (int i = threadIdx.x; i < seg; i += 256) sum += to_float(xr[i]);
    const float mean = __fdiv_rn(block_reduce_256<false>(sum, red), (float)width);
    float sq = 0.f;
    for (int i = threadIdx.x; i < seg; i += 256) {
      const float d = to_float(xr[i]) - mean;
      sq = fmaf(d, d, sq);
    }
    const float var = __fdiv_rn(block_reduce_256<false>(sq, red), (float)width);
    const float rstd = rsqrtf(var + 1e-5f);
    for (int i = threadIdx.x; i < seg; i += 256) {
      const float hv = __fadd_rn(__fmul_rn(__fmul_rn(to_float(xr[i]) - mean, rstd), ln_w[i]), ln_b[i]);
      vals[i] = hv;
      amax = fmaxf(amax, fabsf(hv));
    }
  } else {
    for (int i = threadIdx.x; i < seg; i += 256) {
      const float hv = to_float(xr[i]);
      vals[i] = hv;
      amax = fmaxf(amax, fabsf(hv));
    }
  }
  amax = block_reduce_256<true>(amax, red);
  const float sc = fmaxf(amax / 127.f, 1e-12f);
  for (int i = threadIdx.x; i < seg; i += 256)
    q[base + i] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(vals[i], sc)), -127.f), 127.f);
  if (threadIdx.x == 0) scale[(size_t)row * nseg + s] = sc;
}

template <typename T>
static cudaError_t launch_row_quant(const T* x, int rows, int width, int seg, const float* ln_w,
                                    const float* ln_b, int8_t* q, float* scale,
                                    cudaStream_t stream) {
  if (seg < 1 || width % seg || (ln_w && seg != width)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)seg * sizeof(float);
  dim3 grid(rows, width / seg);
  cudaError_t err;
  if (ln_w) {
    err = allow_dynamic_smem(row_quant_kernel<T, true>, smem);
    if (err != cudaSuccess) return err;
    row_quant_kernel<T, true><<<grid, 256, smem, stream>>>(x, width, seg, ln_w, ln_b, q, scale);
  } else {
    err = allow_dynamic_smem(row_quant_kernel<T, false>, smem);
    if (err != cudaSuccess) return err;
    row_quant_kernel<T, false><<<grid, 256, smem, stream>>>(x, width, seg, ln_w, ln_b, q, scale);
  }
  return cudaGetLastError();
}
