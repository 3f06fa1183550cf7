// Conformer relative-position attention (Transformer-XL scoring) for Hopper.
//
// Replaces the TPU kernels of sonar_tpu/ops/pallas/relpos_flash.py:
//   sonar_relpos_flash_v2 <- relpos_flash_attention_v2 (_kernel_v2), the
//     Conformer's path: the positional term bd is built inside the kernel
//     from the trig-factored form, z = (q + v_bias) Wr_h^T, an i-rotation
//     into w, and bd = w . basis_j;
//   sonar_relpos_flash_v1 <- relpos_flash_attention (_kernel): the same
//     attention tail with bd read from a precomputed [B, H, S, S] tensor.
// score_j = (ac_j + bd_j) * scale + key_bias_j, fp32 softmax with a true
// division, P rounded to the value dtype, P V accumulated in fp32. The
// rounding points are the TPU kernels': v2 rounds q + u, q + v_bias and w to
// the model dtype, v1 keeps q + u in fp32.
//
// What bounds it on the H100: the work is the bd product, B*H*S^2*D*2 flops
// (65 GFLOP per layer at [8, 16, 499, 64], D 1024, against 4 for QK^T), and
// the TPU kernel kept the whole [S, D] basis (4 MB in bf16 at S 2048) and a
// (batch, head)'s K/V in VMEM, far past a block's 227 KB of shared memory.
// Design: one block of 8 warps per (batch, head, 16 query rows). w for the
// 16 rows (16 x D) stays in shared memory, and so do the 16 fp32 score rows
// (128 KB at the gate's top, S 2048), so the softmax takes one pass over
// the scores and bd is never recomputed. The basis and K stream from L2
// (every block reads the same basis) straight into mma fragments. In bf16
// the four products (z, bd, ac, P V) run on the tensor cores (mma.sync
// m16n8k16, fp32 accumulation); the k order inside each 32-wide chunk is
// permuted alike in both operands, so that every fragment load is 16
// bytes. fp32 has no tensor-core path that keeps fp32: there, and for v1's
// fp32 ac, the products are FMA loops. With 16 query rows a block reads the
// basis once per 16 rows: the kernel is bound by L2 bandwidth on the basis
// stream, not by the tensor cores; sharing the basis across more rows or
// heads is later work.
#include <type_traits>

#include "common.cuh"

constexpr int RP_BQ = 16;         // query rows per block: one m16 tile
constexpr int RP_WARPS = 8;
constexpr int RP_THREADS = 32 * RP_WARPS;
constexpr int RP_KT = 32 * RP_WARPS;  // keys per score tile: 32 per warp
constexpr int RP_SPAD = 16;       // floats of padding after a score row
constexpr int RP_QPAD = 4;        // floats of padding after a qu / qv row
constexpr size_t RP_MAX_SMEM = 232448;

template <typename T> struct RpPad;
template <> struct RpPad<float> { static constexpr int w = 4; };
template <> struct RpPad<bf16> { static constexpr int w = 32; };  // spreads 16-byte row loads over the banks

struct RelposArgs {
  const void* q;
  const void* k;
  const void* v;
  long long q_sb, q_sh, q_ss;  // element strides: batch, head, row (last dim is 1)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  const void* wr;     // v2: [H, D, Dh], r_proj per head, input columns de-interleaved
  const void* si;     // v2: [S, D/2] sin(i w)
  const void* ci;     // v2: [S, D/2] cos(i w)
  const void* basis;  // v2: [S, D] = [cos(j w) | sin(j w)]
  const void* bd;     // v1: [B, H, S, S]
  const void* u;      // [H, Dh] u_bias
  const void* vb;     // v2: [H, Dh] v_bias
  const float* key_bias;  // [B, S] additive, or null
  void* out;          // [B, H, S, Dh] contiguous
  int H, S, D;
  float scale;
};

__host__ __device__ inline int rp_score_ld(int S) {
  return ((S + RP_KT - 1) / RP_KT) * RP_KT + RP_SPAD;
}

template <typename T, bool V2>
static size_t rp_smem_bytes(int S, int Dh, int D) {
  size_t bytes = sizeof(float) * RP_BQ * (size_t)rp_score_ld(S);  // scores, then P
  bytes += sizeof(float) * 2 * RP_BQ * (size_t)(Dh + RP_QPAD);   // qu, qv
  if (V2) bytes += sizeof(T) * RP_BQ * (size_t)(D + RpPad<T>::w);  // w
  return bytes;
}

// One 32-wide k chunk as two m16n8k16 products. Thread (g = lane / 4,
// t = lane % 4) holds the 8 consecutive values at k offset 8t of A's rows g
// (lo) and g + 8 (hi) and of B's column g: k step s uses the values
// 4s .. 4s + 3 of each, so logical k {2t, 2t + 1, 2t + 8, 2t + 9} of step s
// is physical k 8t + 4s + {0, 1, 2, 3}, the same permutation in A and B.
__device__ __forceinline__ void mma_k32(float (&c)[4], uint4 lo, uint4 hi, uint4 b) {
  mma_bf16(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma_bf16(c, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

// 8 floats (already bf16 values) -> one 16-byte bf16 fragment.
__device__ __forceinline__ uint4 pack8(const float* p) {
  return make_uint4(bf16x2_bits(p[0], p[1]), bf16x2_bits(p[2], p[3]), bf16x2_bits(p[4], p[5]),
                    bf16x2_bits(p[6], p[7]));
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 r = ldg16(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __bfloat162float(h[i].x);
    x[2 * i + 1] = __bfloat162float(h[i].y);
  }
}

// acc[r] += sum_e A[r][e] x[e] over e < n (n a multiple of 8), A in shared
// memory (every thread reads the same A: broadcast), x a row in device memory.
template <typename X>
__device__ __forceinline__ void fma_rows(float (&acc)[RP_BQ], const float* A, int lda,
                                         const X* x, int n) {
  for (int e = 0; e < n; e += 8) {
    float xv[8];
    load8(x + e, xv);
#pragma unroll
    for (int r = 0; r < RP_BQ; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + r * lda + e);
      const float4 a1 = *reinterpret_cast<const float4*>(A + r * lda + e + 4);
      float s = acc[r];
      s = fmaf(a0.x, xv[0], s); s = fmaf(a0.y, xv[1], s);
      s = fmaf(a0.z, xv[2], s); s = fmaf(a0.w, xv[3], s);
      s = fmaf(a1.x, xv[4], s); s = fmaf(a1.y, xv[5], s);
      s = fmaf(a1.z, xv[6], s); s = fmaf(a1.w, xv[7], s);
      acc[r] = s;
    }
  }
}

// The i-rotation: w = [zs si + zc ci | zc si - zs ci], in fp32 (no fma, as
// the reference's separate products and sums).
__device__ __forceinline__ float rot_first(float zs, float zc, float s, float c) {
  return __fadd_rn(__fmul_rn(zs, s), __fmul_rn(zc, c));
}
__device__ __forceinline__ float rot_second(float zs, float zc, float s, float c) {
  return __fsub_rn(__fmul_rn(zc, s), __fmul_rn(zs, c));
}

__device__ __forceinline__ float score_of(float ac, float bd, float scale, float kb) {
  return __fadd_rn(__fmul_rn(__fadd_rn(ac, bd), scale), kb);
}

template <typename T, bool V2, int DH>
__global__ void __launch_bounds__(RP_THREADS) relpos_kernel(RelposArgs a) {
  constexpr bool BF = std::is_same<T, bf16>::value;
  constexpr int LDQ = DH + RP_QPAD;
  extern __shared__ __align__(16) unsigned char rp_smem[];
  const int S = a.S, D = a.D, half = D / 2, lds = rp_score_ld(S);
  const int ldw = D + RpPad<T>::w;
  float* Ss = reinterpret_cast<float*>(rp_smem);  // [16][lds] scores, then P in place
  float* QU = Ss + RP_BQ * lds;                    // [16][LDQ] q + u
  float* QV = QU + RP_BQ * LDQ;                    // [16][LDQ] q + v_bias (v2)
  T* Ws = reinterpret_cast<T*>(QV + RP_BQ * LDQ);  // [16][ldw] w (v2)

  const int q0 = blockIdx.x * RP_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const T* qb = reinterpret_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = reinterpret_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vbase = reinterpret_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* kbias = a.key_bias ? a.key_bias + (long long)b * S : nullptr;

  // Query rows plus the biases, in fp32; v2 rounds both to T as the TPU
  // kernel does, v1 keeps q + u in fp32. Rows past S read as 0.
  for (int e = tid; e < RP_BQ * DH; e += RP_THREADS) {
    const int r = e / DH, d = e - r * DH, i = q0 + r;
    const float qx = i < S ? to_float(qb[i * a.q_ss + d]) : 0.f;
    const float qu = __fadd_rn(qx, to_float(reinterpret_cast<const T*>(a.u)[h * DH + d]));
    QU[r * LDQ + d] = V2 ? round_to<T>(qu) : qu;
    if (V2) {
      const float qv = __fadd_rn(qx, to_float(reinterpret_cast<const T*>(a.vb)[h * DH + d]));
      QV[r * LDQ + d] = round_to<T>(qv);
    }
  }
  __syncthreads();

  // -- w = rotate(qv Wr_h^T), [16, D], into shared memory (v2) -------------
  if constexpr (V2) {
    const T* wr = reinterpret_cast<const T*>(a.wr) + (long long)h * D * DH;
    const T* si = reinterpret_cast<const T*>(a.si);
    const T* ci = reinterpret_cast<const T*>(a.ci);
    if constexpr (BF) {
      uint4 alo[DH / 32], ahi[DH / 32];
#pragma unroll
      for (int c = 0; c < DH / 32; ++c) {
        alo[c] = pack8(QV + g * LDQ + 32 * c + 8 * t4);
        ahi[c] = pack8(QV + (g + 8) * LDQ + 32 * c + 8 * t4);
      }
      // Warp tiles of 8 columns, paired with the tile half a row further so
      // that z_s and z_c of one column meet in one thread's accumulators.
      for (int p = warp; p < half / 8; p += RP_WARPS) {
        float zs[4] = {0.f, 0.f, 0.f, 0.f}, zc[4] = {0.f, 0.f, 0.f, 0.f};
        const T* w1 = wr + (long long)(p * 8 + g) * DH + 8 * t4;
        const T* w2 = w1 + (long long)half * DH;
#pragma unroll
        for (int c = 0; c < DH / 32; ++c) {
          mma_k32(zs, alo[c], ahi[c], ldg16(w1 + 32 * c));
          mma_k32(zc, alo[c], ahi[c], ldg16(w2 + 32 * c));
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = g + 8 * rr, i = q0 + row, col = p * 8 + 2 * t4;
          float s0 = 0.f, s1 = 0.f, c0 = 0.f, c1 = 0.f;
          if (i < S) {
            s0 = to_float(si[(long long)i * half + col]);
            s1 = to_float(si[(long long)i * half + col + 1]);
            c0 = to_float(ci[(long long)i * half + col]);
            c1 = to_float(ci[(long long)i * half + col + 1]);
          }
          const int e = 2 * rr;
          *reinterpret_cast<uint32_t*>(Ws + row * ldw + col) = bf16x2_bits(
              rot_first(zs[e], zc[e], s0, c0), rot_first(zs[e + 1], zc[e + 1], s1, c1));
          *reinterpret_cast<uint32_t*>(Ws + row * ldw + col + half) = bf16x2_bits(
              rot_second(zs[e], zc[e], s0, c0), rot_second(zs[e + 1], zc[e + 1], s1, c1));
        }
      }
    } else {
      for (int dp = tid; dp < half; dp += RP_THREADS) {
        float zs[RP_BQ], zc[RP_BQ];
#pragma unroll
        for (int r = 0; r < RP_BQ; ++r) zs[r] = zc[r] = 0.f;
        fma_rows(zs, QV, LDQ, wr + (long long)dp * DH, DH);
        fma_rows(zc, QV, LDQ, wr + (long long)(dp + half) * DH, DH);
#pragma unroll
        for (int r = 0; r < RP_BQ; ++r) {
          const int i = q0 + r;
          const float s = i < S ? to_float(si[(long long)i * half + dp]) : 0.f;
          const float c = i < S ? to_float(ci[(long long)i * half + dp]) : 0.f;
          Ws[r * ldw + dp] = rot_first(zs[r], zc[r], s, c);
          Ws[r * ldw + dp + half] = rot_second(zs[r], zc[r], s, c);
        }
      }
    }
    __syncthreads();
  }

  // -- scores of the 16 rows against every key, into shared memory -----------
  if constexpr (V2 && BF) {
    const T* basis = reinterpret_cast<const T*>(a.basis);
    uint4 ulo[DH / 32], uhi[DH / 32];
#pragma unroll
    for (int c = 0; c < DH / 32; ++c) {
      ulo[c] = pack8(QU + g * LDQ + 32 * c + 8 * t4);
      uhi[c] = pack8(QU + (g + 8) * LDQ + 32 * c + 8 * t4);
    }
    const T* wlo = Ws + g * ldw + 8 * t4;
    const T* whi = Ws + (g + 8) * ldw + 8 * t4;
    for (int j0 = 0; j0 < S; j0 += RP_KT) {
      const int jw = j0 + warp * 32;
      if (jw >= S) continue;  // warp-uniform
      float bd[4][4], ac[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) bd[nt][e] = ac[nt][e] = 0.f;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 2
      for (int kc = 0; kc < D; kc += 32) {
        const uint4 lo = *reinterpret_cast<const uint4*>(wlo + kc);
        const uint4 hi = *reinterpret_cast<const uint4*>(whi + kc);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int j = jw + nt * 8 + g;
          const uint4 bv = j < S ? ldg16(basis + (long long)j * D + kc + 8 * t4) : zero;
          mma_k32(bd[nt], lo, hi, bv);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = jw + nt * 8 + g;
#pragma unroll
        for (int c = 0; c < DH / 32; ++c) {
          const uint4 bv = j < S ? ldg16(kb + j * a.k_ss + 32 * c + 8 * t4) : zero;
          mma_k32(ac[nt], ulo[c], uhi[c], bv);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e >> 1), j = jw + nt * 8 + 2 * t4 + (e & 1);
          if (j < S) Ss[row * lds + j] = score_of(ac[nt][e], bd[nt][e], a.scale,
                                                  kbias ? kbias[j] : 0.f);
        }
    }
  } else {
    // One key per thread, all 16 rows: bd from the w . basis FMA loop (v2,
    // fp32) or read from the given tensor (v1); ac from (q + u) . k in fp32.
    const T* bdb = V2 ? nullptr
                      : reinterpret_cast<const T*>(a.bd) + ((long long)b * a.H + h) * S * S;
    for (int j = tid; j < S; j += RP_THREADS) {
      float bd[RP_BQ], ac[RP_BQ];
#pragma unroll
      for (int r = 0; r < RP_BQ; ++r) bd[r] = ac[r] = 0.f;
      if constexpr (V2) {
        fma_rows(bd, reinterpret_cast<const float*>(Ws), ldw,
                 reinterpret_cast<const T*>(a.basis) + (long long)j * D, D);
      } else {
#pragma unroll
        for (int r = 0; r < RP_BQ; ++r) {
          const int i = q0 + r;
          bd[r] = i < S ? to_float(bdb[(long long)i * S + j]) : 0.f;
        }
      }
      fma_rows(ac, QU, LDQ, kb + j * a.k_ss, DH);
      const float kbj = kbias ? kbias[j] : 0.f;
#pragma unroll
      for (int r = 0; r < RP_BQ; ++r) Ss[r * lds + j] = score_of(ac[r], bd[r], a.scale, kbj);
    }
  }
  __syncthreads();

  // -- softmax of each row: fp32, true division; P rounded to T in place -----
  const int spv = (S + 15) & ~15;  // P . V runs over k16 steps; P is 0 past S
  for (int rr = 0; rr < RP_BQ / RP_WARPS; ++rr) {
    const int r = warp * (RP_BQ / RP_WARPS) + rr;
    float* row = Ss + r * lds;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) sum += expf(row[j] - m);
    sum = warp_sum(sum);
    if constexpr (BF) {
      // bf16 P over the row's own first half: iteration j0 writes floats
      // [j0 / 2, j0 / 2 + 16), all read at or before this iteration.
      bf16* prow = reinterpret_cast<bf16*>(row);
      for (int j0 = 0; j0 < spv; j0 += 32) {
        const int j = j0 + lane;
        const float p = j < S ? __fdiv_rn(expf(row[j] - m), sum) : 0.f;
        __syncwarp();
        if (j < spv) prow[j] = __float2bfloat16_rn(p);
        __syncwarp();
      }
    } else {
      for (int j = lane; j < S; j += 32) row[j] = __fdiv_rn(expf(row[j] - m), sum);
    }
  }
  __syncthreads();

  // -- out = P V, fp32 accumulation, rounded to T ------------------------------
  T* ob = reinterpret_cast<T*>(a.out) + ((long long)b * a.H + h) * S * DH;
  if constexpr (BF) {
    constexpr int NT = DH / (8 * RP_WARPS);  // n8 tiles per warp
    const int d0 = warp * (DH / RP_WARPS);
    float o[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    const T* p_lo = reinterpret_cast<const T*>(Ss + g * lds);
    const T* p_hi = reinterpret_cast<const T*>(Ss + (g + 8) * lds);
    const T zero = __float2bfloat16_rn(0.f);
    for (int k0 = 0; k0 < spv; k0 += 16) {
      const int j = k0 + 2 * t4;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(p_lo + j);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(p_hi + j);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(p_lo + j + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(p_hi + j + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* vc = vbase + d0 + nt * 8 + g;
        const T v0 = j < S ? vc[j * a.v_ss] : zero;
        const T v1 = j + 1 < S ? vc[(j + 1) * a.v_ss] : zero;
        const T v2 = j + 8 < S ? vc[(j + 8) * a.v_ss] : zero;
        const T v3 = j + 9 < S ? vc[(j + 9) * a.v_ss] : zero;
        mma_bf16(o[nt], a0, a1, a2, a3, bf16x2_bits(v0, v1), bf16x2_bits(v2, v3));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = q0 + g + 8 * rr;
        if (i < S)
          *reinterpret_cast<uint32_t*>(ob + (long long)i * DH + d0 + nt * 8 + 2 * t4) =
              bf16x2_bits(o[nt][2 * rr], o[nt][2 * rr + 1]);
      }
  } else {
    constexpr int RPT = RP_BQ * DH / RP_THREADS;  // rows per thread
    const int d = tid % DH, r0 = (tid / DH) * RPT;
    float o[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) o[r] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float vv = to_float(vbase[j * a.v_ss + d]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) o[r] = fmaf(Ss[(r0 + r) * lds + j], vv, o[r]);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = q0 + r0 + r;
      if (i < S) ob[(long long)i * DH + d] = from_float<T>(o[r]);
    }
  }
}

template <typename T, bool V2, int DH>
static cudaError_t launch_relpos(const RelposArgs& a, int B, cudaStream_t stream) {
  const size_t smem = rp_smem_bytes<T, V2>(a.S, DH, a.D);
  if (smem > RP_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(relpos_kernel<T, V2, DH>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + RP_BQ - 1) / RP_BQ, a.H, B);
  relpos_kernel<T, V2, DH><<<grid, RP_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool V2>
static cudaError_t dispatch_relpos(const RelposArgs& a, int B, int Dh, int kind,
                                   cudaStream_t st) {
  if (a.S < 1 || (V2 && (a.D < 64 || a.D % 64 != 0))) return cudaErrorInvalidValue;
  if (kind == KIND_BF16) {
    if (Dh == 64) return launch_relpos<bf16, V2, 64>(a, B, st);
    if (Dh == 128) return launch_relpos<bf16, V2, 128>(a, B, st);
  } else {
    if (Dh == 64) return launch_relpos<float, V2, 64>(a, B, st);
    if (Dh == 128) return launch_relpos<float, V2, 128>(a, B, st);
  }
  return cudaErrorInvalidValue;
}

static RelposArgs relpos_args(const void* q, const void* k, const void* v, const void* u,
                              const float* key_bias, void* out, int H, int S, int Dh,
                              long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                              long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                              long long v_ss) {
  RelposArgs a = {};
  a.q = q; a.k = k; a.v = v;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.u = u;
  a.key_bias = key_bias;
  a.out = out;
  a.H = H;
  a.S = S;
  a.scale = (float)(1.0 / sqrt((double)Dh));
  return a;
}

extern "C" int sonar_relpos_flash_v2(const void* q, const void* k, const void* v,
                                     const void* wr, const void* si, const void* ci,
                                     const void* basis, const void* u, const void* vb,
                                     const float* key_bias, void* out, int B, int H, int S,
                                     int Dh, int D, long long q_sb, long long q_sh,
                                     long long q_ss, long long k_sb, long long k_sh,
                                     long long k_ss, long long v_sb, long long v_sh,
                                     long long v_ss, int kind, void* stream) {
  RelposArgs a = relpos_args(q, k, v, u, key_bias, out, H, S, Dh, q_sb, q_sh, q_ss, k_sb, k_sh,
                             k_ss, v_sb, v_sh, v_ss);
  a.wr = wr; a.si = si; a.ci = ci; a.basis = basis; a.vb = vb;
  a.D = D;
  return dispatch_relpos<true>(a, B, Dh, kind, (cudaStream_t)stream);
}

extern "C" int sonar_relpos_flash_v1(const void* q, const void* k, const void* v,
                                     const void* bd, const void* u, const float* key_bias,
                                     void* out, int B, int H, int S, int Dh, long long q_sb,
                                     long long q_sh, long long q_ss, long long k_sb,
                                     long long k_sh, long long k_ss, long long v_sb,
                                     long long v_sh, long long v_ss, int kind, void* stream) {
  RelposArgs a = relpos_args(q, k, v, u, key_bias, out, H, S, Dh, q_sb, q_sh, q_ss, k_sb, k_sh,
                             k_ss, v_sb, v_sh, v_ss);
  a.bd = bd;
  a.D = 0;
  return dispatch_relpos<false>(a, B, Dh, kind, (cudaStream_t)stream);
}
