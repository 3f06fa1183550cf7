// Beam-decode self-attention over the un-reordered KV cache, fp32.
//
// Replaces the TPU kernel sonar_tpu/ops/pallas/beam_attend.py
// beam_masked_attend for fp32 inputs: each of the K query beams of a
// sentence attends every cache row c and position s that its ancestry names
// (anc[b, q, s] == c), with an additive position bias; the compute core of
// the port's _beam_self_attend, launched at every layer of every beam-decode
// step. bf16 runs on the tensor cores in csrc/beam_masked.cu, which also
// holds the C entry point. The other two kernels of that file are
// csrc/beam_diag.cu (beam_diag_attend) and csrc/beam_reorder.cu
// (beam_reorder_attend).
//
// The cache is [B, H, C, S, Dh] (C cache rows per sentence), seen here as
// [B*H, C, S, Dh]. Numerics follow the TPU kernel: q scaled in fp32 before
// the dot, fp32 logits plus the additive bias, softmax and P @ V in fp32,
// the output cast to the input dtype.
//
// What bounds it on the H100: almost no arithmetic (a decode query is one
// Dh vector), so bytes. A query needs, at each position, the one cache row
// its ancestry names. So the kernel reads rows, not the whole C x S slab: a
// position that no query references, or whose bias is <= -1e29, is never
// read. Such a position's term in the reference is exp(-1e29 - m) == 0 in
// fp32 exactly (a valid position always exists on the decode path: position
// 0), so skipping it is the same function.
//
// Design: one block per (sentence, head), one warp per query beam (at most
// 16). A warp walks the positions 32 at a time: each lane finds the row its
// position reads and computes the logit with unrolled 16-byte loads (32
// rows in flight per warp), an online softmax folds the chunk in, and then
// the lanes switch to the feature axis (Dh / 32 values each) to accumulate
// P @ V 8 positions at a time, the row index passed by shuffle and the 8
// coalesced loads issued together. Everything lives in registers; the
// queries are kept in shared memory as fp32 and read by broadcast.
#include "common.cuh"

namespace {

constexpr float kMasked = -1e29f;  // a bias at or below this contributes exactly 0

struct BeamArgs {
  const void* q;      // [B*H, K, Dh]
  const void* k;      // [B*H, C, S, Dh]
  const void* v;
  const int* anc;     // [B, K, S] cache row per (query beam, position)
  const float* vbias; // [S] additive position bias
  void* out;          // laid out like q
  int H, K, C, S, Dh;
  float scale;
};

// DPL consecutive elements of a row slice as floats (the lane's feature
// slice: Dh = 32 * DPL).
template <typename T, int DPL> struct Slice {
  static __device__ __forceinline__ void load(const T* p, float* o) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = to_float(p[i]);
  }
  static __device__ __forceinline__ void store(T* p, const float* o) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) p[i] = from_float<T>(o[i]);
  }
};

// Offset of query beam kq's row of head (bh % H) in q and out.
__device__ __forceinline__ size_t q_offset(const BeamArgs& a, int bh, int kq) {
  return ((size_t)bh * a.K + kq) * a.Dh;
}

// At most 64 registers a thread (two blocks of 512 threads an SM): left to
// itself the compiler took 36 and kept fewer row loads in flight, and the
// fp32 masked attend ran 7% slower.
template <typename T, int DPL>
__global__ void __launch_bounds__(512, 2) beam_attend_kernel(BeamArgs a) {
  extern __shared__ float qs[];  // [K, Dh] scaled queries
  constexpr int DH = 32 * DPL;
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int NONE = -1;              // no row
  constexpr int UNROLL = 8;             // positions of P @ V whose loads are in flight together
  const int bh = blockIdx.x, b = bh / a.H;
  const int kq = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = a.S;

  for (int i = threadIdx.x; i < a.K * DH; i += blockDim.x) {
    qs[i] = to_float(static_cast<const T*>(a.q)[q_offset(a, bh, i / DH) + i % DH]) *
            a.scale;
  }
  __syncthreads();
  const float* q = qs + kq * DH;

  const T* kc = static_cast<const T*>(a.k) + (size_t)bh * a.C * S * DH;
  const T* vc = static_cast<const T*>(a.v) + (size_t)bh * a.C * S * DH;
  const int* anc = a.anc + ((size_t)b * a.K + kq) * S;

  // The row position s of this query reads: a cache row (>= 0) or NONE.
  auto code_of = [&](int s) -> int {
    const int c = anc[s];
    return (c >= 0 && c < a.C) ? c : NONE;
  };
  auto row_ptr = [&](const T* cache, int code, int s) -> const T* {
    return cache + ((size_t)code * S + s) * DH;
  };

  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += 32) {
    // Logits: lane = position, its whole row with 16-byte loads.
    const int s = s0 + lane;
    float logit = -INFINITY;
    int code = NONE;
    if (s < S) {
      const float vb = a.vbias[s];
      if (vb > kMasked) code = code_of(s);
      if (code != NONE) {
        const uint4* r = reinterpret_cast<const uint4*>(row_ptr(kc, code, s));
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DH / PER; ++i) {
          const uint4 u = r[i];
          const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int j = 0; j < PER; ++j) dot += q[i * PER + j] * to_float(e[j]);
        }
        if (vb > kMasked) logit = dot + vb;
      }
    }
    const float m_new = fmaxf(m, warp_max(logit));
    const float corr = m_new == -INFINITY ? 1.f : expf(m - m_new);
    const float p = logit == -INFINITY ? 0.f : expf(logit - m_new);
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
    m = m_new;
    // P @ V: lane = feature slice, UNROLL positions at a time.
    const int n = min(32, S - s0);
    for (int j0 = 0; j0 < n; j0 += UNROLL) {
      float pj[UNROLL], val[UNROLL][DPL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u;  // < 32: j0 <= 24
        pj[u] = __shfl_sync(0xffffffffu, p, j);
        const int cj = __shfl_sync(0xffffffffu, code, j);
        const bool take = j < n && cj != NONE && pj[u] != 0.f;
        if (take) {
          Slice<T, DPL>::load(row_ptr(vc, cj, s0 + j) + lane * DPL, val[u]);
        } else {
#pragma unroll
          for (int i = 0; i < DPL; ++i) val[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += pj[u] * val[u][i];
      }
    }
  }
  T* out = static_cast<T*>(a.out) + q_offset(a, bh, kq);
  float res[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) res[i] = acc[i] / l;
  Slice<T, DPL>::store(out + lane * DPL, res);
}

template <typename T>
int launch_dpl(const BeamArgs& a, int BH, cudaStream_t st) {
  const dim3 grid(BH), block(32 * a.K);
  const size_t smem = (size_t)a.K * a.Dh * sizeof(float);
  switch (a.Dh / 32) {
    case 1: beam_attend_kernel<T, 1><<<grid, block, smem, st>>>(a); break;
    case 2: beam_attend_kernel<T, 2><<<grid, block, smem, st>>>(a); break;
    case 4: beam_attend_kernel<T, 4><<<grid, block, smem, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The fp32 masked attend (called by sonar_beam_masked_attend, beam_masked.cu).
int beam_masked_attend_f32(const void* q, const void* k, const void* v, const int* anc,
                           const float* vbias, void* out, int BH, int H, int K, int C, int S,
                           int Dh, cudaStream_t stream) {
  if (K < 1 || K > 16 || Dh % 32 != 0 || Dh > 128) return (int)cudaErrorInvalidValue;
  BeamArgs a{};
  a.q = q; a.k = k; a.v = v; a.anc = anc; a.vbias = vbias; a.out = out;
  a.H = H; a.K = K; a.C = C; a.S = S; a.Dh = Dh;
  a.scale = 1.0f / sqrtf((float)Dh);
  return launch_dpl<float>(a, BH, stream);
}
