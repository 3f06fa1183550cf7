// Beam-decode cache reorder with the diagonal attend, for Hopper.
//
// Replaces the TPU kernel sonar_tpu/ops/pallas/beam_attend.py
// beam_reorder_attend (body _reorder_attend_kernel): for each sentence b,
// head h and beam k, the new cache slab [S, Dh] of beam k is the old slab of
// row sel[b, k] with this step's k_new / v_new[b, k, h] at the write
// position (every position where write_onehot != 0), for both caches; then
// beam k's query attends its own new slab. The caches are [B, H, K, S, Dh].
// Numerics are the TPU kernel's: q scaled in fp32 before the dot, fp32
// logits plus the additive position bias, an fp32 softmax with a true
// division, P @ V in fp32, the output cast to q's dtype. The new caches are
// copies, equal bit for bit to the plain version's.
//
// What bounds it on the H100: bytes. Each distinct source slab a
// (sentence, head) names is read once and both caches are written whole:
// at B 32, K 5, H 16, S 51, Dh 64 in bf16 with a random sel ~56 MB, ~17 us
// at 3.35 TB/s (~12 us when every beam names one row). The attend is a few
// MFLOP.
//
// Design: one block per (sentence, head), the positions in chunks staged in
// two 24 KB buffers, one landing while the other is used (the decode cache
// of 51 positions at K 5, Dh 64 in bf16 in 3 chunks: 52 KB a block, four
// blocks an SM, so all 512 blocks of the decode shape run at once; larger
// buffers, fewer blocks an SM, were slower).
//   1. Warp 0 reads sel for its sentence (lane k, beam k) and lists the
//      distinct source rows (two beams that inherit one row read it once),
//      while the other threads load the K queries (scaled, fp32) and this
//      step's K and V rows of the beams: all of it one round trip.
//   2. Per chunk, every thread issues 16-byte cp.async copies of the distinct
//      source slabs' K and V rows, neighbouring threads on neighbouring
//      bytes, into rows padded by 16 bytes (so that 32 lanes reading 32 rows
//      meet no bank twice).
//   3. Every thread writes the beams' new slabs from shared memory with
//      16-byte stores, neighbouring threads on neighbouring bytes (this
//      step's row at the write position), and then warp k attends beam k's
//      slab from shared memory: lane = position for the logits (the row's
//      dot with the query, its whole row in 16-byte reads), an online
//      softmax across the chunks, then lane = feature slice for P @ V. A
//      position whose bias is <= -1e29 contributes exp(-1e30 - m) == 0 in
//      fp32 exactly and is skipped in the attend (it is still copied).
#include "common.cuh"

namespace {

constexpr float kMasked = -1e29f;       // a bias at or below this contributes exactly 0
constexpr int BR_STAGE_BYTES = 48 << 10;  // the staging buffers of a block
constexpr int BR_MAX_BEAMS = 16;
constexpr int BR_BUFS = 2;               // chunk buffers: the next lands while one is used

struct ReorderArgs {
  const void* q;      // [B, K, H, Dh]
  const void* k_new;  // [B, K, H, Dh] this step's keys
  const void* v_new;
  const void* k;      // [B, H, K, S, Dh] before the reorder
  const void* v;
  const int* sel;     // [B, K] winner row each beam inherits from
  const float* vbias; // [S] additive position bias
  const float* wpos;  // [S], != 0 at the write position
  void* k_out;        // [B, H, K, S, Dh]
  void* v_out;
  void* out;          // [B, K, H, Dh]
  int H, K, S;
  int chunk;          // positions staged at once
  float scale;
};

template <int RB>  // bytes of a cache row
struct ReorderLayout {
  static constexpr int PITCH = RB + 16;  // a staged row
  static constexpr int CPR = RB / 16;    // 16-byte chunks of a row
};

// Dynamic shared memory: the scaled queries, this step's rows, the source
// list, then BR_BUFS buffers, each the bias and write flags of a chunk and
// its staged slabs [distinct source][K or V][chunk position][PITCH].
template <int RB>
static size_t reorder_smem(int K, int DH, int chunk) {
  return sizeof(float) * K * DH + 2 * (size_t)K * RB + 2 * 16 * sizeof(int) +
         BR_BUFS * (2 * sizeof(float) * ((chunk + 3) / 4 * 4) +
                    (size_t)K * 2 * chunk * ReorderLayout<RB>::PITCH);
}

template <typename T, int DH>
__global__ void __launch_bounds__(32 * BR_MAX_BEAMS) beam_reorder_kernel(ReorderArgs a) {
  constexpr int RB = DH * sizeof(T), PITCH = ReorderLayout<RB>::PITCH,
                CPR = ReorderLayout<RB>::CPR;
  constexpr int PER = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr int DPL = DH / 32;         // features of a lane in P @ V
  extern __shared__ __align__(16) unsigned char br_smem[];
  const int K = a.K, S = a.S, H = a.H, chunk = a.chunk, cpad = (chunk + 3) / 4 * 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31, warp = tid >> 5;

  float* qs = reinterpret_cast<float*>(br_smem);                        // [K][DH]
  unsigned char* fresh = reinterpret_cast<unsigned char*>(qs + K * DH);  // [K][2][RB]
  int* src = reinterpret_cast<int*>(fresh + 2 * K * RB);                // [16] distinct rows
  int* slot = src + 16;                                                 // [16] beam -> index in src
  unsigned char* bufs = reinterpret_cast<unsigned char*>(slot + 16);
  const size_t buf_bytes = 2 * sizeof(float) * cpad + (size_t)K * 2 * chunk * PITCH;
  auto vbs_of = [&](int c) { return reinterpret_cast<float*>(bufs + (c % BR_BUFS) * buf_bytes); };
  auto staged_of = [&](int c) {
    return bufs + (c % BR_BUFS) * buf_bytes + 2 * sizeof(float) * cpad;
  };

  // -- 1. sources (warp 0: lane k holds sel[b, k]; a row two beams name is
  // listed once), queries, this step's rows, all loads in flight together --
  const size_t row0 = ((size_t)b * K * H + h) * DH;  // q, k_new, v_new row of beam 0
  if (warp == 0) {
    const int r = lane < K ? a.sel[b * K + lane] : -1;
    const bool ok = lane < K && r >= 0 && r < K;
    const unsigned valid = __ballot_sync(0xffffffffu, ok);
    const unsigned same = __match_any_sync(0xffffffffu, ok ? r : -1) & valid;
    const int first = __ffs(same) - 1;  // the first beam that names r
    const unsigned firsts = __ballot_sync(0xffffffffu, ok && first == lane);
    const int d = ok ? __popc(firsts & ((1u << first) - 1u)) : -1;
    if (lane < K) slot[lane] = d;  // -1: a row outside the cache, read as zeros
    if (ok && first == lane) src[d] = r;
    if (lane >= __popc(firsts) && lane < 16) src[lane] = -1;
  }
  for (int i = tid; i < K * DH; i += nthreads) {
    const int k = i / DH, d = i - k * DH;
    qs[i] = to_float(static_cast<const T*>(a.q)[row0 + (size_t)k * H * DH + d]) * a.scale;
  }
  for (int i = tid; i < 2 * K * CPR; i += nthreads) {
    const int k = i / (2 * CPR), which = (i / CPR) & 1, ch = i % CPR;
    const T* from = static_cast<const T*>(which ? a.v_new : a.k_new) + row0 + (size_t)k * H * DH;
    reinterpret_cast<uint4*>(fresh + (k * 2 + which) * RB)[ch] =
        reinterpret_cast<const uint4*>(from)[ch];
  }
  __syncthreads();

  const size_t slab = (size_t)S * DH;         // elements of a slab
  const size_t base = (size_t)bh * K * slab;  // this (sentence, head)'s K slabs
  const T* kin = static_cast<const T*>(a.k) + base;
  const T* vin = static_cast<const T*>(a.v) + base;
  T* kout = static_cast<T*>(a.k_out) + base;
  T* vout = static_cast<T*>(a.v_out) + base;
  int nd = 0;
  while (nd < K && src[nd] >= 0) ++nd;
  const int n_chunks = (S + chunk - 1) / chunk;

  // -- 2. chunk c's distinct source rows (both caches), bias and write flags
  // into buffer c % BR_BUFS, 16 bytes a copy, neighbouring threads on
  // neighbouring bytes -------------------------------------------------------
  auto issue = [&](int c) {
    const int s0 = c * chunk, n = min(chunk, S - s0);
    float* vbs = vbs_of(c);
    unsigned char* staged = staged_of(c);
    for (int i = tid; i < nd * 2 * n * CPR; i += nthreads) {
      const int ch = i % CPR, row = i / CPR;  // row: (source, cache, position)
      const int s = row % n, dc = row / n, d = dc >> 1, which = dc & 1;
      cp_async16(staged + ((size_t)dc * chunk + s) * PITCH + ch * 16,
                 (which ? vin : kin) + (size_t)src[d] * slab + (size_t)(s0 + s) * DH + ch * PER, 16);
    }
    for (int s = tid; s < n; s += nthreads) {
      cp_async4(vbs + s, a.vbias + s0 + s);
      cp_async4(vbs + cpad + s, a.wpos + s0 + s);
    }
  };

  const int kq = warp, my = kq < K ? slot[kq] : -1;
  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  for (int c = 0; c < BR_BUFS - 1; ++c) {
    if (c < n_chunks) issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    // into the buffer of chunk c - 1, free since the barrier that ended it
    if (c + BR_BUFS - 1 < n_chunks) issue(c + BR_BUFS - 1);
    cp_async_commit();
    cp_async_wait<BR_BUFS - 1>();
    __syncthreads();
    const int s0 = c * chunk, n = min(chunk, S - s0);
    const float* vbs = vbs_of(c);
    const float* fl = vbs + cpad;
    const unsigned char* staged = staged_of(c);

    // -- 3a. the beams' new slabs, 16 bytes a thread --------------------------
    for (int i = tid; i < K * 2 * n * CPR; i += nthreads) {
      const int ch = i % CPR, row = i / CPR;  // row: (beam, cache, position)
      const int s = row % n, kc = row / n, k = kc >> 1, which = kc & 1;
      const int d = slot[k];
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (fl[s] != 0.f)
        val = reinterpret_cast<const uint4*>(fresh + (k * 2 + which) * RB)[ch];
      else if (d >= 0)
        val = *reinterpret_cast<const uint4*>(staged + ((size_t)(d * 2 + which) * chunk + s) * PITCH +
                                              ch * 16);
      reinterpret_cast<uint4*>((which ? vout : kout) + (size_t)k * slab + (size_t)(s0 + s) * DH)[ch] =
          val;
    }

    // -- 3b. beam kq attends its new slab's positions of the chunk -----------
    if (kq < K) {
      const float* q = qs + kq * DH;
      auto row_of = [&](int which, int s) -> const T* {
        if (fl[s] != 0.f) return reinterpret_cast<const T*>(fresh + (kq * 2 + which) * RB);
        if (my < 0) return nullptr;
        return reinterpret_cast<const T*>(staged + ((size_t)(my * 2 + which) * chunk + s) * PITCH);
      };
      for (int p0 = 0; p0 < n; p0 += 32) {
        const int s = p0 + lane;
        float logit = -INFINITY;
        if (s < n && vbs[s] > kMasked) {
          const T* r = row_of(0, s);
          if (r) {
            float dot = 0.f;
#pragma unroll
            for (int ch = 0; ch < CPR; ++ch) {
              const uint4 u = reinterpret_cast<const uint4*>(r)[ch];
              const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
              for (int j = 0; j < PER; ++j) dot += q[ch * PER + j] * to_float(e[j]);
            }
            logit = dot + vbs[s];
          }
        }
        const float m_new = fmaxf(m, warp_max(logit));
        const float corr = m_new == -INFINITY ? 1.f : expf(m - m_new);
        const float p = logit == -INFINITY ? 0.f : expf(logit - m_new);
        l = l * corr + warp_sum(p);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] *= corr;
        m = m_new;
        const int cnt = min(32, n - p0);
        for (int j = 0; j < cnt; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          if (pj == 0.f) continue;  // warp-uniform
          const T* r = row_of(1, p0 + j) + lane * DPL;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[i] += pj * to_float(r[i]);
        }
      }
    }
    __syncthreads();  // chunk c's buffer is refilled next
  }
  if (kq < K) {
    T* o = static_cast<T*>(a.out) + row0 + (size_t)kq * H * DH + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = from_float<T>(acc[i] / l);
  }
}

// Positions a chunk: the most whose K staged slabs fit a buffer (the
// staging budget over BR_BUFS), balanced over the chunks S needs.
template <int RB>
static int reorder_chunk(int K, int S) {
  const int most = max(1, BR_STAGE_BYTES / BR_BUFS / (K * 2 * ReorderLayout<RB>::PITCH));
  const int chunks = (S + most - 1) / most;
  return (S + chunks - 1) / chunks;
}

template <typename T, int DH>
static int launch_reorder(ReorderArgs a, int B, cudaStream_t st) {
  constexpr int RB = DH * sizeof(T);
  a.chunk = reorder_chunk<RB>(a.K, a.S);
  const size_t smem = reorder_smem<RB>(a.K, DH, a.chunk);
  cudaError_t err = allow_dynamic_smem(beam_reorder_kernel<T, DH>, smem);
  if (err != cudaSuccess) return (int)err;
  // All of the SM's shared memory: four blocks at the decode shape.
  err = cudaFuncSetAttribute(beam_reorder_kernel<T, DH>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * (a.K > 8 ? a.K : 8);
  beam_reorder_kernel<T, DH><<<B * a.H, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_reorder_dh(const ReorderArgs& a, int B, int Dh, cudaStream_t st) {
  switch (Dh) {
    case 32: return launch_reorder<T, 32>(a, B, st);
    case 64: return launch_reorder<T, 64>(a, B, st);
    case 128: return launch_reorder<T, 128>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int sonar_beam_reorder_attend(const void* q, const void* k_new, const void* v_new,
                                         const void* k, const void* v, const int* sel,
                                         const float* vbias, const float* wpos, void* k_out,
                                         void* v_out, void* out, int B, int H, int K, int S,
                                         int Dh, int kind, void* stream) {
  if (K < 1 || K > BR_MAX_BEAMS || S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  ReorderArgs a{};
  a.q = q; a.k_new = k_new; a.v_new = v_new; a.k = k; a.v = v; a.sel = sel;
  a.vbias = vbias; a.wpos = wpos; a.k_out = k_out; a.v_out = v_out; a.out = out;
  a.H = H; a.K = K; a.S = S;
  a.scale = 1.0f / sqrtf((float)Dh);
  const cudaStream_t st = (cudaStream_t)stream;
  return kind == KIND_BF16 ? launch_reorder_dh<__nv_bfloat16>(a, B, Dh, st)
                           : launch_reorder_dh<float>(a, B, Dh, st);
}
