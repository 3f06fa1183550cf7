// Beam-decode diagonal attend over the physically reordered KV cache, for
// Hopper.
//
// Replaces the TPU kernel sonar_tpu/ops/pallas/beam_attend.py
// beam_diag_attend (body _diag_attend_kernel): for each sentence b, head h
// and beam k, the query q[b, k, h] attends beam k's own cache slab
// k_cache[b, h, k] / v_cache[b, h, k] ([S, Dh] each), with an additive
// position bias [S]. q and the output are [B, K, H, Dh]. Numerics are the
// TPU kernel's and in its order: q scaled in fp32 before the dot, fp32
// logits plus the bias, the exact row max, expf, the row sum, P divided by
// it with a true division (__fdiv_rn) before P @ V, P @ V in fp32, the
// output cast to q's dtype.
//
// What bounds it on the H100: bytes. A query is one Dh vector against its
// own rows, so there is no operand reuse for the tensor cores and the
// arithmetic is a few MFLOP. The least traffic is each slab's rows from the
// first to the last position whose bias is above -1e29 (the valid span),
// read once: at B 32, K 5, H 16, S 51, Dh 64, idx 25 in bf16 ~17 MB, ~5.3 us
// at 3.35 TB/s. A position outside the span contributes exp(-1e30 - m) == 0
// in fp32 exactly when some position is valid, so it is never read; a
// masked position inside the span is read but counts exactly 0 (and its
// row is never multiplied, so whatever it holds, NaN included, is
// ignored). With no valid position at all every position counts, as in
// the reference.
//
// Design: every byte a block needs is requested before its first wait on
// the cache. One block of one warp per (sentence, head, beam), so that all
// the blocks of the decode shape (2,560 of ~9.6 KB) are resident at once
// and their rows are all in flight together.
//   1. The warp loads its query slice (scaled, fp32, in registers) and the
//      bias (into shared memory, where the logits will be), and finds the
//      valid span with two ballots: one round trip, the bias an L2 hit for
//      every block but the first.
//   2. Lane 0 issues the span's K rows, then its V rows, as 1-D bulk copies
//      (cp.async.bulk) of up to 32 rows into a ring of two slots, each
//      completing on its own mbarrier: at the decode shape the whole span
//      of K and V is one copy each, both in flight before the first wait. A
//      longer span streams through the ring, K chunks then V chunks, a slot
//      refilled as soon as it is consumed.
//   3. Logits from each K chunk: 32 / L rows at a time, L lanes a row (16
//      bytes each, so every quarter-warp reads 128 contiguous bytes of the
//      unpadded slab: no bank conflicts), summed across the L lanes by
//      shuffles, written over the bias. After the last K chunk: the exact
//      max, expf, the sum and the true division over the span, P in shared
//      memory. Then P @ V from each V chunk, lane over features, a zero P
//      skipped (warp-uniform).
#include "hopper.cuh"

namespace {

constexpr float kMasked = -1e29f;  // a bias at or below this contributes exactly 0
constexpr int BD_CHUNK = 32;       // positions of one bulk copy (one ring slot)
constexpr int BD_SLOTS = 2;        // ring slots: K and V of a short span in flight together
constexpr int BD_MAX_S = 32768;    // positions: the logits live in shared memory

struct DiagArgs {
  const void* q;       // [B, K, H, Dh]
  const void* k;       // [B, H, K, S, Dh]
  const void* v;
  const float* vbias;  // [S] additive position bias
  void* out;           // [B, K, H, Dh]
  int H, K, S;
  float scale;
};

// Dynamic shared memory: the ring's mbarriers, the logits (bias, then
// logits, then P) of every position, the ring's slots.
constexpr int BD_BARS_BYTES = 128;
__host__ __device__ __forceinline__ int bd_logits_bytes(int S) { return (S * 4 + 127) / 128 * 128; }

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int DH>
__global__ void __launch_bounds__(32, 32) beam_diag_kernel(DiagArgs a) {
  constexpr int RB = DH * sizeof(T);  // bytes of a cache row
  constexpr int PER = 16 / sizeof(T); // elements of a lane's 16 bytes of a row
  constexpr int LPR = RB / 16;        // lanes a row in the logits
  constexpr int RPI = 32 / LPR;       // rows a warp-iteration in the logits
  constexpr int DPL = DH / 32;        // features of a lane in P @ V
  extern __shared__ __align__(128) unsigned char bd_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(bd_smem);
  float* lg = reinterpret_cast<float*>(bd_smem + BD_BARS_BYTES);
  unsigned char* slots = bd_smem + BD_BARS_BYTES + bd_logits_bytes(a.S);

  const int S = a.S, lane = threadIdx.x;
  const int bid = blockIdx.x;  // ((b * H + h) * K + k): the slab's index
  const int k = bid % a.K, bh = bid / a.K, b = bh / a.H, h = bh % a.H;
  const size_t qrow = (((size_t)b * a.K + k) * a.H + h) * DH;
  const T* kslab = static_cast<const T*>(a.k) + (size_t)bid * S * DH;
  const T* vslab = static_cast<const T*>(a.v) + (size_t)bid * S * DH;

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < BD_SLOTS; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }

  // -- 1. the query slice and the bias, one round trip; the valid span ---------
  const int part = lane % LPR, sub = lane / LPR;
  float qf[PER];
  {
    const uint4 u = reinterpret_cast<const uint4*>(static_cast<const T*>(a.q) + qrow)[part];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < PER; ++j) qf[j] = to_float(e[j]) * a.scale;
  }
  int lo = S, hi = -1;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const float vb = s < S ? a.vbias[s] : -INFINITY;
    if (s < S) lg[s] = vb;
    const unsigned valid = __ballot_sync(0xffffffffu, vb > kMasked);
    if (valid) {
      lo = min(lo, s0 + __ffs(valid) - 1);
      hi = s0 + 31 - __clz(valid);
    }
  }
  const bool skip_masked = hi >= 0;  // some position is valid
  if (!skip_masked) lo = 0, hi = S - 1;
  const int n = hi - lo + 1, nc = (n + BD_CHUNK - 1) / BD_CHUNK, stages = 2 * nc;
  __syncwarp();  // the mbarriers' initialisation and the bias are seen by every lane

  // -- 2. stage t: K chunk t (t < nc) or V chunk t - nc, into slot t % 2 ------
  auto slot_of = [&](int t) { return slots + (size_t)(t % BD_SLOTS) * BD_CHUNK * RB; };
  auto issue = [&](int t) {
    const int c = t % nc, s0 = lo + c * BD_CHUNK, rows = min(BD_CHUNK, hi + 1 - s0);
    const uint32_t bytes = (uint32_t)rows * RB;
    uint64_t* bar = &bars[t % BD_SLOTS];
    mbar_expect_tx(bar, bytes);
    bulk_load_1d(slot_of(t), (t < nc ? kslab : vslab) + (size_t)s0 * DH, bytes, bar);
  };
  if (lane == 0) {
    for (int t = 0; t < BD_SLOTS && t < stages; ++t) issue(t);
  }

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  for (int t = 0; t < stages; ++t) {
    const int c = t % nc, s0 = lo + c * BD_CHUNK, rows = min(BD_CHUNK, hi + 1 - s0);
    mbar_wait(&bars[t % BD_SLOTS], (t / BD_SLOTS) & 1);
    const T* slot = reinterpret_cast<const T*>(slot_of(t));
    if (t < nc) {
      // -- 3a. logits of the chunk's rows, L lanes a row ----------------------
      for (int r0 = 0; r0 < rows; r0 += RPI) {
        const int r = r0 + sub;
        float dot = 0.f;
        if (r < rows) {
          const uint4 u = reinterpret_cast<const uint4*>(slot + (size_t)r * DH)[part];
          const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int j = 0; j < PER; ++j) dot += qf[j] * to_float(e[j]);
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (part == 0 && r < rows) {
          const float vb = lg[s0 + r];
          lg[s0 + r] = skip_masked && vb <= kMasked ? -INFINITY : dot + vb;
        }
      }
      if (t == nc - 1) {
        // -- 3b. softmax over the span: exact max, expf, sum, true division ----
        __syncwarp();
        float m = -INFINITY;
        for (int s = lo + lane; s <= hi; s += 32) m = fmaxf(m, lg[s]);
        m = warp_max(m);
        float sum = 0.f;
        for (int s = lo + lane; s <= hi; s += 32) {
          const float e = expf(lg[s] - m);
          lg[s] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int s = lo + lane; s <= hi; s += 32) lg[s] = __fdiv_rn(lg[s], sum);
      }
    } else {
      // -- 3c. P @ V of the chunk's rows, lane over features --------------------
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float p = lg[s0 + r];
        if (p == 0.f) continue;  // warp-uniform
        const Pack<T, DPL> pk = reinterpret_cast<const Pack<T, DPL>*>(slot + (size_t)r * DH)[lane];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += p * to_float(pk.v[i]);
      }
    }
    __syncwarp();  // every lane is done with slot t % 2 (and, after 3b, P is written)
    if (lane == 0 && t + BD_SLOTS < stages) issue(t + BD_SLOTS);
  }
  T* o = static_cast<T*>(a.out) + qrow + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) o[i] = from_float<T>(acc[i]);
}

template <typename T, int DH>
int launch_diag(const DiagArgs& a, int blocks, cudaStream_t st) {
  const size_t smem = BD_BARS_BYTES + bd_logits_bytes(a.S) + (size_t)BD_SLOTS * BD_CHUNK * DH * sizeof(T);
  cudaError_t err = allow_dynamic_smem(beam_diag_kernel<T, DH>, smem);
  if (err != cudaSuccess) return (int)err;
  // All of the SM's shared memory: ~23 blocks an SM at the decode shape.
  err = cudaFuncSetAttribute(beam_diag_kernel<T, DH>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  beam_diag_kernel<T, DH><<<blocks, 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_diag_dh(const DiagArgs& a, int blocks, int Dh, cudaStream_t st) {
  switch (Dh) {
    case 32: return launch_diag<T, 32>(a, blocks, st);
    case 64: return launch_diag<T, 64>(a, blocks, st);
    case 128: return launch_diag<T, 128>(a, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v and out 16-byte aligned (the wrapper checks).
extern "C" int sonar_beam_diag_attend(const void* q, const void* k, const void* v,
                                      const float* vbias, void* out, int B, int H, int K, int S,
                                      int Dh, int kind, void* stream) {
  if (B < 1 || H < 1 || K < 1 || K > 16 || S < 1 || S > BD_MAX_S)
    return (int)cudaErrorInvalidValue;
  DiagArgs a{};
  a.q = q; a.k = k; a.v = v; a.vbias = vbias; a.out = out;
  a.H = H; a.K = K; a.S = S;
  a.scale = 1.0f / sqrtf((float)Dh);
  const int blocks = B * H * K;
  const cudaStream_t st = (cudaStream_t)stream;
  return kind == KIND_BF16 ? launch_diag_dh<__nv_bfloat16>(a, blocks, Dh, st)
                           : launch_diag_dh<float>(a, blocks, Dh, st);
}
