// Ancestry-masked beam self-attention over the un-reordered KV cache, bf16.
//
// Replaces the TPU kernel sonar_tpu/ops/pallas/beam_attend.py
// beam_masked_attend (body _masked_attend_kernel): each of the K query beams
// of a sentence attends every cache row c and position s that its ancestry
// names (anc[b, q, s] == c), with an additive position bias. It is the
// compute core of the port's _beam_self_attend, launched at every layer of
// every beam-decode step. The cache is [B, H, C, S, Dh], seen here as
// [B*H, C, S, Dh]. fp32 inputs go to the warp-per-beam body of
// csrc/beam_attend.cu (MODE_MASKED), through the same entry point below.
//
// Numerics are the TPU kernel's: q scaled in fp32 before the dot, fp32
// logits plus the additive bias, an fp32 softmax with a true division, P @ V
// in fp32 with P kept in fp32, the output cast to q's dtype. The two
// products run on the tensor cores (mma.sync m16n8k16, fp32 accumulators)
// without giving any of that up: the fp32 scaled q and the fp32 P are each
// split into three bf16 parts whose sum is the fp32 value exactly (8 + 8 +
// 8 significant bits), and each part is multiplied by the bf16 cache rows,
// whose products are exact in fp32; only the order of the sums changes (a
// query part that is zero everywhere, as at Dh 64 where the scale is 1/8,
// is skipped). A block takes the max and the sum over every position of
// its tile before P @ V, so when the tile is the whole cache P is divided by
// its row sum before P @ V, as on the TPU. A longer cache is split over
// blocks (flash-decoding): each keeps P unnormalised against its tile's
// max, and a second launch rescales the partials and divides once, the
// same function up to rounding. A position whose bias is <= -1e29, or a
// (row, position) pair that no beam names, is never read: its term in the
// reference is exp(-1e30 - m) == 0 in fp32 exactly (a valid position
// always exists on the decode path: position 0).
//
// What bounds it on the H100: bytes. A decode query is one Dh vector, so
// the arithmetic is a few MFLOP; the least traffic is every distinct
// (cache row, position) pair that some beam names, read once (at the decode
// shape B 32, K 5, H 16, S 51, idx 25: ~11 MB, ~3.6 us at 3.35 TB/s). The
// previous design (one warp per query beam) read one row per beam and
// position, in a chain of five dependent round trips per 32 positions.
// Measured on the card (PERF.md §6), what holds this one back is the
// chain of dependent steps each block walks (launch, ancestry, pair list,
// loads, logits, softmax, P @ V, each behind a barrier), not its bytes:
// blocks serving several heads, or the whole cache, were slower.
//
// Design: one block per (sentence, head, tile of up to 64 positions).
//   1. The block loads the tile's bias, the K beams' ancestry and the
//      queries together (the queries split into their bf16 parts in shared
//      memory), and marks the distinct (row, position) pairs some beam names
//      at a valid position: a bit mask over the rows per position (shared
//      atomics), a prefix sum over the positions (each warp its own, so no
//      barrier stands between it and the pair list), a compact list of
//      pairs in position order.
//   2. The pairs go through a staging buffer in batches of whole positions
//      (at most 112 pairs at Dh 64: one batch at the decode shape): the
//      first batch's K rows, then its V rows, are issued at once with
//      16-byte cp.async copies (two commit groups). Rows land in a 128-byte
//      XOR swizzle, so ldmatrix reads them without bank conflicts.
//   3. With a batch's K rows in (the first batch's V rows still in flight),
//      each warp computes the logits of 16 pairs against all 16 (padded)
//      query rows and keeps those its beams name; the next batch's K rows
//      follow. Then, batch by batch, one warp a beam takes the tile's max
//      and sum (once) and writes P's three bf16 parts as dense [beam, pair]
//      rows over the K rows no longer needed, and each warp accumulates 8
//      output features of P @ V from the batch's V rows.
//   4. A cache past 64 positions is split into tiles over several blocks
//      (shorter tiles when there are too few blocks for the card); each
//      writes an fp32 partial (acc, max, sum) a beam, and
//      beam_combine_kernel sums the partials in split order and divides (no
//      atomics: repeated calls give equal bits).
#include "common.cuh"

// The fp32 masked attend: the warp-per-beam body of csrc/beam_attend.cu.
int beam_masked_attend_f32(const void* q, const void* k, const void* v, const int* anc,
                           const float* vbias, void* out, int BH, int H, int K, int C, int S,
                           int Dh, cudaStream_t stream);

namespace {

constexpr float kMasked = -1e29f;   // a bias at or below this contributes exactly 0
constexpr int BM_THREADS = 256, BM_WARPS = BM_THREADS / 32;
constexpr int BM_ROWS = 16;         // query beams, padded to the mma's 16 rows
constexpr int BM_TILE = 64;         // positions a block covers at most
constexpr int BM_PPL = BM_TILE / 32; // positions a lane in the softmax
constexpr int BM_STAGE_BYTES = 32768;  // shared memory for one batch of staged K and V rows

struct MaskedArgs {
  const void* q;       // [BH, K, Dh] unscaled
  const void* k;       // [BH, C, S, Dh]
  const void* v;
  const int* anc;      // [B, K, S] cache row per (query beam, position)
  const float* vbias;  // [S] additive position bias
  void* out;           // [BH, K, Dh] in q's dtype
  float* part;         // nsplit > 1: [BH, nsplit, K, Dh + 2] (acc, max, sum)
  int H, K, C, S;
  int tile, nsplit;    // positions a block, blocks a (sentence, head)
  int np;             // pairs a batch
  float scale;
};

// Byte offset of a 16-byte chunk in the 128-byte XOR swizzle: the chunk's
// index in its 128-byte line is XORed with the line's index (mod 8).
__device__ __forceinline__ int swz(int off) { return off ^ (((off >> 7) & 7) << 4); }

// x == hi + mid + lo exactly, each part a bf16 (8 significant bits each).
__device__ __forceinline__ void split3(float x, bf16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(r - __bfloat162float(p[1]));
}

// Shared memory of one block, carved from the dynamic buffer.
template <int DH> struct MaskedSmem {
  static constexpr int ROW = DH * 2;                 // bytes of a bf16 row
  // A K slot of a batch, once its logits are taken, holds P's three bf16
  // parts, [3][16][np] (96 bytes a pair), for P @ V.
  static constexpr int KSLOT = ROW > 96 ? ROW : 96;
  __host__ __device__ static size_t stage(const MaskedArgs& a) {
    return (size_t)a.np * (KSLOT + ROW);
  }
  unsigned char* buf;   // K slot [np][KSLOT], then V rows [np][ROW], swizzled
  unsigned char* qp;    // [3][16][ROW] the bf16 parts of the scaled queries, swizzled
  float* lg;            // [K][tile] logits of (beam, position)
  float* stat;          // [2][16] the tile's max and sum a beam
  float* vb;            // [tile] the position bias
  int* poff;            // [tile * min(K, C)] pair -> row * S + position
  int* first;           // [tile + 1] first pair of each position
  int* sub;             // [tile + 1] first position of each batch
  unsigned* rows;       // [tile] mask of the rows some beam names there
  short* ppos;          // [tile * min(K, C)] pair -> position in the tile
  short* pidx;          // [K][tile] pair of (beam, position); -1: none

  __device__ MaskedSmem(unsigned char* raw, const MaskedArgs& a) {
    const int maxpairs = a.tile * min(a.K, a.C);
    buf = raw;
    qp = buf + stage(a);
    lg = reinterpret_cast<float*>(qp + 3 * BM_ROWS * ROW);
    stat = lg + a.K * a.tile;
    vb = stat + 2 * BM_ROWS;
    poff = reinterpret_cast<int*>(vb + a.tile);
    first = poff + maxpairs;
    sub = first + a.tile + 1;
    rows = reinterpret_cast<unsigned*>(sub + a.tile + 1);
    ppos = reinterpret_cast<short*>(rows + a.tile);
    pidx = ppos + maxpairs;
  }

  static size_t bytes(const MaskedArgs& a) {
    const size_t maxpairs = (size_t)a.tile * min(a.K, a.C);
    return stage(a) + 3 * BM_ROWS * ROW + (size_t)a.K * a.tile * 4 + 2 * BM_ROWS * 4 + a.tile * 4 + maxpairs * 4 + 2 * (a.tile + 1) * 4 +
           a.tile * 4 + maxpairs * 2 + (size_t)a.K * a.tile * 2;
  }
};

// Byte offset of pair p's bf16 in row r of part `part` of P ([3][16][np],
// rows of np / 8 chunks XOR-swizzled by the row).
__device__ __forceinline__ int p_at(int np, int part, int r, int p) {
  return (part * BM_ROWS + r) * np * 2 + (((p >> 3) ^ (r & 7)) << 4) + (p & 7) * 2;
}

template <int DH>
__global__ void __launch_bounds__(BM_THREADS, 4) beam_masked_kernel(MaskedArgs a) {
  using Sm = MaskedSmem<DH>;
  constexpr int ROW = Sm::ROW, CH = ROW / 16;
  constexpr int NT = DH / 8;                          // n8 tiles of the output
  constexpr int NTW = (NT + BM_WARPS - 1) / BM_WARPS; // a warp's output tiles
  constexpr int QPH = BM_ROWS * DH / BM_THREADS;      // query values a thread
  extern __shared__ __align__(128) unsigned char bm_raw[];
  Sm sm(bm_raw, a);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row and column pair
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / a.H;
  const int K = a.K, C = a.C, S = a.S, np_cap = a.np;
  const int s0 = split * a.tile, n = min(a.tile, S - s0);

  // 1. Queries (their three bf16 parts), bias and ancestry of the tile, all
  // loads in flight together; thread (t, kq0) reads position t for beams
  // kq0, kq0 + 4, ...
  constexpr int KPT = BM_ROWS / (BM_THREADS / BM_TILE);  // beams a thread
  const int t_own = tid % BM_TILE, kq0 = tid / BM_TILE;
  float vbt = -INFINITY;
  int cv[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int kq = kq0 + j * (BM_THREADS / BM_TILE);
    cv[j] = t_own < n && kq < K ? a.anc[((size_t)b * K + kq) * S + s0 + t_own] : -1;
  }
  if (t_own < n) vbt = a.vbias[s0 + t_own];
  const bf16* q = static_cast<const bf16*>(a.q) + (size_t)bh * K * DH;
  float qv[QPH];
#pragma unroll
  for (int j = 0; j < QPH; ++j) {
    const int i = tid + j * BM_THREADS;
    qv[j] = i < K * DH ? __bfloat162float(q[i]) : 0.f;  // rows past K: 0
  }
  if (tid < a.tile) sm.rows[tid] = 0u;
  int low_parts = 0;  // does any query need more than its first bf16 part?
#pragma unroll
  for (int j = 0; j < QPH; ++j) {
    const int i = tid + j * BM_THREADS, r = i / DH, d = i % DH;
    bf16 p[3];
    split3(qv[j] * a.scale, p);
    low_parts |= (__bfloat16_as_ushort(p[1]) | __bfloat16_as_ushort(p[2])) & 0x7fff;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<bf16*>(sm.qp + k * BM_ROWS * ROW + swz(r * ROW + d * 2)) = p[k];
  }
  // One part when every scaled query is a bf16 (Dh 64: the scale is 1/8),
  // three otherwise: the parts left out are zeros.
  const int qparts = __syncthreads_or(low_parts) ? 3 : 1;
  if (t_own < n) {  // the row each (beam, position) reads, or -1; the rows named there
    if (kq0 == 0) sm.vb[t_own] = vbt;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kq = kq0 + j * (BM_THREADS / BM_TILE), c = cv[j];
      if (kq >= K) break;
      const bool ok = vbt > kMasked && c >= 0 && c < C;
      sm.pidx[kq * a.tile + t_own] = ok ? (short)c : (short)-1;
      if (ok) atomicOr(sm.rows + t_own, 1u << c);
    }
  }
  __syncthreads();

  // The prefix sum of the pair counts, every warp for itself, so no barrier
  // stands between it and its use: lane l takes positions [l ppl, (l + 1)
  // ppl). Batch j holds the positions whose first pair lies in [j nph, (j +
  // 1) nph): fewer than np pairs, a position holding at most 16; the
  // batches are counted over the positions that hold pairs.
  const int nph = np_cap - 16, ppl = (n + 31) / 32;
  int cnt = 0, lastf = -1;
  for (int t = lane * ppl, t1 = min(n, t + ppl); t < t1; ++t) {
    const int c = __popc(sm.rows[t]);
    if (c > 0) lastf = cnt;  // relative to the lane's range, for now
    cnt += c;
  }
  int inc = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  const int excl = inc - cnt;
  const int nsub = __reduce_max_sync(0xffffffffu, lastf >= 0 ? (excl + lastf) / nph + 1 : 0);
  // The first pair of position t < n: its lane's prefix plus the positions
  // before it in the lane's range (every lane of the warp calls it).
  auto first_of = [&](int t) {
    const int l = t / ppl;
    int f = __shfl_sync(0xffffffffu, excl, l);
    for (int u = l * ppl; u < t; ++u) f += __popc(sm.rows[u]);
    return f;
  };
  for (int t0 = warp * 32; t0 < n; t0 += BM_THREADS) {  // whole warps, for the shuffles
    const int t = min(t0 + lane, n - 1);
    const int f = first_of(t), fp = first_of(max(t - 1, 0)), j = f / nph;
    if (t0 + lane >= n) continue;
    sm.first[t] = f;
    if (j < nsub && (t == 0 || fp / nph != j)) sm.sub[j] = t;  // batch j starts at t
    const unsigned mt = sm.rows[t];
    unsigned m = mt;
    for (int p = f; m; ++p) {  // the pair list, rows ascending
      const int c = __ffs(m) - 1;
      m &= m - 1;
      sm.poff[p] = c * S + s0 + t;
      sm.ppos[p] = (short)t;
    }
    for (int kq = 0; kq < K; ++kq) {  // each (beam, position)'s pair
      const int c = sm.pidx[kq * a.tile + t];
      if (c >= 0) sm.pidx[kq * a.tile + t] = (short)(f + __popc(mt & ((1u << c) - 1u)));
    }
  }
  if (warp == 0 && lane == 31) {
    sm.first[n] = inc;
    sm.sub[nsub] = n;
  }
  __syncthreads();

  // 2. Every batch's K rows in turn, then every batch's V rows; the first
  // batch's K and V rows are issued together (the decode shape has one).
  const bf16* kc = static_cast<const bf16*>(a.k) + (size_t)bh * C * S * DH;
  const bf16* vc = static_cast<const bf16*>(a.v) + (size_t)bh * C * S * DH;
  unsigned char* kb = sm.buf;
  unsigned char* vbuf = kb + (size_t)np_cap * Sm::KSLOT;
  auto issue = [&](const bf16* src, unsigned char* dst, int j) {  // zeros past np
    const int pb = sm.first[sm.sub[j]];
    const int np = sm.first[sm.sub[j + 1]] - pb, npad = (np + 15) & ~15;
    for (int i = tid; i < npad * CH; i += BM_THREADS) {
      const int p = i / CH, c = i % CH;
      cp_async16(dst + swz(p * ROW + c * 16),
                 src + (size_t)(p < np ? sm.poff[pb + p] : 0) * DH + c * 8, p < np ? 16 : 0);
    }
    cp_async_commit();
  };
  if (nsub > 0) {
    issue(kc, kb, 0);
    issue(vc, vbuf, 0);
  }

  // 3a. Logits of 16 pairs a warp against all 16 query rows, kept where the
  // pair's position and beam name it.
  for (int j = 0; j < nsub; ++j) {
    const int pb = sm.first[sm.sub[j]];
    const int np = sm.first[sm.sub[j + 1]] - pb, npad = (np + 15) & ~15;
    if (j > 0) {
      issue(kc, kb, j);  // the slot is free: the barrier below ended batch j - 1
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();  // the first batch's V rows stay in flight
    }
    __syncthreads();
    for (int g16 = warp; g16 < npad / 16; g16 += BM_WARPS) {
      float c2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, kb + swz((g16 * 16 + (lane >> 4) * 8 + (lane & 7)) * ROW +
                                  (ks * 2 + ((lane >> 3) & 1)) * 16));
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          if (part == qparts) break;
          uint32_t af[4];
          ldmatrix_x4(af, sm.qp + part * BM_ROWS * ROW +
                              swz((((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
                                  (ks * 2 + (lane >> 4)) * 16));
          mma_bf16(c2[0], af[0], af[1], af[2], af[3], bfr[0], bfr[1]);
          mma_bf16(c2[1], af[0], af[1], af[2], af[3], bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = g + ((e >> 1) & 1) * 8, c = g16 * 16 + (e >> 2) * 8 + 2 * tg + (e & 1);
        if (r < K && c < np) {
          const int t = sm.ppos[pb + c];
          if (sm.pidx[r * a.tile + t] == pb + c) sm.lg[r * a.tile + t] = c2[e >> 2][e & 3];
        }
      }
    }
    __syncthreads();
  }

  float o[NTW][4];
#pragma unroll
  for (int u = 0; u < NTW; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
  for (int j = 0; j < nsub; ++j) {
    const int ts = sm.sub[j], te = sm.sub[j + 1], pb = sm.first[ts];
    const int npad = ((sm.first[te] - pb) + 15) & ~15;
    if (j > 0) issue(vc, vbuf, j);  // the rows are free: the barrier below ended batch j - 1

    // 3b. One warp a beam: the tile's max and sum (at the first batch), then
    // P of this batch's positions, divided by the sum when the tile is the
    // whole cache, as three bf16 parts in the K slot.
    for (int kq = warp; kq < K; kq += BM_WARPS) {
      const short* pk = sm.pidx + kq * a.tile;
      if (j == 0) {
        float x[BM_PPL], mx = -INFINITY, sum = 0.f;
#pragma unroll
        for (int e = 0; e < BM_PPL; ++e) {
          const int t = lane + 32 * e;
          x[e] = t < n && pk[t] >= 0 ? sm.lg[kq * a.tile + t] + sm.vb[t] : -INFINITY;
          mx = fmaxf(mx, x[e]);
        }
        mx = warp_max(mx);
#pragma unroll
        for (int e = 0; e < BM_PPL; ++e) sum += x[e] == -INFINITY ? 0.f : expf(x[e] - mx);
        sum = warp_sum(sum);
        if (lane == 0) {
          sm.stat[kq] = mx;
          sm.stat[BM_ROWS + kq] = sum;
        }
        __syncwarp();
      }
      const float mx = sm.stat[kq], sum = sm.stat[BM_ROWS + kq];
      for (int i = lane; i < 3 * (npad / 8); i += 32) {  // zero the beam's rows of the parts
        const int part = i / (npad / 8), ch = i % (npad / 8);
        *reinterpret_cast<uint4*>(kb + (part * BM_ROWS + kq) * np_cap * 2 +
                                  ((ch ^ (kq & 7)) << 4)) = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncwarp();
#pragma unroll
      for (int e = 0; e < BM_PPL; ++e) {
        const int t = ts + lane + 32 * e;
        if (t >= te || pk[t] < 0) continue;
        const float x = expf(sm.lg[kq * a.tile + t] + sm.vb[t] - mx);
        bf16 parts[3];
        split3(a.nsplit == 1 ? __fdiv_rn(x, sum) : x, parts);
#pragma unroll
        for (int part = 0; part < 3; ++part)
          *reinterpret_cast<bf16*>(kb + p_at(np_cap, part, kq, pk[t] - pb)) = parts[part];
      }
    }
    cp_async_wait<0>();  // this batch's V rows
    __syncthreads();

    // 3c. P @ V: 8 output features a warp, from P's three bf16 parts (rows
    // past K hold K rows' bytes: their outputs are never stored).
#pragma unroll
    for (int u = 0; u < NTW; ++u) {
      const int nt = warp + u * BM_WARPS;
      if (nt >= NT) break;
      for (int k0 = 0; k0 < npad; k0 += 32) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vbuf + swz((k0 + (lane >> 3) * 8 + (lane & 7)) * ROW + nt * 16));
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kk = k0 + 16 * hf;
          if (kk >= npad) break;
          const int r = ((lane >> 3) & 1) * 8 + (lane & 7), ch = (kk >> 3) + (lane >> 4);
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            uint32_t af[4];
            ldmatrix_x4(af, kb + (part * BM_ROWS + r) * np_cap * 2 + ((ch ^ (r & 7)) << 4));
            mma_bf16(o[u], af[0], af[1], af[2], af[3], bv[2 * hf], bv[2 * hf + 1]);
          }
        }
      }
    }
    __syncthreads();  // P and the V rows are refilled next
  }

  // 4. The output, or this split's partial (a beam with no valid pair: 0).
#pragma unroll
  for (int u = 0; u < NTW; ++u) {
    const int nt = warp + u * BM_WARPS;
    if (nt >= NT) break;
    const int d = nt * 8 + 2 * tg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      if (row >= K) continue;
      const float v0 = o[u][2 * h], v1 = o[u][2 * h + 1];
      if (a.nsplit == 1) {  // P was normalised (a beam with no valid pair: 0)
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.out) + ((size_t)bh * K + row) * DH + d) =
            bf16x2_bits(v0, v1);
      } else {
        const float l = nsub > 0 ? sm.stat[BM_ROWS + row] : 0.f;
        float* pp = a.part + (((size_t)bh * a.nsplit + split) * K + row) * (DH + 2);
        *reinterpret_cast<float2*>(pp + d) = make_float2(v0, v1);
        if (d == 0) {
          pp[DH] = nsub > 0 ? sm.stat[row] : -INFINITY;
          pp[DH + 1] = l;
        }
      }
    }
  }
}

// out[bh, kq] = sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M), the splits
// in order; a split where the beam has no valid pair (l_j == 0) adds
// nothing and its acc is never read. A beam with no valid pair at all gets
// 0, as in the one-block path.
template <typename T>
__global__ void beam_combine_kernel(const float* part, void* out, int K, int nsplit, int DH) {
  const int row = blockIdx.x, bh = row / K, kq = row % K, d = threadIdx.x;
  const float* p = part + ((size_t)bh * nsplit * K + kq) * (DH + 2);
  const size_t step = (size_t)K * (DH + 2);
  float M = -INFINITY;
  for (int j = 0; j < nsplit; ++j)
    if (p[j * step + DH + 1] > 0.f) M = fmaxf(M, p[j * step + DH]);
  float L = 0.f, O = 0.f;
  for (int j = 0; j < nsplit; ++j) {
    const float l = p[j * step + DH + 1];
    if (!(l > 0.f)) continue;
    const float w = expf(p[j * step + DH] - M);
    L = fmaf(l, w, L);
    O = fmaf(p[j * step + d], w, O);
  }
  static_cast<T*>(out)[(size_t)row * DH + d] = from_float<T>(L > 0.f ? O / L : 0.f);
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Tiles of up to BM_TILE positions. A longer cache is split further, the
// tile halved while fewer than two blocks an SM would run and it is longer
// than 32 positions. A cache of one tile stays in one block at any batch:
// at small batches a split would add a workspace and a second launch to
// every call of a decode step, which is host-bound (PERF.md §6).
void masked_tiles(int BH, int S, int* tile, int* nsplit) {
  const long long want = 2LL * num_sms();
  int t = min(S, BM_TILE);
  if (S > BM_TILE)
    while (t > 32 && (long long)BH * ((S + t - 1) / t) < want) t = (t + 1) / 2;
  *tile = t;
  *nsplit = (S + t - 1) / t;
}

template <int DH>
int launch_masked(MaskedArgs a, int BH, cudaStream_t st) {
  a.np = BM_STAGE_BYTES / (4 * DH);  // pairs a batch: a K and a V row of 2 DH bytes each
  const size_t smem = MaskedSmem<DH>::bytes(a);
  cudaError_t err = allow_dynamic_smem(beam_masked_kernel<DH>, smem);
  if (err != cudaSuccess) return (int)err;
  beam_masked_kernel<DH><<<dim3(a.nsplit, BH), BM_THREADS, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || a.nsplit == 1) return (int)err;
  beam_combine_kernel<bf16><<<BH * a.K, DH, 0, st>>>(a.part, a.out, a.K, a.nsplit, DH);
  return (int)cudaGetLastError();
}

}  // namespace

// Positions a block and blocks a (sentence, head) of the bf16 kernel. The
// wrapper asks first, to size the partials' workspace.
extern "C" int sonar_beam_masked_tiles(int BH, int S, int* tile, int* nsplit) {
  masked_tiles(BH, S, tile, nsplit);
  return 0;
}

extern "C" int sonar_beam_masked_attend(const void* q, const void* k, const void* v,
                                        const int* anc, const float* vbias, void* out,
                                        float* part, int BH, int H, int K, int C, int S, int Dh,
                                        float scale, int kind, void* stream) {
  if (K < 1 || K > 16 || C < 1 || C > 32 || S < 1 || BH % H) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind != KIND_BF16)
    return beam_masked_attend_f32(q, k, v, anc, vbias, out, BH, H, K, C, S, Dh, st);
  MaskedArgs a{};
  a.q = q; a.k = k; a.v = v; a.anc = anc; a.vbias = vbias; a.out = out; a.part = part;
  a.H = H; a.K = K; a.C = C; a.S = S; a.scale = scale;
  masked_tiles(BH, S, &a.tile, &a.nsplit);
  if (a.nsplit > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  switch (Dh) {
    case 32: return launch_masked<32>(a, BH, st);
    case 64: return launch_masked<64>(a, BH, st);
    case 128: return launch_masked<128>(a, BH, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
