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
//
// v2 in bf16, the Conformer's path (relpos_v2_rt_kernel): a block takes 64
// query rows of one (batch, head), so that every basis tile it reads serves
// 64 rows (16 rows a block, reading the basis from L2 straight into mma
// fragments, moved ~5 GB through L2 a call at the speech shape). w [64, D]
// (128 KB in bf16) stays in shared memory in the swizzled layout wgmma reads;
// 64 fp32 score rows (512 KB at S 2048) do not fit beside it, so the scores
// go to a workspace in device memory (32 KB a block per 128 keys, read back
// by the thread that wrote it, mostly from L2). Pass 1 computes each score
// once, stores it and keeps each row's running max and sum of exponentials;
// pass 2 reads the scores back, forms P = exp(s - max) / sum, rounded to
// bf16 in registers before P V, where the TPU kernel rounds it. The basis, K
// and V stream through a ring of 16 KB slots that a producer warp fills by
// TMA (mbarriers: full when a tile landed, empty when both blocks of a
// cluster released it); the two blocks of a cluster load half of each tile
// each, multicast into both. bd and ac run on wgmma (m64n64k16: w and the
// tiles from shared memory, q + u from registers) into two accumulators,
// added once as the TPU kernel adds them; z and P V on mma.sync, V through
// ldmatrix.trans. What bounds it now: shared-memory bandwidth (each tile is
// written by TMA and read by both warpgroups' wgmma, with w's rows: 48 KB
// for 1 MFLOP).
// One departure from the TPU kernel's rounding points: the row sum of
// exp(s - max) is an online sum (each 128-key tile's share, rescaled when
// the row's running max grows, then the two key halves' shares combined)
// where the TPU kernel sums the whole row under its final max. The max,
// each exponential and the division are the TPU kernel's; the sum may
// differ from it in its last bits.
//
// v2 in fp32 has no tensor-core path that keeps fp32: three launches,
// relpos_w_kernel (w [S, D] per head into the workspace), sgemm_nt_kernel
// (bd = w basis^T on 128 x 128 tiles of FMAs, each basis value fetched once
// per 128 query rows where a 16-row block fetched it once per 16) and the
// v1 kernel on that bd.
//
// v1 in bf16 (relpos_v1_tc_kernel). What bounds it at [8, 16, 499, 64] in
// principle: bytes, 96 MB, two thirds of them the given bd [B, H, S, S]
// (0.029 ms at 3.35 TB/s), against 8 GFLOP of tensor-core work. The design:
//   - a block takes 32 query rows of one (batch, head) (16 past S ~1400, where
//     32 rows' scores no longer fit), so each K and V tile it stages serves
//     all of them; K, V and bd come through one ring of 2-3 slots by 16-byte
//     cp.async: per 64-key tile, K in 64-column items (rows padded to 144
//     bytes, read by ldmatrix), and beside the last one the block's bd rows
//     of those keys. bd rows start at any element (S odd), so each row's 64
//     keys come as the 9 aligned 16-byte chunks that cover them, and the
//     row's offset into its chunk is added on reading;
//   - ac = (q + u) . k on mma.sync, exactly: q, u and k are bf16, so
//     (q + u) . k = q . k + u . k with every product exact in fp32; u is
//     given as a second A operand (its value in all 16 rows), into the same
//     fp32 accumulator. Only the order of the fp32 sum differs from the TPU
//     kernel's, which adds q + u in fp32 first;
//   - score = (ac + bd) * scale + key bias into shared memory, fp32, all S
//     of the block's rows (32 x 512 x 4 = 64 KB at S 499), so the row max is
//     exact; each thread then replaces its own scores by exp(s - max) (one
//     expf a logit) and the rows' sums combine across the 4 warps that share
//     a row;
//   - P = exp / sum, divided as __fdiv_rn divides (tc_normalise) and rounded
//     to bf16 where the TPU kernel rounds it, is the A fragment of P V on
//     mma.sync, V's tiles through the same ring (ldmatrix.trans); the 4
//     warps of a row group each sum 16 keys of every tile, and their fp32
//     partials are added in a fixed order at the end.
// What holds it back, measured on the card (PERF.md §6): not bytes (without
// bd it is 10% faster) and not the tensor cores, but the instructions and
// dependent steps each 64-key item costs its warps (the copies' issue, the
// products' chain, the epilogue), behind a block barrier an item. Designs
// measured slower: 64-row blocks (one an SM), a producer warp issuing every
// copy, K and V by TMA boxes, a bulk copy per bd row.
// v1 in fp32 (relpos_kernel), also the last launch of v2 in fp32: one block
// of 8 warps per (batch, head, 16 query rows), the 16 fp32 score rows in
// shared memory (128 KB at S 2048), one pass over the keys, fp32 FMAs.
#include "attention.cuh"
#include "hopper.cuh"

constexpr int RP_BQ = 16;         // query rows per block: one m16 tile
constexpr int RP_WARPS = 8;
constexpr int RP_THREADS = 32 * RP_WARPS;
constexpr int RP_KT = 32 * RP_WARPS;  // a score row's length is a multiple of this
constexpr int RP_SPAD = 16;       // floats of padding after a score row
constexpr int RP_QPAD = 4;        // floats of padding after a qu / qv row
constexpr size_t RP_MAX_SMEM = 232448;

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
  float* work;        // v2: the workspace of one launch (bf16: scores; fp32: w, then bd)
  int H, S, D;
  int b0;             // the launch's first batch row: blockIdx.z + b0 is the batch
  float scale;
};

__host__ __device__ inline int rp_score_ld(int S) {
  return ((S + RP_KT - 1) / RP_KT) * RP_KT + RP_SPAD;
}

static size_t rp_smem_bytes(int S, int Dh) {
  return sizeof(float) * RP_BQ * ((size_t)rp_score_ld(S) + Dh + RP_QPAD);  // scores, q + u
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

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// acc[r] += sum_e A[r][e] x[e] over e < n (n a multiple of 8), A in shared
// memory (every thread reads the same A: broadcast), x a row in device memory.
__device__ __forceinline__ void fma_rows(float (&acc)[RP_BQ], const float* A, int lda,
                                         const float* x, int n) {
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

// v1 in fp32, and the last launch of v2 in fp32 (bd from its workspace).
// Two blocks an SM (at most 128 registers a thread): at one, v1 ran 1.5x
// slower.
template <int DH>
__global__ void __launch_bounds__(RP_THREADS, 2) relpos_kernel(RelposArgs a) {
  constexpr int LDQ = DH + RP_QPAD;
  extern __shared__ __align__(16) unsigned char rp_smem[];
  const int S = a.S, lds = rp_score_ld(S);
  float* Ss = reinterpret_cast<float*>(rp_smem);  // [16][lds] scores, then P in place
  float* QU = Ss + RP_BQ * lds;                    // [16][LDQ] q + u

  const int q0 = blockIdx.x * RP_BQ, h = blockIdx.y, b = blockIdx.z + a.b0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qb = reinterpret_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = reinterpret_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vbase = reinterpret_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* kbias = a.key_bias ? a.key_bias + (long long)b * S : nullptr;

  // Query rows plus u (rows past S read as 0).
  for (int e = tid; e < RP_BQ * DH; e += RP_THREADS) {
    const int r = e / DH, d = e - r * DH, i = q0 + r;
    const float qx = i < S ? qb[i * a.q_ss + d] : 0.f;
    QU[r * LDQ + d] = __fadd_rn(qx, reinterpret_cast<const float*>(a.u)[h * DH + d]);
  }
  __syncthreads();

  // -- scores of the 16 rows against every key, into shared memory: bd read
  // from the given [B, H, S, S] tensor (of this launch's batch rows), ac =
  // (q + u) . k -------------------------------------------------------------
  const float* bdb = reinterpret_cast<const float*>(a.bd) + ((long long)blockIdx.z * a.H + h) * S * S;
  for (int j = tid; j < S; j += RP_THREADS) {
    float bd[RP_BQ], ac[RP_BQ];
#pragma unroll
    for (int r = 0; r < RP_BQ; ++r) {
      const int i = q0 + r;
      bd[r] = i < S ? bdb[(long long)i * S + j] : 0.f;
      ac[r] = 0.f;
    }
    fma_rows(ac, QU, LDQ, kb + j * a.k_ss, DH);
    const float kbj = kbias ? kbias[j] : 0.f;
#pragma unroll
    for (int r = 0; r < RP_BQ; ++r) Ss[r * lds + j] = score_of(ac[r], bd[r], a.scale, kbj);
  }
  __syncthreads();

  // -- softmax of each row, true division, in place ---------------------------
  for (int rr = 0; rr < RP_BQ / RP_WARPS; ++rr) {
    const int r = warp * (RP_BQ / RP_WARPS) + rr;
    float* row = Ss + r * lds;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) sum += expf(row[j] - m);
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) row[j] = __fdiv_rn(expf(row[j] - m), sum);
  }
  __syncthreads();

  // -- out = P V, fp32 accumulation --------------------------------------------
  float* ob = reinterpret_cast<float*>(a.out) + ((long long)b * a.H + h) * S * DH;
  constexpr int RPT = RP_BQ * DH / RP_THREADS;  // rows per thread
  const int d = tid % DH, r0 = (tid / DH) * RPT;
  float o[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) o[r] = 0.f;
  for (int j = 0; j < S; ++j) {
    const float vv = vbase[j * a.v_ss + d];
#pragma unroll
    for (int r = 0; r < RPT; ++r) o[r] = fmaf(Ss[(r0 + r) * lds + j], vv, o[r]);
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = q0 + r0 + r;
    if (i < S) ob[(long long)i * DH + d] = o[r];
  }
}

// -- v1 in bf16: the tensor-core kernel -------------------------------------------

constexpr int V1_KT = 64;          // keys of a tile
constexpr int V1_KP = 4;           // warps of a row group: each takes 16 keys of every tile
constexpr int V1_PITCH = 144;      // bytes of a staged row: 64 bf16 + 16 (K, V) or 9 chunks (bd)

__host__ __device__ inline int v1_score_ld(int S) {  // == 8 (mod 32): float2 rows meet no bank twice
  return (S + V1_KT - 1) / V1_KT * V1_KT + 8;
}

// One ring slot: a K or V item (64 keys x 64 columns), then, with K's last
// item of a tile, the block's bq rows of bd for those keys.
__host__ __device__ inline int v1_slot_bytes(int bq) { return V1_PITCH * (V1_KT + bq); }

static size_t v1_smem(int S, int DH, int bq, int stages) {
  // scores and the rows' max and sum (4 warps each), the ring; later the 4
  // warps' output partials of a row group, rows padded by 8 floats
  const size_t main = sizeof(float) * (size_t)bq * (v1_score_ld(S) + 2 * V1_KP) +
                      (size_t)stages * v1_slot_bytes(bq);
  const size_t red = sizeof(float) * V1_KP * (size_t)bq * (DH + 8);
  return main > red ? main : red;
}

__device__ __forceinline__ void cp_async_wait_upto(int n) {  // n in 0..2
  if (n >= 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// One block of BQ / 16 row groups x 4 warps per (batch, head, BQ query
// rows); warp (rg, kp) takes rows 16 rg .. 16 rg + 15 and keys 16 kp ..
// 16 kp + 15 of every 64-key tile, in both products. Items through the
// ring, in order: per tile, K's DH / 64 column blocks (bd with the last),
// then per tile V's. Each thread's share of the copies is worked out once
// (BQ is a template parameter, so its count is a constant), an item costs
// one block barrier, and the loads that do not need the item are issued
// before it.
template <int DH, int BQ>
__global__ void __launch_bounds__(BQ * 8, 1) relpos_v1_tc_kernel(RelposArgs a, int stages) {
  constexpr int CB = DH / 64;  // 64-column items of a K or V tile
  constexpr int bq = BQ, nthreads = BQ * 8;
  extern __shared__ __align__(16) unsigned char v1_raw[];
  const int S = a.S, lds = v1_score_ld(S), tiles = (S + V1_KT - 1) / V1_KT;
  float* Ss = reinterpret_cast<float*>(v1_raw);  // [bq][lds] scores, then exp(s - max)
  float* mx = Ss + bq * lds;                     // [4][bq] the warps' row maxima
  float* sm = mx + V1_KP * bq;                   // [4][bq] and sums
  unsigned char* ring = reinterpret_cast<unsigned char*>(sm + V1_KP * bq);
  const int slot_bytes = v1_slot_bytes(bq);
  unsigned char* const ring_end = ring + stages * slot_bytes;

  const int q0 = blockIdx.x * bq, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, rg = warp / V1_KP, kp = warp % V1_KP;
  const int row0 = 16 * rg + g;  // this thread's rows: row0, row0 + 8 (of the block)
  const bf16* kb = reinterpret_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = reinterpret_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const long long bd_row = ((long long)b * a.H + h) * S + q0;  // flat row index of row 0
  const float* kbias = a.key_bias ? a.key_bias + (long long)b * S : nullptr;
  const int n_a = tiles * CB, n_items = 2 * n_a;

  // This thread's 16-byte cp.async copies of an item, worked out once. K or
  // V: rows kv_r0 + i kv_rstep (i < kv_n) of the 64-key tile, chunk kv_ch.
  // bd: the (row, chunk) pairs tid and tid + nthreads of the bq x 9 grid;
  // row r's keys j0 .. j0 + len - 1 start at flat element f = (bd_row + r)
  // S + j0, at offset f % 8 (the same for every tile) into the aligned chunk
  // that holds it, and chunk ch is copied when 8 ch - f % 8 < len.
  const int kv_ch = tid & 7, kv_r0 = tid >> 3;
  constexpr int kv_rstep = nthreads >> 3, kv_n = V1_KT * 8 / nthreads;
  const bf16* bd_src[2];
  int bd_dst[2], bd_lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = tid + i * nthreads, r = e / 9, ch = e - r * 9;
    const long long f = (bd_row + r) * S;
    const int off = (int)(f & 7);
    const bool row_in = e < bq * 9 && q0 + r < S;
    bd_src[i] = reinterpret_cast<const bf16*>(a.bd) + (row_in ? f - off + 8 * ch : 0);
    bd_dst[i] = V1_KT * V1_PITCH + r * V1_PITCH + ch * 16;
    bd_lim[i] = row_in ? 8 * ch - off : V1_KT;  // never copied when >= len
  }
  int n_issued = 0;
  unsigned char* issue_slot = ring;
  auto issue = [&]() {  // the next item into the next slot, if there is one
    if (n_issued >= n_items) return;
    const int it = n_issued++;
    const bool is_v = it >= n_a;
    const int k = is_v ? it - n_a : it, t = k / CB, c = k % CB, j0 = t * V1_KT;
    unsigned char* slot = issue_slot;
    issue_slot = issue_slot + slot_bytes == ring_end ? ring : issue_slot + slot_bytes;
    const long long ss = is_v ? a.v_ss : a.k_ss;
    const bf16* src = (is_v ? vb : kb) + 64 * c + j0 * ss + kv_ch * 8;
#pragma unroll
    for (int i = 0; i < kv_n; ++i) {  // keys past S: zeros
      const int r = kv_r0 + i * kv_rstep;
      const bool in = j0 + r < S;
      cp_async16(slot + r * V1_PITCH + kv_ch * 16, in ? src + r * ss : src, in ? 16 : 0);
    }
    if (!is_v && c == CB - 1) {
      const int len = min(V1_KT, S - j0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (bd_lim[i] < len) cp_async16(slot + bd_dst[i], bd_src[i] + j0, 16);
    }
  };
  for (int i = 0; i < stages - 1; ++i) {
    issue();
    cp_async_commit();
  }
  const unsigned char* use_slot = ring;
  auto next = [&]() {  // the next item's slot, landed; the ring refilled behind it
    if (stages == 1) {
      __syncthreads();  // every warp is done with the one slot
      issue();
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      cp_async_wait_upto(stages - 2);
      __syncthreads();  // the item landed for every thread; the slot before it is free
      issue();
      cp_async_commit();
    }
    const unsigned char* slot = use_slot;
    use_slot = use_slot + slot_bytes == ring_end ? ring : use_slot + slot_bytes;
    return slot;
  };

  int off[2];  // where each of this thread's rows starts in its staged bd chunks
  bool live[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 8 * rr;
    off[rr] = (int)(((bd_row + r) * S) & 7);
    live[rr] = q0 + r < S;
  }

  // -- pass 1: the scores, into shared memory; this thread's row maxima ------
  float mrow[2] = {-INFINITY, -INFINITY};
  {
    uint32_t qa[DH / 16][4], ua[DH / 16][2];
    tc_load_q<DH>(qa, reinterpret_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
                  q0 + 16 * rg, S, DH, true, lane);
    const bf16* ub = reinterpret_cast<const bf16*>(a.u) + h * DH;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      ua[kk][0] = *reinterpret_cast<const uint32_t*>(ub + 16 * kk + 2 * t4);
      ua[kk][1] = *reinterpret_cast<const uint32_t*>(ub + 16 * kk + 2 * t4 + 8);
    }
    // ldmatrix rows: lanes 0-7 keys 0-7 at columns 0-7 of a k16 step, 8-15
    // the same keys at 8-15, 16-31 keys 8-15: b0, b1 of two n8 tiles.
    const int lrow = (kp * 16 + (lane & 7) + 8 * (lane >> 4)) * (V1_PITCH / 2) + 8 * ((lane >> 3) & 1);
    for (int t = 0; t < tiles; ++t) {
      const int j0 = t * V1_KT, jt = j0 + kp * 16 + 2 * t4;  // this thread's first key
      float kbv[2][2];  // the key bias of its 4 keys (0 past S)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jt + nt * 8 + e;
          kbv[nt][e] = kbias && j < S ? __ldg(kbias + j) : 0.f;
        }
      float acc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
      for (int c = 0; c < CB; ++c) {  // K's column blocks (compile-time: qa stays in registers)
        const unsigned char* slot = next();
        const bf16* kt = reinterpret_cast<const bf16*>(slot) + lrow;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kt + 16 * kk);
          const uint32_t* qf = qa[4 * c + kk];
          const uint32_t u0 = ua[4 * c + kk][0], u1 = ua[4 * c + kk][1];
          mma_bf16(acc[0], qf[0], qf[1], qf[2], qf[3], kf[0], kf[1]);
          mma_bf16(acc[0], u0, u0, u1, u1, kf[0], kf[1]);
          mma_bf16(acc[1], qf[0], qf[1], qf[2], qf[3], kf[2], kf[3]);
          mma_bf16(acc[1], u0, u0, u1, u1, kf[2], kf[3]);
        }
        if (c == CB - 1) {
          const unsigned char* rows = slot + V1_KT * V1_PITCH;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int j = jt + nt * 8, jj = j - j0;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int r = row0 + 8 * rr;
              const bf16* bdr = reinterpret_cast<const bf16*>(rows + r * V1_PITCH) + off[rr] + jj;
              const float bd0 = live[rr] ? __bfloat162float(bdr[0]) : 0.f;
              const float bd1 = live[rr] ? __bfloat162float(bdr[1]) : 0.f;
              const float s0 =
                  j < S ? score_of(acc[nt][2 * rr], bd0, a.scale, kbv[nt][0]) : -INFINITY;
              const float s1 =
                  j + 1 < S ? score_of(acc[nt][2 * rr + 1], bd1, a.scale, kbv[nt][1]) : -INFINITY;
              mrow[rr] = fmaxf(mrow[rr], fmaxf(s0, s1));
              *reinterpret_cast<float2*>(Ss + r * lds + j) = make_float2(s0, s1);
            }
          }
        }
      }
    }
  }

  // -- the row max over the 4 warps; exp(s - max) in place over this thread's
  // own scores; the row sums -----------------------------------------------
  float M[2], L[2], RL[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float m = quad_max(mrow[rr]);
    if (t4 == 0) mx[kp * bq + row0 + 8 * rr] = m;
  }
  __syncthreads();
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 8 * rr;
    M[rr] = fmaxf(fmaxf(mx[r], mx[bq + r]), fmaxf(mx[2 * bq + r], mx[3 * bq + r]));
  }
  float* own = Ss + row0 * lds + kp * 16 + 2 * t4;  // this thread's scores: + 8 rr lds + 64 t + 8 nt
#pragma unroll 2
  for (int t = 0; t < tiles; ++t)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float2* x = reinterpret_cast<float2*>(own + 8 * rr * lds + t * V1_KT + nt * 8);
        float2 e = *x;
        e.x = expf(e.x - M[rr]);
        e.y = expf(e.y - M[rr]);
        *x = e;
        l[rr] += e.x + e.y;
      }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float sum = quad_sum(l[rr]);
    if (t4 == 0) sm[kp * bq + row0 + 8 * rr] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 8 * rr;
    L[rr] = ((sm[r] + sm[bq + r]) + sm[2 * bq + r]) + sm[3 * bq + r];
    RL[rr] = __frcp_rn(L[rr]);
  }

  // -- pass 2: P = exp / sum (as __fdiv_rn rounds it), rounded to bf16, times
  // V over this warp's 16 keys of every tile --------------------------------
  float o[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  {
    // ldmatrix.trans rows: lanes 0-7 keys 0-7, 8-15 keys 8-15 at columns
    // 0-7 of a 16-column step, 16-31 the same keys at columns 8-15.
    const int vrow = (kp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * (V1_PITCH / 2) + 8 * (lane >> 4);
    for (int t = 0; t < tiles; ++t) {
      float x[2][4];  // P of this warp's 16 keys: needs no V, so before the item's barrier
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float2 e =
              *reinterpret_cast<const float2*>(own + 8 * rr * lds + t * V1_KT + nt * 8);
          x[nt][2 * rr] = e.x;
          x[nt][2 * rr + 1] = e.y;
        }
      tc_normalise<2>(x, L, RL);
      uint32_t pa[4];
      tc_pack_p(pa, x[0], x[1]);
#pragma unroll
      for (int c = 0; c < CB; ++c) {  // V's column blocks (compile-time: o stays in registers)
        const bf16* vt = reinterpret_cast<const bf16*>(next()) + vrow;
#pragma unroll
        for (int n = 0; n < 4; ++n) {  // V's B fragments: keys along k, ldmatrix.trans
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vt + 16 * n);
          mma_bf16(o[8 * c + 2 * n], pa[0], pa[1], pa[2], pa[3], vf[0], vf[1]);
          mma_bf16(o[8 * c + 2 * n + 1], pa[0], pa[1], pa[2], pa[3], vf[2], vf[3]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the ring and the scores

  // -- the 4 warps' partials of a row group, added in order, rounded to bf16 --
  constexpr int RP = DH + 8;
  float* red = reinterpret_cast<float*>(v1_raw);  // [4][bq][RP]
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<float2*>(red + (kp * bq + row0 + 8 * rr) * RP + 8 * nt + 2 * t4) =
          make_float2(o[nt][2 * rr], o[nt][2 * rr + 1]);
  __syncthreads();
  bf16* ob = reinterpret_cast<bf16*>(a.out) + (((long long)b * a.H + h) * S + q0) * DH;
  const int rows = min(bq, S - q0);
  for (int e = tid; e < rows * (DH / 2); e += nthreads) {
    const int r = e / (DH / 2), col = 2 * (e - r * (DH / 2));
    float2 sum = *reinterpret_cast<const float2*>(red + r * RP + col);
#pragma unroll
    for (int w = 1; w < V1_KP; ++w) {
      const float2 p = *reinterpret_cast<const float2*>(red + (w * bq + r) * RP + col);
      sum.x = __fadd_rn(sum.x, p.x);
      sum.y = __fadd_rn(sum.y, p.y);
    }
    *reinterpret_cast<uint32_t*>(ob + (long long)r * DH + col) = bf16x2_bits(sum.x, sum.y);
  }
}

// -- v2 in fp32: w, then bd = w basis^T, then the v1 kernel --------------------------

// w = rotate((q + v_bias) Wr_h^T) of 16 query rows, in fp32, into the
// workspace as [batch row of the launch, H, S, D].
template <int DH>
__global__ void __launch_bounds__(RP_THREADS) relpos_w_kernel(RelposArgs a) {
  constexpr int LDQ = DH + RP_QPAD;
  __shared__ __align__(16) float QV[RP_BQ * LDQ];
  const int S = a.S, D = a.D, half = D / 2;
  const int q0 = blockIdx.x * RP_BQ, h = blockIdx.y, b = blockIdx.z + a.b0;
  const float* qb = reinterpret_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* vb = reinterpret_cast<const float*>(a.vb) + h * DH;
  for (int e = threadIdx.x; e < RP_BQ * DH; e += RP_THREADS) {
    const int r = e / DH, d = e - r * DH, i = q0 + r;
    QV[r * LDQ + d] = i < S ? __fadd_rn(qb[i * a.q_ss + d], vb[d]) : 0.f;
  }
  __syncthreads();
  const float* wr = reinterpret_cast<const float*>(a.wr) + (long long)h * D * DH;
  const float* si = reinterpret_cast<const float*>(a.si);
  const float* ci = reinterpret_cast<const float*>(a.ci);
  float* w = a.work + ((long long)blockIdx.z * a.H + h) * S * D;
  for (int dp = threadIdx.x; dp < half; dp += RP_THREADS) {
    float zs[RP_BQ], zc[RP_BQ];
#pragma unroll
    for (int r = 0; r < RP_BQ; ++r) zs[r] = zc[r] = 0.f;
    fma_rows(zs, QV, LDQ, wr + (long long)dp * DH, DH);
    fma_rows(zc, QV, LDQ, wr + (long long)(dp + half) * DH, DH);
#pragma unroll
    for (int r = 0; r < RP_BQ; ++r) {
      const int i = q0 + r;
      if (i < S) {
        const float s = si[(long long)i * half + dp], c = ci[(long long)i * half + dp];
        w[(long long)i * D + dp] = rot_first(zs[r], zc[r], s, c);
        w[(long long)i * D + dp + half] = rot_second(zs[r], zc[r], s, c);
      }
    }
  }
}

constexpr int SG_BM = 128;  // C tile: 128 x 128, 8 x 8 a thread
constexpr int SG_BK = 8;
constexpr int SG_THREADS = 256;

// C [M, N] = A [M, K] B [N, K]^T in fp32, each C value one fma chain over k
// in order (as the FMA loop it replaces). Batched over blockIdx.z: A and C
// advance by a_batch and c_batch elements, B is shared. K % 8 == 0. Tiles
// of A and B go through registers into shared memory transposed ([k][row]),
// double-buffered; thread (ty, tx) takes rows {4 ty, 64 + 4 ty} + 0..3 and
// columns {4 tx, 64 + 4 tx} + 0..3.
__global__ void __launch_bounds__(SG_THREADS) sgemm_nt_kernel(const float* A, const float* B,
                                                              float* C, int M, int N, int K,
                                                              long long a_batch,
                                                              long long c_batch) {
  __shared__ __align__(16) float As[2][SG_BK][SG_BM];
  __shared__ __align__(16) float Bs[2][SG_BK][SG_BM];
  A += blockIdx.z * a_batch;
  C += blockIdx.z * c_batch;
  const int m0 = blockIdx.y * SG_BM, n0 = blockIdx.x * SG_BM, tid = threadIdx.x;
  const int lr = tid >> 1, lk = (tid & 1) * 4;  // the float4 this thread loads
  const bool a_in = m0 + lr < M, b_in = n0 + lr < N;
  const float* ap = A + (long long)(a_in ? m0 + lr : 0) * K + lk;
  const float* bp = B + (long long)(b_in ? n0 + lr : 0) * K + lk;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto stage = [&](int buf, float4 x, float4 y) {
    As[buf][lk][lr] = x.x; As[buf][lk + 1][lr] = x.y; As[buf][lk + 2][lr] = x.z; As[buf][lk + 3][lr] = x.w;
    Bs[buf][lk][lr] = y.x; Bs[buf][lk + 1][lr] = y.y; Bs[buf][lk + 2][lr] = y.z; Bs[buf][lk + 3][lr] = y.w;
  };
  float4 ra = a_in ? __ldg(reinterpret_cast<const float4*>(ap)) : zero;
  float4 rb = b_in ? __ldg(reinterpret_cast<const float4*>(bp)) : zero;
  stage(0, ra, rb);
  __syncthreads();
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += SG_BK) {
    const int cur = (k0 / SG_BK) & 1;
    const bool more = k0 + SG_BK < K;
    if (more) {
      ra = a_in ? __ldg(reinterpret_cast<const float4*>(ap + k0 + SG_BK)) : zero;
      rb = b_in ? __ldg(reinterpret_cast<const float4*>(bp + k0 + SG_BK)) : zero;
    }
#pragma unroll
    for (int kk = 0; kk < SG_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) stage(cur ^ 1, ra, rb);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n < N) C[(long long)m * N + n] = acc[i][j];
    }
  }
}

// -- v2 in bf16: the tensor-core kernel ---------------------------------------------

constexpr int RT_BQ = 64;                 // query rows of a block: 4 row groups of 16
constexpr int RT_C = 2;                   // blocks of a cluster: consecutive row blocks of a head
constexpr int RT_KT = 128;                // keys of a tile
constexpr int RT_ITEM = RT_KT * 128;      // one ring slot: 128 keys x 128 bytes (64 bf16)
constexpr int RT_SLICE = RT_ITEM / RT_C;  // the part of a slot each block of the cluster loads
constexpr int RT_ST = 4;                  // ring slots
constexpr int RT_THREADS = RP_THREADS + 32;  // 8 consumer warps + the producer warp

__host__ __device__ inline int rt_keys(int S) { return (S + RT_KT - 1) / RT_KT * RT_KT; }

static size_t rt_smem(int S, int D) {
  return (size_t)RT_ST * RT_ITEM + sizeof(bf16) * RT_BQ * (size_t)D +
         sizeof(float2) * 2 * RT_BQ + sizeof(float) * rt_keys(S) + 2 * RT_ST * sizeof(uint64_t) +
         1024;
}

// Row `row` (0..127), 16-byte chunk `chunk` (0..7) of a ring slot, where
// TMA's 128-byte swizzle put it.
__device__ __forceinline__ const void* rt_at(const unsigned char* slot, int row, int chunk) {
  return slot + row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Element (row, col) of w [64, D] in shared memory, laid out for wgmma's A
// operand as TMA lays out a K-major tile: column blocks of 64 (64 rows x
// 128 bytes, 8 KB apart), the 16-byte chunks of a row swizzled by row % 8.
__device__ __forceinline__ bf16* rt_w_at(bf16* Ws, int row, int col) {
  return Ws + (col >> 6) * (RT_BQ * 64) + row * 64 + ((((col >> 3) & 7) ^ (row & 7)) << 3) +
         (col & 7);
}

__device__ __forceinline__ void consumer_sync() {  // the 8 consumer warps only
  asm volatile("bar.sync 1, %0;\n" :: "n"(RP_THREADS) : "memory");
}

// exp(m - n) for a running maximum m that may still be -inf.
__device__ __forceinline__ float rescale(float m, float n) {
  return m == -INFINITY ? 0.f : expf(m - n);
}

// One block of 8 consumer warps and a producer warp per (batch, head, 64
// query rows); warp (rg, kh) takes rows 16 rg .. 16 rg + 15 and keys
// 64 kh .. 64 kh + 63 of every 128-key tile. Pass 1 computes the scores,
// stores them in the workspace (a.work, 32 KB a block per 128 keys) and
// keeps each row's max and sum of exponentials; pass 2 reads them back,
// forms P = exp(s - max) / sum rounded to bf16 in registers (the A fragments
// of P V) and multiplies V. The basis, K and V stream through a ring of 16 KB slots (128 keys x 64
// columns, TMA with the 128-byte swizzle, read with ldmatrix); each block of
// a cluster loads its share of a tile, multicast into both blocks' slots. A
// slot is refilled when all 16 consumer warps of the cluster released it.
template <int DH>
__global__ void __cluster_dims__(RT_C, 1, 1) __launch_bounds__(RT_THREADS, 1)
    relpos_v2_rt_kernel(const __grid_constant__ CUtensorMap map_basis,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, RelposArgs a) {
  extern __shared__ unsigned char rt_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(rt_raw) + 1023) & ~(uintptr_t)1023);
  const int S = a.S, D = a.D, half = D / 2;
  bf16* Ws = reinterpret_cast<bf16*>(ring + RT_ST * RT_ITEM);  // w, [64, D] (rt_w_at)
  float2* stats = reinterpret_cast<float2*>(Ws + RT_BQ * D);   // [2 key halves][64] (max, sum)
  float* kbs = reinterpret_cast<float*>(stats + 2 * RT_BQ);      // key bias; -inf past S
  uint64_t* full = reinterpret_cast<uint64_t*>(kbs + rt_keys(S));
  uint64_t* empty = full + RT_ST;

  const int q0 = blockIdx.x * RT_BQ, h = blockIdx.y, b = blockIdx.z + a.b0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < RT_ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, RP_WARPS * RT_C);
    }
    mbar_fence_init();
  }
  cluster_sync();  // every block's barriers are set before any multicast lands

  if (warp == RP_WARPS) {
    // The producer: the tiles in the order the consumers take them. Pass 1,
    // per 128 keys: D / 64 basis tiles and DH / 64 K tiles; pass 2: DH / 64
    // V tiles. Keys past S are TMA's zero fill.
    if (lane == 0) {
      const int rank = (int)cluster_rank();
      int item = 0;
      auto issue = [&](const CUtensorMap* map, int col, int key0, int c2, int c3) {
        const int s = item % RT_ST;
        if (item >= RT_ST) mbar_wait(empty + s, (item / RT_ST - 1) & 1);
        mbar_expect_tx(full + s, RT_ITEM);
        tma_load_4d_multicast(ring + s * RT_ITEM + rank * RT_SLICE, map, full + s, col,
                              key0 + rank * (RT_KT / RT_C), c2, c3, (1 << RT_C) - 1);
        ++item;
      };
      for (int j0 = 0; j0 < S; j0 += RT_KT) {
        for (int c = 0; c < D; c += 64) issue(&map_basis, c, j0, 0, 0);
        for (int e = 0; e < DH; e += 64) issue(&map_k, e, j0, h, b);
      }
      for (int j0 = 0; j0 < S; j0 += RT_KT)
        for (int e = 0; e < DH; e += 64) issue(&map_v, e, j0, h, b);
    }
  } else {
    const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3;
    const int rg = warp & 3, kh = warp >> 2;
    const int r_lo = q0 + 16 * rg + g, r_hi = r_lo + 8;  // this thread's query rows
    const bf16* qb = reinterpret_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* ub = reinterpret_cast<const bf16*>(a.u) + h * DH;
    const bf16* vbb = reinterpret_cast<const bf16*>(a.vb) + h * DH;
    const float* kbias = a.key_bias ? a.key_bias + (long long)b * S : nullptr;
    int item = 0;
    auto take = [&](int& s) {  // wait for the next tile; its slot index in s
      s = item % RT_ST;
      mbar_wait(full + s, (item / RT_ST) & 1);
      ++item;
      return ring + s * RT_ITEM;
    };
    auto release = [&](int s) {  // lane r tells block r of the cluster
      __syncwarp();
      if (lane < RT_C) mbar_arrive_cluster(empty + s, lane);
    };
    // Columns d, d + 1 of (q + bias) in row i, rounded to bf16 as the TPU
    // kernel rounds them (rows past S read as 0), as one bf16x2 register.
    auto qpair = [&](int i, int d, const bf16* bias) {
      const float x0 = i < S ? to_float(qb[(long long)i * a.q_ss + d]) : 0.f;
      const float x1 = i < S ? to_float(qb[(long long)i * a.q_ss + d + 1]) : 0.f;
      return bf16x2_bits(__fadd_rn(x0, to_float(bias[d])), __fadd_rn(x1, to_float(bias[d + 1])));
    };

    for (int j = tid; j < rt_keys(S); j += RP_THREADS)
      kbs[j] = j >= S ? -INFINITY : kbias ? kbias[j] : 0.f;

    // -- w = rotate(qv Wr_h^T), [64, D], into shared memory ------------------
    {
      const bf16* wr = reinterpret_cast<const bf16*>(a.wr) + (long long)h * D * DH;
      const bf16* si = reinterpret_cast<const bf16*>(a.si);
      const bf16* ci = reinterpret_cast<const bf16*>(a.ci);
      uint4 alo[DH / 32], ahi[DH / 32];
#pragma unroll
      for (int c = 0; c < DH / 32; ++c) {
        const int d = 32 * c + 8 * t4;
        alo[c] = make_uint4(qpair(r_lo, d, vbb), qpair(r_lo, d + 2, vbb), qpair(r_lo, d + 4, vbb),
                            qpair(r_lo, d + 6, vbb));
        ahi[c] = make_uint4(qpair(r_hi, d, vbb), qpair(r_hi, d + 2, vbb), qpair(r_hi, d + 4, vbb),
                            qpair(r_hi, d + 6, vbb));
      }
      // Tiles of 8 columns, paired with the tile half a row further so that
      // z_s and z_c of one column meet in one thread's accumulators.
#pragma unroll 4
      for (int p = kh; p < half / 8; p += 2) {
        float zs[4] = {0.f, 0.f, 0.f, 0.f}, zc[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* w1 = wr + (long long)(p * 8 + g) * DH + 8 * t4;
        const bf16* w2 = w1 + (long long)half * DH;
#pragma unroll
        for (int c = 0; c < DH / 32; ++c) {
          mma_k32(zs, alo[c], ahi[c], ldg16(w1 + 32 * c));
          mma_k32(zc, alo[c], ahi[c], ldg16(w2 + 32 * c));
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = 16 * rg + g + 8 * rr, i = q0 + row, col = p * 8 + 2 * t4;
          float s0 = 0.f, s1 = 0.f, c0 = 0.f, c1 = 0.f;
          if (i < S) {
            s0 = to_float(si[(long long)i * half + col]);
            s1 = to_float(si[(long long)i * half + col + 1]);
            c0 = to_float(ci[(long long)i * half + col]);
            c1 = to_float(ci[(long long)i * half + col + 1]);
          }
          const int e = 2 * rr;
          *reinterpret_cast<uint32_t*>(rt_w_at(Ws, row, col)) = bf16x2_bits(
              rot_first(zs[e], zc[e], s0, c0), rot_first(zs[e + 1], zc[e + 1], s1, c1));
          *reinterpret_cast<uint32_t*>(rt_w_at(Ws, row, col + half)) = bf16x2_bits(
              rot_second(zs[e], zc[e], s0, c0), rot_second(zs[e + 1], zc[e + 1], s1, c1));
        }
      }
      fence_proxy_async();  // w is read by wgmma
    }
    // (q + u) as the A fragments of ac, k = head dim.
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int d = 16 * kk + 2 * t4;
      qa[kk][0] = qpair(r_lo, d, ub);
      qa[kk][1] = qpair(r_hi, d, ub);
      qa[kk][2] = qpair(r_lo, d + 8, ub);
      qa[kk][3] = qpair(r_hi, d + 8, ub);
    }
    consumer_sync();

    // -- the scores of one key tile, on wgmma: warpgroup kh multiplies all 64
    // rows by its 64 keys. bd = w . basis_j (both from shared memory) and
    // ac = (q + u) . k_j (q + u from registers), each in its own fp32
    // accumulator, then (ac + bd) * scale + key bias (-inf past S).
    // acc[nt][e]: row 16 rg + g + 8 (e / 2), key j0 + 64 kh + 8 nt + 2 t4 + e % 2.
    const uint32_t w_base = smem_u32(Ws);
    auto scores = [&](int j0, float (&acc)[8][4]) {
      int prev = -1;
      auto consume = [&](int s) {  // this tile's products issued: free the one before
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0) release(prev);
        prev = s;
      };
      for (int c = 0; c < D; c += 64) {
        int s;
        const unsigned char* slot = take(s);
        const uint32_t b_base = smem_u32(slot) + kh * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_m64n64k16_ss(acc, wgmma_desc_sw128(w_base + c * RT_BQ * 2 + kk * 32),
                                  wgmma_desc_sw128(b_base + kk * 32), c > 0 || kk > 0);
        consume(s);
      }
      float ac[8][4];
#pragma unroll
      for (int e = 0; e < DH / 64; ++e) {
        int s;
        const unsigned char* slot = take(s);
        const uint32_t b_base = smem_u32(slot) + kh * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_m64n64k16_rs(ac, qa[4 * e + kk], wgmma_desc_sw128(b_base + kk * 32),
                                  e > 0 || kk > 0);
        consume(s);
      }
      wgmma_wait<0>();
      release(prev);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 kb = *reinterpret_cast<const float2*>(kbs + j0 + 64 * kh + 8 * nt + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nt][e] = score_of(ac[nt][e], acc[nt][e], a.scale, e & 1 ? kb.y : kb.x);
      }
    };

    // This thread's scores in the workspace: per 128-key tile, float4 nt of
    // lane `lane` of warp `warp` (its acc[nt]), written and read by it alone.
    const long long blk = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    float4* mine = reinterpret_cast<float4*>(a.work) +
                   (blk * (rt_keys(S) / RT_KT) * RP_WARPS + warp) * 8 * 32 + lane;
    auto tile_at = [&](int j0) { return mine + (j0 / RT_KT) * RP_WARPS * 8 * 32; };

    // -- pass 1: the scores, stored; each row's max and sum of exp(s - max),
    // online ------------------------------------------------------------------
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
    for (int j0 = 0; j0 < S; j0 += RT_KT) {
      float acc[8][4];
      scores(j0, acc);
      float4* st = tile_at(j0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        __stcg(st + nt * 32, make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float n = m[rr];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) n = fmaxf(n, fmaxf(acc[nt][2 * rr], acc[nt][2 * rr + 1]));
        float sum = l[rr] * rescale(m[rr], n);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          sum += expf(acc[nt][2 * rr] - n) + expf(acc[nt][2 * rr + 1] - n);
        m[rr] = n;
        l[rr] = sum;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // the quad's four lanes hold other keys of the row
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[rr], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[rr], o);
        const float n = fmaxf(m[rr], mo);
        l[rr] = l[rr] * rescale(m[rr], n) + lo * rescale(mo, n);
        m[rr] = n;
      }
      if (t4 == 0) stats[kh * RT_BQ + 16 * rg + g + 8 * rr] = make_float2(m[rr], l[rr]);
    }
    consumer_sync();
    float rl[2];  // 1 / sum, correctly rounded (tc_normalise divides with it)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // both key halves: the row's max and sum
      const float2 s0 = stats[16 * rg + g + 8 * rr], s1 = stats[RT_BQ + 16 * rg + g + 8 * rr];
      m[rr] = fmaxf(s0.x, s1.x);
      l[rr] = s0.y * rescale(s0.x, m[rr]) + s1.y * rescale(s1.x, m[rr]);
      rl[rr] = __frcp_rn(l[rr]);
    }

    // -- pass 2: the scores read back; P = exp(s - max) / sum, true division,
    // rounded to bf16; P V in fp32 over this warp's keys. The scores are read
    // at the top of the iteration (reading the next tile's ahead, while this
    // one's P V runs, gains no speed). ------------------------------------------
    float o[DH / 8][4];
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    for (int j0 = 0; j0 < S; j0 += RT_KT) {
      float acc[8][4];
      const float4* ld = tile_at(j0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 x = __ldcg(ld + nt * 32);
        acc[nt][0] = x.x; acc[nt][1] = x.y; acc[nt][2] = x.z; acc[nt][3] = x.w;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = expf(acc[nt][e] - m[e >> 1]);
      tc_normalise(acc, l, rl);  // as __fdiv_rn rounds, bit for bit
      uint32_t pa[4][4];  // k16 step kk: keys 16 kk .. of this warp's 64
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hl = 0; hl < 2; ++hl)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float* c = acc[2 * kk + hl] + 2 * rr;
            pa[kk][2 * hl + rr] = bf16x2_bits(c[0], c[1]);
          }
#pragma unroll
      for (int e = 0; e < DH / 64; ++e) {
        int s;
        const unsigned char* slot = take(s);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int np = 0; np < 4; ++np) {  // V's B fragments: keys along k, ldmatrix.trans
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, rt_at(slot, 64 * kh + 16 * kk + (mat & 1) * 8 + (lane & 7),
                                        2 * np + (mat >> 1)));
            mma_bf16(o[8 * e + 2 * np], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3], vf[0], vf[1]);
            mma_bf16(o[8 * e + 2 * np + 1], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3], vf[2],
                     vf[3]);
          }
        release(s);
      }
    }

    // -- the two key halves' sums, then the output rounded to bf16 -------------
    consumer_sync();  // every tile has landed and been read: the ring is free
    float* part = reinterpret_cast<float*>(ring);  // [64 rows][DH], key half 1
    const int row_lo = 16 * rg + g;
    if (kh == 1) {
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(row_lo + 8 * (e >> 1)) * DH + 8 * nt + 2 * t4 + (e & 1)] = o[nt][e];
    }
    consumer_sync();
    if (kh == 0) {
      bf16* ob = reinterpret_cast<bf16*>(a.out) + ((long long)b * a.H + h) * S * DH;
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = row_lo + 8 * rr, i = q0 + row, col = 8 * nt + 2 * t4;
          if (i < S)
            *reinterpret_cast<uint32_t*>(ob + (long long)i * DH + col) =
                bf16x2_bits(__fadd_rn(o[nt][2 * rr], part[row * DH + col]),
                            __fadd_rn(o[nt][2 * rr + 1], part[row * DH + col + 1]));
        }
    }
  }
  cluster_sync();  // no block leaves while its peer may still write to it
}

// The tile maps of the basis [S, D] and of K, V [B, H, S, Dh] (any strides
// that are multiples of 8), boxes of 64 columns x RT_KT / RT_C rows.
static bool rt_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                   uint64_t heads, uint64_t batch, long long ss, long long sh, long long sb) {
  const uint64_t dims[4] = {cols, rows, heads, batch};
  const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {64, RT_KT / RT_C, 1, 1};
  return tma_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, dims, strides, box);
}

// Workspace bytes of one batch row of a v2 launch: in bf16 the scores of
// its blocks, in fp32 w [H, S, D] and bd [H, S, S].
static long long v2_work_per_batch(int H, int S, int D, int kind) {
  if (kind == KIND_BF16) {
    const long long blocks_x = ((S + RT_BQ - 1) / RT_BQ + RT_C - 1) / RT_C * RT_C;
    return blocks_x * H * (rt_keys(S) / RT_KT) * (long long)(RP_WARPS * 8 * 32 * sizeof(float4));
  }
  return (long long)H * S * (D + S) * (long long)sizeof(float);
}

// The batch in chunks whose workspace fits in work_bytes: launch(a, rows)
// for each, a.b0 its first batch row.
template <typename F>
static cudaError_t by_chunks(RelposArgs a, int B, long long work_bytes, int kind, F launch) {
  const long long fit = work_bytes / v2_work_per_batch(a.H, a.S, a.D, kind);
  if (fit < 1) return cudaErrorInvalidValue;
  const int chunk = (int)(fit < B ? fit : B);
  for (a.b0 = 0; a.b0 < B; a.b0 += chunk) {
    const cudaError_t err = launch(a, chunk < B - a.b0 ? chunk : B - a.b0);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int DH>
static cudaError_t launch_relpos_v2_rt(const RelposArgs& args, int B, long long work_bytes,
                                       cudaStream_t stream) {
  const size_t smem = rt_smem(args.S, args.D);
  if (smem > RP_MAX_SMEM) return cudaErrorInvalidValue;
  const long long plane = (long long)args.S * args.D;
  CUtensorMap mb, mk, mv;
  if (!rt_map(&mb, args.basis, args.D, args.S, 1, 1, args.D, plane, plane) ||
      !rt_map(&mk, args.k, DH, args.S, args.H, B, args.k_ss, args.k_sh, args.k_sb) ||
      !rt_map(&mv, args.v, DH, args.S, args.H, B, args.v_ss, args.v_sh, args.v_sb))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(relpos_v2_rt_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  const int row_blocks = (args.S + RT_BQ - 1) / RT_BQ;
  return by_chunks(args, B, work_bytes, KIND_BF16, [&](const RelposArgs& a, int rows) {
    dim3 grid((row_blocks + RT_C - 1) / RT_C * RT_C, a.H, rows);
    relpos_v2_rt_kernel<DH><<<grid, RT_THREADS, smem, stream>>>(mb, mk, mv, a);
    return cudaGetLastError();
  });
}

template <int DH>
static cudaError_t launch_relpos_v2_f32(const RelposArgs& args, int B, long long work_bytes,
                                        cudaStream_t stream) {
  const size_t smem = rp_smem_bytes(args.S, DH);
  if (smem > RP_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(relpos_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  return by_chunks(args, B, work_bytes, KIND_F32, [&](RelposArgs a, int rows) {
    const int S = a.S, row_blocks = (S + RP_BQ - 1) / RP_BQ, tiles = (S + SG_BM - 1) / SG_BM;
    float* bd = a.work + (long long)rows * a.H * S * a.D;
    relpos_w_kernel<DH><<<dim3(row_blocks, a.H, rows), RP_THREADS, 0, stream>>>(a);
    sgemm_nt_kernel<<<dim3(tiles, tiles, rows * a.H), SG_THREADS, 0, stream>>>(
        a.work, reinterpret_cast<const float*>(a.basis), bd, S, S, a.D, (long long)S * a.D,
        (long long)S * S);
    a.bd = bd;
    relpos_kernel<DH><<<dim3(row_blocks, a.H, rows), RP_THREADS, smem, stream>>>(a);
    return cudaGetLastError();
  });
}

template <int DH>
static cudaError_t launch_relpos_v1_f32(const RelposArgs& a, int B, cudaStream_t stream) {
  const size_t smem = rp_smem_bytes(a.S, DH);
  if (smem > RP_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(relpos_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + RP_BQ - 1) / RP_BQ, a.H, B);
  relpos_kernel<DH><<<grid, RP_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// 32 query rows a block where their scores fit in shared memory beside a
// ring of 3 slots, or 2 (S up to ~1400: two blocks an SM at S 499, which
// measured faster than one of 64 rows and than three of 16), else 16; 16
// rows beside 1 slot at the longest S (up to 3392).
template <int DH, int BQ>
static cudaError_t launch_relpos_v1_tc(const RelposArgs& a, int B, int stages,
                                       cudaStream_t stream) {
  const size_t smem = v1_smem(a.S, DH, BQ, stages);
  cudaError_t err = allow_dynamic_smem(relpos_v1_tc_kernel<DH, BQ>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, B);
  relpos_v1_tc_kernel<DH, BQ><<<grid, BQ * 8, smem, stream>>>(a, stages);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_relpos_v1_bf16(const RelposArgs& a, int B, cudaStream_t stream) {
  int bq = 0, stages = 0;
  for (int r = 32; r >= 16 && !bq; r /= 2)
    for (int st = 3; st >= 2 && !bq; --st)
      if (v1_smem(a.S, DH, r, st) <= RP_MAX_SMEM) bq = r, stages = st;
  if (!bq && v1_smem(a.S, DH, 16, 1) <= RP_MAX_SMEM) bq = 16, stages = 1;
  if (bq == 32) return launch_relpos_v1_tc<DH, 32>(a, B, stages, stream);
  if (bq == 16) return launch_relpos_v1_tc<DH, 16>(a, B, stages, stream);
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

extern "C" int sonar_relpos_v2_workspace(int H, int S, int D, int kind, long long* per_batch) {
  if (H < 1 || S < 1 || D < 64) return cudaErrorInvalidValue;
  *per_batch = v2_work_per_batch(H, S, D, kind);
  return cudaSuccess;
}

extern "C" int sonar_relpos_flash_v2(const void* q, const void* k, const void* v,
                                     const void* wr, const void* si, const void* ci,
                                     const void* basis, const void* u, const void* vb,
                                     const float* key_bias, void* out, float* work,
                                     long long work_bytes, int B, int H, int S, int Dh, int D,
                                     long long q_sb, long long q_sh, long long q_ss,
                                     long long k_sb, long long k_sh, long long k_ss,
                                     long long v_sb, long long v_sh, long long v_ss, int kind,
                                     void* stream) {
  RelposArgs a = relpos_args(q, k, v, u, key_bias, out, H, S, Dh, q_sb, q_sh, q_ss, k_sb, k_sh,
                             k_ss, v_sb, v_sh, v_ss);
  a.wr = wr; a.si = si; a.ci = ci; a.basis = basis; a.vb = vb;
  a.D = D;
  a.work = work;
  const cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || D < 64 || D % 64 != 0 || work == nullptr) return cudaErrorInvalidValue;
  if (kind == KIND_BF16) {
    if (Dh == 64) return launch_relpos_v2_rt<64>(a, B, work_bytes, st);
    if (Dh == 128) return launch_relpos_v2_rt<128>(a, B, work_bytes, st);
  } else {
    if (Dh == 64) return launch_relpos_v2_f32<64>(a, B, work_bytes, st);
    if (Dh == 128) return launch_relpos_v2_f32<128>(a, B, work_bytes, st);
  }
  return cudaErrorInvalidValue;
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (S < 1) return cudaErrorInvalidValue;
  if (kind == KIND_BF16) {
    if (Dh == 64) return launch_relpos_v1_bf16<64>(a, B, st);
    if (Dh == 128) return launch_relpos_v1_bf16<128>(a, B, st);
  } else {
    if (Dh == 64) return launch_relpos_v1_f32<64>(a, B, st);
    if (Dh == 128) return launch_relpos_v1_f32<128>(a, B, st);
  }
  return cudaErrorInvalidValue;
}
