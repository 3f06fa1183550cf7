// Conformer relative-position attention (Transformer-XL scoring) for Hopper.
//
// Replaces the TPU kernels of sonar_tpu/ops/pallas/relpos_flash.py:
//   sonar_relpos_flash_v2 <- relpos_flash_attention_v2 (_kernel_v2), the
//     Conformer's path: the positional term bd is built inside the kernel
//     (the TPU kernel from the trig-factored form: z = (q + v_bias) Wr_h^T,
//     an i-rotation into w, and bd = w . basis_j);
//   sonar_relpos_flash_v1 <- relpos_flash_attention (_kernel): the same
//     attention tail with bd read from a precomputed [B, H, S, S] tensor.
// score_j = (ac_j + bd_j) * scale + key_bias_j, fp32 softmax with a true
// division, P rounded to the value dtype, P V accumulated in fp32. v2 rounds
// q + u and q + v_bias to the model dtype, v1 keeps q + u in fp32.
//
// v2 in bf16, the Conformer's path: two launches, both named with the prefix
// relpos_v2_rt_kernel. bd is computed in the rel-shift form, bd[i, j] =
// (q_i + v_bias) . P[i - j], on the projected distance table P[m] = T[m] Wr_h
// (T[m] the model's sinusoid of distance m in Wr_h's de-interleaved column
// order), where the trig form costs 2 D flops a logit (16 times QK^T's at
// D 1024, Dh 64) and the TPU kernel's workspace.
//   - relpos_v2_rt_kernel_table: P [H, 2S - 1 (+ 128 zero rows before),
//     Dh] for the distances -(S - 1) .. S - 1, built from the si / ci tables
//     (reflected for m < 0: sin is odd, cos even), on mma.sync with fp32
//     accumulators, stored in bf16 (8 MB at S 2000, H 16, Dh 64: it stays in
//     L2). 2 (2S + 127) D Dh H flops a launch: against the attention's, 9%
//     at [16, 16, 199, 64], 1% at S 1999.
//   - relpos_v2_rt_kernel: a block takes 64 query rows of one (batch, head);
//     per 128-key tile each warpgroup takes 64 keys: ac = (q + u) . K^T and
//     the window product (q + v) . P_win^T over the 127 distances its 64 x
//     64 block spans (128 table rows, m = q0 - j0 - 63 + w), both on wgmma
//     into fp32 (A operands from shared memory); each warp writes the window
//     columns its 16 rows reach to shared memory and reads bd[r, c] =
//     win[r, r - c + 63] back along the skew. Two passes over the keys, as
//     attention.cuh's tc_attn_two_pass: pass 1 keeps each row's max and sum
//     of exponentials, pass 2 computes the scores again and forms P =
//     exp(s - max) / sum with the true division, rounded to bf16 in
//     registers, then P V on mma.sync. Scores never leave the chip: no
//     workspace. K and V tiles (128 keys x 64 columns) and the table's 192
//     rows of a tile (64 columns) come by TMA into a ring of 24 KB slots
//     filled by a producer warpgroup (registers handed to the consumers by
//     setmaxnreg); the two blocks of a cluster (consecutive row blocks of
//     one head) load half of each K and V tile each, multicast into both,
//     and each loads its own table rows. The next tile's products are
//     issued before this tile's softmax work. The grid is persistent (as
//     many clusters as the card holds, each walking its share of the (batch,
//     head, row pair) units), so a unit's loads start while the unit before
//     ends. Keys past S carry -inf; table rows past its ends are TMA's zero
//     fill and the zero rows before it, so every index stays in the table.
//   What bounds it (measured, PERF.md §6): not the tensor work (7 products
//   of 64 x 64 x Dh a 64 x 64 block of logits: ac 2, the window 4 over the
//   two passes, P V 1, against the rel-shift algorithm's 3) nor one part of
//   the softmax work: taken away one at a time, the window product, the
//   skew, either pass's exponentials or the division each save 5-18%; the
//   consumer warps (two a scheduler) wait in turn on each step's latency.
//   The shared-memory base is aligned by an offset from the shared array:
//   aligned through an integer, the compiler lost the address space and the
//   skew's loads and stores became generic ones (10% slower).
//   Rounding: q + u, q + v_bias, P (the softmax's) and the output are
//   rounded to bf16 where the TPU kernel rounds them; the TPU kernel's
//   rounding of w [S, D] to bf16 is replaced by the rounding of the
//   projected table P to bf16. In PyTorch on the CPU (``relpos_bd_shift_
//   plain`` against the trig form's plain version, random inputs at [3, 2,
//   130 | 257 | 499, 64 | 128] with a fully masked row): min row cosine
//   0.999980, max-abs 0.0039-0.0056 of the output's scale; against fp64,
//   cosine 0.999975-0.999984 where the trig form reads 0.999980-0.999986;
//   bd's largest error over its scale 0.0028-0.0032, the trig form's
//   0.0031-0.0033. On the card, the kernel against the trig form's plain
//   version at [16, 16, 199 | 999 | 1999, 64], D 1024: min row cosine
//   0.99996. The row sum of exp(s - max) is an online sum (each tile's
//   share, rescaled when the row's running max grows, the two key halves'
//   shares combined) where the TPU kernel sums the whole row under its
//   final max: it may differ in its last bits.
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
  const void* basis;  // v2 in fp32: [S, D] = [cos(j w) | sin(j w)]
  const void* bd;     // v1: [B, H, S, S]
  const void* u;      // [H, Dh] u_bias
  const void* vb;     // v2: [H, Dh] v_bias
  const float* key_bias;  // [B, S] additive, or null
  void* out;          // [B, H, S, Dh] contiguous
  float* work;        // v2 in fp32: the workspace of one launch (w, then bd)
  void* table;        // v2 in bf16: the distance table [H, rt_table_rows(S), Dh]
  int B, H, S, D;     // B: v2 in bf16, the batch
  int b0;             // fp32 v2: the launch's first batch row: blockIdx.z + b0 is the batch
  float scale;
};

__host__ __device__ inline int rp_score_ld(int S) {
  return ((S + RP_KT - 1) / RP_KT) * RP_KT + RP_SPAD;
}

static size_t rp_smem_bytes(int S, int Dh) {
  return sizeof(float) * RP_BQ * ((size_t)rp_score_ld(S) + Dh + RP_QPAD);  // scores, q + u
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

// -- v2 in bf16: the distance table, then the tensor-core kernel --------------------

constexpr int RT_PAD = 128;   // zero rows before the table's first distance, -(S - 1)
constexpr int TB_ROWS = 64;   // table rows of a block of relpos_v2_rt_kernel_table
constexpr int TB_PITCH = 72;  // bf16 of a staged table row (64 values): 144 bytes

// Rows of the distance table [H, rows, Dh]: RT_PAD rows of zeros, then the
// distances -(S - 1) .. S - 1 in order.
__host__ __device__ inline int rt_table_rows(int S) { return 2 * S - 1 + RT_PAD; }

// P[h, p, :] = T[m] Wr_h for the distance m = p - RT_PAD - (S - 1), with
// T[m] = [sin(m w) | cos(m w)] (the de-interleaved column order of Wr_h)
// built from the i-rotation tables: si and ci at |m|, the sines negated for
// m < 0; rows of no distance are zeros. One block of 4 warps takes 64 rows of
// one head, warp w rows 16 w .. 16 w + 15: per 64 columns of D it stages T's
// and Wr_h's rows in shared memory (the next 64 loaded into registers
// meanwhile) and multiplies on mma.sync, fp32 accumulators, rounded to bf16
// once at the end.
template <int DH>
__global__ void __launch_bounds__(128) relpos_v2_rt_kernel_table(RelposArgs a) {
  constexpr int BP = DH + 8;        // bf16 of a staged Wr_h row: 144 or 272 bytes
  constexpr int NB = DH / 16;       // 16-byte chunks of Wr_h a thread stages
  __shared__ __align__(16) bf16 As[TB_ROWS * TB_PITCH];  // T: [row][64 columns of D]
  __shared__ __align__(16) bf16 Bs[64 * BP];             // Wr_h: [64 columns of D][DH]
  const int S = a.S, D = a.D, half = D / 2, rows = rt_table_rows(S);
  const int p0 = blockIdx.x * TB_ROWS, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const bf16* si = reinterpret_cast<const bf16*>(a.si);
  const bf16* ci = reinterpret_cast<const bf16*>(a.ci);
  const bf16* wr = reinterpret_cast<const bf16*>(a.wr) + (long long)h * D * DH;

  uint4 ra[4], rb[NB];  // this thread's chunks of the next 64 columns
  auto load = [&](int d0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // T: 64 rows x 8 chunks
      const int e = tid + 128 * i, row = e >> 3, d = d0 + 8 * (e & 7);
      const int m = p0 + row - RT_PAD - (S - 1), am = m < 0 ? -m : m;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (am < S) {
        if (d < half) {
          x = ldg16(si + (long long)am * half + d);
          if (m < 0) {  // sin(-x) = -sin(x): the sign bits, exactly
            x.x ^= 0x80008000u; x.y ^= 0x80008000u; x.z ^= 0x80008000u; x.w ^= 0x80008000u;
          }
        } else {
          x = ldg16(ci + (long long)am * half + d - half);
        }
      }
      ra[i] = x;
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {  // Wr_h: 64 rows x DH / 8 chunks
      const int e = tid + 128 * i, row = e / (DH / 8), ch = e % (DH / 8);
      rb[i] = ldg16(wr + (long long)(d0 + row) * DH + 8 * ch);
    }
  };

  float acc[DH / 8][4];
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // ldmatrix rows: lanes 0-7 rows 0-7, 8-15 rows 8-15 (A: of the warp's rows;
  // B: along k), 16-31 the same at 8 columns further.
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  load(0);
  for (int d0 = 0; d0 < D; d0 += 64) {
    __syncthreads();  // every warp is done with the last chunk
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + 128 * i;
      *reinterpret_cast<uint4*>(As + (e >> 3) * TB_PITCH + 8 * (e & 7)) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = tid + 128 * i;
      *reinterpret_cast<uint4*>(Bs + (e / (DH / 8)) * BP + 8 * (e % (DH / 8))) = rb[i];
    }
    __syncthreads();
    if (d0 + 64 < D) load(d0 + 64);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, As + (16 * warp + lr) * TB_PITCH + 16 * kk + lc);
#pragma unroll
      for (int n = 0; n < DH / 16; ++n) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, Bs + (16 * kk + lr) * BP + 16 * n + lc);
        mma_bf16(acc[2 * n], af[0], af[1], af[2], af[3], bf[0], bf[1]);
        mma_bf16(acc[2 * n + 1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
      }
    }
  }
  bf16* out = reinterpret_cast<bf16*>(a.table) + (long long)h * rows * DH;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int p = p0 + 16 * warp + g + 8 * rr;
    if (p < rows) {
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt)
        *reinterpret_cast<uint32_t*>(out + (long long)p * DH + 8 * nt + 2 * t4) =
            bf16x2_bits(acc[nt][2 * rr], acc[nt][2 * rr + 1]);
    }
  }
}

constexpr int RT_BQ = 64;                 // query rows of a block: 4 row groups of 16
constexpr int RT_C = 2;                   // blocks of a cluster: consecutive row blocks of a head
constexpr int RT_KT = 128;                // keys of a tile
constexpr int RT_KV = RT_KT * 128;        // a K or V item: 128 keys x 128 bytes (64 bf16)
constexpr int RT_SLICE = RT_KV / RT_C;    // the part of a K or V item each block of the cluster loads
constexpr int RT_SLOT = (RT_KT + RT_BQ) * 128;  // a ring slot: a table item, 192 distances x 128 bytes
constexpr int RT_TBOX = 64;               // rows of a table item's TMA box
constexpr int RT_WLD = 88;                // floats of a staged window row (80 used)
constexpr int RT_THREADS = RP_THREADS + 128;  // 8 consumer warps + the producer's warpgroup
constexpr int RT_PRODUCER_REGS = 40;      // registers a thread: the producer's warpgroup
constexpr int RT_CONSUMER_REGS = 232;     // and the consumers' (2 x 128 x 232 + 128 x 40 <= 64 K)

// Ring slots: the consumers hold the next tile's table and K items (2 DH /
// 64) while they take this tile's V items one by one, and a V item's slot
// must be one that an earlier tile freed (at Dh 128 five slots deadlock).
constexpr int RT_ST = 6;

static size_t rt_smem(int DH) {
  return (size_t)RT_ST * RT_SLOT + 2 * sizeof(bf16) * RT_BQ * (size_t)DH +
         sizeof(float) * RP_WARPS * 16 * RT_WLD + sizeof(float2) * 2 * RT_BQ +
         2 * RT_ST * sizeof(uint64_t) + 1024;
}

// Row `row` (0..127), 16-byte chunk `chunk` (0..7) of a ring slot, where
// TMA's 128-byte swizzle put it.
__device__ __forceinline__ const void* rt_at(const unsigned char* slot, int row, int chunk) {
  return slot + row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Element (row, col) of a [64, n] bf16 tile in shared memory, laid out for
// wgmma's A operand as TMA lays out a K-major tile: column blocks of 64 (64
// rows x 128 bytes, 8 KB apart), the 16-byte chunks of a row swizzled by
// row % 8.
__device__ __forceinline__ bf16* rt_a_at(bf16* A, int row, int col) {
  return A + (col >> 6) * (RT_BQ * 64) + row * 64 + ((((col >> 3) & 7) ^ (row & 7)) << 3) +
         (col & 7);
}

// Eight bf16 values plus eight, each sum in fp32 rounded to bf16.
__device__ __forceinline__ uint4 rt_add8(uint4 x, uint4 y) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(&x);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(&y);
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 u = *reinterpret_cast<const __nv_bfloat162*>(a + i);
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(b + i);
    r[i] = bf16x2_bits(__fadd_rn(to_float(u.x), to_float(v.x)),
                       __fadd_rn(to_float(u.y), to_float(v.y)));
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void consumer_sync() {  // the 8 consumer warps only
  asm volatile("bar.sync 1, %0;\n" :: "n"(RP_THREADS) : "memory");
}

// The registers a thread of this warpgroup may hold, lowered or raised
// (every warp of the warpgroup executes it).
template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// exp(m - n) for a running maximum m that may still be -inf.
__device__ __forceinline__ float rescale(float m, float n) {
  return m == -INFINITY ? 0.f : expf(m - n);
}

// A persistent grid of clusters, as many as the card holds at once; cluster
// c takes the work units c, c + clusters, ...: a unit is two consecutive
// 64-row blocks of one (batch, head), one to each block of the cluster
// (block `rank` takes query rows q0 = 64 (2 pair + rank) ..). In a block 8
// consumer warps and a producer warpgroup (one thread of which loads); warp
// (rg, kh) takes rows 16 rg .. 16 rg + 15 and keys 64 kh .. 64 kh + 63 of
// every 128-key tile j0. Each pass over the keys computes the scores of a
// tile: ac = (q + u) . k_j, and the window product of (q + v_bias) with the
// 127 table rows its warpgroup's keys reach, whose skew gives bd; the next
// tile's products are issued (wgmma is asynchronous) before this tile's
// softmax work. Pass 1 keeps each row's max and sum of exponentials; pass 2
// computes the scores again, forms P = exp(s - max) / sum rounded to bf16 in
// registers (the A fragments of P V) and multiplies V. Tiles stream through
// a ring of 24 KB slots (TMA, 128-byte swizzle), from one unit into the
// next: K and V (128 keys x 64 columns) loaded half by each block of the
// cluster and multicast into both; the table's 192 rows m = q0 - j0 - 127
// .. q0 - j0 + 64 (64 columns), which differ between the blocks, loaded by
// each block alone. A slot is refilled when all 16 consumer warps of the
// cluster released it.
template <int DH>
__global__ void __cluster_dims__(RT_C, 1, 1) __launch_bounds__(RT_THREADS, 1)
    relpos_v2_rt_kernel(const __grid_constant__ CUtensorMap map_table,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, RelposArgs a) {
  constexpr int ST = RT_ST, CB = DH / 64;  // CB: 64-column items of a tile
  extern __shared__ unsigned char rt_raw[];
  // 1024-byte aligned for the swizzled tiles; an offset from the shared
  // array (not an integer round trip), so every pointer below is known to
  // be shared memory and compiles to shared loads and stores.
  unsigned char* ring = rt_raw + ((1024 - (smem_u32(rt_raw) & 1023)) & 1023);
  const int S = a.S;
  bf16* Qv = reinterpret_cast<bf16*>(ring + ST * RT_SLOT);  // q + v_bias [64, DH] (rt_a_at)
  bf16* Qu = Qv + RT_BQ * DH;                                // q + u [64, DH]
  // [8 warps][16][RT_WLD]: the staged windows; at a unit's end the second
  // key half's output partials [64][DH]
  float* windows = reinterpret_cast<float*>(Qu + RT_BQ * DH);
  float2* stats = reinterpret_cast<float2*>(windows + RP_WARPS * 16 * RT_WLD);  // [2][64] (max, sum)
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * RT_BQ);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster_rank(), clusters = gridDim.x / RT_C;
  const int pairs = (S + RT_C * RT_BQ - 1) / (RT_C * RT_BQ), units = a.B * a.H * pairs;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, RP_WARPS * RT_C);
    }
    mbar_fence_init();
  }
  cluster_sync();  // every block's barriers are set before any multicast lands

  if (warp >= RP_WARPS) {
    regs_dec<RT_PRODUCER_REGS>();
    // The producer: the tiles in the order the consumers take them. A unit's
    // pass 1, per 128 keys: CB table items, CB K items. Pass 2: tile 0's
    // table and K items, then per tile the next tile's table and K items and
    // this tile's V items. Rows past the table and keys past S are TMA's
    // zero fill.
    if (warp == RP_WARPS && lane == 0) {
      int item = 0;
      auto slot_of = [&](uint32_t bytes) {  // the next slot, free, expecting `bytes`
        const int s = item % ST;
        if (item >= ST) mbar_wait(empty + s, (item / ST - 1) & 1);
        mbar_expect_tx(full + s, bytes);
        ++item;
        return s;
      };
      for (int u = blockIdx.x / RT_C; u < units; u += clusters) {
        const int pair = u % pairs, h = (u / pairs) % a.H, b = u / (pairs * a.H);
        const int q0 = (RT_C * pair + rank) * RT_BQ;
        auto table_tile = [&](int j0) {  // m = q0 - j0 - 127 ..
          const int row0 = q0 - j0 - (RT_KT - 1) + (S - 1) + RT_PAD;
          for (int c = 0; c < DH; c += 64) {
            const int s = slot_of(RT_SLOT);
            for (int r = 0; r < RT_KT + RT_BQ; r += RT_TBOX)
              tma_load_4d(ring + s * RT_SLOT + r * 128, &map_table, full + s, c, row0 + r, h, 0);
          }
        };
        auto keys_tile = [&](const CUtensorMap* map, int j0) {
          for (int e = 0; e < DH; e += 64) {
            const int s = slot_of(RT_KV);
            tma_load_4d_multicast(ring + s * RT_SLOT + rank * RT_SLICE, map, full + s, e,
                                  j0 + rank * (RT_KT / RT_C), h, b, (1 << RT_C) - 1);
          }
        };
        for (int j0 = 0; j0 < S; j0 += RT_KT) {
          table_tile(j0);
          keys_tile(&map_k, j0);
        }
        table_tile(0);
        keys_tile(&map_k, 0);
        for (int j0 = 0; j0 < S; j0 += RT_KT) {
          if (j0 + RT_KT < S) {
            table_tile(j0 + RT_KT);
            keys_tile(&map_k, j0 + RT_KT);
          }
          keys_tile(&map_v, j0);
        }
      }
    }
  } else {
    regs_inc<RT_CONSUMER_REGS>();
    const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3;
    const int rg = warp & 3, kh = warp >> 2;
    int item = 0;
    auto take = [&](int& s) {  // wait for the next tile; its slot index in s
      s = item % ST;
      mbar_wait(full + s, (item / ST) & 1);
      ++item;
      return ring + s * RT_SLOT;
    };
    auto release = [&](int s) {  // lane r tells block r of the cluster
      __syncwarp();
      if (lane < RT_C) mbar_arrive_cluster(empty + s, lane);
    };
    const uint32_t qv_base = smem_u32(Qv), qu_base = smem_u32(Qu);
    float* stage = windows + warp * 16 * RT_WLD;

    for (int u = blockIdx.x / RT_C; u < units; u += clusters) {
      const int pair = u % pairs, h = (u / pairs) % a.H, b = u / (pairs * a.H);
      const int q0 = (RT_C * pair + rank) * RT_BQ;
      const float* kbias = a.key_bias ? a.key_bias + (long long)b * S : nullptr;

      // q + u and q + v_bias, [64, DH] each, rounded to bf16 as the TPU
      // kernel rounds them (rows past S read as 0), into shared memory: the
      // A operands of ac and of the window product. (The unit before read
      // them last before its final consumer_sync.)
      {
        const bf16* qb = reinterpret_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
        const bf16* ub = reinterpret_cast<const bf16*>(a.u) + h * DH;
        const bf16* vbb = reinterpret_cast<const bf16*>(a.vb) + h * DH;
#pragma unroll
        for (int i = 0; i < RT_BQ * DH / 8 / RP_THREADS; ++i) {
          const int e = tid + i * RP_THREADS, row = e / (DH / 8), col = 8 * (e % (DH / 8));
          const int qi = q0 + row;
          const uint4 x =
              qi < S ? ldg16(qb + (long long)qi * a.q_ss + col) : make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(rt_a_at(Qu, row, col)) = rt_add8(x, ldg16(ub + col));
          *reinterpret_cast<uint4*>(rt_a_at(Qv, row, col)) = rt_add8(x, ldg16(vbb + col));
        }
      }
      fence_proxy_async();  // read by wgmma
      consumer_sync();

      // -- the products of one key tile, issued: warpgroup kh multiplies all
      // 64 rows by the 128 table rows m = q0 - (j0 + 64 kh) - 63 + w, w <
      // 128, into `win` (window column w of row r is bd of key 63 + r - w of
      // its 64), and by its 64 keys into `ac`. The slots stay held until
      // `land`.
      float win[16][4], ac[8][4];
      float kb[8][2];  // the issued tile's key bias at this thread's keys; -inf past S
      int held[2 * CB];
      auto issue = [&](int j0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 64 * kh + 8 * nt + 2 * t4 + e;
            kb[nt][e] = j >= S ? -INFINITY : kbias ? __ldg(kbias + j) : 0.f;
          }
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const unsigned char* slot = take(held[c]);
          const uint32_t b_base = smem_u32(slot) + (1 - kh) * RT_BQ * 128;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16_m64n128k16_ss_kmajor(
                win, wgmma_desc_sw128(qv_base + c * RT_BQ * 128 + kk * 32),
                wgmma_desc_sw128(b_base + kk * 32), c > 0 || kk > 0);
        }
#pragma unroll
        for (int e = 0; e < CB; ++e) {
          const unsigned char* slot = take(held[CB + e]);
          const uint32_t b_base = smem_u32(slot) + kh * 64 * 128;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_bf16_m64n64k16_ss(ac, wgmma_desc_sw128(qu_base + e * RT_BQ * 128 + kk * 32),
                                    wgmma_desc_sw128(b_base + kk * 32), e > 0 || kk > 0);
        }
        wgmma_commit();
      };
      // -- the issued tile's products landed, its slots released, and its
      // scores into sc: each warp stages the 79 window columns its 16 rows
      // reach (16 rg .. 16 rg + 78) in shared memory and reads bd[r][c] =
      // win[r][r - c + 63] back along the skew; then (ac + bd) * scale + key
      // bias (-inf past S).
      // sc[nt][e]: row 16 rg + g + 8 (e / 2), key j0 + 64 kh + 8 nt + 2 t4 + e % 2.
      auto land = [&](float (&sc)[8][4]) {
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 2 * CB; ++i) release(held[i]);
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          if (nt >= 2 * rg && nt < 2 * rg + 10) {
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              *reinterpret_cast<float2*>(stage + (g + 8 * rr) * RT_WLD + 8 * nt - 16 * rg +
                                         2 * t4) = make_float2(win[nt][2 * rr], win[nt][2 * rr + 1]);
          }
        }
        __syncwarp();
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + 8 * (e >> 1), c = 8 * nt + 2 * t4 + (e & 1);
            sc[nt][e] = score_of(ac[nt][e], stage[r * RT_WLD + r - c + 63], a.scale, kb[nt][e & 1]);
          }
        __syncwarp();  // the stage is read before the next tile writes it
      };

      // -- pass 1: each row's max and sum of exp(s - max), online -------------
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
      issue(0);
      for (int j0 = 0; j0 < S; j0 += RT_KT) {
        float sc[8][4];
        land(sc);
        if (j0 + RT_KT < S) issue(j0 + RT_KT);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float n = m[rr];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) n = fmaxf(n, fmaxf(sc[nt][2 * rr], sc[nt][2 * rr + 1]));
          float sum = l[rr] * rescale(m[rr], n);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            sum += expf(sc[nt][2 * rr] - n) + expf(sc[nt][2 * rr + 1] - n);
          m[rr] = n;
          l[rr] = sum;
        }
      }
      issue(0);  // pass 2's first tile, while the rows' statistics are combined
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

      // -- pass 2: the scores again; P = exp(s - max) / sum, true division,
      // rounded to bf16; P V in fp32 over this warp's keys -------------------
      float o[DH / 8][4];
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
      for (int j0 = 0; j0 < S; j0 += RT_KT) {
        float sc[8][4];
        land(sc);
        if (j0 + RT_KT < S) issue(j0 + RT_KT);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = expf(sc[nt][e] - m[e >> 1]);
        tc_normalise(sc, l, rl);  // as __fdiv_rn rounds, bit for bit
        uint32_t pa[4][4];  // k16 step kk: keys 16 kk .. of this warp's 64
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hl = 0; hl < 2; ++hl)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const float* c = sc[2 * kk + hl] + 2 * rr;
              pa[kk][2 * hl + rr] = bf16x2_bits(c[0], c[1]);
            }
#pragma unroll
        for (int e = 0; e < CB; ++e) {
          int s;
          const unsigned char* slot = take(s);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int np = 0; np < 4; ++np) {  // V's B fragments: keys along k, ldmatrix.trans
              uint32_t vf[4];
              ldmatrix_x4_trans(vf, rt_at(slot, 64 * kh + 16 * kk + (mat & 1) * 8 + (lane & 7),
                                          2 * np + (mat >> 1)));
              mma_bf16(o[8 * e + 2 * np], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3], vf[0],
                       vf[1]);
              mma_bf16(o[8 * e + 2 * np + 1], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3], vf[2],
                       vf[3]);
            }
          release(s);
        }
      }

      // -- the two key halves' sums, then the output rounded to bf16 -----------
      consumer_sync();  // every warp is done with its stage
      float* part = windows;  // [64 rows][DH], key half 1
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
  }
  cluster_sync();  // no block leaves while its peer may still write to it
}

// A tile map of [batch, heads, rows, cols] bf16 (any strides that are
// multiples of 8), boxes of 64 columns x box_rows rows.
static bool rt_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                   uint64_t heads, uint64_t batch, long long ss, long long sh, long long sb,
                   uint32_t box_rows) {
  const uint64_t dims[4] = {cols, rows, heads, batch};
  const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {64, box_rows, 1, 1};
  return tma_map(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, dims, strides, box);
}

// Workspace bytes of one batch row of an fp32 v2 launch: w [H, S, D] and
// bd [H, S, S].
static long long v2_work_per_batch(int H, int S, int D) {
  return (long long)H * S * (D + S) * (long long)sizeof(float);
}

// The batch in chunks whose workspace fits in work_bytes: launch(a, rows)
// for each, a.b0 its first batch row.
template <typename F>
static cudaError_t by_chunks(RelposArgs a, int B, long long work_bytes, F launch) {
  const long long fit = work_bytes / v2_work_per_batch(a.H, a.S, a.D);
  if (fit < 1) return cudaErrorInvalidValue;
  const int chunk = (int)(fit < B ? fit : B);
  for (a.b0 = 0; a.b0 < B; a.b0 += chunk) {
    const cudaError_t err = launch(a, chunk < B - a.b0 ? chunk : B - a.b0);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The table (table_bytes at a.table, at least [H, rt_table_rows(S), DH]),
// then the attention over the whole batch in one launch.
template <int DH>
static cudaError_t launch_relpos_v2_rt(const RelposArgs& a, int B, long long table_bytes,
                                       cudaStream_t stream) {
  const size_t smem = rt_smem(DH);
  const int rows = rt_table_rows(a.S);
  const long long plane = (long long)rows * DH;
  if (smem > RP_MAX_SMEM || table_bytes < a.H * plane * (long long)sizeof(bf16))
    return cudaErrorInvalidValue;
  CUtensorMap mt, mk, mv;
  if (!rt_map(&mt, a.table, DH, rows, a.H, 1, DH, plane, plane * a.H, RT_TBOX) ||
      !rt_map(&mk, a.k, DH, a.S, a.H, B, a.k_ss, a.k_sh, a.k_sb, RT_KT / RT_C) ||
      !rt_map(&mv, a.v, DH, a.S, a.H, B, a.v_ss, a.v_sh, a.v_sb, RT_KT / RT_C))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(relpos_v2_rt_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  // As many clusters as the card holds at once (asked once a process), or
  // as many as there are units.
  static int resident = 0;
  if (resident == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(RT_C, 1, 1);
    cfg.blockDim = dim3(RT_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    err = cudaOccupancyMaxActiveClusters(&resident, relpos_v2_rt_kernel<DH>, &cfg);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  relpos_v2_rt_kernel_table<DH><<<dim3((rows + TB_ROWS - 1) / TB_ROWS, a.H), 128, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long units = (long long)B * a.H * ((a.S + RT_C * RT_BQ - 1) / (RT_C * RT_BQ));
  RelposArgs args = a;
  args.B = B;
  dim3 grid(RT_C * (int)(units < resident ? units : resident), 1, 1);
  relpos_v2_rt_kernel<DH><<<grid, RT_THREADS, smem, stream>>>(mt, mk, mv, args);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_relpos_v2_f32(const RelposArgs& args, int B, long long work_bytes,
                                        cudaStream_t stream) {
  const size_t smem = rp_smem_bytes(args.S, DH);
  if (smem > RP_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = allow_dynamic_smem(relpos_kernel<DH>, smem);
  if (err != cudaSuccess) return err;
  return by_chunks(args, B, work_bytes, [&](RelposArgs a, int rows) {
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

// fp32 v2's workspace bytes a batch row (bf16 v2 takes none: kind must be 0).
extern "C" int sonar_relpos_v2_workspace(int H, int S, int D, int kind, long long* per_batch) {
  if (H < 1 || S < 1 || D < 64 || kind != KIND_F32) return cudaErrorInvalidValue;
  *per_batch = v2_work_per_batch(H, S, D);
  return cudaSuccess;
}

// `scratch` (scratch_bytes): in fp32 the workspace, in bf16 the distance
// table [H, rt_table_rows(S), Dh], both written by the launch.
extern "C" int sonar_relpos_flash_v2(const void* q, const void* k, const void* v,
                                     const void* wr, const void* si, const void* ci,
                                     const void* basis, const void* u, const void* vb,
                                     const float* key_bias, void* out, void* scratch,
                                     long long scratch_bytes, int B, int H, int S, int Dh, int D,
                                     long long q_sb, long long q_sh, long long q_ss,
                                     long long k_sb, long long k_sh, long long k_ss,
                                     long long v_sb, long long v_sh, long long v_ss, int kind,
                                     void* stream) {
  RelposArgs a = relpos_args(q, k, v, u, key_bias, out, H, S, Dh, q_sb, q_sh, q_ss, k_sb, k_sh,
                             k_ss, v_sb, v_sh, v_ss);
  a.wr = wr; a.si = si; a.ci = ci; a.basis = basis; a.vb = vb;
  a.D = D;
  const cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || D < 64 || D % 64 != 0 || scratch == nullptr) return cudaErrorInvalidValue;
  if (kind == KIND_BF16) {
    a.table = scratch;
    if (Dh == 64) return launch_relpos_v2_rt<64>(a, B, scratch_bytes, st);
    if (Dh == 128) return launch_relpos_v2_rt<128>(a, B, scratch_bytes, st);
  } else {
    a.work = static_cast<float*>(scratch);
    if (Dh == 64) return launch_relpos_v2_f32<64>(a, B, scratch_bytes, st);
    if (Dh == 128) return launch_relpos_v2_f32<128>(a, B, scratch_bytes, st);
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
