// Fused attention over [B, H, S, Dh] for SONAR-length sequences.
//
// Replaces the TPU kernel sonar_tpu/ops/pallas/flash.py
// (pallas_flash_attention): QK^T, a head-independent additive bias (key
// padding [B, 1, 1, Skv] or full [B, 1, Sq, Skv]), fp32 softmax with P
// normalised and then rounded to the value dtype, P @ V in fp32. Dh 64 or
// 128, S up to the encoder's 514 rows.
//
// What bounds it on the H100: the TPU kernel held one (batch, head)'s whole
// K/V in VMEM. Here K and V at S = 512, Dh = 128 in fp32 take 512 KB, more
// than a block's 227 KB of shared memory, so keys stream through in
// 64-row tiles and the softmax takes two passes (attention.cuh): the
// [S, S] logits never reach device memory, and P is rounded exactly where
// the TPU kernel rounds it. The kernel is limited by shared-memory
// bandwidth of its fp32 FMA loops; the tensor cores are unused so far.
#include "attention.cuh"

extern "C" int sonar_flash_attention(const void* q, const void* k, const void* v,
                                     const float* bias, int bias_mode, void* out, int B, int H,
                                     int Sq, int Skv, int Dh, long long q_sb, long long q_sh,
                                     long long q_ss, long long k_sb, long long k_sh,
                                     long long k_ss, long long v_sb, long long v_sh,
                                     long long v_ss, int kind, void* stream) {
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.bias = bias;
  a.bias_mode = bias ? bias_mode : BIAS_NONE;
  a.bias_sb = bias_mode == BIAS_FULL ? (long long)Sq * Skv : Skv;
  a.bias_sq = bias_mode == BIAS_FULL ? Skv : 0;
  a.out = out;  // contiguous [B, H, Sq, Dh]
  a.o_sb = (long long)H * Sq * Dh;
  a.o_sh = (long long)Sq * Dh;
  a.o_ss = Dh;
  a.Sq = Sq;
  a.Skv = Skv;
  a.dh = Dh;
  a.scale = (float)(1.0 / sqrt((double)Dh));
  cudaStream_t st = (cudaStream_t)stream;
  return kind == KIND_BF16 ? launch_attention<__nv_bfloat16, __nv_bfloat16>(a, B, H, st)
                           : launch_attention<float, float>(a, B, H, st);
}
