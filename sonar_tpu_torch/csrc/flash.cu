// Fused attention over [B, H, S, Dh] for SONAR-length sequences.
//
// Replaces the TPU kernel sonar_tpu/ops/pallas/flash.py
// (pallas_flash_attention): QK^T, a head-independent additive bias (key
// padding [B, 1, 1, Skv] or full [B, 1, Sq, Skv]), fp32 softmax with P
// normalised and then rounded to the value dtype, P @ V in fp32. Dh 64 or
// 128, S up to the encoder's 514 rows.
//
// What bounds it on the H100: the TPU kernel held one (batch, head)'s whole
// K/V in VMEM and ran QK^T and P @ V on the MXU. Here device memory sees
// q, k, v and the output once (the [S, S] logits never leave the chip), so
// the limit is the work on chip: the tensor-core products and the softmax's
// expf, true division and rounding per logit. In bf16 (attention.cuh,
// tc_attn_two_pass) a block of 4 warps x 16 query rows runs both products
// on mma.sync with Q in registers and P kept in the accumulators; K and V
// stream through shared memory in 64-key tiles (cp.async, double-buffered).
// Keys past 128 do not fit a warp's registers as fp32 logits, so the softmax
// takes two passes and recomputes QK^T in the second, where P is
// normalised and rounded exactly where the TPU kernel rounds it. At S <= 128
// (a full bias from S 128) the one-pass kernel takes the call. fp32 inputs
// keep the FMA core.
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
