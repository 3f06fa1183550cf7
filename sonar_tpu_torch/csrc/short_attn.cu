// Short-sequence self-attention read straight from the fused QKV projection.
//
// Replaces the TPU kernel sonar_tpu/ops/pallas/short_attn.py
// (short_qkv_attention): per-sequence multi-head attention on
// qkv [B, S, 3 * H * Dh] with an additive fp32 key bias [B, S], fp32 logits
// and softmax, P rounded to the input dtype, P @ V accumulated in fp32,
// merged heads [B, S, H * Dh] out (in the input dtype, or fp32 on request).
//
// What bounds it on the H100: at sentence lengths (S 8..128, Dh 64) the
// attention FLOPs are small next to the projections around it; what the
// TPU kernel saved was the head-split transposes and the fp32 logits in
// device memory. This kernel does the same: each block reads its head's
// q/k/v slices from the fused layout with strides, keeps logits and
// probabilities in shared memory (attention.cuh) and writes merged heads,
// so device memory sees only qkv in and the output out. Its limit is then
// the shared-memory bandwidth of the fp32 FMA loops.
#include "attention.cuh"

extern "C" int sonar_short_qkv_attention(const void* qkv, const float* bias, void* out, int B,
                                         int S, int H, int Dh, int in_kind, int out_kind,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t elem = in_kind == KIND_BF16 ? 2 : 4;
  const AttnArgs a = fused_qkv_args(qkv, elem, bias, out, S, H, Dh);
  if (in_kind == KIND_BF16) {
    return out_kind == KIND_BF16 ? launch_attention<__nv_bfloat16, __nv_bfloat16>(a, B, H, st)
                                 : launch_attention<__nv_bfloat16, float>(a, B, H, st);
  }
  return out_kind == KIND_BF16 ? launch_attention<float, __nv_bfloat16>(a, B, H, st)
                               : launch_attention<float, float>(a, B, H, st);
}

extern "C" const char* sonar_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
