// Pre-LN int8 self-attention residual block: x + O(attn(QKV(LN(x)))).
//
// Replaces the TPU kernel sonar_tpu/ops/pallas/attn_block.py
// (fused_attn_block). The TPU kernel kept the int8 weights ([D, 3D] and
// [D, D], 4 MB) resident in VMEM and ran the whole block in one grid step
// per group of sequences. Hopper's shared memory cannot hold them, so this
// is a short sequence of the port's own launches that keeps the TPU
// kernel's quantisation points:
//   1. LayerNorm (fp32 statistics) + per-row int8 quantisation;
//   2. int8 GEMM with the QKV weights, dequantised, + bias, rounded to bf16
//      (as the TPU kernel does, also for an fp32 model);
//   3. per-(sequence, head) softmax attention on the bf16 QKV, P rounded
//      to bf16, output kept in fp32 (attention.cuh: the tensor-core core,
//      one pass at S <= 128; past that the two-pass kernel of flash.cu,
//      64-key tiles read from the fused QKV rows, fp32 stored into merged
//      heads);
//   4. per-row requantisation of the fp32 attention output;
//   5. int8 GEMM with the output weights, dequantised, + bias, added to x
//      in fp32 and rounded to x.dtype.
// The TPU kernel's block-diagonal mask (several sequences flattened into one
// row block for the MXU) is not needed: attention here is per sequence,
// which computes the same for every sequence of length >= 1.
// What bounds it: the QKV and output GEMMs (4 x 17 GOP at M = 8192,
// D = 1024) on the tensor cores; the bf16 QKV and fp32 attention
// intermediates cross device memory once each.
#include "attention.cuh"
#include "int8_gemm.cuh"

// The longest S whose attention step is the one-pass core: past it, #5's
// two-pass kernel (the wrapper counts that launch on flash's counter).
extern "C" int sonar_attn_one_pass_max(int* s_max) {
  *s_max = TC_ONE_PASS_MAX;
  return 0;
}

extern "C" int sonar_fused_attn_block(const void* x, int x_kind, int B, int S, int H, int Dh,
                                      const float* bias, const float* ln_w, const float* ln_b,
                                      const int8_t* wqkv, const float* sqkv, const float* bqkv,
                                      const int8_t* wo, const float* so, const float* bo,
                                      int8_t* hq, float* hs, void* qkv, float* attn, int8_t* aq,
                                      float* as, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M = B * S, D = H * Dh;
  cudaError_t err =
      x_kind == KIND_BF16
          ? launch_row_quant((const __nv_bfloat16*)x, M, D, D, ln_w, ln_b, hq, hs, st)
          : launch_row_quant((const float*)x, M, D, D, ln_w, ln_b, hq, hs, st);
  if (err != cudaSuccess) return err;

  const GemmArgs proj{hq, wqkv, M, 3 * D, D, D, hs, sqkv, bqkv, nullptr, qkv};
  err = launch_gemm_s8<EPI_BIAS, __nv_bfloat16>(proj, st);
  if (err != cudaSuccess) return err;

  const AttnArgs a = fused_qkv_args(qkv, sizeof(__nv_bfloat16), bias, attn, S, H, Dh);
  err = launch_attention<__nv_bfloat16, float>(a, B, H, st);
  if (err != cudaSuccess) return err;

  err = launch_row_quant((const float*)attn, M, D, D, nullptr, nullptr, aq, as, st);
  if (err != cudaSuccess) return err;

  const GemmArgs outp{aq, wo, M, D, D, D, as, so, bo, x, out};
  return x_kind == KIND_BF16 ? launch_gemm_s8<EPI_RESIDUAL, __nv_bfloat16>(outp, st)
                             : launch_gemm_s8<EPI_RESIDUAL, float>(outp, st);
}
