// Int8 feed-forward block: [LN ->] quant -> x @ W1 -> +b1, ReLU -> requant
// per (row, split) -> @ W2 -> split outputs rounded to x.dtype and summed
// -> +b2.
//
// Replaces the TPU kernel sonar_tpu/ops/pallas/ffn.py (fused_int8_ffn and
// fused_int8_ffn_ln, body _ffn_half_kernel). The TPU kernel kept an int8
// W1-half + W2-half (8 MB) resident in VMEM and the [rows, F] inner
// activation on chip. Hopper's 227 KB of shared memory holds neither, so
// this version is four launches on the shared int8 blocks (int8_gemm.cuh):
//   1. row quantisation of x (with the LayerNorm folded in when asked);
//   2. int8 GEMM x_q @ W1 with a scale + bias + ReLU epilogue into an fp32
//      scratch buffer h [M, F] in device memory;
//   3. per-(row, split) requantisation of h: the second scale covers a
//      whole split of F / n_splits columns, so it needs all of them before
//      any is quantised;
//   4. int8 GEMM h_q @ W2 that folds each split's int32 sum into its own
//      dequantised, x.dtype-rounded partial, sums the partials in x.dtype
//      and adds b2.
// What bounds it: the two GEMMs (2 x 137 GOP at M = 8192, D = 1024,
// F = 8192) on the tensor cores, then the fp32 h: M x F x 4 bytes written
// by step 2 and read by step 3 (with h_q, ~0.2 ms of device memory at that
// shape). Both GEMMs run on the wgmma + TMA core of int8_gemm.cuh; h stays
// fp32, since the second quantisation rounds fp32 h / s (storing h in bf16
// would move values across int8 levels). Step 2's epilogue runs with two
// blocks on an SM, so its h stores overlap the other block's products.
#include "int8_gemm.cuh"

extern "C" int sonar_fused_int8_ffn(const void* x, int x_kind, int M, int D, int F, int n_splits,
                                    const float* ln_w, const float* ln_b, const int8_t* w1,
                                    const float* s1, const float* b1, const int8_t* w2,
                                    const float* s2, const float* b2, int8_t* xq, float* xs,
                                    float* h, int8_t* hq, float* hs, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_splits < 1 || F % n_splits) return cudaErrorInvalidValue;
  cudaError_t err =
      x_kind == KIND_BF16
          ? launch_row_quant((const __nv_bfloat16*)x, M, D, D, ln_w, ln_b, xq, xs, st)
          : launch_row_quant((const float*)x, M, D, D, ln_w, ln_b, xq, xs, st);
  if (err != cudaSuccess) return err;

  const GemmArgs up{xq, w1, M, F, D, D, xs, s1, b1, nullptr, h};
  err = launch_gemm_s8<EPI_BIAS_RELU, float>(up, st);
  if (err != cudaSuccess) return err;

  err = launch_row_quant((const float*)h, M, F, F / n_splits, nullptr, nullptr, hq, hs, st);
  if (err != cudaSuccess) return err;

  const GemmArgs down{hq, w2, M, D, F, F / n_splits, hs, s2, b2, nullptr, out};
  return x_kind == KIND_BF16 ? launch_gemm_s8<EPI_SPLIT_SUM, __nv_bfloat16>(down, st)
                             : launch_gemm_s8<EPI_SPLIT_SUM, float>(down, st);
}
