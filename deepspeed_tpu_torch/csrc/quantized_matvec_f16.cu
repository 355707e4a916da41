// Weight-only int8/int4 matvec, fp16: the C entry, for fp16 serving over
// packed weights (quantize_bits 8 or 4 with dtype float16). The Pallas kernel
// (deepspeed_tpu/ops/pallas/quantized_matmul.py:_kernel, line 38) writes y in
// x's dtype (lines 85, 104). The same kernel as the bf16 form
// (quantized_matvec.cuh) with x and y __half: .f32.f16.f16 products, the
// bytes made fp16 by the magic 1024 (0x6400), y rounded to nearest fp16
// (+-inf past 65504).
#include "quantized_matvec.cuh"

// As dst_quantized_expert_matvec with x and out fp16 (dtype: x's code, fp16).
extern "C" int dst_quantized_expert_matvec_f16(int E, const void* x, const void* q,
                                               const void* s, void* out, void* part,
                                               int M, int D, int N, int Gp, int Bq,
                                               int nibbles, int splits, int per,
                                               int dtype, void* stream) {
  (void)part;
  if (dtype != dst::kFloat16) return static_cast<int>(cudaErrorInvalidValue);
  return matvec_entry<__half>(E, x, q, s, out, M, D, N, Gp, Bq, nibbles, splits, per,
                              static_cast<cudaStream_t>(stream));
}
