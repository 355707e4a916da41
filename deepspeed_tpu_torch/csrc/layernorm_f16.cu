// LayerNorm forward, fp16: x, scale and bias __half (the pairs the fp16 GPT-2
// and BLOOM models pass), computed in fp32 and written in fp16, rounded to
// nearest (+-inf past 65504, never clamped). The Pallas kernel
// (layernorm.py:25) is dtype-generic; fp16 training with the dynamic loss
// scaler runs it on fp16 rows. The design is norm_fwd.cuh's with T = W =
// __half, in its own translation unit, compiled beside the bf16 one.
#include "norm_fwd.cuh"

// x, out: [rows, D] fp16 contiguous, 16-byte aligned, D a multiple of 8;
// w (scale), b (bias): fp16 [D], 16-byte aligned.
extern "C" int dst_layernorm_fwd_f16(const void* x, const void* w, const void* b, void* out,
                                     int rows, int D, float eps, void* stream) {
  return dst::norm::forward<true, __half, __half>(x, w, b, out, rows, D, eps,
                                                  static_cast<cudaStream_t>(stream));
}
