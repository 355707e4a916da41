// RMSNorm forward, fp16: x and weight __half (the pairs the fp16 model
// passes), computed in fp32 and written in fp16, rounded to nearest (+-inf
// past 65504, never clamped). The Pallas kernel (rmsnorm.py:23) is
// dtype-generic; fp16 training with the dynamic loss scaler runs it on fp16
// rows. The design is norm_fwd.cuh's with T = W = __half, in its own
// translation unit, compiled beside the bf16 one.
#include "norm_fwd.cuh"

// x, out: [rows, D] fp16 contiguous, 16-byte aligned, D a multiple of 8;
// w: fp16 [D], 16-byte aligned.
extern "C" int dst_rmsnorm_fwd_f16(const void* x, const void* w, void* out, int rows,
                                   int D, float eps, void* stream) {
  return dst::norm::forward<false, __half, __half>(x, w, nullptr, out, rows, D, eps,
                                                   static_cast<cudaStream_t>(stream));
}
