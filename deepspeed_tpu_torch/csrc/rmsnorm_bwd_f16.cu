// RMSNorm backward, fp16: dx and dscale for fp16 x, g and weight (the
// __half pairs the fp16 model passes), dx written in fp16, dscale in fp32;
// the bf16 kernels' design (rmsnorm_bwd.cuh) and sum order with T = W =
// __half. The Pallas kernel (rmsnorm.py:30) is dtype-generic; fp16 training
// with the dynamic loss scaler runs it on fp16 rows. dx rounds to nearest:
// +-inf past 65504, never clamped, so a scaled gradient's overflow reaches
// the loss scaler. Its own translation unit, compiled beside the bf16 one.
#include "rmsnorm_bwd.cuh"

// x, g, dx: [rows, D] fp16 contiguous, 16-byte aligned, D a multiple of 8
// and at most 16384; w: fp16 [D], 16-byte aligned; part and dscale as for
// dst_rmsnorm_bwd (its nblocks with the fp16 dtype code).
extern "C" int dst_rmsnorm_bwd_f16(const void* x, const void* w, const void* g, void* dx,
                                   void* part, void* dscale, int rows, int D, float eps,
                                   void* stream) {
  return launch<__half, __half>(x, w, g, dx, part, dscale, rows, D, eps,
                                static_cast<cudaStream_t>(stream));
}
