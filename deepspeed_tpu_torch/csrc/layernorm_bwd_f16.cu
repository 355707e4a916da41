// LayerNorm backward, fp16: dx, dscale and dbias for fp16 x, g and weight (the
// __half pairs the fp16 GPT-2 and BLOOM models pass: models/transformer.py's
// _norm on the layer slice cast to fp16), dx written in fp16, dscale and dbias
// in fp32; the bf16 kernels' design (layernorm_bwd.cuh) and sum order with T =
// W = __half. The Pallas kernel (layernorm.py:37) is dtype-generic; fp16
// training with the dynamic loss scaler runs it on fp16 rows. dx rounds to
// nearest: +-inf past 65504, never clamped, so a scaled gradient's overflow
// reaches the loss scaler. Its own translation unit, compiled beside the bf16
// one.
#include "layernorm_bwd.cuh"

// x, g, dx: [rows, D] fp16 contiguous, 16-byte aligned, D a multiple of 8 and
// at most 8192; w: fp16 [D]; part, dscale and dbias as for dst_layernorm_bwd
// (its nblocks with the fp16 dtype code).
extern "C" int dst_layernorm_bwd_f16(const void* x, const void* w, const void* g, void* dx,
                                     void* part, void* dscale, void* dbias, int rows, int D,
                                     float eps, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  return launch<__half, __half>(x, w, g, dx, part, dscale, dbias, rows, D, eps,
                                static_cast<cudaStream_t>(stream));
}
