// LayerNorm forward: out = (x - mean) * rsqrt(var + eps) * scale + bias over
// the last dim, computed in fp32 and written in x's dtype.
//
// Replaces deepspeed_tpu/ops/pallas/layernorm.py:_fwd_kernel (line 25),
// reached through _run_fwd (line 65) from layernorm (line 112).
//
// As the TPU kernel does (layernorm.py:26-30), the mean comes first and the
// variance is the mean of (x - mean)^2, from the row held in registers.
//
// Bound on the H100: bytes (2 * rows * D * sizeof(T) over 3.35 TB/s). The
// design is norm_fwd.cuh's, shared with the RMSNorm forward: a team of
// 1-16 warps a row with the row in registers, read once, and the scale and
// bias loaded once a team; persistent teams that load their next row before
// they store the current one; a sum order fixed by D; rows too wide for
// registers (D > 8192 bf16, 4096 fp32) read three times. The fp32 casts that models/transformer._norm wraps around the TPU
// kernel are fused in: the result is the fp32 result rounded once to x's
// dtype.
#include "norm_fwd.cuh"

// x, out: [rows, D] contiguous, 16-byte aligned, D a multiple of 16 / sizeof(T).
// w (scale), b (bias): [D], both of dtype w_dtype, aligned to their values of
// one vector of x (16 bytes, or 8 for bf16 of fp32 x). x_dtype / w_dtype:
// dst::DType codes.
extern "C" int dst_layernorm_fwd(const void* x, const void* w, const void* b,
                                 void* out, int rows, int D, float eps,
                                 int x_dtype, int w_dtype, void* stream) {
  return dst::norm::forward_by_dtype<true>(x, w, b, out, rows, D, eps, x_dtype, w_dtype,
                                           stream);
}
