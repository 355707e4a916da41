// RMSNorm forward: out = x * rsqrt(mean(x^2) + eps) * w, computed in fp32 and
// written in x's dtype.
//
// Replaces deepspeed_tpu/ops/pallas/rmsnorm.py:_fwd_kernel (line 23), reached
// through _run_fwd (line 64) from rmsnorm (line 110).
//
// Bound on the H100: bytes (2 * rows * D * sizeof(T) over 3.35 TB/s). The
// design is norm_fwd.cuh's, shared with the LayerNorm forward: a team of
// 1-16 warps a row with the row in registers, read once, and the weights
// loaded once a team; persistent teams that load their next row before they
// store the current one; a sum order fixed by D.
// The fp32 casts that models/transformer._norm wraps around the TPU kernel are
// fused in: the result is the fp32 result rounded once to x's dtype.
#include "norm_fwd.cuh"

// x, out: [rows, D] contiguous, 16-byte aligned, D a multiple of 16 / sizeof(T).
// w: [D], aligned to its values of one vector of x (16 bytes, or 8 for bf16 w
// of fp32 x). x_dtype / w_dtype: dst::DType codes, bf16 or fp32 (fp16 is
// dst_rmsnorm_fwd_f16, rmsnorm_f16.cu).
extern "C" int dst_rmsnorm_fwd(const void* x, const void* w, void* out, int rows,
                               int D, float eps, int x_dtype, int w_dtype,
                               void* stream) {
  return dst::norm::forward_by_dtype<false>(x, w, nullptr, out, rows, D, eps, x_dtype,
                                            w_dtype, stream);
}
