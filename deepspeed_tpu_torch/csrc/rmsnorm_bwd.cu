// RMSNorm backward: the C entries. The kernels and their design are in
// rmsnorm_bwd.cuh; fp16 (x and weight __half) is dst_rmsnorm_bwd_f16 in
// rmsnorm_bwd_f16.cu.
#include "rmsnorm_bwd.cuh"

// Rows of partial dscale sums the caller allocates for dst_rmsnorm_bwd: part
// is fp32 [dst_rmsnorm_bwd_nblocks(rows, D, x_dtype), D] (0 rows: no rows).
extern "C" int dst_rmsnorm_bwd_nblocks(int rows, int D, int x_dtype) {
  const int N = x_dtype == dst::kFloat32 ? 4 : 8;  // 16 bytes of x
  return D <= 0 || D % N != 0 ? 0 : blocks_for(rows, D / N);
}

// x, g, dx: [rows, D] contiguous, 16-byte aligned, D a multiple of
// 16 / sizeof(T) and at most 2048 * 16 / sizeof(T) (32 KB a row). w: [D],
// aligned to its values of one vector of x (16 bytes, or 8 for bf16 w of
// fp32 x). part: fp32 scratch as above; dscale: fp32 [D], written whole.
extern "C" int dst_rmsnorm_bwd(const void* x, const void* w, const void* g,
                               void* dx, void* part, void* dscale, int rows,
                               int D, float eps, int x_dtype, int w_dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == dst::kBFloat16 && w_dtype == dst::kBFloat16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, g, dx, part, dscale, rows, D, eps, s);
  } else if (x_dtype == dst::kBFloat16 && w_dtype == dst::kFloat32) {
    return launch<__nv_bfloat16, float>(x, w, g, dx, part, dscale, rows, D, eps, s);
  } else if (x_dtype == dst::kFloat32 && w_dtype == dst::kBFloat16) {
    return launch<float, __nv_bfloat16>(x, w, g, dx, part, dscale, rows, D, eps, s);
  } else if (x_dtype == dst::kFloat32 && w_dtype == dst::kFloat32) {
    return launch<float, float>(x, w, g, dx, part, dscale, rows, D, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
