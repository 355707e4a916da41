// LayerNorm backward: the C entries. The kernels and their design are in
// layernorm_bwd.cuh; fp16 (x and weight __half) is dst_layernorm_bwd_f16 in
// layernorm_bwd_f16.cu.
#include "layernorm_bwd.cuh"

// Rows of partial sums per output the caller allocates for dst_layernorm_bwd:
// part is fp32 [2 * dst_layernorm_bwd_nblocks(rows, D, x_dtype), D]
// (dscale's, then dbias's).
extern "C" int dst_layernorm_bwd_nblocks(int rows, int D, int x_dtype) {
  const int N = x_dtype == dst::kFloat32 ? 4 : 8;
  return rows <= 0 ? 0 : blocks_for(rows, D / N);
}

// x, g, dx: [rows, D] contiguous, 16-byte aligned, D a multiple of
// 16 / sizeof(T) and at most 1024 * 16 / sizeof(T). w: [D]. part: fp32
// scratch as above; dscale, dbias: fp32 [D].
extern "C" int dst_layernorm_bwd(const void* x, const void* w, const void* g,
                                 void* dx, void* part, void* dscale, void* dbias,
                                 int rows, int D, float eps, int x_dtype,
                                 int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (x_dtype == dst::kBFloat16 && w_dtype == dst::kBFloat16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, g, dx, part, dscale, dbias, rows, D, eps, s);
  } else if (x_dtype == dst::kBFloat16 && w_dtype == dst::kFloat32) {
    return launch<__nv_bfloat16, float>(x, w, g, dx, part, dscale, dbias, rows, D, eps, s);
  } else if (x_dtype == dst::kFloat32 && w_dtype == dst::kBFloat16) {
    return launch<float, __nv_bfloat16>(x, w, g, dx, part, dscale, dbias, rows, D, eps, s);
  } else if (x_dtype == dst::kFloat32 && w_dtype == dst::kFloat32) {
    return launch<float, float>(x, w, g, dx, part, dscale, dbias, rows, D, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
