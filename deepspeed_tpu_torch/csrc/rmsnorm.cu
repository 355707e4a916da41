// RMSNorm forward: out = x * rsqrt(mean(x^2) + eps) * w, computed in fp32 and
// written in x's dtype.
//
// Replaces deepspeed_tpu/ops/pallas/rmsnorm.py:_fwd_kernel (line 23), reached
// through _run_fwd (line 64) from rmsnorm (line 110).
//
// Bound on the H100: bytes. Each row of D values is read once and written once
// (2 * rows * D * sizeof(T) bytes over 3.35 TB/s); the arithmetic is a few
// flops per value. Design: one 256-thread block per row, 16-byte vector loads
// and stores, the sum of squares reduced by warp shuffles and one hop through
// shared memory, then a second pass over the row (served by L1/L2) that writes
// the result. The fp32 casts that models/transformer._norm wraps around the TPU
// kernel are fused in: the result is the fp32 result rounded once to x's dtype.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct __align__(16) Pack {
  T v[16 / sizeof(T)];
};

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       T* __restrict__ out, int D, float eps) {
  constexpr int N = 16 / sizeof(T);
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  const Pack<T>* xr = reinterpret_cast<const Pack<T>*>(x + base);
  Pack<T>* orow = reinterpret_cast<Pack<T>*>(out + base);
  const int nvec = D / N;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T> p = xr[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float f = dst::to_float(p.v[j]);
      ss += f * f;
    }
  }
  __shared__ float partial[kThreads / 32];
  ss = dst::warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += partial[i];
  const float rstd = rsqrtf(total / static_cast<float>(D) + eps);

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const Pack<T> p = xr[i];
    Pack<T> o;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      o.v[j] = dst::from_float<T>(dst::to_float(p.v[j]) * rstd *
                                  dst::to_float(w[i * N + j]));
    }
    orow[i] = o;
  }
}

template <typename T, typename W>
void launch(const void* x, const void* w, void* out, int rows, int D, float eps,
            cudaStream_t stream) {
  rmsnorm_fwd_kernel<T, W><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out),
      D, eps);
}

}  // namespace

// x, out: [rows, D] contiguous, 16-byte aligned, D a multiple of 16 / sizeof(T).
// w: [D]. x_dtype / w_dtype: dst::DType codes.
extern "C" int dst_rmsnorm_fwd(const void* x, const void* w, void* out, int rows,
                               int D, float eps, int x_dtype, int w_dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (x_dtype == dst::kBFloat16 && w_dtype == dst::kBFloat16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, D, eps, s);
  } else if (x_dtype == dst::kBFloat16 && w_dtype == dst::kFloat32) {
    launch<__nv_bfloat16, float>(x, w, out, rows, D, eps, s);
  } else if (x_dtype == dst::kFloat32 && w_dtype == dst::kBFloat16) {
    launch<float, __nv_bfloat16>(x, w, out, rows, D, eps, s);
  } else if (x_dtype == dst::kFloat32 && w_dtype == dst::kFloat32) {
    launch<float, float>(x, w, out, rows, D, eps, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
