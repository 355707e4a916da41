// LayerNorm forward: out = (x - mean) * rsqrt(var + eps) * scale + bias over
// the last dim, computed in fp32 and written in x's dtype.
//
// Replaces deepspeed_tpu/ops/pallas/layernorm.py:_fwd_kernel (line 25),
// reached through _run_fwd (line 65) from layernorm (line 112).
//
// As the TPU kernel does (layernorm.py:26-30), the mean comes first and the
// variance is the mean of (x - mean)^2: a one-pass E[x^2] - mean^2 loses the
// variance to cancellation when the mean is large against the spread.
//
// Bound on the H100: bytes. Each row of D values is read once and written
// once (2 * rows * D * sizeof(T) bytes over 3.35 TB/s); the arithmetic is a
// few flops per value. Design: one 128-thread block per row. With the row
// small enough (at most kThreads * kMaxVec 16-byte vectors: D <= 16384 in
// bf16, 8192 in fp32), each thread holds its vectors of the row in registers
// across the two block reductions (warp shuffles, one hop through shared
// memory each) and the write, so x is read from memory once. A wider row
// (kMaxVec = 0) makes three passes over it instead, the second and third
// served by L1/L2. The fp32 casts that models/transformer._norm wraps around
// the TPU kernel are fused in: the result is the fp32 result rounded once to
// x's dtype.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct __align__(16) Pack {
  T v[16 / sizeof(T)];
};

// Sum of v over the block; buf is kWarps floats of shared memory that no
// other reduction in flight uses.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  v = dst::warp_sum(v);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += buf[i];
  return total;
}

// kMaxVec > 0: the row in registers (at most kMaxVec vectors a thread);
// kMaxVec == 0: three passes over the row.
template <typename T, typename W, int kMaxVec>
__global__ void __launch_bounds__(kThreads)
    layernorm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                         const W* __restrict__ b, T* __restrict__ out, int D,
                         float eps) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float red[2][kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  const Pack<T>* xr = reinterpret_cast<const Pack<T>*>(x + base);
  Pack<T>* orow = reinterpret_cast<Pack<T>*>(out + base);
  const int nvec = D / N;
  const int tid = threadIdx.x;
  const float fd = static_cast<float>(D);

  if constexpr (kMaxVec > 0) {
    float xv[kMaxVec][N];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int vi = tid + i * kThreads;
      Pack<T> p;
      if (vi < nvec) p = xr[vi];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        xv[i][j] = vi < nvec ? dst::to_float(p.v[j]) : 0.f;
        s += xv[i][j];
      }
    }
    const float mean = block_sum(s, red[0]) / fd;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int vi = tid + i * kThreads;
      if (vi >= nvec) continue;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float c = xv[i][j] - mean;
        ss += c * c;
      }
    }
    const float rstd = rsqrtf(block_sum(ss, red[1]) / fd + eps);
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int vi = tid + i * kThreads;
      if (vi >= nvec) continue;
      Pack<T> o;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xhat = (xv[i][j] - mean) * rstd;
        o.v[j] = dst::from_float<T>(xhat * dst::to_float(w[vi * N + j]) +
                                    dst::to_float(b[vi * N + j]));
      }
      orow[vi] = o;
    }
  } else {
    float s = 0.f;
    for (int vi = tid; vi < nvec; vi += kThreads) {
      const Pack<T> p = xr[vi];
#pragma unroll
      for (int j = 0; j < N; ++j) s += dst::to_float(p.v[j]);
    }
    const float mean = block_sum(s, red[0]) / fd;
    float ss = 0.f;
    for (int vi = tid; vi < nvec; vi += kThreads) {
      const Pack<T> p = xr[vi];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float c = dst::to_float(p.v[j]) - mean;
        ss += c * c;
      }
    }
    const float rstd = rsqrtf(block_sum(ss, red[1]) / fd + eps);
    for (int vi = tid; vi < nvec; vi += kThreads) {
      const Pack<T> p = xr[vi];
      Pack<T> o;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xhat = (dst::to_float(p.v[j]) - mean) * rstd;
        o.v[j] = dst::from_float<T>(xhat * dst::to_float(w[vi * N + j]) +
                                    dst::to_float(b[vi * N + j]));
      }
      orow[vi] = o;
    }
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* b, void* out, int rows,
           int D, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int nvec = D / N;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  T* op = static_cast<T*>(out);
  if (nvec <= kThreads) {
    layernorm_fwd_kernel<T, W, 1><<<rows, kThreads, 0, stream>>>(xp, wp, bp, op, D, eps);
  } else if (nvec <= 2 * kThreads) {
    layernorm_fwd_kernel<T, W, 2><<<rows, kThreads, 0, stream>>>(xp, wp, bp, op, D, eps);
  } else if (nvec <= 4 * kThreads) {
    layernorm_fwd_kernel<T, W, 4><<<rows, kThreads, 0, stream>>>(xp, wp, bp, op, D, eps);
  } else if (nvec <= 8 * kThreads) {
    layernorm_fwd_kernel<T, W, 8><<<rows, kThreads, 0, stream>>>(xp, wp, bp, op, D, eps);
  } else if (nvec <= 16 * kThreads) {
    layernorm_fwd_kernel<T, W, 16><<<rows, kThreads, 0, stream>>>(xp, wp, bp, op, D, eps);
  } else {
    layernorm_fwd_kernel<T, W, 0><<<rows, kThreads, 0, stream>>>(xp, wp, bp, op, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [rows, D] contiguous, 16-byte aligned, D a multiple of 16 / sizeof(T).
// w (scale), b (bias): [D], both of dtype w_dtype. x_dtype / w_dtype:
// dst::DType codes.
extern "C" int dst_layernorm_fwd(const void* x, const void* w, const void* b,
                                 void* out, int rows, int D, float eps,
                                 int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (x_dtype == dst::kBFloat16 && w_dtype == dst::kBFloat16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, out, rows, D, eps, s);
  } else if (x_dtype == dst::kBFloat16 && w_dtype == dst::kFloat32) {
    return launch<__nv_bfloat16, float>(x, w, b, out, rows, D, eps, s);
  } else if (x_dtype == dst::kFloat32 && w_dtype == dst::kBFloat16) {
    return launch<float, __nv_bfloat16>(x, w, b, out, rows, D, eps, s);
  } else if (x_dtype == dst::kFloat32 && w_dtype == dst::kFloat32) {
    return launch<float, float>(x, w, b, out, rows, D, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
