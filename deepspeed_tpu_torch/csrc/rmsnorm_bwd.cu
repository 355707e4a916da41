// RMSNorm backward: dx and dscale of out = x * rsqrt(mean(x^2) + eps) * w,
// computed in fp32, dx written in x's dtype, dscale in fp32.
//
// Replaces deepspeed_tpu/ops/pallas/rmsnorm.py:_bwd_kernel (line 30), reached
// through _run_bwd (line 80) from the custom VJP of rmsnorm (line 110).
//
//   rstd = rsqrt(mean(x^2) + eps), xhat = x * rstd, gs = g * w
//   dx = rstd * (gs - xhat * mean(gs * xhat))
//   dscale = sum over rows of g * xhat
//
// Bound on the H100: bytes. x and g are read once and dx written once
// (3 * rows * D * sizeof(T) over 3.35 TB/s); the arithmetic is ~10 flops per
// value. Design: one 256-thread block per group of kRowsPerBlock rows. Each
// thread owns the same columns of every row of its group (16-byte vectors,
// at most kMaxVec of them), so its share of dscale stays in registers across
// the rows; per row the two sums (x^2 and g*w*x) are reduced together by warp
// shuffles and one hop through shared memory. The TPU kernel adds the dscale
// partials of its row blocks in a scratch block carried along its sequential
// grid; Hopper blocks run in parallel, so each block writes its own fp32
// partial row [nblocks, D] and a second kernel sums the partials column by
// column. No atomics: the result does not depend on the schedule.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 32;

template <typename T>
struct __align__(16) Pack {
  T v[16 / sizeof(T)];
};

// kMaxVec: 16-byte vectors per thread per row (D <= kThreads * kMaxVec * N)
template <typename T, typename W, int kMaxVec>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       const T* __restrict__ g, T* __restrict__ dx,
                       float* __restrict__ dscale_part, int rows, int D,
                       float eps) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float2 red[2][kWarps];
  const int nvec = D / N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float wv[kMaxVec][N];
  float acc[kMaxVec][N];
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int vi = tid + i * kThreads;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      wv[i][j] = vi < nvec ? dst::to_float(w[vi * N + j]) : 0.f;
      acc[i][j] = 0.f;
    }
  }

  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(rows, r0 + kRowsPerBlock);
  for (int r = r0; r < r1; ++r) {
    const size_t base = static_cast<size_t>(r) * D;
    const Pack<T>* xr = reinterpret_cast<const Pack<T>*>(x + base);
    const Pack<T>* gr = reinterpret_cast<const Pack<T>*>(g + base);
    float xv[kMaxVec][N], gv[kMaxVec][N];
    float ss = 0.f, gsx = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int vi = tid + i * kThreads;
      Pack<T> px, pg;
      if (vi < nvec) {
        px = xr[vi];
        pg = gr[vi];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        xv[i][j] = vi < nvec ? dst::to_float(px.v[j]) : 0.f;
        gv[i][j] = vi < nvec ? dst::to_float(pg.v[j]) : 0.f;
        ss += xv[i][j] * xv[i][j];
        gsx += gv[i][j] * wv[i][j] * xv[i][j];
      }
    }
    ss = dst::warp_sum(ss);
    gsx = dst::warp_sum(gsx);
    // two buffers by row parity: a row's writes never race the previous
    // row's reads, so one barrier per row suffices
    float2* buf = red[r & 1];
    if (lane == 0) buf[warp] = make_float2(ss, gsx);
    __syncthreads();
    float tss = 0.f, tgsx = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      tss += buf[i].x;
      tgsx += buf[i].y;
    }
    const float rstd = rsqrtf(tss / static_cast<float>(D) + eps);
    // mean(gs * xhat) = rstd * sum(g * w * x) / D
    const float dot = tgsx * rstd / static_cast<float>(D);
    Pack<T>* dxr = reinterpret_cast<Pack<T>*>(dx + base);
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int vi = tid + i * kThreads;
      if (vi >= nvec) continue;
      Pack<T> o;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xhat = xv[i][j] * rstd;
        o.v[j] = dst::from_float<T>(rstd * (gv[i][j] * wv[i][j] - xhat * dot));
        acc[i][j] += gv[i][j] * xhat;
      }
      dxr[vi] = o;
    }
  }

  float* part = dscale_part + static_cast<size_t>(blockIdx.x) * D;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int vi = tid + i * kThreads;
    if (vi >= nvec) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) part[vi * N + j] = acc[i][j];
  }
}

// dscale[c] = sum over blocks of part[b, c], in block order (fixed order:
// the same inputs always give the same bits)
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                        int nblocks, int D) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += part[static_cast<size_t>(b) * D + c];
  out[c] = s;
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* g, void* dx, void* part,
           void* dscale, int rows, int D, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int nvec = D / N;
  const int nblocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  if (nvec <= kThreads) {
    rmsnorm_bwd_kernel<T, W, 1><<<nblocks, kThreads, 0, stream>>>(
        xp, wp, gp, dxp, pp, rows, D, eps);
  } else if (nvec <= 2 * kThreads) {
    rmsnorm_bwd_kernel<T, W, 2><<<nblocks, kThreads, 0, stream>>>(
        xp, wp, gp, dxp, pp, rows, D, eps);
  } else if (nvec <= 4 * kThreads) {
    rmsnorm_bwd_kernel<T, W, 4><<<nblocks, kThreads, 0, stream>>>(
        xp, wp, gp, dxp, pp, rows, D, eps);
  } else if (nvec <= 8 * kThreads) {
    rmsnorm_bwd_kernel<T, W, 8><<<nblocks, kThreads, 0, stream>>>(
        xp, wp, gp, dxp, pp, rows, D, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      pp, static_cast<float*>(dscale), nblocks, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of partial dscale sums the caller allocates for dst_rmsnorm_bwd.
extern "C" int dst_rmsnorm_bwd_nblocks(int rows) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

// x, g, dx: [rows, D] contiguous, 16-byte aligned, D a multiple of
// 16 / sizeof(T) and at most 2048 * 16 / sizeof(T). w: [D]. part: fp32
// [dst_rmsnorm_bwd_nblocks(rows), D] scratch; dscale: fp32 [D].
extern "C" int dst_rmsnorm_bwd(const void* x, const void* w, const void* g,
                               void* dx, void* part, void* dscale, int rows,
                               int D, float eps, int x_dtype, int w_dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
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
