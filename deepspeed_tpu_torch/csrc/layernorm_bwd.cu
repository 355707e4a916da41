// LayerNorm backward: dx, dscale and dbias of
// out = (x - mean) * rsqrt(var + eps) * w + b, computed in fp32, dx written in
// x's dtype, dscale and dbias in fp32.
//
// Replaces deepspeed_tpu/ops/pallas/layernorm.py:_bwd_kernel (line 37),
// reached through _run_bwd (line 83) from the custom VJP of layernorm
// (line 112).
//
//   mean = mean(x), xc = x - mean, rstd = rsqrt(mean(xc^2) + eps)
//   xhat = xc * rstd, gs = g * w
//   dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat))   (layernorm.py:50-52)
//   dscale = sum over rows of g * xhat, dbias = sum over rows of g
//
// Bound on the H100: bytes. x and g are read once and dx written once
// (3 * rows * D * sizeof(T) over 3.35 TB/s); the arithmetic is ~15 flops per
// value. Design: rmsnorm_bwd.cu's. One 256-thread block per group of
// kRowsPerBlock rows; each thread owns the same columns of every row of its
// group (16-byte vectors, at most kMaxVec of them), so its shares of dscale
// and dbias stay in registers across the rows. Per row two block reductions,
// each of two sums at once: (sum x, sum gs), then (sum xc^2, sum gs * xc),
// the mean first as the forward takes it; mean(gs * xhat) is
// rstd * sum(gs * xc) / D. The TPU kernel adds the dscale/dbias partials of
// its row blocks in an (8, D) block carried along its sequential grid
// (layernorm.py:54-62); Hopper blocks run in parallel, so each block writes
// its own fp32 partial rows and a second kernel sums them column by column in
// block order. No atomics: two runs give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 32;

template <typename T>
struct __align__(16) Pack {
  T v[16 / sizeof(T)];
};

// Two sums over the block at once; buf is kWarps float2 of shared memory no
// other reduction in flight uses.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* buf) {
  a = dst::warp_sum(a);
  b = dst::warp_sum(b);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    t.x += buf[i].x;
    t.y += buf[i].y;
  }
  return t;
}

// kMaxVec: 16-byte vectors per thread per row (D <= kThreads * kMaxVec * N)
template <typename T, typename W, int kMaxVec>
__global__ void __launch_bounds__(kThreads)
    layernorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                         const T* __restrict__ g, T* __restrict__ dx,
                         float* __restrict__ dscale_part,
                         float* __restrict__ dbias_part, int rows, int D,
                         float eps) {
  constexpr int N = 16 / sizeof(T);
  // four buffers: two reductions a row, by row parity, so a row's writes
  // never race the previous row's reads
  __shared__ float2 red[4][kWarps];
  const int nvec = D / N;
  const int tid = threadIdx.x;
  const float fd = static_cast<float>(D);

  float wv[kMaxVec][N];
  float acc_s[kMaxVec][N];
  float acc_b[kMaxVec][N];
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int vi = tid + i * kThreads;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      wv[i][j] = vi < nvec ? dst::to_float(w[vi * N + j]) : 0.f;
      acc_s[i][j] = 0.f;
      acc_b[i][j] = 0.f;
    }
  }

  const int r0 = blockIdx.x * kRowsPerBlock;
  const int r1 = min(rows, r0 + kRowsPerBlock);
  for (int r = r0; r < r1; ++r) {
    const size_t base = static_cast<size_t>(r) * D;
    const Pack<T>* xr = reinterpret_cast<const Pack<T>*>(x + base);
    const Pack<T>* gr = reinterpret_cast<const Pack<T>*>(g + base);
    float xv[kMaxVec][N], gv[kMaxVec][N];
    float sx = 0.f, sgs = 0.f;
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
        sx += xv[i][j];
        sgs += gv[i][j] * wv[i][j];
      }
    }
    const int par = (r & 1) * 2;
    const float2 t1 = block_sum2(sx, sgs, red[par]);
    const float mean = t1.x / fd;
    const float m1 = t1.y / fd;  // mean(gs)
    float sxc = 0.f, sgxc = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int vi = tid + i * kThreads;
      if (vi >= nvec) continue;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float c = xv[i][j] - mean;
        sxc += c * c;
        sgxc += gv[i][j] * wv[i][j] * c;
      }
    }
    const float2 t2 = block_sum2(sxc, sgxc, red[par + 1]);
    const float rstd = rsqrtf(t2.x / fd + eps);
    const float m2 = t2.y * rstd / fd;  // mean(gs * xhat)
    Pack<T>* dxr = reinterpret_cast<Pack<T>*>(dx + base);
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int vi = tid + i * kThreads;
      if (vi >= nvec) continue;
      Pack<T> o;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xhat = (xv[i][j] - mean) * rstd;
        o.v[j] = dst::from_float<T>(rstd * (gv[i][j] * wv[i][j] - m1 - xhat * m2));
        acc_s[i][j] += gv[i][j] * xhat;
        acc_b[i][j] += gv[i][j];
      }
      dxr[vi] = o;
    }
  }

  float* ps = dscale_part + static_cast<size_t>(blockIdx.x) * D;
  float* pb = dbias_part + static_cast<size_t>(blockIdx.x) * D;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int vi = tid + i * kThreads;
    if (vi >= nvec) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      ps[vi * N + j] = acc_s[i][j];
      pb[vi * N + j] = acc_b[i][j];
    }
  }
}

// dscale[c], dbias[c] = sums over blocks of their partials, in block order
// (fixed order: the same inputs always give the same bits)
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const float* __restrict__ ps, const float* __restrict__ pb,
                        float* __restrict__ ds, float* __restrict__ db,
                        int nblocks, int D) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= D) return;
  float s = 0.f, t = 0.f;
  for (int b = 0; b < nblocks; ++b) {
    s += ps[static_cast<size_t>(b) * D + c];
    t += pb[static_cast<size_t>(b) * D + c];
  }
  ds[c] = s;
  db[c] = t;
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* g, void* dx, void* part,
           void* dscale, void* dbias, int rows, int D, float eps,
           cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int nvec = D / N;
  const int nblocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  float* ps = static_cast<float*>(part);
  float* pb = ps + static_cast<size_t>(nblocks) * D;
  if (nvec <= kThreads) {
    layernorm_bwd_kernel<T, W, 1><<<nblocks, kThreads, 0, stream>>>(
        xp, wp, gp, dxp, ps, pb, rows, D, eps);
  } else if (nvec <= 2 * kThreads) {
    layernorm_bwd_kernel<T, W, 2><<<nblocks, kThreads, 0, stream>>>(
        xp, wp, gp, dxp, ps, pb, rows, D, eps);
  } else if (nvec <= 4 * kThreads) {
    layernorm_bwd_kernel<T, W, 4><<<nblocks, kThreads, 0, stream>>>(
        xp, wp, gp, dxp, ps, pb, rows, D, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      ps, pb, static_cast<float*>(dscale), static_cast<float*>(dbias), nblocks, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of partial sums per output the caller allocates for dst_layernorm_bwd:
// part is fp32 [2 * dst_layernorm_bwd_nblocks(rows), D] (dscale's, then dbias's).
extern "C" int dst_layernorm_bwd_nblocks(int rows) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
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
