// What the RMSNorm and LayerNorm forward kernels share (csrc/rmsnorm.cu,
// csrc/layernorm.cu): the row schedule, the 16-byte vector loads, and the
// warp and team reductions.
//
//   RMSNorm:   out = x * rsqrt(mean(x^2) + eps) * w
//   LayerNorm: out = (x - mean) * rsqrt(mean((x - mean)^2) + eps) * w + b
//
// both in fp32, rounded once to x's dtype. LayerNorm takes the mean first and
// the variance as the mean of (x - mean)^2, as the TPU kernel does
// (layernorm.py:26-30): a one-pass E[x^2] - mean^2 loses the variance to
// cancellation when the mean is large against the spread.
//
// Bound on the H100: bytes. Each row of D values is read once and written
// once (2 * rows * D * sizeof(T) over 3.35 TB/s); the arithmetic is a few
// flops per value. At 1-4 rows (decode) the time is latency: one DRAM round
// trip, the reductions and the launch. Design:
//
// - A team of kRowWarps warps holds a row in registers: one warp up to 64
//   16-byte vectors (D = 512 bf16), 2, 4, 8 or 16 warps for wider rows (16:
//   D = 8192 bf16, 4096 fp32). Thread t of the team holds vectors
//   t + 32 kRowWarps i, i < kVec = 2, as packed x, and the same vectors of w
//   (and b) for every row it takes, loaded once. Every load of a row goes out
//   before its first reduction. Two vectors a lane, not four: four cost
//   registers, so fewer warps stay resident, and ran slower at every shape
//   chip_smoke.py --norm-breakdown times.
// - The sum order is fixed by D alone. Vector v lies in slab v / 32 (32
//   vectors, a warp's width). A lane adds its vector's values in order; a
//   slab's 32 lane sums are a warp's xor-shuffle tree; the row's sum adds the
//   slab sums in slab order (through shared memory when they lie in several
//   warps). So a row's bits do not depend on the rows beside it or on the
//   grid.
// - Persistent rows. The grid is at most the card's resident blocks; team k
//   of all teams takes rows k, k + teams, ... and loads its next row into
//   registers before it reduces and stores the current one, so one row's
//   stores overlap the next row's loads. A team of several warps meets at a
//   named barrier of its own warps: no block barrier a row.
// - Rows wider than 16 warps x 64 vectors (D > 8192 bf16, 4096 fp32) take a
//   block of 8 warps a row, read the row twice (RMSNorm) or three times
//   (LayerNorm; the later passes served by L1/L2), each lane adding its
//   vectors in order, then the warps in order: that order is also fixed by D.
// - No split of a row over the blocks of a cluster at decode's 1-4 rows: such
//   a row costs one DRAM round trip over the launch's own time (an empty
//   kernel's, in chip_smoke.py --norm-breakdown), which no split shortens,
//   and a cluster launch and its barriers add to it.
// - No atomics: two runs give the same bits.
#pragma once

#include "common.cuh"

namespace dst {
namespace norm {

constexpr int kVecs = 2;         // 16-byte vectors a lane holds of a row
constexpr int kBlockWarps = 8;   // warps of a block (of a team of 16: 16)
constexpr int kWideWarps = 8;    // warps of a wide row's block

// The n values of E that one vector of x meets, loaded whole (16 bytes, or
// 8 for four bf16 weights of fp32 x; 32 bytes as two loads).
template <typename E, int n>
struct alignas(n * sizeof(E) < 16 ? n * sizeof(E) : 16) Vec {
  E v[n];
};

// Warps a row's team takes at nvec vectors of the row (0: a wide row).
inline int row_warps(int nvec) {
  return nvec <= 64 ? 1 : nvec <= 128 ? 2 : nvec <= 256 ? 4 : nvec <= 512 ? 8
         : nvec <= 1024 ? 16 : 0;
}

template <int kRowWarps, int kVec>
struct Plan {
  static constexpr bool kWide = kVec == 0;
  static constexpr int kWarps =
      kWide ? kWideWarps : kRowWarps > kBlockWarps ? kRowWarps : kBlockWarps;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kTeams = kWide ? 1 : kWarps / kRowWarps;  // rows a block holds
  static constexpr int kTeamVecs = 32 * kRowWarps;  // vectors a pass of the team covers
  static constexpr int kSlabs = kWide ? 1 : kRowWarps * kVec;
};

// The row's sum from each lane's partial of its slab i (part[i]): every
// slab's warp tree, then the nslab slab sums in slab order. buf: kSlabs
// floats of shared memory that only this team uses (by parity, the caller's:
// a buffer is written again only after another reduction of the team, which
// every reader of it has passed).
template <int kRowWarps, int kVec>
__device__ __forceinline__ float row_sum(float (&part)[kVec], float* buf, int nslab,
                                         int team, int wt) {
  using P = Plan<kRowWarps, kVec>;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
  }
  if constexpr (kRowWarps == 1) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) t += part[i];  // slab i: zero past nslab
    return t;
  } else {
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) buf[i * kRowWarps + wt] = part[i];
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(kRowWarps * 32) : "memory");
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < P::kSlabs; ++k) {
      if (k < nslab) t += buf[k];
    }
    return t;
  }
}

// The wide path's row sum: each warp's tree, then the warps in order.
__device__ __forceinline__ float wide_sum(float v, float* buf) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kWideWarps; ++i) t += buf[i];
  return t;
}

template <bool kLN, typename T, typename W, int kRowWarps, int kVec>
__global__ void __launch_bounds__(Plan<kRowWarps, kVec>::kThreads)
    norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    const W* __restrict__ b, T* __restrict__ out, int rows, int D,
                    float eps) {
  using P = Plan<kRowWarps, kVec>;
  constexpr int N = 16 / sizeof(T);
  using XV = Vec<T, N>;
  using WV = Vec<W, N>;
  const int nvec = D / N;
  const float fd = static_cast<float>(D);
  const WV* wr = reinterpret_cast<const WV*>(w);
  const WV* br = reinterpret_cast<const WV*>(b);

  if constexpr (P::kWide) {
    __shared__ float red[2][kWideWarps];
    for (int r = blockIdx.x; r < rows; r += gridDim.x) {
      const size_t base = static_cast<size_t>(r) * D;
      const XV* xr = reinterpret_cast<const XV*>(x + base);
      XV* orow = reinterpret_cast<XV*>(out + base);
      float s = 0.f;
#pragma unroll 4
      for (int vi = threadIdx.x; vi < nvec; vi += P::kThreads) {
        const XV p = xr[vi];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float f = to_float(p.v[j]);
          s += kLN ? f : f * f;
        }
      }
      const float t1 = wide_sum(s, red[0]);
      float mean = 0.f, rstd;
      if constexpr (kLN) {
        mean = t1 / fd;
        float ss = 0.f;
#pragma unroll 4
        for (int vi = threadIdx.x; vi < nvec; vi += P::kThreads) {
          const XV p = xr[vi];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float c = to_float(p.v[j]) - mean;
            ss += c * c;
          }
        }
        rstd = rsqrtf(wide_sum(ss, red[1]) / fd + eps);
      } else {
        rstd = rsqrtf(t1 / fd + eps);
      }
#pragma unroll 4
      for (int vi = threadIdx.x; vi < nvec; vi += P::kThreads) {
        const XV p = xr[vi];
        const WV wv = wr[vi];
        XV o;
        if constexpr (kLN) {
          const WV bv = br[vi];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float xhat = (to_float(p.v[j]) - mean) * rstd;
            o.v[j] = from_float<T>(xhat * to_float(wv.v[j]) + to_float(bv.v[j]));
          }
        } else {
#pragma unroll
          for (int j = 0; j < N; ++j) {
            o.v[j] = from_float<T>(to_float(p.v[j]) * rstd * to_float(wv.v[j]));
          }
        }
        orow[vi] = o;
      }
      __syncthreads();  // red is free again for the next row
    }
  } else {
    // the team's thread lt holds vectors lt + i * kTeamVecs, i < kVec: its
    // warp's share of slab i * kRowWarps + (its warp in the team)
    __shared__ float red[P::kTeams][2][P::kSlabs];
    const int tid = threadIdx.x;
    const int team = tid / P::kTeamVecs;
    const int wt = (tid / 32) % kRowWarps;
    const int lt = tid % P::kTeamVecs;
    const int stride = gridDim.x * P::kTeams;  // teams of the grid
    const int nslab = (nvec + 31) / 32;

    WV wv[kVec];
    WV bv[kLN ? kVec : 1];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lt + i * P::kTeamVecs;
      if (vi < nvec) {
        wv[i] = wr[vi];
        if constexpr (kLN) bv[i] = br[vi];
      }
    }
    auto load = [&](int row, XV (&px)[kVec]) {
      const XV* xr = reinterpret_cast<const XV*>(x + static_cast<size_t>(row) * D);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int vi = lt + i * P::kTeamVecs;
        if (vi < nvec) px[i] = xr[vi];
      }
    };

    XV px[kVec];
    int r = blockIdx.x * P::kTeams + team;
    if (r < rows) load(r, px);
    int parity = 0;
    for (; r < rows; r += stride) {
      XV nx[kVec];  // the next row's loads go out before this row's reductions
      if (r + stride < rows) load(r + stride, nx);

      float part[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        part[i] = 0.f;
        if (lt + i * P::kTeamVecs >= nvec) continue;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float f = to_float(px[i].v[j]);
          part[i] += kLN ? f : f * f;
        }
      }
      const float t1 = row_sum<kRowWarps, kVec>(part, red[team][parity], nslab, team, wt);
      parity ^= 1;
      float mean = 0.f, rstd;
      if constexpr (kLN) {
        mean = t1 / fd;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          part[i] = 0.f;
          if (lt + i * P::kTeamVecs >= nvec) continue;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float c = to_float(px[i].v[j]) - mean;
            part[i] += c * c;
          }
        }
        const float t2 = row_sum<kRowWarps, kVec>(part, red[team][parity], nslab, team, wt);
        parity ^= 1;
        rstd = rsqrtf(t2 / fd + eps);
      } else {
        rstd = rsqrtf(t1 / fd + eps);
      }

      XV* orow = reinterpret_cast<XV*>(out + static_cast<size_t>(r) * D);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int vi = lt + i * P::kTeamVecs;
        if (vi >= nvec) continue;
        XV o;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float f = to_float(px[i].v[j]);
          if constexpr (kLN) {
            o.v[j] = from_float<T>((f - mean) * rstd * to_float(wv[i].v[j]) +
                                   to_float(bv[i].v[j]));
          } else {
            o.v[j] = from_float<T>(f * rstd * to_float(wv[i].v[j]));
          }
        }
        orow[vi] = o;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) px[i] = nx[i];
    }
  }
}

// Resident blocks of kernel an SM, once a process for each instantiation.
template <bool kLN, typename T, typename W, int kRowWarps, int kVec>
int resident_blocks() {
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, norm_fwd_kernel<kLN, T, W, kRowWarps, kVec>,
        Plan<kRowWarps, kVec>::kThreads, 0);
    return n > 0 ? n : 1;
  }();
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return per_sm * sms;
}

template <bool kLN, typename T, typename W, int kRowWarps, int kVec>
int launch(const T* x, const W* w, const W* b, T* out, int rows, int D, float eps,
           cudaStream_t stream) {
  using P = Plan<kRowWarps, kVec>;
  const int resident = resident_blocks<kLN, T, W, kRowWarps, kVec>();
  const int want = (rows + P::kTeams - 1) / P::kTeams;
  norm_fwd_kernel<kLN, T, W, kRowWarps, kVec>
      <<<want < resident ? want : resident, P::kThreads, 0, stream>>>(x, w, b, out, rows, D,
                                                                      eps);
  return static_cast<int>(cudaGetLastError());
}

// The plan D takes: warps a row, the wide path past 16 warps.
template <bool kLN, typename T, typename W>
int forward(const void* xv, const void* wv, const void* bv, void* outv, int rows, int D,
            float eps, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (D <= 0 || D % N != 0) return static_cast<int>(cudaErrorInvalidValue);
  const T* x = static_cast<const T*>(xv);
  const W* w = static_cast<const W*>(wv);
  const W* b = static_cast<const W*>(bv);
  T* out = static_cast<T*>(outv);
  switch (row_warps(D / N)) {
    case 1: return launch<kLN, T, W, 1, kVecs>(x, w, b, out, rows, D, eps, s);
    case 2: return launch<kLN, T, W, 2, kVecs>(x, w, b, out, rows, D, eps, s);
    case 4: return launch<kLN, T, W, 4, kVecs>(x, w, b, out, rows, D, eps, s);
    case 8: return launch<kLN, T, W, 8, kVecs>(x, w, b, out, rows, D, eps, s);
    case 16: return launch<kLN, T, W, 16, kVecs>(x, w, b, out, rows, D, eps, s);
    default: return launch<kLN, T, W, kWideWarps, 0>(x, w, b, out, rows, D, eps, s);
  }
}

// The C entry points' dtype dispatch.
template <bool kLN>
int forward_by_dtype(const void* x, const void* w, const void* b, void* out, int rows, int D,
                     float eps, int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16) {
    return forward<kLN, __nv_bfloat16, __nv_bfloat16>(x, w, b, out, rows, D, eps, s);
  } else if (x_dtype == kBFloat16 && w_dtype == kFloat32) {
    return forward<kLN, __nv_bfloat16, float>(x, w, b, out, rows, D, eps, s);
  } else if (x_dtype == kFloat32 && w_dtype == kBFloat16) {
    return forward<kLN, float, __nv_bfloat16>(x, w, b, out, rows, D, eps, s);
  } else if (x_dtype == kFloat32 && w_dtype == kFloat32) {
    return forward<kLN, float, float>(x, w, b, out, rows, D, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace norm
}  // namespace dst
