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
// value. Design:
//
// - A team of kRowWarps warps per row: one warp up to 128 16-byte vectors
//   (D = 1024 bf16, 512 fp32), 2, 4 or 8 warps for wider rows. Lane l of
//   warp w in the team holds vectors (32 w + l) + 32 kRowWarps j, j < 4, of
//   every row it takes, so its shares of dscale and dbias stay in registers
//   across the rows. A row's two pairs of sums, (sum x, sum gs) then
//   (sum xc^2, sum gs * xc), are warp shuffles (xor tree); a team of several
//   warps adds its warps' sums in warp order through shared memory under a
//   named barrier of the team's warps only. No block barrier per row.
// - Rows in flight. Team k of all teams takes rows k, k + teams, ...; it
//   loads its next row's x and g before it computes and stores the current
//   row's dx.
// - The grid: ceil(rows / teams a block) blocks, at most kMaxBlocks (two an
//   SM of the H100's 132): a function of rows and D only.
// - dscale/dbias: each block adds its teams' register partials in team
//   order in shared memory and writes one fp32 partial row; a second kernel
//   of D / 16 x 2 blocks (128 at D = 1024) adds the partial rows of a
//   16-column strip: 16 row lanes each take every 16th row in order, then
//   the 16 lane sums in lane order. The TPU kernel carried the sums in an
//   (8, D) block along its sequential grid (layernorm.py:54-62); Hopper
//   blocks run in parallel, hence the partial rows.
// - No atomics: two runs give the same bits.
//
// This header holds the kernels and their launch, templated on the element
// types; layernorm_bwd.cu (bf16 and fp32 forms) and layernorm_bwd_f16.cu
// (fp16 x and weight) instantiate them, each compiled by its own nvcc. Its
// helpers sit in an anonymous namespace: each unit has its own copy.
#pragma once

#include "common.cuh"

namespace {

constexpr int kVec = 4;           // 16-byte vectors a lane holds of a row
constexpr int kBlockWarps = 4;    // warps of a block (of a team of 8: 8)
constexpr int kMaxBlocks = 264;   // two blocks an SM of the H100's 132
constexpr int kMergeCols = 16;    // columns of a merge block's strip
constexpr int kMergeLanes = 16;   // row lanes of a merge block

template <typename T>
struct __align__(16) Pack {
  T v[16 / sizeof(T)];
};

template <int kRowWarps>
struct Plan {
  static constexpr int kWarps = kRowWarps > kBlockWarps ? kRowWarps : kBlockWarps;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kTeams = kWarps / kRowWarps;
};

// Sums of a team of kRowWarps warps: shuffles within each warp, then the
// warps' totals in warp order through buf (kRowWarps float2 of shared memory
// the team alone uses) under the team's named barrier (id 1 + team).
template <int kRowWarps>
__device__ __forceinline__ float2 team_sum2(float a, float b, float2* buf, int team,
                                            int wt) {
  a = dst::warp_sum(a);
  b = dst::warp_sum(b);
  if constexpr (kRowWarps == 1) {
    return make_float2(a, b);
  } else {
    if ((threadIdx.x & 31) == 0) buf[wt] = make_float2(a, b);
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(kRowWarps * 32) : "memory");
    float2 t = buf[0];
#pragma unroll
    for (int i = 1; i < kRowWarps; ++i) {
      t.x += buf[i].x;
      t.y += buf[i].y;
    }
    return t;
  }
}

template <typename T, typename W, int kRowWarps>
__global__ void __launch_bounds__(Plan<kRowWarps>::kThreads)
    layernorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                         const T* __restrict__ g, T* __restrict__ dx,
                         float* __restrict__ dscale_part,
                         float* __restrict__ dbias_part, int rows, int D,
                         float eps) {
  using P = Plan<kRowWarps>;
  constexpr int N = 16 / sizeof(T);
  constexpr int kTeamVecs = 32 * kRowWarps;  // vectors a pass of the team covers
  // two buffers a team, by reduction parity: a buffer is written again only
  // after another barrier of the team, which every reader of it has passed
  __shared__ float2 red[P::kTeams][2][kRowWarps];
  // the block's teams' partials for the merge: [teams][D] (teams > 1 only)
  __shared__ float merge_s[P::kTeams > 1 ? P::kTeams * kTeamVecs * kVec * N : 1];
  __shared__ float merge_b[P::kTeams > 1 ? P::kTeams * kTeamVecs * kVec * N : 1];
  const int nvec = D / N;
  const int tid = threadIdx.x;
  const int team = tid / (32 * kRowWarps);
  const int wt = (tid / 32) % kRowWarps;  // the warp's place in its team
  const int lt = tid % (32 * kRowWarps);  // the thread's place in its team
  const float fd = static_cast<float>(D);

  float wv[kVec][N];
  float acc_s[kVec][N];
  float acc_b[kVec][N];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = lt + i * kTeamVecs;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      wv[i][j] = vi < nvec ? dst::to_float(w[vi * N + j]) : 0.f;
      acc_s[i][j] = 0.f;
      acc_b[i][j] = 0.f;
    }
  }

  const int teams = gridDim.x * P::kTeams;
  int r = blockIdx.x * P::kTeams + team;
  Pack<T> px[kVec], pg[kVec];
  auto load = [&](int row, Pack<T> (&ax)[kVec], Pack<T> (&ag)[kVec]) {
    const size_t base = static_cast<size_t>(row) * D;
    const Pack<T>* xr = reinterpret_cast<const Pack<T>*>(x + base);
    const Pack<T>* gr = reinterpret_cast<const Pack<T>*>(g + base);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lt + i * kTeamVecs;
      if (vi < nvec) {
        ax[i] = xr[vi];
        ag[i] = gr[vi];
      }
    }
  };
  if (r < rows) load(r, px, pg);
  int parity = 0;
  for (; r < rows; r += teams) {
    // the next row's loads go out before this row's arithmetic
    Pack<T> nx[kVec], ng[kVec];
    const int next = r + teams;
    if (next < rows) load(next, nx, ng);

    // x and g stay packed in registers and are widened where they are used
    float sx = 0.f, sgs = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (lt + i * kTeamVecs >= nvec) continue;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        sx += dst::to_float(px[i].v[j]);
        sgs += dst::to_float(pg[i].v[j]) * wv[i][j];
      }
    }
    const float2 t1 = team_sum2<kRowWarps>(sx, sgs, red[team][parity], team, wt);
    parity ^= 1;
    const float mean = t1.x / fd;
    const float m1 = t1.y / fd;  // mean(gs)
    float sxc = 0.f, sgxc = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (lt + i * kTeamVecs >= nvec) continue;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float c = dst::to_float(px[i].v[j]) - mean;
        sxc += c * c;
        sgxc += dst::to_float(pg[i].v[j]) * wv[i][j] * c;
      }
    }
    const float2 t2 = team_sum2<kRowWarps>(sxc, sgxc, red[team][parity], team, wt);
    parity ^= 1;
    const float rstd = rsqrtf(t2.x / fd + eps);
    const float m2 = t2.y * rstd / fd;  // mean(gs * xhat)
    Pack<T>* dxr = reinterpret_cast<Pack<T>*>(dx + static_cast<size_t>(r) * D);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lt + i * kTeamVecs;
      if (vi >= nvec) continue;
      Pack<T> o;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float gf = dst::to_float(pg[i].v[j]);
        const float xhat = (dst::to_float(px[i].v[j]) - mean) * rstd;
        o.v[j] = dst::from_float<T>(rstd * (gf * wv[i][j] - m1 - xhat * m2));
        acc_s[i][j] += gf * xhat;
        acc_b[i][j] += gf;
      }
      dxr[vi] = o;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      px[i] = nx[i];
      pg[i] = ng[i];
    }
  }

  // one partial row a block: its teams' partials added in team order
  float* ps = dscale_part + static_cast<size_t>(blockIdx.x) * D;
  float* pb = dbias_part + static_cast<size_t>(blockIdx.x) * D;
  if constexpr (P::kTeams == 1) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lt + i * kTeamVecs;
      if (vi >= nvec) continue;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ps[vi * N + j] = acc_s[i][j];
        pb[vi * N + j] = acc_b[i][j];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lt + i * kTeamVecs;
      if (vi >= nvec) continue;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        merge_s[team * D + vi * N + j] = acc_s[i][j];
        merge_b[team * D + vi * N + j] = acc_b[i][j];
      }
    }
    __syncthreads();
    for (int c = tid; c < D; c += P::kThreads) {
      float a = merge_s[c], b = merge_b[c];
#pragma unroll
      for (int k = 1; k < P::kTeams; ++k) {
        a += merge_s[k * D + c];
        b += merge_b[k * D + c];
      }
      ps[c] = a;
      pb[c] = b;
    }
  }
}

// dscale[c], dbias[c] = sums over blocks of their partial rows (blockIdx.y:
// 0 dscale, 1 dbias): row lane l adds rows l, l + 16, ... in order, then the
// 16 lane sums in lane order (fixed order: the same inputs give the same bits)
__global__ void __launch_bounds__(kMergeCols * kMergeLanes)
    merge_partials_kernel(const float* __restrict__ ps, const float* __restrict__ pb,
                          float* __restrict__ ds, float* __restrict__ db,
                          int nblocks, int D) {
  __shared__ float lanes[kMergeLanes][kMergeCols];
  const float* part = blockIdx.y == 0 ? ps : pb;
  float* dst_row = blockIdx.y == 0 ? ds : db;
  const int col = threadIdx.x % kMergeCols;
  const int lane = threadIdx.x / kMergeCols;
  const int c = blockIdx.x * kMergeCols + col;
  float v = 0.f;
  if (c < D) {
    for (int b = lane; b < nblocks; b += kMergeLanes) {
      v += part[static_cast<size_t>(b) * D + c];
    }
  }
  lanes[lane][col] = v;
  __syncthreads();
  if (lane == 0 && c < D) {
    float t = lanes[0][col];
#pragma unroll
    for (int l = 1; l < kMergeLanes; ++l) t += lanes[l][col];
    dst_row[c] = t;
  }
}

// Warps a row's team takes at D: 128 vectors a warp, up to 8 warps.
int row_warps(int nvec) {
  return nvec <= 128 ? 1 : nvec <= 256 ? 2 : nvec <= 512 ? 4 : 8;
}

int teams_per_block(int row_warps) {
  return row_warps >= kBlockWarps ? 1 : kBlockWarps / row_warps;
}

int blocks_for(int rows, int nvec) {
  const int teams = teams_per_block(row_warps(nvec));
  const int want = (rows + teams - 1) / teams;
  return want < kMaxBlocks ? want : kMaxBlocks;
}

template <typename T, typename W, int kRowWarps>
cudaError_t launch_rows(const T* x, const W* w, const T* g, T* dx, float* ps, float* pb,
                        int nblocks, int rows, int D, float eps, cudaStream_t stream) {
  layernorm_bwd_kernel<T, W, kRowWarps><<<nblocks, Plan<kRowWarps>::kThreads, 0, stream>>>(
      x, w, g, dx, ps, pb, rows, D, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* x, const void* w, const void* g, void* dx, void* part,
           void* dscale, void* dbias, int rows, int D, float eps,
           cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int nvec = D / N;
  if (D % N != 0 || nvec > 8 * 32 * kVec) return static_cast<int>(cudaErrorInvalidValue);
  const int nblocks = blocks_for(rows, nvec);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  float* ps = static_cast<float*>(part);
  float* pb = ps + static_cast<size_t>(nblocks) * D;
  cudaError_t err;
  switch (row_warps(nvec)) {
    case 1: err = launch_rows<T, W, 1>(xp, wp, gp, dxp, ps, pb, nblocks, rows, D, eps, stream); break;
    case 2: err = launch_rows<T, W, 2>(xp, wp, gp, dxp, ps, pb, nblocks, rows, D, eps, stream); break;
    case 4: err = launch_rows<T, W, 4>(xp, wp, gp, dxp, ps, pb, nblocks, rows, D, eps, stream); break;
    default: err = launch_rows<T, W, 8>(xp, wp, gp, dxp, ps, pb, nblocks, rows, D, eps, stream); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_partials_kernel<<<dim3((D + kMergeCols - 1) / kMergeCols, 2), kMergeCols * kMergeLanes,
                          0, stream>>>(ps, pb, static_cast<float*>(dscale),
                                       static_cast<float*>(dbias), nblocks, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
