// RMSNorm backward: dx and dscale of out = x * rsqrt(mean(x^2) + eps) * w,
// computed in fp32, dx written in x's dtype, dscale in fp32.
//
// Replaces deepspeed_tpu/ops/pallas/rmsnorm.py:_bwd_kernel (line 30), reached
// through _run_bwd (line 82) from the custom VJP of rmsnorm (line 110).
//
//   rstd = rsqrt(mean(x^2) + eps), xhat = x * rstd, gs = g * w
//   dx = rstd * (gs - xhat * mean(gs * xhat))
//   dscale = sum over rows of g * xhat
//
// Bound on the H100: bytes. x and g are read once and dx written once
// (3 * rows * D * sizeof(T) over 3.35 TB/s); the arithmetic is ~10 flops per
// value. Design, on the row layout of the forwards (norm_fwd.cuh):
//
// - A team of kRowWarps warps holds a row: 1, 2, 4, 8 or 16 warps of two
//   16-byte vectors a lane up to 1024 vectors (D = 8192 bf16, 4096 fp32),
//   16 warps of four vectors a lane up to 2048 (32 KB a row). Thread t of
//   the team holds vectors t + 32 kRowWarps i of x and g packed, and the same
//   vectors of w for every row it takes, loaded once.
// - A row's two sums, sum x^2 and sum (g w) x, go through one reduction as
//   a float2, in the forwards' order: a lane adds its vector's values in
//   order, a slab of 32 vectors is a warp's xor-shuffle tree, the row adds
//   its slab sums in slab order (through shared memory under a named barrier
//   of the team's warps when the team has several). So a row's dx depends on
//   D alone, not on the rows beside it.
// - Persistent teams, the next row in flight. The grid is at most
//   kBlocksPerSM blocks for each of the H100's 132 SMs (what the launch
//   bounds keep resident); team k of all teams takes rows k, k + teams, ...
//   and loads its next row's x and g before it reduces and stores the
//   current one. No block barrier a row. Two blocks of 8 warps an SM: at
//   three the registers spill, and one vector a lane, two rows ahead or
//   more blocks ran slower at the training shape (chip_smoke.py
//   --rmsnorm-bwd-breakdown).
// - dscale: each lane adds its rows' g * xhat in row order in registers; a
//   block adds its teams' shares in team order into one fp32 partial row; a
//   second kernel of D / 8 blocks adds the partial rows of an 8-column strip:
//   32 row lanes each take every 32nd partial row in order (all of a lane's
//   loads in flight at once), then the 32 lane sums in lane order. The TPU
//   kernel carried the sum in a block along its sequential grid; Hopper
//   blocks run in parallel, hence the partial rows. The grid, and so the
//   sum order, is a function of rows and D alone. The merge pass costs
//   ≈ 0.0035 ms at the training shape (--rmsnorm-bwd-breakdown, "merge
//   pass cut out"); launching it as a programmatic dependent of the row
//   kernel, its start overlapping the row kernel's end, gained nothing
//   measurable on the H100 and is left out.
// - No atomics: two runs give the same bits; the merge writes every column,
//   so dscale needs no zeroing.
//
// This header holds the kernels and their launch, templated on the element
// types; rmsnorm_bwd.cu (bf16 and fp32 forms) and rmsnorm_bwd_f16.cu (fp16 x
// and weight) instantiate them, each compiled by its own nvcc. Its helpers sit
// in an anonymous namespace: each unit has its own copy.
#pragma once

#include "norm_fwd.cuh"

namespace {

using dst::norm::Vec;

constexpr int kLaneVecs = 2;    // 16-byte vectors a lane holds of a row (twice past 16 warps)
constexpr int kRowsAhead = 1;   // rows a team has in flight beyond the one it reduces
constexpr int kBlockWarps = 8;  // warps of a block (of a team of 16: 16)
constexpr int kSMs = 132;       // the H100's SMs: the grid's cap is per SM
constexpr int kMergeCols = 8;   // columns of a merge block's strip
constexpr int kMergeLanes = 32; // row lanes of a merge block

template <int kRowWarps, int kVec>
struct Plan {
  static constexpr int kWarps = kRowWarps > kBlockWarps ? kRowWarps : kBlockWarps;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kTeams = kWarps / kRowWarps;  // rows a block holds
  static constexpr int kTeamVecs = 32 * kRowWarps;  // vectors a pass of the team covers
  static constexpr int kSlabs = kRowWarps * kVec;
  // blocks an SM the launch bounds keep resident, and so the grid's cap
  static constexpr int kBlocksPerSM = kThreads <= 256 ? 2 : 1;
  static constexpr int kMaxBlocks = kSMs * kBlocksPerSM;
  static constexpr int kAhead = kVec <= kLaneVecs ? kRowsAhead : 0;  // wider lanes: registers
};

// The row's two sums from each lane's partials of its slabs i: every slab's
// warp tree, then the nslab slab sums in slab order. buf: kSlabs float2 of
// shared memory only this team uses (by row parity: a buffer is written
// again only after another reduction of the team, which every reader of it
// has passed).
template <int kRowWarps, int kVec>
__device__ __forceinline__ float2 row_sum2(float2 (&part)[kVec], float2* buf, int nslab,
                                           int team, int wt) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      part[i].x += __shfl_xor_sync(0xffffffffu, part[i].x, o);
      part[i].y += __shfl_xor_sync(0xffffffffu, part[i].y, o);
    }
  }
  float2 t = make_float2(0.f, 0.f);
  if constexpr (kRowWarps == 1) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {  // slab i: zero past nslab
      t.x += part[i].x;
      t.y += part[i].y;
    }
  } else {
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) buf[i * kRowWarps + wt] = part[i];
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(kRowWarps * 32) : "memory");
#pragma unroll
    for (int k = 0; k < kRowWarps * kVec; ++k) {
      if (k < nslab) {
        t.x += buf[k].x;
        t.y += buf[k].y;
      }
    }
  }
  return t;
}

template <typename T, typename W, int kRowWarps, int kVec>
__global__ void __launch_bounds__(Plan<kRowWarps, kVec>::kThreads,
                                  Plan<kRowWarps, kVec>::kBlocksPerSM)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       const T* __restrict__ g, T* __restrict__ dx,
                       float* __restrict__ dscale_part, int rows, int D, float eps) {
  using P = Plan<kRowWarps, kVec>;
  constexpr int N = 16 / sizeof(T);
  using XV = Vec<T, N>;
  using WV = Vec<W, N>;
  __shared__ float2 red[P::kTeams][2][P::kSlabs];
  // the block's teams past the first: their dscale shares for the team merge
  __shared__ __align__(16) float merge[P::kTeams > 1 ? (P::kTeams - 1) * P::kTeamVecs * kVec * N
                                                     : 1];
  const int nvec = D / N;
  const float fd = static_cast<float>(D);
  const int tid = threadIdx.x;
  const int team = tid / P::kTeamVecs;
  const int wt = (tid / 32) % kRowWarps;  // the warp's place in its team
  const int lt = tid % P::kTeamVecs;      // the thread's place in its team
  const int stride = gridDim.x * P::kTeams;  // teams of the grid
  const int nslab = (nvec + 31) / 32;

  const WV* wr = reinterpret_cast<const WV*>(w);
  WV wv[kVec];
  float acc[kVec][N];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = lt + i * P::kTeamVecs;
    if (vi < nvec) wv[i] = wr[vi];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
  }
  auto load = [&](int row, XV (&ax)[kVec], XV (&ag)[kVec]) {
    const size_t base = static_cast<size_t>(row) * D;
    const XV* xr = reinterpret_cast<const XV*>(x + base);
    const XV* gr = reinterpret_cast<const XV*>(g + base);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lt + i * P::kTeamVecs;
      if (vi < nvec) {
        ax[i] = xr[vi];
        ag[i] = gr[vi];
      }
    }
  };

  // rows r + stride * a, a <= kAhead, in flight: buffer a holds row r + stride * a
  XV px[P::kAhead + 1][kVec], pg[P::kAhead + 1][kVec];
  int r = blockIdx.x * P::kTeams + team;
#pragma unroll
  for (int a = 0; a < P::kAhead; ++a) {
    if (r + a * stride < rows) load(r + a * stride, px[a], pg[a]);
  }
  int parity = 0;
  for (; r < rows; r += stride) {
    // the row kAhead turns on goes out before this row's sums
    if (r + P::kAhead * stride < rows) load(r + P::kAhead * stride, px[P::kAhead], pg[P::kAhead]);
    float2 part[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      part[i] = make_float2(0.f, 0.f);
      if (lt + i * P::kTeamVecs >= nvec) continue;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xf = dst::to_float(px[0][i].v[j]);
        part[i].x += xf * xf;
        part[i].y += dst::to_float(pg[0][i].v[j]) * dst::to_float(wv[i].v[j]) * xf;
      }
    }
    const float2 t = row_sum2<kRowWarps, kVec>(part, red[team][parity], nslab, team, wt);
    parity ^= 1;
    const float rstd = rsqrtf(t.x / fd + eps);
    const float dot = t.y * rstd / fd;  // mean(gs * xhat) = rstd * sum(g w x) / D
    XV* dxr = reinterpret_cast<XV*>(dx + static_cast<size_t>(r) * D);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lt + i * P::kTeamVecs;
      if (vi >= nvec) continue;
      XV o;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float gf = dst::to_float(pg[0][i].v[j]);
        const float xhat = dst::to_float(px[0][i].v[j]) * rstd;
        o.v[j] = dst::from_float<T>(rstd * (gf * dst::to_float(wv[i].v[j]) - xhat * dot));
        acc[i][j] += gf * xhat;
      }
      dxr[vi] = o;
    }
#pragma unroll
    for (int a = 0; a < P::kAhead; ++a) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        px[a][i] = px[a + 1][i];
        pg[a][i] = pg[a + 1][i];
      }
    }
  }

  // one partial row a block: its teams' shares added in team order
  float* part_row = dscale_part + static_cast<size_t>(blockIdx.x) * D;
  if constexpr (P::kTeams > 1) {
    if (team > 0) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int vi = lt + i * P::kTeamVecs;
        if (vi >= nvec) continue;
#pragma unroll
        for (int j = 0; j < N; ++j) merge[(team - 1) * D + vi * N + j] = acc[i][j];
      }
    }
    __syncthreads();
  }
  if (team == 0) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lt + i * P::kTeamVecs;
      if (vi >= nvec) continue;
#pragma unroll
      for (int j = 0; j < N; j += 4) {
        float4 s = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
#pragma unroll
        for (int k = 1; k < P::kTeams; ++k) {
          const float4 m = *reinterpret_cast<const float4*>(merge + (k - 1) * D + vi * N + j);
          s.x += m.x;
          s.y += m.y;
          s.z += m.z;
          s.w += m.w;
        }
        *reinterpret_cast<float4*>(part_row + vi * N + j) = s;
      }
    }
  }
}

// dscale[c] = the sum over blocks of their partial rows: row lane l adds
// rows l, l + 32, ... in order (up to kBatch loads in flight: every row of a
// grid of 512 blocks at once), then the 32 lane sums in lane order (fixed
// order: the same inputs give the same bits). Every column is written; no
// partial rows give zeros.
__global__ void __launch_bounds__(kMergeCols * kMergeLanes)
    merge_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                          int nblocks, int D) {
  __shared__ float lanes[kMergeLanes][kMergeCols];
  const int col = threadIdx.x % kMergeCols;
  const int lane = threadIdx.x / kMergeCols;
  const int c = blockIdx.x * kMergeCols + col;
  float v = 0.f;
  if (c < D) {
    constexpr int kBatch = 16;
    for (int b0 = lane; b0 < nblocks; b0 += kBatch * kMergeLanes) {
      float u[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int b = b0 + k * kMergeLanes;
        u[k] = b < nblocks ? part[static_cast<size_t>(b) * D + c] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (b0 + k * kMergeLanes < nblocks) v += u[k];
      }
    }
  }
  lanes[lane][col] = v;
  __syncthreads();
  if (lane == 0 && c < D) {
    float t = lanes[0][col];
#pragma unroll
    for (int l = 1; l < kMergeLanes; ++l) t += lanes[l][col];
    out[c] = t;
  }
}

// Vectors of a row -> (warps a team, vectors a lane): kLaneVecs a lane on
// 1-16 warps, twice that on 16 past them; 0 warps: too wide.
int2 plan_of(int nvec) {
  for (int rw = 1; rw <= 16; rw *= 2) {
    if (nvec <= 32 * rw * kLaneVecs) return make_int2(rw, kLaneVecs);
  }
  return make_int2(nvec <= 32 * 16 * 2 * kLaneVecs ? 16 : 0, 2 * kLaneVecs);
}

template <int kRowWarps, int kVec>
int blocks_for(int rows) {
  using P = Plan<kRowWarps, kVec>;
  const int want = (rows + P::kTeams - 1) / P::kTeams;
  return want < P::kMaxBlocks ? want : P::kMaxBlocks;
}

int blocks_for(int rows, int nvec) {
  if (rows <= 0) return 0;
  constexpr int V = kLaneVecs;
  const int2 plan = plan_of(nvec);
  switch (plan.x) {
    case 1: return blocks_for<1, V>(rows);
    case 2: return blocks_for<2, V>(rows);
    case 4: return blocks_for<4, V>(rows);
    case 8: return blocks_for<8, V>(rows);
    case 16: return plan.y == V ? blocks_for<16, V>(rows) : blocks_for<16, 2 * V>(rows);
    default: return 0;
  }
}

template <typename T, typename W, int kRowWarps, int kVec>
cudaError_t launch_rows(const T* x, const W* w, const T* g, T* dx, float* part, int rows,
                        int D, float eps, cudaStream_t stream) {
  rmsnorm_bwd_kernel<T, W, kRowWarps, kVec>
      <<<blocks_for<kRowWarps, kVec>(rows), Plan<kRowWarps, kVec>::kThreads, 0, stream>>>(
          x, w, g, dx, part, rows, D, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* xv, const void* wv, const void* gv, void* dxv, void* partv,
           void* dscale, int rows, int D, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  if (D <= 0) return static_cast<int>(cudaGetLastError());
  if (D % N != 0 || plan_of(D / N).x == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = D / N;
  const T* x = static_cast<const T*>(xv);
  const W* w = static_cast<const W*>(wv);
  const T* g = static_cast<const T*>(gv);
  T* dx = static_cast<T*>(dxv);
  float* part = static_cast<float*>(partv);
  constexpr int V = kLaneVecs;
  const int2 plan = plan_of(nvec);
  cudaError_t err = cudaSuccess;
  if (rows > 0) {
    switch (plan.x) {
      case 1: err = launch_rows<T, W, 1, V>(x, w, g, dx, part, rows, D, eps, stream); break;
      case 2: err = launch_rows<T, W, 2, V>(x, w, g, dx, part, rows, D, eps, stream); break;
      case 4: err = launch_rows<T, W, 4, V>(x, w, g, dx, part, rows, D, eps, stream); break;
      case 8: err = launch_rows<T, W, 8, V>(x, w, g, dx, part, rows, D, eps, stream); break;
      default:
        err = plan.y == V ? launch_rows<T, W, 16, V>(x, w, g, dx, part, rows, D, eps, stream)
                          : launch_rows<T, W, 16, 2 * V>(x, w, g, dx, part, rows, D, eps, stream);
        break;
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_partials_kernel<<<(D + kMergeCols - 1) / kMergeCols, kMergeCols * kMergeLanes, 0,
                          stream>>>(part, static_cast<float*>(dscale), blocks_for(rows, nvec),
                                    D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
