// Weight-only int8/int4 matvec: y[M, N] = x[M, D] . dequant(q, s), fp32
// accumulation, y in x's dtype (bf16 or fp16).
//
// Replaces deepspeed_tpu/ops/pallas/quantized_matmul.py:_kernel (line 38),
// reached through _packed_matvec (line 89) from packed_proj (line 436), and
// its per-expert use: _packed_expert_matvec_local (line 330, from
// packed_expert_proj, line 391) launches it once per expert of an MoE bank.
// Here one launch covers every expert: blockIdx.z is the expert, and each
// expert's rows, weight, scales and output sit at a fixed stride
// (dst_quantized_expert_matvec). The split plan is that of one expert's
// weight and the fold order is per expert, so each expert's rows are bitwise
// what the 2-D call gives on that expert alone.
//
// Layout (ops/quantizer.py, byte-identical to the JAX package, read as it
// is): the contraction dim D = G * Bq is cut into G blocks of Bq rows (Bq =
// 128, or D when D % 128 != 0); qdata int8 [G, Bq, N]; scale fp32 [G, 1, N].
// int4 with an even G packs two values a byte, split-half: byte plane p <
// G/2 holds block p in its low nibble, ((b & 15) ^ 8) - 8, and block p + G/2
// in its high nibble, the arithmetic b >> 4 (the TPU kernel's _kernel:58-77).
//
// Bound on the H100: bytes. Every weight byte is read once (D * N bytes int8,
// D * N / 2 int4, plus 4 * G * N bytes of scales; Llama-3-8B's wi is 58.7 MB
// + 1.8 MB, 18 us at 3.35 TB/s); x and y are a few KB. At 3.35 TB/s an SM
// must take in about 14.5 weight bytes a clock, so every instruction spent on
// a weight counts. Design:
//
// - Tensor cores. y^T = W^T . x^T on mma.sync m16n8k16 (x's type in, bf16 or
//   fp16, fp32 accumulate): 16 weight columns are the A tile's rows, x's rows the B
//   tile's 8 columns (zeros past M). Every M from 1 to 16 runs the same
//   instruction, one per 8 rows of x (a second only for M > 8), and an
//   output element depends on its own A row and B column alone, so a row's
//   bits never depend on how many rows the call holds (a speculative verify
//   window's projections equal single-token decode). wgmma wants 64-row
//   tiles from a warpgroup, more than a 128-column strip feeds one warp.
// - No int->float converts. A lane takes 16 bytes (16 columns) of four
//   contraction rows of a step; a byte permute puts the same column of two
//   rows into the two halves of a register, and a magic exponent makes it
//   bf16: int8 as (0x4300 | (b & 0x7f)) - (0x4300 | (b & 0x80)), i.e. 128 +
//   (b & 127) minus 128 or 256; int4 as (0x4300 | (n ^ 8)) - 136. In fp16
//   the magic is 1024 (0x6400, an fp16 whose ulp is 1): int8
//   as (0x6400 | (b & 0x7f)) - (0x6400 | (b & 0x80)), int4 as (0x6400 |
//   (n ^ 8)) - 1032. One lop3 or two and one bf16x2 (fp16x2) subtract a
//   pair; every value is exact in either type. The
//   lane's 16 bytes feed eight A tiles (two columns each: A row g is column
//   16g + 2T, row g + 8 is 16g + 2T + 1 of tile T); its rows are A's columns
//   2t, 2t + 1, 2t + 8, 2t + 9 in their natural order, so x's fragment is two
//   4-byte pairs of one row of x.
// - The fold is (x . q) . s. Each Bq-row group's product goes into a zeroed
//   fp32 accumulator, which is then scaled by s[g, n] and added to the
//   running sum by one fused multiply-add, group after group (int4: the
//   plane's low block, then its high block). The products x . q are exact in
//   fp32. The TPU kernel folds x . (q . s) (quantized_matmul.py:47-58) because
//   post-dot scaling was slower on v5e, a TPU reason.
// - Streaming by TMA. A block has 4 warps on one 128-column strip; warp w
//   takes the byte planes p0 + w, p0 + w + 4, ... of its block's split,
//   16 rows a step. Each warp feeds its own ring of 3 stages: lane 0 asks
//   the TMA unit for the step's [16 rows x 128 bytes] box of the weight
//   (one tensor-map copy, 128-byte swizzle, so the lanes' 16-byte reads hit
//   8 distinct bank groups a quarter warp), x's [M rows x 16] box of each
//   block the plane holds and, at a plane's first step, its scales, all
//   counted on the stage's mbarrier; the warp refills a stage as soon as it
//   holds it in registers, after a fence.proxy.async (without it, a
//   register-starved build let the scheduler move the stage's reads past the
//   refill: wrong sums). A grid of fewer blocks than the card has SMs (the
//   narrow leaves, wk/wv: 64 blocks) starts sooner on per-thread cp.async:
//   each lane copies its own four 16-byte rows, x fragments and a 16-byte
//   share of the scales into lane-private slots, into the same fragments,
//   so a row's bits do not depend on the path. Tried on the H100 and
//   slower: per-thread copies on the larger grids (the load path, not the
//   arithmetic, held them back), a TMA copy per 128-byte row and a producer
//   warp feeding four consumers (too many small copies), rings deeper than
//   3 stages (fewer blocks an SM), clusters of 16. `chip_smoke.py
//   --matvec-breakdown` times this kernel with its arithmetic cut out (the
//   load path alone), at other ring depths and with one load path for all.
// - Split-K in one launch. Where the strips alone do not fill the card, the
//   planes are split over the blocks of a thread-block cluster (grid y, at
//   most 8). After the loop each block puts its warps' sums in shared memory;
//   after cluster.sync() each block adds, for a slice of the outputs, the
//   splits in rank order (each split its warps in order) through distributed
//   shared memory and writes y. No scratch in device memory, no second
//   kernel, no atomics: reruns are bitwise equal. The plan (splits, planes a
//   split) depends on the weight's shape alone, never on M. y is rounded to
//   nearest in x's type: an fp16 y past 65,504 is inf, as the TPU kernel's
//   astype (quantized_matmul.py:85).
// - Expert-skip. A block of a bank whose rows of x over its split's
//   contraction range are all zero (by value: -0.0 is zero) streams none of
//   its bytes and contributes +0: exact, since its partial would be +-0 (a
//   2-D call, whose rows are tokens', skips the test). An MoE step's
//   einsum dispatch gives an unrouted expert all-zero rows, so a B=1 Mixtral
//   decode step reads 2 of its 8 experts' banks.
//
// This header holds the kernel, templated on x's type T (__nv_bfloat16 or
// __half), and the C entry's body (matvec_entry<T>); quantized_matvec.cu
// (bf16) and quantized_matvec_f16.cu (fp16) instantiate it, each compiled by
// its own nvcc. Its helpers sit in an anonymous namespace: each unit has its
// own copy.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "flash_attention_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;         // warps of a block, each on its own byte planes
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;        // columns of a block's strip (each warp's too)
constexpr int kStep = 16;         // contraction rows of one mma step (a TMA box)
constexpr int kTiles = 8;         // 16-column A tiles a step of a warp
constexpr int kRing = 3;          // stages of each warp's ring
constexpr int kMaxRows = 16;
constexpr int kMaxSplits = 8;     // blocks of a cluster (the portable maximum)
constexpr int kSms = 132;         // the H100's SMs: a grid this large streams by TMA

// Shared memory of a block, by the rows of x it holds (MH halves of 8) and
// whether bytes hold nibble pairs. Per warp, for each of its kRing stages:
// the step's [16 rows][128 bytes] weight box as TMA writes it with the
// 128-byte swizzle (16-byte chunk c of row r at r * 128 + 16 * (c ^ (r % 8)),
// 1024-byte aligned, the swizzle's period); then x's [kSub][16 rows][16] T
// boxes of each stage (rows past M stay zero); then kRing scale slots
// ([kSub][kCols] fp32, a plane's scales, filled with its first step; plane
// j in slot j % kRing, so a slot is refilled at least (kRing - 1) * Bq / 16
// >= kRing - 1 steps after its plane's fold). The per-thread path keeps the
// same areas with its lanes' own slots: a stage's weights as [4 rows][32
// lanes] x 16 bytes, x as [kSub * MH][2][32 lanes] x 4 bytes. After the loop
// the same bytes hold the warps' sums, red [kWarps][MH * 8][kCols] fp32.
template <int MH, bool NIB>
struct Layout {
  static constexpr int kSub = NIB ? 2 : 1;
  static constexpr int kWBytes = kStep * kCols;              // a stage's weight box
  static constexpr int kXBytes = kSub * kMaxRows * kStep * 2;  // a stage's x boxes
  static constexpr int kScale = kSub * kCols * 4;            // a plane's scales
  static constexpr int kX = kRing * kWBytes;                 // offsets in a warp's part
  static constexpr int kScales = kX + kRing * kXBytes;
  static constexpr int kWarpBytes = kScales + kRing * kScale;
  static constexpr int kRed = kWarps * MH * 8 * kCols * 4;
  static constexpr int kBytes = kWarps * kWarpBytes > kRed ? kWarps * kWarpBytes : kRed;
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base to 1024
  static_assert(kWarpBytes % 1024 == 0, "every weight box 1024-byte aligned");
};

// What a launch reads: the weight as bytes [E * Gp * Bq rows, N] in boxes of
// 16 rows x 128 bytes (128-byte swizzle); x as T [E * M rows, D] in boxes of
// 16 values x M rows.
template <typename T>
struct Params {
  CUtensorMap wmap;
  CUtensorMap xmap;
  const T* x;
  const int8_t* q;
  const float* s;
  T* out;
  int E, M, D, N, Gp, Bq, per;
};

using dst::sm90::mbar_arrive_expect_tx;
using dst::sm90::mbar_fence_init;
using dst::sm90::mbar_init;
using dst::sm90::mbar_wait;
using dst::sm90::smem_addr;

// The box at (c0, c1) of a 2-D tensor map into shared memory, counted on the
// barrier in bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes from device memory into shared memory by the TMA
// unit, counted on the barrier (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 (or 4) bytes from device memory into shared memory by this thread,
// asynchronously; 4 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += A . B on the tensor cores, T (bf16 or fp16) in, fp32 out
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

// a - b on two T values at once (exact here: every result fits)
template <typename T>
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&a),
                        *reinterpret_cast<const __half2*>(&b));
    return *reinterpret_cast<uint32_t*>(&r);
  } else {
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                               *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<uint32_t*>(&r);
  }
}

// The magic exponent of T in both halves: 128 in bf16 (0x4300), 1024 in fp16
// (0x6400), each a power of two whose ulp is 1
template <typename T>
__device__ __forceinline__ constexpr uint32_t magic() {
  return std::is_same<T, __half>::value ? 0x64006400u : 0x43004300u;
}

// Byte `b` of lo and of hi in the low bytes of the two halves.
template <int b>
__device__ __forceinline__ uint32_t pair_bytes(uint32_t lo, uint32_t hi) {
  constexpr uint32_t sel = b | (b << 4) | ((4 + b) << 8) | ((4 + b) << 12);
  return __byte_perm(lo, hi, sel);
}

// Two signed int8 (the low bytes of each half of p) as a T pair: magic +
// (b & 127) less magic + (b & 128).
template <typename T>
__device__ __forceinline__ uint32_t int8_pair(uint32_t p) {
  return sub2<T>((p & 0x007f007fu) | magic<T>(), (p & 0x00800080u) | magic<T>());
}

// Two int4 nibbles (bits 0-3 of each half of p, stored as (v + 8) ^ 8) as a
// T pair: magic | (n ^ 8) less magic + 8 (bf16 0x4308 = 136, fp16 0x6408 =
// 1032).
template <typename T>
__device__ __forceinline__ uint32_t int4_pair(uint32_t p) {
  constexpr uint32_t m8 = magic<T>() | 0x00080008u;
  return sub2<T>((p & 0x000f000fu) ^ m8, m8);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// XT: x's and y's type (bf16 or fp16); MH: 8-row halves of x held (1 for M
// <= 8, 2 for M <= 16); NIB: int4 pairs;
// TMA: the weight streams as tensor-map boxes, else by per-thread cp.async
// (the same fragments either way, so the same bits). Grid (N / kCols,
// splits, E), cluster (1, splits, 1).
template <typename XT, int MH, bool NIB, bool TMA>
__global__ void __launch_bounds__(kThreads) quantized_matvec_kernel(
    const __grid_constant__ Params<XT> prm) {
  using L = Layout<MH, NIB>;
  constexpr int kSub = L::kSub;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kWarps][kRing];  // a stage's boxes landed
  cg::cluster_group cluster = cg::this_cluster();
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  const int M = prm.M, D = prm.D, N = prm.N, Gp = prm.Gp, Bq = prm.Bq;

  // this block's expert: its slice of every array (expert 0 of a 2-D call)
  const int e = blockIdx.z;
  const XT* x = prm.x + (size_t)e * M * D;
  const float* s = prm.s + (size_t)e * kSub * Gp * N;
  XT* out = prm.out + (size_t)e * M * N;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int col0 = blockIdx.x * kCols;
  const int p0 = blockIdx.y * prm.per;
  const int p1 = min(Gp, p0 + prm.per);

  unsigned char* wbase = smem + warp * L::kWarpBytes;
  if (TMA && lane == 0) {
    if (warp == 0) {  // the maps' descriptors, fetched while the block sets up
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&prm.wmap) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&prm.xmap) : "memory");
    }
#pragma unroll
    for (int st = 0; st < kRing; ++st) mbar_init(smem_addr(&bars[warp][st]), 1);
    mbar_fence_init();
  }
  // the rows of x past M are zeros in every stage: no box writes them
  for (int i = lane; TMA && i < kRing * kSub * (kMaxRows - M) * 2; i += 32) {
    const int row = i / 2;  // (stage and sub, m - M)
    const int box = row / (kMaxRows - M);
    const int m = M + row % (kMaxRows - M);
    reinterpret_cast<uint4*>(wbase + L::kX + box * kMaxRows * kStep * 2 + m * kStep * 2)[i % 2] =
        make_uint4(0, 0, 0, 0);
  }

  // Expert-skip: is every row of x zero over this split's contraction range?
  // (asked of an expert bank only: a 2-D call's rows of x are a token's)
  bool nonzero = prm.E == 1;
  if (prm.E > 1) {
    const int chunks = (p1 - p0) * Bq / 8;  // 16-byte chunks of a row, a block
    for (int i = tid; i < M * kSub * chunks; i += kThreads) {
      const int m = i / (kSub * chunks);
      const int rest = i - m * kSub * chunks;
      const int sub = rest / chunks;
      const int c = rest - sub * chunks;
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + (size_t)m * D + (size_t)(p0 + sub * Gp) * Bq + c * 8);
      nonzero |= ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) != 0u;
    }
  }
  const bool any = __syncthreads_or(nonzero);
  const int planes = any && p0 + warp < p1 ? (p1 - p0 - warp + kWarps - 1) / kWarps : 0;
  const int KS = Bq / kStep;
  const int total = planes * KS;

  // A lane's 16 columns 16 g .. 16 g + 15 of the strip and its contraction
  // rows 2t, 2t + 1, 2t + 8, 2t + 9 of a step (A columns in order)
  const int g = lane >> 2;
  const int t = lane & 3;

  // The next step to issue, in order (plane p0 + warp + 4 ipi, rows iks * 16
  // ..), into stage ist: the step's weight rows, x's values of each block the
  // plane holds and, at a plane's first step, its scales into slot islot.
  // TMA: lane 0 asks for the weight box, the x boxes and the scales, counted
  // on the stage's barrier. cp.async: every lane copies its own 4 weight
  // rows and x fragments (lane-private slots, so no other lane waits on
  // them) and 16 bytes of the scales (read by the warp after a __syncwarp).
  int ipi = 0, iks = 0, ist = 0, islot = 0;
  auto issue = [&]() {
    const int p = p0 + warp + kWarps * ipi;
    if constexpr (TMA) {
      const uint32_t bar = smem_addr(&bars[warp][ist]);
      // the warp's reads of the stage (generic proxy, ordered before this
      // lane by __syncwarp) come before the TMA's writes into it (async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive_expect_tx(bar, kStep * kCols + kSub * M * kStep * 2 +
                                     (iks == 0 ? kSub * kCols * 4 : 0));
      tma_load_2d(smem_addr(wbase + ist * L::kWBytes), &prm.wmap, bar, col0,
                  (e * Gp + p) * Bq + iks * kStep);
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
        tma_load_2d(smem_addr(wbase + L::kX + ist * L::kXBytes + sub * kMaxRows * kStep * 2),
                    &prm.xmap, bar, (p + sub * Gp) * Bq + iks * kStep, e * M);
      }
      if (iks == 0) {
        unsigned char* slot = wbase + L::kScales + islot * L::kScale;
#pragma unroll
        for (int sub = 0; sub < kSub; ++sub) {
          bulk_copy(smem_addr(slot + sub * kCols * 4), s + (size_t)(p + sub * Gp) * N + col0,
                    kCols * 4, bar);
        }
      }
    } else {
      const int8_t* src = prm.q + ((size_t)(e * Gp + p) * Bq + iks * kStep) * N + col0 + 16 * g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 2 * t + (j & 1) + 8 * (j >> 1);
        cp_async_16(smem_addr(wbase + ist * L::kWBytes + j * 512 + lane * 16),
                    src + (size_t)r * N);
      }
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          const int m = g + 8 * h;
          const bool valid = m < M;
          const XT* xs =
              x + (valid ? (size_t)m * D + (size_t)(p + sub * Gp) * Bq + iks * kStep + 2 * t : 0);
          unsigned char* dst = wbase + L::kX + ist * L::kXBytes + (sub * MH + h) * 256 + lane * 4;
          cp_async_4(smem_addr(dst), xs, valid);
          cp_async_4(smem_addr(dst + 128), xs + (valid ? 8 : 0), valid);
        }
      }
      if (iks == 0) {
        unsigned char* slot = wbase + L::kScales + islot * L::kScale;
#pragma unroll
        for (int sub = 0; sub < kSub; ++sub) {
          cp_async_16(smem_addr(slot + sub * kCols * 4 + lane * 16),
                      s + (size_t)(p + sub * Gp) * N + col0 + 4 * lane);
        }
      }
    }
    if (++iks == KS) {
      iks = 0;
      ++ipi;
      if (++islot == kRing) islot = 0;
    }
    if (++ist == kRing) ist = 0;
  };

  float acc[kSub][kTiles][MH][4];
  float sum[kTiles][MH][4];
#pragma unroll
  for (int T = 0; T < kTiles; ++T) {
#pragma unroll
    for (int h = 0; h < MH; ++h) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[T][h][c] = 0.f;
    }
  }
  if constexpr (TMA) {
    if (lane == 0) {
      for (int i = 0; i < kRing && i < total; ++i) issue();
    }
  } else {
    for (int i = 0; i < kRing; ++i) {  // a group a step, empty past the last
      if (i < total) issue();
      cp_async_commit();
    }
  }
  int st = 0, slot = 0, ks = 0;  // stage, scale slot, step in the plane
  uint32_t phase = 0;
  for (int i = 0; i < total; ++i) {
    if constexpr (TMA) {
      mbar_wait(smem_addr(&bars[warp][st]), phase);
    } else {
      cp_async_wait<kRing - 1>();  // this lane's copies of step i landed
    }
    if (ks == 0) {
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
#pragma unroll
        for (int T = 0; T < kTiles; ++T) {
#pragma unroll
          for (int h = 0; h < MH; ++h) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[sub][T][h][c] = 0.f;
          }
        }
      }
    }
    const unsigned char* wb = wbase + st * L::kWBytes;
    const unsigned char* xbase = wbase + L::kX + st * L::kXBytes;
    uint4 w[4];  // rows 2t, 2t + 1, 2t + 8, 2t + 9
    // x fragment: row g + 8 h, contraction values 2t, 2t + 1 and 2t + 8, 2t + 9
    uint32_t xb[kSub][MH][2];
    if constexpr (TMA) {  // a quarter warp's chunks of the swizzled box in 8 banks
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 2 * t + (j & 1) + 8 * (j >> 1);
        w[j] = *reinterpret_cast<const uint4*>(wb + r * kCols + 16 * (g ^ (r & 7)));
      }
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          const uint32_t* xr = reinterpret_cast<const uint32_t*>(
              xbase + (sub * kMaxRows + g + 8 * h) * kStep * 2);
          xb[sub][h][0] = xr[t];
          xb[sub][h][1] = xr[4 + t];
        }
      }
    } else {  // the lane's own slots
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = *reinterpret_cast<const uint4*>(wb + j * 512 + lane * 16);
      }
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          const unsigned char* xr = xbase + (sub * MH + h) * 256 + lane * 4;
          xb[sub][h][0] = *reinterpret_cast<const uint32_t*>(xr);
          xb[sub][h][1] = *reinterpret_cast<const uint32_t*>(xr + 128);
        }
      }
    }
    // the stage is in registers: refill it now, or at a plane's last step
    // after the fold, which still reads the plane's scale slot (cp.async: a
    // group every step, empty when nothing is left to ask for)
    __syncwarp();
    if (ks != KS - 1) {
      if (TMA ? lane == 0 && i + kRing < total : i + kRing < total) issue();
      if (!TMA) cp_async_commit();
    }
#pragma unroll
    for (int T = 0; T < kTiles; ++T) {
      const int wi = T >> 1;
      const uint32_t r0 = word(w[0], wi), r1 = word(w[1], wi);
      const uint32_t r2 = word(w[2], wi), r3 = word(w[3], wi);
      // bytes 2T % 4 (column 16 g + 2T) and the next (column 16 g + 2T + 1)
      uint32_t p01a, p01b, p23a, p23b;
      if (T & 1) {
        p01a = pair_bytes<2>(r0, r1); p01b = pair_bytes<3>(r0, r1);
        p23a = pair_bytes<2>(r2, r3); p23b = pair_bytes<3>(r2, r3);
      } else {
        p01a = pair_bytes<0>(r0, r1); p01b = pair_bytes<1>(r0, r1);
        p23a = pair_bytes<0>(r2, r3); p23b = pair_bytes<1>(r2, r3);
      }
      if constexpr (NIB) {
        const uint32_t a0 = int4_pair<XT>(p01a), a1 = int4_pair<XT>(p01b);
        const uint32_t a2 = int4_pair<XT>(p23a), a3 = int4_pair<XT>(p23b);
        const uint32_t c0 = int4_pair<XT>(p01a >> 4), c1 = int4_pair<XT>(p01b >> 4);
        const uint32_t c2 = int4_pair<XT>(p23a >> 4), c3 = int4_pair<XT>(p23b >> 4);
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          mma<XT>(acc[0][T][h], a0, a1, a2, a3, xb[0][h][0], xb[0][h][1]);
          mma<XT>(acc[kSub - 1][T][h], c0, c1, c2, c3, xb[kSub - 1][h][0],
                 xb[kSub - 1][h][1]);
        }
      } else {
        const uint32_t a0 = int8_pair<XT>(p01a), a1 = int8_pair<XT>(p01b);
        const uint32_t a2 = int8_pair<XT>(p23a), a3 = int8_pair<XT>(p23b);
#pragma unroll
        for (int h = 0; h < MH; ++h) {
          mma<XT>(acc[0][T][h], a0, a1, a2, a3, xb[0][h][0], xb[0][h][1]);
        }
      }
    }
    if (ks == KS - 1) {  // fold the plane's group(s): sum += acc * s[g, n]
      // (cp.async: every lane's scale copy landed steps ago; the __syncwarp
      // above makes them all seen)
      const float* sl = reinterpret_cast<const float*>(wbase + L::kScales + slot * L::kScale);
#pragma unroll
      for (int sub = 0; sub < kSub; ++sub) {
        float sc[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(sl + sub * kCols + 16 * g + 4 * j);
          sc[4 * j] = v.x; sc[4 * j + 1] = v.y; sc[4 * j + 2] = v.z; sc[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int T = 0; T < kTiles; ++T) {
#pragma unroll
          for (int h = 0; h < MH; ++h) {
            sum[T][h][0] = __fmaf_rn(acc[sub][T][h][0], sc[2 * T], sum[T][h][0]);
            sum[T][h][1] = __fmaf_rn(acc[sub][T][h][1], sc[2 * T], sum[T][h][1]);
            sum[T][h][2] = __fmaf_rn(acc[sub][T][h][2], sc[2 * T + 1], sum[T][h][2]);
            sum[T][h][3] = __fmaf_rn(acc[sub][T][h][3], sc[2 * T + 1], sum[T][h][3]);
          }
        }
      }
      __syncwarp();
      if (TMA ? lane == 0 && i + kRing < total : i + kRing < total) issue();
      if (!TMA) cp_async_commit();
      ks = 0;
      if (++slot == kRing) slot = 0;
    } else {
      ++ks;
    }
    if (++st == kRing) {
      st = 0;
      phase ^= 1u;
    }
  }
  if constexpr (!TMA) cp_async_wait<0>();
  __syncthreads();  // every ring is drained: red may overwrite them

  // red[warp][m][n]: C fragment c0, c1 = rows (m) 2t, 2t+1 of column 16 g +
  // 2T; c2, c3 = the same rows of column 16 g + 2T + 1
  float* red = reinterpret_cast<float*>(smem);
  constexpr int kR = MH * 8;
#pragma unroll
  for (int T = 0; T < kTiles; ++T) {
#pragma unroll
    for (int h = 0; h < MH; ++h) {
      float* rw = red + (warp * kR + 8 * h + 2 * t) * kCols + 16 * g + 2 * T;
      rw[0] = sum[T][h][0];
      rw[kCols] = sum[T][h][1];
      rw[1] = sum[T][h][2];
      rw[kCols + 1] = sum[T][h][3];
    }
  }
  cluster.sync();  // every block's red is written and visible to the cluster

  // output i to rank i % splits, so every block of the cluster merges; its
  // splits' reads all in flight at once, then added in rank order
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank + splits * tid; i < M * kCols; i += splits * kThreads) {
    const int m = i / kCols;
    const int n = i - m * kCols;
    float part[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < splits) {
        const float* rs = cluster.map_shared_rank(red, sp) + m * kCols + n;
        float b = rs[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) b = __fadd_rn(b, rs[w * kR * kCols]);
        part[sp] = b;
      }
    }
    float v = part[0];
#pragma unroll
    for (int sp = 1; sp < kMaxSplits; ++sp) {
      if (sp < splits) v = __fadd_rn(v, part[sp]);
    }
    out[(size_t)m * N + col0 + n] = dst::from_float<XT>(v);
  }
  cluster.sync();  // no block leaves while another still reads its red
}

template <typename XT, int MH, bool NIB, bool TMA>
cudaError_t launch(const Params<XT>& prm, int E, int splits, cudaStream_t stream) {
  auto* kernel = quantized_matvec_kernel<XT, MH, NIB, TMA>;
  constexpr int bytes = Layout<MH, NIB>::kAlloc;
  static const cudaError_t set =  // once per instantiation and process
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(prm.N / kCols, splits, E);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, prm);
}

// The two maps of a launch (see Params); false where the driver refuses.
template <typename XT>
bool encode_maps(Params<XT>& prm, const void* x, const void* q, int E) {
  const dst::sm90::EncodeTiled fn = dst::sm90::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t estr[2] = {1, 1};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(prm.N),
                               static_cast<cuuint64_t>(E) * prm.Gp * prm.Bq};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(prm.N)};
  const cuuint32_t wbox[2] = {kCols, kStep};
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(prm.D),
                               static_cast<cuuint64_t>(E) * prm.M};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(prm.D) * 2};
  const cuuint32_t xbox[2] = {kStep, static_cast<cuuint32_t>(prm.M)};
  return fn(&prm.wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q), wdims,
            wstride, wbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         fn(&prm.xmap, dst::sm90::tma_type<XT>(), 2, const_cast<void*>(x), xdims,
            xstride, xbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The body of the C entries (quantized_matvec.cu, quantized_matvec_f16.cu):
// the checks, the maps and the launch of x's type XT.
template <typename XT>
int matvec_entry(int E, const void* x, const void* q, const void* s, void* out, int M,
                 int D, int N, int Gp, int Bq, int nibbles, int splits, int per,
                 cudaStream_t st) {
  const int G = nibbles ? 2 * Gp : Gp;
  if (E < 1 || E > 65535 || M < 1 || M > kMaxRows || N <= 0 || N % kCols != 0 ||
      Gp <= 0 || Bq <= 0 || Bq % kStep != 0 || G * Bq != D || splits < 1 ||
      splits > kMaxSplits || per < 1 || (splits - 1) * per >= Gp || splits * per < Gp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params<XT> prm;
  prm.x = static_cast<const XT*>(x);
  prm.q = static_cast<const int8_t*>(q);
  prm.s = static_cast<const float*>(s);
  prm.out = static_cast<XT*>(out);
  prm.E = E; prm.M = M; prm.D = D; prm.N = N; prm.Gp = Gp; prm.Bq = Bq; prm.per = per;
  // TMA streams a grid of at least a block an SM faster; below that, per-
  // thread copies start sooner (a function of the weight's shape alone)
  const bool tma = (long long)(N / kCols) * splits * E >= kSms;
  if (tma && !encode_maps(prm, x, q, E)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (nibbles) {
    err = M <= 8 ? (tma ? launch<XT, 1, true, true>(prm, E, splits, st)
                        : launch<XT, 1, true, false>(prm, E, splits, st))
                 : (tma ? launch<XT, 2, true, true>(prm, E, splits, st)
                        : launch<XT, 2, true, false>(prm, E, splits, st));
  } else {
    err = M <= 8 ? (tma ? launch<XT, 1, false, true>(prm, E, splits, st)
                        : launch<XT, 1, false, false>(prm, E, splits, st))
                 : (tma ? launch<XT, 2, false, true>(prm, E, splits, st)
                        : launch<XT, 2, false, false>(prm, E, splits, st));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
