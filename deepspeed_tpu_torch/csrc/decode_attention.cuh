// GQA decode attention against a KV cache: the contiguous cache, and the
// block-paged pool of the serving engine.
//
// Replaces deepspeed_tpu/ops/pallas/decode_attention.py:_decode_kernel
// (line 76) and _paged_decode_kernel (line 111), with their shared
// _tile_update (line 35), reached through decode_attention_kernel (line 160)
// and paged_decode_attention_kernel (line 243) from decode_attention
// (line 323): the dense form over a bf16 or fp16 (or fp32) cache, and the
// int8 form (has_scales=True) over an int8 cache with one fp32 scale per
// (token, kv head), each over a contiguous cache or through per-sequence page
// tables. Under fp16 queries the cache may also be bf16 (kv_cache_dtype="bf16"
// on an fp16 engine, the "mixed" form): each tile is converted to fp16 as it
// lands, the TPU kernel's k.astype(q.dtype) (_tile_update:44-48).
//
// out[r, h] = softmax(q[r, h] . K[s, :n, kv]^T * scale) @ V[s, :n, kv] with
// kv = h / (H / KV), s = r / rows_per_seq the sequence query row r reads, and
// n = min(cache_len[r] + 1, Smax): every position at or before the row's
// frontier is attended, as `kpos <= cache_len` in the TPU kernels. A row
// whose frontier is negative attends nothing and writes zeros (the TPU
// kernels' _finalize_out). With ALiBi slopes (BLOOM), each score is
// dot * scale - slope[h] * (frontier - pos), the key's distance from the
// row's own frontier, added before the mask and the fp32 softmax: what the TPU
// package computes for every ALiBi step after a fresh prefill, on its XLA path
// (models/decoding.py:424-438), since its Pallas decode kernel takes no slope.
// slopes == nullptr (Llama) skips the term; the score is rounded by
// __fmul_rn and the term added by __fmaf_rn, so slopes of zero give the same
// bits. rows_per_seq = R runs the serving engine's [N, W] step, W query rows
// of each slot at their own frontiers, in one launch: the TPU package runs
// that window as XLA's masked softmax, row by row the same function.
//
// Paged form: key position p of sequence s lives in physical page
// page_table[s][p / page_size], row p % page_size, of the pool
// [P + 1, page_size, KV, hd] (scales [P + 1, KV, page_size]). Only that
// address changes, so a paged cache and a contiguous cache holding the same
// bytes give the same bits.
//
// Bound on the H100: bytes. The K and V rows up to each sequence's furthest
// frontier are read once (2 * n * KV * hd * sizeof(T) per sequence, int8
// 2 * n * KV * (hd + 4), over 3.35 TB/s); the arithmetic, 4 * hd flops per
// (query head, key), is far below the tensor-core line. At the serving shapes
// that is a few MB, under 5 us, so what a launch takes is latency: how long
// its longest chain of dependent tile loads is, and how many SMs share it.
// Design, for both:
//
// - Row tiles. A block holds up to 64 query rows of one kv head: the rows of
//   one sequence (64 / G of them) times its G = H / KV query heads, so the K/V
//   tile it loads serves every row and head of the tile: a window of R rows
//   reads its sequence's K/V once per (row tile, kv head), not once per row.
//   In bf16 and fp16 the scores S = Q K^T and the update O += P V run on
//   mma.sync m16n8k16 (bf16 or fp16 in, fp32 accumulate), one warp per 16
//   query rows; wgmma's 64-row minimum does not fit a decode row's G <= 8
//   heads. bf16 puts P in as two bf16 terms, its rounding and the
//   remainder's, so P V keeps fp32's accuracy; fp16 rounds P once to fp16,
//   as the TPU kernel rounds p to the cache's dtype (_tile_update:64): 11
//   bits, 2^-12 relative, half the P V products of bf16's two terms. Each query row is masked at its own frontier (kpos < n_row); the
//   online softmax runs in base 2 on the special-function unit. Three blocks
//   share an SM (168 registers a thread). The fp32 forms (no main path; held
//   to 1e-4) keep fp32 CUDA-core arithmetic on 32-key tiles, with the same
//   schedule.
// - Split-K over a thread-block cluster. The 8 blocks of a cluster
//   (__cluster_dims__, the portable maximum) share one (row tile, kv head):
//   block s walks the 64-key tiles of absolute index t = s (mod 8) up to the
//   tile's furthest frontier, keeping an fp32 partial (m, l, acc) per query
//   row. After cluster.sync() each block merges a slice of hd / 8 output
//   columns from the 8 partials through distributed shared memory, in the
//   fixed order s = 0..7: acc_s and l_s rescaled by exp(m_s - m), one division
//   by l, zeros where l == 0. No atomics, no second launch; a 1024-key row is
//   two tiles deep instead of sixteen, and B = 1 fills 64 SMs instead of 8.
// - Loads. 16-byte cp.async copies into a two-stage ring, the second tile in
//   flight while the first is scored; positions past the tile's furthest
//   frontier arrive as zeros. A paged tile gathers its rows through the page
//   table (four 16-row pages at page_size 16), addressed like the contiguous
//   tile. The int8 forms copy the int8 rows and their scales and dequantize
//   each value once the tile has landed, float(q) * scale rounded to q's dtype
//   (the order of the TPU kernel's _tile_update:42-43), into two tiles past
//   the ring; the mixed form converts each bf16 value to fp16 in its place in
//   the ring (round to nearest even, the bytes the same size). The cache is read in
//   place through its strides: a layer of the [L, ...] cache needs no copy;
//   every cache row must start 16-byte aligned.
//
// Bits. A row's result depends on its q, its frontier and its sequence's
// bytes alone: tile size, cluster size and tile ownership are compile-time
// constants over absolute key positions; a tile wholly past a row's frontier
// leaves its (m, l, acc) exactly as they were (correction 1, P = 0);
// an empty split merges with weight 0. So a window row equals the
// single-token decode at its position, paged equals contiguous, and neither
// rows_per_seq, tile-mates nor Smax move a bit. A cluster whose rows are all
// padded writes zeros and returns as a whole; every other block, with keys or
// without, reaches both cluster barriers.
//
// This header holds the kernel, templated on the query's type T (fp32, bf16
// or fp16), the cache's storage TC (T, int8_t, or bf16 under fp16 q), the
// head dim and the address policy, and the C entries' argument packing; the
// translation units decode_attention.cu (bf16 and fp32) and
// decode_attention_f16.cu (fp16: fp16, int8 and bf16 caches) instantiate it,
// each compiled by its own nvcc. Its helpers sit in an anonymous namespace:
// each unit has its own copy.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // query rows a block holds: sequence rows x G
constexpr int kSplit = 8;      // blocks of a cluster: the key tiles' owners
constexpr int kStages = 2;     // the cp.async ring
constexpr int kMaxGroup = 8;

// Everything a launch needs, passed by value. Strides are in elements.
// k/v: dense [B, Smax, KV, hd] by (k_s0 = batch, k_s1 = seq, k_sh = head);
// paged [P + 1, page_size, KV, hd] by (k_s0 = page, k_s1 = row, k_sh = head).
// ks/vs: dense [B, KV, Smax] by (ks_s0 = batch, ks_sh = head), paged
// [P + 1, KV, page_size] by (ks_s0 = page, ks_sh = head), positions
// contiguous.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  void* out;
  const int* cache_len;  // [rows], or nullptr for cache_len_scalar
  const float* slopes;   // [H] ALiBi slopes, or nullptr
  int cache_len_scalar;
  const int* page_table;  // [B, max_pages] (paged form)
  int page_size;
  int max_pages;
  int rows_per_seq;
  int tiles_per_seq;  // row tiles a sequence: ceil(rows_per_seq / (kRows / G))
  int Smax;
  int H;
  int KV;
  long long q_sb, q_sh, k_s0, k_s1, k_sh, v_s0, v_s1, v_sh;
  long long ks_s0, ks_sh, vs_s0, vs_sh;
  float scale;
};

using dst::sm90::cp_async_4;
using dst::sm90::smem_addr;

// 16 bytes from device memory into shared memory, asynchronously; zeros when
// !valid (src is then not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The B fragments of two n8 column blocks of a row-major [k][n] tile, read
// transposed: r[0], r[1] for columns n0..n0+7, r[2], r[3] for n0+8..n0+15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The B fragments of two n8 row blocks of a row-major [n][k] tile:
// r[0], r[1] for rows n0..n0+7, r[2], r[3] for n0+8..n0+15.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two adjacent bf16 (fp16) values as an mma operand register (any alignment).
__device__ __forceinline__ uint32_t pair_of(const __nv_bfloat16* p) {
  __nv_bfloat162 h;
  h.x = p[0];
  h.y = p[1];
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pair_of(const __half* p) {
  __half2 h;
  h.x = p[0];
  h.y = p[1];
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) as bf16 pairs hi + lo: hi the rounded values, lo their remainders
// rounded; 0 gives 0 and 0.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);  // +-inf past 65504
}

// 16 bytes of bf16 (eight values) as fp16, round to nearest even: the mixed
// form's conversion of a landed tile, in place.
__device__ __forceinline__ uint4 bf16x8_to_f16(uint4 v) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    const __half2 h = __floats2half2_rn(f.x, f.y);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return v;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}

// A score: dot * scale, then the ALiBi term by one fused multiply-add (a
// slope of zero adds -0: the slope-free bits).
__device__ __forceinline__ float score(float dot, float scale, bool alibi, float slope,
                                       int cl, int kpos) {
  const float s = __fmul_rn(dot, scale);
  return alibi ? __fmaf_rn(-slope, static_cast<float>(cl - kpos), s) : s;
}

// The shared-memory layout of one instantiation, in bytes.
template <typename T, typename TC, int HD>
struct Layout {
  static constexpr bool kInt8 = std::is_same<TC, int8_t>::value;
  // a 16-bit cache of another type than q's (bf16 under fp16 q): converted in
  // place as it lands
  static constexpr bool kRecast = !kInt8 && !std::is_same<TC, T>::value;
  static constexpr bool kMma = !std::is_same<T, float>::value;  // bf16, fp16
  static constexpr int kTile = kMma ? 64 : 32;             // keys a tile
  static constexpr int kLd = kMma ? HD + 8 : HD + 4;        // a K/V tile row, in T
  static constexpr int kRawLd = kInt8 ? HD + 16 : kLd;      // a ring row, in TC
  static constexpr int kChunks = HD * sizeof(TC) / 16;      // 16-byte chunks a cache row
  static constexpr int kRawTile = kTile * kRawLd * sizeof(TC);
  static constexpr int kScales = kInt8 ? kTile * 4 : 0;
  static constexpr int kStage = 2 * kRawTile + 2 * kScales;  // K, V (and scales)
  static constexpr int kTileBytes = kTile * kLd * sizeof(T);
  static constexpr int kRing = kStages * kStage + (kInt8 ? 2 * kTileBytes : 0);
  static constexpr int kAccLd = HD + 8;                     // a partial row, in floats
  static constexpr int kPart = kRows * kAccLd * 4;
  static constexpr int kMain = kRing > kPart ? kRing : kPart;  // the ring, then the partials
  static constexpr int kQ = kMma ? 0 : kRows * HD * 4;       // fp32 q rows (CUDA cores)
  static constexpr int kS = kMma ? 0 : kRows * (kTile + 1) * 4;
  // m, l, corr, merged l: kRows floats each; merge weights kRows x kSplit;
  // frontiers and visible counts of the sequence rows, and the max reduce
  static constexpr int kStats = (4 * kRows + kRows * kSplit) * 4 + 2 * kRows * 4 + 64;
  static constexpr int kBytes = kMain + kQ + kS + kStats;
  static_assert(kRawTile % 16 == 0 && kTileBytes % 16 == 0 && kStage % 16 == 0,
                "ring tiles must stay 16-byte aligned");
  static_assert(HD % kSplit == 0, "the merge splits the head dim");
  static_assert(!kRecast || (kMma && sizeof(TC) == sizeof(T)),
                "a recast tile keeps its bytes' size");
};

// The bf16 and fp16 forms (T): query rows on the tensor cores, 16 a warp.
// Thread (g, tig) of its warp holds rows 16 w + g and that + 8.
template <typename T, int HD>
struct MmaRows {
  uint32_t qa[HD / 16][4];  // the A fragments of the warp's 16 q rows
  float o[HD / 8][4];       // O accumulators, 16 x HD
  float m[2], l[2];
  int n[2], cl[2];
  float slope[2];
  bool active;  // the warp holds a query row of the tile

  __device__ __forceinline__ void init(const Args& a, const int* sN, const int* sCl,
                                       int nq, int G, int kvh, int row0, int warp,
                                       int lane) {
    const int g = lane >> 2, tig = lane & 3;
    active = warp * 16 < nq;
    const T* qp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = warp * 16 + g + 8 * h;
      const bool valid = i < nq;
      const int j = valid ? i / G : 0;
      const int head = kvh * G + (valid ? i - j * G : 0);
      n[h] = valid ? sN[j] : 0;
      cl[h] = valid ? sCl[j] : 0;
      slope[h] = (valid && a.slopes != nullptr) ? a.slopes[head] : 0.f;
      qp[h] = valid ? static_cast<const T*>(a.q) + (row0 + j) * a.q_sb +
                          head * a.q_sh
                    : nullptr;
      m[h] = -INFINITY;
      l[h] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int c = ks * 16 + tig * 2;
      qa[ks][0] = qp[0] ? pair_of(qp[0] + c) : 0u;
      qa[ks][1] = qp[1] ? pair_of(qp[1] + c) : 0u;
      qa[ks][2] = qp[0] ? pair_of(qp[0] + c + 8) : 0u;
      qa[ks][3] = qp[1] ? pair_of(qp[1] + c + 8) : 0u;
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }

  // Fold the 64-key tile t (K and V at kt, vt, row stride HD + 8) into the
  // warp's rows.
  __device__ __forceinline__ void update(const T* kt, const T* vt, int t, float scale,
                                         bool alibi, int lane) {
    if (!active) return;
    const int g = lane >> 2, tig = lane & 3;
    constexpr int kLd = HD + 8;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // S = Q K^T: K's B fragments by ldmatrix, two key blocks of 8 a load
    const int krow = (lane & 7) + (lane >> 4) * 8;
    const int kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(kt + (j * 8 + krow) * kLd + ks * 16 + kcol));
        dst::flash::mma_16816<T>(s[j], qa[ks], b[0], b[1]);
        dst::flash::mma_16816<T>(s[j + 1], qa[ks], b[2], b[3]);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kpos = t * 64 + j * 8 + 2 * tig + (e & 1);
        const float x = score(s[j][e], scale, alibi, slope[h], cl[h], kpos);
        s[j][e] = kpos < n[h] ? x : -INFINITY;
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    }
    // the online softmax in base 2: p = 2^((s - m) log2 e); a tile that
    // leaves a row's max where it was corrects it by exactly 1
    float mlog[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      mlog[h] = m_new == -INFINITY ? 0.f : m_new * dst::flash::kLog2e;
      corr[h] = m[h] == m_new ? 1.f : dst::sm90::fast_exp2(__fmaf_rn(m[h], dst::flash::kLog2e, -mlog[h]));
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = dst::sm90::fast_exp2(__fmaf_rn(s[j][e], dst::flash::kLog2e, -mlog[e >> 1]));
        psum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l[h] = l[h] * corr[h] + psum[h];
    }
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }
    // O += P V: P's k-step kk is score blocks 2 kk and 2 kk + 1; V's B
    // fragments come transposed from its row-major tile. bf16: P as two
    // terms hi + lo (P alone in bf16 is 2^-9 off, beyond the 1e-2 an output
    // near 4 allows). fp16: P rounded once, the TPU kernel's p.astype(v.dtype)
    // (a p below 2^-14 keeps fp16's subnormal steps of 2^-24, absolute)
    const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int vcol = (lane >> 4) * 8;
    constexpr bool kSplitP = std::is_same<T, __nv_bfloat16>::value;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[4], lo[4];
      if constexpr (kSplitP) {
        split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      } else {
        hi[0] = dst::flash::pack2<T>(s[2 * kk][0], s[2 * kk][1]);
        hi[1] = dst::flash::pack2<T>(s[2 * kk][2], s[2 * kk][3]);
        hi[2] = dst::flash::pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        hi[3] = dst::flash::pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
#pragma unroll
      for (int nd = 0; nd < HD / 16; ++nd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(vt + (kk * 16 + vrow) * kLd + nd * 16 + vcol));
        dst::flash::mma_16816<T>(o[2 * nd], hi, b[0], b[1]);
        dst::flash::mma_16816<T>(o[2 * nd + 1], hi, b[2], b[3]);
        if constexpr (kSplitP) {
          dst::flash::mma_16816<T>(o[2 * nd], lo, b[0], b[1]);
          dst::flash::mma_16816<T>(o[2 * nd + 1], lo, b[2], b[3]);
        }
      }
    }
  }

  // The warp's partials into this block's shared memory for the merge.
  __device__ __forceinline__ void store(float* sAcc, float* sM, float* sL, int warp,
                                        int lane) const {
    if (!active) return;
    const int g = lane >> 2, tig = lane & 3;
    const int i0 = warp * 16 + g;
    constexpr int kAccLd = HD + 8;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      *reinterpret_cast<float2*>(sAcc + i0 * kAccLd + c) = make_float2(o[nt][0], o[nt][1]);
      *reinterpret_cast<float2*>(sAcc + (i0 + 8) * kAccLd + c) =
          make_float2(o[nt][2], o[nt][3]);
    }
    if (tig == 0) {
      sM[i0] = m[0];
      sL[i0] = l[0];
      sM[i0 + 8] = m[1];
      sL[i0 + 8] = l[1];
    }
  }
};

// The fp32 forms: CUDA cores on 32-key tiles. Thread tid owns output column
// tid % HD of the query rows tid / HD + k * (kThreads / HD); the running
// (m, l) live in shared memory.
template <int HD>
struct SimtRows {
  static constexpr int kPer = kRows * HD / kThreads;  // accumulators a thread
  static constexpr int kStride = kThreads / HD;       // its rows' spacing
  static constexpr int kTile = 32;
  static constexpr int kLd = HD + 4;
  float acc[kPer];
  float* sQ;     // [kRows][HD] fp32 q rows
  float* sS;     // [kRows][kTile + 1] scores, then P
  float* sM;     // running max, sum and this tile's correction
  float* sL;
  float* sCorr;
  const int* sN;
  const int* sCl;
  int nq, G;

  __device__ __forceinline__ void init(const Args& a, int row0, int kvh, int tid) {
    const float* q = static_cast<const float*>(a.q);
    for (int e = tid; e < nq * HD; e += kThreads) {
      const int i = e / HD, d = e - i * HD;
      const int j = i / G;
      sQ[e] = q[(row0 + j) * a.q_sb + (long long)(kvh * G + i - j * G) * a.q_sh + d];
    }
    for (int i = tid; i < kRows; i += kThreads) {
      sM[i] = -INFINITY;
      sL[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  }

  __device__ __forceinline__ void update(const float* kt, const float* vt, int t,
                                         const Args& a, int kvh, int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    {
      const int k = tid % kTile;
      const int kpos = t * kTile + k;
      for (int i = tid / kTile; i < nq; i += kThreads / kTile) {
        const float* qr = sQ + i * HD;
        const float* kr = kt + k * kLd;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        const int j = i / G;
        const float slope = a.slopes != nullptr ? a.slopes[kvh * G + i - j * G] : 0.f;
        const float x = score(dot, a.scale, a.slopes != nullptr, slope, sCl[j], kpos);
        sS[i * (kTile + 1) + k] = kpos < sN[j] ? x : -INFINITY;
      }
    }
    __syncthreads();
    for (int i = warp; i < nq; i += kWarps) {
      const float x = sS[i * (kTile + 1) + lane];
      const float m_old = sM[i];
      const float m_new = fmaxf(m_old, dst::warp_max(x));
      const float msafe = m_new == -INFINITY ? 0.f : m_new;
      const float p = expf(x - msafe);
      sS[i * (kTile + 1) + lane] = p;
      const float psum = dst::warp_sum(p);
      if (lane == 0) {
        const float corr = expf(m_old - msafe);
        sCorr[i] = corr;
        sL[i] = sL[i] * corr + psum;
        sM[i] = m_new;
      }
    }
    __syncthreads();
    const int d = tid % HD;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = tid / HD + r * kStride;
      if (i < nq) {
        const float* pr = sS + i * (kTile + 1);
        float x = acc[r] * sCorr[i];
#pragma unroll 8
        for (int k = 0; k < kTile; ++k) x = fmaf(pr[k], vt[k * kLd + d], x);
        acc[r] = x;
      }
    }
  }

  __device__ __forceinline__ void store(float* sAcc, int tid) const {
    const int d = tid % HD;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = tid / HD + r * kStride;
      if (i < nq) sAcc[i * (HD + 8) + d] = acc[r];
    }
  }
};

// T: q, out and the K/V tiles the arithmetic reads; TC: the cache's storage
// type (T, int8_t with the fp32 scales, or bf16 under fp16 T); kPaged: the address policy of a
// key position. Grid: (kSplit x row tiles, KV); a cluster is one (row tile,
// kv head), its block rank the split.
template <typename T, typename TC, int HD, bool kPaged>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 3)
    decode_attention_kernel(Args a) {
  using L = Layout<T, TC, HD>;
  constexpr int kTile = L::kTile;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  float* sAcc = reinterpret_cast<float*>(smem);  // over the ring, after the walk
  float* sQ = reinterpret_cast<float*>(smem + L::kMain);
  float* sS = reinterpret_cast<float*>(smem + L::kMain + L::kQ);
  float* sM = reinterpret_cast<float*>(smem + L::kMain + L::kQ + L::kS);
  float* sL = sM + kRows;
  float* sCorr = sL + kRows;
  float* sLm = sCorr + kRows;
  float* sW = sLm + kRows;  // [kRows][kSplit]
  int* sCl = reinterpret_cast<int*>(sW + kRows * kSplit);
  int* sN = sCl + kRows;
  int* sRed = sN + kRows;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int tile_id = blockIdx.x / kSplit;
  const int kvh = blockIdx.y;
  const int G = a.H / a.KV;
  const int TR = kRows / G;
  const int seq = tile_id / a.tiles_per_seq;
  const int srow0 = (tile_id - seq * a.tiles_per_seq) * TR;
  const int nsr = min(TR, a.rows_per_seq - srow0);  // sequence rows of the tile
  const int row0 = seq * a.rows_per_seq + srow0;    // their first query row
  const int nq = nsr * G;                           // query rows of the tile
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kCols = HD / kSplit;  // output columns this block merges
  T* out = static_cast<T*>(a.out);
  auto out_at = [&](int i, int c) -> T* {
    const int j = i / G;
    return out + ((long long)(row0 + j) * a.H + kvh * G + (i - j * G)) * HD + c;
  };

  // each sequence row's frontier and visible keys; the tile's furthest
  int nv = 0;
  if (tid < nsr) {
    const int cl = a.cache_len != nullptr ? a.cache_len[row0 + tid] : a.cache_len_scalar;
    nv = min(max(cl + 1, 0), a.Smax);
    sCl[tid] = cl;
    sN[tid] = nv;
  }
  nv = __reduce_max_sync(0xffffffffu, nv);
  if (lane == 0) sRed[warp] = nv;
  __syncthreads();
  const int n_max = max(max(sRed[0], sRed[1]), max(sRed[2], sRed[3]));
  if (n_max == 0) {  // every row padded: the whole cluster writes zeros and returns
    for (int e = tid; e < nq * kCols; e += kThreads) {
      *out_at(e / kCols, split * kCols + e % kCols) = dst::from_float<T>(0.f);
    }
    return;
  }

  const TC* kb = static_cast<const TC*>(a.k) + kvh * a.k_sh;
  const TC* vb = static_cast<const TC*>(a.v) + kvh * a.v_sh;
  const float* ksb = L::kInt8 ? a.ks + kvh * a.ks_sh : nullptr;
  const float* vsb = L::kInt8 ? a.vs + kvh * a.vs_sh : nullptr;
  const int* pt = kPaged ? a.page_table + (long long)seq * a.max_pages : nullptr;
  const int n_tiles = (n_max + kTile - 1) / kTile;
  const int mine = n_tiles > split ? (n_tiles - 1 - split) / kSplit + 1 : 0;

  // a key position's (block, row): (sequence, position) in the dense cache,
  // (its page, its row in the page) in the pool
  auto locate = [&](int pos, long long& blk, int& off) {
    if constexpr (kPaged) {
      const int lp = pos / a.page_size;
      blk = pt[lp];
      off = pos - lp * a.page_size;
    } else {
      blk = seq;
      off = pos;
    }
  };
  // the copies of the i-th tile this block owns into ring stage i % kStages
  auto issue = [&](int i) {
    if (i >= mine) return;
    const int start = (split + i * kSplit) * kTile;
    uint8_t* stage = ring + (i % kStages) * L::kStage;
    for (int c = tid; c < kTile * L::kChunks; c += kThreads) {
      const int r = c / L::kChunks;
      const int ch = c - r * L::kChunks;
      const int pos = start + r;
      const bool valid = pos < n_max;
      const TC* ksrc = kb;
      const TC* vsrc = vb;
      if (valid) {
        long long blk;
        int off;
        locate(pos, blk, off);
        ksrc = kb + blk * a.k_s0 + off * a.k_s1 + ch * (16 / sizeof(TC));
        vsrc = vb + blk * a.v_s0 + off * a.v_s1 + ch * (16 / sizeof(TC));
      }
      const int at = r * L::kRawLd * sizeof(TC) + ch * 16;
      cp_async_16(smem_addr(stage + at), ksrc, valid);
      cp_async_16(smem_addr(stage + L::kRawTile + at), vsrc, valid);
    }
    if constexpr (L::kInt8) {
      for (int r = tid; r < kTile; r += kThreads) {
        const int pos = start + r;
        const bool valid = pos < n_max;
        long long blk = 0;
        int off = 0;
        if (valid) locate(pos, blk, off);
        uint8_t* sc = stage + 2 * L::kRawTile;
        cp_async_4(smem_addr(sc + r * 4), ksb + blk * a.ks_s0 + off, valid);
        cp_async_4(smem_addr(sc + L::kScales + r * 4), vsb + blk * a.vs_s0 + off, valid);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    issue(i);
    cp_async_commit();
  }
  using Rows = typename std::conditional<L::kMma, MmaRows<T, HD>, SimtRows<HD>>::type;
  Rows rows;  // its q rows load while the first tiles are in flight
  if constexpr (L::kMma) {
    rows.init(a, sN, sCl, nq, G, kvh, row0, warp, lane);
  } else {
    rows.sQ = sQ;
    rows.sS = sS;
    rows.sM = sM;
    rows.sL = sL;
    rows.sCorr = sCorr;
    rows.sN = sN;
    rows.sCl = sCl;
    rows.nq = nq;
    rows.G = G;
    rows.init(a, row0, kvh, tid);
  }
  T* tiles = reinterpret_cast<T*>(ring + kStages * L::kStage);  // int8: dequantized K, V
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    uint8_t* stage = ring + (i % kStages) * L::kStage;
    const T* kt;
    const T* vt;
    if constexpr (L::kInt8) {
      // dequantize as the tile lands: float(q) * scale, rounded to T
      const float* sc = reinterpret_cast<const float*>(stage + 2 * L::kRawTile);
      for (int c = tid; c < 2 * kTile * (HD / 16); c += kThreads) {
        const int which = c / (kTile * (HD / 16));
        const int rc = c - which * kTile * (HD / 16);
        const int r = rc / (HD / 16);
        const int ch = rc - r * (HD / 16);
        const uint4 raw = *reinterpret_cast<const uint4*>(
            stage + which * L::kRawTile + r * L::kRawLd + ch * 16);
        const int8_t* qv = reinterpret_cast<const int8_t*>(&raw);
        const float s = sc[which * kTile + r];
        T* dq = tiles + which * kTile * L::kLd + r * L::kLd + ch * 16;
#pragma unroll
        for (int e = 0; e < 16; e += 2) {
          store2(dq + e, __fmul_rn(static_cast<float>(qv[e]), s),
                 __fmul_rn(static_cast<float>(qv[e + 1]), s));
        }
      }
      __syncthreads();
      kt = tiles;
      vt = tiles + kTile * L::kLd;
    } else {
      if constexpr (L::kRecast) {
        // convert as the tile lands: each 16-byte chunk to T in its place
        for (int c = tid; c < 2 * kTile * L::kChunks; c += kThreads) {
          const int which = c / (kTile * L::kChunks);
          const int rc = c - which * kTile * L::kChunks;
          const int r = rc / L::kChunks;
          uint4* p = reinterpret_cast<uint4*>(stage + which * L::kRawTile +
                                              r * L::kRawLd * sizeof(TC)) +
                     (rc - r * L::kChunks);
          *p = bf16x8_to_f16(*p);
        }
        __syncthreads();
      }
      kt = reinterpret_cast<const T*>(stage);
      vt = reinterpret_cast<const T*>(stage + L::kRawTile);
    }
    const int t = split + i * kSplit;
    if constexpr (L::kMma) {
      rows.update(kt, vt, t, a.scale, a.slopes != nullptr, lane);
    } else {
      rows.update(kt, vt, t, a, kvh, tid);
    }
    __syncthreads();  // the stage (and the dequantized tiles) are free again
    issue(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: the partials go over it
  if constexpr (L::kMma) {
    rows.store(sAcc, sM, sL, warp, lane);
  } else {
    rows.store(sAcc, tid);
  }

  // merge: block `split` finishes columns [split * kCols, (split + 1) * kCols)
  // of every row from the kSplit partials, in rank order
  cluster.sync();
  if (tid < nq) {
    float ms[kSplit], ls[kSplit];
#pragma unroll
    for (int s = 0; s < kSplit; ++s) {
      ms[s] = *cluster.map_shared_rank(sM + tid, s);
      ls[s] = *cluster.map_shared_rank(sL + tid, s);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kSplit; ++s) mx = fmaxf(mx, ms[s]);
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < kSplit; ++s) {
      const float w = ms[s] == -INFINITY ? 0.f : expf(ms[s] - mx);  // empty: 0
      sW[tid * kSplit + s] = w;
      l = __fmaf_rn(ls[s], w, l);
    }
    sLm[tid] = l;
  }
  __syncthreads();
  constexpr int kQuads = kCols / 4;
  for (int e = tid; e < nq * kQuads; e += kThreads) {
    const int i = e / kQuads;
    const int c = split * kCols + (e - i * kQuads) * 4;
    float4 v[kSplit];
#pragma unroll
    for (int s = 0; s < kSplit; ++s) {
      v[s] = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(sAcc + i * L::kAccLd + c, s));
    }
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
    for (int s = 0; s < kSplit; ++s) {
      const float w = sW[i * kSplit + s];
      o0 = __fmaf_rn(v[s].x, w, o0);
      o1 = __fmaf_rn(v[s].y, w, o1);
      o2 = __fmaf_rn(v[s].z, w, o2);
      o3 = __fmaf_rn(v[s].w, w, o3);
    }
    const float l = sLm[i];
    T* op = out_at(i, c);
    if (l == 0.f) {
      store2(op, 0.f, 0.f);
      store2(op + 2, 0.f, 0.f);
    } else {
      store2(op, o0 / l, o1 / l);
      store2(op + 2, o2 / l, o3 / l);
    }
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

template <typename T, typename TC, int HD, bool kPaged>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t s) {
  auto* kernel = decode_attention_kernel<T, TC, HD, kPaged>;
  constexpr int bytes = Layout<T, TC, HD>::kBytes;
  static const cudaError_t set =  // once per instantiation and process
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  kernel<<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// The checks every form shares, then the grid of `rows` (> 0) query rows into
// `grid`.
inline cudaError_t plan(Args& a, int rows, bool paged, dim3& grid) {
  if (a.KV <= 0 || a.H % a.KV != 0 || a.H / a.KV > kMaxGroup || a.rows_per_seq < 1 ||
      rows % a.rows_per_seq != 0 || (paged && (a.page_size < 1 || a.max_pages < 1))) {
    return cudaErrorInvalidValue;
  }
  const int per_tile = kRows / (a.H / a.KV);
  a.tiles_per_seq = (a.rows_per_seq + per_tile - 1) / per_tile;
  grid = dim3(kSplit * (rows / a.rows_per_seq) * a.tiles_per_seq, a.KV);
  return cudaSuccess;
}

// The launch of one (T, TC, paged) form at the head sizes it takes; rows
// query rows. The status an entry returns.
template <typename T, typename TC, bool kPaged>
int run(Args& a, int rows, int hd, cudaStream_t s) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  dim3 grid;
  const cudaError_t ok = plan(a, rows, kPaged, grid);
  if (ok != cudaSuccess) return static_cast<int>(ok);
  cudaError_t st;
  if (hd == 128) {
    st = launch<T, TC, 128, kPaged>(a, grid, s);
  } else if (hd == 64) {
    st = launch<T, TC, 64, kPaged>(a, grid, s);
  } else {
    st = cudaErrorInvalidValue;
  }
  return static_cast<int>(st);
}

Args base_args(const void* q, const void* k, const void* v, void* out,
               int H, int KV, int rows_per_seq, long long q_sb, long long q_sh,
               long long k_s0, long long k_s1, long long k_sh, long long v_s0,
               long long v_s1, long long v_sh, const void* slopes, float scale) {
  Args a{};
  a.slopes = static_cast<const float*>(slopes);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.H = H;
  a.KV = KV;
  a.rows_per_seq = rows_per_seq;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_s0 = k_s0;
  a.k_s1 = k_s1;
  a.k_sh = k_sh;
  a.v_s0 = v_s0;
  a.v_s1 = v_s1;
  a.v_sh = v_sh;
  a.scale = scale;
  return a;
}

// The contiguous cache's frontiers: per row (cache_len, on the device) or one
// for every row (cache_len == nullptr: cache_len_scalar).
void set_dense(Args& a, const void* cache_len, int cache_len_scalar, int Smax) {
  a.cache_len = static_cast<const int*>(cache_len);
  a.cache_len_scalar = cache_len_scalar;
  a.Smax = Smax;
}

// The page pool's frontiers and page tables.
void set_paged(Args& a, const void* cache_len, const void* page_table, int max_pages,
               int page_size) {
  a.cache_len = static_cast<const int*>(cache_len);
  a.page_table = static_cast<const int*>(page_table);
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.Smax = max_pages * page_size;
}

// The int8 forms' scales, by strides (batch or page, head).
void set_scales(Args& a, const void* k_scale, const void* v_scale, long long ks_s0,
                long long ks_sh, long long vs_s0, long long vs_sh) {
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.ks_s0 = ks_s0;
  a.ks_sh = ks_sh;
  a.vs_s0 = vs_s0;
  a.vs_sh = vs_sh;
}

}  // namespace
