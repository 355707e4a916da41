// Device helpers shared by the flash attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu, flash_attention_bias_grad.cu): bf16 and fp16
// packing, the
// ALiBi score, and the masked form's operands (segment ids, a dense additive
// bias, block-sparse compaction tables, ring-hop offsets); and the mma.sync
// product and kLog2e, which the decode kernel (decode_attention.cu) takes.
//
// The masked form is one template instantiation per kernel whose masks are
// read at run time from a Mask; the slope-free (Llama) and ALiBi forms are
// instantiated without it. The Mask also carries the
// offset form of ring attention's hops (flash_attention.py:94-113, has_offsets):
// the global positions qoff and koff of the local query chunk and of the
// visiting key chunk, which shift the causal test and the ALiBi distance, and
// the visiting chunk's own segment ids. Its score is pinned with
// __fmul_rn/__fmaf_rn, so the forward's and the backward's scores are the
// same bits and p recomputed in a backward kernel is the p whose sum went
// into the forward's lse:
//   t = s * scale_log2;  t += bias * log2e;  t -= slope_log2 * |row - key|
// (the dense bias first, then ALiBi, as _mask_and_bias adds them,
// deepspeed_tpu/ops/pallas/flash_attention.py:94-113).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dst {
namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// d += a (16 x 16, row-major) * b (16 x 8, column-major), T in (bf16 by
// default, or fp16: __half), fp32 out.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(h);
}

// Two fp32 values rounded to a pair of T (bf16 or fp16) in one register, and
// back. The fp16 rounding is cvt.rn.f16x2.f32: +-inf past 65504, never the
// .satfinite clamp, so an overflow reaches the loss scaler as the Pallas
// kernel's does.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    return pack_f32(lo, hi);
  }
}

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 h = *reinterpret_cast<__half2*>(&u);
    return __half22float2(h);
  } else {
    return unpack(u);
  }
}

// A score with its ALiBi term in the log2 domain: s * scale_log2 rounded,
// then - slope_log2 * |row - key| by one fused multiply-add. Written with
// intrinsics so no contraction choice of the compiler can make the forward's
// and the backward's scores differ.
__device__ __forceinline__ float alibi_score(float s, float scale_log2,
                                             float slope_log2, int row, int key) {
  return __fmaf_rn(-slope_log2, static_cast<float>(abs(row - key)),
                   __fmul_rn(s, scale_log2));
}

struct Strides {
  long long sb, ss, sh;
};

inline Strides at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// ---------------------------------------------------------------------------
// The masked form's operands, read at run time
// ---------------------------------------------------------------------------
struct Mask {
  const int* seg;        // [B, S] int32 segment ids, or nullptr
  const void* bias;      // dense additive bias [B|1, H|1, S, S], or nullptr
  long long bias_sb;     // its element strides; 0 on a broadcast dim
  long long bias_sh;
  long long bias_sq;     // query-row stride (the key stride is 1)
  int bias_dtype;        // its storage, a DType code: fp32, bf16 or fp16
  const int* cols;       // block-sparse table [nb, jmax] (per row of layout
                         // blocks, its active blocks ascending), or nullptr
  const int* counts;     // [nb]: active blocks per row
  int jmax;              // the table's row stride
  int blk;               // layout block, in tokens (a multiple of 64)
  void* dbias;           // a dbias output in the bias's dtype, or nullptr
  const int* seg_k;      // the keys' [B, S] segment ids when they differ from
                         // the queries' (a ring hop's visiting chunk), or nullptr
  int qoff;              // global position of query row 0 (ring hops; else 0)
  int koff;              // global position of key 0
};

// A row with no visible key: lse = the JAX package's finite mask value
// (flash_attention.py:57), so a merge by logaddexp and the backward's
// exp(s - lse) read a number, never -inf - -inf.
constexpr float kNegInf = -1e30f;

// The C entry points' mask argument: long long[14], in Mask's field order
// (pointers as integers, 0 for none); nullptr selects an unmasked form.
inline Mask parse_mask(const long long* m) {
  Mask k;
  k.seg = reinterpret_cast<const int*>(m[0]);
  k.bias = reinterpret_cast<const void*>(m[1]);
  k.bias_sb = m[2];
  k.bias_sh = m[3];
  k.bias_sq = m[4];
  k.bias_dtype = static_cast<int>(m[5]);
  k.cols = reinterpret_cast<const int*>(m[6]);
  k.counts = reinterpret_cast<const int*>(m[7]);
  k.jmax = static_cast<int>(m[8]);
  k.blk = static_cast<int>(m[9]);
  k.dbias = reinterpret_cast<void*>(m[10]);
  k.seg_k = reinterpret_cast<const int*>(m[11]);
  k.qoff = static_cast<int>(m[12]);
  k.koff = static_cast<int>(m[13]);
  return k;
}

__device__ __forceinline__ float load_bias(const Mask& m, long long off) {
  switch (m.bias_dtype) {
    case kBFloat16: return __bfloat162float(static_cast<const __nv_bfloat16*>(m.bias)[off]);
    case kFloat16: return __half2float(static_cast<const __half*>(m.bias)[off]);
    default: return static_cast<const float*>(m.bias)[off];
  }
}

// dbias in the bias's dtype, rounded to nearest (an fp16 overflow stays inf).
__device__ __forceinline__ void store_dbias(const Mask& m, long long off, float x) {
  switch (m.bias_dtype) {
    case kBFloat16: static_cast<__nv_bfloat16*>(m.dbias)[off] = __float2bfloat16(x); break;
    case kFloat16: static_cast<__half*>(m.dbias)[off] = __float2half_rn(x); break;
    default: static_cast<float*>(m.dbias)[off] = x;
  }
}

// The masked form's score (log2 domain): the dense bias, then ALiBi.
__device__ __forceinline__ float masked_score(float s, float scale_log2, bool has_bias,
                                              float bias, bool has_alibi,
                                              float slope_log2, int row, int key) {
  float t = __fmul_rn(s, scale_log2);
  if (has_bias) t = __fmaf_rn(bias, kLog2e, t);
  if (has_alibi) t = __fmaf_rn(-slope_log2, static_cast<float>(abs(row - key)), t);
  return t;
}

// The causal walk under position offsets: the number of key tiles of TILE
// keys that rows [.., last_row] see, the keys sitting reach = last_row + qoff
// - koff positions behind them (0 when the whole chunk lies in the future);
// with no offsets, the tiles up to the diagonal.
template <int TILE>
__device__ __forceinline__ int causal_key_tiles(int last_row, int qoff, int koff,
                                                int n_all) {
  const int reach = last_row + qoff - koff;
  return reach < 0 ? 0 : min(n_all, reach / TILE + 1);
}

// The first query tile of TILE rows that sees key key0 under the offsets.
template <int TILE>
__device__ __forceinline__ int causal_first_query_tile(int key0, int qoff, int koff) {
  return max(0, key0 + koff - qoff) / TILE;
}

// Walk the tiles of TILE rows (or keys) that a block of the dense grid
// visits: [t_begin, t_end) without a table; with one, only the tiles inside
// the active layout blocks of layout row `line` (those tables list blocks
// ascending, so the tiles come in the dense walk's order), clipped to
// [t_begin, t_end). Calls body(t) for each.
template <int TILE, typename Body>
__device__ __forceinline__ void for_tiles(const Mask& m, int line, int t_begin,
                                          int t_end, Body&& body) {
  if (m.cols == nullptr) {
    for (int t = t_begin; t < t_end; ++t) body(t);
    return;
  }
  const int per = m.blk / TILE;
  const int n = m.counts[line];
  for (int i = 0; i < n; ++i) {
    const int blk = m.cols[line * m.jmax + i];
    const int te = min((blk + 1) * per, t_end);
    for (int t = max(blk * per, t_begin); t < te; ++t) body(t);
  }
}

}  // namespace flash
}  // namespace dst
