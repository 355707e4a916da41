// The tile machinery that the Hopper flash attention kernels share: the
// forward (flash_attention_fwd.cu), the dq and dk/dv kernels
// (flash_attention_bwd.cu) and the bias-gradient kernel
// (flash_attention_bias_grad.cu). Each runs blocks of three warpgroups: two
// consumers, each owning 64 of the block's kRows rows, and a producer whose
// first warp walks the block's tiles (the bias gradient: the (batch row,
// head) pairs of its output tiles), judges each against each consumer's rows
// (tile_class) and keeps a ring of shared-memory stages filled by TMA. This
// header holds that walk's pieces: the block shape and register split, the
// tile classes and the segment-id range reduction they read, the
// compile-time flags of a tile's epilogue, the wgmma products over whole
// tiles, the addressing of a dense bias tile, the layout-table check and the
// launch.
#pragma once

#include <climits>
#include <type_traits>

#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace dst {
namespace flash {

constexpr int kGroups = 2;              // consumer warpgroups a block
constexpr int kRows = 64 * kGroups;     // the block's own rows
constexpr int kBlockThreads = 128 * (kGroups + 1);
// setmaxnreg: the producer gives its registers to the consumers; 128 x 40 +
// 256 x 232 fits the 168 a thread that a 384-thread launch allots
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kEmpty = 0, kPartial = 1, kFull = 2;  // tile classes

// The class of the tile [q_lo, q_hi] x [k_lo, k_hi] (queries x keys, both
// inclusive and possibly past S); qseg and kseg are the [min, max] segment
// ids of the rows and keys inside S when has_seg.
__device__ __forceinline__ int tile_class(int q_lo, int q_hi, int k_lo, int k_hi, int S,
                                          int causal, int qoff, int koff, bool has_seg,
                                          int2 qseg, int2 kseg) {
  if (q_lo >= S || k_lo >= S) return kEmpty;
  if (causal && k_lo + koff > q_hi + qoff) return kEmpty;
  if (has_seg && (qseg.y < kseg.x || kseg.y < qseg.x)) return kEmpty;
  const bool full = q_hi < S && k_hi < S && (!causal || k_hi + koff <= q_lo + qoff) &&
                    (!has_seg || (qseg.x == qseg.y && kseg.x == kseg.y && qseg.x == kseg.x));
  return full ? kFull : kPartial;
}

// [min, max] over the warp of the segment ids of the 64 rows at i0 inside S
// (INT_MAX, INT_MIN for none); each lane's two ids (i0 + lane, + 32) in ids.
__device__ __forceinline__ int2 seg_range(const int* seg, int i0, int S, int lane,
                                          int2& ids) {
  const int a = i0 + lane, b = a + 32;
  ids.x = a < S ? seg[a] : 0;
  ids.y = b < S ? seg[b] : 0;
  int lo = INT_MAX, hi = INT_MIN;
  if (a < S) lo = hi = ids.x;
  if (b < S) {
    lo = min(lo, ids.y);
    hi = max(hi, ids.y);
  }
  return make_int2(__reduce_min_sync(0xffffffffu, lo), __reduce_max_sync(0xffffffffu, hi));
}

// The per-tile [min, max] segment ids of tiles [t_lo, t_hi) of a [S] row into
// tr[t], and of the 64 rows at own_row into *own (own_row < 0: none), shared
// by the 8 consumer warps (cw: this warp's index among them); then each warp
// arrives on the ranges barrier, which the producer waits on before it
// classifies a tile.
template <int TILE>
__device__ __forceinline__ void tile_ranges(const int* tile_seg, int t_lo, int t_hi,
                                            const int* own_seg, int own_row, int2* own,
                                            int2* tr, int S, int cw, int lane,
                                            uint32_t rbar) {
  int2 ids;
  if (own_row >= 0) {
    const int2 r = seg_range(own_seg, own_row, S, lane, ids);
    if (lane == 0) *own = r;
  }
  for (int t = t_lo + cw; t < t_hi; t += 4 * kGroups) {
    int2 r = make_int2(INT_MAX, INT_MIN);
#pragma unroll
    for (int c = 0; c < TILE; c += 64) {
      const int2 rc = seg_range(tile_seg, t * TILE + c, S, lane, ids);
      r = make_int2(min(r.x, rc.x), max(r.y, rc.y));
    }
    if (lane == 0) tr[t] = r;
  }
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(rbar);
}

// Call f(test, terms, emit) with compile-time flags for the run-time ones, so
// each combination gets its own epilogue: test (a partial tile's per-pair
// tests), terms (a bias or ALiBi term in the score), emit (dst into dbias,
// only with kMasked; it comes with a bias).
template <bool kMasked, typename F>
__device__ __forceinline__ void with_flags(bool full, bool terms, bool emit, F&& f) {
  auto by_terms = [&](auto test) {
    if (kMasked && emit) {
      f(test, std::true_type{}, std::true_type{});
    } else if (terms) {
      f(test, std::true_type{}, std::false_type{});
    } else {
      f(test, std::false_type{}, std::false_type{});
    }
  };
  if (full) {
    by_terms(std::false_type{});
  } else {
    by_terms(std::true_type{});
  }
}

// The 1024-aligned start of the dynamic shared memory (the 128-byte swizzle's
// atoms are 1024-byte aligned).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// The A fragments of k-step kk (columns 16 kk..16 kk + 15) of an m64nN
// accumulator, rounded to T (bf16 by default, or fp16; the accumulator's
// layout is the A operand's).
template <typename T = __nv_bfloat16, int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = pack2<T>(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack2<T>(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2<T>(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2<T>(d[8 * kk + 6], d[8 * kk + 7]);
}

// d += the RS product of the k-step fragments a over the ROWS x HD tile in
// panels at b (read MN-major), operands of type T.
template <int HD, int ROWS, typename T = __nv_bfloat16>
__device__ __forceinline__ void rs_product(float (&d)[HD / 2],
                                           const uint32_t (&a)[ROWS / 16][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {
    if constexpr (HD == 128) {
      sm90::wgmma_rs_n128<T>(d, a[kk], sm90::desc_mn(b, ROWS, kk), 1);
    } else {
      sm90::wgmma_rs_n64<T>(d, a[kk], sm90::desc_mn(b, ROWS, kk), 1);
    }
  }
}

// d = the SS product of 64 rows at a (a tile of a_rows rows) and the N rows at
// b, over the head dim (both K-major), operands of type T.
template <int HD, int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void ss_product(float (&d)[N / 2], uint32_t a, int a_rows,
                                           int a_row0, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    if constexpr (N == 128) {
      sm90::wgmma_ss_n128<T>(d, sm90::desc_k(a, a_rows, a_row0, ks),
                             sm90::desc_k(b, N, 0, ks), ks > 0);
    } else if constexpr (N == 32) {
      sm90::wgmma_ss_n32<T>(d, sm90::desc_k(a, a_rows, a_row0, ks),
                            sm90::desc_k(b, N, 0, ks), ks > 0);
    } else {
      sm90::wgmma_ss_n64<T>(d, sm90::desc_k(a, a_rows, a_row0, ks),
                            sm90::desc_k(b, N, 0, ks), ks > 0);
    }
  }
}

// The byte offset of element (r, key) of a dense bias tile of kRows rows in
// shared memory, as TMA writes it: panels of 128 bytes a row (32 fp32 or 64
// bf16 keys) with the 128-byte swizzle, one panel after another.
__device__ __forceinline__ int bias_offset(int r, int key, bool bf16) {
  if (bf16) {
    return (key >> 6) * (kRows * 128) + r * 128 + ((((key & 63) >> 3) ^ (r & 7)) << 4) +
           ((key & 7) << 1);
  }
  return (key >> 5) * (kRows * 128) + r * 128 + ((((key & 31) >> 2) ^ (r & 7)) << 4) +
         ((key & 3) << 2);
}

// The bias pair (key, key + 1), key even, of row r of a bias tile.
__device__ __forceinline__ float2 bias_pair(const uint8_t* tile, int r, int key, bool bf16) {
  const uint8_t* at = tile + bias_offset(r, key, bf16);
  return bf16 ? unpack(*reinterpret_cast<const uint32_t*>(at))
              : *reinterpret_cast<const float2*>(at);
}

// A table's layout block must hold whole blocks of kRows rows, so that no
// block of the grid straddles two layout blocks.
inline bool table_ok(const long long* mask) {
  return mask == nullptr || mask[6] == 0 || (mask[9] > 0 && mask[9] % kRows == 0);
}

// Whether a mask needs the masked instantiation: position offsets alone (a
// ring hop without segment ids) run the unmasked one, which reads them too.
inline bool needs_masked(const Mask& m) {
  return m.seg != nullptr || m.bias != nullptr || m.cols != nullptr || m.dbias != nullptr;
}

// Launch a kernel of kBlockThreads threads with `bytes` of dynamic shared
// memory; the launch's status.
template <typename Params>
cudaError_t launch(void (*kernel)(Params), const Params& prm, dim3 grid, int bytes,
                   cudaStream_t s) {
  const cudaError_t st =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (st != cudaSuccess) return st;
  kernel<<<grid, kBlockThreads, bytes, s>>>(prm);
  return cudaGetLastError();
}

}  // namespace flash
}  // namespace dst
