// Flash attention backward (bf16, causal or not, GQA) with mma.sync tensor
// cores: one kernel for dq, one for dk/dv, as the TPU package splits them.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:_bwd_dq_kernel
// (line 455) and :_bwd_dkv_kernel (line 517), driven by _flash_bwd (line 719),
// in all their forms: causal, grouped-query heads, ALiBi slopes, segment ids,
// a dense additive bias (with the dq kernel's dbias output, emit_dbias), a
// block-sparse layout and the position offsets of ring attention's hops
// (has_offsets; deepspeed_tpu/ops/pallas/ring_flash.py:_rf_bwd, line 120). A
// hop's backward reads the ring's final lse, and its dq kernel is given the
// final output, so the delta it computes is the ring's (the given delta= of
// _flash_bwd, flash_attention.py:719).
//
// With s = q . k * scale + bias - slope[h] * |q - k| (each term only where
// given), p = exp(s - lse) (the forward's saved lse; p = 0 where the key is
// masked: causal, segment, layout; under offsets the global positions q + qoff
// and k + koff enter the causal test and the ALiBi distance, and the keys'
// segment ids are the visiting chunk's), dp = do . v and delta = rowsum(do * o):
//   dst = p * (dp - delta),  ds = dst * scale
//   dq = sum_k ds K,  dk = sum_q ds^T Q,  dv = sum_q p^T dO,  dbias = dst
// dk and dv of a kv head sum over the query heads of its group.
//
// Bound on the H100: operations at training lengths. The dq kernel does 6 * D
// flops per visible (query, key) pair (q.k, do.v and ds.K), the dk/dv kernel
// 8 * D (q.k, do.v, p^T dO, ds^T Q), over 989 TFLOP/s of bf16 tensor-core
// rate. Design: both kernels follow the forward kernel (flash_attention_fwd.cu):
// 4 warps per block, each warp owning 16 rows of the tile, mma.sync m16n8k16
// bf16 products with fp32 accumulation, operand rows from device memory into
// registers for the row side and 16-byte loads into padded shared memory for
// the column side, fp32 softmax recompute in registers, the model layout
// [B, S, H, D] read through strides and ragged S masked in the kernel.
//   dq: one block per (64 query rows, head, batch row); loops key tiles up to
//     the diagonal (under offsets, to the last tile its rows see: none for a
//     chunk wholly in the future, whose dq is exactly zero; with a layout, the
//     tiles of the row's active blocks). It
//     also computes delta for its rows from do and o and writes it [B, H, S]
//     for the dk/dv kernel (launched after it on the same stream), so delta
//     costs no pass of its own. With a dbias output (a full [B, H, S, S]
//     bias) it writes dst for every pair of its rows, zeros in the tiles its
//     causal loop skips, as _zero_dbias does (flash_attention.py:505-510).
//   dk/dv: one block per (64 keys, kv head, batch row); loops the group's
//     query heads and, for each, the query tiles from the diagonal on (under
//     offsets, from the first tile that sees its keys, so a future chunk's
//     dk, dv are exactly zero; with a
//     layout, the tiles of the active blocks of its key block's column, from
//     the transposed table as flash_attention.py:1200 builds it). The group
//     sum and the sum over query tiles stay in fp32 registers: the TPU kernel
//     writes per-query-head dk/dv [B, H, S, D] and sums them afterwards; here
//     each output is written once, with no atomics, so the result does not
//     depend on the schedule. A dense bias is read at the query head.
// Each score is recomputed by the function the forward kernel used
// (alibi_score, masked_score in flash_attention.cuh), so p is the p whose sum
// went into the saved lse; the slope-free and ALiBi instantiations keep their
// code from before the masked form came in. wgmma, TMA and pipelined tiles are
// later work.
#include "flash_attention.cuh"

using namespace dst::flash;

namespace {

// ---------------------------------------------------------------------------
// dq (+ delta, + dbias)
// ---------------------------------------------------------------------------
template <int HD, bool kAlibi, bool kMasked>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S, int H,
    int KV, Strides qs, Strides ks_, Strides vs, Strides os, Strides dos,
    Strides dqs, const float* __restrict__ slopes, float scale, int causal, Mask mask) {
  constexpr int kBlockN = HD == 128 ? 32 : 64;  // keys per tile
  constexpr int kLds = HD + 8;
  constexpr int kSTiles = kBlockN / 8;
  __shared__ __align__(16) __nv_bfloat16 sk[kBlockN * kLds];
  __shared__ __align__(16) __nv_bfloat16 sv[kBlockN * kLds];
  __shared__ int sseg[kMasked ? kBlockN : 1];  // the tile's key segment ids

  const int qblock = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = qblock * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;

  const __nv_bfloat16* qb = q + b * qs.sb + h * qs.sh;
  const __nv_bfloat16* kb = k + b * ks_.sb + kvh * ks_.sh;
  const __nv_bfloat16* vb = v + b * vs.sb + kvh * vs.sh;
  const __nv_bfloat16* ob = o + b * os.sb + h * os.sh;
  const __nv_bfloat16* dob = dout + b * dos.sb + h * dos.sh;

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  load_rows<HD>(qa, qb, qs.ss, row0, row1, S, tig);
  load_rows<HD>(da, dob, dos.ss, row0, row1, S, tig);

  // delta = rowsum(do * o): this thread's columns of its two rows, then the
  // group of four threads that share the rows
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks * 16 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (row0 < S) {
        const float2 d2 = unpack(da[ks][half * 2]);
        const float2 o2 = unpack(load_pair(ob + row0 * os.ss + c + half * 8));
        dl0 += d2.x * o2.x + d2.y * o2.y;
      }
      if (row1 < S) {
        const float2 d2 = unpack(da[ks][half * 2 + 1]);
        const float2 o2 = unpack(load_pair(ob + row1 * os.ss + c + half * 8));
        dl1 += d2.x * o2.x + d2.y * o2.y;
      }
    }
  }
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
  const long long lrow = ((long long)b * H + h) * S;
  if (tig == 0) {
    if (row0 < S) delta[lrow + row0] = dl0;
    if (row1 < S) delta[lrow + row1] = dl1;
  }
  // lse in the log2 domain; a row with nothing visible (lse = -inf) gets p = 0
  const float lse0 = row0 < S ? lse[lrow + row0] * kLog2e : -INFINITY;
  const float lse1 = row1 < S ? lse[lrow + row1] * kLog2e : -INFINITY;
  const float scale_log2 = scale * kLog2e;
  const bool m_alibi = kMasked && slopes != nullptr;  // the masked form's, at run time
  const float slope_log2 = kAlibi || m_alibi ? slopes[h] * kLog2e : 0.f;

  // the masked form's per-row operands
  const bool has_seg = kMasked && mask.seg != nullptr;
  const bool has_bias = kMasked && mask.bias != nullptr;
  const bool emit_dbias = kMasked && mask.dbias != nullptr;
  const int* seg_b = has_seg ? mask.seg + (long long)b * S : nullptr;
  const int* segk_b =
      has_seg ? (mask.seg_k != nullptr ? mask.seg_k : mask.seg) + (long long)b * S : nullptr;
  const int seg0 = has_seg && row0 < S ? seg_b[row0] : 0;
  const int seg1 = has_seg && row1 < S ? seg_b[row1] : 0;
  const long long bias_bh = has_bias ? b * mask.bias_sb + h * mask.bias_sh : 0;
  const long long dbias_bh = lrow * S;  // the full [B, H, S, S] output
  const int qoff = kMasked ? mask.qoff : 0;  // ring hops' global positions
  const int koff = kMasked ? mask.koff : 0;

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_all = (S + kBlockN - 1) / kBlockN;
  const int last_row = (qblock + 1) * kBlockM - 1;
  const int n_tiles =
      causal ? causal_key_tiles<kBlockN>(last_row, qoff, koff, n_all) : n_all;
  auto tile = [&](int t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile is fully consumed
    stage2<HD, kBlockN>(sk, sv, kb, ks_.ss, vb, vs.ss, k0, S, tid);
    if constexpr (kMasked) {
      if (has_seg && tid < kBlockN) sseg[tid] = k0 + tid < S ? segk_b[k0 + tid] : 0;
    }
    __syncthreads();

    float s[kSTiles][4], dp[kSTiles][4];
    rows_dot_tile<HD, kSTiles>(s, qa, sk, g, tig);
    rows_dot_tile<HD, kSTiles>(dp, da, sv, g, tig);
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tig * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const float l = e < 2 ? lse0 : lse1;
        const float dlt = e < 2 ? dl0 : dl1;
        float p = 0.f;
        if constexpr (kMasked) {
          const bool visible = key < S && row < S &&
                               (!causal || key + koff <= row + qoff) && l != -INFINITY &&
                               (!has_seg || sseg[key - k0] == (e < 2 ? seg0 : seg1));
          if (visible) {
            const float bias =
                has_bias ? load_bias(mask, bias_bh + row * mask.bias_sq + key) : 0.f;
            p = exp2f(masked_score(s[j][e], scale_log2, has_bias, bias, m_alibi,
                                   slope_log2, row + qoff, key + koff) - l);
          }
          const float dst = p * (dp[j][e] - dlt);
          if (emit_dbias && row < S && key < S) {
            store_dbias(mask, dbias_bh + (long long)row * S + key, dst);
          }
          s[j][e] = dst * scale;  // ds
        } else {
          const bool visible = key < S && row < S && (!causal || key <= row) &&
                               l != -INFINITY;
          if constexpr (kAlibi) {
            if (visible) p = exp2f(alibi_score(s[j][e], scale_log2, slope_log2, row, key) - l);
          } else {
            p = visible ? exp2f(s[j][e] * scale_log2 - l) : 0.f;
          }
          s[j][e] = p * (dp[j][e] - dlt) * scale;  // ds
        }
      }
    }
    tile_times_rows<HD, kSTiles>(acc, s, sk, g, tig);
  };

  if constexpr (kMasked) {
    for_tiles<kBlockN>(mask, mask.cols ? qblock * kBlockM / mask.blk : 0, 0, n_tiles,
                       tile);
    if (emit_dbias) {
      // the keys past the causal loop's last tile: dst = 0
      const int kz = n_tiles * kBlockN;
      const int rz = qblock * kBlockM;
      const int nz = S - kz;
      for (int i = tid; nz > 0 && i < kBlockM * nz; i += kThreads) {
        const int r = rz + i / nz;
        if (r < S) store_dbias(mask, dbias_bh + (long long)r * S + kz + i % nz, 0.f);
      }
    }
  } else {
    for (int t = 0; t < n_tiles; ++t) tile(t);
  }
  store_rows<HD>(dq + b * dqs.sb + h * dqs.sh, dqs.ss, acc, row0, row1, S, tig);
}

// ---------------------------------------------------------------------------
// dk, dv (summed over the GQA group)
// ---------------------------------------------------------------------------
template <int HD, bool kAlibi, bool kMasked>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
    int KV, Strides qs, Strides ks_, Strides vs, Strides dos, Strides dks,
    Strides dvs, const float* __restrict__ slopes, float scale, int causal, Mask mask) {
  constexpr int kBlockN = HD == 128 ? 32 : 64;  // queries per tile
  constexpr int kLds = HD + 8;
  constexpr int kSTiles = kBlockN / 8;
  __shared__ __align__(16) __nv_bfloat16 sq[kBlockN * kLds];
  __shared__ __align__(16) __nv_bfloat16 sdo[kBlockN * kLds];
  __shared__ float slse[kBlockN];
  __shared__ float sdelta[kBlockN];
  __shared__ int sseg[kMasked ? kBlockN : 1];  // the tile's query segment ids

  const int kblock = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int key0 = kblock * kBlockM + warp * 16 + g;  // this thread's key rows
  const int key1 = key0 + 8;

  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_rows<HD>(ka, k + b * ks_.sb + kvh * ks_.sh, ks_.ss, key0, key1, S, tig);
  load_rows<HD>(va, v + b * vs.sb + kvh * vs.sh, vs.ss, key0, key1, S, tig);
  const float scale_log2 = scale * kLog2e;

  // the masked form's per-key operands
  const bool has_seg = kMasked && mask.seg != nullptr;
  const bool has_bias = kMasked && mask.bias != nullptr;
  const bool m_alibi = kMasked && slopes != nullptr;
  const int* seg_b = has_seg ? mask.seg + (long long)b * S : nullptr;
  const int* segk_b =
      has_seg ? (mask.seg_k != nullptr ? mask.seg_k : mask.seg) + (long long)b * S : nullptr;
  const int segk0 = has_seg && key0 < S ? segk_b[key0] : 0;
  const int segk1 = has_seg && key1 < S ? segk_b[key1] : 0;
  const int qoff = kMasked ? mask.qoff : 0;  // ring hops' global positions
  const int koff = kMasked ? mask.koff : 0;

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const int n_all = (S + kBlockN - 1) / kBlockN;
  // first query tile that sees any key of this block
  const int t0 = causal ? causal_first_query_tile<kBlockN>(kblock * kBlockM, qoff, koff) : 0;
  for (int j = 0; j < group; ++j) {
    const int h = kvh * group + j;
    const __nv_bfloat16* qb = q + b * qs.sb + h * qs.sh;
    const __nv_bfloat16* dob = dout + b * dos.sb + h * dos.sh;
    const long long lrow = ((long long)b * H + h) * S;
    const float slope_log2 = kAlibi || m_alibi ? slopes[h] * kLog2e : 0.f;
    const long long bias_bh = has_bias ? b * mask.bias_sb + h * mask.bias_sh : 0;
    auto tile = [&](int t) {
      const int q0 = t * kBlockN;
      __syncthreads();  // the previous tile is fully consumed
      stage2<HD, kBlockN>(sq, sdo, qb, qs.ss, dob, dos.ss, q0, S, tid);
      for (int i = tid; i < kBlockN; i += kThreads) {
        const bool in = q0 + i < S;
        slse[i] = in ? lse[lrow + q0 + i] * kLog2e : -INFINITY;
        sdelta[i] = in ? delta[lrow + q0 + i] : 0.f;
        if constexpr (kMasked) {
          if (has_seg) sseg[i] = in ? seg_b[q0 + i] : 0;
        }
      }
      __syncthreads();

      // st = K Q^T (keys x queries), dpt = V dO^T
      float st[kSTiles][4], dpt[kSTiles][4];
      rows_dot_tile<HD, kSTiles>(st, ka, sq, g, tig);
      rows_dot_tile<HD, kSTiles>(dpt, va, sdo, g, tig);
#pragma unroll
      for (int jj = 0; jj < kSTiles; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = jj * 8 + tig * 2 + (e & 1);
          const int query = q0 + col;
          const int key = e < 2 ? key0 : key1;
          const float l = slse[col];
          float p = 0.f;
          if constexpr (kMasked) {
            const bool visible = query < S && key < S &&
                                 (!causal || key + koff <= query + qoff) &&
                                 l != -INFINITY &&
                                 (!has_seg || sseg[col] == (e < 2 ? segk0 : segk1));
            if (visible) {
              const float bias =
                  has_bias ? load_bias(mask, bias_bh + query * mask.bias_sq + key) : 0.f;
              p = exp2f(masked_score(st[jj][e], scale_log2, has_bias, bias, m_alibi,
                                     slope_log2, query + qoff, key + koff) - l);
            }
          } else {
            const bool visible = query < S && key < S &&
                                 (!causal || key <= query) && l != -INFINITY;
            if constexpr (kAlibi) {
              if (visible) {
                p = exp2f(alibi_score(st[jj][e], scale_log2, slope_log2, query, key) - l);
              }
            } else {
              p = visible ? exp2f(st[jj][e] * scale_log2 - l) : 0.f;
            }
          }
          st[jj][e] = p;
          dpt[jj][e] = p * (dpt[jj][e] - sdelta[col]) * scale;  // ds^T
        }
      }
      tile_times_rows<HD, kSTiles>(dva, st, sdo, g, tig);   // dv += p^T dO
      tile_times_rows<HD, kSTiles>(dka, dpt, sq, g, tig);   // dk += ds^T Q
    };
    if constexpr (kMasked) {
      for_tiles<kBlockN>(mask, mask.cols ? kblock * kBlockM / mask.blk : 0, t0, n_all,
                         tile);
    } else {
      for (int t = t0; t < n_all; ++t) tile(t);
    }
  }
  store_rows<HD>(dk + b * dks.sb + kvh * dks.sh, dks.ss, dka, key0, key1, S, tig);
  store_rows<HD>(dv + b * dvs.sb + kvh * dvs.sh, dvs.ss, dva, key0, key1, S, tig);
}

}  // namespace

// q, o, do, dq: [B, S, H, hd]; k, v: [B, S, KV, hd], each by its (batch, seq,
// head) strides (st: 3 per tensor in the order q, k, v, o, do, dq) with a
// contiguous last dim and 16-byte aligned rows. lse (in), delta (out): [B, H, S]
// fp32 contiguous. slopes: fp32 [H] ALiBi slopes on the device (those the
// forward took), or nullptr for none. mask: nullptr, or the forward's masked
// form (flash_attention.cuh:parse_mask, the table per query layout row),
// whose dbias slot may name a [B, H, S, S] output in the bias's dtype.
extern "C" int dst_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int S, int H, int KV, int hd,
    const long long* st, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || !table_ok(mask))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  using T = __nv_bfloat16;
  const Mask m = mask != nullptr ? parse_mask(mask) : Mask{};
#define DQ_ARGS                                                                   \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),   \
      static_cast<const T*>(o), static_cast<const T*>(dout),                      \
      static_cast<const float*>(lse), static_cast<float*>(delta),                 \
      static_cast<T*>(dq), S, H, KV, at(st, 0), at(st, 1), at(st, 2), at(st, 3),  \
      at(st, 4), at(st, 5), static_cast<const float*>(slopes), scale, causal, m
  const bool alibi = slopes != nullptr;
  const bool masked = mask != nullptr;
  if (hd == 128 && masked) {
    flash_bwd_dq_kernel<128, false, true><<<grid, kThreads, 0, s>>>(DQ_ARGS);
  } else if (hd == 128 && alibi) {
    flash_bwd_dq_kernel<128, true, false><<<grid, kThreads, 0, s>>>(DQ_ARGS);
  } else if (hd == 128) {
    flash_bwd_dq_kernel<128, false, false><<<grid, kThreads, 0, s>>>(DQ_ARGS);
  } else if (hd == 64 && masked) {
    flash_bwd_dq_kernel<64, false, true><<<grid, kThreads, 0, s>>>(DQ_ARGS);
  } else if (hd == 64 && alibi) {
    flash_bwd_dq_kernel<64, true, false><<<grid, kThreads, 0, s>>>(DQ_ARGS);
  } else if (hd == 64) {
    flash_bwd_dq_kernel<64, false, false><<<grid, kThreads, 0, s>>>(DQ_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DQ_ARGS
  return static_cast<int>(cudaGetLastError());
}

// q, do: [B, S, H, hd]; k, v, dk, dv: [B, S, KV, hd], by strides (st: q, k, v,
// do, dk, dv); lse, delta: [B, H, S] fp32 contiguous (delta from the dq kernel);
// slopes as for the dq kernel; mask as for the dq kernel but with the
// transposed table (per key layout column, its active query blocks) and no
// dbias.
extern "C" int dst_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
    int KV, int hd, const long long* st, const void* slopes, float scale,
    int causal, const long long* mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || !table_ok(mask))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + kBlockM - 1) / kBlockM, KV, B);
  using T = __nv_bfloat16;
  const Mask m = mask != nullptr ? parse_mask(mask) : Mask{};
#define DKV_ARGS                                                                  \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),   \
      static_cast<const T*>(dout), static_cast<const float*>(lse),                \
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), \
      S, H, KV, at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5), \
      static_cast<const float*>(slopes), scale, causal, m
  const bool alibi = slopes != nullptr;
  const bool masked = mask != nullptr;
  if (hd == 128 && masked) {
    flash_bwd_dkv_kernel<128, false, true><<<grid, kThreads, 0, s>>>(DKV_ARGS);
  } else if (hd == 128 && alibi) {
    flash_bwd_dkv_kernel<128, true, false><<<grid, kThreads, 0, s>>>(DKV_ARGS);
  } else if (hd == 128) {
    flash_bwd_dkv_kernel<128, false, false><<<grid, kThreads, 0, s>>>(DKV_ARGS);
  } else if (hd == 64 && masked) {
    flash_bwd_dkv_kernel<64, false, true><<<grid, kThreads, 0, s>>>(DKV_ARGS);
  } else if (hd == 64 && alibi) {
    flash_bwd_dkv_kernel<64, true, false><<<grid, kThreads, 0, s>>>(DKV_ARGS);
  } else if (hd == 64) {
    flash_bwd_dkv_kernel<64, false, false><<<grid, kThreads, 0, s>>>(DKV_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DKV_ARGS
  return static_cast<int>(cudaGetLastError());
}
