// Flash attention forward (bf16, causal or not, GQA) with mma.sync tensor cores.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:_fwd_kernel (line 175),
// driven by _flash_fwd (line 334) from flash_attention (line 1011), in all its
// forms: causal, grouped-query heads, ALiBi slopes, segment ids, a dense
// additive bias, a block-sparse layout and the position offsets of ring
// attention's hops (has_offsets; the hops are deepspeed_tpu/ops/pallas/
// ring_flash.py:_rf_fwd, line 83, ported by deepspeed_tpu_torch/ops/ring_flash.py).
//
// out[b, s, h] = softmax_k(score, masks) @ v with
// score = q[b, s, h] . k[b, k, kv]^T * scale + bias[b, h, s, k] - slope[h] * |s - k|,
// kv = h / (H / KV); lse[b, h, s] = log sum_k exp(score), kept for a backward.
// A key is visible when it is inside S, not above the diagonal (causal), in
// the row's segment (seg[b, s] == seg[b, k]) and in an active block of the
// layout; _mask_and_bias (flash_attention.py:94-113) applies the same masks.
// Under offsets (a ring hop: the local query chunk against a visiting key
// chunk) the row's and the key's global positions s + qoff and k + koff take
// their places in the causal test and the ALiBi distance, the keys' segment
// ids are the visiting chunk's (seg_k), the causal walk stops at the last key
// tile a row of the block sees (none when the chunk lies wholly in the
// future: out = 0, lse = -1e30) and a past chunk is walked whole.
// Three instantiations per head dim: slopes == nullptr without a mask (Llama),
// whose code and bits are those of the kernel before ALiBi came in; ALiBi
// without a mask; and the masked form, which reads its segment ids, bias,
// compaction tables and (optional) slopes at run time (flash_attention.cuh).
//
// Bound on the H100: operations for long prompts. The product is 4 * D flops
// per visible (query, key) pair over 989 TFLOP/s of bf16 tensor-core rate;
// q, k, v and out are read or written once, a dense bias once per visible
// pair. Design: one 128-thread block (4 warps) per (64-row query tile, head,
// batch row). Each warp owns 16 query rows and keeps its Q fragments, its
// 16 x 64 score tile, its fp32 output accumulator and its online-softmax
// state (max, sum) in registers. Q K^T and P V are mma.sync m16n8k16 bf16
// products with fp32 accumulation; P is rounded to bf16 for the second
// product, as the TPU kernel does. K and V tiles of 64 keys are staged in
// padded shared memory (row stride HD + 8, conflict-free fragment reads), the
// tile's key segment ids beside them. The key loop stops at the diagonal,
// which is the causal skip the TPU kernel gets from its compaction tables;
// with a layout it walks only the tiles of each active block (the table is
// per 64-row query tile's layout row; inactive blocks are never read), which
// is the TPU kernel's compacted grid (_sparse_step, flash_attention.py:138).
// A tile the segments mask whole keeps the running max at -inf and is guarded
// by ms = 0; a row with nothing visible writes out = 0 and lse = -inf (the
// masked form: -1e30, the JAX package's finite NEG_INF). Heads are addressed
// through strides, so the model layout [B, S, H, D] is read and written
// without transposes, and every row and key past S is masked in the kernel:
// any prompt length runs here, where the TPU entry fell back to XLA for
// lengths without a 128-aligned tile. The scores live in the log2 domain
// (s * scale * log2 e); alibi_score and masked_score (flash_attention.cuh)
// pin their rounding, and the backward kernels use the same functions, so p
// recomputed there is the p whose sum went into lse. wgmma, TMA and a
// pipelined K/V ring are later work.
#include "flash_attention.cuh"

using namespace dst::flash;

namespace {

constexpr int kBlockN = 64;  // keys per tile

template <int HD, bool kAlibi, bool kMasked>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int S, int H, int KV, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, const float* __restrict__ slopes,
    float scale_log2, int causal, Mask mask) {
  constexpr int kLds = HD + 8;           // shared row stride, in elements
  constexpr int kKSteps = HD / 16;       // k-steps of Q K^T
  constexpr int kSTiles = kBlockN / 8;   // n-tiles of the score tile
  constexpr int kOTiles = HD / 8;        // n-tiles of the output
  constexpr int kChunks = HD / 8;        // 16-byte chunks per K/V row
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
  const int g = lane >> 2;   // row within the 8-row half of the fragment
  const int tig = lane & 3;  // thread within the group of four
  const int row0 = qblock * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;
  // the masked form takes slopes at run time
  const bool m_alibi = kMasked && slopes != nullptr;
  const float slope_log2 = kAlibi || m_alibi ? slopes[h] * 1.4426950408889634f : 0.f;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  // the masked form's per-row operands
  const bool has_seg = kMasked && mask.seg != nullptr;
  const bool has_bias = kMasked && mask.bias != nullptr;
  const int* seg_b = has_seg ? mask.seg + (long long)b * S : nullptr;
  const int* segk_b =
      has_seg ? (mask.seg_k != nullptr ? mask.seg_k : mask.seg) + (long long)b * S : nullptr;
  const int seg0 = has_seg && row0 < S ? seg_b[row0] : 0;
  const int seg1 = has_seg && row1 < S ? seg_b[row1] : 0;
  const long long bias_bh = has_bias ? b * mask.bias_sb + h * mask.bias_sh : 0;
  const int qoff = kMasked ? mask.qoff : 0;  // ring hops' global positions
  const int koff = kMasked ? mask.koff : 0;

  // Q fragments (A operand) straight from device memory, once per block.
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int c = ks * 16 + tig * 2;
    qa[ks][0] = row0 < S ? load_pair(qb + row0 * q_ss + c) : 0u;
    qa[ks][1] = row1 < S ? load_pair(qb + row1 * q_ss + c) : 0u;
    qa[ks][2] = row0 < S ? load_pair(qb + row0 * q_ss + c + 8) : 0u;
    qa[ks][3] = row1 < S ? load_pair(qb + row1 * q_ss + c + 8) : 0u;
  }

  float o[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // running sum over this thread's columns

  const int n_all = (S + kBlockN - 1) / kBlockN;
  const int last_row = (qblock + 1) * kBlockM - 1;
  const int n_tiles =
      causal ? causal_key_tiles<kBlockN>(last_row, qoff, koff, n_all) : n_all;

  auto tile = [&](int t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < kBlockN * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * 8;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < S) {
        kval = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * k_ss + c);
        vval = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * v_ss + c);
      }
      *reinterpret_cast<uint4*>(sk + r * kLds + c) = kval;
      *reinterpret_cast<uint4*>(sv + r * kLds + c) = vval;
    }
    if constexpr (kMasked) {
      if (has_seg && tid < kBlockN) sseg[tid] = k0 + tid < S ? segk_b[k0 + tid] : 0;
    }
    __syncthreads();

    // scores: s = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        const __nv_bfloat16* kr = sk + (j * 8 + g) * kLds + ks * 16 + tig * 2;
        mma_16816(s[j], qa[ks], load_pair(kr), load_pair(kr + 8));
      }
    }

    // scale to the log2 domain, mask, and fold into the online softmax
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tig * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        if constexpr (kMasked) {
          const bool visible = key < S && row < S && (!causal || key + koff <= row + qoff) &&
                               (!has_seg || sseg[key - k0] == (e < 2 ? seg0 : seg1));
          s[j][e] = visible
                        ? masked_score(s[j][e], scale_log2, has_bias,
                                       has_bias ? load_bias(mask, bias_bh +
                                                                  row * mask.bias_sq + key)
                                                : 0.f,
                                       m_alibi, slope_log2, row + qoff, key + koff)
                        : -INFINITY;
        } else {
          const bool visible = key < S && (!causal || key <= row);
          if constexpr (kAlibi) {
            s[j][e] = visible ? alibi_score(s[j][e], scale_log2, slope_log2, row, key)
                              : -INFINITY;
          } else {
            s[j][e] = visible ? s[j][e] * scale_log2 : -INFINITY;
          }
        }
      }
      mt0 = fmaxf(mt0, fmaxf(s[j][0], s[j][1]));
      mt1 = fmaxf(mt1, fmaxf(s[j][2], s[j][3]));
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0);
    const float mn1 = fmaxf(m1, mt1);
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;  // rows with nothing visible yet
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    const float c0 = exp2f(m0 - ms0);
    const float c1 = exp2f(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][0] = exp2f(s[j][0] - ms0);
      s[j][1] = exp2f(s[j][1] - ms0);
      s[j][2] = exp2f(s[j][2] - ms1);
      s[j][3] = exp2f(s[j][3] - ms1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // o += P V: the score fragments of two adjacent n-tiles are the A
    // fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        const __nv_bfloat16* vr = sv + (kk * 16 + tig * 2) * kLds + n * 8 + g;
        const uint32_t b0 = pack_bf16(vr[0], vr[kLds]);
        const uint32_t b1 = pack_bf16(vr[8 * kLds], vr[9 * kLds]);
        mma_16816(o[n], pa, b0, b1);
      }
    }
  };

  if constexpr (kMasked) {
    for_tiles<kBlockN>(mask, mask.cols ? qblock * kBlockM / mask.blk : 0, 0, n_tiles,
                       tile);
  } else {
    for (int t = 0; t < n_tiles; ++t) tile(t);
  }

  // the four threads of a group hold disjoint columns of the same rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 == 0.f ? 1.f : l0;
  const float d1 = l1 == 0.f ? 1.f : l1;
  const float empty_lse = kMasked ? kNegInf : -INFINITY;  // a row with nothing visible
  if (row0 < S) {
    __nv_bfloat16* orow = out + b * o_sb + row0 * o_ss + h * o_sh + tig * 2;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_f32(o[n][0] / d0, o[n][1] / d0);
    }
    if (tig == 0) {
      lse[((long long)b * H + h) * S + row0] =
          l0 == 0.f ? empty_lse : (m0 + log2f(l0)) * kLn2;
    }
  }
  if (row1 < S) {
    __nv_bfloat16* orow = out + b * o_sb + row1 * o_ss + h * o_sh + tig * 2;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_f32(o[n][2] / d1, o[n][3] / d1);
    }
    if (tig == 0) {
      lse[((long long)b * H + h) * S + row1] =
          l1 == 0.f ? empty_lse : (m1 + log2f(l1)) * kLn2;
    }
  }
}

template <int HD, bool kAlibi, bool kMasked>
void launch(const void* q, const void* k, const void* v, void* out, void* lse,
            int B, int S, int H, int KV, const long long* st, const float* slopes,
            float scale_log2, int causal, const Mask& mask, cudaStream_t stream) {
  dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<HD, kAlibi, kMasked><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), S, H, KV, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], slopes, scale_log2, causal,
      mask);
}

template <int HD>
void launch_form(const void* q, const void* k, const void* v, void* out, void* lse,
                 int B, int S, int H, int KV, const long long* st,
                 const float* slopes, float scale_log2, int causal,
                 const long long* mask, cudaStream_t stream) {
  if (mask != nullptr) {
    launch<HD, false, true>(q, k, v, out, lse, B, S, H, KV, st, slopes, scale_log2,
                            causal, parse_mask(mask), stream);
  } else if (slopes != nullptr) {
    launch<HD, true, false>(q, k, v, out, lse, B, S, H, KV, st, slopes, scale_log2,
                            causal, Mask{}, stream);
  } else {
    launch<HD, false, false>(q, k, v, out, lse, B, S, H, KV, st, slopes, scale_log2,
                             causal, Mask{}, stream);
  }
}

}  // namespace

// q: [B, S, H, hd], k/v: [B, S, KV, hd], out: [B, S, H, hd], each by its
// (batch, seq, head) strides with a contiguous last dim; every row start
// 16-byte aligned. lse: [B, H, S] fp32 contiguous. slopes: fp32 [H] ALiBi
// slopes on the device, or nullptr for none. scale: softmax scale applied to
// q . k (1 / sqrt(hd) for the model). mask: nullptr, or long long[14] naming
// the masked form's segment ids, bias, compaction tables, the keys' segment
// ids and the position offsets (flash_attention.cuh:parse_mask; the table is
// per query layout row).
extern "C" int dst_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int KV, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!table_ok(mask)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  const float* sl = static_cast<const float*>(slopes);
  if (hd == 128) {
    launch_form<128>(q, k, v, out, lse, B, S, H, KV, st, sl, scale_log2, causal, mask, s);
  } else if (hd == 64) {
    launch_form<64>(q, k, v, out, lse, B, S, H, KV, st, sl, scale_log2, causal, mask, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
