// Gradient of a broadcast dense attention bias (bf16 q/k/v, GQA), with
// mma.sync tensor cores.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:_bias_grad_kernel
// (line 570), driven by _bias_grad_call (line 614) from _flash_bwd when the
// bias broadcasts over the batch or the heads ([1, H, S, S], [B, 1, S, S] or
// [1, 1, S, S]):
//   dbias[bo, ho, i, j] = sum over the (b, h) that read bias[bo, ho] of
//                         p[b, h, i, j] * (dp[b, h, i, j] - delta[b, h, i])
// with p = exp(s - lse) recomputed from the forward's lse (s with the same
// bias, segment ids and ALiBi slopes, by flash_attention.cuh:masked_score, the
// forward's and the dq kernel's score), dp = do . v, and delta from the dq
// kernel. dbias is written in the bias's dtype.
//
// Bound on the H100: operations. Each (b, h, i, j) visible pair costs the two
// recomputed products q.k and do.v, 4 * D flops, over 989 TFLOP/s bf16; the
// bytes are dbias written once plus q, do, k, v re-read per tile. Design: one
// 128-thread block per (64 query rows, 64 keys, or 32 at head_dim 128) tile
// of one output slab (bo, ho). The block loops the broadcast dims in a fixed
// order (heads outer, batch rows inner, as the Pallas grid's innermost
// accumulation runs), and for each (b, h) loads its Q and dO fragments into
// registers and its K and V tile into shared memory, recomputes the score and
// dp tiles with mma.sync and adds dst into fp32 registers. Each output tile is
// written once, with no atomics, so the result is deterministic; a tile above
// the causal diagonal is written as zeros without any product.
#include "flash_attention.cuh"

using namespace dst::flash;

namespace {

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bias_grad_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int B, int S,
    int H, int KV, int Bb, int Hb, Strides qs, Strides ks_, Strides vs, Strides dos,
    const float* __restrict__ slopes, float scale, int causal, Mask mask) {
  constexpr int kBlockN = HD == 128 ? 32 : 64;  // keys per tile
  constexpr int kLds = HD + 8;
  constexpr int kSTiles = kBlockN / 8;
  __shared__ __align__(16) __nv_bfloat16 sk[kBlockN * kLds];
  __shared__ __align__(16) __nv_bfloat16 sv[kBlockN * kLds];
  __shared__ int sseg[kBlockN];

  const int qblock = blockIdx.x;
  const int k0 = blockIdx.y * kBlockN;
  const int bo = blockIdx.z / Hb;  // the output slab
  const int ho = blockIdx.z % Hb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = qblock * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;
  const float scale_log2 = scale * kLog2e;
  const bool has_seg = mask.seg != nullptr;
  const bool has_alibi = slopes != nullptr;
  const long long bias_bh = bo * mask.bias_sb + ho * mask.bias_sh;

  float acc[kSTiles][4];
#pragma unroll
  for (int j = 0; j < kSTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // a tile wholly above the diagonal has dst = 0
  const bool any_visible = !causal || k0 <= (qblock + 1) * kBlockM - 1;
  const int nb = Bb == 1 ? B : 1;
  const int nh = Hb == 1 ? H : 1;
  for (int hi = 0; any_visible && hi < nh; ++hi) {
    const int h = Hb == 1 ? hi : ho;
    const int kvh = h / (H / KV);
    const float slope_log2 = has_alibi ? slopes[h] * kLog2e : 0.f;
    for (int bi = 0; bi < nb; ++bi) {
      const int b = Bb == 1 ? bi : bo;
      const long long lrow = ((long long)b * H + h) * S;
      uint32_t qa[HD / 16][4], da[HD / 16][4];
      load_rows<HD>(qa, q + b * qs.sb + h * qs.sh, qs.ss, row0, row1, S, tig);
      load_rows<HD>(da, dout + b * dos.sb + h * dos.sh, dos.ss, row0, row1, S, tig);
      const float lse0 = row0 < S ? lse[lrow + row0] * kLog2e : -INFINITY;
      const float lse1 = row1 < S ? lse[lrow + row1] * kLog2e : -INFINITY;
      const float dl0 = row0 < S ? delta[lrow + row0] : 0.f;
      const float dl1 = row1 < S ? delta[lrow + row1] : 0.f;
      const int* seg_b = has_seg ? mask.seg + (long long)b * S : nullptr;
      const int seg0 = has_seg && row0 < S ? seg_b[row0] : 0;
      const int seg1 = has_seg && row1 < S ? seg_b[row1] : 0;

      __syncthreads();  // the previous (b, h)'s tile is fully consumed
      stage2<HD, kBlockN>(sk, sv, k + b * ks_.sb + kvh * ks_.sh, ks_.ss,
                          v + b * vs.sb + kvh * vs.sh, vs.ss, k0, S, tid);
      if (has_seg && tid < kBlockN) sseg[tid] = k0 + tid < S ? seg_b[k0 + tid] : 0;
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
          const bool visible = key < S && row < S && (!causal || key <= row) &&
                               l != -INFINITY &&
                               (!has_seg || sseg[key - k0] == (e < 2 ? seg0 : seg1));
          if (visible) {
            const float bias = load_bias(mask, bias_bh + row * mask.bias_sq + key);
            const float p = exp2f(masked_score(s[j][e], scale_log2, true, bias, has_alibi,
                                               slope_log2, row, key) - l);
            acc[j][e] += p * (dp[j][e] - (e < 2 ? dl0 : dl1));
          }
        }
      }
    }
  }

  // one write per output element, in the bias's dtype
  const long long out_bh = ((long long)bo * Hb + ho) * S;
#pragma unroll
  for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + j * 8 + tig * 2 + (e & 1);
      const int row = e < 2 ? row0 : row1;
      if (row < S && key < S) store_dbias(mask, (out_bh + row) * S + key, acc[j][e]);
    }
  }
}

}  // namespace

// q, do: [B, S, H, hd]; k, v: [B, S, KV, hd], by strides (st: q, k, v, do);
// lse and delta (the dq kernel's): [B, H, S] fp32 contiguous. slopes: fp32 [H]
// or nullptr. mask: the forward's masked form (flash_attention.cuh:parse_mask)
// with its bias [Bb, Hb, S, S] (Bb in {1, B}, Hb in {1, H}) and, in the dbias
// slot, the [Bb, Hb, S, S] contiguous output in the bias's dtype; no table.
extern "C" int dst_flash_attention_bias_grad(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, int B, int S, int H, int KV, int hd, int Bb, int Hb,
    const long long* st, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || mask == nullptr || mask[1] == 0 || mask[10] == 0 ||
      mask[6] != 0 || (Bb != 1 && Bb != B) || (Hb != 1 && Hb != H))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask m = parse_mask(mask);
  using T = __nv_bfloat16;
#define BG_ARGS                                                                     \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),     \
      static_cast<const T*>(dout), static_cast<const float*>(lse),                  \
      static_cast<const float*>(delta), B, S, H, KV, Bb, Hb, at(st, 0), at(st, 1),  \
      at(st, 2), at(st, 3), static_cast<const float*>(slopes), scale, causal, m
  if (hd == 128) {
    dim3 grid((S + kBlockM - 1) / kBlockM, (S + 31) / 32, Bb * Hb);
    flash_bias_grad_kernel<128><<<grid, kThreads, 0, s>>>(BG_ARGS);
  } else if (hd == 64) {
    dim3 grid((S + kBlockM - 1) / kBlockM, (S + 63) / 64, Bb * Hb);
    flash_bias_grad_kernel<64><<<grid, kThreads, 0, s>>>(BG_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BG_ARGS
  return static_cast<int>(cudaGetLastError());
}
