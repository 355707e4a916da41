// Gradient of a broadcast dense attention bias, bf16 q/k/v: the C entry. The
// kernel and its design are in flash_attention_bias_grad.cuh;
// flash_attention_bias_grad_f16.cu has the fp16 entry.
#include "flash_attention_bias_grad.cuh"

// q, do: [B, S, H, hd]; k, v: [B, S, KV, hd], by strides (st: q, k, v, do;
// read by TMA: 16-byte aligned start and strides); lse and delta (the dq
// kernel's): [B, H, S] fp32 contiguous. slopes: fp32 [H] or nullptr. mask: the
// forward's masked form (flash_attention.cuh:parse_mask) with its bias
// [Bb, Hb, S, S] (Bb in {1, B}, Hb in {1, H}; read by TMA: 16-byte aligned
// start and query-row stride) and, in the dbias slot, the [Bb, Hb, S, S]
// contiguous output in the bias's dtype; no table, no offsets.
extern "C" int dst_flash_attention_bias_grad(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, int B, int S, int H, int KV, int hd, int Bb, int Hb,
    const long long* st, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  return bias_grad_entry<__nv_bfloat16>(q, k, v, dout, lse, delta, B, S, H, KV, hd, Bb, Hb, st,
                                       slopes, scale, causal, mask, stream);
}
