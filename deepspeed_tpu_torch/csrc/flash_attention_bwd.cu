// Flash attention backward, bf16: the C entries of the dq and dk/dv
// kernels in every form (Llama, ALiBi, masked, ring-hop offsets). The
// kernels and their design are in flash_attention_bwd.cuh;
// flash_attention_bwd_f16.cu has the fp16 entries.
#include "flash_attention_bwd.cuh"

// q, o, do, dq: [B, S, H, hd]; k, v: [B, S, KV, hd], each by its (batch, seq,
// head) strides (st: 3 per tensor in the order q, k, v, o, do, dq) with a
// contiguous last dim; q, k, v, do are read by TMA (16-byte aligned start and
// strides). lse (in), delta (out): [B, H, S] fp32 contiguous. slopes: fp32 [H]
// ALiBi slopes on the device (those the forward took), or nullptr for none.
// mask: nullptr, or the forward's masked form (flash_attention.cuh:parse_mask,
// the table per query layout row), whose dbias slot may name a [B, H, S, S]
// output in the bias's dtype.
extern "C" int dst_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int S, int H, int KV, int hd,
    const long long* st, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  return dq_entry<__nv_bfloat16>(
      q, k, v, o, dout, lse, delta, dq, B, S, H, KV, hd, st, slopes, scale, causal, mask,
      stream);
}

// q, do: [B, S, H, hd]; k, v, dk, dv: [B, S, KV, hd], by strides (st: q, k, v,
// do, dk, dv; q, k, v, do read by TMA); lse, delta: [B, H, S] fp32 contiguous
// (delta from the dq kernel); slopes as for the dq kernel; mask as for the dq
// kernel but with the transposed table (per key layout column, its active
// query blocks) and no dbias.
extern "C" int dst_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
    int KV, int hd, const long long* st, const void* slopes, float scale,
    int causal, const long long* mask, void* stream) {
  return dkv_entry<__nv_bfloat16>(
      q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, hd, st, slopes, scale, causal,
      mask, stream);
}
