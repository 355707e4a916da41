// Flash attention backward, fp16, the masked form: the dq kernel (with the
// full bias's gradient, emit_dbias, in the bias's dtype) and the dk/dv kernel
// under segment ids (a ring hop's query and key ids too, at its offsets), a
// dense additive bias (fp32, bf16 or fp16) and block-sparse tables, ALiBi
// slopes with any of them. The masked instantiations of
// flash_attention_bwd.cuh with T = __half at head dims 64 and 128, in a unit
// of their own so that nvcc compiles them beside the fp16 unmasked unit;
// reached through dst_flash_attention_bwd_{dq,dkv}_f16
// (flash_attention_bwd_f16.cu), which send them the calls whose mask needs
// them.
#include "flash_attention_bwd.cuh"

// As dst_flash_attention_bwd_dq_f16 with a mask that needs the masked form
// (cudaErrorInvalidValue otherwise).
extern "C" int dst_flash_attention_bwd_dq_masked_f16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int S, int H, int KV, int hd,
    const long long* st, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  return dq_entry<__half, kFormMasked>(
      q, k, v, o, dout, lse, delta, dq, B, S, H, KV, hd, st, slopes, scale, causal, mask,
      stream);
}

// As dst_flash_attention_bwd_dkv_f16 with a mask that needs the masked form.
extern "C" int dst_flash_attention_bwd_dkv_masked_f16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
    int KV, int hd, const long long* st, const void* slopes, float scale,
    int causal, const long long* mask, void* stream) {
  return dkv_entry<__half, kFormMasked>(
      q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, hd, st, slopes, scale, causal,
      mask, stream);
}
