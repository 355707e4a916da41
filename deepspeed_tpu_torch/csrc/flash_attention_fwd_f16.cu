// Flash attention forward, fp16: the C entry of every form (Llama, ALiBi,
// masked, ring-hop offsets) at head dims 64 and 128, for fp16 training with
// the dynamic loss scaler (deepspeed_tpu/runtime/precision.py; the Pallas
// kernel, flash_attention.py:175, is dtype-generic and rounds p to v's dtype,
// line 237, as this one rounds p to fp16 before P V). The same wgmma + TMA
// kernel as the bf16 form (flash_attention_fwd.cuh) with T = __half:
// .f32.f16.f16 products, fp16 tensor maps, round-to-nearest fp16 packing
// (+-inf past 65504, never clamped). This unit holds the Llama and ALiBi
// instantiations; the masked one (segment ids, a dense bias, a block-sparse
// table, a hop's offsets with segment ids) is
// flash_attention_fwd_masked_f16.cu, so _build.py compiles the two beside
// the bf16 unit at once.
#include "flash_attention_fwd.cuh"

// flash_attention_fwd_masked_f16.cu
extern "C" int dst_flash_attention_fwd_masked_f16(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int KV, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, const void* slopes, float scale, int causal,
    const long long* mask, void* stream);

// As dst_flash_attention_fwd, fp16 q, k, v, out; a dense bias in fp32, bf16
// or fp16.
extern "C" int dst_flash_attention_fwd_f16(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int KV, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  if (mask != nullptr && needs_masked(parse_mask(mask))) {
    return dst_flash_attention_fwd_masked_f16(
        q, k, v, out, lse, B, S, H, KV, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
        v_sh, o_sb, o_ss, o_sh, slopes, scale, causal, mask, stream);
  }
  return fwd_entry<__half, kFormPlain | kFormAlibi>(
      q, k, v, out, lse, B, S, H, KV, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, o_sb, o_ss, o_sh, slopes, scale, causal, mask, stream);
}
