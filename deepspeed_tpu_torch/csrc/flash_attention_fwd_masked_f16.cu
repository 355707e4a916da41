// Flash attention forward, fp16, the masked form: segment ids (a ring hop's
// query and key ids too, at its position offsets), a dense additive bias
// (fp32, bf16 or fp16) and block-sparse compaction tables, ALiBi slopes with
// any of them. The masked instantiation of flash_attention_fwd.cuh with T =
// __half at head dims 64 and 128, in a unit of its own so that nvcc compiles
// it beside the fp16 Llama/ALiBi unit; reached through
// dst_flash_attention_fwd_f16 (flash_attention_fwd_f16.cu), which sends it
// the calls whose mask needs it.
#include "flash_attention_fwd.cuh"

// As dst_flash_attention_fwd_f16 with a mask that needs the masked form
// (cudaErrorInvalidValue otherwise).
extern "C" int dst_flash_attention_fwd_masked_f16(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int KV, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  return fwd_entry<__half, kFormMasked>(
      q, k, v, out, lse, B, S, H, KV, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, o_sb, o_ss, o_sh, slopes, scale, causal, mask, stream);
}
