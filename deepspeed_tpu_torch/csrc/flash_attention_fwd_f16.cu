// Flash attention forward, fp16: the Llama form (causal or not, GQA, no
// slopes, no mask, no offsets) at head dims 64 and 128, for fp16 training
// with the dynamic loss scaler (deepspeed_tpu/runtime/precision.py; the
// Pallas kernel, flash_attention.py:175, is dtype-generic and rounds p to
// v's dtype, line 237, as this one rounds p to fp16 before P V). The same
// wgmma + TMA kernel as the bf16 form (flash_attention_fwd.cuh) with T =
// __half: .f32.f16.f16 products, fp16 tensor maps, round-to-nearest fp16
// packing (+-inf past 65504, never clamped). Its own translation unit, so
// _build.py compiles it beside the bf16 one. The other fp16 forms are ROADMAP
// A6 part 2.
#include "flash_attention_fwd.cuh"

// As dst_flash_attention_fwd, fp16 q, k, v, out; slopes and mask must be
// nullptr (cudaErrorInvalidValue otherwise).
extern "C" int dst_flash_attention_fwd_f16(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int KV, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  return fwd_entry<__half>(
      q, k, v, out, lse, B, S, H, KV, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, o_sb, o_ss, o_sh, slopes, scale, causal, mask, stream);
}
