// Gradient of a broadcast dense attention bias, fp16 q/k/v: the C entry, for
// fp16 training with the dynamic loss scaler. The Pallas kernel
// (flash_attention.py:570 _bias_grad_kernel) is dtype-generic; this is the
// bf16 kernel's design (flash_attention_bias_grad.cuh) with T = __half:
// .f32.f16.f16 products and fp16 tensor maps. dbias is written in the bias's
// dtype (fp32, bf16 or fp16), an fp16 one rounded to nearest (+-inf past
// 65504, never clamped, so a scaled gradient's overflow stays visible). Its
// own translation unit, compiled beside the bf16 one.
#include "flash_attention_bias_grad.cuh"

// As dst_flash_attention_bias_grad with fp16 q, k, v, do.
extern "C" int dst_flash_attention_bias_grad_f16(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, int B, int S, int H, int KV, int hd, int Bb, int Hb,
    const long long* st, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  return bias_grad_entry<__half>(q, k, v, dout, lse, delta, B, S, H, KV, hd, Bb, Hb, st,
                                slopes, scale, causal, mask, stream);
}
