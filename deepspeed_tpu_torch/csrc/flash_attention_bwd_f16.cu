// Flash attention backward, fp16: the dq and dk/dv kernels in the Llama
// form (causal or not, GQA, no slopes, no mask, no offsets) at head dims 64
// and 128, for fp16 training with the dynamic loss scaler. The Pallas
// kernels (flash_attention.py:455, :517) are dtype-generic: they round p to
// v's dtype (line 555) and dS to k's and q's (lines 501, 560), as these round
// p and dst to fp16 before dV += P^T dO, dQ += dS K and dK += dS^T Q. The
// same wgmma + TMA kernels as the bf16 forms (flash_attention_bwd.cuh) with
// T = __half: .f32.f16.f16 products, fp16 tensor maps, round-to-nearest fp16
// packing (+-inf past 65504, never clamped, so a scaled gradient's overflow
// stays visible). Their own translation unit, compiled beside the bf16 one.
// The other fp16 forms are ROADMAP A6 part 2.
#include "flash_attention_bwd.cuh"

// As dst_flash_attention_bwd_dq with fp16 q, k, v, o, do, dq; slopes and
// mask must be nullptr (cudaErrorInvalidValue otherwise).
extern "C" int dst_flash_attention_bwd_dq_f16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int S, int H, int KV, int hd,
    const long long* st, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  return dq_entry<__half>(
      q, k, v, o, dout, lse, delta, dq, B, S, H, KV, hd, st, slopes, scale, causal, mask,
      stream);
}

// As dst_flash_attention_bwd_dkv with fp16 q, k, v, do, dk, dv; slopes and
// mask must be nullptr.
extern "C" int dst_flash_attention_bwd_dkv_f16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
    int KV, int hd, const long long* st, const void* slopes, float scale,
    int causal, const long long* mask, void* stream) {
  return dkv_entry<__half>(
      q, k, v, dout, lse, delta, dk, dv, B, S, H, KV, hd, st, slopes, scale, causal,
      mask, stream);
}
