// GQA decode attention against a KV cache, fp16: the C entries of the
// contiguous and paged forms, dense and int8, for fp16 serving. The Pallas
// kernels (deepspeed_tpu/ops/pallas/decode_attention.py:_decode_kernel, line
// 76, and _paged_decode_kernel, line 111) compute in q's dtype: an int8 tile
// is dequantized to it, a cache stored in another dtype is cast to it, and p
// is rounded to the cache's dtype before P V (_tile_update:35, lines 42-48
// and 64). The same kernel as the bf16 forms (decode_attention.cuh) with
// T = __half: .f32.f16.f16 products, P rounded once to fp16, the output
// rounded to nearest fp16 (+-inf past 65504). Each entry takes the bf16
// entry's arguments; `dtype` names the cache's storage: fp16, or bf16 for
// the mixed form (kv_cache_dtype="bf16" on an fp16 engine), whose tiles are
// converted to fp16 as they land; the int8 entries take fp16 only.
#include "decode_attention.cuh"

namespace {

template <bool kInt8, bool kPaged>
int dispatch_f16(Args& a, int rows, int hd, int cache_dtype, cudaStream_t s) {
  if constexpr (kInt8) {
    if (cache_dtype == dst::kFloat16) return run<__half, int8_t, kPaged>(a, rows, hd, s);
  } else {
    if (cache_dtype == dst::kFloat16) return run<__half, __half, kPaged>(a, rows, hd, s);
    if (cache_dtype == dst::kBFloat16) {
      return run<__half, __nv_bfloat16, kPaged>(a, rows, hd, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As dst_decode_attention with fp16 q and out; k, v fp16 or (cache_dtype
// bf16) bf16.
extern "C" int dst_decode_attention_f16(
    const void* q, const void* k, const void* v, void* out,
    const void* cache_len, int cache_len_scalar, int rows, int Smax, int H,
    int KV, int hd, int rows_per_seq, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, const void* slopes, float scale, int cache_dtype,
    void* stream) {
  Args a = base_args(q, k, v, out, H, KV, rows_per_seq, q_sb, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, slopes, scale);
  set_dense(a, cache_len, cache_len_scalar, Smax);
  return dispatch_f16<false, false>(a, rows, hd, cache_dtype,
                                    static_cast<cudaStream_t>(stream));
}

// As dst_decode_attention_int8 with fp16 q and out (cache_dtype fp16).
extern "C" int dst_decode_attention_int8_f16(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, const void* cache_len, int cache_len_scalar,
    int rows, int Smax, int H, int KV, int hd, int rows_per_seq, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long ks_sb,
    long long ks_sh, long long vs_sb, long long vs_sh, const void* slopes,
    float scale, int cache_dtype, void* stream) {
  Args a = base_args(q, k, v, out, H, KV, rows_per_seq, q_sb, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, slopes, scale);
  set_scales(a, k_scale, v_scale, ks_sb, ks_sh, vs_sb, vs_sh);
  set_dense(a, cache_len, cache_len_scalar, Smax);
  return dispatch_f16<true, false>(a, rows, hd, cache_dtype,
                                   static_cast<cudaStream_t>(stream));
}

// As dst_paged_decode_attention with fp16 q and out; the pool fp16 or
// (cache_dtype bf16) bf16.
extern "C" int dst_paged_decode_attention_f16(
    const void* q, const void* k, const void* v, void* out,
    const void* cache_len, const void* page_table, int rows, int max_pages,
    int page_size, int H, int KV, int hd, int rows_per_seq, long long q_sb,
    long long q_sh, long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, const void* slopes,
    float scale, int cache_dtype, void* stream) {
  Args a = base_args(q, k, v, out, H, KV, rows_per_seq, q_sb, q_sh, k_sp, k_ss,
                     k_sh, v_sp, v_ss, v_sh, slopes, scale);
  set_paged(a, cache_len, page_table, max_pages, page_size);
  return dispatch_f16<false, true>(a, rows, hd, cache_dtype,
                                   static_cast<cudaStream_t>(stream));
}

// As dst_paged_decode_attention_int8 with fp16 q and out (cache_dtype fp16).
extern "C" int dst_paged_decode_attention_int8_f16(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, const void* cache_len,
    const void* page_table, int rows, int max_pages, int page_size, int H,
    int KV, int hd, int rows_per_seq, long long q_sb, long long q_sh,
    long long k_sp, long long k_ss, long long k_sh, long long v_sp,
    long long v_ss, long long v_sh, long long ks_sp, long long ks_sh,
    long long vs_sp, long long vs_sh, const void* slopes, float scale,
    int cache_dtype, void* stream) {
  Args a = base_args(q, k, v, out, H, KV, rows_per_seq, q_sb, q_sh, k_sp, k_ss,
                     k_sh, v_sp, v_ss, v_sh, slopes, scale);
  set_scales(a, k_scale, v_scale, ks_sp, ks_sh, vs_sp, vs_sh);
  set_paged(a, cache_len, page_table, max_pages, page_size);
  return dispatch_f16<true, true>(a, rows, hd, cache_dtype,
                                  static_cast<cudaStream_t>(stream));
}
