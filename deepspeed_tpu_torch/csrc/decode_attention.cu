// GQA decode attention against a KV cache, bf16 and fp32: the C entries of
// the contiguous and paged forms, dense and int8. The kernel and its design
// are in decode_attention.cuh; decode_attention_f16.cu has the fp16 entries.
#include "decode_attention.cuh"

namespace {

// The query dtypes every form takes here: bf16 (the serving path) and fp32
// (no main path; held to 1e-4).
template <bool kInt8, bool kPaged>
int dispatch(Args& a, int rows, int hd, int dtype, cudaStream_t s) {
  if (dtype == dst::kBFloat16) {
    using TC = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
    return run<__nv_bfloat16, TC, kPaged>(a, rows, hd, s);
  }
  if (dtype == dst::kFloat32) {
    using TC = typename std::conditional<kInt8, int8_t, float>::type;
    return run<float, TC, kPaged>(a, rows, hd, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: [rows, 1, H, hd] by strides (q_sb, q_sh); row r reads sequence
// r / rows_per_seq of k, v: one layer of the cache, [B, Smax, KV, hd] by
// strides (batch, seq, head); the last dim is contiguous everywhere. out:
// [rows, 1, H, hd] contiguous. cache_len: int32 [rows] on the device (each
// row's frontier), or nullptr to use cache_len_scalar for every row. slopes:
// fp32 [H] ALiBi slopes on the device, or nullptr for none (every form).
// dtype: q's, out's and the cache's code, bf16 or fp32.
extern "C" int dst_decode_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* cache_len, int cache_len_scalar, int rows, int Smax, int H,
    int KV, int hd, int rows_per_seq, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, const void* slopes, float scale, int dtype,
    void* stream) {
  Args a = base_args(q, k, v, out, H, KV, rows_per_seq, q_sb, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, slopes, scale);
  set_dense(a, cache_len, cache_len_scalar, Smax);
  return dispatch<false, false>(a, rows, hd, dtype, static_cast<cudaStream_t>(stream));
}

// The int8 form: k, v int8 as above; k_scale, v_scale: fp32, one layer of the
// [L, B, KV, Smax] scale caches, [B, KV, Smax] by strides (batch, head) with
// the sequence contiguous.
extern "C" int dst_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, const void* cache_len, int cache_len_scalar,
    int rows, int Smax, int H, int KV, int hd, int rows_per_seq, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long ks_sb,
    long long ks_sh, long long vs_sb, long long vs_sh, const void* slopes,
    float scale, int dtype, void* stream) {
  Args a = base_args(q, k, v, out, H, KV, rows_per_seq, q_sb, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, slopes, scale);
  set_scales(a, k_scale, v_scale, ks_sb, ks_sh, vs_sb, vs_sh);
  set_dense(a, cache_len, cache_len_scalar, Smax);
  return dispatch<true, false>(a, rows, hd, dtype, static_cast<cudaStream_t>(stream));
}

// The paged form: k, v one layer of the page pool, [P + 1, page_size, KV, hd]
// by strides (page, row, head); page_table: int32 [B, max_pages] contiguous on
// the device, the physical page of each logical page of sequence b (every
// entry a valid page: unmapped ones name the NULL page P); cache_len: int32
// [rows] on the device.
extern "C" int dst_paged_decode_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* cache_len, const void* page_table, int rows, int max_pages,
    int page_size, int H, int KV, int hd, int rows_per_seq, long long q_sb,
    long long q_sh, long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, const void* slopes,
    float scale, int dtype, void* stream) {
  Args a = base_args(q, k, v, out, H, KV, rows_per_seq, q_sb, q_sh, k_sp, k_ss,
                     k_sh, v_sp, v_ss, v_sh, slopes, scale);
  set_paged(a, cache_len, page_table, max_pages, page_size);
  return dispatch<false, true>(a, rows, hd, dtype, static_cast<cudaStream_t>(stream));
}

// The paged int8 form: scales one layer of the [L, P + 1, KV, page_size] scale
// pools, [P + 1, KV, page_size] by strides (page, head), rows contiguous.
extern "C" int dst_paged_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, const void* cache_len,
    const void* page_table, int rows, int max_pages, int page_size, int H,
    int KV, int hd, int rows_per_seq, long long q_sb, long long q_sh,
    long long k_sp, long long k_ss, long long k_sh, long long v_sp,
    long long v_ss, long long v_sh, long long ks_sp, long long ks_sh,
    long long vs_sp, long long vs_sh, const void* slopes, float scale, int dtype,
    void* stream) {
  Args a = base_args(q, k, v, out, H, KV, rows_per_seq, q_sb, q_sh, k_sp, k_ss,
                     k_sh, v_sp, v_ss, v_sh, slopes, scale);
  set_scales(a, k_scale, v_scale, ks_sp, ks_sh, vs_sp, vs_sh);
  set_paged(a, cache_len, page_table, max_pages, page_size);
  return dispatch<true, true>(a, rows, hd, dtype, static_cast<cudaStream_t>(stream));
}
