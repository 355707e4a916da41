// Flash attention forward, bf16: the C entry of every form (Llama, ALiBi,
// masked, ring-hop offsets). The kernel and its design are in
// flash_attention_fwd.cuh; flash_attention_fwd_f16.cu has the fp16 entry.
#include "flash_attention_fwd.cuh"

// q: [B, S, H, hd], k/v: [B, S, KV, hd], out: [B, S, H, hd], each by its
// (batch, seq, head) strides with a contiguous last dim; q, k, v are read by
// TMA (16-byte aligned start and strides). lse: [B, H, S] fp32 contiguous.
// slopes: fp32 [H] ALiBi slopes on the device, or nullptr for none. scale:
// softmax scale applied to q . k (1 / sqrt(hd) for the model). mask: nullptr,
// or long long[14] naming the masked form's segment ids, bias (read by TMA:
// 16-byte aligned start and query-row, head and batch strides), compaction
// tables, the keys' segment ids and the position offsets
// (flash_attention.cuh:parse_mask; the table is per query layout row, its
// block a multiple of 128 tokens).
extern "C" int dst_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int KV, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  return fwd_entry<__nv_bfloat16>(
      q, k, v, out, lse, B, S, H, KV, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, o_sb, o_ss, o_sh, slopes, scale, causal, mask, stream);
}
