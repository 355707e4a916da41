// Weight-only int8/int4 matvec, bf16: the C entry. The kernel and its design
// are in quantized_matvec.cuh; quantized_matvec_f16.cu has the fp16 entry.
#include "quantized_matvec.cuh"

// E experts, each contiguous after the other (E = 1: one 2-D weight): x
// [E, M, D] bf16; qdata int8 [E, Gp, Bq, N] (Gp = G, or G / 2 nibble planes
// when nibbles); scale fp32 [E, G, 1, N]; out [E, M, N] bf16. Split `sp`
// (a block of the cluster) owns byte planes [sp * per, min(Gp, (sp + 1) *
// per)), splits at most 8. M is 1 to 16, N a multiple of 128, Bq a multiple
// of 16, every expert's slice of every array 16-byte aligned. `part` is not
// read (the splits merge in the cluster); it stays in the signature. dtype:
// x's code, bf16.
extern "C" int dst_quantized_expert_matvec(int E, const void* x, const void* q,
                                           const void* s, void* out, void* part,
                                           int M, int D, int N, int Gp, int Bq,
                                           int nibbles, int splits, int per,
                                           int dtype, void* stream) {
  (void)part;
  if (dtype != dst::kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  return matvec_entry<__nv_bfloat16>(E, x, q, s, out, M, D, N, Gp, Bq, nibbles, splits,
                                     per, static_cast<cudaStream_t>(stream));
}
