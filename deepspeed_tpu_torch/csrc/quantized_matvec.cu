// Weight-only int8/int4 matvec: y[M, N] = x[M, D] . dequant(q, s), fp32
// accumulation, y in x's dtype (bf16).
//
// Replaces deepspeed_tpu/ops/pallas/quantized_matmul.py:_kernel (line 38),
// reached through _packed_matvec (line 89) from packed_proj (line 436), and
// its per-expert use: _packed_expert_matvec_local (line 330, from
// packed_expert_proj, line 391) launches it once per expert of an MoE bank.
// Here one launch covers every expert: blockIdx.z is the expert, and each
// expert's rows, weight, scales, output and split scratch sit at a fixed
// stride (dst_quantized_expert_matvec). The split plan is that of one
// expert's weight and the fold order is per expert, so each expert's rows are
// bitwise what the 2-D call gives on that expert alone; 8 experts x 112
// column tiles x the splits fill the 132 SMs where one expert's tiles do not.
//
// Layout (ops/quantizer.py, byte-identical to the JAX package): the
// contraction dim D = G * Bq is cut into G blocks of Bq rows (Bq = 128, or
// D when D % 128 != 0); qdata int8 [G, Bq, N]; scale fp32 [G, 1, N]. int4
// with an even G packs two values a byte, split-half: byte plane p < G/2
// holds block p in its low nibble, ((b & 15) ^ 8) - 8, and block p + G/2 in
// its high nibble, the arithmetic b >> 4 (the TPU kernel's _kernel:58-77).
//
// Scale folding: per element, x . (q . s), the TPU fold: each weight is
// dequantized in fp32, w = float(q) * s[g, n], then y[m, n] += x[m, d] * w
// by fused multiply-adds, for every row m.
//
// Bound on the H100: bytes. Every weight byte is read once (D * N bytes int8,
// D * N / 2 int4, plus 4 * G * N bytes of scales; Llama-3-8B's wi is 58.7 MB
// + 1.8 MB, 18 us at 3.35 TB/s); x and y are a few KB. Design: a block owns
// 128 columns (16 threads of 8 columns, one 8-byte load a row each) and a
// slice of the contraction (split-K over the byte planes), so the narrowest
// leaf (wk/wv, N = 1024, 8 column tiles) still puts about two blocks on
// every SM. The block's 16 row lanes walk its rows with four loads in flight
// a thread; x is staged in shared memory as fp32 [rows][M], read by
// broadcast. The partial sums meet in a fixed order: the two row lanes of a
// warp by one shuffle, the eight warps through shared memory, the splits by a
// second kernel in split order. No atomics, so reruns are bitwise equal; and
// the split plan depends on the weight's shape alone, never on M, so each
// row of a multi-row call equals the same row computed alone (a speculative
// verify window's projections equal single-token decode).
//
// This first form runs the products on the CUDA cores, not the tensor
// cores; wgmma and TMA come later.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 128;                        // columns of a block tile
constexpr int kVec = 8;                           // columns of a thread
constexpr int kColThreads = kCols / kVec;         // 16
constexpr int kRowLanes = kThreads / kColThreads; // 16
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;                       // rows of x staged at a time
constexpr int kMChunk = 4;                        // output rows reduced at a time
constexpr int kUnroll = 4;                        // weight loads in flight a thread
constexpr int kMaxRows = 16;

template <typename T, int MAXM, bool NIB>
__global__ void __launch_bounds__(kThreads) quantized_matvec_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ s, T* __restrict__ out, float* __restrict__ part,
    int M, int D, int N, int Gp, int Bq, int per) {
  constexpr int kSub = NIB ? 2 : 1;  // dense blocks a byte plane holds
  __shared__ __align__(16) float xs[kChunk][kSub][MAXM];
  __shared__ float red[kWarps][kMChunk][kCols];

  // this block's expert: its slice of every array (expert 0 of a 2-D call)
  const size_t e = blockIdx.z;
  x += e * M * D;
  q += e * Gp * Bq * N;
  s += e * kSub * Gp * N;
  out += e * M * N;
  if (part != nullptr) part += e * gridDim.y * M * N;

  const int tid = threadIdx.x;
  const int ct = tid % kColThreads;
  const int rl = tid / kColThreads;
  const int n0 = blockIdx.x * kCols + ct * kVec;
  const int split = blockIdx.y;
  const int p0 = split * per;
  const int p1 = min(Gp, p0 + per);

  float acc[MAXM][kVec];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[m][c] = 0.f;
  }

  for (int p = p0; p < p1; ++p) {
    // the scales of the block(s) this plane holds, for the thread's columns
    float sc[kSub][kVec];
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
      const float4* sp =
          reinterpret_cast<const float4*>(s + (size_t)(p + sub * Gp) * N + n0);
      const float4 a = sp[0], b = sp[1];
      sc[sub][0] = a.x; sc[sub][1] = a.y; sc[sub][2] = a.z; sc[sub][3] = a.w;
      sc[sub][4] = b.x; sc[sub][5] = b.y; sc[sub][6] = b.z; sc[sub][7] = b.w;
    }
    for (int r0 = 0; r0 < Bq; r0 += kChunk) {
      const int rows = min(kChunk, Bq - r0);
      __syncthreads();  // the previous chunk's readers are done
      for (int i = tid; i < rows * kSub * MAXM; i += kThreads) {
        const int r = i % rows;  // neighbouring threads read neighbouring x
        const int t = i / rows;
        const int sub = t % kSub;
        const int m = t / kSub;
        float v = 0.f;
        if (m < M) {
          v = dst::to_float(x[(size_t)m * D + (size_t)(p + sub * Gp) * Bq + r0 + r]);
        }
        xs[r][sub][m] = v;
      }
      __syncthreads();
      const int8_t* qb = q + ((size_t)p * Bq + r0) * N + n0;
      for (int rb = rl; rb < rows; rb += kRowLanes * kUnroll) {
        uint2 wd[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = rb + u * kRowLanes;
          wd[u] = r < rows ? *reinterpret_cast<const uint2*>(qb + (size_t)r * N)
                           : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = rb + u * kRowLanes;
          if (r >= rows) continue;
          const int8_t* b = reinterpret_cast<const int8_t*>(&wd[u]);
          float w0[kVec], w1[kVec];
#pragma unroll
          for (int c = 0; c < kVec; ++c) {
            if constexpr (NIB) {
              const int v = b[c];
              w0[c] = __fmul_rn(static_cast<float>(((v & 15) ^ 8) - 8), sc[0][c]);
              w1[c] = __fmul_rn(static_cast<float>(v >> 4), sc[kSub - 1][c]);
            } else {
              w0[c] = __fmul_rn(static_cast<float>(b[c]), sc[0][c]);
            }
          }
#pragma unroll
          for (int m = 0; m < MAXM; ++m) {
            const float x0 = xs[r][0][m];
#pragma unroll
            for (int c = 0; c < kVec; ++c) acc[m][c] = __fmaf_rn(x0, w0[c], acc[m][c]);
            if constexpr (NIB) {
              const float x1 = xs[r][kSub - 1][m];
#pragma unroll
              for (int c = 0; c < kVec; ++c) acc[m][c] = __fmaf_rn(x1, w1[c], acc[m][c]);
            }
          }
        }
      }
    }
  }

  // the two row lanes of a warp (threads t and t ^ 16): a + b == b + a, so
  // both hold the same sum
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 16);
    }
  }
  const int warp = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int mc = 0; mc < MAXM; mc += kMChunk) {
    if (mc >= M) break;
    __syncthreads();  // the previous chunk's readers are done
    if (lane < kColThreads) {
#pragma unroll
      for (int mm = 0; mm < kMChunk; ++mm) {
        if (mc + mm < MAXM) {
#pragma unroll
          for (int c = 0; c < kVec; ++c) red[warp][mm][ct * kVec + c] = acc[mc + mm][c];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < kMChunk * kCols; i += kThreads) {
      const int mm = i / kCols;
      const int col = i % kCols;
      const int m = mc + mm;
      if (m >= M) continue;
      float v = red[0][mm][col];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[w][mm][col];
      const size_t n = (size_t)blockIdx.x * kCols + col;
      if (part != nullptr) {
        part[((size_t)split * M + m) * N + n] = v;
      } else {
        out[(size_t)m * N + n] = dst::from_float<T>(v);
      }
    }
  }
}

// out[e, i] = sum over splits of part[e, split, i], in split order
template <typename T>
__global__ void __launch_bounds__(kThreads) sum_splits_kernel(
    const float* __restrict__ part, T* __restrict__ out, int splits, int MN,
    int E) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (size_t)E * MN) return;
  const size_t e = i / MN;
  const float* pe = part + e * splits * MN + (i - e * MN);
  float v = pe[0];
  for (int sp = 1; sp < splits; ++sp) v += pe[(size_t)sp * MN];
  out[i] = dst::from_float<T>(v);
}

template <typename T, int MAXM, bool NIB>
void launch_main(const void* x, const void* q, const void* s, void* out,
                 float* part, int E, int M, int D, int N, int Gp, int Bq,
                 int splits, int per, cudaStream_t stream) {
  dim3 grid(N / kCols, splits, E);
  quantized_matvec_kernel<T, MAXM, NIB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<T*>(out), part, M, D, N, Gp, Bq,
      per);
}

template <typename T, bool NIB>
int launch(const void* x, const void* q, const void* s, void* out, void* part,
           int E, int M, int D, int N, int Gp, int Bq, int splits, int per,
           cudaStream_t stream) {
  float* pp = splits > 1 ? static_cast<float*>(part) : nullptr;
  if (M <= 1) {
    launch_main<T, 1, NIB>(x, q, s, out, pp, E, M, D, N, Gp, Bq, splits, per, stream);
  } else if (M <= 2) {
    launch_main<T, 2, NIB>(x, q, s, out, pp, E, M, D, N, Gp, Bq, splits, per, stream);
  } else if (M <= 4) {
    launch_main<T, 4, NIB>(x, q, s, out, pp, E, M, D, N, Gp, Bq, splits, per, stream);
  } else if (M <= 8) {
    launch_main<T, 8, NIB>(x, q, s, out, pp, E, M, D, N, Gp, Bq, splits, per, stream);
  } else {
    launch_main<T, 16, NIB>(x, q, s, out, pp, E, M, D, N, Gp, Bq, splits, per, stream);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int MN = M * N;
  const size_t total = (size_t)E * MN;
  sum_splits_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(pp, static_cast<T*>(out), splits, MN, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// E experts, each contiguous after the other (E = 1: one 2-D weight): x
// [E, M, D]; qdata int8 [E, Gp, Bq, N] (Gp = G, or G / 2 nibble planes when
// nibbles); scale fp32 [E, G, 1, N]; out [E, M, N] in x's dtype; part fp32
// [E, splits, M, N] scratch when splits > 1. Split `sp` owns byte planes
// [sp * per, min(Gp, (sp + 1) * per)). M is 1 to 16, N a multiple of 128,
// every expert's slice of every array 16-byte aligned.
extern "C" int dst_quantized_expert_matvec(int E, const void* x, const void* q,
                                           const void* s, void* out, void* part,
                                           int M, int D, int N, int Gp, int Bq,
                                           int nibbles, int splits, int per,
                                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = nibbles ? 2 * Gp : Gp;
  if (E < 1 || E > 65535 || M < 1 || M > kMaxRows || N <= 0 || N % kCols != 0 ||
      Gp <= 0 || Bq <= 0 || G * Bq != D || splits < 1 || per < 1 ||
      (splits - 1) * per >= Gp || splits * per < Gp || dtype != dst::kBFloat16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nibbles) {
    return launch<__nv_bfloat16, true>(x, q, s, out, part, E, M, D, N, Gp, Bq,
                                       splits, per, st);
  }
  return launch<__nv_bfloat16, false>(x, q, s, out, part, E, M, D, N, Gp, Bq,
                                      splits, per, st);
}
