// Flash attention backward (bf16, causal or not, GQA) with mma.sync tensor
// cores: one kernel for dq, one for dk/dv, as the TPU package splits them.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:_bwd_dq_kernel
// (line 455) and :_bwd_dkv_kernel (line 517), driven by _flash_bwd (line 719),
// in the forms the training step uses: causal, grouped-query heads, with or
// without ALiBi slopes; no segment ids or dense bias.
//
// With s = q . k * scale - slope[h] * |q - k| (the ALiBi term only when
// slopes are given), p = exp(s - lse) (the forward's saved lse; p = 0 where
// the key is masked), dp = do . v and delta = rowsum(do * o):
//   ds = p * (dp - delta) * scale
//   dq = sum_k ds K,  dk = sum_q ds^T Q,  dv = sum_q p^T dO
// dk and dv of a kv head sum over the query heads of its group.
//
// Bound on the H100: operations at training lengths. The dq kernel does 6 * D
// flops per visible (query, key) pair (q.k, do.v and ds.K), the dk/dv kernel
// 8 * D (q.k, do.v, p^T dO, ds^T Q), over 989 TFLOP/s of bf16 tensor-core
// rate. Design: both kernels follow the forward kernel (flash_attention_fwd.cu):
// 4 warps per block, each warp owning 16 rows of the tile, mma.sync m16n8k16
// bf16 products with fp32 accumulation, operand rows from device memory into
// registers for the row side and 16-byte loads into padded shared memory for
// the column side, fp32 softmax recompute in registers, the model layout
// [B, S, H, D] read through strides and ragged S masked in the kernel.
//   dq: one block per (64 query rows, head, batch row); loops key tiles up to
//     the diagonal. It also computes delta for its rows from do and o and
//     writes it [B, H, S] for the dk/dv kernel (launched after it on the same
//     stream), so delta costs no pass of its own.
//   dk/dv: one block per (64 keys, kv head, batch row); loops the group's
//     query heads and, for each, the query tiles from the diagonal on. The
//     group sum and the sum over query tiles stay in fp32 registers: the TPU
//     kernel writes per-query-head dk/dv [B, H, S, D] and sums them
//     afterwards; here each output is written once, with no atomics, so the
//     result does not depend on the schedule.
// ALiBi (flash_attention.py:149-246 carries the slope into both backward
// kernels): each score is recomputed by alibi_score, the very expression the
// forward kernel used (flash_attention_fwd.cu), so p is the p whose sum went
// into the saved lse; slopes == nullptr instantiates the kernels without the
// term, as they were before ALiBi came in. wgmma, TMA and pipelined tiles are
// later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;  // rows per block (queries for dq, keys for dk/dv)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The forward kernel's ALiBi score (flash_attention_fwd.cu:alibi_score), to
// the bit: s * scale_log2 rounded, then - slope_log2 * |row - key| fused.
__device__ __forceinline__ float alibi_score(float s, float scale_log2,
                                             float slope_log2, int row, int key) {
  return __fmaf_rn(-slope_log2, static_cast<float>(abs(row - key)),
                   __fmul_rn(s, scale_log2));
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(h);
}

// A-operand fragments of 16 rows x HD (row-major, k = head dim) straight from
// device memory: rows row0 and row0 + 8 of a [S, *, HD] slab with row stride
// ss; rows past S read as zero.
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t (&a)[HD / 16][4],
                                          const __nv_bfloat16* base, long long ss,
                                          int row0, int row1, int S, int tig) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks * 16 + tig * 2;
    a[ks][0] = row0 < S ? load_pair(base + row0 * ss + c) : 0u;
    a[ks][1] = row1 < S ? load_pair(base + row1 * ss + c) : 0u;
    a[ks][2] = row0 < S ? load_pair(base + row0 * ss + c + 8) : 0u;
    a[ks][3] = row1 < S ? load_pair(base + row1 * ss + c + 8) : 0u;
  }
}

// Stage rows [r0, r0 + NR) of two [S, *, HD] slabs into padded shared memory
// (row stride HD + 8 elements), zero past S.
template <int HD, int NR>
__device__ __forceinline__ void stage2(__nv_bfloat16* sa, __nv_bfloat16* sb,
                                       const __nv_bfloat16* a, long long a_ss,
                                       const __nv_bfloat16* b, long long b_ss,
                                       int r0, int S, int tid) {
  constexpr int kLds = HD + 8;
  constexpr int kChunks = HD / 8;
  for (int i = tid; i < NR * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    uint4 av = make_uint4(0u, 0u, 0u, 0u);
    uint4 bv = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) {
      av = *reinterpret_cast<const uint4*>(a + (long long)(r0 + r) * a_ss + c);
      bv = *reinterpret_cast<const uint4*>(b + (long long)(r0 + r) * b_ss + c);
    }
    *reinterpret_cast<uint4*>(sa + r * kLds + c) = av;
    *reinterpret_cast<uint4*>(sb + r * kLds + c) = bv;
  }
}

// acc[j] += A (16 x HD, fragments a) . B^T where B rows are the NT*8 shared
// rows of sb (so acc is 16 x NT*8): the score-shaped products q.k, do.v.
template <int HD, int NT>
__device__ __forceinline__ void rows_dot_tile(float (&acc)[NT][4],
                                              const uint32_t (&a)[HD / 16][4],
                                              const __nv_bfloat16* sb, int g, int tig) {
  constexpr int kLds = HD + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* r = sb + (j * 8 + g) * kLds + ks * 16 + tig * 2;
      mma_16816(acc[j], a[ks], load_pair(r), load_pair(r + 8));
    }
  }
}

// out (16 x HD) += P (16 x NT*8, score fragments, rounded to bf16) . V where
// V is the NT*8 x HD tile in shared memory: the value-shaped products.
template <int HD, int NT>
__device__ __forceinline__ void tile_times_rows(float (&out)[HD / 8][4],
                                                const float (&p)[NT][4],
                                                const __nv_bfloat16* sv, int g, int tig) {
  constexpr int kLds = HD + 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_f32(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_f32(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const __nv_bfloat16* vr = sv + (kk * 16 + tig * 2) * kLds + n * 8 + g;
      const uint32_t b0 = pack_bf16(vr[0], vr[kLds]);
      const uint32_t b1 = pack_bf16(vr[8 * kLds], vr[9 * kLds]);
      mma_16816(out[n], pa, b0, b1);
    }
  }
}

// Write a 16 x HD fp32 accumulator (rows row0, row1) as bf16 rows.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ss,
                                           const float (&acc)[HD / 8][4], int row0,
                                           int row1, int S, int tig) {
  if (row0 < S) {
    __nv_bfloat16* r = base + row0 * ss + tig * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(r + n * 8) = pack_f32(acc[n][0], acc[n][1]);
  }
  if (row1 < S) {
    __nv_bfloat16* r = base + row1 * ss + tig * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(r + n * 8) = pack_f32(acc[n][2], acc[n][3]);
  }
}

struct Strides {
  long long sb, ss, sh;
};

// ---------------------------------------------------------------------------
// dq (+ delta)
// ---------------------------------------------------------------------------
template <int HD, bool kAlibi>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S, int H,
    int KV, Strides qs, Strides ks_, Strides vs, Strides os, Strides dos,
    Strides dqs, const float* __restrict__ slopes, float scale, int causal) {
  constexpr int kBlockN = HD == 128 ? 32 : 64;  // keys per tile
  constexpr int kLds = HD + 8;
  constexpr int kSTiles = kBlockN / 8;
  __shared__ __align__(16) __nv_bfloat16 sk[kBlockN * kLds];
  __shared__ __align__(16) __nv_bfloat16 sv[kBlockN * kLds];

  const int qblock = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = qblock * kBlockM + warp * 16 + g;
  const int row1 = row0 + 8;

  const __nv_bfloat16* qb = q + b * qs.sb + h * qs.sh;
  const __nv_bfloat16* kb = k + b * ks_.sb + kvh * ks_.sh;
  const __nv_bfloat16* vb = v + b * vs.sb + kvh * vs.sh;
  const __nv_bfloat16* ob = o + b * os.sb + h * os.sh;
  const __nv_bfloat16* dob = dout + b * dos.sb + h * dos.sh;

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  load_rows<HD>(qa, qb, qs.ss, row0, row1, S, tig);
  load_rows<HD>(da, dob, dos.ss, row0, row1, S, tig);

  // delta = rowsum(do * o): this thread's columns of its two rows, then the
  // group of four threads that share the rows
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks * 16 + tig * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (row0 < S) {
        const float2 d2 = unpack(da[ks][half * 2]);
        const float2 o2 = unpack(load_pair(ob + row0 * os.ss + c + half * 8));
        dl0 += d2.x * o2.x + d2.y * o2.y;
      }
      if (row1 < S) {
        const float2 d2 = unpack(da[ks][half * 2 + 1]);
        const float2 o2 = unpack(load_pair(ob + row1 * os.ss + c + half * 8));
        dl1 += d2.x * o2.x + d2.y * o2.y;
      }
    }
  }
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
  dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
  dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
  const long long lrow = ((long long)b * H + h) * S;
  if (tig == 0) {
    if (row0 < S) delta[lrow + row0] = dl0;
    if (row1 < S) delta[lrow + row1] = dl1;
  }
  // lse in the log2 domain; a row with nothing visible (lse = -inf) gets p = 0
  const float lse0 = row0 < S ? lse[lrow + row0] * kLog2e : -INFINITY;
  const float lse1 = row1 < S ? lse[lrow + row1] * kLog2e : -INFINITY;
  const float scale_log2 = scale * kLog2e;
  const float slope_log2 = kAlibi ? slopes[h] * kLog2e : 0.f;

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_all = (S + kBlockN - 1) / kBlockN;
  const int last_row = (qblock + 1) * kBlockM - 1;
  const int n_tiles = causal ? min(n_all, last_row / kBlockN + 1) : n_all;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile is fully consumed
    stage2<HD, kBlockN>(sk, sv, kb, ks_.ss, vb, vs.ss, k0, S, tid);
    __syncthreads();

    float s[kSTiles][4], dp[kSTiles][4];
    rows_dot_tile<HD, kSTiles>(s, qa, sk, g, tig);
    rows_dot_tile<HD, kSTiles>(dp, da, sv, g, tig);
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tig * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const float l = e < 2 ? lse0 : lse1;
        const float dlt = e < 2 ? dl0 : dl1;
        const bool visible = key < S && row < S && (!causal || key <= row) &&
                             l != -INFINITY;
        float p = 0.f;
        if constexpr (kAlibi) {
          if (visible) p = exp2f(alibi_score(s[j][e], scale_log2, slope_log2, row, key) - l);
        } else {
          p = visible ? exp2f(s[j][e] * scale_log2 - l) : 0.f;
        }
        s[j][e] = p * (dp[j][e] - dlt) * scale;  // ds
      }
    }
    tile_times_rows<HD, kSTiles>(acc, s, sk, g, tig);
  }
  store_rows<HD>(dq + b * dqs.sb + h * dqs.sh, dqs.ss, acc, row0, row1, S, tig);
}

// ---------------------------------------------------------------------------
// dk, dv (summed over the GQA group)
// ---------------------------------------------------------------------------
template <int HD, bool kAlibi>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
    int KV, Strides qs, Strides ks_, Strides vs, Strides dos, Strides dks,
    Strides dvs, const float* __restrict__ slopes, float scale, int causal) {
  constexpr int kBlockN = HD == 128 ? 32 : 64;  // queries per tile
  constexpr int kLds = HD + 8;
  constexpr int kSTiles = kBlockN / 8;
  __shared__ __align__(16) __nv_bfloat16 sq[kBlockN * kLds];
  __shared__ __align__(16) __nv_bfloat16 sdo[kBlockN * kLds];
  __shared__ float slse[kBlockN];
  __shared__ float sdelta[kBlockN];

  const int kblock = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int key0 = kblock * kBlockM + warp * 16 + g;  // this thread's key rows
  const int key1 = key0 + 8;

  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_rows<HD>(ka, k + b * ks_.sb + kvh * ks_.sh, ks_.ss, key0, key1, S, tig);
  load_rows<HD>(va, v + b * vs.sb + kvh * vs.sh, vs.ss, key0, key1, S, tig);
  const float scale_log2 = scale * kLog2e;

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const int n_all = (S + kBlockN - 1) / kBlockN;
  // first query tile that sees any key of this block
  const int t0 = causal ? (kblock * kBlockM) / kBlockN : 0;
  for (int j = 0; j < group; ++j) {
    const int h = kvh * group + j;
    const __nv_bfloat16* qb = q + b * qs.sb + h * qs.sh;
    const __nv_bfloat16* dob = dout + b * dos.sb + h * dos.sh;
    const long long lrow = ((long long)b * H + h) * S;
    const float slope_log2 = kAlibi ? slopes[h] * kLog2e : 0.f;
    for (int t = t0; t < n_all; ++t) {
      const int q0 = t * kBlockN;
      __syncthreads();  // the previous tile is fully consumed
      stage2<HD, kBlockN>(sq, sdo, qb, qs.ss, dob, dos.ss, q0, S, tid);
      for (int i = tid; i < kBlockN; i += kThreads) {
        const bool in = q0 + i < S;
        slse[i] = in ? lse[lrow + q0 + i] * kLog2e : -INFINITY;
        sdelta[i] = in ? delta[lrow + q0 + i] : 0.f;
      }
      __syncthreads();

      // st = K Q^T (keys x queries), dpt = V dO^T
      float st[kSTiles][4], dpt[kSTiles][4];
      rows_dot_tile<HD, kSTiles>(st, ka, sq, g, tig);
      rows_dot_tile<HD, kSTiles>(dpt, va, sdo, g, tig);
#pragma unroll
      for (int jj = 0; jj < kSTiles; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = jj * 8 + tig * 2 + (e & 1);
          const int query = q0 + col;
          const int key = e < 2 ? key0 : key1;
          const float l = slse[col];
          const bool visible = query < S && key < S &&
                               (!causal || key <= query) && l != -INFINITY;
          float p = 0.f;
          if constexpr (kAlibi) {
            if (visible) {
              p = exp2f(alibi_score(st[jj][e], scale_log2, slope_log2, query, key) - l);
            }
          } else {
            p = visible ? exp2f(st[jj][e] * scale_log2 - l) : 0.f;
          }
          st[jj][e] = p;
          dpt[jj][e] = p * (dpt[jj][e] - sdelta[col]) * scale;  // ds^T
        }
      }
      tile_times_rows<HD, kSTiles>(dva, st, sdo, g, tig);   // dv += p^T dO
      tile_times_rows<HD, kSTiles>(dka, dpt, sq, g, tig);   // dk += ds^T Q
    }
  }
  store_rows<HD>(dk + b * dks.sb + kvh * dks.sh, dks.ss, dka, key0, key1, S, tig);
  store_rows<HD>(dv + b * dvs.sb + kvh * dvs.sh, dvs.ss, dva, key0, key1, S, tig);
}

Strides at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

}  // namespace

// q, o, do, dq: [B, S, H, hd]; k, v: [B, S, KV, hd], each by its (batch, seq,
// head) strides (st: 3 per tensor in the order q, k, v, o, do, dq) with a
// contiguous last dim and 16-byte aligned rows. lse (in), delta (out): [B, H, S]
// fp32 contiguous. slopes: fp32 [H] ALiBi slopes on the device (those the
// forward took), or nullptr for none.
extern "C" int dst_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int S, int H, int KV, int hd,
    const long long* st, const void* slopes, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + kBlockM - 1) / kBlockM, H, B);
  using T = __nv_bfloat16;
#define DQ_ARGS                                                                   \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),   \
      static_cast<const T*>(o), static_cast<const T*>(dout),                      \
      static_cast<const float*>(lse), static_cast<float*>(delta),                 \
      static_cast<T*>(dq), S, H, KV, at(st, 0), at(st, 1), at(st, 2), at(st, 3),  \
      at(st, 4), at(st, 5), static_cast<const float*>(slopes), scale, causal
  const bool alibi = slopes != nullptr;
  if (hd == 128 && alibi) {
    flash_bwd_dq_kernel<128, true><<<grid, kThreads, 0, s>>>(DQ_ARGS);
  } else if (hd == 128) {
    flash_bwd_dq_kernel<128, false><<<grid, kThreads, 0, s>>>(DQ_ARGS);
  } else if (hd == 64 && alibi) {
    flash_bwd_dq_kernel<64, true><<<grid, kThreads, 0, s>>>(DQ_ARGS);
  } else if (hd == 64) {
    flash_bwd_dq_kernel<64, false><<<grid, kThreads, 0, s>>>(DQ_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DQ_ARGS
  return static_cast<int>(cudaGetLastError());
}

// q, do: [B, S, H, hd]; k, v, dk, dv: [B, S, KV, hd], by strides (st: q, k, v,
// do, dk, dv); lse, delta: [B, H, S] fp32 contiguous (delta from the dq kernel);
// slopes as for the dq kernel.
extern "C" int dst_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
    int KV, int hd, const long long* st, const void* slopes, float scale,
    int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + kBlockM - 1) / kBlockM, KV, B);
  using T = __nv_bfloat16;
#define DKV_ARGS                                                                  \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),   \
      static_cast<const T*>(dout), static_cast<const float*>(lse),                \
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), \
      S, H, KV, at(st, 0), at(st, 1), at(st, 2), at(st, 3), at(st, 4), at(st, 5), \
      static_cast<const float*>(slopes), scale, causal
  const bool alibi = slopes != nullptr;
  if (hd == 128 && alibi) {
    flash_bwd_dkv_kernel<128, true><<<grid, kThreads, 0, s>>>(DKV_ARGS);
  } else if (hd == 128) {
    flash_bwd_dkv_kernel<128, false><<<grid, kThreads, 0, s>>>(DKV_ARGS);
  } else if (hd == 64 && alibi) {
    flash_bwd_dkv_kernel<64, true><<<grid, kThreads, 0, s>>>(DKV_ARGS);
  } else if (hd == 64) {
    flash_bwd_dkv_kernel<64, false><<<grid, kThreads, 0, s>>>(DKV_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DKV_ARGS
  return static_cast<int>(cudaGetLastError());
}
