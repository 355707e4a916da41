// Single-token GQA decode attention against a contiguous KV cache.
//
// Replaces deepspeed_tpu/ops/pallas/decode_attention.py:_decode_kernel
// (line 76) with its shared _tile_update (line 35), reached through
// decode_attention_kernel (line 160) from decode_attention (line 323): the
// dense form over a bf16 (or fp32) cache, and the int8 form (has_scales=True)
// over an int8 cache with one fp32 scale per (token, kv head).
//
// out[b, h] = softmax(q[b, h] . K[b, :n, kv]^T * scale) @ V[b, :n, kv] with
// kv = h / (H / KV) and n = min(cache_len[b] + 1, Smax): every position at or
// before the row's frontier is attended, as `kpos <= cache_len` in the TPU
// kernel.
//
// Bound on the H100: bytes. The K and V rows up to each row's frontier are
// read once (2 * sum_b n_b * KV * hd * sizeof(T) over 3.35 TB/s); the
// arithmetic is 4 * H * hd flops per key, far below the tensor-core line.
// Design: one 128-thread block per (kv head, batch row), so the G = H / KV
// query rows of a group share every K/V tile load. The TPU kernel carries the
// online softmax (m, l, acc) across its sequential "arbitrary" grid axis; on
// Hopper the blocks run in parallel, so that carry is a loop over key tiles
// inside the block, stopping at the row's own frontier. Each tile (64 keys in
// bf16) arrives by 16-byte loads, all in flight at once and started one tile
// ahead, into padded shared memory (conflict-free row reads); each score is one
// thread's dot product against fp32 query rows in shared memory, one warp per
// query row folds the tile into the running (max, sum), and thread d
// accumulates output column d for every query row of the group. The cache is
// read in place through its strides (a layer of the [L, B, Smax, KV, hd] cache
// needs no copy); every row start must be 16-byte aligned.
//
// The int8 form reads the int8 K/V rows by the same 16-byte loads (16 values
// a load, so a tile is a quarter of the bf16 bytes' loads) together with each
// row's scale, and dequantizes each value as it lands in shared memory:
// float(q) * scale, rounded to q's dtype, the order of the TPU kernel's
// _tile_update:42-43. Scales are read through their (batch, head) strides
// from the port's [B, KV, Smax] layer layout, one fp32 a (token, head).
// Bound: bytes, 2 * sum_b n_b * KV * (hd + 4) over 3.35 TB/s.
//
// Known gap: at B = 1 and KV = 8 only 8 of the card's 132 SMs have a block.
// Split-K over the sequence with a combine pass is the later fix.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return make_float2(p[0], p[1]);
}

// One dequantized pair into shared memory in q's dtype.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}

// T: q, out and the shared tiles; TC: the cache's storage type (T, or int8_t
// with the fp32 scales ks/vs, [B, KV, Smax] by strides (sb, sh, 1)).
template <typename T, typename TC, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const TC* __restrict__ k, const TC* __restrict__ v,
    const float* __restrict__ ks_scale, const float* __restrict__ vs_scale,
    T* __restrict__ out, const int* __restrict__ cache_len, int cache_len_scalar,
    int Smax, int H, int KV, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long ks_sb, long long ks_sh, long long vs_sb,
    long long vs_sh, float scale) {
  constexpr bool kInt8 = std::is_same<TC, int8_t>::value;
  // 64 keys a tile in bf16, 32 in fp32: K and V tiles both fit the 48 KB of
  // static shared memory
  constexpr int kTile = sizeof(T) == 2 ? 64 : 32;
  constexpr int kPerLane = kTile / 32;           // scores per lane in the softmax
  constexpr int kPad = sizeof(T) == 2 ? 2 : 1;   // row stride odd in 32-bit words
  constexpr int kLd = HD + kPad;
  constexpr int kChunks = HD * sizeof(TC) / 16;  // 16-byte chunks per cache row
  constexpr int kPerChunk = 16 / sizeof(TC);     // values per chunk
  constexpr int kLoads = kTile * kChunks / kThreads;
  static_assert(kTile * kChunks % kThreads == 0, "tile loads must divide");
  __shared__ __align__(16) T ks[kTile * kLd];
  __shared__ __align__(16) T vs[kTile * kLd];
  __shared__ float qs[kMaxGroup][HD];
  __shared__ float sc[kMaxGroup][kTile];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float corr_s[kMaxGroup];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cl = cache_len != nullptr ? cache_len[b] : cache_len_scalar;
  const int n_keys = min(max(cl + 1, 0), Smax);

  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i - g * HD;
    qs[g][d] = dst::to_float(q[b * q_sb + (long long)(kvh * G + g) * q_sh + d]);
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  const char* kb = reinterpret_cast<const char*>(k + b * k_sb + kvh * k_sh);
  const char* vb = reinterpret_cast<const char*>(v + b * v_sb + kvh * v_sh);
  const long long k_row = k_ss * (long long)sizeof(TC);
  const long long v_row = v_ss * (long long)sizeof(TC);
  const float* ksr = kInt8 ? ks_scale + b * ks_sb + kvh * ks_sh : nullptr;
  const float* vsr = kInt8 ? vs_scale + b * vs_sb + kvh * vs_sh : nullptr;

  // 16-byte loads of one K and one V tile into registers (and, int8, each
  // row's two scales), all in flight at once; the next tile's loads overlap
  // this tile's arithmetic
  uint4 kreg[kLoads], vreg[kLoads];
  float kscl[kLoads], vscl[kLoads];
  auto fetch = [&](int start) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      kreg[j] = make_uint4(0u, 0u, 0u, 0u);
      vreg[j] = make_uint4(0u, 0u, 0u, 0u);
      kscl[j] = 0.f;
      vscl[j] = 0.f;
      if (start + r < n_keys) {
        kreg[j] = *reinterpret_cast<const uint4*>(kb + (start + r) * k_row + c * 16);
        vreg[j] = *reinterpret_cast<const uint4*>(vb + (start + r) * v_row + c * 16);
        if (kInt8) {
          kscl[j] = ksr[start + r];
          vscl[j] = vsr[start + r];
        }
      }
    }
  };
  if (n_keys > 0) fetch(0);
  __syncthreads();

  for (int start = 0; start < n_keys; start += kTile) {
    const int nvalid = min(kTile, n_keys - start);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / kChunks;
      const int c = i - r * kChunks;
      if constexpr (kInt8) {
        // dequantize as the row lands: float(q) * scale, rounded to T
        const int8_t* kq = reinterpret_cast<const int8_t*>(&kreg[j]);
        const int8_t* vq = reinterpret_cast<const int8_t*>(&vreg[j]);
        T* kd = ks + r * kLd + c * kPerChunk;
        T* vd = vs + r * kLd + c * kPerChunk;
#pragma unroll
        for (int e = 0; e < kPerChunk; e += 2) {
          store2(kd + e, __fmul_rn(static_cast<float>(kq[e]), kscl[j]),
                 __fmul_rn(static_cast<float>(kq[e + 1]), kscl[j]));
          store2(vd + e, __fmul_rn(static_cast<float>(vq[e]), vscl[j]),
                 __fmul_rn(static_cast<float>(vq[e + 1]), vscl[j]));
        }
      } else {
        uint32_t* kd = reinterpret_cast<uint32_t*>(ks + r * kLd) + c * 4;
        uint32_t* vd = reinterpret_cast<uint32_t*>(vs + r * kLd) + c * 4;
        kd[0] = kreg[j].x; kd[1] = kreg[j].y; kd[2] = kreg[j].z; kd[3] = kreg[j].w;
        vd[0] = vreg[j].x; vd[1] = vreg[j].y; vd[2] = vreg[j].z; vd[3] = vreg[j].w;
      }
    }
    __syncthreads();
    if (start + kTile < n_keys) fetch(start + kTile);

    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      const int t = i - g * kTile;
      float s = -INFINITY;
      if (t < nvalid) {
        const T* kr = ks + t * kLd;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; d += 2) {
          const float2 kf = load2(kr + d);
          dot += qs[g][d] * kf.x + qs[g][d + 1] * kf.y;
        }
        s = dot * scale;
      }
      sc[g][t] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      float sv[kPerLane];
      float mt = -INFINITY;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        sv[e] = sc[g][lane + 32 * e];
        mt = fmaxf(mt, sv[e]);
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, dst::warp_max(mt));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const float p = expf(sv[e] - m_safe);
        sc[g][lane + 32 * e] = p;
        psum += p;
      }
      psum = dst::warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_old - m_safe);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    if (tid < HD) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) acc[g] *= corr_s[g];
      }
#pragma unroll 4
      for (int t = 0; t < nvalid; ++t) {
        const float vv = dst::to_float(vs[t * kLd + tid]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) acc[g] += sc[g][t] * vv;
        }
      }
    }
    __syncthreads();
  }

  if (tid < HD) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float l = l_s[g];
        const float o = l == 0.f ? 0.f : acc[g] / l;
        out[((long long)b * H + kvh * G + g) * HD + tid] = dst::from_float<T>(o);
      }
    }
  }
}

template <typename T, typename TC, int HD>
void launch(const void* q, const void* k, const void* v, const void* ksc,
            const void* vsc, void* out, const void* cache_len,
            int cache_len_scalar, int B, int Smax, int H, int KV,
            const long long* st, float scale, cudaStream_t stream) {
  dim3 grid(KV, B);
  decode_attention_kernel<T, TC, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<T*>(out),
      static_cast<const int*>(cache_len), cache_len_scalar, Smax, H, KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale);
}

// The cache's storage type: the query's (dense) or int8_t.
template <bool kInt8, typename T>
using CacheT = typename std::conditional<kInt8, int8_t, T>::type;

// The head sizes and query dtypes both forms take.
template <bool kInt8>
int dispatch(const void* q, const void* k, const void* v, const void* ksc,
             const void* vsc, void* out, const void* cache_len,
             int cache_len_scalar, int B, int Smax, int H, int KV, int hd,
             const long long* st, float scale, int dtype, cudaStream_t s) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxGroup) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == dst::kBFloat16 && hd == 128) {
    launch<__nv_bfloat16, CacheT<kInt8, __nv_bfloat16>, 128>(
        q, k, v, ksc, vsc, out, cache_len, cache_len_scalar, B, Smax, H, KV,
        st, scale, s);
  } else if (dtype == dst::kBFloat16 && hd == 64) {
    launch<__nv_bfloat16, CacheT<kInt8, __nv_bfloat16>, 64>(
        q, k, v, ksc, vsc, out, cache_len, cache_len_scalar, B, Smax, H, KV,
        st, scale, s);
  } else if (dtype == dst::kFloat32 && hd == 128) {
    launch<float, CacheT<kInt8, float>, 128>(
        q, k, v, ksc, vsc, out, cache_len, cache_len_scalar, B, Smax, H, KV,
        st, scale, s);
  } else if (dtype == dst::kFloat32 && hd == 64) {
    launch<float, CacheT<kInt8, float>, 64>(
        q, k, v, ksc, vsc, out, cache_len, cache_len_scalar, B, Smax, H, KV,
        st, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, 1, H, hd] by strides (q_sb, q_sh); k, v: one layer of the cache,
// [B, Smax, KV, hd] by strides (batch, seq, head); the last dim is contiguous
// everywhere. out: [B, 1, H, hd] contiguous. cache_len: int32 [B] on the
// device, or nullptr to use cache_len_scalar for every row.
extern "C" int dst_decode_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* cache_len, int cache_len_scalar, int B, int Smax, int H, int KV,
    int hd, long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, float scale,
    int dtype, void* stream) {
  const long long st[12] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            0, 0, 0, 0};
  return dispatch<false>(q, k, v, nullptr, nullptr, out, cache_len,
                         cache_len_scalar, B, Smax, H, KV, hd, st, scale, dtype,
                         static_cast<cudaStream_t>(stream));
}

// The int8 form: k, v int8 as above; k_scale, v_scale: fp32, one layer of the
// [L, B, KV, Smax] scale caches, [B, KV, Smax] by strides (batch, head) with
// the sequence contiguous.
extern "C" int dst_decode_attention_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, const void* cache_len, int cache_len_scalar,
    int B, int Smax, int H, int KV, int hd, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long ks_sb, long long ks_sh,
    long long vs_sb, long long vs_sh, float scale, int dtype, void* stream) {
  const long long st[12] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb,
                            v_ss, v_sh, ks_sb, ks_sh, vs_sb, vs_sh};
  return dispatch<true>(q, k, v, k_scale, v_scale, out, cache_len,
                          cache_len_scalar, B, Smax, H, KV, hd, st, scale,
                          dtype, static_cast<cudaStream_t>(stream));
}
