// GQA decode attention against a KV cache: the contiguous cache, and the
// block-paged pool of the serving engine.
//
// Replaces deepspeed_tpu/ops/pallas/decode_attention.py:_decode_kernel
// (line 76) and _paged_decode_kernel (line 111), with their shared
// _tile_update (line 35), reached through decode_attention_kernel (line 160)
// and paged_decode_attention_kernel (line 243) from decode_attention
// (line 323): the dense form over a bf16 (or fp32) cache, and the int8 form
// (has_scales=True) over an int8 cache with one fp32 scale per (token, kv
// head), each over a contiguous cache or through per-sequence page tables.
//
// out[r, h] = softmax(q[r, h] . K[s, :n, kv]^T * scale) @ V[s, :n, kv] with
// kv = h / (H / KV), s = r / rows_per_seq the sequence query row r reads, and
// n = min(cache_len[r] + 1, Smax): every position at or before the row's
// frontier is attended, as `kpos <= cache_len` in the TPU kernels. A row
// whose frontier is negative attends nothing and writes zeros (the TPU
// kernels' _finalize_out). With ALiBi slopes (BLOOM), each score is
// dot * scale - slope[h] * (frontier - pos), the key's distance from the
// row's own frontier, added before the mask and the fp32 softmax: what the TPU
// package computes for every ALiBi step after a fresh prefill, on its XLA path
// (models/decoding.py:424-438), since its Pallas decode kernel takes no slope.
// slopes == nullptr (Llama) skips the term, so those scores keep their bits.
// rows_per_seq = R lets the serving engine's
// [N, W] step run its W query rows of each slot, each at its own frontier,
// in one launch: the TPU package runs that window as XLA's masked softmax,
// row by row the same function.
//
// Paged form: key position p of sequence s lives in physical page
// page_table[s][p / page_size], row p % page_size, of the pool
// [P + 1, page_size, KV, hd] (scales [P + 1, KV, page_size]). Only that
// address changes: the key tiles, their order and the arithmetic are the
// dense kernel's, so a paged cache and a contiguous cache holding the same
// bytes give the same bits.
//
// Bound on the H100: bytes. The K and V rows up to each sequence's furthest
// frontier are read from memory once (2 * n * KV * hd * sizeof(T) per
// sequence over 3.35 TB/s; the R rows of a sequence share them through L2);
// the arithmetic is 4 * H * hd flops per (row, key), below the tensor-core
// line. Design: one 128-thread block per (kv head, query row), so the
// G = H / KV query heads of a group share every K/V tile load. The TPU kernel
// carries the online softmax (m, l, acc) across its sequential "arbitrary"
// grid axis; on Hopper the blocks run in parallel, so that carry is a loop
// over key tiles inside the block, stopping at the row's own frontier. Each
// tile (64 keys in bf16) arrives by 16-byte loads, all in flight at once and
// started one tile ahead, into padded shared memory (conflict-free row
// reads); a paged tile spans several pages and is gathered row by row with
// the same loads. Each score is one thread's dot product against fp32 query
// rows in shared memory, one warp per query head folds the tile into the
// running (max, sum), and thread d accumulates output column d for every
// query head of the group. The cache is read in place through its strides (a
// layer of the [L, ...] cache needs no copy); every row start must be 16-byte
// aligned.
//
// The int8 form reads the int8 K/V rows by the same 16-byte loads (16 values
// a load) together with each row's scale, and dequantizes each value as it
// lands in shared memory: float(q) * scale, rounded to q's dtype, the order
// of the TPU kernel's _tile_update:42-43. Bound: bytes, 2 * n * KV * (hd + 4).
//
// Known gaps: at a batch of one row and KV = 8 only 8 of the card's 132 SMs
// have a block (split-K over the sequence is the later fix), and the R rows
// of a sequence each stream its K/V from L2 instead of sharing one tile.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;

// Everything a launch needs, passed by value. Strides are in elements.
// k/v: dense [B, Smax, KV, hd] by (k_s0 = batch, k_s1 = seq, k_sh = head);
// paged [P + 1, page_size, KV, hd] by (k_s0 = page, k_s1 = row, k_sh = head).
// ks/vs: dense [B, KV, Smax] by (ks_s0 = batch, ks_sh = head), paged
// [P + 1, KV, page_size] by (ks_s0 = page, ks_sh = head), positions
// contiguous.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  void* out;
  const int* cache_len;  // [rows], or nullptr for cache_len_scalar
  const float* slopes;   // [H] ALiBi slopes, or nullptr
  int cache_len_scalar;
  const int* page_table;  // [B, max_pages] (paged form)
  int page_size;
  int max_pages;
  int rows_per_seq;
  int Smax;
  int H;
  int KV;
  long long q_sb, q_sh, k_s0, k_s1, k_sh, v_s0, v_s1, v_sh;
  long long ks_s0, ks_sh, vs_s0, vs_sh;
  float scale;
};

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
// with the fp32 scales); kPaged: the address policy of a key position.
template <typename T, typename TC, int HD, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Args a) {
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
  const int row = blockIdx.y;                 // query row
  const int seq = row / a.rows_per_seq;       // the sequence it reads
  const int G = a.H / a.KV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cl = a.cache_len != nullptr ? a.cache_len[row] : a.cache_len_scalar;
  const int n_keys = min(max(cl + 1, 0), a.Smax);
  const float* slopes = a.slopes != nullptr ? a.slopes + kvh * G : nullptr;

  const T* q = static_cast<const T*>(a.q);
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i - g * HD;
    qs[g][d] = dst::to_float(q[row * a.q_sb + (long long)(kvh * G + g) * a.q_sh + d]);
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  const TC* kb = static_cast<const TC*>(a.k) + kvh * a.k_sh;
  const TC* vb = static_cast<const TC*>(a.v) + kvh * a.v_sh;
  const float* ksb = kInt8 ? a.ks + kvh * a.ks_sh : nullptr;
  const float* vsb = kInt8 ? a.vs + kvh * a.vs_sh : nullptr;
  const int* pt = kPaged ? a.page_table + (long long)seq * a.max_pages : nullptr;

  // 16-byte loads of one K and one V tile into registers (and, int8, each
  // row's two scales), all in flight at once; the next tile's loads overlap
  // this tile's arithmetic. A key position's (block, row): (sequence,
  // position) in the dense cache, (its page, its row in the page) in the pool.
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
      const int pos = start + r;
      if (pos < n_keys) {
        long long blk;
        int off;
        if constexpr (kPaged) {
          const int lp = pos / a.page_size;
          blk = pt[lp];
          off = pos - lp * a.page_size;
        } else {
          blk = seq;
          off = pos;
        }
        kreg[j] = *reinterpret_cast<const uint4*>(
            kb + blk * a.k_s0 + off * a.k_s1 + c * kPerChunk);
        vreg[j] = *reinterpret_cast<const uint4*>(
            vb + blk * a.v_s0 + off * a.v_s1 + c * kPerChunk);
        if constexpr (kInt8) {
          kscl[j] = ksb[blk * a.ks_s0 + off];
          vscl[j] = vsb[blk * a.vs_s0 + off];
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
        s = dot * a.scale;
        if (slopes != nullptr) s -= slopes[g] * static_cast<float>(cl - (start + t));
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
    T* out = static_cast<T*>(a.out);
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float l = l_s[g];
        const float o = l == 0.f ? 0.f : acc[g] / l;
        out[((long long)row * a.H + kvh * G + g) * HD + tid] = dst::from_float<T>(o);
      }
    }
  }
}

// The cache's storage type: the query's (dense) or int8_t.
template <bool kInt8, typename T>
using CacheT = typename std::conditional<kInt8, int8_t, T>::type;

// The head sizes and query dtypes every form takes; rows query rows.
template <bool kInt8, bool kPaged>
int dispatch(const Args& a, int rows, int hd, int dtype, cudaStream_t s) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (a.KV <= 0 || a.H % a.KV != 0 || a.H / a.KV > kMaxGroup || a.rows_per_seq < 1
      || (kPaged && (a.page_size < 1 || a.max_pages < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(a.KV, rows);
  if (dtype == dst::kBFloat16 && hd == 128) {
    decode_attention_kernel<__nv_bfloat16, CacheT<kInt8, __nv_bfloat16>, 128, kPaged>
        <<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == dst::kBFloat16 && hd == 64) {
    decode_attention_kernel<__nv_bfloat16, CacheT<kInt8, __nv_bfloat16>, 64, kPaged>
        <<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == dst::kFloat32 && hd == 128) {
    decode_attention_kernel<float, CacheT<kInt8, float>, 128, kPaged>
        <<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == dst::kFloat32 && hd == 64) {
    decode_attention_kernel<float, CacheT<kInt8, float>, 64, kPaged>
        <<<grid, kThreads, 0, s>>>(a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

Args base_args(const void* q, const void* k, const void* v, void* out,
               int H, int KV, int rows_per_seq, long long q_sb, long long q_sh,
               long long k_s0, long long k_s1, long long k_sh, long long v_s0,
               long long v_s1, long long v_sh, const void* slopes, float scale) {
  Args a{};
  a.slopes = static_cast<const float*>(slopes);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.H = H;
  a.KV = KV;
  a.rows_per_seq = rows_per_seq;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_s0 = k_s0;
  a.k_s1 = k_s1;
  a.k_sh = k_sh;
  a.v_s0 = v_s0;
  a.v_s1 = v_s1;
  a.v_sh = v_sh;
  a.scale = scale;
  return a;
}

}  // namespace

// q: [rows, 1, H, hd] by strides (q_sb, q_sh); row r reads sequence
// r / rows_per_seq of k, v: one layer of the cache, [B, Smax, KV, hd] by
// strides (batch, seq, head); the last dim is contiguous everywhere. out:
// [rows, 1, H, hd] contiguous. cache_len: int32 [rows] on the device (each
// row's frontier), or nullptr to use cache_len_scalar for every row. slopes:
// fp32 [H] ALiBi slopes on the device, or nullptr for none (every form).
extern "C" int dst_decode_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* cache_len, int cache_len_scalar, int rows, int Smax, int H,
    int KV, int hd, int rows_per_seq, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, const void* slopes, float scale, int dtype,
    void* stream) {
  Args a = base_args(q, k, v, out, H, KV, rows_per_seq, q_sb, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, slopes, scale);
  a.cache_len = static_cast<const int*>(cache_len);
  a.cache_len_scalar = cache_len_scalar;
  a.Smax = Smax;
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
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.ks_s0 = ks_sb;
  a.ks_sh = ks_sh;
  a.vs_s0 = vs_sb;
  a.vs_sh = vs_sh;
  a.cache_len = static_cast<const int*>(cache_len);
  a.cache_len_scalar = cache_len_scalar;
  a.Smax = Smax;
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
  a.cache_len = static_cast<const int*>(cache_len);
  a.page_table = static_cast<const int*>(page_table);
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.Smax = max_pages * page_size;
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
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.ks_s0 = ks_sp;
  a.ks_sh = ks_sh;
  a.vs_s0 = vs_sp;
  a.vs_sh = vs_sh;
  a.cache_len = static_cast<const int*>(cache_len);
  a.page_table = static_cast<const int*>(page_table);
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.Smax = max_pages * page_size;
  return dispatch<true, true>(a, rows, hd, dtype, static_cast<cudaStream_t>(stream));
}
