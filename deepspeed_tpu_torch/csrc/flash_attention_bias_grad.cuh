// Gradient of a broadcast dense attention bias (bf16 or fp16 q/k/v, GQA) for Hopper:
// wgmma tensor-core products on tiles that TMA streams through a ring of
// shared-memory stages, the output tile held in registers.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:_bias_grad_kernel
// (line 570), driven by _bias_grad_call (line 614) from _flash_bwd when the
// bias broadcasts over the batch or the heads ([1, H, S, S], [B, 1, S, S] or
// [1, 1, S, S]):
//   dbias[bo, ho, i, j] = sum over the (b, h) that read bias[bo, ho] of
//                         p[b, h, i, j] * (dp[b, h, i, j] - delta[b, h, i])
// with p = exp(s - lse) recomputed from the forward's lse (s with the same
// bias, segment ids and ALiBi slopes, by flash_attention.cuh:masked_score, the
// forward's and the dq kernel's score), dp = do . v, and delta from the dq
// kernel. dbias is written once, in the bias's dtype; a pair that no (b, h)
// sees is written as 0.
//
// Bound on the H100: bytes at training lengths: the visible half of the bias
// read once, dbias written once, q, k, v and do read once (4 * D flops a
// visible pair and (b, h), over 989 TFLOP/s bf16, is below it). Design
// (flash_attention_sm90.cuh and flash_attention_tiles.cuh hold the building
// blocks, which the forward and backward kernels share), output tile
// stationary:
//   Persistent blocks (one an SM), each of three warpgroups: two consumers,
//   each owning 64 query rows of the block's output tile of kRows rows by BN
//   keys (BgSmem::kBN: 64, or 32 at head dim 128 for shared memory) and its
//   fp32 sum in registers, and a producer whose first warp walks the block's
//   tiles (tile t of the grid's list takes blocks t, t + grid, ...; a slab's
//   tiles query block by query block) and, for each, the (b, h) pairs that
//   read the slab in the Pallas grid's order (heads outer and batch rows
//   inner for a bias [1, *, S, S], the heads inner for [B, 1, S, S]). The
//   producer gives its registers to the consumers (setmaxnreg).
//   A tile's bias rows arrive once, by TMA (128-byte swizzled panels, a
//   broadcast dim read at coordinate 0), into one of two bias buffers, so the
//   next tile's bias lands while the current tile computes; every pair reads
//   the bias from shared memory. A ring stage holds a pair's Q and dO rows
//   (TMA), its K and V tile (TMA), and its lse, delta and segment ids
//   (cp.async), all counted on the stage's full barrier, so the next pairs'
//   tiles land while the current pair computes.
//   Per pair: S = Q K^T and dP = dO V^T by wgmma, both operands in shared
//   memory, K-major; p = exp2(score - lse) while dP is still in the tensor
//   cores; then dst = p (dP - delta) added into the tile's fp32 sum.
//   Tile classes (tile_class): a tile wholly above the causal diagonal is
//   written as zeros by the consumers with no load and no product; the
//   producer judges each pair against each consumer's rows by the pair's
//   segment-id ranges: a pair that meets neither consumer's rows is not
//   loaded, a consumer skips a pair empty for its rows, and a full pair
//   takes the epilogue without per-pair tests.
//   The write: each consumer rounds its sum to the bias's dtype into its own
//   rows of the tile's bias buffer (the bias's layout), then stores its rows
//   as 16-byte chunks, a row's chunks on neighbouring threads (element by
//   element where a row of S is not whole chunks).
//   The sum over pairs runs in the walk's fixed order, and no atomics: two
//   runs give the same bits.
// Head dims 64 and 128; any GQA group; a bias in fp32, bf16 or fp16; segment ids,
// ALiBi slopes, causal or not; S need not be a multiple of a tile (TMA
// fills rows and keys past S with zeros, the per-pair tests drop them).
//
// This header holds the kernel, templated on its element type T (bf16 or
// fp16: __nv_bfloat16 or __half; .f32.bf16.bf16 or .f32.f16.f16 products and
// the matching tensor maps; the bias's own dtype is read at run time), and
// its C entry's body (bias_grad_entry<T>); flash_attention_bias_grad.cu (bf16)
// and flash_attention_bias_grad_f16.cu (fp16) instantiate it, each compiled by
// its own nvcc. Its helpers sit in an anonymous namespace: each unit has its
// own copy.
#pragma once

#include "flash_attention_tiles.cuh"

using namespace dst::flash;
using namespace dst::sm90;

namespace {

struct BgParams {
  CUtensorMap q, dout;  // boxes: kRows rows
  CUtensorMap k, v;     // boxes: BgSmem::kBN rows
  CUtensorMap bias;     // boxes: 128 bytes of keys x kRows query rows
  const float* lse;     // [B, H, S]
  const float* delta;   // [B, H, S]
  int B, S, H, KV, Bb, Hb;
  int n_qb, n_kt, n_tiles;  // query blocks and key tiles a slab; tiles of the grid
  const float* slopes;
  float scale_log2;
  int causal;
  Mask mask;  // segment ids, the bias (strides, dtype) and the dbias output
};

template <int BN>
struct BgMeta {         // what the producer tells the consumers of a stage
  int h;                // the pair's head
  int cls[kGroups];     // its class for each consumer's rows
  float lse[kRows];     // the block's rows (cp.async; 0 past S)
  float delta[kRows];
  int qseg[kRows];      // segment ids of the rows and of the tile's keys
  int kseg[BN];
};

// Shared memory: the ring's stages (Q, dO, K, V), two bias buffers, the
// stages' metadata, the barriers.
template <int HD>
struct BgSmem {
  static constexpr int kBN = HD == 64 ? 64 : 32;  // keys an output tile
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kQ = kRows * HD * 2;       // Q (and dO) of a stage
  static constexpr int kKV = kBN * HD * 2;        // K (and V) of a stage
  static constexpr int kStage = 2 * kQ + 2 * kKV;
  // a bias tile: kRows rows of 128-byte panels (fp32 room for kBN keys; a
  // bf16 box is 64 keys)
  static constexpr int kBias = kRows * (kBN * 4 > 128 ? kBN * 4 : 128);
  static constexpr int kBiasAt = kStages * kStage;
  static constexpr int kMeta = kBiasAt + 2 * kBias;
  static constexpr int kBars =
      (kMeta + kStages * static_cast<int>(sizeof(BgMeta<kBN>)) + 7) & ~7;
  static constexpr int kBytes = kBars + (2 * kStages + 4) * 8 + 1024;
};

template <int HD, typename T>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bias_grad_kernel(const __grid_constant__ BgParams p) {
  using L = BgSmem<HD>;
  constexpr int BN = L::kBN;
  constexpr int NST = L::kStages;
  using Meta = BgMeta<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t s0 = smem_addr(sm);
  Meta* meta = reinterpret_cast<Meta*>(sm + L::kMeta);
  const uint32_t bars = s0 + L::kBars;  // full[NST], empty[NST], bias full[2], bias empty[2]
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NST + st); };
  auto bias_full = [&](int i) { return bars + 8 * (2 * NST + i); };
  auto bias_empty = [&](int i) { return bars + 8 * (2 * NST + 2 + i); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid & 31;
  const Mask& mask = p.mask;
  const int S = p.S;
  const bool has_seg = mask.seg != nullptr;
  const int bias_dtype = mask.bias_dtype;
  const bool narrow = bias_dtype != dst::kFloat32;  // 2-byte storage
  const int per_slab = p.n_qb * p.n_kt;
  // the pairs (b, h) that read a slab, in the Pallas grid's order
  const int npairs = (p.Bb == 1 ? p.B : 1) * (p.Hb == 1 ? p.H : 1);
  auto pair_of = [&](int bo, int ho, int i, int& b, int& h) {
    if (p.Hb != 1) {  // [1, H, S, S]: the batch rows ([B, H, S, S]: the slab's own)
      b = p.Bb == 1 ? i : bo;
      h = ho;
    } else if (p.Bb == 1) {  // [1, 1, S, S]: heads outer, batch rows inner
      b = i % p.B;
      h = i / p.B;
    } else {  // [B, 1, S, S]: the heads
      b = bo;
      h = i;
    }
  };
  // tile t: slab (bo, ho), query rows from row_base, keys from k0
  auto tile_of = [&](int t, int& bo, int& ho, int& row_base, int& k0) {
    const int slab = t / per_slab;
    const int rem = t - slab * per_slab;
    bo = slab / p.Hb;
    ho = slab - bo * p.Hb;
    row_base = (rem / p.n_kt) * kRows;
    k0 = (rem % p.n_kt) * BN;
  };
  auto zero_tile = [&](int row_base, int k0) {
    return p.causal && k0 > row_base + kRows - 1;  // wholly above the diagonal
  };

  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(full(st), 33);  // 32 producer lanes' copies + lane 0's arrival
      mbar_init(empty(st), 4 * kGroups);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(bias_full(i), 1);
      mbar_init(bias_empty(i), 4 * kGroups);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kGroups) {
    // ---------------- producer ----------------
    regs_dec<kProducerRegs>();
    if (tid / 32 != 4 * kGroups) return;
    const int box_keys = narrow ? 64 : 32;  // 128 bytes of keys
    const uint32_t bias_bytes = kRows * 128 * ((BN + box_keys - 1) / box_keys);
    const uint32_t pair_bytes = 2 * tile_bytes<HD, kRows>() + 2 * tile_bytes<HD, BN>();
    Ring<NST> ring;
    Ring<2> bring;
    for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
      int bo, ho, row_base, k0;
      tile_of(t, bo, ho, row_base, k0);
      if (zero_tile(row_base, k0)) continue;
      mbar_wait(bias_empty(bring.stage), bring.phase ^ 1u);
      if (lane == 0) {
        const uint32_t fb = bias_full(bring.stage);
        const uint32_t dst = s0 + L::kBiasAt + bring.stage * L::kBias;
        mbar_arrive_expect_tx(fb, bias_bytes);
        for (int c = 0; c < BN; c += box_keys) {
          tma_load_4d(dst + (c / box_keys) * kRows * 128, &p.bias, fb, k0 + c, row_base,
                      mask.bias_sh != 0 ? ho : 0, mask.bias_sb != 0 ? bo : 0);
        }
      }
      bring.next();
      for (int i = 0; i < npairs; ++i) {
        int b, h;
        pair_of(bo, ho, i, b, h);
        const int* seg_b = has_seg ? mask.seg + (long long)b * S : nullptr;
        int2 ids;
        const int2 kseg = has_seg ? seg_range(seg_b, k0, S, lane, ids) : make_int2(0, 0);
        int cls[kGroups];
        bool any = false;
#pragma unroll
        for (int w = 0; w < kGroups; ++w) {
          const int r0 = row_base + 64 * w;
          const int2 qseg = has_seg ? seg_range(seg_b, r0, S, lane, ids) : kseg;
          cls[w] = tile_class(r0, r0 + 63, k0, k0 + BN - 1, S, p.causal, 0, 0, has_seg, qseg,
                              kseg);
          any |= cls[w] != kEmpty;
        }
        const uint32_t fb = full(ring.stage);
        mbar_wait(empty(ring.stage), ring.phase ^ 1u);
        Meta& m = meta[ring.stage];
        if (any) {
          const long long lrow = ((long long)b * p.H + h) * S;
          for (int r = lane; r < kRows; r += 32) {
            const int row = row_base + r;
            const bool in = row < S;
            cp_async_4(smem_addr(m.lse + r), p.lse + (in ? lrow + row : 0), in);
            cp_async_4(smem_addr(m.delta + r), p.delta + (in ? lrow + row : 0), in);
            if (has_seg) cp_async_4(smem_addr(m.qseg + r), seg_b + (in ? row : 0), in);
          }
          if (has_seg) {
            for (int c = lane; c < BN; c += 32) {
              const bool in = k0 + c < S;
              cp_async_4(smem_addr(m.kseg + c), seg_b + (in ? k0 + c : 0), in);
            }
          }
        }
        if (lane == 0) {
          m.h = h;
#pragma unroll
          for (int w = 0; w < kGroups; ++w) m.cls[w] = cls[w];
          if (any) {
            const uint32_t st = s0 + ring.stage * L::kStage;
            const int kvh = h / (p.H / p.KV);
            mbar_arrive_expect_tx(fb, pair_bytes);
            tma_rows<HD, kRows>(st, &p.q, fb, row_base, h, b);
            tma_rows<HD, kRows>(st + L::kQ, &p.dout, fb, row_base, h, b);
            tma_rows<HD, BN>(st + 2 * L::kQ, &p.k, fb, k0, kvh, b);
            tma_rows<HD, BN>(st + 2 * L::kQ + L::kKV, &p.v, fb, k0, kvh, b);
          } else {
            mbar_arrive(fb);  // a pair no consumer sees: no load
          }
        }
        cp_async_arrive(fb);
        ring.next();
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  regs_inc<kConsumerRegs>();
  const int wi = (tid / 32) & 3;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r_lo = 64 * wg;  // this consumer's rows of a tile
  const int it = tid & 127;  // its thread among the consumer's
  const float scale_log2 = p.scale_log2;
  const bool alibi = p.slopes != nullptr;
  const int esize = narrow ? 2 : 4;
  const int chunks = BN * esize / 16;  // 16-byte chunks a tile row
  const bool whole = (static_cast<long long>(S) * esize) % 16 == 0;  // rows of whole chunks
  uint8_t* out = static_cast<uint8_t*>(mask.dbias);

  // Store this consumer's 64 rows of the tile at (row_base, k0) of slab base
  // `slab`: chunk c of row r from from(r, c) (16 bytes), rows and keys past S
  // dropped.
  auto store_rows = [&](long long slab, int row_base, int k0, auto&& from) {
    for (int i = it; i < 64 * chunks; i += 128) {
      const int r = r_lo + i / chunks;
      const int c = i % chunks;
      const int row = row_base + r;
      const int key = k0 + c * (16 / esize);
      if (row >= S || key >= S) continue;
      const uint4 v = from(r, c);
      uint8_t* at = out + ((slab + row) * S + key) * esize;
      if (whole) {
        *reinterpret_cast<uint4*>(at) = v;
      } else {
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&v);
        for (int j = 0; j < 16 / esize && key + j < S; ++j) {
          for (int u = 0; u < esize; ++u) at[j * esize + u] = bytes[j * esize + u];
        }
      }
    }
  };

  Ring<NST> ring;
  Ring<2> bring;
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    int bo, ho, row_base, k0;
    tile_of(t, bo, ho, row_base, k0);
    const long long slab = static_cast<long long>(bo * p.Hb + ho) * S;
    if (zero_tile(row_base, k0)) {
      store_rows(slab, row_base, k0, [](int, int) { return make_uint4(0u, 0u, 0u, 0u); });
      continue;
    }
    const int row0 = row_base + r_lo + 16 * wi + g;  // this thread's rows
    const int row1 = row0 + 8;
    const int lr0 = row0 - row_base, lr1 = lr0 + 8;  // their rows in the tile
    uint8_t* bt = sm + L::kBiasAt + bring.stage * L::kBias;
    float acc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    mbar_wait(bias_full(bring.stage), bring.phase);
    for (int i = 0; i < npairs; ++i) {
      mbar_wait(full(ring.stage), ring.phase);
      const Meta& m = meta[ring.stage];
      const int cls = m.cls[wg];
      if (cls != kEmpty) {
        const uint32_t st = s0 + ring.stage * L::kStage;
        float s[BN / 2], dp[BN / 2];
        wgmma_fence();
        ss_product<HD, BN, T>(s, st, kRows, r_lo, st + 2 * L::kQ);          // S = Q K^T
        wgmma_commit();
        ss_product<HD, BN, T>(dp, st + L::kQ, kRows, r_lo, st + 2 * L::kQ + L::kKV);  // dP = dO V^T
        wgmma_commit();
        const float l0 = m.lse[lr0] * kLog2e, l1 = m.lse[lr1] * kLog2e;
        const float d0 = m.delta[lr0], d1 = m.delta[lr1];
        const float slope_log2 = alibi ? p.slopes[m.h] * kLog2e : 0.f;
        const int q0 = has_seg ? m.qseg[lr0] : 0, q1 = has_seg ? m.qseg[lr1] : 0;
        // p (in s) while dP is still in the tensor cores; kTest: a partial
        // pair's per-pair tests
        auto pass_p = [&](auto test) {
          constexpr bool kTest = decltype(test)::value;
#pragma unroll
          for (int e = 0; e < BN / 2; e += 2) {
            const bool hi = e & 2;
            const int row = hi ? row1 : row0;
            const int c = 8 * (e >> 2) + 2 * tq;  // the pair's first key, in the tile
            const float2 bias = bias_pair(bt, hi ? lr1 : lr0, c, bias_dtype);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int key = k0 + c + u;
              bool vis = true;
              if constexpr (kTest) {
                vis = key < S && row < S && (!p.causal || key <= row) &&
                      (!has_seg || m.kseg[c + u] == (hi ? q1 : q0));
              }
              const float sc = masked_score(s[e + u], scale_log2, true, u ? bias.y : bias.x,
                                            alibi, slope_log2, row, key);
              s[e + u] = vis ? fast_exp2(sc - (hi ? l1 : l0)) : 0.f;
            }
          }
        };
        wgmma_wait<1>();
        fence_regs(s);
        if (cls == kFull) {
          pass_p(std::false_type{});
        } else {
          pass_p(std::true_type{});
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[e] += s[e] * (dp[e] - ((e & 2) ? d1 : d0));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(ring.stage));
      ring.next();
    }
    // the sum in the bias's dtype into this warp's rows of the bias buffer
    // (only this warp reads them), then the consumer's rows out
    __syncwarp();
#pragma unroll
    for (int e = 0; e < BN / 2; e += 2) {
      const int c = 8 * (e >> 2) + 2 * tq;
      uint8_t* at = bt + bias_offset((e & 2) ? lr1 : lr0, c, narrow);
      if (bias_dtype == dst::kFloat16) {  // rounded to nearest: an overflow stays inf
        *reinterpret_cast<uint32_t*>(at) = pack2<__half>(acc[e], acc[e + 1]);
      } else if (narrow) {
        *reinterpret_cast<uint32_t*>(at) = pack_f32(acc[e], acc[e + 1]);
      } else {
        *reinterpret_cast<float2*>(at) = make_float2(acc[e], acc[e + 1]);
      }
    }
    named_sync(1 + wg, 128);
    store_rows(slab, row_base, k0, [&](int r, int c) {
      return *reinterpret_cast<const uint4*>(bt + (c >> 3) * (kRows * 128) + r * 128 +
                                             (((c & 7) ^ (r & 7)) << 4));
    });
    __syncwarp();
    if (lane == 0) mbar_arrive(bias_empty(bring.stage));
    bring.next();
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

// The maps of q and do (kRows-row boxes), k and v (output-tile boxes) and the
// bias, then the persistent launch.
template <int HD, typename T>
cudaError_t launch_bias_grad(BgParams& prm, const void* q, const void* k, const void* v,
                             const void* dout, const long long* st, cudaStream_t s) {
  using L = BgSmem<HD>;
  const Strides qs = at(st, 0), ks = at(st, 1), vs = at(st, 2), dos = at(st, 3);
  const Mask& m = prm.mask;
  const int B = prm.B, S = prm.S;
  constexpr CUtensorMapDataType ty = tma_type<T>();
  if (!encode_rows_map(&prm.q, q, B, S, prm.H, HD, qs.sb, qs.ss, qs.sh, kRows, ty) ||
      !encode_rows_map(&prm.dout, dout, B, S, prm.H, HD, dos.sb, dos.ss, dos.sh, kRows, ty) ||
      !encode_rows_map(&prm.k, k, B, S, prm.KV, HD, ks.sb, ks.ss, ks.sh, L::kBN, ty) ||
      !encode_rows_map(&prm.v, v, B, S, prm.KV, HD, vs.sb, vs.ss, vs.sh, L::kBN, ty) ||
      !encode_bias_map(&prm.bias, m.bias, m.bias_dtype, B, S, prm.H, m.bias_sb,
                       m.bias_sh, m.bias_sq, kRows))
    return cudaErrorInvalidValue;
  prm.n_qb = (S + kRows - 1) / kRows;
  prm.n_kt = (S + L::kBN - 1) / L::kBN;
  prm.n_tiles = prm.n_qb * prm.n_kt * prm.Bb * prm.Hb;
  const int grid = prm.n_tiles < sm_count() ? prm.n_tiles : sm_count();
  return launch(flash_bias_grad_kernel<HD, T>, prm, dim3(grid), L::kBytes, s);
}

// The body of the C entries dst_flash_attention_bias_grad (T = bf16) and
// dst_flash_attention_bias_grad_f16 (T = __half).
// q, do: [B, S, H, hd]; k, v: [B, S, KV, hd], by strides (st: q, k, v, do;
// read by TMA: 16-byte aligned start and strides); lse and delta (the dq
// kernel's): [B, H, S] fp32 contiguous. slopes: fp32 [H] or nullptr. mask: the
// forward's masked form (flash_attention.cuh:parse_mask) with its bias
// [Bb, Hb, S, S] (Bb in {1, B}, Hb in {1, H}; read by TMA: 16-byte aligned
// start and query-row stride) and, in the dbias slot, the [Bb, Hb, S, S]
// contiguous output in the bias's dtype; no table, no offsets.
template <typename T>
int bias_grad_entry(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, int B, int S, int H, int KV, int hd, int Bb, int Hb,
    const long long* st, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || mask == nullptr || mask[1] == 0 || mask[10] == 0 ||
      mask[6] != 0 || mask[11] != 0 || mask[12] != 0 || mask[13] != 0 ||
      (Bb != 1 && Bb != B) || (Hb != 1 && Hb != H) || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  BgParams prm;
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<const float*>(delta);
  prm.B = B;
  prm.S = S;
  prm.H = H;
  prm.KV = KV;
  prm.Bb = Bb;
  prm.Hb = Hb;
  prm.slopes = static_cast<const float*>(slopes);
  prm.scale_log2 = scale * kLog2e;
  prm.causal = causal;
  prm.mask = parse_mask(mask);
  const cudaError_t r = hd == 128 ? launch_bias_grad<128, T>(prm, q, k, v, dout, st, s)
                                  : launch_bias_grad<64, T>(prm, q, k, v, dout, st, s);
  return static_cast<int>(r);
}

}  // namespace
