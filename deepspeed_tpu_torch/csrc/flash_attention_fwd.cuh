// Flash attention forward (bf16 or fp16, causal or not, GQA) for Hopper: wgmma
// tensor-core products, a TMA-fed ring of K/V tiles and per-tile mask
// classification.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:_fwd_kernel (line 175),
// driven by _flash_fwd (line 334) from flash_attention (line 1011), in all its
// forms: causal, grouped-query heads, ALiBi slopes, segment ids, a dense
// additive bias, a block-sparse layout and the position offsets of ring
// attention's hops (has_offsets; the hops are deepspeed_tpu/ops/pallas/
// ring_flash.py:_rf_fwd, line 83, ported by deepspeed_tpu_torch/ops/ring_flash.py).
//
// out[b, s, h] = softmax_k(score, masks) @ v with
// score = q[b, s, h] . k[b, k, kv]^T * scale + bias[b, h, s, k] - slope[h] * |s - k|,
// kv = h / (H / KV); lse[b, h, s] = log sum_k exp(score), kept for a backward.
// A key is visible when it is inside S, not above the diagonal (causal), in
// the row's segment (seg[b, s] == seg[b, k]) and in an active block of the
// layout; _mask_and_bias (flash_attention.py:94-113) applies the same masks.
// Under offsets (a ring hop: the local query chunk against a visiting key
// chunk) the row's and the key's global positions s + qoff and k + koff take
// their places in the causal test and the ALiBi distance, and the keys'
// segment ids are the visiting chunk's (seg_k). A row with nothing visible
// writes out = 0 and lse = -1e30 (the JAX package's finite NEG_INF, which the
// ring's logaddexp merge and the backward read); a hop wholly in the future
// walks no tile.
//
// Bound on the H100: operations for long prompts. The two products are 4 * D
// flops per visible (query, key) pair over 989 TFLOP/s of bf16 tensor-core
// rate, which only wgmma reaches; q, k, v and out are read or written once,
// a dense bias once per visible pair. Design (flash_attention_sm90.cuh and
// flash_attention_tiles.cuh have the building blocks, which the backward
// kernels share):
//   One block per (128 query rows, head, batch row), of three warpgroups:
//   two consumers, each owning 64 query rows, its fp32 output accumulator
//   and its online-softmax state (max, sum) in registers, and a producer
//   whose first warp walks the block's key tiles and keeps a ring of stages
//   filled by TMA (full and empty mbarriers); the producer gives its
//   registers to the consumers (setmaxnreg). Q arrives once by TMA; a
//   stage holds a K and a V tile, the tile's key segment ids (cp.async) and,
//   with a dense bias, the bias's 128 x BN tile (TMA, 128-byte swizzled
//   panels, broadcast dims read at coordinate 0), all counted on the stage's
//   full barrier, so the bias is read once per visible tile and never pair
//   by pair from device memory. Tensors are read through their (batch, seq,
//   head) strides by 4-D tensor maps (the model layout [B, S, H, D], no
//   transposes); TMA fills rows and keys past S with zeros.
//   Per tile: S = Q K^T by wgmma with both operands in shared memory,
//   K-major; the scores scaled into the log2 domain, masked and offset, the
//   online softmax, p rounded to T (bf16 or fp16) A fragments in place (the accumulator
//   layout is the A operand's; the TPU kernel rounds p likewise); then
//   O += P V by wgmma with P from registers and V read MN-major (the
//   transpose bit). A tile's P V product is issued together with the next
//   tile's Q K^T and runs while that tile's softmax does; the stage is
//   released once it is done. The two consumers take turns to issue their
//   products (named barriers), so one's exponentials run while the other's
//   products do.
//   Key tiles (BN keys, FwdSmem::kBN; ops/cuda/flash_attention.py:
//   ring_tile sizes the maps' boxes by the same rule, the backward's): 128 for the
//   unmasked forms at head dim 64 (S tiles of 64 x 128, 64 accumulator
//   registers), else 64: at head dim 128 the output accumulator takes 64
//   registers and three 128-key stages would not fit shared memory, and the
//   masked form's stage carries a 128 x BN fp32 bias tile. Three stages,
//   two for the masked form at head dim 128 (shared memory again).
//   Tile classes: the producer judges each key tile against each consumer's
//   64 rows before it loads it: empty (above the causal diagonal under qoff
//   and koff, past S, or segment-id ranges that do not meet), full (every
//   pair visible) or partial. The key tiles' segment-id ranges are reduced
//   once a block by the consumers before the walk. A tile empty for both
//   consumers is never loaded; a consumer takes a tile empty for its own
//   rows as a partial one (all its pairs test invisible), which keeps every
//   consumer's products in step with the ring; a full tile takes the
//   epilogue without per-pair tests, which still adds the bias and ALiBi
//   terms where given; only a partial tile tests each pair. With a layout
//   the producer walks only the tiles of the active blocks (the table per
//   query layout row, flash_attention.py:138). Causal grids launch their
//   longest blocks first, so the short ones fill the tail.
// Three instantiations per head dim: slopes == nullptr without a mask
// (Llama), ALiBi without a mask, and the masked form, which reads its segment
// ids, bias, compaction tables and (optional) slopes at run time. Position
// offsets alone (a ring hop without segment ids) run an unmasked form, which
// reads them too: a past hop is then all full tiles. Every score is computed
// by the functions the backward kernels use (masked_score, alibi_score, the
// Llama form's __fmul_rn), so p recomputed from lse there is the p whose sum
// went into lse here, and the Llama form is bitwise the ALiBi form with
// slopes of zero. No atomics: two runs give the same bits.
//
// This header holds the kernel, templated on its element type T (bf16 or
// fp16: __nv_bfloat16 or __half), and its C entry's body (fwd_entry<T>); the
// translation units flash_attention_fwd.cu (bf16: every form) and
// flash_attention_fwd_f16.cu (fp16: the Llama form) instantiate it, each
// compiled by its own nvcc. Its helpers sit in an anonymous namespace: each
// unit has its own copy.
#pragma once

#include "flash_attention_tiles.cuh"

using namespace dst::flash;
using namespace dst::sm90;

namespace {

template <typename T>
struct FwdParams {
  CUtensorMap q, k, v;  // boxes: kRows rows of q, FwdSmem::kBN of k and v
  CUtensorMap bias;     // boxes: 128 bytes of keys x kRows query rows
  T* out;
  float* lse;
  int S, H, KV;
  Strides os;
  const float* slopes;
  float scale_log2;
  int causal;
  Mask mask;
};

template <int BN>
struct FwdMeta {     // what the producer tells the consumers of a stage
  int tile;          // key tile index; -1 ends the walk
  int cls[kGroups];  // its class for each consumer's rows
  int seg[BN];       // the tile's key segment ids (cp.async; 0 past S)
};

// Shared memory: Q; the ring's K, V; its bias tiles (the masked form); its
// metadata; the barriers; then the segment-id ranges of each consumer's rows
// and of the key tiles.
template <int HD, bool kMasked>
struct FwdSmem {
  static constexpr int kBN = HD == 64 && !kMasked ? 128 : 64;
  static constexpr int kStages = HD == 128 && kMasked ? 2 : 3;
  static constexpr int kQ = kRows * HD * 2;       // Q of the block
  static constexpr int kKV = kBN * HD * 2;        // K (and V) of a stage
  static constexpr int kBias = kMasked ? kRows * kBN * 4 : 0;  // fp32 room
  static constexpr int kBiasAt = kQ + kStages * 2 * kKV;
  static constexpr int kMeta = kBiasAt + kStages * kBias;
  static constexpr int kBars =
      (kMeta + kStages * static_cast<int>(sizeof(FwdMeta<kBN>)) + 7) & ~7;
  static constexpr int kRanges = kBars + (2 * kStages + 2) * 8;
  static int bytes(int n_tiles) { return kRanges + 8 * (kGroups + n_tiles) + 1024; }
};

template <int HD, bool kAlibi, bool kMasked, typename T>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_fwd_kernel(const __grid_constant__ FwdParams<T> p) {
  using L = FwdSmem<HD, kMasked>;
  constexpr int BN = L::kBN;
  constexpr int NST = L::kStages;
  using Meta = FwdMeta<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t s_q = smem_addr(sm), s_kv = s_q + L::kQ, s_bias = s_q + L::kBiasAt;
  Meta* meta = reinterpret_cast<Meta*>(sm + L::kMeta);
  const uint32_t bars = s_q + L::kBars;  // full[NST], empty[NST], qbar, rbar
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NST + st); };
  const uint32_t qbar = bars + 16 * NST;
  const uint32_t rbar = qbar + 8;
  int2* own_seg = reinterpret_cast<int2*>(sm + L::kRanges);  // [kGroups]
  int2* tile_seg = own_seg + kGroups;                         // [key tiles]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qblock = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // longest first
  const int kvh = h / (p.H / p.KV);
  const int S = p.S;
  const int row_base = qblock * kRows;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid & 31;
  const Mask& mask = p.mask;
  const bool has_seg = kMasked && mask.seg != nullptr;
  const bool has_bias = kMasked && mask.bias != nullptr;
  const int qoff = mask.qoff;  // ring hops' global positions (0 otherwise)
  const int koff = mask.koff;
  const int* seg_b = has_seg ? mask.seg + (long long)b * S : nullptr;
  const int* segk_b =
      has_seg ? (mask.seg_k != nullptr ? mask.seg_k : mask.seg) + (long long)b * S : nullptr;
  const int n_all = (S + BN - 1) / BN;
  // the key tiles the causal walk reaches (none for a hop wholly in the future)
  const int n_tiles =
      p.causal ? causal_key_tiles<BN>(row_base + kRows - 1, qoff, koff, n_all) : n_all;

  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(full(st), 33);  // 32 producer lanes' copies + lane 0's arrival
      mbar_init(empty(st), 4 * kGroups);
    }
    mbar_init(qbar, 1);
    mbar_init(rbar, 4 * kGroups);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kGroups) {
    // ---------------- producer ----------------
    regs_dec<kProducerRegs>();
    if (tid / 32 != 4 * kGroups) return;
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(qbar, tile_bytes<HD, kRows>());
      tma_rows<HD, kRows>(s_q, &p.q, qbar, row_base, h, b);
    }
    if (has_seg) mbar_wait(rbar, 0);
    const int bias_h = mask.bias_sh != 0 ? h : 0;  // broadcast dims at coordinate 0
    const int bias_b = mask.bias_sb != 0 ? b : 0;
    const int box_keys = mask.bias_bf16 ? 64 : 32;  // 128 bytes of keys
    const uint32_t bias_bytes = has_bias ? kRows * BN * (mask.bias_bf16 ? 2 : 4) : 0;
    Ring<NST> ring;
    auto visit = [&](int t) {
      const int k0 = t * BN;
      const int2 kseg = has_seg ? tile_seg[t] : make_int2(0, 0);
      int cls[kGroups];
      bool any = false;
#pragma unroll
      for (int w = 0; w < kGroups; ++w) {
        const int r0 = row_base + 64 * w;
        cls[w] = tile_class(r0, r0 + 63, k0, k0 + BN - 1, S, p.causal, qoff, koff, has_seg,
                            has_seg ? own_seg[w] : kseg, kseg);
        any |= cls[w] != kEmpty;
      }
      if (!any) return;
      const uint32_t fb = full(ring.stage);
      mbar_wait(empty(ring.stage), ring.phase ^ 1u);
      Meta& m = meta[ring.stage];
      if (has_seg) {
        for (int i = lane; i < BN; i += 32) {
          const bool in = k0 + i < S;
          cp_async_4(smem_addr(m.seg + i), segk_b + (in ? k0 + i : 0), in);
        }
      }
      if (lane == 0) {
        m.tile = t;
#pragma unroll
        for (int w = 0; w < kGroups; ++w) m.cls[w] = cls[w];
        const uint32_t sk = s_kv + ring.stage * 2 * L::kKV;
        mbar_arrive_expect_tx(fb, 2 * tile_bytes<HD, BN>() + bias_bytes);
        tma_rows<HD, BN>(sk, &p.k, fb, k0, kvh, b);
        tma_rows<HD, BN>(sk + L::kKV, &p.v, fb, k0, kvh, b);
        if (has_bias) {
          const uint32_t sb = s_bias + ring.stage * L::kBias;
          for (int c = 0; c < BN; c += box_keys) {
            tma_load_4d(sb + (c / box_keys) * kRows * 128, &p.bias, fb, k0 + c, row_base,
                        bias_h, bias_b);
          }
        }
      }
      cp_async_arrive(fb);
      ring.next();
    };
    if (kMasked && mask.cols != nullptr) {
      for_tiles<BN>(mask, row_base / mask.blk, 0, n_tiles, visit);
    } else {
      for (int t = 0; t < n_tiles; ++t) visit(t);
    }
    mbar_wait(empty(ring.stage), ring.phase ^ 1u);
    if (lane == 0) {
      meta[ring.stage].tile = -1;
      mbar_arrive(full(ring.stage));
    }
    cp_async_arrive(full(ring.stage));
    return;
  }

  // ---------------- consumers ----------------
  regs_inc<kConsumerRegs>();
  const int wi = (tid / 32) & 3;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r_lo = row_base + 64 * wg;
  const int row0 = r_lo + 16 * wi + g;  // this thread's rows
  const int row1 = row0 + 8;
  if (has_seg) {
    tile_ranges<BN>(segk_b, 0, n_tiles, seg_b, wi == 0 ? r_lo : -1, own_seg + wg, tile_seg,
                    S, tid / 32, lane, rbar);
  }
  const float scale_log2 = p.scale_log2;
  const bool alibi = kAlibi || (kMasked && p.slopes != nullptr);
  const float slope_log2 = alibi ? p.slopes[h] * kLog2e : 0.f;
  const int seg0 = has_seg && row0 < S ? seg_b[row0] : 0;
  const int seg1 = has_seg && row1 < S ? seg_b[row1] : 0;
  const bool bias_bf16 = mask.bias_bf16 != 0;
  // a score carries a term beyond q . k * scale (every tile, full or not)
  const bool terms = kAlibi || (kMasked && (has_bias || alibi));

  float o[HD / 2];  // the output accumulator, rows row0 and row1
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // running sum over this thread's columns
  float s[BN / 2];                       // a tile's scores, then its p
  uint32_t pa[BN / 16][4];               // p as T A fragments

  // the scores of the tile at k0 (log2 domain, -inf where not visible);
  // kTest: a partial tile's per-pair tests, kTerms: a bias or ALiBi term
  auto scores = [&](auto test, auto with_terms, int k0, const Meta& m, const uint8_t* bt) {
    constexpr bool kTest = decltype(test)::value;
    constexpr bool kTerms = decltype(with_terms)::value;
#pragma unroll
    for (int e = 0; e < BN / 2; e += 2) {
      const bool hi = e & 2;
      const int row = hi ? row1 : row0;
      const int c = 8 * (e >> 2) + 2 * tq;  // the pair's first key, in the tile
      float2 bias = make_float2(0.f, 0.f);
      if constexpr (kMasked && kTerms) {
        if (has_bias) bias = bias_pair(bt, row - row_base, c, bias_bf16);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int key = k0 + c + u;
        bool vis = true;
        if constexpr (kTest) {
          vis = key < S && row < S && (!p.causal || key + koff <= row + qoff);
          if constexpr (kMasked) vis = vis && (!has_seg || m.seg[c + u] == (hi ? seg1 : seg0));
        }
        float t;
        if constexpr (kTerms && kMasked) {
          t = masked_score(s[e + u], scale_log2, has_bias, u ? bias.y : bias.x, alibi,
                           slope_log2, row + qoff, key + koff);
        } else if constexpr (kTerms) {
          t = alibi_score(s[e + u], scale_log2, slope_log2, row + qoff, key + koff);
        } else {
          t = __fmul_rn(s[e + u], scale_log2);
        }
        s[e + u] = vis ? t : -INFINITY;
      }
    }
  };
  // the online softmax of one tile's scores: the running max and its
  // correction (c0, c1) for the rows' output and sum, p = 2^(s - max) in s
  auto softmax = [&](float& c0, float& c1) {
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mt0 = fmaxf(mt0, fmaxf(s[4 * j], s[4 * j + 1]));
      mt1 = fmaxf(mt1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float mn0 = fmaxf(m0, mt0);
    const float mn1 = fmaxf(m1, mt1);
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;  // rows with nothing visible yet
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    c0 = fast_exp2(m0 - ms0);
    c1 = fast_exp2(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[4 * j] = fast_exp2(s[4 * j] - ms0);
      s[4 * j + 1] = fast_exp2(s[4 * j + 1] - ms0);
      s[4 * j + 2] = fast_exp2(s[4 * j + 2] - ms1);
      s[4 * j + 3] = fast_exp2(s[4 * j + 3] - ms1);
      ps0 += s[4 * j] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
  };
  // scores and softmax of the tile in stage st
  auto epilogue = [&](const Meta& m, int st, float& c0, float& c1) {
    const uint8_t* bt = sm + L::kBiasAt + st * L::kBias;
    with_flags<kMasked>(m.cls[wg] == kFull, terms, false,
                        [&](auto test, auto with_terms, auto) {
                          scores(test, with_terms, m.tile * BN, m, bt);
                        });
    softmax(c0, c1);
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };

  // The two consumers take turns to issue their products (named barriers 1
  // and 2), so one's softmax runs while the other's products do.
  if (wg == 1) named_arrive(1, 2 * 128);
  if (n_tiles > 0) mbar_wait(qbar, 0);
  Ring<NST> ring;
  mbar_wait(full(ring.stage), ring.phase);
  if (meta[ring.stage].tile >= 0) {
    // the first tile: its scores alone
    float c0, c1;
    named_sync(1 + wg, 2 * 128);
    wgmma_fence();
    ss_product<HD, BN, T>(s, s_q, kRows, 64 * wg, s_kv + ring.stage * 2 * L::kKV);
    wgmma_commit();
    named_arrive(2 - wg, 2 * 128);
    wgmma_wait<0>();
    fence_regs(s);
    epilogue(meta[ring.stage], ring.stage, c0, c1);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<T>(pa[kk], s, kk);
    int held = ring.stage;  // the stage whose V the fragments pa multiply
    ring.next();
    for (;;) {
      mbar_wait(full(ring.stage), ring.phase);
      const Meta& m = meta[ring.stage];
      if (m.tile < 0) break;
      named_sync(1 + wg, 2 * 128);
      wgmma_fence();
      ss_product<HD, BN, T>(s, s_q, kRows, 64 * wg, s_kv + ring.stage * 2 * L::kKV);  // S = Q K^T
      wgmma_commit();
      rs_product<HD, BN, T>(o, pa, s_kv + held * 2 * L::kKV + L::kKV);  // O += P V, last tile
      wgmma_commit();
      named_arrive(2 - wg, 2 * 128);
      wgmma_wait<1>();  // the scores; the last tile's P V runs on
      fence_regs(s);
      epilogue(m, ring.stage, c0, c1);
      wgmma_wait<0>();
      fence_regs(o);
      release(held);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<T>(pa[kk], s, kk);
      held = ring.stage;
      ring.next();
    }
    wgmma_fence();
    rs_product<HD, BN, T>(o, pa, s_kv + held * 2 * L::kKV + L::kKV);  // the last tile's P V
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    release(held);
  }
  if (wg == 0) named_sync(1, 2 * 128);  // the other's last turn

  // the four threads of a group hold disjoint columns of the same rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;  // a row with nothing visible: out 0
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  T* ob = p.out + b * p.os.sb + h * p.os.sh;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    if (row0 < S) {
      *reinterpret_cast<uint32_t*>(ob + row0 * p.os.ss + c) =
          pack2<T>(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
    if (row1 < S) {
      *reinterpret_cast<uint32_t*>(ob + row1 * p.os.ss + c) =
          pack2<T>(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
  if (tq == 0) {
    const long long lrow = ((long long)b * p.H + h) * S;
    if (row0 < S) p.lse[lrow + row0] = l0 == 0.f ? kNegInf : (m0 + log2f(l0)) * kLn2;
    if (row1 < S) p.lse[lrow + row1] = l1 == 0.f ? kNegInf : (m1 + log2f(l1)) * kLn2;
  }
}

// The maps of q (kRows-row boxes), k and v (ring-tile boxes) and of a dense
// bias, then the launch.
template <int HD, bool kAlibi, bool kMasked, typename T>
cudaError_t launch_fwd(FwdParams<T>& prm, const void* q, const void* k, const void* v, int B,
                       int S, const long long* st, cudaStream_t s) {
  using L = FwdSmem<HD, kMasked>;
  const Strides qs = at(st, 0), ks = at(st, 1), vs = at(st, 2);
  const Mask& m = prm.mask;
  constexpr CUtensorMapDataType ty = tma_type<T>();
  if (!encode_rows_map(&prm.q, q, B, S, prm.H, HD, qs.sb, qs.ss, qs.sh, kRows, ty) ||
      !encode_rows_map(&prm.k, k, B, S, prm.KV, HD, ks.sb, ks.ss, ks.sh, L::kBN, ty) ||
      !encode_rows_map(&prm.v, v, B, S, prm.KV, HD, vs.sb, vs.ss, vs.sh, L::kBN, ty) ||
      (kMasked && m.bias != nullptr &&
       !encode_bias_map(&prm.bias, m.bias, m.bias_bf16 != 0, B, S, prm.H, m.bias_sb,
                        m.bias_sh, m.bias_sq, kRows)))
    return cudaErrorInvalidValue;
  const dim3 grid(prm.H, B, (S + kRows - 1) / kRows);
  return launch(flash_fwd_kernel<HD, kAlibi, kMasked, T>, prm, grid,
                L::bytes((S + L::kBN - 1) / L::kBN), s);
}

// The form's instantiation: bf16 has all three; fp16 the Llama form only
// (its ALiBi and masked forms, the offsets among them, are not instantiated,
// and the wrapper refuses them before the launch).
template <int HD, typename T>
cudaError_t launch_form(FwdParams<T>& prm, const void* q, const void* k, const void* v,
                        int B, int S, const long long* st, cudaStream_t s) {
  if constexpr (std::is_same<T, __half>::value) {
    if (needs_masked(prm.mask) || prm.slopes != nullptr || prm.mask.qoff != 0 ||
        prm.mask.koff != 0)
      return cudaErrorInvalidValue;
  } else {
    if (needs_masked(prm.mask)) return launch_fwd<HD, false, true>(prm, q, k, v, B, S, st, s);
    if (prm.slopes != nullptr) return launch_fwd<HD, true, false>(prm, q, k, v, B, S, st, s);
  }
  return launch_fwd<HD, false, false>(prm, q, k, v, B, S, st, s);
}

// The body of the C entries dst_flash_attention_fwd (T = bf16) and
// dst_flash_attention_fwd_f16 (T = __half). q: [B, S, H, hd], k/v:
// [B, S, KV, hd], out: [B, S, H, hd], each by its (batch, seq, head) strides with a contiguous last dim; q, k, v are read by
// TMA (16-byte aligned start and strides). lse: [B, H, S] fp32 contiguous.
// slopes: fp32 [H] ALiBi slopes on the device, or nullptr for none. scale:
// softmax scale applied to q . k (1 / sqrt(hd) for the model). mask: nullptr,
// or long long[14] naming the masked form's segment ids, bias (read by TMA:
// 16-byte aligned start and query-row, head and batch strides), compaction
// tables, the keys' segment ids and the position offsets
// (flash_attention.cuh:parse_mask; the table is per query layout row, its
// block a multiple of 128 tokens).
template <typename T>
int fwd_entry(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int S, int H, int KV, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || !table_ok(mask) || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams<T> prm;
  prm.out = static_cast<T*>(out);
  prm.lse = static_cast<float*>(lse);
  prm.S = S;
  prm.H = H;
  prm.KV = KV;
  prm.os = at(st, 3);
  prm.slopes = static_cast<const float*>(slopes);
  prm.scale_log2 = scale * kLog2e;
  prm.causal = causal;
  prm.mask = mask != nullptr ? parse_mask(mask) : Mask{};
  const cudaError_t r = hd == 128 ? launch_form<128, T>(prm, q, k, v, B, S, st, s)
                                  : launch_form<64, T>(prm, q, k, v, B, S, st, s);
  return static_cast<int>(r);
}

}  // namespace
