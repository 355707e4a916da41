// Flash attention backward (bf16 or fp16, causal or not, GQA) for Hopper: wgmma
// tensor-core products, a TMA-fed ring of tiles and per-tile mask
// classification; one kernel for dq, one for dk/dv, as the TPU package
// splits them.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:_bwd_dq_kernel
// (line 455) and :_bwd_dkv_kernel (line 517), driven by _flash_bwd (line 719),
// in all their forms: causal, grouped-query heads, ALiBi slopes, segment ids,
// a dense additive bias (with the dq kernel's dbias output, emit_dbias), a
// block-sparse layout and the position offsets of ring attention's hops
// (has_offsets; deepspeed_tpu/ops/pallas/ring_flash.py:_rf_bwd, line 120). A
// hop's backward reads the ring's final lse, and its dq kernel is given the
// final output, so the delta it computes is the ring's (the given delta= of
// _flash_bwd, flash_attention.py:719).
//
// With s = q . k * scale + bias - slope[h] * |q - k| (each term only where
// given), p = exp(s - lse) (the forward's saved lse; p = 0 where the key is
// masked: causal, segment, layout; under offsets the global positions q + qoff
// and k + koff enter the causal test and the ALiBi distance, and the keys'
// segment ids are the visiting chunk's), dp = do . v and delta = rowsum(do * o):
//   dst = p * (dp - delta),  ds = dst * scale
//   dq = sum_k ds K,  dk = sum_q ds^T Q,  dv = sum_q p^T dO,  dbias = dst
// dk and dv of a kv head sum over the query heads of its group.
//
// Bound on the H100: operations at training lengths. The dq kernel does 6 * D
// flops per visible (query, key) pair (q.k, do.v and ds.K), the dk/dv kernel
// 8 * D (k.q, v.do, p^T dO, ds^T Q), over 989 TFLOP/s of bf16 tensor-core
// rate, which only wgmma reaches. Design (flash_attention_sm90.cuh and
// flash_attention_tiles.cuh have the building blocks, which the forward
// kernel shares):
//   Blocks of three warpgroups: two consumers, each owning 64 rows (dq: query
//   rows; dk/dv: keys) and all their fp32 accumulators in registers, and a
//   producer whose first warp walks the block's tiles and keeps a ring of
//   kStages shared-memory stages filled by TMA (full and empty mbarriers);
//   the producer gives its registers to the consumers (setmaxnreg: 40 and
//   232, which the 168 a thread of the launch balance exactly). The block's
//   own rows (dq: Q and dO; dk/dv: K and V) arrive once, by TMA; a tile's
//   small rows (its segment ids; dk/dv: its lse and delta) by cp.async,
//   counted on the same full barrier, so the producer never waits on a load.
//   Every tile sits in shared memory once, as TMA writes it with the 128-byte
//   swizzle, and is read through two descriptors: K-major for the score
//   products and MN-major (the transpose bit) for the products that reduce
//   over its rows. A ring tile is 128 rows for the unmasked form at head dim
//   64 and 64 otherwise (register room; DqSmem, DkvSmem).
//   dq: one block per (128 query rows, head, batch row). Per key tile:
//     S = Q K^T and dP = dO V^T (wgmma, A and B from shared memory), p while
//     dP is still in the tensor cores, then dst, rounded to T A fragments
//     in place (the accumulator layout is the A operand's), and dQ += dst K
//     with K read MN-major, left running while the next tile's score
//     products are issued (its stage is released once it is done); dQ takes
//     the softmax scale once, at the end. It also computes delta for its
//     rows from do and o and writes it [B, H, S] for the dk/dv kernel
//     (launched after it on the same stream). With a dbias output (a full
//     [B, H, S, S] bias) it writes dst for every pair of its rows: the
//     producer then sends every key tile through the ring, and a tile it
//     skips carries no load and gets zeros, as _zero_dbias does
//     (flash_attention.py:505-510).
//   dk/dv: one block per (128 keys, kv head, batch row). Per query tile of
//     each query head of the group: S^T = K Q^T and dP^T = V dO^T, then P^T
//     as T fragments and dV += P^T dO while dst^T (from those fragments)
//     is computed, then dK += dst^T Q, with Q and dO read MN-major. The group
//     sum and the sum over tiles stay in fp32 registers; each output is
//     written once, with no atomics, so the result does not depend on the
//     schedule.
//   The two consumers take turns to issue their score products (named
//   barriers), so that one's exponentials run while the other's products
//   do.
//   Tile classes: the producer judges each tile against each consumer's 64
//   rows before it loads it: empty (above the causal diagonal under qoff and
//   koff, past S, or segment-id ranges that do not meet), full (every pair
//   visible: below the diagonal, inside S, one segment id on both sides) or
//   partial. The ranges of every tile are reduced once a block by the
//   consumers before the walk. An empty tile is never loaded; a full one
//   takes the epilogue without per-pair tests, which still adds the bias
//   and ALiBi terms where given; only a partial tile tests each pair. With a
//   layout the producer walks only the tiles of the active blocks (the
//   table per query layout row for dq, the transposed one for dk/dv, as
//   flash_attention.py:1200 builds it). A hop wholly in the future walks
//   nothing: its dq, dk, dv are exactly zero. Position offsets alone (a
//   ring hop) run the unmasked instantiation, which reads them too.
//   Causal grids launch their longest blocks first (dq: the last query
//   blocks; dk/dv: the first key blocks) so the short ones fill the tail.
//   Each score is recomputed by the function the forward kernel used
//   (masked_score in flash_attention.cuh: the dense bias, then ALiBi), so p
//   is the p whose sum went into the saved lse.
// Tensors are read through their (batch, seq, head) strides by 4-D tensor
// maps, so the model layout [B, S, H, D] needs no transpose; TMA fills rows
// past S with zeros. Head dims 64 and 128 (two 64-column panels).
//
// This header holds the two kernels, templated on their element type T
// (bf16 or fp16: __nv_bfloat16 or __half), and their C entries' bodies
// (dq_entry<T>, dkv_entry<T>); the translation units flash_attention_bwd.cu
// (bf16: every form) and flash_attention_bwd_f16.cu (fp16: the Llama form)
// instantiate them, each compiled by its own nvcc. Its helpers sit in an
// anonymous namespace: each unit has its own copy.
#pragma once

#include "flash_attention_tiles.cuh"

using namespace dst::flash;
using namespace dst::sm90;

namespace {

constexpr int kStages = 3;  // ring stages

// dbias at off and off + 1; one 8-byte (fp32) or 4-byte (bf16) store when
// `aligned` (off even).
__device__ __forceinline__ void store_dbias_pair(const Mask& m, long long off, float x,
                                                 float y, bool aligned) {
  if (!aligned) {
    store_dbias(m, off, x);
    store_dbias(m, off + 1, y);
  } else if (m.bias_bf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(m.dbias) + off) =
        __floats2bfloat162_rn(x, y);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(m.dbias) + off) = make_float2(x, y);
  }
}

// Write an m64nHD accumulator as T rows row0 and row1 (inside S).
template <int HD, typename T>
__device__ __forceinline__ void store_acc(T* base, long long ss, const float (&d)[HD / 2],
                                          int row0, int row1, int S, int tq) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * tq;
    if (row0 < S) {
      *reinterpret_cast<uint32_t*>(base + row0 * ss + c) = pack2<T>(d[4 * j], d[4 * j + 1]);
    }
    if (row1 < S) {
      *reinterpret_cast<uint32_t*>(base + row1 * ss + c) = pack2<T>(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq (+ delta, + dbias)
// ---------------------------------------------------------------------------
template <typename T>
struct DqParams {
  CUtensorMap q, k, v, dout;  // boxes: kRows rows of q and dout, DqSmem::kBN of k, v
  const T* o;
  const T* dout_ptr;
  const float* lse;
  float* delta;
  T* dq;
  int S, H, KV;
  Strides os, dos, dqs;
  const float* slopes;
  float scale;
  int causal;
  Mask mask;
};

template <int BN>
struct DqMeta {     // what the producer tells the consumers of a stage
  int tile;         // key tile index; -1 ends the walk
  int cls[kGroups]; // its class for each consumer's rows
  int seg[BN];      // the tile's key segment ids (cp.async; 0 past S)
};

// Shared memory: Q, dO; the ring's K, V; its metadata; the barriers; then the
// segment-id ranges of each consumer's rows, the block's delta rows and the
// ranges of the key tiles.
// Keys a ring tile: 128 for the unmasked form at head dim 64 (score tiles of
// 64 x 128); 64 at head dim 128, where the dQ accumulator takes twice the
// registers, and for the masked form, whose epilogues spill at 128.
template <int HD, bool kMasked>
struct DqSmem {
  static constexpr int kBN = HD == 64 && !kMasked ? 128 : 64;
  static constexpr int kQ = kRows * HD * 2;     // Q (and dO) of the block
  static constexpr int kKV = kBN * HD * 2;      // K (and V) of a stage
  static constexpr int kMeta = 2 * kQ + kStages * 2 * kKV;
  static constexpr int kBars =
      (kMeta + kStages * static_cast<int>(sizeof(DqMeta<kBN>)) + 7) & ~7;
  static constexpr int kRanges = kBars + (2 * kStages + 2) * 8;
  static int bytes(int n_tiles) {
    return kRanges + 8 * (kGroups + n_tiles) + 4 * kRows + 1024;
  }
};

template <int HD, bool kMasked, typename T>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ DqParams<T> p) {
  using L = DqSmem<HD, kMasked>;
  constexpr int BN = L::kBN;
  using Meta = DqMeta<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t s_q = smem_addr(sm), s_do = s_q + L::kQ, s_kv = s_q + 2 * L::kQ;
  Meta* meta = reinterpret_cast<Meta*>(sm + L::kMeta);
  const uint32_t bars = s_q + L::kBars;  // full[kStages], empty[kStages], qbar, rbar
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  const uint32_t qbar = bars + 16 * kStages;
  const uint32_t rbar = qbar + 8;
  int2* own_seg = reinterpret_cast<int2*>(sm + L::kRanges);  // [kGroups]
  float* row_delta = reinterpret_cast<float*>(own_seg + kGroups);  // [kRows]
  int2* tile_seg = reinterpret_cast<int2*>(row_delta + kRows);     // [key tiles]

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
  const bool emit_dbias = kMasked && mask.dbias != nullptr;
  const int qoff = mask.qoff;  // ring hops' global positions (0 without a mask)
  const int koff = mask.koff;
  const int* seg_b = has_seg ? mask.seg + (long long)b * S : nullptr;
  const int* segk_b =
      has_seg ? (mask.seg_k != nullptr ? mask.seg_k : mask.seg) + (long long)b * S : nullptr;
  const int n_all = (S + BN - 1) / BN;
  // the key tiles the causal walk reaches; with a dbias output every tile, the
  // skipped ones carrying zeros
  const int n_tiles =
      emit_dbias || !p.causal
          ? n_all
          : causal_key_tiles<BN>(row_base + kRows - 1, qoff, koff, n_all);

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
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
    if (lane == 0 && n_tiles > 0) {  // a hop wholly in the future loads nothing
      mbar_arrive_expect_tx(qbar, 2 * tile_bytes<HD, kRows>());
      tma_rows<HD, kRows>(s_q, &p.q, qbar, row_base, h, b);
      tma_rows<HD, kRows>(s_do, &p.dout, qbar, row_base, h, b);
    }
    if (has_seg) mbar_wait(rbar, 0);
    Ring<kStages> ring;
    auto visit = [&](int t) {
      const int k0 = t * BN;
      const int2 kseg = has_seg ? tile_seg[t] : make_int2(0, 0);
      int cls[kGroups];
      bool any = false;
#pragma unroll
      for (int w = 0; w < kGroups; ++w) {
        const int r0 = row_base + 64 * w;
        cls[w] = tile_class(r0, r0 + 63, k0, k0 + BN - 1, S, p.causal, qoff, koff,
                            has_seg, has_seg ? own_seg[w] : kseg, kseg);
        any |= cls[w] != kEmpty;
      }
      if (!any && !emit_dbias) return;
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
        if (any) {
          const uint32_t sk = s_kv + ring.stage * 2 * L::kKV;
          mbar_arrive_expect_tx(fb, 2 * tile_bytes<HD, BN>());
          tma_rows<HD, BN>(sk, &p.k, fb, k0, kvh, b);
          tma_rows<HD, BN>(sk + L::kKV, &p.v, fb, k0, kvh, b);
        } else {
          mbar_arrive(fb);
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
  const int row0 = r_lo + 16 * wi + g;
  const int row1 = row0 + 8;
  if (has_seg) {
    tile_ranges<BN>(segk_b, 0, n_tiles, seg_b, wi == 0 ? r_lo : -1, own_seg + wg, tile_seg,
                    S, tid / 32, lane, rbar);
  }

  // delta = rowsum(do * o): two threads a row, each a half row in 16-byte
  // loads, summed by the pair and handed to the accumulator layout's threads
  // through shared memory (named barrier 3 + wg: this warpgroup)
  const T* ob = p.o + b * p.os.sb + h * p.os.sh;
  const T* dob = p.dout_ptr + b * p.dos.sb + h * p.dos.sh;
  const long long lrow = ((long long)b * p.H + h) * S;
  {
    const int it = tid & 127;
    const int drow = r_lo + it / 2;
    const int c0 = (it & 1) * (HD / 2);
    float sum = 0.f;
    if (drow < S) {
      const uint4* d4 = reinterpret_cast<const uint4*>(dob + drow * p.dos.ss + c0);
      const uint4* o4 = reinterpret_cast<const uint4*>(ob + drow * p.os.ss + c0);
#pragma unroll
      for (int i = 0; i < HD / 16; ++i) {
        const uint4 dv = d4[i], ov = o4[i];
        const uint32_t du[4] = {dv.x, dv.y, dv.z, dv.w}, ou[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float2 d2 = unpack2<T>(du[w]), o2 = unpack2<T>(ou[w]);
          sum += d2.x * o2.x + d2.y * o2.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((it & 1) == 0) {
      row_delta[64 * wg + it / 2] = sum;
      if (drow < S) p.delta[lrow + drow] = sum;
    }
    named_sync(3 + wg, 128);
  }
  const float dl0 = row_delta[row0 - row_base];
  const float dl1 = row_delta[row1 - row_base];
  // lse in the log2 domain; a row past S gets p = 0
  const float lse0 = row0 < S ? p.lse[lrow + row0] * kLog2e : INFINITY;
  const float lse1 = row1 < S ? p.lse[lrow + row1] * kLog2e : INFINITY;
  const float scale_log2 = p.scale * kLog2e;
  const bool alibi = p.slopes != nullptr;
  const float slope_log2 = alibi ? p.slopes[h] * kLog2e : 0.f;
  const int seg0 = has_seg && row0 < S ? seg_b[row0] : 0;
  const int seg1 = has_seg && row1 < S ? seg_b[row1] : 0;
  const long long bias_bh = has_bias ? b * mask.bias_sb + h * mask.bias_sh : 0;
  const long long dbias_bh = lrow * S;  // the full [B, H, S, S] output

  float acc[HD / 2];  // sum of dst K; times the scale at the end
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  // p (in s) of one tile from the scores s; kTest: a partial tile's per-pair
  // tests, kTerms: a bias or ALiBi term in the score
  auto pass_p = [&](auto test, auto terms, auto& s, int k0, const int* kseg) {
    constexpr bool kTest = decltype(test)::value;
    constexpr bool kTerms = decltype(terms)::value;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const bool hi = e & 2;
      const int row = hi ? row1 : row0;
      const int key = k0 + 8 * (e >> 2) + 2 * tq + (e & 1);
      bool vis = true;
      if constexpr (kTest) {
        vis = key < S && row < S && (!p.causal || key + koff <= row + qoff) &&
              (!has_seg || kseg[key - k0] == (hi ? seg1 : seg0));
      }
      float pr = 0.f;
      if (vis) {
        float t;
        if constexpr (kTerms) {
          const float bias =
              has_bias ? load_bias(mask, bias_bh + row * mask.bias_sq + key) : 0.f;
          t = masked_score(s[e], scale_log2, has_bias, bias, alibi, slope_log2, row + qoff,
                           key + koff);
        } else {
          t = s[e] * scale_log2;
        }
        pr = fast_exp2(t - (hi ? lse1 : lse0));
      }
      s[e] = pr;
    }
  };
  // dst (in s) from p (in s) and dp; kEmit: dst into dbias (kTest: pairs inside
  // S), two adjacent keys a store where the row length S keeps them aligned
  auto pass_ds = [&](auto test, auto emit, auto& s, const auto& dp, int k0) {
    constexpr bool kTest = decltype(test)::value;
    constexpr bool kEmit = decltype(emit)::value;
#pragma unroll
    for (int e = 0; e < BN / 2; e += 2) {
      const bool hi = e & 2;
      const float dl = hi ? dl1 : dl0;
      s[e] = s[e] * (dp[e] - dl);
      s[e + 1] = s[e + 1] * (dp[e + 1] - dl);
      if constexpr (kEmit) {
        const int row = hi ? row1 : row0;
        const int key = k0 + 8 * (e >> 2) + 2 * tq;
        const long long off = dbias_bh + (long long)row * S + key;
        if (!kTest || (row < S && key + 1 < S)) {
          store_dbias_pair(mask, off, s[e], s[e + 1], S % 2 == 0);
        } else if (row < S && key < S) {
          store_dbias(mask, off, s[e]);
        }
      }
    }
  };

  // The two consumers take turns to issue their score products (named
  // barriers 1 and 2), so one's epilogue runs while the other's products do.
  if (wg == 1) named_arrive(1, 2 * 128);
  if (n_tiles > 0) mbar_wait(qbar, 0);
  Ring<kStages> ring;
  // A tile's last product (dQ += dS K) runs on while the next tile's score
  // products are issued; its stage is released once it is done.
  int held = -1;
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };
  for (;;) {
    mbar_wait(full(ring.stage), ring.phase);
    const Meta& m = meta[ring.stage];
    const int t = m.tile;
    if (t < 0) break;
    const int cls = m.cls[wg];
    const int k0 = t * BN;
    const uint32_t a_k = s_kv + ring.stage * 2 * L::kKV;
    const uint32_t a_v = a_k + L::kKV;
    named_sync(1 + wg, 2 * 128);
    if (cls != kEmpty) {
      float s[BN / 2], dp[BN / 2];
      wgmma_fence();
      ss_product<HD, BN, T>(s, s_q, kRows, 64 * wg, a_k);    // S = Q K^T
      wgmma_commit();
      ss_product<HD, BN, T>(dp, s_do, kRows, 64 * wg, a_v);  // dP = dO V^T
      wgmma_commit();
      named_arrive(2 - wg, 2 * 128);
      wgmma_wait<2>();  // the last tile's dQ product
      if (held >= 0) release(held);
      // p while dP is still in the tensor cores, then dst
      wgmma_wait<1>();
      fence_regs(s);
      with_flags<kMasked>(cls == kFull, has_bias || alibi, emit_dbias,
                          [&](auto test, auto terms, auto) {
                            pass_p(test, terms, s, k0, m.seg);
                          });
      wgmma_wait<0>();
      fence_regs(dp);
      with_flags<kMasked>(cls == kFull, has_bias || alibi, emit_dbias,
                          [&](auto test, auto, auto emit) { pass_ds(test, emit, s, dp, k0); });
      uint32_t a[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a<T>(a[kk], s, kk);
      wgmma_fence();
      rs_product<HD, BN, T>(acc, a, a_k);  // dQ += dS K, K read MN-major
      wgmma_commit();
      held = ring.stage;
    } else {
      named_arrive(2 - wg, 2 * 128);
      wgmma_wait<0>();
      if (held >= 0) release(held);
      held = -1;
      // a tile no pair of these rows sees: dst = 0
      for (int i = tid & 127; emit_dbias && i < 64 * BN; i += 128) {
        const int r = r_lo + i / BN;
        const int key = k0 + i % BN;
        if (r < S && key < S) store_dbias(mask, dbias_bh + (long long)r * S + key, 0.f);
      }
      release(ring.stage);
    }
    ring.next();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (wg == 0) named_sync(1, 2 * 128);  // the other's last turn
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] *= p.scale;
  store_acc<HD, T>(p.dq + b * p.dqs.sb + h * p.dqs.sh, p.dqs.ss, acc, row0, row1, S, tq);
}

// ---------------------------------------------------------------------------
// dk, dv (summed over the GQA group)
// ---------------------------------------------------------------------------
template <typename T>
struct DkvParams {
  CUtensorMap q, k, v, dout;  // boxes: DkvSmem::kBQ rows of q and dout, kRows of k, v
  const float* lse;
  const float* delta;
  T* dk;
  T* dv;
  int S, H, KV;
  Strides dks, dvs;
  const float* slopes;
  float scale;
  int causal;
  Mask mask;
};

template <int BQ>
struct DkvMeta {
  int head;             // the query head of the tile
  int tile;             // query tile index; -1 ends the walk
  int cls[kGroups];
  float lse[BQ];        // the tile's lse and delta rows (cp.async; 0 past S)
  float delta[BQ];
  int seg[BQ];          // the tile's query segment ids
};

// Queries a ring tile: 128 for the unmasked form at head dim 64 (score tiles
// of 64 x 128, ds taken from the rounded p so that the score and gradient
// accumulators fit the registers), else 64, as in dq.
template <int HD, bool kMasked>
struct DkvSmem {
  static constexpr int kBQ = HD == 64 && !kMasked ? 128 : 64;
  static constexpr int kKV = kRows * HD * 2;    // K (and V) of the block
  static constexpr int kQ = kBQ * HD * 2;       // Q (and dO) of a stage
  static constexpr int kMeta = 2 * kKV + kStages * 2 * kQ;
  static constexpr int kBars =
      (kMeta + kStages * static_cast<int>(sizeof(DkvMeta<kBQ>)) + 7) & ~7;
  static constexpr int kRanges = kBars + (2 * kStages + 2) * 8;
  static int bytes(int n_tiles) { return kRanges + 8 * (kGroups + n_tiles) + 1024; }
};

template <int HD, bool kMasked, typename T>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ DkvParams<T> p) {
  using L = DkvSmem<HD, kMasked>;
  constexpr int BQ = L::kBQ;
  using Meta = DkvMeta<BQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  const uint32_t s_k = smem_addr(sm), s_v = s_k + L::kKV, s_qd = s_k + 2 * L::kKV;
  Meta* meta = reinterpret_cast<Meta*>(sm + L::kMeta);
  const uint32_t bars = s_k + L::kBars;  // full[kStages], empty[kStages], kvbar, rbar
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  const uint32_t kvbar = bars + 16 * kStages;
  const uint32_t rbar = kvbar + 8;
  int2* own_seg = reinterpret_cast<int2*>(sm + L::kRanges);  // [kGroups]
  int2* tile_seg = own_seg + kGroups;                         // [query tiles]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int kblock = blockIdx.z;  // causal: the first key blocks are the longest
  const int group = p.H / p.KV;
  const int S = p.S;
  const int key_base = kblock * kRows;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid & 31;
  const Mask& mask = p.mask;
  const bool has_seg = kMasked && mask.seg != nullptr;
  const bool has_bias = kMasked && mask.bias != nullptr;
  const int qoff = mask.qoff;
  const int koff = mask.koff;
  const int* seg_b = has_seg ? mask.seg + (long long)b * S : nullptr;
  const int* segk_b =
      has_seg ? (mask.seg_k != nullptr ? mask.seg_k : mask.seg) + (long long)b * S : nullptr;
  const int n_all = (S + BQ - 1) / BQ;
  // first query tile that sees any key of this block
  const int t0 = p.causal ? causal_first_query_tile<BQ>(key_base, qoff, koff) : 0;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 33);  // 32 producer lanes' copies + lane 0's arrival
      mbar_init(empty(st), 4 * kGroups);
    }
    mbar_init(kvbar, 1);
    mbar_init(rbar, 4 * kGroups);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kGroups) {
    // ---------------- producer ----------------
    regs_dec<kProducerRegs>();
    if (tid / 32 != 4 * kGroups) return;
    if (lane == 0 && t0 < n_all) {  // keys no query sees (a future hop) load nothing
      mbar_arrive_expect_tx(kvbar, 2 * tile_bytes<HD, kRows>());
      tma_rows<HD, kRows>(s_k, &p.k, kvbar, key_base, kvh, b);
      tma_rows<HD, kRows>(s_v, &p.v, kvbar, key_base, kvh, b);
    }
    if (has_seg) mbar_wait(rbar, 0);
    Ring<kStages> ring;
    for (int j = 0; j < group; ++j) {
      const int h = kvh * group + j;
      const long long lrow = ((long long)b * p.H + h) * S;
      auto visit = [&](int t) {
        const int q0 = t * BQ;
        const int2 qseg = has_seg ? tile_seg[t] : make_int2(0, 0);
        int cls[kGroups];
        bool any = false;
#pragma unroll
        for (int w = 0; w < kGroups; ++w) {
          const int c0 = key_base + 64 * w;
          cls[w] = tile_class(q0, q0 + BQ - 1, c0, c0 + 63, S, p.causal, qoff, koff,
                              has_seg, qseg, has_seg ? own_seg[w] : qseg);
          any |= cls[w] != kEmpty;
        }
        if (!any) return;
        const uint32_t fb = full(ring.stage);
        mbar_wait(empty(ring.stage), ring.phase ^ 1u);
        Meta& m = meta[ring.stage];
        for (int i = lane; i < BQ; i += 32) {
          const bool in = q0 + i < S;
          const long long r = lrow + (in ? q0 + i : 0);
          cp_async_4(smem_addr(m.lse + i), p.lse + r, in);
          cp_async_4(smem_addr(m.delta + i), p.delta + r, in);
          if (has_seg) cp_async_4(smem_addr(m.seg + i), seg_b + (in ? q0 + i : 0), in);
        }
        if (lane == 0) {
          m.head = h;
          m.tile = t;
#pragma unroll
          for (int w = 0; w < kGroups; ++w) m.cls[w] = cls[w];
          const uint32_t sq = s_qd + ring.stage * 2 * L::kQ;
          mbar_arrive_expect_tx(fb, 2 * tile_bytes<HD, BQ>());
          tma_rows<HD, BQ>(sq, &p.q, fb, q0, h, b);
          tma_rows<HD, BQ>(sq + L::kQ, &p.dout, fb, q0, h, b);
        }
        cp_async_arrive(fb);
        ring.next();
      };
      if (kMasked && mask.cols != nullptr) {
        for_tiles<BQ>(mask, key_base / mask.blk, t0, n_all, visit);
      } else {
        for (int t = t0; t < n_all; ++t) visit(t);
      }
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
  const int key_lo = key_base + 64 * wg;
  const int key0 = key_lo + 16 * wi + g;  // this thread's key rows
  const int key1 = key0 + 8;
  if (has_seg) {
    tile_ranges<BQ>(seg_b, t0, n_all, segk_b, wi == 0 ? key_lo : -1, own_seg + wg,
                       tile_seg, S, tid / 32, lane, rbar);
  }
  const float scale_log2 = p.scale * kLog2e;
  const bool alibi = p.slopes != nullptr;
  const int segk0 = has_seg && key0 < S ? segk_b[key0] : 0;
  const int segk1 = has_seg && key1 < S ? segk_b[key1] : 0;

  float dka[HD / 2], dva[HD / 2];  // dka: sum of dst^T Q, times the scale at the end
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

  // p^T (in st) of one tile from the scores st; kTest: a partial tile's
  // per-pair tests, kTerms: a bias or ALiBi term in the score
  auto pass_p = [&](auto test, auto terms, auto& st, int q0, int h, const Meta& m) {
    constexpr bool kTest = decltype(test)::value;
    constexpr bool kTerms = decltype(terms)::value;
    const float slope_log2 = alibi ? p.slopes[h] * kLog2e : 0.f;
    const long long bias_bh = has_bias ? b * mask.bias_sb + h * mask.bias_sh : 0;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = 8 * j + 2 * tq;
      float2 l2 = *reinterpret_cast<const float2*>(m.lse + c);
      l2 = make_float2(l2.x * kLog2e, l2.y * kLog2e);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int e = 4 * j + e4;
        const bool hi = e4 & 2;
        const int col = c + (e4 & 1);
        const int query = q0 + col;
        const int key = hi ? key1 : key0;
        bool vis = true;
        if constexpr (kTest) {
          vis = query < S && key < S && (!p.causal || key + koff <= query + qoff) &&
                (!has_seg || m.seg[col] == (hi ? segk1 : segk0));
        }
        float pr = 0.f;
        if (vis) {
          float t;
          if constexpr (kTerms) {
            const float bias =
                has_bias ? load_bias(mask, bias_bh + query * mask.bias_sq + key) : 0.f;
            t = masked_score(st[e], scale_log2, has_bias, bias, alibi, slope_log2,
                             query + qoff, key + koff);
          } else {
            t = st[e] * scale_log2;
          }
          pr = fast_exp2(t - ((e4 & 1) ? l2.y : l2.x));
        }
        st[e] = pr;
      }
    }
  };
  // dst^T (in dpt) from p^T (its T fragments pa) and dp^T
  auto pass_ds = [&](const auto& pa, auto& dpt, const Meta& m) {
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(m.delta + 8 * j + 2 * tq);
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows key0, key1
        const float2 p2 = unpack2<T>(pa[j / 2][2 * (j & 1) + half]);
        const int e = 4 * j + 2 * half;
        dpt[e] = p2.x * (dpt[e] - d2.x);
        dpt[e + 1] = p2.y * (dpt[e + 1] - d2.y);
      }
    }
  };

  // the consumers take turns to issue their score products, as in dq
  if (wg == 1) named_arrive(1, 2 * 128);
  if (t0 < n_all) mbar_wait(kvbar, 0);
  Ring<kStages> ring;
  for (;;) {
    mbar_wait(full(ring.stage), ring.phase);
    const Meta& m = meta[ring.stage];
    const int t = m.tile;
    if (t < 0) break;
    const int cls = m.cls[wg];
    const uint32_t a_q = s_qd + ring.stage * 2 * L::kQ;
    const uint32_t a_do = a_q + L::kQ;
    named_sync(1 + wg, 2 * 128);
    if (cls != kEmpty) {
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
      ss_product<HD, BQ, T>(st, s_k, kRows, 64 * wg, a_q);    // S^T = K Q^T
      wgmma_commit();
      ss_product<HD, BQ, T>(dpt, s_v, kRows, 64 * wg, a_do);  // dP^T = V dO^T
      wgmma_commit();
      named_arrive(2 - wg, 2 * 128);
      // p^T while dP^T is still in the tensor cores; dV += P^T dO while dst^T
      // is computed; then dK += dst^T Q
      wgmma_wait<1>();
      fence_regs(st);
      with_flags<false>(cls == kFull, has_bias || alibi, false,
                        [&](auto test, auto terms, auto) {
                          pass_p(test, terms, st, t * BQ, m.head, m);
                        });
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a<T>(pa[kk], st, kk);
      wgmma_fence();
      rs_product<HD, BQ, T>(dva, pa, a_do);  // dV += P^T dO, dO read MN-major
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dpt);
      pass_ds(pa, dpt, m);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a<T>(da[kk], dpt, kk);
      wgmma_fence();
      rs_product<HD, BQ, T>(dka, da, a_q);   // dK += dS^T Q, Q read MN-major
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
    } else {
      named_arrive(2 - wg, 2 * 128);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(ring.stage));
    ring.next();
  }
  if (wg == 0) named_sync(1, 2 * 128);  // the other's last turn
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] *= p.scale;
  store_acc<HD, T>(p.dk + b * p.dks.sb + kvh * p.dks.sh, p.dks.ss, dka, key0, key1, S, tq);
  store_acc<HD, T>(p.dv + b * p.dvs.sb + kvh * p.dvs.sh, p.dvs.ss, dva, key0, key1, S, tq);
}

// The dq kernel's K and V maps (boxes of its ring tile), then the launch.
template <int HD, bool kMasked, typename T>
cudaError_t launch_dq(DqParams<T>& prm, const void* k, const void* v, int B, int S, int KV,
                      const long long* st, cudaStream_t s) {
  using L = DqSmem<HD, kMasked>;
  const Strides ks = at(st, 1), vs = at(st, 2);
  constexpr CUtensorMapDataType ty = tma_type<T>();
  if (!encode_rows_map(&prm.k, k, B, S, KV, HD, ks.sb, ks.ss, ks.sh, L::kBN, ty) ||
      !encode_rows_map(&prm.v, v, B, S, KV, HD, vs.sb, vs.ss, vs.sh, L::kBN, ty))
    return cudaErrorInvalidValue;
  const dim3 grid(prm.H, B, (S + kRows - 1) / kRows);
  return launch(flash_bwd_dq_kernel<HD, kMasked, T>, prm, grid,
                L::bytes((S + L::kBN - 1) / L::kBN), s);
}

// The dk/dv kernel's Q and dO maps (boxes of its ring tile), then the launch.
template <int HD, bool kMasked, typename T>
cudaError_t launch_dkv(DkvParams<T>& prm, const void* q, const void* dout, int B, int S,
                       const long long* st, cudaStream_t s) {
  using L = DkvSmem<HD, kMasked>;
  const Strides qs = at(st, 0), dos = at(st, 3);
  constexpr CUtensorMapDataType ty = tma_type<T>();
  if (!encode_rows_map(&prm.q, q, B, S, prm.H, HD, qs.sb, qs.ss, qs.sh, L::kBQ, ty) ||
      !encode_rows_map(&prm.dout, dout, B, S, prm.H, HD, dos.sb, dos.ss, dos.sh, L::kBQ, ty))
    return cudaErrorInvalidValue;
  const dim3 grid(prm.KV, B, (S + kRows - 1) / kRows);
  return launch(flash_bwd_dkv_kernel<HD, kMasked, T>, prm, grid,
                L::bytes((S + L::kBQ - 1) / L::kBQ), s);
}

// The instantiation of a form: bf16 has the unmasked and masked ones; fp16
// the unmasked (Llama) one only, without slopes or offsets (the wrapper
// refuses the rest before the launch).
template <typename T>
bool form_ok(const void* slopes, const Mask& m) {
  return !std::is_same<T, __half>::value ||
         (slopes == nullptr && !needs_masked(m) && m.qoff == 0 && m.koff == 0);
}

// The body of the C entries dst_flash_attention_bwd_dq (T = bf16) and
// dst_flash_attention_bwd_dq_f16 (T = __half).
// q, o, do, dq: [B, S, H, hd]; k, v: [B, S, KV, hd], each by its (batch, seq,
// head) strides (st: 3 per tensor in the order q, k, v, o, do, dq) with a
// contiguous last dim; q, k, v, do are read by TMA (16-byte aligned start and
// strides). lse (in), delta (out): [B, H, S] fp32 contiguous. slopes: fp32 [H]
// ALiBi slopes on the device (those the forward took), or nullptr for none.
// mask: nullptr, or the forward's masked form (flash_attention.cuh:parse_mask,
// the table per query layout row), whose dbias slot may name a [B, H, S, S]
// output in the bias's dtype.
template <typename T>
int dq_entry(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, int B, int S, int H, int KV, int hd,
    const long long* st, const void* slopes, float scale, int causal,
    const long long* mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || !table_ok(mask) || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  DqParams<T> prm;
  const Strides qs = at(st, 0), dos = at(st, 4);
  constexpr CUtensorMapDataType ty = tma_type<T>();
  if (!encode_rows_map(&prm.q, q, B, S, H, hd, qs.sb, qs.ss, qs.sh, kRows, ty) ||
      !encode_rows_map(&prm.dout, dout, B, S, H, hd, dos.sb, dos.ss, dos.sh, kRows, ty))
    return static_cast<int>(cudaErrorInvalidValue);
  prm.o = static_cast<const T*>(o);
  prm.dout_ptr = static_cast<const T*>(dout);
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<float*>(delta);
  prm.dq = static_cast<T*>(dq);
  prm.S = S;
  prm.H = H;
  prm.KV = KV;
  prm.os = at(st, 3);
  prm.dos = dos;
  prm.dqs = at(st, 5);
  prm.slopes = static_cast<const float*>(slopes);
  prm.scale = scale;
  prm.causal = causal;
  prm.mask = mask != nullptr ? parse_mask(mask) : Mask{};
  if (!form_ok<T>(slopes, prm.mask)) return static_cast<int>(cudaErrorInvalidValue);
  [[maybe_unused]] const bool masked = needs_masked(prm.mask);
  cudaError_t r;
  if constexpr (std::is_same<T, __half>::value) {
    r = hd == 128 ? launch_dq<128, false>(prm, k, v, B, S, KV, st, s)
                  : launch_dq<64, false>(prm, k, v, B, S, KV, st, s);
  } else if (hd == 128) {
    r = masked ? launch_dq<128, true>(prm, k, v, B, S, KV, st, s)
               : launch_dq<128, false>(prm, k, v, B, S, KV, st, s);
  } else {
    r = masked ? launch_dq<64, true>(prm, k, v, B, S, KV, st, s)
               : launch_dq<64, false>(prm, k, v, B, S, KV, st, s);
  }
  return static_cast<int>(r);
}

// The body of dst_flash_attention_bwd_dkv(_f16). q, do: [B, S, H, hd]; k, v, dk, dv: [B, S, KV, hd], by strides (st: q, k, v,
// do, dk, dv; q, k, v, do read by TMA); lse, delta: [B, H, S] fp32 contiguous
// (delta from the dq kernel); slopes as for the dq kernel; mask as for the dq
// kernel but with the transposed table (per key layout column, its active
// query blocks) and no dbias.
template <typename T>
int dkv_entry(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S, int H,
    int KV, int hd, const long long* st, const void* slopes, float scale,
    int causal, const long long* mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || !table_ok(mask) || (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  DkvParams<T> prm;
  const Strides ks = at(st, 1), vs = at(st, 2);
  constexpr CUtensorMapDataType ty = tma_type<T>();
  if (!encode_rows_map(&prm.k, k, B, S, KV, hd, ks.sb, ks.ss, ks.sh, kRows, ty) ||
      !encode_rows_map(&prm.v, v, B, S, KV, hd, vs.sb, vs.ss, vs.sh, kRows, ty))
    return static_cast<int>(cudaErrorInvalidValue);
  prm.lse = static_cast<const float*>(lse);
  prm.delta = static_cast<const float*>(delta);
  prm.dk = static_cast<T*>(dk);
  prm.dv = static_cast<T*>(dv);
  prm.S = S;
  prm.H = H;
  prm.KV = KV;
  prm.dks = at(st, 4);
  prm.dvs = at(st, 5);
  prm.slopes = static_cast<const float*>(slopes);
  prm.scale = scale;
  prm.causal = causal;
  prm.mask = mask != nullptr ? parse_mask(mask) : Mask{};
  if (!form_ok<T>(slopes, prm.mask)) return static_cast<int>(cudaErrorInvalidValue);
  [[maybe_unused]] const bool masked = needs_masked(prm.mask);
  cudaError_t r;
  if constexpr (std::is_same<T, __half>::value) {
    r = hd == 128 ? launch_dkv<128, false>(prm, q, dout, B, S, st, s)
                  : launch_dkv<64, false>(prm, q, dout, B, S, st, s);
  } else if (hd == 128) {
    r = masked ? launch_dkv<128, true>(prm, q, dout, B, S, st, s)
               : launch_dkv<128, false>(prm, q, dout, B, S, st, s);
  } else {
    r = masked ? launch_dkv<64, true>(prm, q, dout, B, S, st, s)
               : launch_dkv<64, false>(prm, q, dout, B, S, st, s);
  }
  return static_cast<int>(r);
}

}  // namespace
