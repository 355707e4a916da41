// Hopper (sm_90a) building blocks of the flash attention forward, backward
// and bias-gradient kernels (flash_attention_fwd.cu, flash_attention_bwd.cu,
// flash_attention_bias_grad.cu): mbarriers, TMA tile loads through tensor
// maps, wgmma shared-memory descriptors and products, and the host-side
// encoding of the tensor maps. The decode kernel (decode_attention.cu) takes
// the mma.sync helpers of flash_attention.cuh and the cp.async and exp2
// helpers here.
//
// Tiles live in shared memory as TMA writes them with the 128-byte swizzle:
// a [rows, 64] panel of bf16 (128 bytes a row), 16-byte chunk c of row r at
// r * 128 + ((c ^ (r % 8)) * 16), each panel 1024-byte aligned; a head dim of
// 128 is two panels, columns 0..63 and 64..127. wgmma reads a panel through
// one of two descriptors:
//   K-major (the head dim is the product's reduction): 8-row groups 1024
//     bytes apart (SBO); a k-step of 16 columns moves the start 32 bytes
//     inside the 128-byte row, the next panel after four k-steps;
//   MN-major (the rows are the reduction, the head dim the output columns,
//     the instruction's transpose bit set): 8-row groups of the reduction
//     1024 bytes apart (SBO), the next 64 output columns one panel further
//     (LBO = the panel's bytes); a k-step of 16 rows moves the start 2048
//     bytes.
// An m64nN fp32 accumulator gives thread (warp w of its warpgroup, lane l)
// rows 16 w + l / 4 and that + 8, columns 8 j + 2 (l % 4) and that + 1 of each
// n8 block j: d[4 j + 0..3] = (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1),
// which is the register layout of a wgmma A operand, so a score tile rounds
// to bf16 fragments for the next product without leaving registers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing is linked)

#include <type_traits>

#include "common.cuh"

namespace dst {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A ring of NST stages: (stage, phase) of the next use, advanced in step by
// the producer and every consumer.
template <int NST>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == NST) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------
// Copy the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into shared
// memory at dst; completion is counted in bytes on the barrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Rows [row0, row0 + ROWS) of head h, batch row b of a [B, S, H, HD] tensor
// (its map's box: 64 columns x ROWS rows) into HD / 64 panels at dst; rows
// past S arrive as zeros. The barrier counts tile_bytes<HD, ROWS>().
template <int HD, int ROWS>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row0, int h, int b) {
#pragma unroll
  for (int p = 0; p < HD / 64; ++p) {
    tma_load_4d(dst + p * ROWS * 128, map, bar, p * 64, row0, h, b);
  }
}

template <int HD, int ROWS>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return HD * ROWS * 2;
}

// Copy 4 bytes from device memory to shared memory asynchronously; zeros when
// !valid (src is then not read).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Arrive on the barrier once this thread's cp.async copies have landed (the
// arrival is one of those the barrier was initialised to expect).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// Named barriers between the consumer warpgroups (id 0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x on the special-function unit, denormals flushed to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// A shared-memory matrix descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// K-major operand: k-step ks (16 columns of the head dim) of the 64 rows
// starting at row0 of a tile of `rows` rows in panels at base.
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int row0, int ks) {
  return sw128_desc(base + (ks >> 2) * rows * 128 + row0 * 128 + (ks & 3) * 32, 16, 1024);
}

// MN-major operand: k-step ks (rows 16 ks..16 ks + 15) of a tile of `rows`
// rows in panels at base, all of its head dim as the output columns.
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int rows, int ks) {
  return sw128_desc(base + ks * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across a
// wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The products below take T = __nv_bfloat16 (bf16 operands, the default) or
// __half (fp16): one instruction string each, .f32.bf16.bf16 or .f32.f16.f16.

// d (64 x 64, fp32) = scale_d * d + A (64 x 16) . B (16 x 64), both in
// shared memory, K-major.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
#define DST_WGMMA(TY) \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                                       \
      : "l"(da), "l"(db), "r"(scale_d));
  if constexpr (std::is_same<T, __half>::value) {
    DST_WGMMA("f16")
  } else {
    DST_WGMMA("bf16")
  }
#undef DST_WGMMA
}

// d (64 x 32, fp32) = scale_d * d + A (64 x 16) . B (16 x 32), both in
// shared memory, K-major.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                              int scale_d) {
#define DST_WGMMA(TY) \
  asm volatile(                                                                   \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"      \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                        \
      : "l"(da), "l"(db), "r"(scale_d));
  if constexpr (std::is_same<T, __half>::value) {
    DST_WGMMA("f16")
  } else {
    DST_WGMMA("bf16")
  }
#undef DST_WGMMA
}

// d (64 x 128, fp32) = scale_d * d + A (64 x 16) . B (16 x 128), both in
// shared memory, K-major.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
#define DST_WGMMA(TY) \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),         \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),       \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),   \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),   \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),   \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                              \
      : "l"(da), "l"(db), "r"(scale_d));
  if constexpr (std::is_same<T, __half>::value) {
    DST_WGMMA("f16")
  } else {
    DST_WGMMA("bf16")
  }
#undef DST_WGMMA
}

// d (64 x 64, fp32) = scale_d * d + A (64 x 16: bf16 register fragments,
// the accumulator's layout) . B (16 x 64, shared memory, MN-major: the
// transpose bit set).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
#define DST_WGMMA(TY) \
  asm volatile(                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),      \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),  \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  if constexpr (std::is_same<T, __half>::value) {
    DST_WGMMA("f16")
  } else {
    DST_WGMMA("bf16")
  }
#undef DST_WGMMA
}

// d (64 x 128, fp32) = scale_d * d + A (64 x 16: bf16 register fragments,
// the accumulator's layout) . B (16 x 128, shared memory, MN-major: the
// transpose bit set).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
#define DST_WGMMA(TY) \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),         \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),       \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),   \
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),   \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),   \
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),   \
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  if constexpr (std::is_same<T, __half>::value) {
    DST_WGMMA("f16")
  } else {
    DST_WGMMA("bf16")
  }
#undef DST_WGMMA
}


// Hand a warpgroup's registers back (the producer) or take them (consumers).
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's entry-point
// lookup, so the library links nothing beyond the runtime.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t st = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t st =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return st == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor-map element type of T: bf16, or fp16 (__half).
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The map of a bf16 (or, by `type`, fp16) [B, S, H, D] tensor read by its
// element strides (batch,
// seq, head; the last dim contiguous): dims (D, S, H, B), byte strides
// (2 ss, 2 sh, 2 sb), box 64 columns x rows x 1 x 1, 128-byte swizzle, zeros
// past every edge. The wrapper's tma_map (ops/cuda/flash_attention.py)
// computes and checks the same numbers. False where the driver refuses.
inline bool encode_rows_map(CUtensorMap* map, const void* base, int B, int S, int H,
                            int D, long long sb, long long ss, long long sh, int rows,
                            CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * ss),
                                 static_cast<cuuint64_t>(2 * sh),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a dense additive bias [B|1, H|1, S, S] (fp32 or bf16, the key
// dim contiguous) by its element strides (sq: query rows; sh, sb: 0 on a
// broadcast dim): dims (S, S, H or 1, B or 1), byte strides of the query
// rows, heads and batch rows (a broadcast dim of size 1 gets the next
// inner one's span), box 128 bytes of keys (32 fp32 or 64 bf16) x rows
// query rows x 1 x 1, 128-byte swizzle, zeros past S. The wrapper's
// bias_tma_map (ops/cuda/flash_attention.py) computes and checks the same
// numbers. False where the driver refuses.
inline bool encode_bias_map(CUtensorMap* map, const void* base, bool bf16, int B, int S,
                            int H, long long sb, long long sh, long long sq, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t esize = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(sh != 0 ? H : 1),
                              static_cast<cuuint64_t>(sb != 0 ? B : 1)};
  const cuuint64_t st_q = esize * sq;
  const cuuint64_t st_h = sh != 0 ? esize * sh : st_q * S;
  const cuuint64_t st_b = sb != 0 ? esize * sb : st_h * dims[2];
  const cuuint64_t strides[3] = {st_q, st_h, st_b};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace dst
