// Fused AdamW update over one flat fp32 leaf, in place:
//   g' = g * clip                (clip read from the device: no host sync)
//   m = b1 m + (1 - b1) g',  v = b2 v + (1 - b2) g'^2
//   u = (m / bc1) / (sqrt(v / bc2) + eps)
//   p = p - lr * (u + wd * p)
//
// Replaces deepspeed_tpu/ops/pallas/fused_adam.py:_adam_kernel (line 29),
// reached through _fused_adam_flat (line 41) from scale_by_fused_adam, which
// runtime/optimizers.build_optimizer chains with add_decayed_weights(wd),
// scale(-1) and the lr schedule. The TPU kernel writes the direction u and
// leaves the decay, lr and parameter write to XLA; here they are folded into
// the same pass (as DeepSpeed's FusedAdam does), so each element moves once:
// p, g, m, v read and p, m, v written, 28 bytes.
//
// Bound on the H100: bytes, 28 * n over 3.35 TB/s; ~15 flops per element.
// Design: a grid-stride loop over 16-byte vectors (4 floats of each of the
// four arrays per step), scalars (lr, bias corrections, decay) passed by
// value from the host's step count, the clip factor by pointer.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct AdamArgs {
  float b1, b2, omb1, omb2, eps, lr, wd, bc1, bc2;  // omb: 1 - b, from the host
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const AdamArgs& a) {
  m = a.b1 * m + a.omb1 * g;
  v = a.b2 * v + a.omb2 * g * g;
  const float u = (m / a.bc1) / (sqrtf(v / a.bc2) + a.eps);
  p = p - a.lr * (u + a.wd * p);
}

__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                      float* __restrict__ m, float* __restrict__ v, long long n,
                      const float* __restrict__ clip, AdamArgs a) {
  const float c = clip != nullptr ? *clip : 1.f;
  const long long nvec = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < nvec; i += stride) {
    float4 pp = p4[i], gg = g4[i], mm = m4[i], vv = v4[i];
    adam_one(pp.x, gg.x * c, mm.x, vv.x, a);
    adam_one(pp.y, gg.y * c, mm.y, vv.y, a);
    adam_one(pp.z, gg.z * c, mm.z, vv.z, a);
    adam_one(pp.w, gg.w * c, mm.w, vv.w, a);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  // the last n % 4 elements
  if (blockIdx.x == 0 && threadIdx.x < n - nvec * 4) {
    const long long i = nvec * 4 + threadIdx.x;
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(pp, g[i] * c, mm, vv, a);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// p, g, m, v: [n] fp32 contiguous, 16-byte aligned; clip: a device fp32
// scalar multiplying g, or null for none. omb1, omb2: 1 - b1, 1 - b2 rounded
// once from the host's double (as the optax chain's Python floats are; 1 - b2
// taken in fp32 from an fp32 b2 = 0.999 is off by 1.3e-5 relative). bc1, bc2:
// the bias corrections 1 - b1^t, 1 - b2^t of this step t.
extern "C" int dst_fused_adam(void* p, const void* g, void* m, void* v,
                              long long n, const void* clip, float lr, float b1,
                              float b2, float omb1, float omb2, float eps, float wd,
                              float bc1, float bc2,
                              int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long nvec = (n + 3) / 4;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count > 0 ? sm_count : 132) * 8;
  if (blocks > cap) blocks = cap;
  AdamArgs a{b1, b2, omb1, omb2, eps, lr, wd, bc1, bc2};
  fused_adam_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(m),
      static_cast<float*>(v), n, static_cast<const float*>(clip), a);
  return static_cast<int>(cudaGetLastError());
}
