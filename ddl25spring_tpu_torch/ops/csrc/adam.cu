// Fused Adam apply for Hopper (sm_90a): one pass over a flat fp32 leaf that
// updates the parameter and both moments in place.
//
// Replaces the JAX package's Pallas TPU kernel _adam_kernel (via
// _adam_leaf_pallas) in ddl25spring_tpu/ops/pallas_adam.py:
//   m <- b1 m + (1 - b1) g
//   v <- b2 v + (1 - b2) g^2
//   p <- p - lr (m / c1) / (sqrt(v / c2) + eps)
// with the bias corrections c1 = 1 - b1^t and c2 = 1 - b2^t read from a
// device array at run time (the TPU kernel's scalar prefetch), so one build
// serves every step and the host never waits for the step count.
//
// Every operation is written as its correctly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn) in the JAX rule's order: the compiler can
// neither contract a multiply-add into an FMA nor take a fast division, so
// the result matches the plain PyTorch rule (ops/adam.py adam_leaf_math),
// which rounds after every operation, to the bit.
//
// What bounds it on this card: memory. Each element reads p, m, v, g and
// writes p, m, v (28 bytes) for ~12 flops. Design: a grid-stride loop over
// float4s (the wrapper routes only leaves whose size is a multiple of 512,
// with 16-byte-aligned storage), 256 threads a block, at most 8 blocks per SM.

#include <cuda_runtime.h>

namespace {

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void step(float& p, float& m, float& v, float g, float c1, float c2,
                                     const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float u = __fdiv_rn(__fmul_rn(h.lr, __fdiv_rn(m, c1)),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps));
  p = __fsub_rn(p, u);
}

__global__ void __launch_bounds__(256)
adam_kernel(float4* __restrict__ p, float4* __restrict__ m, float4* __restrict__ v,
            const float4* __restrict__ g, long long n4, const float* __restrict__ corrections,
            Hyper h) {
  const float c1 = corrections[0];
  const float c2 = corrections[1];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 pp = p[i], mm = m[i], vv = v[i];
    const float4 gg = g[i];
    step(pp.x, mm.x, vv.x, gg.x, c1, c2, h);
    step(pp.y, mm.y, vv.y, gg.y, c1, c2, h);
    step(pp.z, mm.z, vv.z, gg.z, c1, c2, h);
    step(pp.w, mm.w, vv.w, gg.w, c1, c2, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). p, m, v (updated in place) and g
// are dense fp32 arrays of n elements, n a multiple of 4, each 16-byte
// aligned; corrections is a device fp32 [2] = {c1, c2}; omb1 = 1 - b1 and
// omb2 = 1 - b2 as the caller rounds them to fp32. Launches on `stream` and
// returns the launch's cudaError_t (0 = success); it does not synchronise.
extern "C" int ddl_adam(float* p, float* m, float* v, const float* g, long long n,
                        const float* corrections, float lr, float b1, float omb1, float b2,
                        float omb2, float eps, void* stream) {
  if (n < 4 || n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = n / 4;
  const long long want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  adam_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(p), reinterpret_cast<float4*>(m), reinterpret_cast<float4*>(v),
      reinterpret_cast<const float4*>(g), n4, corrections, Hyper{lr, b1, omb1, b2, omb2, eps});
  return static_cast<int>(cudaGetLastError());
}
