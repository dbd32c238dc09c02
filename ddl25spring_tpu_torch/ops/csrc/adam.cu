// Fused Adam apply for Hopper (sm_90a): one launch over a table of flat fp32
// leaves that updates every parameter and both its moments in place.
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
// the result matches the plain PyTorch rule (ops/adam.py adam_math), which
// rounds after every operation, to the bit.
//
// What bounds it on this card: memory. Each element reads p, m, v, g and
// writes p, m, v (28 bytes) for ~12 flops. The TPU kernel runs once per leaf;
// here one launch covers every leaf of a step, so no leaf's tail leaves the
// card idle and the host makes one call:
// - The table of leaves (the p, m, v, g pointers and element count of each)
//   is a __grid_constant__ parameter: nothing is copied to the device.
// - Each leaf is cut into chunks of kChunk elements, its last chunk shorter
//   (every leaf is a multiple of 4 elements, 16 bytes). Chunks are numbered
//   leaf after leaf, and a persistent grid (blocks per SM from the occupancy
//   API, times the SMs) strides over them.
// - Bulk-copy path (kStages > 0): one producer thread moves each chunk's p, m,
//   v and g into a ring of kStages shared-memory stages with 1-D bulk copies
//   (cp.async.bulk: the copy engine, no registers or load instructions), and
//   arms the stage's "full" mbarrier with the bytes it expects. 256 consumer
//   threads wait on it, run the rule on one float4 of each array from shared
//   memory, write p, m, v back into the stage and arrive on its "done"
//   mbarrier. The producer then stores p, m, v with bulk copies and loads a
//   later chunk into the stage once cp.async.bulk.wait_group.read says the
//   store has read it. Loads and stores carry an L2 evict_first hint: each
//   byte is touched once.
// - Register path (kStages = 0): the same grid and chunks, 256 threads, each
//   loading two float4 of every array with streaming loads (__ldcs) before
//   any arithmetic, and storing with __stcs.
// DDL_ADAM_STAGES picks the path at compile time; DDL_ADAM_PER_LEAF builds a
// grid-stride kernel launched once per leaf instead. ddl25spring_tpu_torch.
// adam_ab builds and times each; the default is the fastest.

#include <cuda_runtime.h>

#include "bulk_copy.cuh"

#ifndef DDL_ADAM_STAGES
#define DDL_ADAM_STAGES 4
#endif

namespace {

constexpr int kMaxLeaves = 48;   // the table fits the 4 KB parameter space
constexpr int kConsumers = 256;  // threads that run the rule
constexpr int kMaxDevices = 64;

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps;
};

struct Table {
  float* p[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  const float* g[kMaxLeaves];
  long long n[kMaxLeaves];
  long long first_chunk[kMaxLeaves + 1];  // chunk numbers of each leaf start here
  int leaves;
};
static_assert(sizeof(Table) + sizeof(Hyper) + sizeof(float*) <= 4096,
              "the kernel's parameters exceed 4 KB");

__device__ __forceinline__ void step(float& p, float& m, float& v, float g, float c1, float c2,
                                     const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float u = __fdiv_rn(__fmul_rn(h.lr, __fdiv_rn(m, c1)),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps));
  p = __fsub_rn(p, u);
}

__device__ __forceinline__ void step4(float4& p, float4& m, float4& v, const float4& g, float c1,
                                      float c2, const Hyper& h) {
  step(p.x, m.x, v.x, g.x, c1, c2, h);
  step(p.y, m.y, v.y, g.y, c1, c2, h);
  step(p.z, m.z, v.z, g.z, c1, c2, h);
  step(p.w, m.w, v.w, g.w, c1, c2, h);
}

// Chunk c of the table: its leaf (`leaf` is a cursor that only moves forward,
// as a block's chunk numbers only grow), first element and element count.
template <int kChunk>
__device__ __forceinline__ void locate(const Table& t, long long c, int& leaf, long long& off,
                                       int& count) {
  while (c >= t.first_chunk[leaf + 1]) ++leaf;
  off = (c - t.first_chunk[leaf]) * kChunk;
  const long long left = t.n[leaf] - off;
  count = static_cast<int>(left < kChunk ? left : kChunk);
}

// ---- bulk-copy path --------------------------------------------------------

constexpr int kBulkChunk = 4 * kConsumers;  // one float4 of each array per consumer

template <int kStages>
struct BulkLayout {
  static constexpr int kArrayBytes = kBulkChunk * 4;
  static constexpr int kStageBytes = 4 * kArrayBytes;   // p, m, v, g
  static constexpr int kBarriers = kStages * kStageBytes;  // full[s], then done[s]
  static constexpr int kSmem = kBarriers + 2 * 8 * kStages;
};

template <int kStages>
__global__ void __launch_bounds__(kConsumers + 32)
bulk_adam_kernel(const __grid_constant__ Table t, const float* __restrict__ corrections,
                 Hyper h) {
  using L = BulkLayout<kStages>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t full = base + L::kBarriers;   // full[s] at full + 8 s
  const uint32_t done = full + 8 * kStages;    // done[s] at done + 8 s
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(done + 8 * s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const long long total = t.first_chunk[t.leaves];
  const long long stride = gridDim.x;

  if (threadIdx.x >= kConsumers) {   // the producer warp: one thread issues every copy
    if (threadIdx.x != kConsumers) return;
    const uint64_t policy = evict_first_policy();
    int load_leaf = 0, store_leaf = 0;
    long long next = blockIdx.x;    // the next chunk to load
    long long off;
    int count;
    auto load = [&](int s) {
      locate<kBulkChunk>(t, next, load_leaf, off, count);
      const uint32_t bytes = 4u * count, stage = base + s * L::kStageBytes;
      mbar_arrive_expect_tx(full + 8 * s, 4 * bytes);
      bulk_load(stage, t.p[load_leaf] + off, bytes, full + 8 * s, policy);
      bulk_load(stage + L::kArrayBytes, t.m[load_leaf] + off, bytes, full + 8 * s, policy);
      bulk_load(stage + 2 * L::kArrayBytes, t.v[load_leaf] + off, bytes, full + 8 * s, policy);
      bulk_load(stage + 3 * L::kArrayBytes, t.g[load_leaf] + off, bytes, full + 8 * s, policy);
      next += stride;
    };
    for (int s = 0; s < kStages && next < total; ++s) load(s);
    int j = 0;
    for (long long c = blockIdx.x; c < total; c += stride, ++j) {
      const int s = j % kStages;
      mbar_wait(done + 8 * s, (j / kStages) & 1);
      locate<kBulkChunk>(t, c, store_leaf, off, count);
      const uint32_t bytes = 4u * count, stage = base + s * L::kStageBytes;
      bulk_store(t.p[store_leaf] + off, stage, bytes, policy);
      bulk_store(t.m[store_leaf] + off, stage + L::kArrayBytes, bytes, policy);
      bulk_store(t.v[store_leaf] + off, stage + 2 * L::kArrayBytes, bytes, policy);
      bulk_commit();
      if (next < total) {   // the stage's next chunk, once the store has read it
        bulk_wait_read<0>();
        load(s);
      }
    }
    bulk_wait<0>();
    return;
  }

  const float c1 = corrections[0];
  const float c2 = corrections[1];
  float4* stages = reinterpret_cast<float4*>(smem_raw);
  constexpr int kF4 = L::kArrayBytes / 16;   // float4s per array in a stage
  int leaf = 0;
  int j = 0;
  for (long long c = blockIdx.x; c < total; c += stride, ++j) {
    const int s = j % kStages;
    long long off;
    int count;
    locate<kBulkChunk>(t, c, leaf, off, count);
    float4* P = stages + s * 4 * kF4;
    mbar_wait(full + 8 * s, (j / kStages) & 1);
    const int i = threadIdx.x;
    if (4 * i < count) {
      float4 pp = P[i], mm = P[kF4 + i], vv = P[2 * kF4 + i];
      const float4 gg = P[3 * kF4 + i];
      step4(pp, mm, vv, gg, c1, c2, h);
      P[i] = pp;
      P[kF4 + i] = mm;
      P[2 * kF4 + i] = vv;
    }
    fence_proxy_async();   // the writes above, before the producer's bulk store
    mbar_arrive(done + 8 * s);
  }
}

#if !defined(DDL_ADAM_PER_LEAF) && DDL_ADAM_STAGES == 0
// ---- register path ----------------------------------------------------------

constexpr int kRegThreads = 256;
constexpr int kRegChunk = 8 * kRegThreads;   // two float4 of each array per thread

__global__ void __launch_bounds__(kRegThreads)
reg_adam_kernel(const __grid_constant__ Table t, const float* __restrict__ corrections,
                Hyper h) {
  const float c1 = corrections[0];
  const float c2 = corrections[1];
  const long long total = t.first_chunk[t.leaves];
  int leaf = 0;
  for (long long c = blockIdx.x; c < total; c += gridDim.x) {
    long long off;
    int count;
    locate<kRegChunk>(t, c, leaf, off, count);
    float4* P = reinterpret_cast<float4*>(t.p[leaf] + off);
    float4* M = reinterpret_cast<float4*>(t.m[leaf] + off);
    float4* V = reinterpret_cast<float4*>(t.v[leaf] + off);
    const float4* G = reinterpret_cast<const float4*>(t.g[leaf] + off);
    const int n4 = count / 4;
    const int i0 = threadIdx.x, i1 = threadIdx.x + kRegThreads;
    float4 p0{}, m0{}, v0{}, g0{}, p1{}, m1{}, v1{}, g1{};
    if (i0 < n4) {
      p0 = __ldcs(P + i0); m0 = __ldcs(M + i0); v0 = __ldcs(V + i0); g0 = __ldcs(G + i0);
    }
    if (i1 < n4) {
      p1 = __ldcs(P + i1); m1 = __ldcs(M + i1); v1 = __ldcs(V + i1); g1 = __ldcs(G + i1);
    }
    if (i0 < n4) {
      step4(p0, m0, v0, g0, c1, c2, h);
      __stcs(P + i0, p0); __stcs(M + i0, m0); __stcs(V + i0, v0);
    }
    if (i1 < n4) {
      step4(p1, m1, v1, g1, c1, c2, h);
      __stcs(P + i1, p1); __stcs(M + i1, m1); __stcs(V + i1, v1);
    }
  }
}

#endif

#if defined(DDL_ADAM_PER_LEAF)
// ---- one launch per leaf (the A/B baseline) --------------------------------

__global__ void __launch_bounds__(256)
leaf_adam_kernel(float4* __restrict__ p, float4* __restrict__ m, float4* __restrict__ v,
                 const float4* __restrict__ g, long long n4,
                 const float* __restrict__ corrections, Hyper h) {
  const float c1 = corrections[0];
  const float c2 = corrections[1];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 pp = p[i], mm = m[i], vv = v[i];
    const float4 gg = g[i];
    step4(pp, mm, vv, gg, c1, c2, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

#endif

#if defined(DDL_ADAM_PER_LEAF)
constexpr int kChunk = 0;   // no chunks: each leaf is one grid
#elif DDL_ADAM_STAGES > 0
constexpr int kChunk = kBulkChunk;
#else
constexpr int kChunk = kRegChunk;
#endif

// Blocks the launch can keep resident on the current device's SMs (cached
// per device; the first call also lifts the kernel's shared-memory limit).
template <class K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int* out) {
  static int cached[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && cached[device]) {
    *out = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  if (device < kMaxDevices) cached[device] = *out;
  return cudaSuccess;
}

cudaError_t launch(const Table& t, const float* corrections, const Hyper& h,
                   cudaStream_t stream) {
#if defined(DDL_ADAM_PER_LEAF)
  int sms = 0, device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < t.leaves; ++i) {
    const long long n4 = t.n[i] / 4;
    const long long want = (n4 + 255) / 256;
    const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
    leaf_adam_kernel<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<float4*>(t.p[i]), reinterpret_cast<float4*>(t.m[i]),
        reinterpret_cast<float4*>(t.v[i]), reinterpret_cast<const float4*>(t.g[i]), n4,
        corrections, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
#else
  const long long total = t.first_chunk[t.leaves];
  int resident = 0;
#if DDL_ADAM_STAGES > 0
  constexpr int kSmem = BulkLayout<DDL_ADAM_STAGES>::kSmem;
  cudaError_t err = resident_blocks(bulk_adam_kernel<DDL_ADAM_STAGES>, kConsumers + 32, kSmem,
                                    &resident);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(total < resident ? total : resident);
  bulk_adam_kernel<DDL_ADAM_STAGES><<<grid, kConsumers + 32, kSmem, stream>>>(t, corrections, h);
#else
  cudaError_t err = resident_blocks(reg_adam_kernel, kRegThreads, 0, &resident);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(total < resident ? total : resident);
  reg_adam_kernel<<<grid, kRegThreads, 0, stream>>>(t, corrections, h);
#endif
  return cudaGetLastError();
#endif
}

}  // namespace

// Plain C entry points (bound with ctypes).
//
// ddl_adam: one fused Adam step over `leaves` leaves. `ptrs` holds 4 device
// pointers per leaf (p, m, v, g: dense fp32, 16-byte aligned; p, m, v updated
// in place), `counts` each leaf's element count (a positive multiple of 4).
// corrections is a device fp32 [2] = {c1, c2}; omb1 = 1 - b1 and omb2 = 1 - b2
// as the caller rounds them to fp32. One launch per ddl_adam_table_size()
// leaves, on `stream`; returns the first failing launch's cudaError_t (0 =
// success) and does not synchronise.
extern "C" int ddl_adam(const long long* ptrs, const long long* counts, int leaves,
                        const float* corrections, float lr, float b1, float omb1, float b2,
                        float omb2, float eps, void* stream) {
  if (leaves < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < leaves; ++i)
    if (counts[i] < 4 || counts[i] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{lr, b1, omb1, b2, omb2, eps};
  for (int first = 0; first < leaves; first += kMaxLeaves) {
    Table t{};
    t.leaves = leaves - first < kMaxLeaves ? leaves - first : kMaxLeaves;
    for (int i = 0; i < t.leaves; ++i) {
      const long long* q = ptrs + 4 * (first + i);
      t.p[i] = reinterpret_cast<float*>(q[0]);
      t.m[i] = reinterpret_cast<float*>(q[1]);
      t.v[i] = reinterpret_cast<float*>(q[2]);
      t.g[i] = reinterpret_cast<const float*>(q[3]);
      t.n[i] = counts[first + i];
      t.first_chunk[i + 1] =
          t.first_chunk[i] + (kChunk ? (t.n[i] + kChunk - 1) / kChunk : 0);
    }
    const cudaError_t err = launch(t, corrections, h, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The most leaves one launch takes.
extern "C" int ddl_adam_table_size() { return kMaxLeaves; }

// Elements per chunk of the built kernel (0: one grid per leaf).
extern "C" int ddl_adam_chunk() { return kChunk; }
