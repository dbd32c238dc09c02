// A CPU emulation of the CUDA features the port's kernels use, so that
// their sources (ddl25spring_tpu_torch/ops/csrc) compile with a host C++
// compiler and run here: every CTA runs its threads as std::threads, and
// the warp-wide operations (ldmatrix, mma.sync m16n8k16 bf16 and m16n8k8
// tf32, shuffles) meet at per-warp barriers and compute their results from
// the PTX ISA's fragment layouts. cp.async copies at once (the kernels' waits and barriers then
// order nothing extra). Bulk copies and mbarriers (bulk_copy.cuh): a bulk
// load lands at once and counts its bytes in on its barrier; a bulk store
// waits in its group and is copied when a wait_group lets its source be
// overwritten, as late as the card may read it, so a stage reused before
// its store was waited for shows as wrong results, and a store never waited
// for aborts at the thread's exit. Shared-memory accesses are checked
// against the launch's dynamic size and the alignment ldmatrix, cp.async,
// bulk copies and mbarriers need; build with -fsanitize=address to check
// device-memory accesses too. tests/test_torch_cuda_emulation.py prepares
// the sources (the headers' inline-PTX helpers are replaced by the ones
// below, launches become emu_launch calls) and runs emu_main.cpp's cases;
// tests/test_torch_adam_emulation.py runs emu_adam.cpp's.
#pragma once
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <cmath>
#include <cassert>
#include <cstdio>
#include <cstdlib>
#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>
#include <functional>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <map>
#include <mutex>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
#define __align__(n)
#define __grid_constant__
struct dim3 { unsigned x, y, z; dim3(unsigned a=1, unsigned b=1, unsigned c=1):x(a),y(b),z(c){} };
thread_local dim3 threadIdx;
dim3 blockIdx, gridDim, blockDim;
typedef int cudaError_t; enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
int g_smem_limit = 0;
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int n) { g_smem_limit = n; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
// What the emulated card reports: its SMs and the blocks of any kernel that
// fit on one (the persistent grids are their product).
int g_emu_sms = 1, g_emu_blocks_per_sm = 1;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = g_emu_sms; return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = g_emu_blocks_per_sm; return 0;
}
// Correctly rounded fp32 arithmetic (build with -ffp-contract=off).
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = (uint32_t)b.x << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
using std::min; using std::max;
struct float4 {float x,y,z,w;}; inline float4 make_float4(float a,float b,float c,float d){return {a,b,c,d};}
inline float4 __ldcs(const float4* p) { return *p; }
inline void __stcs(float4* p, float4 v) { *p = v; }
struct float2 {float x, y;};
struct uint4 { unsigned x,y,z,w; };

namespace {
alignas(16) unsigned char smem_raw[232448 + 64];
alignas(16) float smem[232448 / 4];
}
int g_smem_bytes = 0;                   // dynamic smem of the current launch
thread_local int t_lane, t_warp, t_phase;
// A warp operation's exchange: each lane writes its operands, meets the
// others at one barrier, and reads theirs. Successive operations alternate
// between two exchanges, so a lane writing operation n + 2's operands has
// passed operation n + 1's barrier, which every lane reaches only after it
// has read operation n's: one barrier per operation suffices.
struct WarpX { uint32_t addr[32]; uint32_t a[32][4]; uint32_t b[32][2]; float c[32][4]; float sh[32]; };
WarpX g_wx[2][8];
inline WarpX& warp_exchange() { WarpX& w = g_wx[t_phase][t_warp]; t_phase ^= 1; return w; }
std::vector<std::barrier<>*> g_wbar;
std::barrier<>* g_bbar;
inline void wsync() { g_wbar[t_warp]->arrive_and_wait(); }
inline void __syncthreads() { g_bbar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  auto& W = warp_exchange(); W.sh[t_lane] = v; wsync(); return W.sh[t_lane ^ off];
}
inline size_t __cvta_generic_to_shared(const void* p) {
  const unsigned char* c = (const unsigned char*)p;
  if (c < smem_raw || c >= smem_raw + sizeof(smem_raw)) { fprintf(stderr, "cvta: not shared\n"); abort(); }
  return c - smem_raw;
}
inline void check_smem(uint32_t addr, int n) {
  if ((int)addr + n > g_smem_bytes) { fprintf(stderr, "smem OOB addr %u + %d > %d\n", addr, n, g_smem_bytes); abort(); }
}
inline void ldsm_impl(uint32_t (&r)[4], uint32_t addr, bool trans) {
  if (addr % 16) { fprintf(stderr, "ldmatrix misaligned %u\n", addr); abort(); }
  check_smem(addr, 16);
  auto& W = warp_exchange(); W.addr[t_lane] = addr; wsync();
  const int g = t_lane >> 2, t = t_lane & 3;
  for (int i = 0; i < 4; ++i) {
    if (!trans) {
      const uint16_t* row = (const uint16_t*)(smem_raw + W.addr[8 * i + g]);
      r[i] = row[2 * t] | ((uint32_t)row[2 * t + 1] << 16);
    } else {
      const uint16_t* r0 = (const uint16_t*)(smem_raw + W.addr[8 * i + 2 * t]);
      const uint16_t* r1 = (const uint16_t*)(smem_raw + W.addr[8 * i + 2 * t + 1]);
      r[i] = r0[g] | ((uint32_t)r1[g] << 16);
    }
  }
  wsync();
}
inline void ldsm_x4(uint32_t (&r)[4], uint32_t addr) { ldsm_impl(r, addr, false); }
inline void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) { ldsm_impl(r, addr, true); }
inline float bf_lo(uint32_t u) { uint32_t x = u << 16; float f; memcpy(&f, &x, 4); return f; }
inline float bf_hi(uint32_t u) { uint32_t x = u & 0xffff0000u; float f; memcpy(&f, &x, 4); return f; }
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& W = warp_exchange();
  for (int i = 0; i < 4; ++i) { W.a[t_lane][i] = a[i]; W.c[t_lane][i] = d[i]; }
  W.b[t_lane][0] = b0; W.b[t_lane][1] = b1; wsync();
  float A[16][16], B[16][8];
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, t = L & 3;
    A[g][2*t] = bf_lo(W.a[L][0]); A[g][2*t+1] = bf_hi(W.a[L][0]);
    A[g+8][2*t] = bf_lo(W.a[L][1]); A[g+8][2*t+1] = bf_hi(W.a[L][1]);
    A[g][2*t+8] = bf_lo(W.a[L][2]); A[g][2*t+9] = bf_hi(W.a[L][2]);
    A[g+8][2*t+8] = bf_lo(W.a[L][3]); A[g+8][2*t+9] = bf_hi(W.a[L][3]);
    B[2*t][g] = bf_lo(W.b[L][0]); B[2*t+1][g] = bf_hi(W.b[L][0]);
    B[2*t+8][g] = bf_lo(W.b[L][1]); B[2*t+9][g] = bf_hi(W.b[L][1]);
  }
  const int g = t_lane >> 2, t = t_lane & 3;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = W.c[t_lane][e];
    for (int k = 0; k < 16; ++k) acc += A[row][k] * B[k][col];
    out[e] = acc;
  }
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
// mma.sync m16n8k8 .tf32 (mma_tf32.cuh): each operand's low 13 bits are
// ignored, as on the card; the accumulator and the 8 products (exact) are
// summed and the sum truncated toward zero to fp32, as the card's tensor
// cores truncate theirs.
inline float tf32_of(uint32_t u) { u &= 0xffffe000u; float f; memcpy(&f, &u, 4); return f; }
inline float round_to_zero(double s) {
  float f = static_cast<float>(s);
  if (std::fabs(static_cast<double>(f)) > std::fabs(s)) f = std::nextafter(f, 0.f);
  return f;
}
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& W = warp_exchange();
  for (int i = 0; i < 4; ++i) { W.a[t_lane][i] = a[i]; W.c[t_lane][i] = d[i]; }
  W.b[t_lane][0] = b0; W.b[t_lane][1] = b1; wsync();
  float A[16][8], B[8][8];
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, t = L & 3;
    A[g][t] = tf32_of(W.a[L][0]); A[g + 8][t] = tf32_of(W.a[L][1]);
    A[g][t + 4] = tf32_of(W.a[L][2]); A[g + 8][t + 4] = tf32_of(W.a[L][3]);
    B[t][g] = tf32_of(W.b[L][0]); B[t + 4][g] = tf32_of(W.b[L][1]);
  }
  const int g = t_lane >> 2, t = t_lane & 3;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double acc = W.c[t_lane][e];
    for (int k = 0; k < 8; ++k) acc += static_cast<double>(A[row][k]) * B[k][col];
    out[e] = round_to_zero(acc);
  }
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}
inline float fast_exp2(float x) {   // ex2.approx.ftz.f32
  const float y = std::exp2(x);
  return std::fpclassify(y) == FP_SUBNORMAL ? 0.f : y;
}
inline void cp_async_16(uint32_t dst, const void* src, int bytes) {
  if (dst % 16 || ((uintptr_t)src) % 16) { fprintf(stderr, "cp.async16 misaligned dst %u src %p\n", dst, src); abort(); }
  if (bytes < 0 || bytes > 16) abort();
  check_smem(dst, 16);
  memset(smem_raw + dst, 0, 16); if (bytes) memcpy(smem_raw + dst, src, bytes);
}
inline void cp_async_4(uint32_t dst, const void* src, int bytes) {
  if (dst % 4 || ((uintptr_t)src) % 4) abort();
  check_smem(dst, 4);
  memset(smem_raw + dst, 0, 4); if (bytes) memcpy(smem_raw + dst, src, bytes);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}


// ---- bulk copies and mbarriers (bulk_copy.cuh) ----
struct EmuMbar { int count, pending; long long tx; unsigned phase; };
std::mutex g_mb_mu;
std::condition_variable g_mb_cv;
std::map<uint32_t, EmuMbar> g_mb;      // by shared address
struct EmuStore { void* dst; uint32_t src; uint32_t bytes; };
thread_local std::vector<EmuStore> t_open_group;
thread_local std::deque<std::vector<EmuStore>> t_groups;
inline uint64_t evict_first_policy() { return 0; }
inline EmuMbar& mbar_at(uint32_t bar) {   // with g_mb_mu held
  auto it = g_mb.find(bar);
  if (it == g_mb.end()) { fprintf(stderr, "mbarrier %u used before init\n", bar); abort(); }
  return it->second;
}
inline void mbar_settle(EmuMbar& b) {     // with g_mb_mu held
  if (b.pending < 0 || b.tx < 0) { fprintf(stderr, "mbarrier over-arrived: pending %d tx %lld\n", b.pending, b.tx); abort(); }
  if (b.pending == 0 && b.tx == 0) { b.phase ^= 1u; b.pending = b.count; g_mb_cv.notify_all(); }
}
inline void mbar_init(uint32_t bar, uint32_t count) {
  if (bar % 8) { fprintf(stderr, "mbarrier misaligned %u\n", bar); abort(); }
  check_smem(bar, 8);
  std::lock_guard<std::mutex> lk(g_mb_mu);
  g_mb[bar] = {static_cast<int>(count), static_cast<int>(count), 0, 0};
}
inline void mbar_init_fence() {}
inline void mbar_arrive(uint32_t bar) {
  std::lock_guard<std::mutex> lk(g_mb_mu);
  EmuMbar& b = mbar_at(bar); --b.pending; mbar_settle(b);
}
inline void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> lk(g_mb_mu);
  EmuMbar& b = mbar_at(bar); b.tx += bytes; --b.pending; mbar_settle(b);
}
inline void mbar_wait(uint32_t bar, uint32_t parity) {
  std::unique_lock<std::mutex> lk(g_mb_mu);
  if (!g_mb_cv.wait_for(lk, std::chrono::seconds(60), [&] { return mbar_at(bar).phase != parity; })) {
    fprintf(stderr, "mbarrier %u: wait for parity %u timed out\n", bar, parity); abort();
  }
}
inline void bulk_check(uint32_t shared, const void* global, uint32_t bytes) {
  if (shared % 16 || reinterpret_cast<uintptr_t>(global) % 16 || bytes % 16 || bytes == 0) {
    fprintf(stderr, "bulk copy misaligned: shared %u global %p bytes %u\n", shared, global, bytes); abort();
  }
  check_smem(shared, bytes);
}
inline void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar, uint64_t) {
  bulk_check(dst, src, bytes);
  memcpy(smem_raw + dst, src, bytes);
  std::lock_guard<std::mutex> lk(g_mb_mu);
  EmuMbar& b = mbar_at(bar); b.tx -= bytes; mbar_settle(b);
}
inline void bulk_store(void* dst, uint32_t src, uint32_t bytes, uint64_t) {
  bulk_check(src, dst, bytes);
  t_open_group.push_back({dst, src, bytes});
}
inline void bulk_commit() { t_groups.push_back(std::move(t_open_group)); t_open_group.clear(); }
inline void bulk_drain(size_t keep) {
  for (; t_groups.size() > keep; t_groups.pop_front())
    for (const EmuStore& s : t_groups.front()) memcpy(s.dst, smem_raw + s.src, s.bytes);
}
template <int N> inline void bulk_wait_read() { bulk_drain(N); }
template <int N> inline void bulk_wait() { bulk_drain(N); }
inline void fence_proxy_async() {}
int g_emu_launches = 0;

template <class F> void emu_launch(dim3 grid, int nt, int smem, F f) {
  g_smem_bytes = smem;
  ++g_emu_launches;
  if (smem > 48 * 1024 && g_smem_limit < smem) { fprintf(stderr, "smem attr not set\n"); abort(); }
  if (smem > 232448) { fprintf(stderr, "smem too large %d\n", smem); abort(); }
  gridDim = grid;
  blockDim = dim3(nt);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx = dim3(bx, by);
      memset(smem_raw, 0xcd, sizeof(smem_raw));   // garbage, as on the card
      g_mb.clear();                               // no barrier outlives its block
      std::barrier<> bb(nt); g_bbar = &bb;
      std::vector<std::barrier<>*> wb; for (int w = 0; w < nt / 32; ++w) wb.push_back(new std::barrier<>(32));
      g_wbar = wb;
      std::vector<std::thread> th;
      for (int i = 0; i < nt; ++i) th.emplace_back([&, i] {
        threadIdx = dim3(i); t_lane = i & 31; t_warp = i >> 5; f();
        if (!t_open_group.empty() || !t_groups.empty()) { fprintf(stderr, "bulk stores not waited for at exit\n"); abort(); }
      });
      for (auto& t : th) t.join();
      for (auto* b : wb) delete b;
    }
}
