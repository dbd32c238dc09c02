// Causal flash-attention forward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the JAX package's Pallas TPU kernels _fwd_kernel (row-major
// [B*H, T, Dh] operands) and _fwd_kernel_t (dh-major [B*H, Dh, T]) in
// ddl25spring_tpu/ops/flash_attention.py: each kernel here serves both
// layouts, because it reads every operand through (batch, head, seq, dim)
// strides.
//
// What they compute, per (batch, head) and query row i:
//   s_j  = (q_i . k_j) / sqrt(Dh)        for keys j <= i (causal) and j < T
//   out_i = sum_j softmax(s)_j v_j       (online softmax: running m, l, acc)
//   lse_i = m + log(l)
// with fp32 scores, softmax statistics and lse, and `out` cast back to the
// input type. Key tiles strictly above the diagonal of a query tile are
// never visited, and no key at or past T gets mass: the ragged edge is
// masked here, so nothing is padded in device memory (Dh = 48 and T = 200
// run as they are). The head dim is a template parameter rounded up to a
// multiple of 16 (<= 128); the padded dims are zero in shared memory only.
//
// bf16: flash_fwd_mma_kernel, on the tensor cores (mma_bf16.cuh). One CTA
// of 4 warps per (batch*head, 64-query tile), the latest (heaviest) query
// tiles launched first. Each warp owns 16 query rows and keeps Q's A
// fragments in registers. K and V tiles of 64 keys are double-buffered in
// shared memory as bf16 with cp.async, so the next tile loads while this
// one is multiplied, and K and V wait in separate copy groups, so V's load
// overlaps S and the softmax. S = Q.K^T is 8 n-tiles x Dh/16 k-steps of mma; the
// online softmax runs on the accumulator rows (each thread holds 2 rows, a
// row's max takes two shuffles within its quad; l stays a per-thread
// partial sum until the end). The scale log2(e)/sqrt(Dh) is applied to the
// fp32 scores, not folded into Q, so Q is not rounded a second time and
// lse keeps fp32 accuracy. P is rounded to bf16 in registers as the A
// operand of O += P.V (FlashAttention-2's one extra rounding point; the
// accumulation stays fp32). The epilogue stages O through shared memory in
// the output's layout and writes 16-byte rows. The layout of q, k and v is
// a template parameter (all row-major, all dh-major, or each read at run
// time for a mixed call), the exponentials run on the SFU (fast_exp2), and
// the registers are capped for 4 CTAs per SM at Dh <= 64: each of these
// bought time on the card (PERF.md, flash_ab).
//
// fp32: flash_fwd_kernel, register-tiled FMA code (no TF32: the fp32 limits
// are 1e-4). One CTA of 256 threads per (batch*head, 64-query tile); Q
// (pre-scaled by log2(e)/sqrt(Dh)), K and V staged in shared memory as
// fp32, Q and K transposed; a 16 x 16 thread grid where each thread owns 4
// query rows x 4 keys of S (then 4 rows x Dh/16 dims of O); P goes through
// shared memory into the P.V product.
//
// What bounds them on this card: at the training shape (B=64, H=6, T=256,
// Dh=48, bf16) the function moves ~38 MB (q, k, v, out, lse) against
// 2.4 GFLOP of tensor-core work, so bytes bound it (11.4 us at 3.35 TB/s).
// The kernel is held back by latency instead: each CTA walks at most 4 key
// tiles, so its first loads and its epilogue are a large share of its time,
// and the double buffer hides later loads only in part. The fp32 FMA kernel
// is bound by the fp32 FMA rate at B=8 (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockQ = 64;                  // query rows per CTA
constexpr int kBlockK = 64;                  // keys per tile
constexpr float kNegInf = -1e30f;            // finite, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- fp32 FMA

constexpr int kTX = 16;                      // threads along keys / dims
constexpr int kTY = kBlockQ / 4;             // threads along rows (4 rows each)
constexpr int kThreads = kTX * kTY;
constexpr int kKPT = kBlockK / kTX;          // keys per thread in S
constexpr int kQPad = kBlockQ + 4;           // Qt / Ps row stride (float4-aligned)
constexpr int kKPad = kBlockK + 1;           // Kt row stride (odd: conflict-free stores)

// Dynamic shared memory per CTA, in floats: Qt, Kt, V and Pt tiles (55.5 KB
// at DP = 48, so the launch raises the 48 KB default where needed).
template <int DP>
constexpr int smem_floats() {
  return DP * kQPad + DP * kKPad + kBlockK * (DP + 1) + kBlockK * kQPad;
}

// Element (t, d) of rows [t0, t0 + n) of one head, read in the operand's own
// contiguous order; f(t, d, x) stores it (zero past seq and dh).
template <int DP, typename F>
__device__ __forceinline__ void for_tile(const float* __restrict__ src, const Strides& s, int t0,
                                         int n, int seq, int dh, F f) {
  const bool dim_fastest = (s.d == 1);
  for (int idx = threadIdx.x; idx < n * DP; idx += kThreads) {
    int t, d;
    if (dim_fastest) {
      t = idx / DP;
      d = idx % DP;
    } else {
      d = idx / n;
      t = idx % n;
    }
    const int pos = t0 + t;
    float x = 0.f;
    if (pos < seq && d < dh) x = src[pos * s.t + d * s.d];
    f(t, d, x);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int heads, int seq, int dh, Strides sq, Strides sk, Strides sv, Strides so,
                 float scale, int causal) {
  constexpr int NC = DP / 16;   // dims per thread in O
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                         // [DP][kQPad]   Q transposed
  float* kt = qt + DP * kQPad;              // [DP][kKPad]   K transposed
  float* vs = kt + DP * kKPad;              // [kBlockK][DP + 1]
  float* ps = vs + kBlockK * (DP + 1);      // [kBlockK][kQPad]  P transposed

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int r0 = ty * 4;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  for_tile<DP>(qb, sq, q0, kBlockQ, seq, dh,
               [&](int t, int d, float x) { qt[d * kQPad + t] = x * (scale * kLog2e); });

  float m[4], l[4], acc[4][NC];   // m in the log2 domain
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBlockQ, seq) - 1;
  const int k_end = causal ? q_last + 1 : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();
    for_tile<DP>(kb, sk, k0, kBlockK, seq, dh,
                 [&](int t, int d, float x) { kt[d * kKPad + t] = x; });
    for_tile<DP>(vb, sv, k0, kBlockK, seq, dh,
                 [&](int t, int d, float x) { vs[t * (DP + 1) + d] = x; });
    __syncthreads();

    // S micro-tile: rows r0..r0+3, keys tx + 16 j.
    float s[4][kKPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kKPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * kQPad + r0]);
      float bk[kKPT];
#pragma unroll
      for (int j = 0; j < kKPT; ++j) bk[j] = kt[d * kKPad + tx + kTX * j];
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        s[0][j] = fmaf(a.x, bk[j], s[0][j]);
        s[1][j] = fmaf(a.y, bk[j], s[1][j]);
        s[2][j] = fmaf(a.z, bk[j], s[2][j]);
        s[3][j] = fmaf(a.w, bk[j], s[3][j]);
      }
    }

    // Online softmax per row; a row's 64 scores sit on 16 lanes (tx).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const int kp = k0 + tx + kTX * j;
        const bool visible = kp < seq && (!causal || kp <= qpos);
        s[i][j] = visible ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const float p = s[i][j] == kNegInf ? 0.f : exp2f(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKPT; ++j) {
      *reinterpret_cast<float4*>(&ps[(tx + kTX * j) * kQPad + r0]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // O micro-tile: rows r0..r0+3, dims tx + 16 c.
#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[kk * kQPad + r0]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[kk * (DP + 1) + tx + 16 * c];
        acc[0][c] = fmaf(p.x, vv, acc[0][c]);
        acc[1][c] = fmaf(p.y, vv, acc[1][c]);
        acc[2][c] = fmaf(p.z, vv, acc[2][c]);
        acc[3][c] = fmaf(p.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= seq) continue;
    const float safe = (l[i] == 0.f) ? 1.f : l[i];
    float* ob = o + b * so.b + h * so.h + qpos * so.t;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) ob[d * so.d] = acc[i][c] / safe;
    }
    if (tx == 0) lse[static_cast<long long>(bh) * seq + qpos] = m[i] * kLn2 + logf(safe);
  }
}

// ------------------------------------------------------ bf16 tensor cores

constexpr int kMmaThreads = 128;             // 4 warps x 16 query rows

struct Modes {
  int q, k, v, o;
};

// L: the layout of q, k and v (mma_bf16.cuh); out may lie either way.
template <int DP, int L>
__global__ void __launch_bounds__(kMmaThreads, DP <= 64 ? 4 : 1)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int heads, int seq, int dh, Strides sq, Strides sk, Strides sv, Strides so,
                     Modes md, float scale, int causal) {
  constexpr int NK = DP / 16;   // 16-wide k-steps over the head dim
  constexpr int ND = DP / 8;    // 8-wide n-tiles over the head dim
  constexpr int TE = tile_elems<DP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // Q, then O on the way out
  bf16* ks = qs + TE;                             // [2] K tiles
  bf16* vs = ks + 2 * TE;                         // [2] V tiles

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + 16 * warp + (lane >> 2);   // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane & 3);                 // and columns col0, col0 + 1 of each n-tile
  const float c = scale * kLog2e;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int q_last = min(q0 + kBlockQ, seq) - 1;
  const int n_k = ((causal ? q_last + 1 : seq) + kBlockK - 1) / kBlockK;

  // K and V in separate copy groups: S and the softmax wait for K only.
  stage_tile<DP, kMmaThreads>(qs, qb, sq, md.q, q0, seq, dh);
  stage_tile<DP, kMmaThreads>(ks, kb, sk, md.k, 0, seq, dh);
  cp_async_commit();
  stage_tile<DP, kMmaThreads>(vs, vb, sv, md.v, 0, seq, dh);
  cp_async_commit();
  const TileView<DP> qv(qs, view_mode<L>(md.q)), kv(ks, view_mode<L>(md.k)),
      vv(vs, view_mode<L>(md.v));

  uint32_t qa[NK][4];
  float m[2] = {kNegInf, kNegInf};   // running max, log2 domain, quad-uniform
  float l[2] = {0.f, 0.f};           // this thread's share of the running sum
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) {
      stage_tile<DP, kMmaThreads>(ks + (buf ^ 1) * TE, kb, sk, md.k, (kt + 1) * kBlockK, seq, dh);
    }
    cp_async_commit();
    if (kt + 1 < n_k) {
      stage_tile<DP, kMmaThreads>(vs + (buf ^ 1) * TE, vb, sv, md.v, (kt + 1) * kBlockK, seq, dh);
    }
    cp_async_commit();
    cp_async_wait<3>();   // K of this tile (V of this tile, K and V of the next in flight)
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) qv.load(qa[kk], 0, 16 * warp, 16 * kk, true);
    }

    // S = Q K^T: this warp's 16 rows x 64 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t r[4];
        kv.load(r, buf, 16 * jj, 16 * kk, true);
        mma_bf16(s[2 * jj], qa[kk], r[0], r[2]);
        mma_bf16(s[2 * jj + 1], qa[kk], r[1], r[3]);
      }
    }

    // Scale to the log2 domain; mask the causal diagonal and the ragged edge.
    const int k0 = kt * kBlockK;
    const bool edge = (causal && k0 + kBlockK - 1 > q0 + 16 * warp) || k0 + kBlockK > seq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + col0 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        const bool visible = !edge || (key < seq && (!causal || key <= row));
        s[j][e] = visible ? s[j][e] * c : kNegInf;
      }
    }

    // Online softmax on the two rows this thread holds.
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float p = s[j][e] == kNegInf ? 0.f : fast_exp2(s[j][e] - m_new);
          s[j][e] = p;
          sum += p;
        }
      }
      l[i] = l[i] * alpha[i] + sum;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    cp_async_wait<2>();   // V of this tile
    __syncthreads();

    // O += P V, P rounded to bf16 in registers.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dd = 0; dd < NK; ++dd) {
        uint32_t r[4];
        vv.load(r, buf, 16 * j, 16 * dd, false);
        mma_bf16(acc[2 * dd], pa, r[0], r[1]);
        mma_bf16(acc[2 * dd + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();   // buffer `buf` is refilled at the next iteration
  }

  // Epilogue: the row sums over the quad, O / l through shared memory, lse.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float safe = (l[i] == 0.f) ? 1.f : l[i];
    inv[i] = 1.f / safe;
    const int row = row0 + 8 * i;
    if ((lane & 3) == 0 && row < seq) {
      lse[static_cast<long long>(bh) * seq + row] = m[i] * kLn2 + logf(safe);
    }
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] *= inv[0];
    acc[n][1] *= inv[0];
    acc[n][2] *= inv[1];
    acc[n][3] *= inv[1];
  }
  acc_to_tile<DP>(qs, md.o, 16 * warp, acc);   // Q is in registers: its tile is free
  __syncthreads();
  store_tile<DP, kMmaThreads>(o + b * so.b + h * so.h, so, md.o, qs, q0, seq, dh);
}

template <int DP>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int batch, int heads, int seq, int dh, const Strides* s, float scale,
                       int causal, cudaStream_t stream) {
  constexpr int smem = 4 * smem_floats<DP>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, heads, seq, dh, s[0], s[1], s[2], s[3], scale, causal);
  return cudaGetLastError();
}

template <int DP, int L>
cudaError_t launch_mma_l(const void* q, const void* k, const void* v, void* o, float* lse,
                         int batch, int heads, int seq, int dh, const Strides* s, const Modes& md,
                         float scale, int causal, cudaStream_t stream) {
  constexpr int smem = 5 * 2 * tile_elems<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DP, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  flash_fwd_mma_kernel<DP, L><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, heads, seq, dh, s[0], s[1], s[2], s[3], md, scale, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                       int batch, int heads, int seq, int dh, const Strides* s, float scale,
                       int causal, cudaStream_t stream) {
  const Modes md{operand_mode(q, s[0], seq, dh), operand_mode(k, s[1], seq, dh),
                 operand_mode(v, s[2], seq, dh), operand_mode(o, s[3], seq, dh)};
  if (md.q < 0 || md.k < 0 || md.v < 0 || md.o < 0) return cudaErrorInvalidValue;
  const int lq = md.q & kDhMajor;
  const int layout = (md.k & kDhMajor) == lq && (md.v & kDhMajor) == lq ? lq : kAnyLayout;
  auto run = layout == 0          ? launch_mma_l<DP, 0>
             : layout == kDhMajor ? launch_mma_l<DP, kDhMajor>
                                  : launch_mma_l<DP, kAnyLayout>;
  return run(q, k, v, o, lse, batch, heads, seq, dh, s, md, scale, causal, stream);
}

cudaError_t dispatch(bool bf, const void* q, const void* k, const void* v, void* o, float* lse,
                     int batch, int heads, int seq, int dh, const Strides* s, float scale,
                     int causal, cudaStream_t st) {
#define DDL_CASE(n)                                                                    \
  case n:                                                                              \
    return bf ? launch_mma<16 * n>(q, k, v, o, lse, batch, heads, seq, dh, s, scale,   \
                                   causal, st)                                         \
              : launch_fma<16 * n>(q, k, v, o, lse, batch, heads, seq, dh, s, scale,   \
                                   causal, st);
  switch ((dh + 15) / 16) {
    DDL_CASE(1)
    DDL_CASE(2)
    DDL_CASE(3)
    DDL_CASE(4)
    DDL_CASE(5)
    DDL_CASE(6)
    DDL_CASE(7)
    DDL_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef DDL_CASE
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v, o are indexed
// [b, h, t, d] through `strides`: 16 element strides, four (b, h, t, d) per
// operand in the order q, k, v, o. lse is a dense fp32 [batch*heads, seq].
// bf16 operands need positions or dims at stride 1 (either layout); fp32
// ones may have any strides. Launches on `stream` and returns the launch's
// cudaError_t (0 = success); it does not synchronise.
extern "C" int ddl_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             int is_bf16, int batch, int heads, int seq, int dh,
                             const long long* strides, float scale, int causal, void* stream) {
  if (batch < 1 || heads < 1 || seq < 1 || dh < 1 || dh > 128 ||
      (seq + kBlockQ - 1) / kBlockQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides s[4];
  for (int i = 0; i < 4; ++i) {
    s[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  }
  return static_cast<int>(dispatch(is_bf16 != 0, q, k, v, o, lse, batch, heads, seq, dh, s,
                                   scale, causal, static_cast<cudaStream_t>(stream)));
}
