// Causal flash-attention backward for Hopper (sm_90a), fp32 and bf16 inputs:
// one dQ kernel and one dK/dV kernel per type.
//
// Replaces the JAX package's Pallas TPU kernels in
// ddl25spring_tpu/ops/flash_attention.py: _dq_kernel (:190) and _dkv_kernel
// (:218) on row-major [B*H, T, Dh] operands, and _dq_kernel_t (:450) and
// _dkv_kernel_t (:480) on dh-major [B*H, Dh, T] operands. As in flash_fwd.cu,
// each kernel reads every operand through (batch, head, seq, dim) strides, so
// one kernel serves both layouts, and the gradients are written through
// strides too (the wrapper hands the model's [B, T, H, Dh] layout).
//
// What they compute, per (batch, head), with s_ij = q_i . k_j / sqrt(Dh):
//   P_ij  = exp(s_ij - lse_i)                 (lse saved by the forward)
//   dS_ij = P_ij (dO_i . v_j - delta_i) / sqrt(Dh),  delta_i = dO_i . o_i
//   dQ_i  = sum_j dS_ij k_j       (dQ kernel: one CTA per query tile)
//   dK_j  = sum_i dS_ij q_i       (dK/dV kernel: one CTA per key tile)
//   dV_j  = sum_i P_ij dO_i
// over the visible pairs: j <= i (causal) or j < T, and i < T. A query row at
// or past T gets P = 0, so no non-finite lse of a padded row can reach dK or
// dV (the reason for _bwd_mask in the JAX package). Scores, P and dS are
// fp32; gradients are cast to the input type on the way out. delta is
// computed by the caller (a plain reduction, as in the JAX package). The
// TPU kernels carry dQ (or dK, dV) in VMEM scratch across a sequential grid
// axis; here that axis is a loop inside the CTA, and the two kernels keep
// the TPU's split so no atomics are needed and the results are
// deterministic.
//
// bf16: both kernels on the tensor cores (mma_bf16.cuh), CTAs of 4 warps,
// each warp owning 16 rows of a 64-row tile and keeping that tile's operands
// as A fragments in registers while the other side's tiles stream through a
// shared-memory double buffer filled with cp.async. Scores, P and dS stay in
// fp32 registers; P and dS are rounded to bf16 in registers as the A
// operands of the gradient products (FlashAttention-2's rounding point;
// accumulation stays fp32), the exponentials run on the SFU (fast_exp2), and
// the epilogue stages the fp32 accumulators through shared memory in the
// gradient's layout and writes 16-byte rows. The layout of q, k and v is a
// template parameter (each in one layout with dO row-major, as the training
// step calls them, or every operand read at run time for a mixed call).
//  - dQ, flash_bwd_dq_mma_kernel: one CTA per (batch*head, 64-query tile),
//    the last query tiles (the heaviest when causal) first. Q's and dO's A
//    fragments, and each row's lse and delta, stay in registers. K and V
//    tiles from tile 0 up to the diagonal (causal) or to T are
//    double-buffered, K and V in separate copy groups, so S and P wait for
//    K only and V's load overlaps them. Per 32 keys: S = Q.K^T and dP =
//    dO.V^T on mma; P = exp2(S log2(e)/sqrt(Dh) - lse log2(e)), masked only
//    on edge tiles; dS = P (dP - delta) / sqrt(Dh); dQ += dS.K. Registers
//    capped for 4 CTAs per SM at Dh <= 64.
//  - dK/dV, flash_bwd_dkv_mma_kernel: one CTA per (batch*head, 64-key
//    tile), key tile 0 (the heaviest when causal) first. K's and V's A
//    fragments stay in registers; Q and dO tiles from the diagonal tile to
//    the end (causal) or over all of T are double-buffered with the 64
//    queries' lse and delta beside them. Per 32 queries: S^T = K.Q^T and
//    dP^T = V.dO^T; P^T and dS^T as above; dV += P^T.dO and dK += dS^T.Q.
//    Registers capped for 3 CTAs per SM at Dh <= 64.
//
// fp32: register-tiled FMA code, no tensor cores (no TF32: the fp32 limits
// are 1e-4). CTAs of 256 threads on 64 x 64 tiles, the heaviest first (dQ:
// the last query tiles; dK/dV: the first key tiles). Every product is
// register-tiled: a 16 x 16 thread grid where each thread owns 4 rows x 4
// columns of S, dP and dS (then 4 rows x Dh/16 dims of the accumulated
// gradient), so each shared-memory load feeds 4 FMAs. Tiles are staged
// transposed (dim-major) in shared memory as fp32; an operand read 4 rows at
// a time as a float4 gets a row stride of 68 floats, one read one column per
// lane a stride of 65, so both reads and the transposed stores are free of
// bank conflicts. P and dS go through shared memory into the gradient
// products.
//
// What bounds them on this card: at the training shape (B=64, H=6, T=256,
// Dh=48, bf16) the dQ kernel does 6*Dh and the dK/dV kernel 8*Dh operations
// per visible pair (12.6 M pairs) against ~48 / ~57 MB of operand traffic:
// the bytes bound both functions (14.3 / 17.1 us, PERF.md). The tensor-core
// kernels are held back by latency instead: a CTA walks 1-4 tiles, so its
// first loads (four tiles before its first product) and its epilogue are a
// large share of its time, and registers decide how many CTAs per SM hide
// one another's waits. The designs answer with the heaviest CTAs first,
// later tiles loaded during the current tile's products, operands that stay
// in registers, and the register caps above. The fp32 FMA kernels are held
// back by the fp32 FMA rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlock = 64;                   // queries and keys per tile
constexpr int kTX = 16;                      // threads along columns / dims
constexpr int kTY = kBlock / 4;              // threads along rows (4 rows each)
constexpr int kThreads = kTX * kTY;
constexpr int kPer = kBlock / kTX;           // columns per thread
constexpr int kVecPad = kBlock + 4;          // row stride of float4-read tiles
constexpr int kOddPad = kBlock + 1;          // row stride of column-read tiles
constexpr float kLog2e = 1.4426950408889634f;

// Element (t, d) of rows [t0, t0 + kBlock) of one head, read in the operand's
// own contiguous order and stored transposed: dst[d * pad + t] (zero past seq
// and dh).
template <int DP>
__device__ __forceinline__ void load_t(const float* __restrict__ src, const Strides& s, int t0,
                                       int seq, int dh, float* dst, int pad) {
  const bool dim_fastest = (s.d == 1);
  for (int idx = threadIdx.x; idx < kBlock * DP; idx += kThreads) {
    int t, d;
    if (dim_fastest) {
      t = idx / DP;
      d = idx % DP;
    } else {
      d = idx / kBlock;
      t = idx % kBlock;
    }
    const int pos = t0 + t;
    float x = 0.f;
    if (pos < seq && d < dh) x = src[pos * s.t + d * s.d];
    dst[d * pad + t] = x;
  }
}

// Rows r0..r0+3 of a [4 x DP] register accumulator to rows t0 + r0 + i of a
// [seq, dh] gradient through strides (dims tx + 16 c).
template <int NC>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const Strides& s, int t0,
                                           int r0, int tx, int seq, int dh,
                                           const float (&acc)[4][NC]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = t0 + r0 + i;
    if (pos >= seq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) dst[pos * s.t + d * s.d] = acc[i][c];
    }
  }
}

template <int DP>
constexpr int dq_smem_floats() {
  return 2 * DP * kVecPad + 2 * DP * kOddPad + kBlock * kVecPad;
}

template <int DP>
constexpr int dkv_smem_floats() {
  return 2 * DP * kVecPad + 2 * DP * kOddPad + 2 * kBlock * kVecPad + 2 * kBlock;
}

// dQ, fp32: one CTA per (batch*head, 64-query tile); walks the key tiles up
// to the diagonal (causal) or to T.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int heads, int seq, int dh, Strides sq, Strides sk,
                    Strides sv, Strides sdo, Strides sdq, float scale, int causal) {
  constexpr int NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                         // [DP][kVecPad]  Q transposed
  float* dot = qt + DP * kVecPad;           // [DP][kVecPad]  dO transposed
  float* kt = dot + DP * kVecPad;           // [DP][kOddPad]  K transposed
  float* vt = kt + DP * kOddPad;            // [DP][kOddPad]  V transposed
  float* dst = vt + DP * kOddPad;           // [kBlock][kVecPad]  dS transposed (key, query)

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int r0 = ty * 4;
  const float sl2 = scale * kLog2e;

  load_t<DP>(q + b * sq.b + h * sq.h, sq, q0, seq, dh, qt, kVecPad);
  load_t<DP>(dout + b * sdo.b + h * sdo.h, sdo, q0, seq, dh, dot, kVecPad);
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  float lse2[4], dlt[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + r0 + i;
    const long long row = static_cast<long long>(bh) * seq + qpos;
    lse2[i] = qpos < seq ? lse[row] * kLog2e : 0.f;
    dlt[i] = qpos < seq ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBlock, seq) - 1;
  const int k_end = causal ? q_last + 1 : seq;
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();
    load_t<DP>(kb, sk, k0, seq, dh, kt, kOddPad);
    load_t<DP>(vb, sv, k0, seq, dh, vt, kOddPad);
    __syncthreads();

    // S and dP micro-tiles: rows r0..r0+3, keys tx + 16 j.
    float s[4][kPer], dp[4][kPer];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[d * kVecPad + r0]);
      const float4 g = *reinterpret_cast<const float4*>(&dot[d * kVecPad + r0]);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float bk = kt[d * kOddPad + tx + kTX * j];
        const float bv = vt[d * kOddPad + tx + kTX * j];
        s[0][j] = fmaf(a.x, bk, s[0][j]);
        s[1][j] = fmaf(a.y, bk, s[1][j]);
        s[2][j] = fmaf(a.z, bk, s[2][j]);
        s[3][j] = fmaf(a.w, bk, s[3][j]);
        dp[0][j] = fmaf(g.x, bv, dp[0][j]);
        dp[1][j] = fmaf(g.y, bv, dp[1][j]);
        dp[2][j] = fmaf(g.z, bv, dp[2][j]);
        dp[3][j] = fmaf(g.w, bv, dp[3][j]);
      }
    }
    // dS = P (dP - delta) scale, P recomputed from the saved lse.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int kp = k0 + tx + kTX * j;
        const bool visible = qpos < seq && (causal ? kp <= qpos : kp < seq);
        const float p = visible ? exp2f(s[i][j] * sl2 - lse2[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - dlt[i]) * scale;
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      *reinterpret_cast<float4*>(&dst[(tx + kTX * j) * kVecPad + r0]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // dQ micro-tile: rows r0..r0+3, dims tx + 16 c.
#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      const float4 ds = *reinterpret_cast<const float4*>(&dst[kk * kVecPad + r0]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = kt[(tx + 16 * c) * kOddPad + kk];
        acc[0][c] = fmaf(ds.x, kv, acc[0][c]);
        acc[1][c] = fmaf(ds.y, kv, acc[1][c]);
        acc[2][c] = fmaf(ds.z, kv, acc[2][c]);
        acc[3][c] = fmaf(ds.w, kv, acc[3][c]);
      }
    }
  }
  store_rows<NC>(dq + b * sdq.b + h * sdq.h, sdq, q0, r0, tx, seq, dh, acc);
}

// dK/dV, fp32: one CTA per (batch*head, 64-key tile); walks the query tiles
// from the diagonal (causal) or from 0 to T.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv,
                     int heads, int seq, int dh, Strides sq, Strides sk, Strides sv, Strides sdo,
                     Strides sdk, Strides sdv, float scale, int causal) {
  constexpr int NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                         // [DP][kVecPad]  K transposed
  float* vt = kt + DP * kVecPad;            // [DP][kVecPad]  V transposed
  float* qt = vt + DP * kVecPad;            // [DP][kOddPad]  Q transposed
  float* dot = qt + DP * kOddPad;           // [DP][kOddPad]  dO transposed
  float* ps = dot + DP * kOddPad;           // [kBlock][kVecPad]  P (query, key)
  float* dss = ps + kBlock * kVecPad;       // [kBlock][kVecPad]  dS (query, key)
  float* lse2 = dss + kBlock * kVecPad;     // [kBlock]  lse * log2(e) of the query tile
  float* dlt = lse2 + kBlock;               // [kBlock]  delta of the query tile

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.y * kBlock;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int r0 = ty * 4;
  const float sl2 = scale * kLog2e;

  load_t<DP>(k + b * sk.b + h * sk.h, sk, k0, seq, dh, kt, kVecPad);
  load_t<DP>(v + b * sv.b + h * sv.h, sv, k0, seq, dh, vt, kVecPad);
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = causal ? k0 : 0; q0 < seq; q0 += kBlock) {
    __syncthreads();
    load_t<DP>(qb, sq, q0, seq, dh, qt, kOddPad);
    load_t<DP>(dob, sdo, q0, seq, dh, dot, kOddPad);
    if (threadIdx.x < kBlock) {
      const int qpos = q0 + threadIdx.x;
      const long long row = static_cast<long long>(bh) * seq + qpos;
      lse2[threadIdx.x] = qpos < seq ? lse[row] * kLog2e : 0.f;
      dlt[threadIdx.x] = qpos < seq ? delta[row] : 0.f;
    }
    __syncthreads();

    // S and dP transposed: rows = keys r0..r0+3, columns = queries tx + 16 j.
    float s[4][kPer], dp[4][kPer];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&kt[d * kVecPad + r0]);
      const float4 w = *reinterpret_cast<const float4*>(&vt[d * kVecPad + r0]);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float bq = qt[d * kOddPad + tx + kTX * j];
        const float bo = dot[d * kOddPad + tx + kTX * j];
        s[0][j] = fmaf(a.x, bq, s[0][j]);
        s[1][j] = fmaf(a.y, bq, s[1][j]);
        s[2][j] = fmaf(a.z, bq, s[2][j]);
        s[3][j] = fmaf(a.w, bq, s[3][j]);
        dp[0][j] = fmaf(w.x, bo, dp[0][j]);
        dp[1][j] = fmaf(w.y, bo, dp[1][j]);
        dp[2][j] = fmaf(w.z, bo, dp[2][j]);
        dp[3][j] = fmaf(w.w, bo, dp[3][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int qc = tx + kTX * j;
      const int qpos = q0 + qc;
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + r0 + i;
        const bool visible = qpos < seq && (causal ? kp <= qpos : kp < seq);
        p[i] = visible ? exp2f(s[i][j] * sl2 - lse2[qc]) : 0.f;
        ds[i] = p[i] * (dp[i][j] - dlt[qc]) * scale;
      }
      *reinterpret_cast<float4*>(&ps[qc * kVecPad + r0]) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(&dss[qc * kVecPad + r0]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dV and dK micro-tiles: rows = keys r0..r0+3, dims tx + 16 c.
#pragma unroll 4
    for (int qq = 0; qq < kBlock; ++qq) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[qq * kVecPad + r0]);
      const float4 ds = *reinterpret_cast<const float4*>(&dss[qq * kVecPad + r0]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float o = dot[(tx + 16 * c) * kOddPad + qq];
        const float x = qt[(tx + 16 * c) * kOddPad + qq];
        acc_v[0][c] = fmaf(p.x, o, acc_v[0][c]);
        acc_v[1][c] = fmaf(p.y, o, acc_v[1][c]);
        acc_v[2][c] = fmaf(p.z, o, acc_v[2][c]);
        acc_v[3][c] = fmaf(p.w, o, acc_v[3][c]);
        acc_k[0][c] = fmaf(ds.x, x, acc_k[0][c]);
        acc_k[1][c] = fmaf(ds.y, x, acc_k[1][c]);
        acc_k[2][c] = fmaf(ds.z, x, acc_k[2][c]);
        acc_k[3][c] = fmaf(ds.w, x, acc_k[3][c]);
      }
    }
  }
  store_rows<NC>(dk + b * sdk.b + h * sdk.h, sdk, k0, r0, tx, seq, dh, acc_k);
  store_rows<NC>(dv + b * sdv.b + h * sdv.h, sdv, k0, r0, tx, seq, dh, acc_v);
}

// ------------------------------------------------------ bf16 tensor cores

constexpr int kMmaThreads = 128;   // 4 warps x 16 rows
constexpr int kKSub = 32;          // dQ: keys per step of the products
constexpr int kQSub = 32;          // dK/dV: queries per step of the products

// Each operand's mode (mma_bf16.cuh); the gradients are dq, or dk and dv.
struct Modes {
  int q, k, v, dout, g0, g1;
};

// Q and dO tiles, then double-buffered K and V tiles.
template <int DP>
constexpr int dq_mma_smem_bytes() {
  return 6 * 2 * tile_elems<DP>();
}

// K and V tiles, double-buffered Q and dO tiles, and the query tiles' lse
// and delta ([2 buffers][lse, delta][kBlock] floats).
template <int DP>
constexpr int dkv_mma_smem_bytes() {
  return 6 * 2 * tile_elems<DP>() + 2 * 2 * kBlock * 4;
}

// L: the layout of q, k and v (mma_bf16.cuh); dO is row-major unless L is
// kAnyLayout; dq (md.g0) may lie either way.
template <int DP, int L>
__global__ void __launch_bounds__(kMmaThreads, DP <= 64 ? 4 : 1)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int heads, int seq, int dh, Strides sq,
                        Strides sk, Strides sv, Strides sdo, Strides sdq, Modes md, float scale,
                        int causal) {
  constexpr int NK = DP / 16;       // 16-wide k-steps over the head dim
  constexpr int ND = DP / 8;        // 8-wide n-tiles over the head dim
  constexpr int NS = kKSub / 8;     // 8-wide n-tiles over a step's keys
  constexpr int TE = tile_elems<DP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // Q, then dQ on the way out
  bf16* dos = qs + TE;                            // dO
  bf16* ks = dos + TE;                            // [2] K tiles
  bf16* vs = ks + 2 * TE;                         // [2] V tiles

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + 16 * warp + (lane >> 2);   // this thread's queries: row0, row0 + 8
  const int col0 = 2 * (lane & 3);                 // and key columns col0, col0 + 1
  const float c = scale * kLog2e;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int q_last = min(q0 + kBlock, seq) - 1;
  const int n_k = ((causal ? q_last + 1 : seq) + kBlock - 1) / kBlock;

  // Q, dO and K in one copy group, V in the next: S and P wait for K only.
  stage_tile<DP, kMmaThreads>(qs, q + b * sq.b + h * sq.h, sq, md.q, q0, seq, dh);
  stage_tile<DP, kMmaThreads>(dos, dout + b * sdo.b + h * sdo.h, sdo, md.dout, q0, seq, dh);
  stage_tile<DP, kMmaThreads>(ks, kb, sk, md.k, 0, seq, dh);
  cp_async_commit();
  stage_tile<DP, kMmaThreads>(vs, vb, sv, md.v, 0, seq, dh);
  cp_async_commit();
  const TileView<DP> qv(qs, view_mode<L>(md.q)), dov(dos, L == kAnyLayout ? md.dout : 0),
      kv(ks, view_mode<L>(md.k)), vv(vs, view_mode<L>(md.v));

  // The two rows' lse (log2 domain) and delta; a row past seq reads neither.
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long at = static_cast<long long>(bh) * seq + row;
    lse2[i] = row < seq ? lse[at] * kLog2e : 0.f;
    dlt[i] = row < seq ? delta[at] : 0.f;
  }

  uint32_t qa[NK][4], doa[NK][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) {
      stage_tile<DP, kMmaThreads>(ks + (buf ^ 1) * TE, kb, sk, md.k, (kt + 1) * kBlock, seq, dh);
    }
    cp_async_commit();
    if (kt + 1 < n_k) {
      stage_tile<DP, kMmaThreads>(vs + (buf ^ 1) * TE, vb, sv, md.v, (kt + 1) * kBlock, seq, dh);
    }
    cp_async_commit();
    cp_async_wait<3>();   // K of this tile (V of this tile, K and V of the next in flight)
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        qv.load(qa[kk], 0, 16 * warp, 16 * kk, true);
        dov.load(doa[kk], 0, 16 * warp, 16 * kk, true);
      }
    }

#pragma unroll
    for (int sub = 0; sub < kBlock; sub += kKSub) {
      // S = Q K^T: this warp's 16 queries x kKSub keys.
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t r[4];
          kv.load(r, buf, sub + 16 * jj, 16 * kk, true);
          mma_bf16(s[2 * jj], qa[kk], r[0], r[2]);
          mma_bf16(s[2 * jj + 1], qa[kk], r[1], r[3]);
        }
      }

      // P from the saved lse; masked only where the step meets the causal
      // diagonal or the ragged edge of the keys or of this warp's rows.
      const int key_base = kt * kBlock + sub;
      const bool edge = q0 + 16 * warp + 16 > seq ||
                        (causal ? key_base + kKSub - 1 > q0 + 16 * warp : key_base + kKSub > seq);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_base + 8 * j + col0 + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          const bool visible = !edge || (row < seq && (causal ? key <= row : key < seq));
          s[j][e] = visible ? fast_exp2(fmaf(s[j][e], c, -lse2[e >> 1])) : 0.f;
        }
      }
      if (sub == 0) {
        cp_async_wait<2>();   // V of this tile
        __syncthreads();
      }

      // dP = dO V^T, then dS = P (dP - delta) scale.
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t r[4];
          vv.load(r, buf, sub + 16 * jj, 16 * kk, true);
          mma_bf16(dp[2 * jj], doa[kk], r[0], r[2]);
          mma_bf16(dp[2 * jj + 1], doa[kk], r[1], r[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dlt[e >> 1]) * scale;
      }

      // dQ += dS K, dS as bf16 A fragments.
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t da[4];
        acc_to_a(da, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
        for (int dd = 0; dd < NK; ++dd) {
          uint32_t r[4];
          kv.load(r, buf, sub + 16 * j, 16 * dd, false);
          mma_bf16(acc[2 * dd], da, r[0], r[1]);
          mma_bf16(acc[2 * dd + 1], da, r[2], r[3]);
        }
      }
    }
    __syncthreads();   // buffer `buf` is refilled at the next iteration
  }

  // Epilogue: Q and dO are in registers, so Q's tile takes dQ.
  acc_to_tile<DP>(qs, md.g0, 16 * warp, acc);
  __syncthreads();
  store_tile<DP, kMmaThreads>(dq + b * sdq.b + h * sdq.h, sdq, md.g0, qs, q0, seq, dh);
}

// L: the layout of q, k and v (mma_bf16.cuh); dO is row-major unless L is
// kAnyLayout; dk and dv (md.g0, md.g1) may lie either way.
template <int DP, int L>
__global__ void __launch_bounds__(kMmaThreads, DP <= 64 ? 3 : 1)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int seq, int dh,
                         Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, Modes md, float scale, int causal) {
  constexpr int NK = DP / 16;       // 16-wide k-steps over the head dim
  constexpr int ND = DP / 8;        // 8-wide n-tiles over the head dim
  constexpr int NQ = kQSub / 8;     // 8-wide n-tiles over a step's queries
  constexpr int TE = tile_elems<DP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // K, then dK on the way out
  bf16* vs = ks + TE;                             // V, then dV
  bf16* qs = vs + TE;                             // [2] Q tiles
  bf16* dos = qs + 2 * TE;                        // [2] dO tiles
  float* rows = reinterpret_cast<float*>(dos + 2 * TE);

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.y * kBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key0 = k0 + 16 * warp + (lane >> 2);   // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (lane & 3);                 // and query columns col0, col0 + 1
  const float c = scale * kLog2e;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* dob = dout + b * sdo.b + h * sdo.h;
  const long long row_base = static_cast<long long>(bh) * seq;
  const int n_q = (seq + kBlock - 1) / kBlock;
  const int first = causal ? blockIdx.y : 0;

  // Query tile qt's Q, dO, lse and delta into buffer `buf`.
  auto stage_queries = [&](int qt, int buf) {
    const int q0 = qt * kBlock;
    stage_tile<DP, kMmaThreads>(qs + buf * TE, qb, sq, md.q, q0, seq, dh);
    stage_tile<DP, kMmaThreads>(dos + buf * TE, dob, sdo, md.dout, q0, seq, dh);
    for (int i = threadIdx.x; i < 2 * kBlock; i += kMmaThreads) {
      const int pos = q0 + i % kBlock;
      const float* src = (i < kBlock ? lse : delta) + row_base + pos;
      cp_async_4(smem_u32(rows + buf * 2 * kBlock + i), pos < seq ? src : lse,
                 pos < seq ? 4 : 0);
    }
  };

  stage_tile<DP, kMmaThreads>(ks, k + b * sk.b + h * sk.h, sk, md.k, k0, seq, dh);
  stage_tile<DP, kMmaThreads>(vs, v + b * sv.b + h * sv.h, sv, md.v, k0, seq, dh);
  stage_queries(first, 0);
  cp_async_commit();
  const TileView<DP> kv(ks, view_mode<L>(md.k)), vv(vs, view_mode<L>(md.v)),
      qv(qs, view_mode<L>(md.q)), dov(dos, L == kAnyLayout ? md.dout : 0);

  uint32_t ka[NK][4], va[NK][4];
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  }

  for (int qt = first; qt < n_q; ++qt) {
    const int buf = (qt - first) & 1;
    if (qt + 1 < n_q) stage_queries(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // everything but the tile just requested
    __syncthreads();
    if (qt == first) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        kv.load(ka[kk], 0, 16 * warp, 16 * kk, true);
        vv.load(va[kk], 0, 16 * warp, 16 * kk, true);
      }
    }
    const int q0 = qt * kBlock;
    const float* lse_t = rows + buf * 2 * kBlock;
    const float* delta_t = lse_t + kBlock;

#pragma unroll
    for (int sub = 0; sub < kBlock; sub += kQSub) {
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries.
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < NQ / 2; ++jj) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t r[4];
          qv.load(r, buf, sub + 16 * jj, 16 * kk, true);
          mma_bf16(st[2 * jj], ka[kk], r[0], r[2]);
          mma_bf16(st[2 * jj + 1], ka[kk], r[1], r[3]);
          dov.load(r, buf, sub + 16 * jj, 16 * kk, true);
          mma_bf16(dpt[2 * jj], va[kk], r[0], r[2]);
          mma_bf16(dpt[2 * jj + 1], va[kk], r[1], r[3]);
        }
      }

      // P^T from the saved lse, masked; dS^T = P^T (dP^T - delta) scale.
      const bool edge = q0 + sub + kQSub > seq ||
                        (causal ? k0 + 16 * warp + 15 > q0 + sub : k0 + kBlock > seq);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int qc = sub + 8 * j + col0;
        const float2 ls = *reinterpret_cast<const float2*>(lse_t + qc);
        const float2 dl = *reinterpret_cast<const float2*>(delta_t + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + qc + (e & 1);
          const int kpos = key0 + 8 * (e >> 1);
          const bool visible = !edge || (qpos < seq && (causal ? kpos <= qpos : kpos < seq));
          const float p =
              visible ? fast_exp2(fmaf(st[j][e], c, -((e & 1) ? ls.y : ls.x) * kLog2e)) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dl.y : dl.x)) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T as bf16 A fragments.
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, st[2 * j], st[2 * j + 1]);
        acc_to_a(da, dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
        for (int dd = 0; dd < NK; ++dd) {
          uint32_t r[4];
          dov.load(r, buf, sub + 16 * j, 16 * dd, false);
          mma_bf16(acc_v[2 * dd], pa, r[0], r[1]);
          mma_bf16(acc_v[2 * dd + 1], pa, r[2], r[3]);
          qv.load(r, buf, sub + 16 * j, 16 * dd, false);
          mma_bf16(acc_k[2 * dd], da, r[0], r[1]);
          mma_bf16(acc_k[2 * dd + 1], da, r[2], r[3]);
        }
      }
    }
    __syncthreads();   // buffer `buf` is refilled at the next iteration
  }

  // Epilogue: K and V are in registers, so their tiles take dK and dV.
  acc_to_tile<DP>(ks, md.g0, 16 * warp, acc_k);
  acc_to_tile<DP>(vs, md.g1, 16 * warp, acc_v);
  __syncthreads();
  store_tile<DP, kMmaThreads>(dk + b * sdk.b + h * sdk.h, sdk, md.g0, ks, k0, seq, dh);
  store_tile<DP, kMmaThreads>(dv + b * sdv.b + h * sdv.h, sdv, md.g1, vs, k0, seq, dh);
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *g0, *g1;                 // dq, or dk and dv
  int batch, heads, seq, dh, causal;
  float scale;
  Strides s[6];                  // q, k, v, dO, then the gradients
};

template <int DP>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int smem = 4 * dq_smem_floats<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kBlock - 1) / kBlock);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.g0), a.heads, a.seq, a.dh, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4],
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int smem = 4 * dkv_smem_floats<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kBlock - 1) / kBlock);
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.g0), static_cast<float*>(a.g1), a.heads, a.seq, a.dh, a.s[0],
      a.s[1], a.s[2], a.s[3], a.s[4], a.s[5], a.scale, a.causal);
  return cudaGetLastError();
}

// The operands' modes for the bf16 kernels; false where one has neither its
// positions nor its dims at stride 1.
bool modes_of(const Args& a, int n_grads, Modes& md) {
  md = Modes{operand_mode(a.q, a.s[0], a.seq, a.dh), operand_mode(a.k, a.s[1], a.seq, a.dh),
             operand_mode(a.v, a.s[2], a.seq, a.dh), operand_mode(a.dout, a.s[3], a.seq, a.dh),
             operand_mode(a.g0, a.s[4], a.seq, a.dh),
             n_grads > 1 ? operand_mode(a.g1, a.s[5], a.seq, a.dh) : 0};
  return md.q >= 0 && md.k >= 0 && md.v >= 0 && md.dout >= 0 && md.g0 >= 0 && md.g1 >= 0;
}

// The bf16 kernels' layout parameter: q, k and v in one layout with dO
// row-major (the training step's call) fix it; anything else is read at run
// time.
int layout_of(const Modes& md) {
  const int lq = md.q & kDhMajor;
  const bool fixed = (md.k & kDhMajor) == lq && (md.v & kDhMajor) == lq && !(md.dout & kDhMajor);
  return fixed ? lq : kAnyLayout;
}

template <int DP, int L>
cudaError_t launch_dq_mma_l(const Args& a, const Modes& md, cudaStream_t stream) {
  constexpr int smem = dq_mma_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<DP, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kBlock - 1) / kBlock);
  flash_bwd_dq_mma_kernel<DP, L><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.g0), a.heads, a.seq, a.dh, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], md,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int DP, int L>
cudaError_t launch_dkv_mma_l(const Args& a, const Modes& md, cudaStream_t stream) {
  constexpr int smem = dkv_mma_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<DP, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kBlock - 1) / kBlock);
  flash_bwd_dkv_mma_kernel<DP, L><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.g0), static_cast<bf16*>(a.g1), a.heads, a.seq, a.dh, a.s[0], a.s[1],
      a.s[2], a.s[3], a.s[4], a.s[5], md, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq_mma(const Args& a, cudaStream_t stream) {
  Modes md;
  if (!modes_of(a, 1, md)) return cudaErrorInvalidValue;
  switch (layout_of(md)) {
    case 0: return launch_dq_mma_l<DP, 0>(a, md, stream);
    case kDhMajor: return launch_dq_mma_l<DP, kDhMajor>(a, md, stream);
    default: return launch_dq_mma_l<DP, kAnyLayout>(a, md, stream);
  }
}

template <int DP>
cudaError_t launch_dkv_mma(const Args& a, cudaStream_t stream) {
  Modes md;
  if (!modes_of(a, 2, md)) return cudaErrorInvalidValue;
  switch (layout_of(md)) {
    case 0: return launch_dkv_mma_l<DP, 0>(a, md, stream);
    case kDhMajor: return launch_dkv_mma_l<DP, kDhMajor>(a, md, stream);
    default: return launch_dkv_mma_l<DP, kAnyLayout>(a, md, stream);
  }
}

// bf16: the tensor-core kernels; fp32: the FMA kernels.
template <int DP>
cudaError_t launch(const Args& a, bool bf, bool is_dq, cudaStream_t st) {
  if (is_dq) return bf ? launch_dq_mma<DP>(a, st) : launch_dq<DP>(a, st);
  return bf ? launch_dkv_mma<DP>(a, st) : launch_dkv<DP>(a, st);
}

int run(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, void* g0, void* g1, int is_bf16, int batch, int heads, int seq,
        int dh, const long long* strides, int n_ops, float scale, int causal, void* stream,
        bool is_dq) {
  if (batch < 1 || heads < 1 || seq < 1 || dh < 1 || dh > 128 ||
      (seq + kBlock - 1) / kBlock > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, dout, lse, delta, g0, g1, batch, heads, seq, dh, causal, scale, {}};
  for (int i = 0; i < n_ops; ++i) {
    a.s[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
  }
  const bool bf = is_bf16 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((dh + 15) / 16) {
    case 1: return static_cast<int>(launch<16>(a, bf, is_dq, st));
    case 2: return static_cast<int>(launch<32>(a, bf, is_dq, st));
    case 3: return static_cast<int>(launch<48>(a, bf, is_dq, st));
    case 4: return static_cast<int>(launch<64>(a, bf, is_dq, st));
    case 5: return static_cast<int>(launch<80>(a, bf, is_dq, st));
    case 6: return static_cast<int>(launch<96>(a, bf, is_dq, st));
    case 7: return static_cast<int>(launch<112>(a, bf, is_dq, st));
    default: return static_cast<int>(launch<128>(a, bf, is_dq, st));
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). q, k, v, dout and the gradients
// are indexed [b, h, t, d] through `strides`: four (b, h, t, d) element
// strides per operand, in the order q, k, v, dout, then dq (5 operands) or
// dk, dv (6 operands). lse and delta are dense fp32 [batch*heads, seq].
// Each launches one kernel on `stream` and returns the launch's cudaError_t
// (0 = success); neither synchronises. The bf16 kernels need positions or
// dims at stride 1 in each operand (either layout).
extern "C" int ddl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq, int is_bf16,
                                int batch, int heads, int seq, int dh, const long long* strides,
                                float scale, int causal, void* stream) {
  return run(q, k, v, dout, lse, delta, dq, nullptr, is_bf16, batch, heads, seq, dh, strides, 5,
             scale, causal, stream, true);
}

extern "C" int ddl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk, void* dv,
                                 int is_bf16, int batch, int heads, int seq, int dh,
                                 const long long* strides, float scale, int causal,
                                 void* stream) {
  return run(q, k, v, dout, lse, delta, dk, dv, is_bf16, batch, heads, seq, dh, strides, 6,
             scale, causal, stream, false);
}
