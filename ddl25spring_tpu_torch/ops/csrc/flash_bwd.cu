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
// fp32: both kernels on the tensor cores too, in 3xTF32 (mma_tf32.cuh): each
// product of two fp32 operands is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on
// mma.sync m16n8k8 TF32, hi the operand cut to TF32 and lo the remainder. One
// TF32 product keeps ~3 digits and puts the gradients ~1e-2 off fp32 at T=256,
// Dh=48; three keep them within ~1e-5, inside the fp32 limit of 1e-4. The
// tensor cores' fp32 sums truncate, so a long sum drifts (2.5e-4 at T=4096
// when every product went into one accumulator): each step's gradient products
// go into fresh accumulators, NC head-dim n-tiles at a time, which are added
// to running sums in shared memory (each thread's own words) in rounded fp32.
// CTAs of kTf32Warps warps, 16 rows each; the rows' operands are A fragments
// read once from device memory into registers (DP <= 48; a wider head reads
// them from L1 at each use), and the other side's 64-position tiles stream
// through a shared-memory double buffer filled with cp.async (16-byte copies
// where rows are aligned, else one element each) in mma_tf32.cuh's padded
// layouts, read at a per-lane base plus compile-time offsets. B fragments are
// split into hi and lo as they are read. Score columns hold permuted
// positions, so the accumulators of P and dS are, as they are, the A fragments
// of the gradient products. Each 3xTF32 step is three passes over independent
// accumulators. The exponentials run on the SFU (fast_exp2: the same results
// as libm's exp2f here, 5-7% faster, PERF.md). The streamed operands' layouts
// are a template parameter (four pairs); the fp32 kernels exist for DP = 48,
// 64 and 128. The gradients are written from registers through their
// strides. A warp skips a step of kTf32Sub positions that the causal mask
// hides from all of its rows.
//  - dQ, flash_bwd_dq_tf32_kernel: one CTA per (batch*head, kTf32Rows-query
//    tile), the last (heaviest) first; K and V tiles in one copy group per
//    tile; S = Q.K^T and dP = dO.V^T interleaved, then P, dS and dQ += dS.K.
//  - dK/dV, flash_bwd_dkv_tf32_kernel: one CTA per (batch*head,
//    kTf32Rows-key tile), key tile 0 first; Q and dO tiles from the diagonal
//    with their lse and delta; S^T = K.Q^T and dP^T = V.dO^T, then dV +=
//    P^T.dO and dK += dS^T.Q.
//
// What bounds them on this card: at the training shape (B=64, H=6, T=256,
// Dh=48, bf16) the dQ kernel does 6*Dh and the dK/dV kernel 8*Dh operations
// per visible pair (12.6 M pairs) against ~48 / ~57 MB of operand traffic:
// the bytes bound both functions (14.3 / 17.1 us, PERF.md). In fp32 the
// least time for fp32-accurate products is at 3xTF32, a third of the TF32
// rate (495 / 3 = 165 TFLOP/s): at B=8 the bytes bound them too (3.55 / 4.25
// us; 6.79 / 9.05 us at the 67 TFLOP/s of fp32 FMAs). The kernels are held
// back by latency instead: a CTA walks 1-4 tiles, so its first loads and its
// epilogue are a large share of its time, and registers decide how many CTAs
// per SM hide one another's waits. The designs answer with the heaviest CTAs
// first, later tiles loaded during the current tile's products, operands
// that stay in registers, and (bf16) the register caps above. In fp32 a
// warp issues three mma per 8-wide step where bf16 issues one per 16, and
// each B element costs a shared load and a split, so one warp's instruction
// stream sets the pace of its CTA: a CTA's time hardly moves from B=8 to
// B=3 (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kBlock = 64;                   // positions per streamed tile (bf16: per CTA too)
constexpr float kLog2e = 1.4426950408889634f;

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

// ------------------------------------------------------ fp32 tensor cores

constexpr int kTf32Warps = 4;                  // warps per CTA, 16 rows each
constexpr int kTf32Rows = 16 * kTf32Warps;     // queries (dQ) or keys (dK/dV) per CTA
constexpr int kTf32Threads = 32 * kTf32Warps;
constexpr int kTf32Sub = 32;                   // streamed positions per step of the products
constexpr bool kTf32HoldLo = false;            // held A fragments split once (else at each use)

// n-tiles of the head dim per pass of a gradient product: 3 or 4, as many
// independent accumulators as its B fragments' registers allow.
template <int NK>
__host__ __device__ constexpr int grad_chunk() {
  return NK % 3 == 0 ? 3 : 4;
}

// A warp's held A fragments over the head dim (NK k-steps of 8), rows r0 + g
// and r0 + g + 8 of one head: in registers up to DP = 48, split into hi and
// lo once (kTf32HoldLo) or held as fp32 and split at each use; a wider head
// reads them again from device memory (L1) at each use, so that no kernel
// spills.
template <int NK>
struct HeldA {
  static constexpr bool kRegs = NK <= 6;
  Tf32Frag<4> f[kRegs ? NK : 1];
  float x[kRegs ? NK : 1][4];
  const float* src;
  Strides s;
  int r0, seq, dh;

  __device__ __forceinline__ void load(const float* __restrict__ src_, const Strides& s_, int r0_,
                                       int seq_, int dh_) {
    src = src_, s = s_, r0 = r0_, seq = seq_, dh = dh_;
    if constexpr (kRegs) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        load_a_f32(x[kk], src, s, r0, seq, dh, kk);
        if (kTf32HoldLo) f[kk] = split_frag(x[kk]);
      }
    }
  }

  __device__ __forceinline__ Tf32Frag<4> get(int kk) const {
    if constexpr (kRegs) {
      return kTf32HoldLo ? f[kk] : split_frag(x[kk]);
    } else {
      float v[4];
      load_a_f32(v, src, s, r0, seq, dh, kk);
      return split_frag(v);
    }
  }
};

// Double-buffered K and V tiles, then each thread's running dQ sums.
template <int DP>
constexpr int dq_tf32_smem_bytes() {
  return 4 * 4 * f32_tile_floats<DP>() + kTf32Threads * DP / 2 * 4;
}

// Double-buffered Q and dO tiles, the query tiles' lse and delta ([2
// buffers][lse, delta][kBlock] floats), then each thread's running dK and
// dV sums.
template <int DP>
constexpr int dkv_tf32_smem_bytes() {
  return 4 * 4 * f32_tile_floats<DP>() + 2 * 2 * kBlock * 4 + 2 * kTf32Threads * DP / 2 * 4;
}

// L: bit 0 set where K is dh-major, bit 1 where V is (the tiles' layouts);
// mode_k and mode_v (mma_tf32.cuh) say whether their rows take 16-byte copies.
template <int DP, int L>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int heads, int seq, int dh, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Strides sdq, int mode_k,
                         int mode_v, float scale, int causal) {
  constexpr int NK = DP / 8;          // 8-wide k-steps (and n-tiles) over the head dim
  constexpr int NS = kTf32Sub / 8;    // 8-wide n-tiles over a step's keys
  constexpr int TF = f32_tile_floats<DP>();
  constexpr bool kdh = L & 1, vdh = L & 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);   // [2] K tiles
  float* vs = ks + 2 * TF;                          // [2] V tiles
  float* sums = vs + 2 * TF;                        // dQ over the finished key tiles

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTf32Rows;
  const int lane = threadIdx.x & 31;
  const int wrow = q0 + 16 * (threadIdx.x >> 5);   // this warp's first query
  const int row0 = wrow + (lane >> 2);             // this thread's queries: row0, row0 + 8
  const int t4 = lane & 3;                         // and keys t4, t4 + 4 of each 8
  const float c = scale * kLog2e;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int q_last = min(q0 + kTf32Rows, seq) - 1;
  const int n_k = ((causal ? q_last + 1 : seq) + kBlock - 1) / kBlock;

  stage_tile_f32<DP, kTf32Threads>(ks, kb, sk, mode_k, 0, seq, dh);
  stage_tile_f32<DP, kTf32Threads>(vs, vb, sv, mode_v, 0, seq, dh);
  cp_async_commit();

  const F32Reads<DP> kr(kdh), vr(vdh);
  HeldA<NK> qa, doa;
  qa.load(q + b * sq.b + h * sq.h, sq, wrow, seq, dh);
  doa.load(dout + b * sdo.b + h * sdo.h, sdo, wrow, seq, dh);
  // The two rows' lse (log2 domain) and delta; a row past seq reads neither.
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long at = static_cast<long long>(bh) * seq + row;
    lse2[i] = row < seq ? lse[at] * kLog2e : 0.f;
    dlt[i] = row < seq ? delta[at] : 0.f;
  }
  constexpr int NC = grad_chunk<NK>();
  zero_sums<NK, kTf32Threads>(sums);

  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) {
      stage_tile_f32<DP, kTf32Threads>(ks + (buf ^ 1) * TF, kb, sk, mode_k, (kt + 1) * kBlock,
                                       seq, dh);
      stage_tile_f32<DP, kTf32Threads>(vs + (buf ^ 1) * TF, vb, sv, mode_v, (kt + 1) * kBlock,
                                       seq, dh);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this tile's K and V (the next tile's in flight)
    __syncthreads();
    const float* kt_s = ks + buf * TF;
    const float* vt_s = vs + buf * TF;

#pragma unroll 1
    for (int sub = 0; sub < kBlock; sub += kTf32Sub) {
      const int key_base = kt * kBlock + sub;
      if (causal && key_base > wrow + 15) continue;   // every key after this warp's queries
      const float* k_sub = kt_s + f32_at<DP>(kdh, sub, 0);
      const float* v_sub = vt_s + f32_at<DP>(vdh, sub, 0);
      // S = Q K^T and dP = dO V^T: this warp's 16 queries x kTf32Sub keys.
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll(NK <= 6 ? NK : 2)
      for (int kk = 0; kk < NK; ++kk) {
        const Tf32Frag<4> qf = qa.get(kk), df = doa.get(kk);
        Tf32Frag<2> bk[NS], bv[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          bk[j] = f32_b_scores<DP>(k_sub, kdh, kr.scores, 8 * j, 8 * kk);
          bv[j] = f32_b_scores<DP>(v_sub, vdh, vr.scores, 8 * j, 8 * kk);
        }
        mma_3xtf32<NS, true>(s, qf, bk, dp, df, bv);
      }

      // P from the saved lse, masked only where the step meets the causal
      // diagonal or the ragged edge; dS = P (dP - delta) scale.
      const bool edge = wrow + 16 > seq ||
                        (causal ? key_base + kTf32Sub - 1 > wrow : key_base + kTf32Sub > seq);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_base + 8 * j + t4 + 4 * (e & 1);
          const int row = row0 + 8 * (e >> 1);
          const bool visible = !edge || (row < seq && (causal ? key <= row : key < seq));
          const float p = visible ? fast_exp2(fmaf(s[j][e], c, -lse2[e >> 1])) : 0.f;
          dp[j][e] = p * (dp[j][e] - dlt[e >> 1]) * scale;
        }
      }

      // dQ += dS K, dS's accumulators as A fragments: NC n-tiles of dims at
      // a time, summed over the step in fresh accumulators, then added to
      // the running sums.
      Tf32Frag<4> af[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float a[4];
        acc_a(a, dp[j]);
        af[j] = split_frag(a);
      }
#pragma unroll
      for (int n0 = 0; n0 < NK; n0 += NC) {
        float part[NC][4] = {};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          Tf32Frag<2> bg[NC];
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            bg[i] = f32_b_grads<DP>(k_sub, kdh, kr.grads, 8 * j, 8 * (n0 + i));
          }
          mma_3xtf32<NC, false>(part, af[j], bg, nullptr, af[j], bg);
        }
        add_sums<NC, kTf32Threads>(sums + 4 * n0 * kTf32Threads, part);
      }
    }
    __syncthreads();   // buffer `buf` is refilled at the next iteration
  }
  float acc[NK][4];
  load_sums<NK, kTf32Threads>(acc, sums);
  store_acc_f32<NK>(dq + b * sdq.b + h * sdq.h, sdq, wrow, seq, dh, acc);
}

// L: bit 0 set where Q is dh-major, bit 1 where dO is (the tiles' layouts);
// mode_q and mode_do say whether their rows take 16-byte copies.
template <int DP, int L>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int heads, int seq,
                          int dh, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                          Strides sdv, int mode_q, int mode_do, float scale, int causal) {
  constexpr int NK = DP / 8;          // 8-wide k-steps (and n-tiles) over the head dim
  constexpr int NQ = kTf32Sub / 8;    // 8-wide n-tiles over a step's queries
  constexpr int TF = f32_tile_floats<DP>();
  constexpr bool qdh = L & 1, odh = L & 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [2] Q tiles
  float* dos = qs + 2 * TF;                         // [2] dO tiles
  float* rows = dos + 2 * TF;                       // [2][lse, delta][kBlock]
  float* sums_k = rows + 2 * 2 * kBlock;            // dK and dV over the finished query tiles
  float* sums_v = sums_k + kTf32Threads * NK * 4;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int k0 = blockIdx.y * kTf32Rows;
  const int lane = threadIdx.x & 31;
  const int wkey = k0 + 16 * (threadIdx.x >> 5);   // this warp's first key
  const int key0 = wkey + (lane >> 2);             // this thread's keys: key0, key0 + 8
  const int t4 = lane & 3;                         // and queries t4, t4 + 4 of each 8
  const float c = scale * kLog2e;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const long long row_base = static_cast<long long>(bh) * seq;
  const int n_q = (seq + kBlock - 1) / kBlock;
  const int first = causal ? k0 / kBlock : 0;

  // Query tile qt's Q, dO, lse and delta into buffer `buf`.
  auto stage_queries = [&](int qt, int buf) {
    const int q0 = qt * kBlock;
    stage_tile_f32<DP, kTf32Threads>(qs + buf * TF, qb, sq, mode_q, q0, seq, dh);
    stage_tile_f32<DP, kTf32Threads>(dos + buf * TF, dob, sdo, mode_do, q0, seq, dh);
    for (int i = threadIdx.x; i < 2 * kBlock; i += kTf32Threads) {
      const int pos = q0 + i % kBlock;
      const float* src = (i < kBlock ? lse : delta) + row_base + pos;
      cp_async_4(smem_u32(rows + buf * 2 * kBlock + i), pos < seq ? src : lse,
                 pos < seq ? 4 : 0);
    }
  };
  stage_queries(first, 0);
  cp_async_commit();

  const F32Reads<DP> qr(qdh), dr(odh);
  HeldA<NK> ka, va;
  ka.load(k + b * sk.b + h * sk.h, sk, wkey, seq, dh);
  va.load(v + b * sv.b + h * sv.h, sv, wkey, seq, dh);
  constexpr int NC = grad_chunk<NK>();
  zero_sums<NK, kTf32Threads>(sums_k);
  zero_sums<NK, kTf32Threads>(sums_v);

  for (int qt = first; qt < n_q; ++qt) {
    const int buf = (qt - first) & 1;
    if (qt + 1 < n_q) stage_queries(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // everything but the tile just requested
    __syncthreads();
    const int q0 = qt * kBlock;
    const float* qt_s = qs + buf * TF;
    const float* dt_s = dos + buf * TF;
    const float* lse_t = rows + buf * 2 * kBlock;
    const float* delta_t = lse_t + kBlock;

#pragma unroll 1
    for (int sub = 0; sub < kBlock; sub += kTf32Sub) {
      if (causal && wkey > q0 + sub + kTf32Sub - 1) continue;   // every query before these keys
      const float* q_sub = qt_s + f32_at<DP>(qdh, sub, 0);
      const float* d_sub = dt_s + f32_at<DP>(odh, sub, 0);
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kTf32Sub queries.
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
#pragma unroll(NK <= 6 ? NK : 2)
      for (int kk = 0; kk < NK; ++kk) {
        const Tf32Frag<4> kf = ka.get(kk), vf = va.get(kk);
        Tf32Frag<2> bq[NQ], bo[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          bq[j] = f32_b_scores<DP>(q_sub, qdh, qr.scores, 8 * j, 8 * kk);
          bo[j] = f32_b_scores<DP>(d_sub, odh, dr.scores, 8 * j, 8 * kk);
        }
        mma_3xtf32<NQ, true>(st, kf, bq, dpt, vf, bo);
      }

      // P^T from the saved lse, masked; dS^T = P^T (dP^T - delta) scale.
      const bool edge = q0 + sub + kTf32Sub > seq ||
                        (causal ? wkey + 15 > q0 + sub : wkey + 16 > seq);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = sub + 8 * j + t4 + 4 * (e & 1);
          const int qpos = q0 + qc;
          const int kpos = key0 + 8 * (e >> 1);
          const bool visible = !edge || (qpos < seq && (causal ? kpos <= qpos : kpos < seq));
          const float p = visible ? fast_exp2(fmaf(st[j][e], c, -lse_t[qc] * kLog2e)) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - delta_t[qc]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, their accumulators as A fragments:
      // NC n-tiles of dims at a time, summed over the step in fresh
      // accumulators, then added to the running sums.
      Tf32Frag<4> pf[NQ], df[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float a[4];
        acc_a(a, st[j]);
        pf[j] = split_frag(a);
        acc_a(a, dpt[j]);
        df[j] = split_frag(a);
      }
#pragma unroll
      for (int n0 = 0; n0 < NK; n0 += NC) {
        float part_v[NC][4] = {}, part_k[NC][4] = {};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          Tf32Frag<2> bo[NC], bq[NC];
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            bo[i] = f32_b_grads<DP>(d_sub, odh, dr.grads, 8 * j, 8 * (n0 + i));
            bq[i] = f32_b_grads<DP>(q_sub, qdh, qr.grads, 8 * j, 8 * (n0 + i));
          }
          mma_3xtf32<NC, true>(part_v, pf[j], bo, part_k, df[j], bq);
        }
        add_sums<NC, kTf32Threads>(sums_v + 4 * n0 * kTf32Threads, part_v);
        add_sums<NC, kTf32Threads>(sums_k + 4 * n0 * kTf32Threads, part_k);
      }
    }
    __syncthreads();   // buffer `buf` is refilled at the next iteration
  }
  float acc[NK][4];
  load_sums<NK, kTf32Threads>(acc, sums_k);
  store_acc_f32<NK>(dk + b * sdk.b + h * sdk.h, sdk, wkey, seq, dh, acc);
  load_sums<NK, kTf32Threads>(acc, sums_v);
  store_acc_f32<NK>(dv + b * sdv.b + h * sdv.h, sdv, wkey, seq, dh, acc);
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

template <int DP, int L>
cudaError_t launch_dq_tf32_l(const Args& a, int m0, int m1, cudaStream_t stream) {
  constexpr int smem = dq_tf32_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tf32_kernel<DP, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kTf32Rows - 1) / kTf32Rows);
  flash_bwd_dq_tf32_kernel<DP, L><<<grid, kTf32Threads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.g0), a.heads, a.seq, a.dh, a.s[0], a.s[1], a.s[2], a.s[3], a.s[4], m0,
      m1, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DP, int L>
cudaError_t launch_dkv_tf32_l(const Args& a, int m0, int m1, cudaStream_t stream) {
  constexpr int smem = dkv_tf32_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tf32_kernel<DP, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + kTf32Rows - 1) / kTf32Rows);
  flash_bwd_dkv_tf32_kernel<DP, L><<<grid, kTf32Threads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.g0), static_cast<float*>(a.g1), a.heads, a.seq, a.dh, a.s[0], a.s[1],
      a.s[2], a.s[3], a.s[4], a.s[5], m0, m1, a.scale, a.causal);
  return cudaGetLastError();
}

// The fp32 kernels' layout parameter from the modes of their two streamed
// operands (dQ: k and v; dK/dV: q and dO).
template <int DP, bool DQ>
cudaError_t launch_tf32(const Args& a, cudaStream_t st) {
  const int i0 = DQ ? 1 : 0, i1 = DQ ? 2 : 3;
  const void* p[4] = {a.q, a.k, a.v, a.dout};
  const int m0 = operand_mode_f32(p[i0], a.s[i0], a.seq, a.dh);
  const int m1 = operand_mode_f32(p[i1], a.s[i1], a.seq, a.dh);
  auto go = [&](auto l) {
    constexpr int L = decltype(l)::value;
    if constexpr (DQ) {
      return launch_dq_tf32_l<DP, L>(a, m0, m1, st);
    } else {
      return launch_dkv_tf32_l<DP, L>(a, m0, m1, st);
    }
  };
  switch ((m0 & kDhMajor) | ((m1 & kDhMajor) << 1)) {
    case 0: return go(std::integral_constant<int, 0>{});
    case 1: return go(std::integral_constant<int, 1>{});
    case 2: return go(std::integral_constant<int, 2>{});
    default: return go(std::integral_constant<int, 3>{});
  }
}

// bf16: the bf16 tensor-core kernels; fp32: the 3xTF32 ones.
// The fp32 kernels exist for DP = 48, 64 and 128 (a head is padded to the
// next): each takes seconds to compile, four layouts of each, and the build
// shares the host with chip_smoke.py's phases 8 and 9.
template <int DP>
cudaError_t launch(const Args& a, bool bf, bool is_dq, cudaStream_t st) {
  constexpr int F = DP <= 48 ? 48 : (DP <= 64 ? 64 : 128);
  if (is_dq) return bf ? launch_dq_mma<DP>(a, st) : launch_tf32<F, true>(a, st);
  return bf ? launch_dkv_mma<DP>(a, st) : launch_tf32<F, false>(a, st);
}

int run(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, void* g0, void* g1, int is_bf16, int batch, int heads, int seq,
        int dh, const long long* strides, int n_ops, float scale, int causal, void* stream,
        bool is_dq) {
  const int rows = is_bf16 ? kBlock : kTf32Rows;   // per CTA
  if (batch < 1 || heads < 1 || seq < 1 || dh < 1 || dh > 128 || (seq + rows - 1) / rows > 65535) {
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
