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
// fp32: flash_fwd_tf32_kernel, on the tensor cores in 3xTF32 (mma_tf32.cuh):
// each product of two fp32 operands is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on
// mma.sync m16n8k8 TF32, hi the operand with its low 13 bits cleared and lo
// the remainder (one TF32 product puts out ~2e-3 off fp32; three keep it
// within a few 1e-6, inside the fp32 limit of 1e-4). The CTA is the bf16
// kernel's: 4 warps of 16 query rows per (batch*head, 64-query tile), the
// heaviest first. Q's A fragments are read once from device memory through
// its strides and held in registers, split into hi and lo (DP <= 48; a wider
// head reads them from L1 at each use). K and V tiles of 64 keys are
// double-buffered with cp.async in mma_tf32.cuh's padded fp32 layouts (one
// copy group per tile) and their B fragments split as they are read (hi and
// lo tiles split once per CTA ran slower on the card: PERF.md).
// Per step of 32 keys (two to a tile): S = Q.K^T (score columns hold
// permuted keys, so S's accumulators are, as they are, the A fragments of
// P.V), the scale log2(e)/sqrt(Dh) on the fp32 scores, masks only on edge
// steps, the online softmax on the accumulator rows (fast_exp2), then P.V
// into fresh accumulators, a few n-tiles of O at a time: the tensor cores'
// sums truncate, so no accumulator lives across steps. The running O is
// rescaled by alpha and the step's P.V added to it, each in rounded fp32.
// (A build of 64-key steps with one fmaf per update ran faster: PERF.md,
// ROADMAP.md.) Each 3xTF32 product is three passes over independent
// accumulators. The epilogue writes out and lse from registers through
// their strides. The layout of K and V is a template parameter (both
// row-major, both dh-major, or each read at run time); the kernel exists for
// DP = 48, 64 and 128 (a narrower head is padded up to the next).
//
// What bounds them on this card: at the training shape (B=64, H=6, T=256,
// Dh=48, bf16) the function moves ~38 MB (q, k, v, out, lse) against
// 2.4 GFLOP of tensor-core work, so bytes bound it (11.4 us at 3.35 TB/s).
// The kernel is held back by latency instead: each CTA walks at most 4 key
// tiles, so its first loads and its epilogue are a large share of its time,
// and the double buffer hides later loads only in part. In fp32 the bytes
// bound it too at B=8 (2.83 us; 1.84 us of operations at 3xTF32's third of
// the TF32 rate), and the heaviest CTA's walk holds it back more: a warp
// issues three mma per 8-wide step, and a shared load and a split per B
// element (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kBlockQ = 64;                  // query rows per CTA
constexpr int kBlockK = 64;                  // keys per tile
constexpr float kNegInf = -1e30f;            // finite, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------ fp32 tensor cores

constexpr int kTf32Threads = 128;    // 4 warps x 16 query rows
constexpr int kTf32Sub = 32;         // keys per step of the products: half a tile

// The fp32 kernel's head dims: a head is padded up to the next.
__host__ __device__ constexpr int tf32_dp(int dp) { return dp <= 48 ? 48 : (dp <= 64 ? 64 : 128); }

// Double-buffered K and V tiles.
template <int DP>
constexpr int fwd_tf32_smem_bytes() {
  return 4 * 4 * f32_tile_floats<DP>();
}

// L: the layout of K and V (mma_bf16.cuh's layout parameter: both
// row-major, both dh-major, or each read from mode_k / mode_v at run time);
// mode_k and mode_v also say whether their rows take 16-byte copies. Q is
// read, and out written, through their strides. One CTA per SM is all the
// launch bound asks: without it ptxas fits DP = 48 into 168 registers (3
// CTAs per SM) with a spill, and takes 217 with it (PERF.md).
template <int DP, int L>
__global__ void __launch_bounds__(kTf32Threads, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                      int heads, int seq, int dh, Strides sq, Strides sk, Strides sv, Strides so,
                      int mode_k, int mode_v, float scale, int causal) {
  constexpr int NK = DP / 8;          // 8-wide k-steps over the head dim (and n-tiles of O)
  constexpr int NS = kTf32Sub / 8;    // 8-wide n-tiles over a step's keys
  constexpr int NC = NK <= 6 ? NK : grad_chunk<NK>();   // n-tiles of O per pass of P.V
  constexpr int TF = f32_tile_floats<DP>();
  const bool kdh = view_mode<L>(mode_k) & kDhMajor;
  const bool vdh = view_mode<L>(mode_v) & kDhMajor;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);   // [2] K tiles
  float* vs = ks + 2 * TF;                          // [2] V tiles

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int lane = threadIdx.x & 31;
  const int wrow = q0 + 16 * (threadIdx.x >> 5);   // this warp's first query
  const int row0 = wrow + (lane >> 2);             // this thread's queries: row0, row0 + 8
  const int t4 = lane & 3;                         // and keys t4, t4 + 4 of each 8
  const float c = scale * kLog2e;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int q_last = min(q0 + kBlockQ, seq) - 1;
  const int n_k = ((causal ? q_last + 1 : seq) + kBlockK - 1) / kBlockK;

  stage_tile_f32<DP, kTf32Threads>(ks, kb, sk, mode_k, 0, seq, dh);
  stage_tile_f32<DP, kTf32Threads>(vs, vb, sv, mode_v, 0, seq, dh);
  cp_async_commit();

  const F32Reads<DP> kr(kdh), vr(vdh);
  HeldA<NK, true> qa;   // Q split once (DP <= 48)
  qa.load(q + b * sq.b + h * sq.h, sq, wrow, seq, dh);
  float m[2] = {kNegInf, kNegInf};   // running max, log2 domain, quad-uniform
  float l[2] = {0.f, 0.f};           // this thread's share of the running sum
  float acc[NK][4];                  // O, rescaled and summed in rounded fp32
#pragma unroll
  for (int n = 0; n < NK; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) {
      stage_tile_f32<DP, kTf32Threads>(ks + (buf ^ 1) * TF, kb, sk, mode_k, (kt + 1) * kBlockK,
                                       seq, dh);
      stage_tile_f32<DP, kTf32Threads>(vs + (buf ^ 1) * TF, vb, sv, mode_v, (kt + 1) * kBlockK,
                                       seq, dh);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this tile's K and V (the next tile's in flight)
    __syncthreads();
    const float* kt_s = ks + buf * TF;
    const float* vt_s = vs + buf * TF;

#pragma unroll 1
    for (int sub = 0; sub < kBlockK; sub += kTf32Sub) {
      const int key_base = kt * kBlockK + sub;
      // Rows past seq, and keys after every one of this warp's rows, are skipped.
      if (wrow >= seq || (causal && key_base > wrow + 15)) continue;
      const int k_at = f32_at<DP>(kdh, sub, 0), v_at = f32_at<DP>(vdh, sub, 0);
      // S = Q K^T: this warp's 16 queries x kTf32Sub keys.
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll(NK <= 6 ? NK : 2)
      for (int kk = 0; kk < NK; ++kk) {
        const Tf32Frag<4> qf = qa.get(kk);
        Tf32Frag<2> bk[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          bk[j] = f32_b_scores<DP>(kt_s + k_at, kdh, kr.scores, 8 * j, 8 * kk);
        }
        mma_3xtf32<NS, false>(s, qf, bk, nullptr, qf, bk);
      }

      // Scale to the log2 domain; mask only where the step meets the causal
      // diagonal or the ragged edge.
      const bool edge = wrow + 16 > seq ||
                        (causal ? key_base + kTf32Sub - 1 > wrow : key_base + kTf32Sub > seq);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_base + 8 * j + t4 + 4 * (e & 1);
          const int row = row0 + 8 * (e >> 1);
          const bool visible = !edge || (row < seq && (causal ? key <= row : key < seq));
          s[j][e] = visible ? s[j][e] * c : kNegInf;
        }
      }

      // Online softmax on the two rows this thread holds.
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = fast_exp2(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float p = s[j][e] == kNegInf ? 0.f : fast_exp2(s[j][e] - m_new);
            s[j][e] = p;
            sum += p;
          }
        }
        l[i] = l[i] * alpha[i] + sum;
      }

      // O = O alpha + P V, P's accumulators as A fragments: NC n-tiles of
      // dims at a time, summed over the step in fresh accumulators.
      Tf32Frag<4> pf[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float a[4];
        acc_a(a, s[j]);
        pf[j] = split_frag(a);
      }
#pragma unroll
      for (int n0 = 0; n0 < NK; n0 += NC) {
        float part[NC][4] = {};
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          Tf32Frag<2> bv[NC];
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            bv[i] = f32_b_grads<DP>(vt_s + v_at, vdh, vr.grads, 8 * j, 8 * (n0 + i));
          }
          mma_3xtf32<NC, false>(part, pf[j], bv, nullptr, pf[j], bv);
        }
#pragma unroll
        for (int i = 0; i < NC; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[n0 + i][e] = __fadd_rn(__fmul_rn(acc[n0 + i][e], alpha[e >> 1]), part[i][e]);
          }
        }
      }
    }
    __syncthreads();   // buffer `buf` is refilled at the next iteration
  }

  // Epilogue: the row sums over the quad, O / l and lse through strides.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float safe = (l[i] == 0.f) ? 1.f : l[i];
    const int row = row0 + 8 * i;
    if (t4 == 0 && row < seq) {
      lse[static_cast<long long>(bh) * seq + row] = m[i] * kLn2 + logf(safe);
    }
    const float inv = 1.f / safe;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      acc[n][2 * i] *= inv;
      acc[n][2 * i + 1] *= inv;
    }
  }
  store_acc_f32<NK>(o + b * so.b + h * so.h, so, wrow, seq, dh, acc);
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

template <int DP, int L>
cudaError_t launch_tf32_l(const void* q, const void* k, const void* v, void* o, float* lse,
                          int batch, int heads, int seq, int dh, const Strides* s, int mode_k,
                          int mode_v, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = fwd_tf32_smem_bytes<DP>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<DP, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  flash_fwd_tf32_kernel<DP, L><<<grid, kTf32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, heads, seq, dh, s[0], s[1], s[2], s[3], mode_k, mode_v, scale,
      causal);
  return cudaGetLastError();
}

// The fp32 kernel for head dim DP (48, 64 or 128), its layout parameter from
// the modes of K and V.
template <int DP>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse,
                        int batch, int heads, int seq, int dh, const Strides* s, float scale,
                        int causal, cudaStream_t stream) {
  const int mk = operand_mode_f32(k, s[1], seq, dh), mv = operand_mode_f32(v, s[2], seq, dh);
  const int lk = mk & kDhMajor;
  auto run = (mv & kDhMajor) != lk ? launch_tf32_l<DP, kAnyLayout>
             : lk                  ? launch_tf32_l<DP, kDhMajor>
                                   : launch_tf32_l<DP, 0>;
  return run(q, k, v, o, lse, batch, heads, seq, dh, s, mk, mv, scale, causal, stream);
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
              : launch_tf32<tf32_dp(16 * n)>(q, k, v, o, lse, batch, heads, seq, dh, s,  \
                                             scale, causal, st);
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
