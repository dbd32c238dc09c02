// Tensor-core building blocks for the port's fp32 attention kernels (the
// forward, dQ and dK/dV) on Hopper (sm_90a): mma.sync m16n8k8 on TF32 operands with fp32
// accumulators, the split of an fp32 value into TF32 hi and lo parts for
// 3xTF32 products (a.b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, within a few
// units of fp32's last place, where one TF32 product keeps ~3 digits), and
// fp32 tiles in shared memory that both fragment reads of a streamed operand
// find free of bank conflicts.
//
// Fragments of mma.m16n8k8 .tf32 (lane = 4 g + t, so g = lane / 4,
// t = lane % 4), one element per 32-bit register:
//   A 16 x 8 (m, k): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8 x 8 (k, n):  b0 (t, g), b1 (t + 4, g)
//   C 16 x 8 fp32:   c0, c1 (g, 2t and 2t + 1), c2, c3 (g + 8, 2t and 2t + 1)
// An accumulator's columns (2t, 2t + 1) are not the A fragment's k slots
// (t, t + 4). So a score tile's B operand loads, in its column n, position
// key_of(n) = n / 2 + 4 (n % 2) of the 8: column 2t then holds position t
// and column 2t + 1 position t + 4, and the accumulator {c0, c2, c1, c3} is
// the A fragment of the next product over those 8 positions (acc_a), whose
// B rows are positions t and t + 4 in their natural order. No shuffles.
//
// Tiles. A tile holds positions [t0, t0 + 64) of one (batch, head) and head
// dims [0, DP), DP = Dh rounded up to 16, as fp32 in the operand's own
// contiguous order, so cp.async moves 16-byte groups of 4 elements:
// row-major (dims at stride 1) [64][DP + 4], dh-major (positions at stride
// 1) [DP][72]. A warp reads a tile two ways: as a score product's B (8
// positions key_of(g) x dims t, t + 4: f32_b_scores) and as a gradient
// product's B (positions t, t + 4 x 8 dims g: f32_b_grads). The pitches
// give the score reads, two thirds of the dQ kernel's, a bank per lane; the
// gradient reads meet two lanes per bank. The index of an element is linear
// in its position and dim, so each read is a shared load at a lane's base
// (F32Reads) plus an offset known at compile time: an XOR swizzle that
// freed both reads cost ~10 integer instructions per load in address
// arithmetic (PERF.md). Elements past seq or dh are zero.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// d += a * b on the tensor cores: A 16 x 8 TF32, B 8 x 8 TF32, D fp32. The
// tensor cores read the top 19 bits of each operand (sign, exponent, 10
// mantissa bits) and ignore the low 13, and their fp32 additions truncate:
// a sum over many products drifts one way, so the kernels sum each tile in
// fresh accumulators and add the tiles in rounded fp32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo exactly: hi is x with its low 13 bits cleared (TF32, toward
// zero), lo the remainder, below one TF32 unit of x (the tensor cores read
// lo's top 11 significant bits: x to ~2^-21 of itself). Rounding hi to
// nearest instead (cvt.rna.tf32.f32) costs two more instructions per value
// and halves that error (PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An A or B fragment as TF32 hi and lo parts.
template <int N>
struct Tf32Frag {
  uint32_t h[N], l[N];
};

template <int N>
__device__ __forceinline__ Tf32Frag<N> split_frag(const float (&x)[N]) {
  Tf32Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], f.h[i], f.l[i]);
  return f;
}

// d[i] += a * b[i] (i < N), and the same for a second set (d2, a2, b2),
// at about fp32 accuracy: the two small cross terms first (a_lo b_hi,
// a_hi b_lo), then the large one, each as a pass over all the independent
// accumulators, so that no mma waits on the one issued just before it.
// -DDDL_TF32_HI_ONLY keeps a_hi b_hi alone (one TF32 product; the
// emulation's negative case).
template <int N, bool kTwo>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4], const Tf32Frag<4>& a,
                                           const Tf32Frag<2>* b, float (*d2)[4],
                                           const Tf32Frag<4>& a2, const Tf32Frag<2>* b2) {
#ifndef DDL_TF32_HI_ONLY
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(d[i], a.l, b[i].h[0], b[i].h[1]);
    if (kTwo) mma_tf32(d2[i], a2.l, b2[i].h[0], b2[i].h[1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(d[i], a.h, b[i].l[0], b[i].l[1]);
    if (kTwo) mma_tf32(d2[i], a2.h, b2[i].l[0], b2[i].l[1]);
  }
#endif
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(d[i], a.h, b[i].h[0], b[i].h[1]);
    if (kTwo) mma_tf32(d2[i], a2.h, b2[i].h[0], b2[i].h[1]);
  }
}

// The A fragment of one 8-wide k-step from a score accumulator whose B
// columns held positions key_of(n) (see the top of this file).
__device__ __forceinline__ void acc_a(float (&a)[4], const float (&c)[4]) {
  a[0] = c[0];
  a[1] = c[2];
  a[2] = c[1];
  a[3] = c[3];
}

// The position a score product's B column n holds, of 8.
__device__ __forceinline__ int key_of(int n) { return (n >> 1) + 4 * (n & 1); }

constexpr int kF32PosPitch = kTileT + 8;   // row pitch of a dh-major fp32 tile

template <int DP>
__host__ __device__ constexpr int f32_dim_pitch() { return DP + 4; }   // row-major

template <int DP>
__host__ __device__ constexpr int f32_tile_floats() {
  return kTileT * f32_dim_pitch<DP>() > DP * kF32PosPitch ? kTileT * f32_dim_pitch<DP>()
                                                          : DP * kF32PosPitch;
}

// The index of element (p, d) in a tile laid out dh-major (dhm) or row-major.
template <int DP>
__device__ __forceinline__ int f32_at(bool dhm, int p, int d) {
  return dhm ? d * kF32PosPitch + p : p * f32_dim_pitch<DP>() + d;
}

// A lane's bases of its two fragment reads of a tile in one layout.
template <int DP>
struct F32Reads {
  int scores, grads;

  __device__ __forceinline__ explicit F32Reads(bool dhm) {
    const int lane = threadIdx.x & 31;
    scores = f32_at<DP>(dhm, key_of(lane >> 2), lane & 3);
    grads = f32_at<DP>(dhm, lane & 3, lane >> 2);
  }
};

// The mode (mma_bf16.cuh) of an fp32 operand with origin p and strides s:
// kVec where its rows are 16-byte aligned. An operand with neither positions
// nor dims at stride 1 takes the element path in row-major order.
inline int operand_mode_f32(const void* p, const Strides& s, int seq, int dh) {
  int mode;
  if (s.d == 1 || dh == 1) {
    mode = 0;
  } else if (s.t == 1 || seq == 1) {
    mode = kDhMajor;
  } else {
    return 0;
  }
  const long long row = (mode & kDhMajor) ? s.d : s.t;
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 && s.h % 4 == 0 && row % 4 == 0) {
    mode |= kVec;
  }
  return mode;
}

// Positions [t0, t0 + 64) of one head's fp32 operand (src at its (b, h)
// origin) into a tile: 16-byte cp.async where mode has kVec, else 4-byte
// cp.async per element; zero past seq and dh.
template <int DP, int NT>
__device__ __forceinline__ void stage_tile_f32(float* tile, const float* __restrict__ src,
                                               const Strides& s, int mode, int t0, int seq,
                                               int dh) {
  const bool dhm = mode & kDhMajor;
  if (mode & kVec) {
    if (dhm) {
      for (int idx = threadIdx.x; idx < DP * (kTileT / 4); idx += NT) {
        const int d = idx / (kTileT / 4);
        const int p0 = (idx % (kTileT / 4)) * 4;
        const int pos = t0 + p0;
        const int bytes = (d < dh && pos < seq) ? min(16, (seq - pos) * 4) : 0;
        cp_async_16(smem_u32(tile + f32_at<DP>(true, p0, d)), bytes ? src + d * s.d + pos : src,
                    bytes);
      }
    } else {
      for (int idx = threadIdx.x; idx < kTileT * (DP / 4); idx += NT) {
        const int t = idx / (DP / 4);
        const int d0 = (idx % (DP / 4)) * 4;
        const int pos = t0 + t;
        const int bytes = (pos < seq && d0 < dh) ? min(16, (dh - d0) * 4) : 0;
        cp_async_16(smem_u32(tile + f32_at<DP>(false, t, d0)),
                    bytes ? src + pos * s.t + d0 : src, bytes);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kTileT * DP; idx += NT) {
    const int t = dhm ? idx % kTileT : idx / DP;
    const int d = dhm ? idx / kTileT : idx % DP;
    const int pos = t0 + t;
    const bool in = pos < seq && d < dh;
    cp_async_4(smem_u32(tile + f32_at<DP>(dhm, t, d)), in ? src + pos * s.t + d * s.d : src,
               in ? 4 : 0);
  }
}

// A score product's B fragment from a tile: positions p0 + key_of(g), dims
// d0 + t and d0 + t + 4 (p0, d0 multiples of 8; base: F32Reads::scores).
template <int DP>
__device__ __forceinline__ Tf32Frag<2> f32_b_scores(const float* tile, bool dhm, int base,
                                                    int p0, int d0) {
  const float x[2] = {tile[base + f32_at<DP>(dhm, p0, d0)],
                      tile[base + f32_at<DP>(dhm, p0, d0 + 4)]};
  return split_frag(x);
}

// A gradient product's B fragment from a tile: positions p0 + t and
// p0 + t + 4, dims d0 + g (p0, d0 multiples of 8; base: F32Reads::grads).
// The forward's O += P.V reads V this way too.
template <int DP>
__device__ __forceinline__ Tf32Frag<2> f32_b_grads(const float* tile, bool dhm, int base, int p0,
                                                   int d0) {
  const float x[2] = {tile[base + f32_at<DP>(dhm, p0, d0)],
                      tile[base + f32_at<DP>(dhm, p0 + 4, d0)]};
  return split_frag(x);
}

// A warp's A fragment of k-step kk over the head dim (dims 8 kk + t and
// 8 kk + t + 4) of rows r0 + g and r0 + g + 8 of one head's fp32 operand,
// read through its strides from device memory; zero past seq and dh.
__device__ __forceinline__ void load_a_f32(float (&x)[4], const float* __restrict__ src,
                                           const Strides& s, int r0, int seq, int dh, int kk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r0 + (lane >> 2) + 8 * (e & 1);
    const int d = 8 * kk + (lane & 3) + 4 * (e >> 1);
    x[e] = (row < seq && d < dh) ? src[row * s.t + d * s.d] : 0.f;
  }
}

// n-tiles of the head dim per pass of a product into the head dim: 3 or 4,
// as many independent accumulators as its B fragments' registers allow.
template <int NK>
__host__ __device__ constexpr int grad_chunk() {
  return NK % 3 == 0 ? 3 : 4;
}

// A warp's held A fragments over the head dim (NK k-steps of 8), rows r0 + g
// and r0 + g + 8 of one head: in registers up to DP = 48, split into hi and
// lo once (kHoldLo) or held as fp32 and split at each use; a wider head
// reads them again from device memory (L1) at each use, so that no kernel
// spills.
template <int NK, bool kHoldLo>
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
        if (kHoldLo) f[kk] = split_frag(x[kk]);
      }
    }
  }

  __device__ __forceinline__ Tf32Frag<4> get(int kk) const {
    if constexpr (kRegs) {
      return kHoldLo ? f[kk] : split_frag(x[kk]);
    } else {
      float v[4];
      load_a_f32(v, src, s, r0, seq, dh, kk);
      return split_frag(v);
    }
  }
};

// A thread's running sums of ND accumulator fragments, kept in shared memory
// (element (n, e) at sums[(4 n + e) NT + threadIdx.x]: a warp's lanes on
// consecutive words) so that they hold no registers while a tile is summed:
// zeroed, then a tile's fresh accumulators added in rounded fp32.
template <int ND, int NT>
__device__ __forceinline__ void zero_sums(float* sums) {
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) sums[i * NT + threadIdx.x] = 0.f;
}

template <int ND, int NT>
__device__ __forceinline__ void add_sums(float* sums, const float (&part)[ND][4]) {
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sums[(4 * n + e) * NT + threadIdx.x] += part[n][e];
  }
}

template <int ND, int NT>
__device__ __forceinline__ void load_sums(float (&acc)[ND][4], const float* sums) {
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = sums[(4 * n + e) * NT + threadIdx.x];
  }
}

// A warp's 16 x DP fp32 accumulator (rows r0 + g and r0 + g + 8, n-tiles of
// 8 dims) to one head's gradient through its strides; rows past seq and
// dims past dh are skipped.
template <int ND>
__device__ __forceinline__ void store_acc_f32(float* __restrict__ dst, const Strides& s, int r0,
                                              int seq, int dh, const float (&acc)[ND][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (lane >> 2) + 8 * (e >> 1);
      const int d = 8 * n + 2 * (lane & 3) + (e & 1);
      if (row < seq && d < dh) dst[row * s.t + d * s.d] = acc[n][e];
    }
  }
}

}  // namespace
