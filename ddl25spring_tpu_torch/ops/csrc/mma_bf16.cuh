// Tensor-core building blocks for the port's bf16 attention kernels on
// Hopper (sm_90a): ldmatrix, mma.sync m16n8k16 (bf16 operands, fp32
// accumulators), packing an fp32 accumulator fragment into a bf16 A
// fragment, cp.async copies with zero-fill, and the staging of one 64-row
// tile of a head between device memory and shared memory.
//
// Fragments of mma.m16n8k16 (lane = 4 g + t, so g = lane / 4, t = lane % 4),
// each 32-bit register holding two bf16 adjacent along k:
//   A 16 x 16 (m, k): a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8), a3 (g + 8, 2t + 8)
//   B 16 x 8 (k, n):  b0 (2t, g), b1 (2t + 8, g)
//   C 16 x 8 fp32:    c0, c1 (g, 2t and 2t + 1), c2, c3 (g + 8, 2t and 2t + 1)
// The C fragments of two adjacent n-tiles, packed to bf16, are therefore the
// A fragment of one 16-wide k-step (acc_to_a), so a product of scores (P,
// dS) with the next operand never goes through shared memory.
//
// Tiles. A tile holds positions [t0, t0 + 64) of one (batch, head) and the
// head dims [0, DP), DP = Dh rounded up to 16, in the operand's own
// contiguous order: [64][DP + 8] when dims have stride 1 (row-major
// [B, T, H, Dh]), [DP][72] when positions do (dh-major [B*H, Dh, T]). Both
// pitches are an odd number of 16-byte units, so the eight rows an ldmatrix
// phase reads fall in distinct banks. Elements past seq or dh are zero.
// A tile is staged with 16-byte cp.async where the operand is aligned for
// it, else with element loads into the same layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, t, d;
};

constexpr int kTileT = 64;               // positions per tile
constexpr int kPosPitch = kTileT + 8;    // row pitch of a dh-major tile

template <int DP>
__host__ __device__ constexpr int dim_pitch() { return DP + 8; }   // row pitch, row-major tile

template <int DP>
__host__ __device__ constexpr int tile_elems() {
  return kTileT * dim_pitch<DP>() > DP * kPosPitch ? kTileT * dim_pitch<DP>() : DP * kPosPitch;
}

// How an operand lies in device memory, decided once on the host.
constexpr int kDhMajor = 1;   // positions have stride 1 (else dims do)
constexpr int kVec = 2;       // 16-byte aligned rows: cp.async / uint4 stores

// A kernel's layout parameter L for the operands it reads with ldmatrix:
// all row-major (0), all dh-major (kDhMajor), or each its own, read from
// its mode at run time (kAnyLayout). A fixed layout lets the compiler fold
// the choice of ldmatrix and the tile addressing (in the dK/dV kernel: 166
// registers instead of 180, 3 CTAs per SM instead of 2). view_mode<L>(mode)
// is the mode a TileView is built with.
constexpr int kAnyLayout = 2;

template <int L>
__device__ __forceinline__ int view_mode(int mode) {
  return L == kAnyLayout ? mode : L;
}

// The mode of an operand with origin p and strides s, or -1 where neither
// positions nor dims have stride 1. A size-1 axis counts as stride 1.
inline int operand_mode(const void* p, const Strides& s, int seq, int dh) {
  int mode;
  if (s.d == 1 || dh == 1) {
    mode = 0;
  } else if (s.t == 1 || seq == 1) {
    mode = kDhMajor;
  } else {
    return -1;
  }
  const long long row = (mode & kDhMajor) ? s.d : s.t;
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 && row % 8 == 0) {
    mode |= kVec;
  }
  return mode;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b on the tensor cores: A 16 x 16 bf16, B 16 x 8 bf16, D fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit, a subnormal result flushed to zero (a
// probability below 2^-126 adds nothing to a sum whose largest term is 1).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of one 16-wide k-step from the fp32 accumulators of the
// two 8-wide n-tiles that cover it.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Copy `bytes` (0..16) of src to the 16 bytes at dst and zero the rest.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

// Copy `bytes` (0 or 4) of src to the 4 bytes at dst and zero the rest.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Positions [t0, t0 + 64) of one head's operand (src at its (b, h) origin,
// element strides s.t and s.d) into a tile (see the top of this file).
template <int DP, int NT>
__device__ __forceinline__ void stage_tile(bf16* tile, const bf16* __restrict__ src,
                                           const Strides& s, int mode, int t0, int seq, int dh) {
  constexpr int DPP = dim_pitch<DP>();
  if (mode & kVec) {
    if (mode & kDhMajor) {
      for (int idx = threadIdx.x; idx < DP * (kTileT / 8); idx += NT) {
        const int d = idx / (kTileT / 8);
        const int p0 = (idx % (kTileT / 8)) * 8;
        const int pos = t0 + p0;
        const int bytes = (d < dh && pos < seq) ? min(16, (seq - pos) * 2) : 0;
        cp_async_16(smem_u32(tile + d * kPosPitch + p0), bytes ? src + d * s.d + pos : src,
                    bytes);
      }
    } else {
      for (int idx = threadIdx.x; idx < kTileT * (DP / 8); idx += NT) {
        const int t = idx / (DP / 8);
        const int d0 = (idx % (DP / 8)) * 8;
        const int pos = t0 + t;
        const int bytes = (pos < seq && d0 < dh) ? min(16, (dh - d0) * 2) : 0;
        cp_async_16(smem_u32(tile + t * DPP + d0), bytes ? src + pos * s.t + d0 : src, bytes);
      }
    }
    return;
  }
  const bool dhm = mode & kDhMajor;
  for (int idx = threadIdx.x; idx < kTileT * DP; idx += NT) {
    const int t = dhm ? idx % kTileT : idx / DP;
    const int d = dhm ? idx / kTileT : idx % DP;
    const int pos = t0 + t;
    bf16 x = __float2bfloat16(0.f);
    if (pos < seq && d < dh) x = src[pos * s.t + d * s.d];
    tile[dhm ? d * kPosPitch + t : t * DPP + d] = x;
  }
}

// A tile (positions [t0, t0 + 64)) to one head's output through strides,
// skipping positions past seq and dims past dh.
template <int DP, int NT>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, const Strides& s, int mode,
                                           const bf16* tile, int t0, int seq, int dh) {
  constexpr int DPP = dim_pitch<DP>();
  const bool dhm = mode & kDhMajor;
  if (mode & kVec) {
    // Chunks of 8 elements along the contiguous axis: one 16-byte store
    // when the chunk is whole, element stores at the ragged edge.
    const int n_chunks = dhm ? DP * (kTileT / 8) : kTileT * (DP / 8);
    for (int idx = threadIdx.x; idx < n_chunks; idx += NT) {
      int t, d, n;
      const bf16* from;
      bf16* to;
      if (dhm) {
        d = idx / (kTileT / 8);
        t = (idx % (kTileT / 8)) * 8;
        n = min(8, seq - (t0 + t));
        from = tile + d * kPosPitch + t;
        to = dst + d * s.d + (t0 + t);
        if (d >= dh) continue;
      } else {
        t = idx / (DP / 8);
        d = (idx % (DP / 8)) * 8;
        n = min(8, dh - d);
        from = tile + t * DPP + d;
        to = dst + (t0 + t) * s.t + d;
        if (t0 + t >= seq) continue;
      }
      if (n == 8) {
        *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
      } else {
        for (int e = 0; e < n; ++e) to[e] = from[e];
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kTileT * DP; idx += NT) {
    const int t = dhm ? idx % kTileT : idx / DP;
    const int d = dhm ? idx / kTileT : idx % DP;
    if (t0 + t < seq && d < dh) {
      dst[(t0 + t) * s.t + d * s.d] = tile[dhm ? d * kPosPitch + t : t * DPP + d];
    }
  }
}

// ldmatrix over a (possibly double-buffered) tile. load() returns the 16 x
// 16 block at positions [t0, t0 + 16) and dims [d0, d0 + 16) as four 8 x 8
// matrices in the order (t lo, d lo), (t hi, d lo), (t lo, d hi), (t hi,
// d hi), each register holding two elements adjacent in d (along_d: an
// operand contracted over the head dim) or in t (contracted over
// positions). ldmatrix transposes where the tile's contiguous axis is the
// other one. So, as an A operand (m = t, k = d): {r0, r1, r2, r3}; as the B
// operands of two n-tiles (n = t, k = d): {r0, r2} and {r1, r3}; as the B
// operands of two n-tiles (k = t, n = d): {r0, r1} and {r2, r3}.
template <int DP>
struct TileView {
  uint32_t base;      // this lane's row address in block (0, 0) of buffer 0
  int t_bytes;        // bytes per position
  int d_bytes;        // bytes per dim
  bool dhm;

  __device__ __forceinline__ TileView(const bf16* tile, int mode) : dhm(mode & kDhMajor) {
    const int lane = threadIdx.x & 31;
    const int tb = ((lane >> 3) & 1) * 8;
    const int db = (lane >> 4) * 8;
    const int r = lane & 7;
    int off;
    if (dhm) {
      off = (db + r) * kPosPitch + tb;
      t_bytes = 2;
      d_bytes = 2 * kPosPitch;
    } else {
      off = (tb + r) * dim_pitch<DP>() + db;
      t_bytes = 2 * dim_pitch<DP>();
      d_bytes = 2;
    }
    base = smem_u32(tile) + 2 * off;
  }

  __device__ __forceinline__ void load(uint32_t (&r)[4], int buf, int t0, int d0,
                                       bool along_d) const {
    const uint32_t a = base + buf * (2 * tile_elems<DP>()) + t0 * t_bytes + d0 * d_bytes;
    if (along_d == dhm) {
      ldsm_x4_trans(r, a);
    } else {
      ldsm_x4(r, a);
    }
  }
};

// A warp's 16 x DP fp32 accumulator (rows row0 + g and row0 + g + 8 of the
// tile, n-tiles of 8 dims) rounded to bf16 into a tile in `mode`'s layout.
template <int DP>
__device__ __forceinline__ void acc_to_tile(bf16* tile, int mode, int row0,
                                            const float (&acc)[DP / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int d = 8 * n + t2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + g + 8 * half;
      if (mode & kDhMajor) {
        tile[d * kPosPitch + r] = __float2bfloat16(acc[n][2 * half]);
        tile[(d + 1) * kPosPitch + r] = __float2bfloat16(acc[n][2 * half + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(tile + r * dim_pitch<DP>() + d) =
            pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
      }
    }
  }
}

}  // namespace
