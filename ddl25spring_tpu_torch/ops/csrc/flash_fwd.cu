// Causal flash-attention forward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the JAX package's Pallas TPU kernels _fwd_kernel (row-major
// [B*H, T, Dh] operands) and _fwd_kernel_t (dh-major [B*H, Dh, T]) in
// ddl25spring_tpu/ops/flash_attention.py: one kernel serves both layouts,
// because it reads every operand through (batch, head, seq, dim) strides.
//
// What it computes, per (batch, head) and query row i:
//   s_j  = (q_i . k_j) / sqrt(Dh)        for keys j <= i (causal) and j < T
//   out_i = sum_j softmax(s)_j v_j       (online softmax: running m, l, acc)
//   lse_i = m + log(l)
// all in fp32 (no TF32), with `out` cast back to the input type. Key tiles
// strictly above the diagonal of a query tile are never visited, and no key
// at or past T gets mass: the ragged edge is masked here, so nothing is
// padded in device memory (Dh = 48 and T = 200 run as they are).
//
// Design. One CTA of 256 threads per (batch*head, 64-query tile), the
// latest (heaviest) query tiles launched first. Q (pre-scaled by
// log2(e)/sqrt(Dh), so each probability is one exp2), K and V tiles of 64
// keys are staged in shared memory as fp32, Q and K transposed. Both
// products are register-tiled as in a CUDA-core GEMM: a 16 x 16 thread grid
// where each thread owns 4 query rows x 4 keys of S (then 4 rows x Dh/16
// dims of O), so each shared-memory load feeds 4 FMAs instead of 1. A row's
// 64 scores sit on 16 adjacent lanes, whose shuffles give the row max and
// sum; P goes through shared memory (transposed) into the P.V product.
// Row strides are padded so the transposed stores and the 128-bit loads are
// free of bank conflicts.
//
// What bounds it on this card: at the canonical shape (B=8, H=6, T=256,
// Dh=48) the causal work is about 2*B*H*T^2*Dh = 0.3 GFLOP against about
// 9.5 MB of q/k/v/o/lse traffic, so the fp32 FMA rate bounds it (the
// tensor cores are not used: this kernel is plain FMA). The head dim is a
// template parameter rounded up to a multiple of 16 (<= 128); the padded
// dims are zero in shared memory only.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBlockQ = 64;                  // query rows per CTA
constexpr int kBlockK = 64;                  // keys per tile
constexpr int kTX = 16;                      // threads along keys / dims
constexpr int kTY = kBlockQ / 4;             // threads along rows (4 rows each)
constexpr int kThreads = kTX * kTY;
constexpr int kKPT = kBlockK / kTX;          // keys per thread in S
constexpr int kQPad = kBlockQ + 4;           // Qt / Ps row stride (float4-aligned)
constexpr int kKPad = kBlockK + 1;           // Kt row stride (odd: conflict-free stores)
constexpr float kNegInf = -1e30f;            // finite, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, t, d;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Dynamic shared memory per CTA, in floats: Qt, Kt, V and Pt tiles (55.5 KB
// at DP = 48, so the launch raises the 48 KB default where needed).
template <int DP>
constexpr int smem_floats() {
  return DP * kQPad + DP * kKPad + kBlockK * (DP + 1) + kBlockK * kQPad;
}

// Element (t, d) of rows [t0, t0 + n) of one head, read in the operand's own
// contiguous order; f(t, d, x) stores it (zero past seq and dh).
template <typename T, int DP, typename F>
__device__ __forceinline__ void for_tile(const T* __restrict__ src, const Strides& s, int t0,
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
    if (pos < seq && d < dh) x = to_float(src[pos * s.t + d * s.d]);
    f(t, d, x);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int heads, int seq, int dh,
                 Strides sq, Strides sk, Strides sv, Strides so, float scale, int causal) {
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for_tile<T, DP>(qb, sq, q0, kBlockQ, seq, dh,
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
    for_tile<T, DP>(kb, sk, k0, kBlockK, seq, dh,
                    [&](int t, int d, float x) { kt[d * kKPad + t] = x; });
    for_tile<T, DP>(vb, sv, k0, kBlockK, seq, dh,
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
    T* ob = o + b * so.b + h * so.h + qpos * so.t;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) ob[d * so.d] = from_float<T>(acc[i][c] / safe);
    }
    if (tx == 0) lse[static_cast<long long>(bh) * seq + qpos] = m[i] * kLn2 + logf(safe);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                   int heads, int seq, int dh, const Strides* s, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = 4 * smem_floats<DP>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * heads, (seq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, heads, seq, dh, s[0], s[1], s[2], s[3], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                     int heads, int seq, int dh, const Strides* s, float scale, int causal,
                     cudaStream_t stream) {
  switch ((dh + 15) / 16) {
    case 1: return launch<T, 16>(q, k, v, o, lse, batch, heads, seq, dh, s, scale, causal, stream);
    case 2: return launch<T, 32>(q, k, v, o, lse, batch, heads, seq, dh, s, scale, causal, stream);
    case 3: return launch<T, 48>(q, k, v, o, lse, batch, heads, seq, dh, s, scale, causal, stream);
    case 4: return launch<T, 64>(q, k, v, o, lse, batch, heads, seq, dh, s, scale, causal, stream);
    case 5: return launch<T, 80>(q, k, v, o, lse, batch, heads, seq, dh, s, scale, causal, stream);
    case 6: return launch<T, 96>(q, k, v, o, lse, batch, heads, seq, dh, s, scale, causal, stream);
    case 7: return launch<T, 112>(q, k, v, o, lse, batch, heads, seq, dh, s, scale, causal, stream);
    case 8: return launch<T, 128>(q, k, v, o, lse, batch, heads, seq, dh, s, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). q, k, v, o are indexed
// [b, h, t, d] through `strides`: 16 element strides, four (b, h, t, d) per
// operand in the order q, k, v, o. lse is a dense fp32 [batch*heads, seq].
// Launches on `stream` and returns the launch's cudaError_t (0 = success);
// it does not synchronise.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, batch, heads, seq, dh, s, scale, causal, st)
              : dispatch<float>(q, k, v, o, lse, batch, heads, seq, dh, s, scale, causal, st);
  return static_cast<int>(err);
}
