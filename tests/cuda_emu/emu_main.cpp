// One case of the flash kernels under the CPU emulation (emu.h), against a
// float64 reference of the same function on the same bf16 or fp32 inputs.
//
//   emu_fwd T DH BF16 LQ LK LV LO OFFSET CAUSAL        (built with -DEMU_FWD)
//   emu_bwd T DH BF16 LQ LK LV LDK OFFSET CAUSAL LDO LDQ DQOFFSET
//
// B=1, H=2. L* is each operand's layout: 0 row-major [B, T, H, Dh], 1
// dh-major [B*H, Dh, T]. OFFSET shifts q and v by that many elements off
// their 16-byte alignment (the kernels' element-staging path), DQOFFSET
// shifts dq (the epilogue's element stores). The forward checks out (2e-2
// bf16, 1e-4 fp32) and lse (1e-4); the backward checks dq, dk, dv (2e-2 of
// the largest reference gradient in bf16, 1e-4 fp32),
// with lse from the reference and delta from the rounded output, as the
// wrapper hands them. Prints one line per output; exits 1 on any miss.
#include "emu.h"
#ifdef EMU_FWD
#include "flash_fwd.cu"
#else
#include "flash_bwd.cu"
#endif
#include <random>

namespace {

// A logical [B, T, H, Dh] tensor in one of the kernels' layouts.
struct Ten {
  int B, T, H, D;
  bool bf;
  int off;
  std::vector<uint16_t> hb;
  std::vector<float> hf;
  long long s[4];  // b, h, t, d element strides

  Ten(int B_, int T_, int H_, int D_, bool bf_, int layout, int off_)
      : B(B_), T(T_), H(H_), D(D_), bf(bf_), off(off_) {
    const size_t n = static_cast<size_t>(B) * T * H * D + off;
    if (bf) hb.assign(n, 0); else hf.assign(n, 0.f);
    if (layout == 0) {
      s[0] = static_cast<long long>(T) * H * D; s[1] = D; s[2] = static_cast<long long>(H) * D; s[3] = 1;
    } else {
      s[0] = static_cast<long long>(H) * D * T; s[1] = static_cast<long long>(D) * T; s[2] = 1; s[3] = T;
    }
  }
  size_t at(int b, int t, int h, int d) const { return off + b * s[0] + h * s[1] + t * s[2] + d * s[3]; }
  float get(int b, int t, int h, int d) const {
    const size_t i = at(b, t, h, d);
    return bf ? __bfloat162float(__nv_bfloat16{hb[i]}) : hf[i];
  }
  void set(int b, int t, int h, int d, float x) {
    const size_t i = at(b, t, h, d);
    if (bf) hb[i] = __float2bfloat16(x).x; else hf[i] = x;
  }
  void* ptr() { return bf ? static_cast<void*>(hb.data() + off) : static_cast<void*>(hf.data() + off); }
  void fill(std::mt19937& g) {
    std::normal_distribution<float> n;
    for (int b = 0; b < B; ++b) for (int t = 0; t < T; ++t) for (int h = 0; h < H; ++h)
      for (int d = 0; d < D; ++d) set(b, t, h, d, n(g));
  }
  size_t dense(int b, int t, int h, int d) const { return ((static_cast<size_t>(b) * T + t) * H + h) * D + d; }
};

void strides_of(std::initializer_list<const Ten*> ops, long long* out) {
  for (const Ten* x : ops) for (int j = 0; j < 4; ++j) *out++ = x->s[j];
}

int misses = 0;

void report(const char* what, double err, double tol) {
  const bool ok = std::isfinite(err) && err <= tol;
  printf("%s max|d| %.3g tol %.3g %s\n", what, err, tol, ok ? "ok" : "MISS");
  misses += !ok;
}

// out (dense [B, T, H, Dh]) and lse ([B*H, T]) of softmax(q k^T / sqrt(Dh)) v.
void reference_forward(const Ten& q, const Ten& k, const Ten& v, bool causal,
                       std::vector<double>& out, std::vector<double>& lse) {
  const int B = q.B, T = q.T, H = q.H, D = q.D;
  const double sc = 1.0 / std::sqrt(static_cast<double>(D));
  out.assign(static_cast<size_t>(B) * T * H * D, 0.0);
  lse.assign(static_cast<size_t>(B) * H * T, 0.0);
  std::vector<double> p(T);
  for (int b = 0; b < B; ++b) for (int h = 0; h < H; ++h) for (int i = 0; i < T; ++i) {
    const int n = causal ? i + 1 : T;
    double m = -1e300, l = 0;
    for (int j = 0; j < n; ++j) {
      double a = 0;
      for (int d = 0; d < D; ++d) a += static_cast<double>(q.get(b, i, h, d)) * k.get(b, j, h, d);
      p[j] = a * sc;
      m = std::max(m, p[j]);
    }
    for (int j = 0; j < n; ++j) { p[j] = std::exp(p[j] - m); l += p[j]; }
    for (int d = 0; d < D; ++d) {
      double a = 0;
      for (int j = 0; j < n; ++j) a += p[j] * v.get(b, j, h, d);
      out[q.dense(b, i, h, d)] = a / l;
    }
    lse[(static_cast<size_t>(b) * H + h) * T + i] = m + std::log(l);
  }
}

}  // namespace

int main(int argc, char** argv) {
#ifdef EMU_FWD
  const int n_args = 9;
#else
  const int n_args = 12;
#endif
  if (argc != n_args + 1) {
    fprintf(stderr, "expected %d arguments\n", n_args);
    return 2;
  }
  int a[12] = {0};
  for (int i = 0; i < n_args; ++i) a[i] = atoi(argv[i + 1]);
  const int T = a[0], D = a[1], off = a[7];
  const bool bf = a[2], causal = a[8];
  const int B = 1, H = 2;
  const float scale = 1.f / std::sqrt(static_cast<float>(D));
  std::mt19937 gen(T * 131 + D * 7 + a[3] + 2 * a[4] + 4 * a[5] + 8 * a[6] + off + causal);
  Ten q(B, T, H, D, bf, a[3], off), k(B, T, H, D, bf, a[4], 0), v(B, T, H, D, bf, a[5], off);
  q.fill(gen); k.fill(gen); v.fill(gen);
  std::vector<double> ref_out, ref_lse;
  reference_forward(q, k, v, causal, ref_out, ref_lse);
  long long st[24];
#ifdef EMU_FWD
  Ten o(B, T, H, D, bf, a[6], 0);
  std::vector<float> lse(static_cast<size_t>(B) * H * T, -7.f);
  strides_of({&q, &k, &v, &o}, st);
  if (ddl_flash_fwd(q.ptr(), k.ptr(), v.ptr(), o.ptr(), lse.data(), bf, B, H, T, D, st, scale,
                    causal, nullptr)) {
    printf("launch refused\n");
    return 1;
  }
  double eo = 0, el = 0;
  for (int b = 0; b < B; ++b) for (int t = 0; t < T; ++t) for (int h = 0; h < H; ++h)
    for (int d = 0; d < D; ++d) eo = std::max(eo, std::abs(o.get(b, t, h, d) - ref_out[q.dense(b, t, h, d)]));
  for (size_t i = 0; i < lse.size(); ++i) el = std::max(el, std::abs(lse[i] - ref_lse[i]));
  report("out", eo, bf ? 2e-2 : 1e-4);
  report("lse", el, 1e-4);
#else
  // The forward's output as the wrapper holds it (rounded to the input
  // type), a cotangent, and delta = rowsum(dO * O).
  Ten o(B, T, H, D, bf, 0, 0), dout(B, T, H, D, bf, a[9], 0);
  for (int b = 0; b < B; ++b) for (int t = 0; t < T; ++t) for (int h = 0; h < H; ++h)
    for (int d = 0; d < D; ++d) o.set(b, t, h, d, ref_out[q.dense(b, t, h, d)]);
  dout.fill(gen);
  std::vector<float> lse(ref_lse.begin(), ref_lse.end()), delta(lse.size());
  for (int b = 0; b < B; ++b) for (int h = 0; h < H; ++h) for (int t = 0; t < T; ++t) {
    double s = 0;
    for (int d = 0; d < D; ++d) s += static_cast<double>(dout.get(b, t, h, d)) * o.get(b, t, h, d);
    delta[(static_cast<size_t>(b) * H + h) * T + t] = s;
  }
  Ten dq(B, T, H, D, bf, a[10], a[11]), dk(B, T, H, D, bf, a[6], 0), dv(B, T, H, D, bf, 0, 0);
  strides_of({&q, &k, &v, &dout, &dk, &dv}, st);
  if (ddl_flash_bwd_dkv(q.ptr(), k.ptr(), v.ptr(), dout.ptr(), lse.data(), delta.data(), dk.ptr(),
                        dv.ptr(), bf, B, H, T, D, st, scale, causal, nullptr)) {
    printf("dK/dV launch refused\n");
    return 1;
  }
  strides_of({&q, &k, &v, &dout, &dq}, st);
  if (ddl_flash_bwd_dq(q.ptr(), k.ptr(), v.ptr(), dout.ptr(), lse.data(), delta.data(), dq.ptr(), bf,
                       B, H, T, D, st, scale, causal, nullptr)) {
    printf("dQ launch refused\n");
    return 1;
  }
  std::vector<double> want[3];
  for (auto& w : want) w.assign(ref_out.size(), 0.0);
  for (int b = 0; b < B; ++b) for (int h = 0; h < H; ++h) for (int i = 0; i < T; ++i)
    for (int j = 0; j < (causal ? i + 1 : T); ++j) {
      double s = 0, dp = 0;
      for (int d = 0; d < D; ++d) {
        s += static_cast<double>(q.get(b, i, h, d)) * k.get(b, j, h, d);
        dp += static_cast<double>(dout.get(b, i, h, d)) * v.get(b, j, h, d);
      }
      const size_t row = (static_cast<size_t>(b) * H + h) * T + i;
      const double p = std::exp(s * scale - lse[row]);
      const double ds = p * (dp - delta[row]) * scale;
      for (int d = 0; d < D; ++d) {
        want[0][q.dense(b, i, h, d)] += ds * k.get(b, j, h, d);
        want[1][q.dense(b, j, h, d)] += ds * q.get(b, i, h, d);
        want[2][q.dense(b, j, h, d)] += p * dout.get(b, i, h, d);
      }
    }
  double largest = 0;
  for (const auto& w : want) for (double x : w) largest = std::max(largest, std::abs(x));
  const char* names[3] = {"dq", "dk", "dv"};
  const Ten* got[3] = {&dq, &dk, &dv};
  for (int n = 0; n < 3; ++n) {
    double e = 0;
    for (int b = 0; b < B; ++b) for (int t = 0; t < T; ++t) for (int h = 0; h < H; ++h)
      for (int d = 0; d < D; ++d) e = std::max(e, std::abs(got[n]->get(b, t, h, d) - want[n][q.dense(b, t, h, d)]));
    report(names[n], e, bf ? 2e-2 * largest : 1e-4);
  }
#endif
  return misses != 0;
}
