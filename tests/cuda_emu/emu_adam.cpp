// One ddl_adam call (ops/csrc/adam.cu) under the CPU emulation (emu.h) over
// a table of leaves, against a float reference of the same operations in the
// same order.
//
//   emu_adam SMS BLOCKS_PER_SM N0 [N1 ...]
//
// SMS and BLOCKS_PER_SM are what the emulated card reports: the persistent
// grid is their product, or the chunk count where that is smaller. N0... are
// the leaves' sizes in elements; "c", "c+512" or "c-512" count from the
// built kernel's chunk (1024 for the one-grid-per-leaf build). Every p, m and
// v element must equal the reference bitwise, the 16 guard elements on
// either side of every array must keep their values, and the call must
// launch once per table of leaves (once per leaf for the per-leaf build).
// Prints one line; exits 1 on any miss.
#include "emu.h"
#include "adam.cu"
#include <random>
#include <string>

namespace {

constexpr int kGuard = 16;         // 64 bytes: keeps each leaf 16-byte aligned
constexpr float kSentinel = 1234.5f;

struct Array {
  std::vector<float> buf;
  explicit Array(long long n) : buf(n + 2 * kGuard, kSentinel) {}
  float* data() { return buf.data() + kGuard; }
  bool guards_intact() const {
    for (int i = 0; i < kGuard; ++i)
      if (buf[i] != kSentinel || buf[buf.size() - 1 - i] != kSentinel) return false;
    return true;
  }
};

bool same_bits(float a, float b) { return memcmp(&a, &b, sizeof(float)) == 0; }

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4) {
    fprintf(stderr, "usage: emu_adam SMS BLOCKS_PER_SM N0 [N1 ...]\n");
    return 2;
  }
  g_emu_sms = atoi(argv[1]);
  g_emu_blocks_per_sm = atoi(argv[2]);
  const int chunk = ddl_adam_chunk() ? ddl_adam_chunk() : 1024;
  std::vector<long long> counts;
  for (int i = 3; i < argc; ++i) {
    const std::string a = argv[i];
    counts.push_back(a[0] == 'c' ? chunk + (a.size() > 1 ? std::stoll(a.substr(1)) : 0)
                                 : std::stoll(a));
  }
  const int leaves = static_cast<int>(counts.size());
  const float lr = 1e-3f, b1 = 0.9f, b2 = 0.999f, eps = 1e-8f;
  const float omb1 = 1.f - b1, omb2 = 1.f - b2;
  const float corrections[2] = {1.f - b1 * b1 * b1, 1.f - b2 * b2 * b2};
  std::mt19937 gen(leaves * 7919 + static_cast<unsigned>(counts[0]));
  std::normal_distribution<float> normal;
  std::vector<Array> p, m, v, g;
  std::vector<std::vector<float>> want_p, want_m, want_v;
  std::vector<long long> ptrs;
  long long elements = 0;
  for (long long n : counts) {
    p.emplace_back(n); m.emplace_back(n); v.emplace_back(n); g.emplace_back(n);
    std::vector<float> wp(n), wm(n), wv(n);
    for (long long i = 0; i < n; ++i) {
      const float pp = normal(gen), mm = 0.1f * normal(gen), vv = 0.01f * std::fabs(normal(gen));
      const float gg = normal(gen);
      p.back().data()[i] = pp; m.back().data()[i] = mm; v.back().data()[i] = vv;
      g.back().data()[i] = gg;
      // The rule in the kernel's order, each operation rounded to fp32.
      wm[i] = b1 * mm + omb1 * gg;
      wv[i] = b2 * vv + omb2 * (gg * gg);
      const float u = (lr * (wm[i] / corrections[0])) / (std::sqrt(wv[i] / corrections[1]) + eps);
      wp[i] = pp - u;
    }
    want_p.push_back(std::move(wp)); want_m.push_back(std::move(wm)); want_v.push_back(std::move(wv));
    elements += n;
  }
  for (int i = 0; i < leaves; ++i)
    for (Array* a : {&p[i], &m[i], &v[i], &g[i]}) ptrs.push_back(reinterpret_cast<long long>(a->data()));
  const int err = ddl_adam(ptrs.data(), counts.data(), leaves, corrections, lr, b1, omb1, b2, omb2,
                           eps, nullptr);
  long long misses = 0;
  int guards = 0;
  for (int i = 0; i < leaves; ++i) {
    for (long long k = 0; k < counts[i]; ++k) {
      misses += !same_bits(p[i].data()[k], want_p[i][k]);
      misses += !same_bits(m[i].data()[k], want_m[i][k]);
      misses += !same_bits(v[i].data()[k], want_v[i][k]);
    }
    for (Array* a : {&p[i], &m[i], &v[i], &g[i]}) guards += !a->guards_intact();
  }
  const int table = ddl_adam_table_size();
  const int want_launches = ddl_adam_chunk() ? (leaves + table - 1) / table : leaves;
  const bool ok = err == 0 && misses == 0 && guards == 0 && g_emu_launches == want_launches;
  printf("%d leaves, %lld elements, chunk %d, grid up to %d: error %d, p/m/v elements off "
         "the reference %lld, guards changed %d, launches %d (want %d) %s\n",
         leaves, elements, ddl_adam_chunk(), g_emu_sms * g_emu_blocks_per_sm, err, misses,
         guards, g_emu_launches, want_launches, ok ? "ok" : "MISS");
  return ok ? 0 : 1;
}
