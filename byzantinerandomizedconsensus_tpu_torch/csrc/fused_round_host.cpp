// Host build of the fused round kernel's per-replica arithmetic, for the CPU
// tests: g++ compiles fused_round.cuh behind this extern "C" shim
// (ops/_build.py::load_host), and tests/test_torch_kernel_host.py holds each
// function against the port's plain torch version and the reference.
//
// brc_host_fused_round runs the kernel's round loop for one instance at a
// time with the block reductions written as loops over the replicas. It calls
// the same functions between the reductions as fused_round.cu does, in the
// same order.
#include <stdint.h>

#include <vector>

#include "fused_round.cuh"

extern "C" {

uint32_t brc_threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  return brc::threefry2x32(k0, k1, x0, x1);
}

uint32_t brc_prf_u32(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                     uint32_t step, uint32_t recv, uint32_t send,
                     uint32_t purpose) {
  return brc::prf_u32(k0, k1, inst, rnd, step, recv, send, purpose);
}

int brc_urn2_chain(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                   uint32_t t, uint32_t recv, uint32_t seg, int m, int Lr,
                   int Dr) {
  return brc::urn2_chain(k0, k1, inst, rnd, t, recv, seg, m, Lr, Dr);
}

void brc_urn2_counts(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                     uint32_t t, uint32_t recv, uint32_t own, int own_live,
                     int M0, int M1, int M2, int n, int f, int* c0, int* c1) {
  brc::urn2_counts(k0, k1, inst, rnd, t, recv, own, own_live != 0, M0, M1, M2,
                   n, f, c0, c1);
}

void brc_host_fused_round(const int32_t* inst_ids, int32_t* rounds,
                          uint8_t* decision, int B, int n, int f, int round_cap,
                          int init_code, int coin_code, uint32_t k0,
                          uint32_t k1) {
  const brc::Params p{k0, k1, n, f, round_cap, init_code, coin_code};
  std::vector<uint32_t> word(n), x(n), z(n);
  std::vector<bool> live1(n), live2(n);
  for (int b = 0; b < B; ++b) {
    const uint32_t inst = (uint32_t)inst_ids[b];
    auto count = [&](auto pred) {
      int c = 0;
      for (int v = 0; v < n; ++v) c += pred(v) ? 1 : 0;
      return c;
    };
    for (int v = 0; v < n; ++v) word[v] = brc::init_est(p, inst, (uint32_t)v);
    int done_at = -1;
    for (int r = 0; r < round_cap; ++r) {
      const uint32_t rnd = (uint32_t)r;
      const int g00 = count([&](int v) { return brc::word_est(word[v]) == 0u; });
      const int g01 = count([&](int v) { return brc::word_est(word[v]) == 1u; });
      for (int v = 0; v < n; ++v)
        x[v] = brc::step0_vote(p, inst, rnd, v, brc::word_est(word[v]), g00, g01);
      for (int v = 0; v < n; ++v) live1[v] = brc::step1_valid(p, x[v], g00, g01);
      const int g10 = count([&](int v) { return live1[v] && x[v] == 0u; });
      const int g11 = count([&](int v) { return live1[v] && x[v] == 1u; });
      for (int v = 0; v < n; ++v)
        z[v] = brc::step1_vote(p, inst, rnd, v, x[v], live1[v], g10, g11);
      for (int v = 0; v < n; ++v) live2[v] = brc::step2_valid(p, z[v], g10, g11);
      const int m20 = count([&](int v) { return live2[v] && z[v] == 0u; });
      const int m21 = count([&](int v) { return live2[v] && z[v] == 1u; });
      const int m22 = count([&](int v) { return live2[v] && z[v] == 2u; });
      for (int v = 0; v < n; ++v)
        word[v] = brc::round_update(p, inst, rnd, v, word[v], z[v], live2[v],
                                    m20, m21, m22);
      const int undone = count([&](int v) { return !brc::word_decided(word[v]); });
      if (undone == 0) {
        done_at = r + 1;
        break;
      }
    }
    rounds[b] = done_at >= 0 ? done_at : round_cap;
    decision[b] = done_at >= 0 ? (uint8_t)brc::word_decided_val(word[0]) : 2;
  }
}

}  // extern "C"
