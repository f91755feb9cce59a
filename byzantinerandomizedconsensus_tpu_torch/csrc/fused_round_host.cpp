// Host build of the fused round kernel's per-replica arithmetic, for the CPU
// tests: g++ compiles fused_round.cuh behind this extern "C" shim
// (ops/_build.py::load_host), and tests/test_torch_kernel_host.py holds each
// function against the port's plain torch version and the reference.
//
// brc_host_fused_round runs the kernel's round loop for one instance at a
// time, for every (protocol, adversary) instantiation, with the block
// reductions written as loops over the replicas. It calls the same
// functions between the reductions as fused_round.cu does, in the same order.
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "fused_round.cuh"

namespace {

using brc::Sent;
namespace fz = brc::fused;

template <class Pred>
int count(int n, Pred pred) {
  int c = 0;
  for (int v = 0; v < n; ++v) c += pred(v) ? 1 : 0;
  return c;
}

// fused_round.cu::broadcast for all n receivers of one instance.
template <int PROTO, int ADV, bool BOT, class Valid>
void broadcast(const brc::Params& p, uint32_t inst, uint32_t rnd, uint32_t t,
               const std::vector<bool>& faulty, const std::vector<int>& crash_round,
               int F, const std::vector<uint32_t>& honest, Valid valid,
               std::vector<Sent>& out) {
  const int n = p.n;
  if constexpr (ADV == fz::kAdaptive || ADV == fz::kAdaptiveMin) {
    const int h0 = count(n, [&](int v) { return !faulty[v] && honest[v] == 0u; });
    const int h1 = count(n, [&](int v) { return !faulty[v] && honest[v] == 1u; });
    for (int v = 0; v < n; ++v)
      out[v] = brc::adaptive_sent<ADV>(v, n, honest[v], faulty[v], F, h0, h1,
                                       n - F - h0 - h1, valid(0u), valid(1u), valid(2u));
  } else if constexpr (ADV == fz::kByzantine && PROTO == fz::kBenOr) {
    std::vector<uint32_t> c0v(n), c1v(n);
    for (int v = 0; v < n; ++v) {
      c0v[v] = faulty[v] ? brc::two_faced_value(p, inst, rnd, t, v, 0u) : honest[v];
      c1v[v] = faulty[v] ? brc::two_faced_value(p, inst, rnd, t, v, 1u) : honest[v];
    }
    const int a0 = count(n, [&](int v) { return c0v[v] == 0u; });
    const int a1 = count(n, [&](int v) { return c0v[v] == 1u; });
    const int b0 = count(n, [&](int v) { return c1v[v] == 0u; });
    const int b1 = count(n, [&](int v) { return c1v[v] == 1u; });
    for (int v = 0; v < n; ++v)
      out[v] = v >= (n + 1) / 2 ? Sent{c1v[v], true, b0, b1, n - b0 - b1, 0u}
                                : Sent{c0v[v], true, a0, a1, n - a0 - a1, 0u};
  } else {
    for (int v = 0; v < n; ++v) {
      out[v] = brc::inject<PROTO, ADV>(p, inst, rnd, t, v, honest[v], faulty[v],
                                       crash_round[v]);
      out[v].live = out[v].live && valid(out[v].own);
    }
    const int M0 = count(n, [&](int v) { return out[v].live && out[v].own == 0u; });
    const int M1 = count(n, [&](int v) { return out[v].live && out[v].own == 1u; });
    const int M2 =
        BOT ? count(n, [&](int v) { return out[v].live && out[v].own == 2u; }) : 0;
    for (int v = 0; v < n; ++v) {
      out[v].M0 = M0;
      out[v].M1 = M1;
      out[v].M2 = M2;
    }
  }
}

template <int PROTO, int ADV>
void host_run(const brc::Params& p, const int32_t* inst_ids, const uint8_t* faulty_plane,
              const int32_t* crash_plane, int32_t* rounds, uint8_t* decision, int B) {
  constexpr bool kLying = ADV == fz::kByzantine || ADV == fz::kAdaptive ||
                          ADV == fz::kAdaptiveMin;
  const int n = p.n;
  std::vector<uint32_t> word(n), est(n), x(n);
  std::vector<bool> faulty(n);
  std::vector<int> crash_round(n);
  std::vector<Sent> s0(n), s1(n), s2(n);
  auto any = [](uint32_t) { return true; };
  for (int b = 0; b < B; ++b) {
    const uint32_t inst = (uint32_t)inst_ids[b];
    for (int v = 0; v < n; ++v) {
      faulty[v] = ADV != fz::kNone && faulty_plane[(size_t)b * n + v] != 0;
      crash_round[v] = ADV == fz::kCrash ? crash_plane[(size_t)b * n + v] : 0;
      word[v] = brc::init_est(p, inst, (uint32_t)v);
    }
    const int F = count(n, [&](int v) { return faulty[v]; });
    int done_at = -1;
    for (int r = 0; r < p.round_cap; ++r) {
      const uint32_t rnd = (uint32_t)r;
      int c0, c1;
      for (int v = 0; v < n; ++v) est[v] = brc::word_est(word[v]);
      if constexpr (PROTO == fz::kBracha) {
        broadcast<PROTO, ADV, false>(p, inst, rnd, 0u, faulty, crash_round, F, est, any, s0);
        for (int v = 0; v < n; ++v) {
          brc::deliver<ADV>(p, inst, rnd, 0u, v, s0[v], &c0, &c1);
          x[v] = brc::bracha_vote0(c0, c1);
        }
        broadcast<PROTO, ADV, false>(p, inst, rnd, 1u, faulty, crash_round, F, x,
                                     [&](uint32_t val) {
                                       return brc::step1_valid(p, val, s0[0].M0, s0[0].M1);
                                     }, s1);
        for (int v = 0; v < n; ++v) {
          brc::deliver<ADV>(p, inst, rnd, 1u, v, s1[v], &c0, &c1);
          x[v] = brc::bracha_vote1(p, c0, c1);
        }
        broadcast<PROTO, ADV, true>(p, inst, rnd, 2u, faulty, crash_round, F, x,
                                    [&](uint32_t val) {
                                      return brc::step2_valid(p, val, s1[0].M0, s1[0].M1);
                                    }, s2);
        for (int v = 0; v < n; ++v) {
          if (brc::word_decided(word[v])) continue;
          brc::deliver<ADV>(p, inst, rnd, 2u, v, s2[v], &c0, &c1);
          word[v] = brc::bracha_update(p, inst, rnd, v, word[v], c0, c1);
        }
      } else {
        broadcast<PROTO, ADV, false>(p, inst, rnd, 0u, faulty, crash_round, F, est, any, s0);
        for (int v = 0; v < n; ++v) {
          brc::deliver<ADV>(p, inst, rnd, 0u, v, s0[v], &c0, &c1);
          x[v] = brc::benor_report(p, kLying, c0, c1);
        }
        broadcast<PROTO, ADV, true>(p, inst, rnd, 1u, faulty, crash_round, F, x, any, s1);
        for (int v = 0; v < n; ++v) {
          if (brc::word_decided(word[v])) continue;
          brc::deliver<ADV>(p, inst, rnd, 1u, v, s1[v], &c0, &c1);
          word[v] = brc::benor_update(p, kLying, inst, rnd, v, word[v], c0, c1);
        }
      }
      if (count(n, [&](int v) { return !faulty[v] && !brc::word_decided(word[v]); }) == 0) {
        done_at = r + 1;
        break;
      }
    }
    int first = 0;
    while (faulty[first]) ++first;
    rounds[b] = done_at >= 0 ? done_at : p.round_cap;
    decision[b] = done_at >= 0 ? (uint8_t)brc::word_decided_val(word[first]) : 2;
  }
}

template <int PROTO>
void host_run_adversary(int adversary, const brc::Params& p, const int32_t* inst_ids,
                        const uint8_t* faulty, const int32_t* crash_round,
                        int32_t* rounds, uint8_t* decision, int B) {
  switch (adversary) {
    case fz::kNone: host_run<PROTO, fz::kNone>(p, inst_ids, faulty, crash_round, rounds, decision, B); break;
    case fz::kCrash: host_run<PROTO, fz::kCrash>(p, inst_ids, faulty, crash_round, rounds, decision, B); break;
    case fz::kByzantine: host_run<PROTO, fz::kByzantine>(p, inst_ids, faulty, crash_round, rounds, decision, B); break;
    case fz::kAdaptive: host_run<PROTO, fz::kAdaptive>(p, inst_ids, faulty, crash_round, rounds, decision, B); break;
    case fz::kAdaptiveMin: host_run<PROTO, fz::kAdaptiveMin>(p, inst_ids, faulty, crash_round, rounds, decision, B); break;
  }
}

}  // namespace

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

void brc_urn2_counts_strata(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                            uint32_t t, uint32_t recv, uint32_t own, int own_live,
                            int M0, int M1, int M2, int n, int f, uint32_t pref,
                            int* c0, int* c1) {
  brc::urn2_counts_strata(k0, k1, inst, rnd, t, recv, own, own_live != 0, M0, M1,
                          M2, n, f, pref, c0, c1);
}

// The wire value and liveness (live << 8 | value) of sender v at step t
// under crash (protocol-independent) or Bracha's Byzantine pairing.
int brc_inject(int adversary, uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
               uint32_t t, uint32_t v, uint32_t honest, int faulty, int crash_round) {
  const brc::Params p{k0, k1, 1, 0, 1, 0, 0};
  Sent s{honest, true, 0, 0, 0, 0u};
  if (adversary == fz::kCrash)
    s = brc::inject<fz::kBracha, fz::kCrash>(p, inst, rnd, t, v, honest, faulty != 0,
                                             crash_round);
  else if (adversary == fz::kByzantine)
    s = brc::inject<fz::kBracha, fz::kByzantine>(p, inst, rnd, t, v, honest,
                                                 faulty != 0, crash_round);
  return (s.live ? 1 << 8 : 0) | (int)s.own;
}

uint32_t brc_two_faced_value(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                             uint32_t t, uint32_t v, uint32_t h) {
  const brc::Params p{k0, k1, 1, 0, 1, 0, 0};
  return brc::two_faced_value(p, inst, rnd, t, v, h);
}

uint32_t brc_benor_report(int n, int f, int lying, int r0, int r1) {
  const brc::Params p{0u, 0u, n, f, 1, 0, 0};
  return brc::benor_report(p, lying != 0, r0, r1);
}

uint32_t brc_benor_update(uint32_t k0, uint32_t k1, int n, int f, int coin_code,
                          int lying, uint32_t inst, uint32_t rnd, uint32_t v,
                          uint32_t word, int p0, int p1) {
  const brc::Params p{k0, k1, n, f, 1, 0, coin_code};
  return brc::benor_update(p, lying != 0, inst, rnd, v, word, p0, p1);
}

void brc_host_fused_round(const int32_t* inst_ids, const uint8_t* faulty,
                          const int32_t* crash_round, int32_t* rounds,
                          uint8_t* decision, int B, int n, int f, int round_cap,
                          int init_code, int coin_code, int protocol, int adversary,
                          uint32_t k0, uint32_t k1) {
  const brc::Params p{k0, k1, n, f, round_cap, init_code, coin_code};
  if (protocol == fz::kBracha)
    host_run_adversary<fz::kBracha>(adversary, p, inst_ids, faulty, crash_round, rounds,
                                    decision, B);
  else
    host_run_adversary<fz::kBenOr>(adversary, p, inst_ids, faulty, crash_round, rounds,
                                   decision, B);
}

}  // extern "C"
