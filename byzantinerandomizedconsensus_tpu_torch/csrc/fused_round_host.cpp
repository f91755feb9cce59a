// Host build of the fused round kernel's per-replica arithmetic, for the CPU
// tests: g++ compiles fused_round.cuh behind this extern "C" shim
// (ops/_build.py::load_host), and tests/test_torch_kernel_host.py holds each
// function against the port's plain torch version and the reference.
//
// brc_host_fused_round runs the kernel's round loop for one instance at a
// time, for every (protocol, adversary, fault schedule) instantiation, with
// the block reductions written as loops over the replicas. It calls the same
// functions between the reductions as fused_round.cu does, in the same order,
// and writes the final state words where `state` is non-null, as the
// kernel's state_out plane.
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

// The live class totals of one wire: the senders v with on[v], by value.
template <class On, class Own>
void totals(int n, On on, Own own, int& T0, int& T1, int& T2) {
  T0 = count(n, [&](int v) { return on(v) && own(v) == 0u; });
  T1 = count(n, [&](int v) { return on(v) && own(v) == 1u; });
  T2 = count(n, [&](int v) { return on(v) && own(v) == 2u; });
}

// fused_round.cu::broadcast for all n receivers of one instance; fs[v] is
// what the round's fault schedule does to v, cut whether a partition epoch
// holds the round.
template <int PROTO, int ADV, int FAULT, bool BOT, class Valid>
void broadcast(const brc::Params& p, uint32_t inst, uint32_t rnd, uint32_t t,
               const std::vector<bool>& faulty, const std::vector<int>& crash_round,
               int F, const std::vector<uint32_t>& honest,
               const std::vector<brc::Fault>& fs, bool cut, Valid valid,
               std::vector<Sent>& out) {
  constexpr bool kAdaptive = ADV == fz::kAdaptive || ADV == fz::kAdaptiveMin;
  constexpr bool kTwoFaced = ADV == fz::kByzantine && PROTO == fz::kBenOr;
  const int n = p.n;
  if constexpr (FAULT == fz::kNone && kAdaptive) {
    const int h0 = count(n, [&](int v) { return !faulty[v] && honest[v] == 0u; });
    const int h1 = count(n, [&](int v) { return !faulty[v] && honest[v] == 1u; });
    for (int v = 0; v < n; ++v)
      out[v] = brc::adaptive_sent<ADV>(v, n, honest[v], faulty[v], F, h0, h1,
                                       n - F - h0 - h1, valid(0u), valid(1u), valid(2u));
  } else if constexpr (FAULT == fz::kNone && kTwoFaced) {
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
  } else if constexpr (kTwoFaced) {
    std::vector<uint32_t> c0v(n), c1v(n);
    for (int v = 0; v < n; ++v) {
      c0v[v] = faulty[v] ? brc::two_faced_value(p, inst, rnd, t, v, 0u) : honest[v];
      c1v[v] = faulty[v] ? brc::two_faced_value(p, inst, rnd, t, v, 1u) : honest[v];
    }
    auto live = [&](int v) { return !fs[v].silent; };
    auto side1 = [&](int v) { return !fs[v].silent && fs[v].side1; };
    int a[3], b[3], A[3] = {0, 0, 0}, B[3] = {0, 0, 0};
    totals(n, live, [&](int v) { return c0v[v]; }, a[0], a[1], a[2]);
    totals(n, live, [&](int v) { return c1v[v]; }, b[0], b[1], b[2]);
    if (FAULT == fz::kPartition && cut) {
      totals(n, side1, [&](int v) { return c0v[v]; }, A[0], A[1], A[2]);
      totals(n, side1, [&](int v) { return c1v[v]; }, B[0], B[1], B[2]);
    }
    for (int v = 0; v < n; ++v) {
      const bool h = v >= (n + 1) / 2;
      const int* m = h ? b : a;
      const int* sd = h ? B : A;
      out[v] = Sent{h ? c1v[v] : c0v[v], live(v), m[0], m[1], m[2], 0u, 0, 0, 0};
      if (FAULT == fz::kPartition) brc::own_side_totals(out[v], fs[v].side1, sd[0], sd[1], sd[2]);
    }
  } else {
    if constexpr (kAdaptive) {
      const int h0 = count(n, [&](int v) { return !faulty[v] && honest[v] == 0u; });
      const int h1 = count(n, [&](int v) { return !faulty[v] && honest[v] == 1u; });
      for (int v = 0; v < n; ++v)
        out[v] = brc::adaptive_wire<ADV>(v, n, honest[v], faulty[v], h0, h1);
    } else {
      for (int v = 0; v < n; ++v)
        out[v] = brc::inject<PROTO, ADV>(p, inst, rnd, t, v, honest[v], faulty[v],
                                         crash_round[v]);
    }
    for (int v = 0; v < n; ++v)
      out[v].live = out[v].live && !fs[v].silent && valid(out[v].own);
    int M[3], S[3] = {0, 0, 0};
    totals(n, [&](int v) { return out[v].live; }, [&](int v) { return out[v].own; },
           M[0], M[1], M[2]);
    if (!BOT) M[2] = 0;
    if (FAULT == fz::kPartition && cut) {
      totals(n, [&](int v) { return out[v].live && fs[v].side1; },
             [&](int v) { return out[v].own; }, S[0], S[1], S[2]);
      if (!BOT) S[2] = 0;
    }
    for (int v = 0; v < n; ++v) {
      out[v].M0 = M[0];
      out[v].M1 = M[1];
      out[v].M2 = M[2];
      if (FAULT == fz::kPartition) brc::own_side_totals(out[v], fs[v].side1, S[0], S[1], S[2]);
    }
  }
}

// The §9 planes of one chunk (null where the schedule has none), as
// fused_round.cu::FaultPlanes.
struct HostFaultPlanes {
  const uint8_t* fprone;
  const int32_t* down_at;
  const int32_t* up_at;
  const uint8_t* side;
  const int32_t* part_start;
  const int32_t* part_heal;
};

template <int PROTO, int ADV, int FAULT>
void host_run(const brc::Params& p, const int32_t* inst_ids, const uint8_t* faulty_plane,
              const int32_t* crash_plane, const HostFaultPlanes& fp, int32_t* rounds,
              uint8_t* decision, uint32_t* state, int B) {
  constexpr bool kLying = ADV == fz::kByzantine || ADV == fz::kAdaptive ||
                          ADV == fz::kAdaptiveMin;
  const int n = p.n;
  std::vector<uint32_t> word(n), est(n), x(n);
  std::vector<bool> faulty(n), fprone(n), side(n);
  std::vector<int> crash_round(n), down_at(n), up_at(n);
  std::vector<brc::Fault> fs(n);
  std::vector<Sent> s0(n), s1(n), s2(n);
  auto any = [](uint32_t) { return true; };
  for (int b = 0; b < B; ++b) {
    const uint32_t inst = (uint32_t)inst_ids[b];
    for (int v = 0; v < n; ++v) {
      const size_t at = (size_t)b * n + v;
      faulty[v] = ADV != fz::kNone && faulty_plane[at] != 0;
      crash_round[v] = ADV == fz::kCrash ? crash_plane[at] : 0;
      // Any adversary but none selects the fault-prone set as its faulty set.
      fprone[v] = FAULT != fz::kNone &&
                  (ADV != fz::kNone ? faulty[v] : fp.fprone[at] != 0);
      down_at[v] = FAULT == fz::kRecover ? fp.down_at[at] : 0;
      up_at[v] = FAULT == fz::kRecover ? fp.up_at[at] : 0;
      side[v] = FAULT == fz::kPartition && fp.side[at] != 0;
      word[v] = brc::init_est(p, inst, (uint32_t)v);
    }
    const int part_start = FAULT == fz::kPartition ? fp.part_start[b] : 0;
    const int part_heal = FAULT == fz::kPartition ? fp.part_heal[b] : 0;
    const int F = count(n, [&](int v) { return faulty[v]; });
    int done_at = -1;
    for (int r = 0; r < p.round_cap; ++r) {
      const uint32_t rnd = (uint32_t)r;
      int c0, c1;
      const bool burst = FAULT == fz::kOmission && brc::omission_burst(p, inst, rnd);
      const bool cut = FAULT == fz::kPartition && brc::partition_cut(part_start, part_heal, r);
      for (int v = 0; v < n; ++v) {
        fs[v] = brc::Fault{false, cut && side[v]};
        if (FAULT == fz::kRecover)
          fs[v].silent = brc::recover_silent(fprone[v], down_at[v], up_at[v], r);
        if (FAULT == fz::kOmission)
          fs[v].silent = brc::omission_silent(p, inst, rnd, v, fprone[v], burst);
        est[v] = brc::word_est(word[v]);
      }
      if constexpr (PROTO == fz::kBracha) {
        broadcast<PROTO, ADV, FAULT, false>(p, inst, rnd, 0u, faulty, crash_round, F, est,
                                            fs, cut, any, s0);
        for (int v = 0; v < n; ++v) {
          brc::deliver<ADV, FAULT>(p, inst, rnd, 0u, v, s0[v], &c0, &c1);
          x[v] = brc::bracha_vote0(c0, c1);
        }
        broadcast<PROTO, ADV, FAULT, false>(p, inst, rnd, 1u, faulty, crash_round, F, x,
                                            fs, cut, [&](uint32_t val) {
                                              return brc::step1_valid(p, val, s0[0].M0,
                                                                      s0[0].M1);
                                            }, s1);
        for (int v = 0; v < n; ++v) {
          brc::deliver<ADV, FAULT>(p, inst, rnd, 1u, v, s1[v], &c0, &c1);
          x[v] = brc::bracha_vote1(p, c0, c1);
        }
        broadcast<PROTO, ADV, FAULT, true>(p, inst, rnd, 2u, faulty, crash_round, F, x,
                                           fs, cut, [&](uint32_t val) {
                                             return brc::step2_valid(p, val, s1[0].M0,
                                                                     s1[0].M1);
                                           }, s2);
        for (int v = 0; v < n; ++v) {
          if (brc::word_decided(word[v])) continue;
          brc::deliver<ADV, FAULT>(p, inst, rnd, 2u, v, s2[v], &c0, &c1);
          word[v] = brc::bracha_update(p, inst, rnd, v, word[v], c0, c1);
        }
      } else {
        broadcast<PROTO, ADV, FAULT, false>(p, inst, rnd, 0u, faulty, crash_round, F, est,
                                            fs, cut, any, s0);
        for (int v = 0; v < n; ++v) {
          brc::deliver<ADV, FAULT>(p, inst, rnd, 0u, v, s0[v], &c0, &c1);
          x[v] = brc::benor_report(p, kLying, c0, c1);
        }
        broadcast<PROTO, ADV, FAULT, true>(p, inst, rnd, 1u, faulty, crash_round, F, x,
                                           fs, cut, any, s1);
        for (int v = 0; v < n; ++v) {
          if (brc::word_decided(word[v])) continue;
          brc::deliver<ADV, FAULT>(p, inst, rnd, 1u, v, s1[v], &c0, &c1);
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
    if (state != nullptr)
      for (int v = 0; v < n; ++v) state[(size_t)b * n + v] = word[v];
  }
}

template <int PROTO, int ADV>
void host_run_fault(int fault, const brc::Params& p, const int32_t* inst_ids,
                    const uint8_t* faulty, const int32_t* crash_round,
                    const HostFaultPlanes& fp, int32_t* rounds, uint8_t* decision, uint32_t* state, int B) {
  switch (fault) {
    case fz::kNone: host_run<PROTO, ADV, fz::kNone>(p, inst_ids, faulty, crash_round, fp, rounds, decision, state, B); break;
    case fz::kRecover: host_run<PROTO, ADV, fz::kRecover>(p, inst_ids, faulty, crash_round, fp, rounds, decision, state, B); break;
    case fz::kPartition: host_run<PROTO, ADV, fz::kPartition>(p, inst_ids, faulty, crash_round, fp, rounds, decision, state, B); break;
    case fz::kOmission: host_run<PROTO, ADV, fz::kOmission>(p, inst_ids, faulty, crash_round, fp, rounds, decision, state, B); break;
  }
}

template <int PROTO>
void host_run_adversary(int adversary, int fault, const brc::Params& p,
                        const int32_t* inst_ids, const uint8_t* faulty,
                        const int32_t* crash_round, const HostFaultPlanes& fp,
                        int32_t* rounds, uint8_t* decision, uint32_t* state, int B) {
  switch (adversary) {
    case fz::kNone: host_run_fault<PROTO, fz::kNone>(fault, p, inst_ids, faulty, crash_round, fp, rounds, decision, state, B); break;
    case fz::kCrash: host_run_fault<PROTO, fz::kCrash>(fault, p, inst_ids, faulty, crash_round, fp, rounds, decision, state, B); break;
    case fz::kByzantine: host_run_fault<PROTO, fz::kByzantine>(fault, p, inst_ids, faulty, crash_round, fp, rounds, decision, state, B); break;
    case fz::kAdaptive: host_run_fault<PROTO, fz::kAdaptive>(fault, p, inst_ids, faulty, crash_round, fp, rounds, decision, state, B); break;
    case fz::kAdaptiveMin: host_run_fault<PROTO, fz::kAdaptiveMin>(fault, p, inst_ids, faulty, crash_round, fp, rounds, decision, state, B); break;
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

int brc_recover_silent(int fprone, int down_at, int up_at, int rnd) {
  return brc::recover_silent(fprone != 0, down_at, up_at, rnd) ? 1 : 0;
}

int brc_omission_silent(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd, uint32_t v,
                        int fprone) {
  const brc::Params p{k0, k1, 1, 0, 1, 0, 0};
  const bool burst = brc::omission_burst(p, inst, rnd);
  return brc::omission_silent(p, inst, rnd, v, fprone != 0, burst) ? 1 : 0;
}

int brc_omission_burst(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd) {
  const brc::Params p{k0, k1, 1, 0, 1, 0, 0};
  return brc::omission_burst(p, inst, rnd) ? 1 : 0;
}

int brc_partition_cut(int part_start, int part_heal, int rnd) {
  return brc::partition_cut(part_start, part_heal, rnd) ? 1 : 0;
}

// The totals U0..U2 of a receiver's own side, from the global and the
// side-1 totals.
void brc_own_side_totals(int side1, int M0, int M1, int M2, int S0, int S1, int S2,
                         int* U) {
  Sent s{0u, true, M0, M1, M2, 0u, 0, 0, 0};
  brc::own_side_totals(s, side1 != 0, S0, S1, S2);
  U[0] = s.U0;
  U[1] = s.U1;
  U[2] = s.U2;
}

void brc_host_fused_round(const int32_t* inst_ids, const uint8_t* faulty,
                          const int32_t* crash_round, const uint8_t* fprone,
                          const int32_t* down_at, const int32_t* up_at,
                          const uint8_t* side, const int32_t* part_start,
                          const int32_t* part_heal, int32_t* rounds,
                          uint8_t* decision, uint32_t* state, int B, int n, int f,
                          int round_cap,
                          int init_code, int coin_code, int protocol, int adversary,
                          int fault, uint32_t k0, uint32_t k1) {
  const brc::Params p{k0, k1, n, f, round_cap, init_code, coin_code};
  const HostFaultPlanes fp{fprone, down_at, up_at, side, part_start, part_heal};
  if (protocol == fz::kBracha)
    host_run_adversary<fz::kBracha>(adversary, fault, p, inst_ids, faulty, crash_round, fp,
                                    rounds, decision, state, B);
  else
    host_run_adversary<fz::kBenOr>(adversary, fault, p, inst_ids, faulty, crash_round, fp,
                                   rounds, decision, state, B);
}

}  // extern "C"
