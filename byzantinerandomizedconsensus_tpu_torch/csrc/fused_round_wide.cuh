// The wide fused round kernel: the round loop of a chunk in one launch for
// the laws and sizes past fused_round.cu's (urn2 at n <= 1024).
//
// Replaces, beside fused_round.cu, the TPU kernel
// byzantinerandomizedconsensus_tpu/ops/pallas_round.py (run_chunk,
// pallas_call at :268, body _make_kernel.kernel at :146) on the rest of its
// surface: delivery urn (spec §4b) and urn3 (spec §4c) for n <= 4096, urn2
// (spec §4b-v2) for 1024 < n <= 4096 and committee (spec §10) for n <= 2^20,
// both protocols, every static adversary, every §9 fault schedule, every
// init law and both coins. The §4b draws are urn_step.cuh's urn_counts, the
// per-step urn kernel's own function, so the two kernels share one
// implementation of the law.
//
// Layout. One CTA per instance, so that every per-instance count stays a
// reduction inside the block. Thread `tid` owns replicas v = tid + k·blockDim
// (coalesced for k fixed). The layout R is a template argument and fixes the
// packing law: R = 1 (n <= 1024, law v1) and R = 4 (n <= 4096, law v2) keep
// each replica's state word in a register, blockDim = ceil(n / R) rounded up
// to a warp; R = 0 (n > 4096, law v3, the committee family only) streams the
// words of ceil(n / 1024) replicas per thread from a (B, n) u32 scratch plane
// in device memory (512 KB per instance at n = 2^17: more than a block's 227
// KB of shared memory). Several replicas per thread make the block's counts
// sums, not predicates: block_sum reduces up to 12 counters at once with
// warp shuffles and one pass through shared memory.
//
// A step is three passes over a thread's replicas: (adaptive family only)
// the honest non-faulty votes, whose minority the faulty senders push;
// the senders, whose live wire totals the block sums; and the receivers,
// which recompute their own wire (one Byzantine PRF word per faulty sender,
// the §9 silence) rather than keep it, draw their delivery and update their
// word. Under the committee family each replica draws its membership word
// once per step, in the senders' pass, and keeps the bit in its word for its
// receiver pass (spec §10.4: adversary inject -> §9 silences -> membership
// silence -> §5.1b validation -> delivery law). Membership silences anyone,
// so the totals are reduced sender by sender under every adversary: the
// closed forms of fused_round.cu (adaptive family, Ben-Or's two-faced
// pairing) assume full-mesh senders and are not used here.
//
// The state word is prf.FUSED_STATE_BITS plus, between the steps of a
// round, the replica's honest value of the step in bits 5-6 and its
// committee membership in bit 7. Where the caller asks for the final state,
// layouts R = 1 and R = 4 write each replica's word (brc::state_word, those
// bits cleared) once after the loop to a (B, n) state_out plane; under R = 0
// the scratch plane already holds the words, and the wrapper reads them
// there.
//
// Bound. Integer issue, as fused_round.cu: a threefry word is about 72
// integer operations, a cheap-law segment about 12, a chain draw about 9.
// Under R = 0 the scratch plane adds at least a read and a write of each
// word per round.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "block_sum.cuh"
#include "fused_round.cuh"
#include "urn_step.cuh"

// The two per-replica functions of a step are called, not inlined, in the
// kernel: each is compiled once per instantiation instead of once per
// replica slot and step, which keeps the build of the forty instantiations
// of a library short; a call costs a few instructions beside the PRF words
// each does.
#ifdef __CUDACC__
#define BRC_HD_CALL __host__ __device__ __noinline__
#else
#define BRC_HD_CALL inline
#endif

namespace brc {

namespace fused {
// Delivery-law codes of the wide kernel's instantiations
// (ops/fused_round.py::_LAW_CODES).
constexpr int kLawUrn2 = 0;
constexpr int kLawUrn3 = 1;
constexpr int kLawCommittee = 2;
constexpr int kLawUrn = 3;
}  // namespace fused

// The operand planes of one chunk, null where the config has none: faulty
// (B, n) uint8 (adversary != none), crash_round (B, n) int32 (crash), fprone
// (B, n) uint8 (a schedule under adversary none), down_at and up_at (B, n)
// int32 (recover), side (B, n) uint8 and part_start, part_heal (B,) int32
// (partition).
struct Planes {
  const uint8_t* faulty;
  const int32_t* crash_round;
  const uint8_t* fprone;
  const int32_t* down_at;
  const int32_t* up_at;
  const uint8_t* side;
  const int32_t* part_start;
  const int32_t* part_heal;
};

BRC_HD uint32_t word_hv(uint32_t w) { return (w >> 5) & 3u; }
BRC_HD uint32_t set_hv(uint32_t w, uint32_t hv) { return (w & ~0x60u) | (hv << 5); }
BRC_HD bool word_member(uint32_t w) { return ((w >> 7) & 1u) != 0u; }
BRC_HD uint32_t set_member(uint32_t w, bool m) { return (w & ~0x80u) | (m ? 0x80u : 0u); }

// The packing law of a layout: R = 1 runs n <= 1024 (v1), R > 1 n <= 4096
// (v2), R = 0 n > 4096 (v3).
template <int R>
constexpr int kLayoutPack = R == 1 ? 1 : (R == 0 ? 3 : 2);

// Everything one thread computes for one replica between two block
// reductions, for the instantiation (PROTO, ADV, FAULT, LAW) under packing
// law PACK. fused_round_wide_host.inc runs the same functions with the
// reductions written as loops.
template <int PROTO, int ADV, int FAULT, int LAW, int PACK>
struct Wide {
  static constexpr bool kAdaptive = ADV == fused::kAdaptive || ADV == fused::kAdaptiveMin;
  static constexpr bool kTwoFaced = ADV == fused::kByzantine && PROTO == fused::kBenOr;
  static constexpr bool kCut = FAULT == fused::kPartition;
  static constexpr bool kLying = ADV == fused::kByzantine || kAdaptive;
  static constexpr int kSteps = PROTO == fused::kBracha ? 3 : 2;
  // The block's counters of one step: the live wire totals by value (of
  // each receiver class under the two-faced pairing), and inside a
  // partition epoch the same over the isolated side.
  static constexpr int kClass = kTwoFaced ? 6 : 3;
  static constexpr int K = kCut ? 2 * kClass : kClass;

  // Replica v's static state (plane entries at `at`).
  struct Replica {
    bool faulty, fprone, side;
    int crash_round, down_at, up_at;
  };

  static BRC_HD Replica replica(const Planes& pl, size_t at) {
    Replica r{false, false, false, 0, 0, 0};
    if constexpr (ADV != fused::kNone) r.faulty = pl.faulty[at] != 0;
    if constexpr (ADV == fused::kCrash) r.crash_round = pl.crash_round[at];
    // Any adversary but none selects the fault-prone set as its faulty set.
    if constexpr (FAULT != fused::kNone && ADV != fused::kNone) r.fprone = r.faulty;
    if constexpr (FAULT != fused::kNone && ADV == fused::kNone) r.fprone = pl.fprone[at] != 0;
    if constexpr (FAULT == fused::kRecover) {
      r.down_at = pl.down_at[at];
      r.up_at = pl.up_at[at];
    }
    if constexpr (kCut) r.side = pl.side[at] != 0;
    return r;
  }

  // The replica's honest value at step t: its estimate, then the value its
  // previous step chose.
  static BRC_HD uint32_t honest(uint32_t word, uint32_t t) {
    return t == 0u ? word_est(word) : word_hv(word);
  }

  // Adds a replica's honest vote to the adaptive family's counts h[0..1].
  static BRC_HD void vote(const Planes& pl, size_t at, uint32_t word, uint32_t t, int* h) {
    if (pl.faulty[at] != 0) return;
    const uint32_t x = honest(word, t);
    h[0] += x == 0u ? 1 : 0;
    h[1] += x == 1u ? 1 : 0;
  }

  // A sender's wire at one step, as the block counts it and as its own
  // receiver reads it: the value each receiver class sees (own, own1), live
  // after the silences and the validation, and on the isolated side of a
  // partition epoch (side1).
  struct Slot {
    uint32_t own, own1;
    bool live, side1, member;
  };

  static BRC_HD bool valid(const Params& q, uint32_t t, uint32_t x, int g0, int g1) {
    if constexpr (PROTO == fused::kBracha) {
      if (t == 1u) return step1_valid(q, x, g0, g1);
      if (t == 2u) return step2_valid(q, x, g0, g1);
    }
    return true;
  }

  // Replica v as a sender at step t of round r. `mn` is the adaptive
  // family's minority, `burst` and `cut` the round's §9 state, `member` its
  // committee membership (true under the other laws), (g0, g1) the live
  // totals of 0 and 1 of the previous step, q the threshold parameters.
  static BRC_HD_CALL Slot send(const Params& p, const Params& q, uint32_t inst, int r, uint32_t t,
                          uint32_t v, uint32_t word, const Replica& rep, uint32_t mn,
                          bool burst, bool cut, bool member, int g0, int g1) {
    const uint32_t rnd = (uint32_t)r;
    const uint32_t hon = honest(word, t);
    Slot s{hon, hon, true, cut && rep.side, member};
    if constexpr (kAdaptive) {
      if (rep.faulty) s.own = s.own1 = mn;
    } else if constexpr (kTwoFaced) {
      if (rep.faulty) {
        s.own = two_faced_value<PACK>(p, inst, rnd, t, v, 0u);
        s.own1 = two_faced_value<PACK>(p, inst, rnd, t, v, 1u);
      }
    } else {
      const Sent w = inject<PROTO, ADV, PACK>(p, inst, rnd, t, v, hon, rep.faulty,
                                              rep.crash_round);
      s.own = s.own1 = w.own;
      s.live = w.live;
    }
    bool silent = false;
    if constexpr (FAULT == fused::kRecover)
      silent = recover_silent(rep.fprone, rep.down_at, rep.up_at, r);
    if constexpr (FAULT == fused::kOmission)
      silent = omission_silent<PACK>(p, inst, rnd, v, rep.fprone, burst);
    s.live = s.live && member && !silent && valid(q, t, s.own, g0, g1);
    return s;
  }

  // Adds a live sender to the block's counters c[0..K).
  static BRC_HD void tally(const Slot& s, int* c) {
    if (!s.live) return;
    c[0] += s.own == 0u ? 1 : 0;
    c[1] += s.own == 1u ? 1 : 0;
    c[2] += s.own == 2u ? 1 : 0;
    if constexpr (kTwoFaced) {
      c[3] += s.own1 == 0u ? 1 : 0;
      c[4] += s.own1 == 1u ? 1 : 0;
      c[5] += s.own1 == 2u ? 1 : 0;
    }
    if constexpr (kCut) {
      if (s.side1) {
        c[kClass + 0] += s.own == 0u ? 1 : 0;
        c[kClass + 1] += s.own == 1u ? 1 : 0;
        c[kClass + 2] += s.own == 2u ? 1 : 0;
        if constexpr (kTwoFaced) {
          c[kClass + 3] += s.own1 == 0u ? 1 : 0;
          c[kClass + 4] += s.own1 == 1u ? 1 : 0;
          c[kClass + 5] += s.own1 == 2u ? 1 : 0;
        }
      }
    }
  }

  // Receiver v's word after step t of round r, from its own wire `s` and
  // the block's counters `c`: its class's totals (of its own side inside a
  // partition epoch), the delivery law's counts, then the protocol.
  static BRC_HD_CALL uint32_t deliver(const Params& p, const Params& q, uint32_t inst, int r,
                                 uint32_t t, uint32_t v, uint32_t word, const Slot& s,
                                 const int* c, uint32_t mn) {
    const uint32_t rnd = (uint32_t)r;
    bool h = false;
    if constexpr (kTwoFaced) h = v >= (uint32_t)(p.n + 1) / 2;
    const uint32_t own = h ? s.own1 : s.own;
    int M0 = c[0], M1 = c[1], M2 = c[2];
    if constexpr (kTwoFaced) {
      M0 = h ? c[3] : M0;
      M1 = h ? c[4] : M1;
      M2 = h ? c[5] : M2;
    }
    if constexpr (kCut) {
      int S0 = c[kClass + 0], S1 = c[kClass + 1], S2 = c[kClass + 2];
      if constexpr (kTwoFaced) {
        S0 = h ? c[kClass + 3] : S0;
        S1 = h ? c[kClass + 4] : S1;
        S2 = h ? c[kClass + 5] : S2;
      }
      M0 = s.side1 ? S0 : M0 - S0;
      M1 = s.side1 ? S1 : M1 - S1;
      M2 = s.side1 ? S2 : M2 - S2;
    }
    uint32_t pref = 0u;
    if constexpr (ADV == fused::kAdaptive) pref = v >= (uint32_t)(p.n + 1) / 2 ? 1u : 0u;
    if constexpr (ADV == fused::kAdaptiveMin) pref = mn;
    int c0, c1;
    if constexpr (LAW == fused::kLawUrn2) {
      if constexpr (kAdaptive)
        urn2_counts_strata<PACK>(p.k0, p.k1, inst, rnd, t, v, own, s.live, M0, M1, M2, p.n,
                                 p.f, pref, &c0, &c1);
      else
        urn2_counts<PACK>(p.k0, p.k1, inst, rnd, t, v, own, s.live, M0, M1, M2, p.n, p.f,
                          &c0, &c1);
    } else if constexpr (LAW == fused::kLawUrn3) {
      urn3_counts<PACK, kAdaptive>(p.k0, p.k1, inst, rnd, t, v, own, s.live, M0, M1, M2,
                                   p.n, p.f, pref, &c0, &c1);
    } else if constexpr (LAW == fused::kLawUrn) {
      // The per-step urn kernel's draws; its strata follow the adversary
      // code (pref_of: the receiver's class, or the minority mn).
      constexpr int kCode = ADV == fused::kAdaptive      ? kAdvAdaptive
                            : ADV == fused::kAdaptiveMin ? kAdvAdaptiveMin
                                                         : kAdvNone;
      const StepParams sp{p.k0, p.k1, p.n, p.f, rnd, t, kCode};
      urn_counts<PACK>(sp, inst, v, own, s.live, M0, M1, M2, mn, &c0, &c1);
    } else {
      committee_counts<PACK, kAdaptive>(p.k0, p.k1, inst, rnd, t, v, own, s.live, s.member,
                                        M0, M1, M2, p.kq, pref, &c0, &c1);
    }
    if constexpr (PROTO == fused::kBracha) {
      if (t == 0u) return set_hv(word, bracha_vote0(c0, c1));
      if (t == 1u) return set_hv(word, bracha_vote1(q, c0, c1));
      return bracha_update<PACK>(q, inst, rnd, v, word, c0, c1);
    } else {
      if (t == 0u) return set_hv(word, benor_report(q, kLying, c0, c1));
      return benor_update<PACK>(q, kLying, inst, rnd, v, word, c0, c1);
    }
  }
};

// The threshold parameters: (n, f) replaced by (nq, fq).
BRC_HD Params quorum(const Params& p) {
  Params q = p;
  q.n = p.nq;
  q.f = p.fq;
  return q;
}

}  // namespace brc

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace brc {

template <int PROTO, int ADV, int FAULT, int LAW, int R>
__global__ void __launch_bounds__(1024)
fused_round_wide_kernel(const int32_t* __restrict__ inst_ids, Planes pl,
                        uint32_t* __restrict__ scratch, int32_t* __restrict__ rounds_out,
                        uint8_t* __restrict__ decision_out, uint32_t* __restrict__ state_out,
                        Params p) {
  constexpr int PACK = kLayoutPack<R>;
  using W = Wide<PROTO, ADV, FAULT, LAW, PACK>;
  const int b = blockIdx.x;
  const uint32_t tid = threadIdx.x, nt = blockDim.x;
  const int slots = R > 0 ? R : (p.n + (int)nt - 1) / (int)nt;
  const size_t row = (size_t)b * p.n;
  const uint32_t inst = (uint32_t)inst_ids[b];
  const Params q = quorum(p);
  uint32_t reg[R > 0 ? R : 1];
  auto word = [&](int k) -> uint32_t& {
    if constexpr (R > 0)
      return reg[k];
    else
      return scratch[row + tid + (size_t)k * nt];
  };
  // f(k, v) for each of this thread's replicas v < n.
  auto each = [&](auto&& f) {
    if constexpr (R > 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const uint32_t v = tid + (uint32_t)k * nt;
        if ((int)v < p.n) f(k, v);
      }
    } else {
      for (int k = 0; k < slots; ++k) {
        const uint32_t v = tid + (uint32_t)k * nt;
        if ((int)v < p.n) f(k, v);
      }
    }
  };
  if constexpr (R > 0) {
#pragma unroll
    for (int k = 0; k < R; ++k) reg[k] = 0u;
  }
  each([&](int k, uint32_t v) { word(k) = init_est<PACK>(p, inst, v); });
  int part_start = 0, part_heal = 0;
  if constexpr (W::kCut) {
    part_start = pl.part_start[b];
    part_heal = pl.part_heal[b];
  }

  int done_at = -1;
  for (int r = 0; r < p.round_cap; ++r) {
    bool burst = false;
    if constexpr (FAULT == fused::kOmission)
      burst = __syncthreads_or(tid == 0u && omission_burst<PACK>(p, inst, (uint32_t)r));
    const bool cut = W::kCut && partition_cut(part_start, part_heal, r);
    int g0 = 0, g1 = 0;
#pragma unroll 1
    for (int step = 0; step < W::kSteps; ++step) {
      const uint32_t t = (uint32_t)step;
      uint32_t mn = 0u;
      if constexpr (W::kAdaptive) {
        int h[2] = {0, 0};
        each([&](int k, uint32_t v) { W::vote(pl, row + v, word(k), t, h); });
        block_sum(h);
        mn = minority(h[0], h[1]);
      }
      // The senders: membership, wire, silences, validation; the block's totals.
      int c[W::K];
#pragma unroll
      for (int i = 0; i < W::K; ++i) c[i] = 0;
      each([&](int k, uint32_t v) {
        bool member = true;
        if constexpr (LAW == fused::kLawCommittee) {
          member = committee_member<PACK>(p.k0, p.k1, inst, (uint32_t)r, t, v, p.n, p.csize);
          word(k) = set_member(word(k), member);
        }
        W::tally(W::send(p, q, inst, r, t, v, word(k), W::replica(pl, row + v), mn, burst,
                         cut, member, g0, g1),
                 c);
      });
      block_sum(c);
      // The receivers. At the round's last step decided replicas keep their
      // word: only their own update would read the draw.
      const bool last = step + 1 == W::kSteps;
      each([&](int k, uint32_t v) {
        uint32_t& w = word(k);
        if (last && word_decided(w)) return;
        const bool member = LAW == fused::kLawCommittee ? word_member(w) : true;
        const auto s = W::send(p, q, inst, r, t, v, w, W::replica(pl, row + v), mn, burst,
                               cut, member, g0, g1);
        w = W::deliver(p, q, inst, r, t, v, w, s, c, mn);
      });
      g0 = c[0];
      g1 = c[1];
    }
    // Termination and the reporter stay on the adversary's faulty set.
    int undone[1] = {0};
    each([&](int k, uint32_t v) {
      const bool faulty = ADV != fused::kNone && pl.faulty[row + v] != 0;
      undone[0] += !faulty && !word_decided(word(k)) ? 1 : 0;
    });
    block_sum(undone);
    if (undone[0] == 0) {
      done_at = r + 1;
      break;
    }
  }
  // The first correct replica reports the instance.
  __shared__ int first_correct;
  if (tid == 0u) first_correct = p.n;
  __syncthreads();
  int mine = p.n;
  each([&](int, uint32_t v) {
    const bool faulty = ADV != fused::kNone && pl.faulty[row + v] != 0;
    if (!faulty && (int)v < mine) mine = (int)v;
  });
  if (mine < p.n) atomicMin(&first_correct, mine);
  __syncthreads();
  const int first = first_correct;
  each([&](int k, uint32_t v) {
    if ((int)v != first) return;
    rounds_out[b] = done_at >= 0 ? done_at : p.round_cap;
    decision_out[b] = done_at >= 0 ? (uint8_t)word_decided_val(word(k)) : (uint8_t)2;
  });
  if constexpr (R > 0) {
    if (state_out != nullptr)
      each([&](int k, uint32_t v) { state_out[row + v] = state_word(word(k)); });
  }
}

// Host side of one (LAW, R) library: the launch of every (protocol,
// adversary, fault schedule) instantiation.
struct WideLaunch {
  int B, threads;
  cudaStream_t stream;
  const int32_t* inst_ids;
  Planes pl;
  uint32_t* scratch;
  int32_t* rounds;
  uint8_t* decision;
  uint32_t* state;
  Params p;
};

template <int PROTO, int ADV, int FAULT, int LAW, int R>
void wide_launch(const WideLaunch& l) {
  fused_round_wide_kernel<PROTO, ADV, FAULT, LAW, R><<<l.B, l.threads, 0, l.stream>>>(
      l.inst_ids, l.pl, l.scratch, l.rounds, l.decision, l.state, l.p);
}

template <int PROTO, int ADV, int LAW, int R>
bool wide_launch_fault(int fault, const WideLaunch& l) {
  switch (fault) {
    case fused::kNone: wide_launch<PROTO, ADV, fused::kNone, LAW, R>(l); return true;
    case fused::kRecover: wide_launch<PROTO, ADV, fused::kRecover, LAW, R>(l); return true;
    case fused::kPartition: wide_launch<PROTO, ADV, fused::kPartition, LAW, R>(l); return true;
    case fused::kOmission: wide_launch<PROTO, ADV, fused::kOmission, LAW, R>(l); return true;
    default: return false;
  }
}

template <int PROTO, int LAW, int R>
bool wide_launch_adversary(int adversary, int fault, const WideLaunch& l) {
  switch (adversary) {
    case fused::kNone: return wide_launch_fault<PROTO, fused::kNone, LAW, R>(fault, l);
    case fused::kCrash: return wide_launch_fault<PROTO, fused::kCrash, LAW, R>(fault, l);
    case fused::kByzantine: return wide_launch_fault<PROTO, fused::kByzantine, LAW, R>(fault, l);
    case fused::kAdaptive: return wide_launch_fault<PROTO, fused::kAdaptive, LAW, R>(fault, l);
    case fused::kAdaptiveMin:
      return wide_launch_fault<PROTO, fused::kAdaptiveMin, LAW, R>(fault, l);
    default: return false;
  }
}

// The smallest and largest n of layout R.
template <int R>
constexpr int kLayoutMinN = R == 1 ? 1 : (R == 0 ? 4097 : 1025);
template <int R>
constexpr int kLayoutMaxN = R == 1 ? 1024 : (R == 0 ? (1 << 20) : 4096);

// The entry of one (LAW, R) library: validates the operands as
// fused_round.cu does, picks blockDim, launches, and returns
// cudaGetLastError() (0 on success).
template <int LAW, int R>
int wide_entry(const int32_t* inst_ids, const Planes& pl, uint32_t* scratch, int32_t* rounds,
               uint8_t* decision, uint32_t* state, int B, const Params& p, int protocol,
               int adversary, int fault, void* stream) {
  if (B <= 0) return 0;
  if (p.n < kLayoutMinN<R> || p.n > kLayoutMaxN<R>) return (int)cudaErrorInvalidValue;
  if (R == 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (adversary != fused::kNone && pl.faulty == nullptr) return (int)cudaErrorInvalidValue;
  if (adversary == fused::kCrash && pl.crash_round == nullptr) return (int)cudaErrorInvalidValue;
  if (fault != fused::kNone && adversary == fused::kNone && pl.fprone == nullptr)
    return (int)cudaErrorInvalidValue;
  if (fault == fused::kRecover && (pl.down_at == nullptr || pl.up_at == nullptr))
    return (int)cudaErrorInvalidValue;
  if (fault == fused::kPartition &&
      (pl.side == nullptr || pl.part_start == nullptr || pl.part_heal == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per_thread = R > 0 ? (p.n + R - 1) / R : 1024;
  const int threads = R > 0 ? (per_thread + 31) / 32 * 32 : 1024;
  const WideLaunch l{B, threads, (cudaStream_t)stream, inst_ids, pl, scratch, rounds, decision,
                     state, p};
  bool ok;
  if (protocol == fused::kBracha)
    ok = wide_launch_adversary<fused::kBracha, LAW, R>(adversary, fault, l);
  else if (protocol == fused::kBenOr)
    ok = wide_launch_adversary<fused::kBenOr, LAW, R>(adversary, fault, l);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace brc

// One (LAW, R) library's C entry, brc_fused_round_wide_launch: inst_ids (B,)
// int32; the planes as brc::Planes (null where the config has none);
// scratch (B, n) uint32 under R = 0, else null; rounds (B,) int32, decision
// (B,) uint8; state (B, n) uint32 for the final state words under R = 1 and
// R = 4, or null (under R = 0 they are the scratch plane's); the config's
// (n, f), round cap, init and coin codes, threshold (nq, fq), committee
// quota kq and size csize; protocol, adversary and fault codes as
// fused_round.cu's; the PRF key; the stream.
#define BRC_WIDE_ENTRY(LAW, R)                                                              \
  extern "C" int brc_fused_round_wide_launch(                                               \
      const int32_t* inst_ids, const uint8_t* faulty, const int32_t* crash_round,           \
      const uint8_t* fprone, const int32_t* down_at, const int32_t* up_at,                  \
      const uint8_t* side, const int32_t* part_start, const int32_t* part_heal,             \
      uint32_t* scratch, int32_t* rounds, uint8_t* decision, uint32_t* state, int B, int n, \
      int f, int round_cap, int init_code, int coin_code, int nq, int fq, int kq,          \
      int csize,                                                                            \
      int protocol, int adversary, int fault, uint32_t k0, uint32_t k1, void* stream) {     \
    const brc::Planes pl{faulty, crash_round, fprone, down_at, up_at, side, part_start,    \
                         part_heal};                                                        \
    const brc::Params p{k0, k1, n, f, round_cap, init_code, coin_code, nq, fq, kq, csize}; \
    return brc::wide_entry<LAW, R>(inst_ids, pl, scratch, rounds, decision, state, B, p,    \
                                   protocol, adversary, fault, stream);                     \
  }

#endif  // __CUDACC__
