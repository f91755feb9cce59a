// The fused round kernel: the whole round loop of a chunk in one launch.
//
// Replaces the TPU kernel byzantinerandomizedconsensus_tpu/ops/pallas_round.py
// (run_chunk, pallas_call at :268, body _make_kernel.kernel at :146), on
// delivery urn2 (spec §4b-v2), n <= 1024 (packing law v1), both protocols
// (Ben-Or §5.1, Bracha §5.2), every static adversary (none, crash, byzantine,
// adaptive, adaptive_min), every §9 fault schedule (none, recover, partition,
// omission), every init law and both coins. The kernel is a template on
// (protocol, adversary, fault schedule), one instantiation each, so each
// pays only for what it needs: the ten without a schedule keep the code they
// had before the schedules came.
//
// Layout. One CTA per instance, one thread per replica (blockDim = n rounded
// up to a warp). Each thread keeps its replica's state word
// (prf.FUSED_STATE_BITS) in a register for the whole loop; the block-wide
// counts the protocol needs (live class totals of each step, the validation
// counts, the termination test) are __syncthreads_count reductions. Each
// thread runs its own urn2 chain of K = min(m, L-m, D) draws; the torch plain
// version runs all lanes to the batch maximum of K with lanes masked, which
// draws the same bits. Each CTA leaves its round loop as soon as its correct
// replicas have decided. Rounds (int32) and decision (uint8) are written,
// one of each per instance, and, where the caller passes a state_out plane,
// each replica's final state word, once, after the loop.
//
// Adversaries. The host computes the sort-backed static selections once
// (models/adversaries.py::AdversaryModel.setup): a (B, n) faulty plane, and
// under crash a (B, n) crash-round plane; under adversary none there is no
// plane, no replica is faulty and replica 0 reports the decision. Faulty
// replicas run the honest state machine (spec §6.3); what reaches the wire
// is computed per sender (crash silence, Bracha's Byzantine word) and the
// class totals are reduced over the wire values. Under the adaptive family
// the totals come from two reductions of the honest non-faulty votes (their
// minority is what the faulty senders push) and the faulty count, taken
// once. Ben-Or's Byzantine pairing shows each of two receiver classes its
// own value from a faulty sender: two words per faulty sender and step, and
// two sets of class totals. The decision is the first correct replica's,
// found by a block reduction (atomicMin in shared memory) after the loop.
//
// Fault schedules (spec §9; pallas_round.py:156-168 and the planes of
// :258-265). The host builds the static planes (models/faults.py::
// setup_faults, which needs the §3.2 sort): the fault-prone set under
// adversary none (any other adversary's faulty plane is that set), the
// outage window [down_at, up_at) under recover, the side and the epoch
// [part_start, part_heal) under partition. Omission is drawn in the loop:
// one burst-gate word per instance and round, drawn by thread 0 and shared
// by a block reduction, and one bit word per fault-prone replica in a burst
// round. A fault-silent sender leaves the live totals before the §5.1b
// validation reductions, for all the steps of its round. Inside a partition
// epoch the block also reduces the side-1 totals (only fault-prone senders
// can be on side 1), side 0 takes the rest, and each receiver's urn reads
// its own side's; validation keeps the global totals. With a schedule every
// adversary reduces its wire totals sender by sender (the adaptive family's
// closed form and Ben-Or's "nobody is silent" hold only without one). The
// termination test and the reporting replica stay on the adversary's faulty
// set: fault-prone replicas of a benign adversary are correct and decide.
//
// Bound. Integer issue: a threefry word costs about 72 integer operations and
// a chain draw about 9, against a few bytes per instance and replica moved to
// or from device memory. wgmma, TMA and the tensor cores do not apply to this
// integer workload.
//
// Known and left for later: warp divergence in the chain. K runs from 0 to
// D = 170 at config4's balanced steps, and a warp waits for its longest lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_round.cuh"

namespace {

using brc::Sent;
namespace fz = brc::fused;

// The live class totals of one wire over the block: the senders for which
// `on` holds, by value; the ⊥ total only where a wire may carry ⊥.
template <bool BOT>
__device__ __forceinline__ void reduce_totals(bool on, uint32_t own, int& T0, int& T1,
                                              int& T2) {
  T0 = __syncthreads_count(on && own == 0u);
  T1 = __syncthreads_count(on && own == 1u);
  T2 = BOT ? __syncthreads_count(on && own == 2u) : 0;
}

// One broadcast step as receiver v sees it: the sender's own message
// through the adversary, then the block's live class totals. `valid` is
// the step's validation (spec §5.1b), a function of the value; BOT says
// whether an honest value may be ⊥. `fs` is what the round's fault schedule
// does to v (FAULT != kNone).
template <int PROTO, int ADV, int FAULT, bool BOT, class Valid>
__device__ __forceinline__ Sent broadcast(const brc::Params& p, uint32_t inst,
                                          uint32_t rnd, uint32_t t, uint32_t v,
                                          bool active, bool faulty, int crash_round,
                                          int F, uint32_t honest, brc::Fault fs,
                                          bool cut, Valid valid) {
  constexpr bool kAdaptive = ADV == fz::kAdaptive || ADV == fz::kAdaptiveMin;
  constexpr bool kTwoFaced = ADV == fz::kByzantine && PROTO == fz::kBenOr;
  if constexpr (FAULT == fz::kNone && kAdaptive) {
    // Nobody is silent: the totals in closed form from the honest counts.
    const int h0 = __syncthreads_count(active && !faulty && honest == 0u);
    const int h1 = __syncthreads_count(active && !faulty && honest == 1u);
    return brc::adaptive_sent<ADV>(v, p.n, honest, faulty, F, h0, h1,
                                   p.n - F - h0 - h1, valid(0u), valid(1u), valid(2u));
  } else if constexpr (FAULT == fz::kNone && kTwoFaced) {
    const uint32_t c0v = faulty ? brc::two_faced_value(p, inst, rnd, t, v, 0u) : honest;
    const uint32_t c1v = faulty ? brc::two_faced_value(p, inst, rnd, t, v, 1u) : honest;
    const int a0 = __syncthreads_count(active && c0v == 0u);
    const int a1 = __syncthreads_count(active && c0v == 1u);
    const int b0 = __syncthreads_count(active && c1v == 0u);
    const int b1 = __syncthreads_count(active && c1v == 1u);
    const bool h = v >= (uint32_t)(p.n + 1) / 2;
    // Nobody is silent: ⊥ is whatever is left of n.
    return h ? Sent{c1v, true, b0, b1, p.n - b0 - b1, 0u}
             : Sent{c0v, true, a0, a1, p.n - a0 - a1, 0u};
  } else if constexpr (kTwoFaced) {
    // Each receiver class has its own wire; ⊥ is a live message.
    const uint32_t c0v = faulty ? brc::two_faced_value(p, inst, rnd, t, v, 0u) : honest;
    const uint32_t c1v = faulty ? brc::two_faced_value(p, inst, rnd, t, v, 1u) : honest;
    const bool live = !fs.silent;
    const bool h = v >= (uint32_t)(p.n + 1) / 2;
    Sent a{c0v, live, 0, 0, 0, 0u, 0, 0, 0}, b{c1v, live, 0, 0, 0, 0u, 0, 0, 0};
    reduce_totals<true>(active && live, c0v, a.M0, a.M1, a.M2);
    reduce_totals<true>(active && live, c1v, b.M0, b.M1, b.M2);
    Sent s = h ? b : a;
    if constexpr (FAULT == fz::kPartition) {
      int S0 = 0, S1 = 0, S2 = 0;
      if (cut) {
        int A0, A1, A2, B0, B1, B2;
        reduce_totals<true>(active && live && fs.side1, c0v, A0, A1, A2);
        reduce_totals<true>(active && live && fs.side1, c1v, B0, B1, B2);
        S0 = h ? B0 : A0;
        S1 = h ? B1 : A1;
        S2 = h ? B2 : A2;
      }
      brc::own_side_totals(s, fs.side1, S0, S1, S2);
    }
    return s;
  } else {
    // The totals reduced sender by sender over the wire.
    Sent s;
    if constexpr (kAdaptive) {
      const int h0 = __syncthreads_count(active && !faulty && honest == 0u);
      const int h1 = __syncthreads_count(active && !faulty && honest == 1u);
      s = brc::adaptive_wire<ADV>(v, p.n, honest, faulty, h0, h1);
    } else {
      s = brc::inject<PROTO, ADV>(p, inst, rnd, t, v, honest, faulty, crash_round);
    }
    s.live = s.live && !fs.silent && valid(s.own);
    reduce_totals<BOT>(active && s.live, s.own, s.M0, s.M1, s.M2);
    if constexpr (FAULT == fz::kPartition) {
      int S0 = 0, S1 = 0, S2 = 0;
      if (cut) reduce_totals<BOT>(active && s.live && fs.side1, s.own, S0, S1, S2);
      brc::own_side_totals(s, fs.side1, S0, S1, S2);
    }
    return s;
  }
}

// The §9 planes of one chunk (device pointers, null where the schedule has
// none): fprone, side (B, n) uint8; down_at, up_at (B, n) int32;
// part_start, part_heal (B,) int32.
struct FaultPlanes {
  const uint8_t* fprone;
  const int32_t* down_at;
  const int32_t* up_at;
  const uint8_t* side;
  const int32_t* part_start;
  const int32_t* part_heal;
};

template <int PROTO, int ADV, int FAULT>
__global__ void __launch_bounds__(1024)
fused_round_kernel(const int32_t* __restrict__ inst_ids,
                   const uint8_t* __restrict__ faulty_plane,
                   const int32_t* __restrict__ crash_plane, FaultPlanes fp,
                   int32_t* __restrict__ rounds_out,
                   uint8_t* __restrict__ decision_out, uint32_t* __restrict__ state_out,
                   brc::Params p) {
  constexpr bool kLying = ADV == fz::kByzantine || ADV == fz::kAdaptive ||
                          ADV == fz::kAdaptiveMin;
  const int b = blockIdx.x;
  const uint32_t v = threadIdx.x;
  const bool active = (int)v < p.n;
  const uint32_t inst = (uint32_t)inst_ids[b];
  const size_t at = (size_t)b * p.n + v;
  bool faulty = false;
  int crash_round = 0, F = 0;
  if constexpr (ADV != fz::kNone) faulty = active && faulty_plane[at] != 0;
  if constexpr (ADV == fz::kCrash) crash_round = active ? crash_plane[at] : 0;
  if constexpr ((ADV == fz::kAdaptive || ADV == fz::kAdaptiveMin) && FAULT == fz::kNone)
    F = __syncthreads_count(faulty);
  // The schedule's static state of replica v (spec §9).
  bool fprone = false, side = false;
  int down_at = 0, up_at = 0, part_start = 0, part_heal = 0;
  // Any adversary but none selects the fault-prone set as its faulty set.
  if constexpr (FAULT != fz::kNone && ADV != fz::kNone) fprone = faulty;
  if constexpr (FAULT != fz::kNone && ADV == fz::kNone) fprone = active && fp.fprone[at] != 0;
  if constexpr (FAULT == fz::kRecover) {
    down_at = active ? fp.down_at[at] : 0;
    up_at = active ? fp.up_at[at] : 0;
  }
  if constexpr (FAULT == fz::kPartition) {
    side = active && fp.side[at] != 0;
    part_start = fp.part_start[b];
    part_heal = fp.part_heal[b];
  }
  auto any = [](uint32_t) { return true; };

  uint32_t word = active ? brc::init_est(p, inst, v) : 0u;
  int done_at = -1;
  for (int r = 0; r < p.round_cap; ++r) {
    const uint32_t rnd = (uint32_t)r;
    const uint32_t est = brc::word_est(word);
    // What the schedule does to v this round: the same for every step.
    brc::Fault fs{false, false};
    bool cut = false;
    if constexpr (FAULT == fz::kRecover) fs.silent = brc::recover_silent(fprone, down_at, up_at, r);
    if constexpr (FAULT == fz::kOmission) {
      const bool burst = __syncthreads_or(v == 0u && brc::omission_burst(p, inst, rnd));
      fs.silent = brc::omission_silent(p, inst, rnd, v, fprone, burst);
    }
    if constexpr (FAULT == fz::kPartition) {
      cut = brc::partition_cut(part_start, part_heal, r);
      fs.side1 = cut && side;
    }
    int c0, c1;
    if constexpr (PROTO == fz::kBracha) {
      // Step 0: est on the wire.
      const Sent s0 = broadcast<PROTO, ADV, FAULT, false>(
          p, inst, rnd, 0u, v, active, faulty, crash_round, F, est, fs, cut, any);
      uint32_t x = 0u;
      if (active) {
        brc::deliver<ADV, FAULT>(p, inst, rnd, 0u, v, s0, &c0, &c1);
        x = brc::bracha_vote0(c0, c1);
      }
      // Step 1: invalid messages join the silent set before delivery.
      const Sent s1 = broadcast<PROTO, ADV, FAULT, false>(
          p, inst, rnd, 1u, v, active, faulty, crash_round, F, x, fs, cut,
          [&](uint32_t val) { return brc::step1_valid(p, val, s0.M0, s0.M1); });
      uint32_t z = 0u;
      if (active) {
        brc::deliver<ADV, FAULT>(p, inst, rnd, 1u, v, s1, &c0, &c1);
        z = brc::bracha_vote1(p, c0, c1);
      }
      // Step 2, coin and decide. Decided replicas keep their word and skip
      // the draw, whose counts only their own update reads.
      const Sent s2 = broadcast<PROTO, ADV, FAULT, true>(
          p, inst, rnd, 2u, v, active, faulty, crash_round, F, z, fs, cut,
          [&](uint32_t val) { return brc::step2_valid(p, val, s1.M0, s1.M1); });
      if (active && !brc::word_decided(word)) {
        brc::deliver<ADV, FAULT>(p, inst, rnd, 2u, v, s2, &c0, &c1);
        word = brc::bracha_update(p, inst, rnd, v, word, c0, c1);
      }
    } else {
      // Report: est on the wire.
      const Sent s0 = broadcast<PROTO, ADV, FAULT, false>(
          p, inst, rnd, 0u, v, active, faulty, crash_round, F, est, fs, cut, any);
      uint32_t prop = 0u;
      if (active) {
        brc::deliver<ADV, FAULT>(p, inst, rnd, 0u, v, s0, &c0, &c1);
        prop = brc::benor_report(p, kLying, c0, c1);
      }
      // Propose, coin and decide.
      const Sent s1 = broadcast<PROTO, ADV, FAULT, true>(
          p, inst, rnd, 1u, v, active, faulty, crash_round, F, prop, fs, cut, any);
      if (active && !brc::word_decided(word)) {
        brc::deliver<ADV, FAULT>(p, inst, rnd, 1u, v, s1, &c0, &c1);
        word = brc::benor_update(p, kLying, inst, rnd, v, word, c0, c1);
      }
    }

    // Termination and the reporter stay on the adversary's faulty set.
    const int undone = __syncthreads_count(active && !faulty && !brc::word_decided(word));
    if (undone == 0) {
      done_at = r + 1;
      break;
    }
  }
  // The first correct replica reports the instance.
  int first = 0;
  if constexpr (ADV != fz::kNone) {
    __shared__ int first_correct;
    if (v == 0) first_correct = p.n;
    __syncthreads();
    if (active && !faulty) atomicMin(&first_correct, (int)v);
    __syncthreads();
    first = first_correct;
  }
  if ((int)v == first) {
    rounds_out[b] = done_at >= 0 ? done_at : p.round_cap;
    decision_out[b] = done_at >= 0 ? (uint8_t)brc::word_decided_val(word) : (uint8_t)2;
  }
  if (state_out != nullptr && active) state_out[at] = word;
}

struct Launch {
  int B, threads;
  cudaStream_t stream;
  const int32_t* inst_ids;
  const uint8_t* faulty;
  const int32_t* crash_round;
  FaultPlanes fp;
  int32_t* rounds;
  uint8_t* decision;
  uint32_t* state;
  brc::Params p;
};

template <int PROTO, int ADV, int FAULT>
void launch(const Launch& l) {
  fused_round_kernel<PROTO, ADV, FAULT><<<l.B, l.threads, 0, l.stream>>>(
      l.inst_ids, l.faulty, l.crash_round, l.fp, l.rounds, l.decision, l.state, l.p);
}

template <int PROTO, int ADV>
bool launch_fault(int fault, const Launch& l) {
  switch (fault) {
    case fz::kNone: launch<PROTO, ADV, fz::kNone>(l); return true;
    case fz::kRecover: launch<PROTO, ADV, fz::kRecover>(l); return true;
    case fz::kPartition: launch<PROTO, ADV, fz::kPartition>(l); return true;
    case fz::kOmission: launch<PROTO, ADV, fz::kOmission>(l); return true;
    default: return false;
  }
}

template <int PROTO>
bool launch_adversary(int adversary, int fault, const Launch& l) {
  switch (adversary) {
    case fz::kNone: return launch_fault<PROTO, fz::kNone>(fault, l);
    case fz::kCrash: return launch_fault<PROTO, fz::kCrash>(fault, l);
    case fz::kByzantine: return launch_fault<PROTO, fz::kByzantine>(fault, l);
    case fz::kAdaptive: return launch_fault<PROTO, fz::kAdaptive>(fault, l);
    case fz::kAdaptiveMin: return launch_fault<PROTO, fz::kAdaptiveMin>(fault, l);
    default: return false;
  }
}

}  // namespace

// Launch one chunk of B instances on `stream`. Pointers are device pointers:
// inst_ids (B,) int32; faulty (B, n) uint8 (null under adversary none);
// crash_round (B, n) int32 (read only under crash); the §9 planes (read
// only under their schedule): fprone (B, n) uint8 under adversary none (any
// other adversary's faulty plane is the fault-prone set),
// down_at and up_at (B, n) int32 under recover, side (B, n) uint8 and
// part_start, part_heal (B,) int32 under partition; rounds (B,) int32,
// decision (B,) uint8; state (B, n) uint32, the final state words, or null
// for none. protocol: 0 benor, 1 bracha; adversary: 0 none,
// 1 crash, 2 byzantine, 3 adaptive, 4 adaptive_min; fault: 0 none,
// 1 recover, 2 partition, 3 omission. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int brc_fused_round_launch(const int32_t* inst_ids, const uint8_t* faulty,
                                      const int32_t* crash_round, const uint8_t* fprone,
                                      const int32_t* down_at, const int32_t* up_at,
                                      const uint8_t* side, const int32_t* part_start,
                                      const int32_t* part_heal, int32_t* rounds,
                                      uint8_t* decision, uint32_t* state, int B, int n, int f,
                                      int round_cap, int init_code, int coin_code,
                                      int protocol, int adversary, int fault,
                                      uint32_t k0, uint32_t k1, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > 1024) return (int)cudaErrorInvalidValue;
  if (adversary != fz::kNone && faulty == nullptr) return (int)cudaErrorInvalidValue;
  if (adversary == fz::kCrash && crash_round == nullptr) return (int)cudaErrorInvalidValue;
  if (fault != fz::kNone && adversary == fz::kNone && fprone == nullptr)
    return (int)cudaErrorInvalidValue;
  if (fault == fz::kRecover && (down_at == nullptr || up_at == nullptr))
    return (int)cudaErrorInvalidValue;
  if (fault == fz::kPartition &&
      (side == nullptr || part_start == nullptr || part_heal == nullptr))
    return (int)cudaErrorInvalidValue;
  const Launch l{B, (n + 31) / 32 * 32, (cudaStream_t)stream, inst_ids, faulty,
                 crash_round, FaultPlanes{fprone, down_at, up_at, side, part_start, part_heal},
                 rounds, decision, state,
                 brc::Params{k0, k1, n, f, round_cap, init_code, coin_code}};
  bool ok;
  if (protocol == fz::kBracha)
    ok = launch_adversary<fz::kBracha>(adversary, fault, l);
  else if (protocol == fz::kBenOr)
    ok = launch_adversary<fz::kBenOr>(adversary, fault, l);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
