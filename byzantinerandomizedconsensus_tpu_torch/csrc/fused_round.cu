// The fused round kernel: the whole round loop of a chunk in one launch.
//
// Replaces the TPU kernel byzantinerandomizedconsensus_tpu/ops/pallas_round.py
// (run_chunk, pallas_call at :268, body _make_kernel.kernel at :146), on
// delivery urn2 (spec §4b-v2), faults none, n <= 1024 (packing law v1), both
// protocols (Ben-Or §5.1, Bracha §5.2), every static adversary (none, crash,
// byzantine, adaptive, adaptive_min), every init law and both coins. The
// kernel is a template on (protocol, adversary), one instantiation each, so
// each adversary pays only for what it needs.
//
// Layout. One CTA per instance, one thread per replica (blockDim = n rounded
// up to a warp). Each thread keeps its replica's state word
// (prf.FUSED_STATE_BITS) in a register for the whole loop; the block-wide
// counts the protocol needs (live class totals of each step, the validation
// counts, the termination test) are __syncthreads_count reductions. Each
// thread runs its own urn2 chain of K = min(m, L-m, D) draws; the torch plain
// version runs all lanes to the batch maximum of K with lanes masked, which
// draws the same bits. Each CTA leaves its round loop as soon as its correct
// replicas have decided. Only rounds (int32) and decision (uint8) are
// written, one of each per instance.
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

// One broadcast step as receiver v sees it: the sender's own message
// through the adversary, then the block's live class totals. `valid` is
// the step's validation (spec §5.1b), a function of the value; BOT says
// whether an honest value may be ⊥.
template <int PROTO, int ADV, bool BOT, class Valid>
__device__ __forceinline__ Sent broadcast(const brc::Params& p, uint32_t inst,
                                          uint32_t rnd, uint32_t t, uint32_t v,
                                          bool active, bool faulty, int crash_round,
                                          int F, uint32_t honest, Valid valid) {
  if constexpr (ADV == fz::kAdaptive || ADV == fz::kAdaptiveMin) {
    const int h0 = __syncthreads_count(active && !faulty && honest == 0u);
    const int h1 = __syncthreads_count(active && !faulty && honest == 1u);
    return brc::adaptive_sent<ADV>(v, p.n, honest, faulty, F, h0, h1,
                                   p.n - F - h0 - h1, valid(0u), valid(1u), valid(2u));
  } else if constexpr (ADV == fz::kByzantine && PROTO == fz::kBenOr) {
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
  } else {
    Sent s = brc::inject<PROTO, ADV>(p, inst, rnd, t, v, honest, faulty, crash_round);
    s.live = s.live && valid(s.own);
    s.M0 = __syncthreads_count(active && s.live && s.own == 0u);
    s.M1 = __syncthreads_count(active && s.live && s.own == 1u);
    if constexpr (BOT) s.M2 = __syncthreads_count(active && s.live && s.own == 2u);
    return s;
  }
}

template <int PROTO, int ADV>
__global__ void __launch_bounds__(1024)
fused_round_kernel(const int32_t* __restrict__ inst_ids,
                   const uint8_t* __restrict__ faulty_plane,
                   const int32_t* __restrict__ crash_plane,
                   int32_t* __restrict__ rounds_out,
                   uint8_t* __restrict__ decision_out, brc::Params p) {
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
  if constexpr (ADV == fz::kAdaptive || ADV == fz::kAdaptiveMin)
    F = __syncthreads_count(faulty);
  auto any = [](uint32_t) { return true; };

  uint32_t word = active ? brc::init_est(p, inst, v) : 0u;
  int done_at = -1;
  for (int r = 0; r < p.round_cap; ++r) {
    const uint32_t rnd = (uint32_t)r;
    const uint32_t est = brc::word_est(word);
    int c0, c1;
    if constexpr (PROTO == fz::kBracha) {
      // Step 0: est on the wire.
      const Sent s0 = broadcast<PROTO, ADV, false>(p, inst, rnd, 0u, v, active, faulty,
                                                   crash_round, F, est, any);
      uint32_t x = 0u;
      if (active) {
        brc::deliver<ADV>(p, inst, rnd, 0u, v, s0, &c0, &c1);
        x = brc::bracha_vote0(c0, c1);
      }
      // Step 1: invalid messages join the silent set before delivery.
      const Sent s1 = broadcast<PROTO, ADV, false>(
          p, inst, rnd, 1u, v, active, faulty, crash_round, F, x,
          [&](uint32_t val) { return brc::step1_valid(p, val, s0.M0, s0.M1); });
      uint32_t z = 0u;
      if (active) {
        brc::deliver<ADV>(p, inst, rnd, 1u, v, s1, &c0, &c1);
        z = brc::bracha_vote1(p, c0, c1);
      }
      // Step 2, coin and decide. Decided replicas keep their word and skip
      // the draw, whose counts only their own update reads.
      const Sent s2 = broadcast<PROTO, ADV, true>(
          p, inst, rnd, 2u, v, active, faulty, crash_round, F, z,
          [&](uint32_t val) { return brc::step2_valid(p, val, s1.M0, s1.M1); });
      if (active && !brc::word_decided(word)) {
        brc::deliver<ADV>(p, inst, rnd, 2u, v, s2, &c0, &c1);
        word = brc::bracha_update(p, inst, rnd, v, word, c0, c1);
      }
    } else {
      // Report: est on the wire.
      const Sent s0 = broadcast<PROTO, ADV, false>(p, inst, rnd, 0u, v, active, faulty,
                                                   crash_round, F, est, any);
      uint32_t prop = 0u;
      if (active) {
        brc::deliver<ADV>(p, inst, rnd, 0u, v, s0, &c0, &c1);
        prop = brc::benor_report(p, kLying, c0, c1);
      }
      // Propose, coin and decide.
      const Sent s1 = broadcast<PROTO, ADV, true>(p, inst, rnd, 1u, v, active, faulty,
                                                  crash_round, F, prop, any);
      if (active && !brc::word_decided(word)) {
        brc::deliver<ADV>(p, inst, rnd, 1u, v, s1, &c0, &c1);
        word = brc::benor_update(p, kLying, inst, rnd, v, word, c0, c1);
      }
    }

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
}

template <int PROTO, int ADV>
void launch(int B, int threads, cudaStream_t stream, const int32_t* inst_ids,
            const uint8_t* faulty, const int32_t* crash_round, int32_t* rounds,
            uint8_t* decision, const brc::Params& p) {
  fused_round_kernel<PROTO, ADV><<<B, threads, 0, stream>>>(inst_ids, faulty, crash_round,
                                                           rounds, decision, p);
}

template <int PROTO>
bool launch_adversary(int adversary, int B, int threads, cudaStream_t stream,
                      const int32_t* inst_ids, const uint8_t* faulty,
                      const int32_t* crash_round, int32_t* rounds, uint8_t* decision,
                      const brc::Params& p) {
  switch (adversary) {
    case fz::kNone: launch<PROTO, fz::kNone>(B, threads, stream, inst_ids, faulty, crash_round, rounds, decision, p); return true;
    case fz::kCrash: launch<PROTO, fz::kCrash>(B, threads, stream, inst_ids, faulty, crash_round, rounds, decision, p); return true;
    case fz::kByzantine: launch<PROTO, fz::kByzantine>(B, threads, stream, inst_ids, faulty, crash_round, rounds, decision, p); return true;
    case fz::kAdaptive: launch<PROTO, fz::kAdaptive>(B, threads, stream, inst_ids, faulty, crash_round, rounds, decision, p); return true;
    case fz::kAdaptiveMin: launch<PROTO, fz::kAdaptiveMin>(B, threads, stream, inst_ids, faulty, crash_round, rounds, decision, p); return true;
    default: return false;
  }
}

}  // namespace

// Launch one chunk of B instances on `stream`. Pointers are device pointers:
// inst_ids (B,) int32; faulty (B, n) uint8 (null under adversary none);
// crash_round (B, n) int32 (read only under crash); rounds (B,) int32,
// decision (B,) uint8. protocol: 0 benor, 1 bracha; adversary: 0 none,
// 1 crash, 2 byzantine, 3 adaptive, 4 adaptive_min. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int brc_fused_round_launch(const int32_t* inst_ids, const uint8_t* faulty,
                                      const int32_t* crash_round, int32_t* rounds,
                                      uint8_t* decision, int B, int n, int f,
                                      int round_cap, int init_code, int coin_code,
                                      int protocol, int adversary, uint32_t k0,
                                      uint32_t k1, void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || n > 1024) return (int)cudaErrorInvalidValue;
  if (adversary != fz::kNone && faulty == nullptr) return (int)cudaErrorInvalidValue;
  if (adversary == fz::kCrash && crash_round == nullptr) return (int)cudaErrorInvalidValue;
  const brc::Params p{k0, k1, n, f, round_cap, init_code, coin_code};
  const int threads = (n + 31) / 32 * 32;
  const cudaStream_t s = (cudaStream_t)stream;
  bool ok;
  if (protocol == fz::kBracha)
    ok = launch_adversary<fz::kBracha>(adversary, B, threads, s, inst_ids, faulty,
                                       crash_round, rounds, decision, p);
  else if (protocol == fz::kBenOr)
    ok = launch_adversary<fz::kBenOr>(adversary, B, threads, s, inst_ids, faulty,
                                      crash_round, rounds, decision, p);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
