// Per-thread arithmetic of the keys step kernel (keys_step.cu).
//
// What a lane computes between two warp reductions lives here, in functions
// that compile for the device (nvcc) and for the host (g++), so the CPU tests
// can build this header behind keys_step_host.cpp and check it bit for bit
// against the port's plain torch version (ops/masks.py + ops/tally.py) and
// the reference. Packing law v1 only (n <= 1024).
#pragma once

#include <stdint.h>

#include "prf.cuh"

namespace brc {

// The spec §4 combined key under law v1: silent(1) | bias(1) | prf(20) |
// sender(10) (prf.KEY_LOW_BITS[1] = 10). Selection searches the top field,
// key >> kKeyLow, and breaks ties in sender order.
constexpr int kKeyLow = 10;
constexpr int kKeyPrf = 30 - kKeyLow;
constexpr int kTopBits = 32 - kKeyLow;
constexpr uint32_t kPadKey = 0xFFFFFFFFu;

// Adversary codes of the per-step kernels.
constexpr int kAdvNone = 0;
constexpr int kAdvAdaptive = 1;
constexpr int kAdvAdaptiveMin = 2;

struct StepParams {
  uint32_t k0, k1;
  int n, f;
  uint32_t rnd, step;
  int adversary;  // kAdvNone, kAdvAdaptive or kAdvAdaptiveMin
};

// The §6.4 observation: the minority among the honest non-⊥ votes, ties to 1.
BRC_HD uint32_t minority_of(int h0, int h1) { return h1 <= h0 ? 1u : 0u; }

// Scheduling bias of a sender's wire value at receiver recv: §6.4 (adaptive,
// receiver v prefers 1 iff v >= (n+1)/2) or §6.4b (adaptive_min, the minority
// first). Bias 1 sorts after every bias-0 key.
BRC_HD uint32_t bias_bit(const StepParams& p, uint32_t value, uint32_t recv,
                         uint32_t minority) {
  if (p.adversary == kAdvNone) return 0u;
  const uint32_t pref = p.adversary == kAdvAdaptive
                            ? (recv >= (uint32_t)(p.n + 1) / 2 ? 1u : 0u)
                            : minority;
  return (value == 2u || value != pref) ? 1u : 0u;
}

// The combined key of (recv, send) (ops/masks.py::combined_keys): the own
// message's key is recv, a padded sender's the largest word.
BRC_HD uint32_t combined_key(const StepParams& p, uint32_t inst, uint32_t recv,
                             uint32_t send, uint32_t value, bool silent,
                             uint32_t minority) {
  if (send >= (uint32_t)p.n) return kPadKey;
  if (send == recv) return recv;
  const uint32_t sched = prf_u32(p.k0, p.k1, inst, p.rnd, p.step, recv, send, kSched);
  return (silent ? 1u << 31 : 0u) | (bias_bit(p, value, recv, minority) << 30) |
         ((sched >> (32 - kKeyPrf)) << kKeyLow) | send;
}

// The MSB-first search for T, the k-th smallest top field of a row: at bit b
// the candidate sets every lower bit, and cnt counts the tops <= candidate.
BRC_HD uint32_t search_cand(uint32_t T, int b) { return T | ((1u << b) - 1u); }
BRC_HD uint32_t search_step(uint32_t T, int b, int cnt, int k) {
  return cnt >= k ? T : T | (1u << b);
}

// Membership in the k smallest keys: every top below T, and the first
// k - below of the tops equal to T in sender order (tie_rank counts the ties
// of lower senders).
BRC_HD bool selected(uint32_t top, uint32_t T, int tie_rank, int k, int below) {
  return top < T || (top == T && tie_rank < k - below);
}

// Delivered: the own message always; another only if selected and live.
BRC_HD bool delivered(bool own, bool silent, bool sel) {
  return own || (sel && !silent);
}

}  // namespace brc
