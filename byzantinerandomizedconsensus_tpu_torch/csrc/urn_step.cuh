// Per-receiver arithmetic of the urn step kernel (urn_step.cu).
//
// Everything a thread computes after the block's class totals lives here, in
// functions that compile for the device (nvcc) and for the host (g++), so the
// CPU tests can build this header behind urn_step_host.cpp and check it bit
// for bit against the port's plain torch version (ops/urn.py) and the
// reference. Packing law v1 only (n <= 1024).
#pragma once

#include <stdint.h>

#include "keys_step.cuh"
#include "prf.cuh"

namespace brc {

// Stratum flags of the values 0, 1, 2 at receiver recv, as bits 0-2 (spec
// §4b; ops/urn.py::lane_setup). 0 means a single stratum. adaptive:
// biased(w) = (w == 2) | (w != pref(recv)); adaptive_min: (w == 2) |
// (w != minority).
BRC_HD uint32_t strata(const StepParams& p, uint32_t recv, uint32_t minority) {
  if (p.adversary == kAdvNone) return 0u;
  const uint32_t pref = p.adversary == kAdvAdaptive
                            ? (recv >= (uint32_t)(p.n + 1) / 2 ? 1u : 0u)
                            : minority;
  return (pref != 0u ? 1u : 0u) | (pref != 1u ? 2u : 0u) | 4u;
}

// One receiver's delivered counts (c0, c1) of one step under §4b
// (ops/urn.py::counts_fn). M0..M2 are the live class totals over all
// senders; the receiver's own live message leaves its urn, D = L - (n-f-1)
// of the L others are dropped one draw at a time, and its own value is added
// back. The reference masks the draws past D, which change nothing, so the
// loop stops at D.
BRC_HD void urn_counts(const StepParams& p, uint32_t inst, uint32_t recv,
                       uint32_t own, bool own_live, int M0, int M1, int M2,
                       uint32_t st, int* c0, int* c1) {
  int r0 = M0 - (own_live && own == 0u ? 1 : 0);
  int r1 = M1 - (own_live && own == 1u ? 1 : 0);
  int r2 = M2 - (own_live && own == 2u ? 1 : 0);
  const int L = r0 + r1 + r2;
  const int D = L - (p.n - p.f - 1) > 0 ? L - (p.n - p.f - 1) : 0;
  uint32_t s = prf_u32(p.k0, p.k1, inst, p.rnd, p.step, recv, 0u, kUrn);
  if (st == 0u) {
    // Single stratum: the urn holds L - j messages at draw j.
    for (int j = 0; j < D; ++j) {
      s = s * kLcgA + kLcgC;
      const uint32_t d = (((s ^ (s >> 16)) >> 10) * (uint32_t)(L - j)) >> 22;
      if (d < (uint32_t)r0) --r0;
      else if (d < (uint32_t)(r0 + r1)) --r1;
    }
  } else {
    const bool s0 = st & 1u, s1 = (st >> 1) & 1u, s2 = (st >> 2) & 1u;
    for (int j = 0; j < D; ++j) {
      s = s * kLcgA + kLcgC;
      const int b_rem = (s0 ? r0 : 0) + (s1 ? r1 : 0) + (s2 ? r2 : 0);
      const bool in_biased = b_rem > 0;
      const uint32_t R = (uint32_t)(in_biased ? b_rem : r0 + r1 + r2 - b_rem);
      const uint32_t d = (((s ^ (s >> 16)) >> 10) * R) >> 22;
      const uint32_t e0 = s0 == in_biased ? (uint32_t)r0 : 0u;
      const uint32_t e1 = s1 == in_biased ? (uint32_t)r1 : 0u;
      if (d < e0) --r0;
      else if (d < e0 + e1) --r1;
      else --r2;
    }
  }
  *c0 = r0 + (own == 0u ? 1 : 0);
  *c1 = r1 + (own == 1u ? 1 : 0);
}

}  // namespace brc
