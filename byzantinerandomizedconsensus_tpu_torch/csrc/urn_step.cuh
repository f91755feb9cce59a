// Per-receiver arithmetic of the urn step kernel (urn_step.cu).
//
// Everything a thread computes after the block's class totals lives here, in
// functions that compile for the device (nvcc) and for the host (g++), so the
// CPU tests can build this header behind urn_step_host.cpp and check it bit
// for bit against the port's plain torch version (ops/urn.py) and the
// reference. Packing laws v1 (n <= 1024) and v2 (n <= 4096), by the
// template argument PACK (v1 by default). The fused round kernel's §4b law
// (fused_round_wide.cuh) calls urn_counts too, so both kernels make the
// draws of one implementation.
//
// The two-stratum law (adaptive, adaptive_min; ops/urn.py::counts_fn) is run
// in two phases. The biased stratum holds exactly two value classes, ⊥ and
// the value a other than the receiver's preference, and every draw while it
// is not empty removes one biased message: the urn size at draw j is
// B0 - j whatever the picks, and a pick is one compare against r_a. Once it
// is empty, the unbiased stratum holds the preferred class alone, so every
// remaining draw takes it and needs no random word.
#pragma once

#include <stdint.h>

#include "keys_step.cuh"
#include "prf.cuh"

namespace brc {

// A draw's index in an urn of R < 1024 messages under packing law v1 is
// d = (((s ^ s >> 16) >> 10) * R) >> 22 (ops/urn.py, RED_SHIFTS[1]). The
// product before the last shift is below 2^32, so the kernel keeps it
// (urn_scaled) and tests d < r as product < r << 22, carrying each tracked
// count r as r << 22. That is one full-rate IMAD per draw and no shift
// after it; the high multiply of the masked word, which gives d itself, was
// measured slower on an H100 (IMAD.HI; PERF.md). Under v2 (RED_SHIFTS[2] =
// (12, 20)) the same holds: ((s ^ s >> 16) >> 12) < 2^20 and R < 2^12, so
// the product stays below 2^32, scaled by 2^20.
template <int PACK>
constexpr int kUrnPreOf = PACK == 1 ? 10 : 12;
template <int PACK>
constexpr int kUrnShiftOf = PACK == 1 ? 22 : 20;
constexpr int kUrnShift = kUrnShiftOf<1>;
constexpr uint32_t kUrnOne = 1u << kUrnShift;

template <int PACK = 1>
BRC_HD uint32_t urn_scaled(uint32_t s, uint32_t R) {
  return ((s ^ (s >> 16)) >> kUrnPreOf<PACK>) * R;
}

// a - step when x < a, else a: one compare and one predicated subtract on
// the card, with no select between them.
BRC_HD uint32_t sub_if_below(uint32_t x, uint32_t a, uint32_t step) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .pred p;\n\tsetp.lt.u32 p, %1, %0;\n\t@p sub.u32 %0, %0, %2;\n\t}"
      : "+r"(a)
      : "r"(x), "r"(step));
  return a;
#else
  return x < a ? a - step : a;
#endif
}

// One receiver's delivered counts (c0, c1) of one step under §4b
// (ops/urn.py::counts_fn). M0..M2 are the live class totals over the
// senders of the receiver's urn (all of them, or those of its side inside a
// §9 partition epoch, in the fused kernel); the receiver's own live message
// leaves its urn, D = L - (n-f-1)
// of the L others are dropped, and its own value is added back. minority
// is adaptive_min's observation (unused otherwise). Returns the random
// draws made: D for one stratum, min(D, B0) for two; the reference's draws
// past D, which it masks, and the tail, which needs no random word, are not
// made. A receiver with D == 0 computes no PRF word.
template <int PACK = 1>
BRC_HD int urn_counts(const StepParams& p, uint32_t inst, uint32_t recv,
                      uint32_t own, bool own_live, int M0, int M1, int M2,
                      uint32_t minority, int* c0, int* c1) {
  constexpr int kShift = kUrnShiftOf<PACK>;
  constexpr uint32_t kOne = 1u << kShift;
  int r0 = M0 - (own_live && own == 0u ? 1 : 0);
  int r1 = M1 - (own_live && own == 1u ? 1 : 0);
  const int r2 = M2 - (own_live && own == 2u ? 1 : 0);
  const int L = r0 + r1 + r2;
  const int D = L - (p.n - p.f - 1) > 0 ? L - (p.n - p.f - 1) : 0;
  int draws = 0;
  if (D > 0) {
    uint32_t s = prf<PACK>(p.k0, p.k1, inst, p.rnd, p.step, recv, 0u, kUrn);
    if (p.adversary == kAdvNone) {
      // One stratum: the urn holds L - j messages at draw j. Track r0 and
      // r0 + r1, scaled; a pick of ⊥ changes neither.
      uint32_t a0 = (uint32_t)r0 << kShift;
      uint32_t a01 = (uint32_t)(r0 + r1) << kShift;
      const uint32_t Rend = (uint32_t)(L - D);
#pragma unroll 4
      for (uint32_t R = (uint32_t)L; R > Rend; --R) {
        s = s * kLcgA + kLcgC;
        const uint32_t x = urn_scaled<PACK>(s, R);
        a0 = sub_if_below(x, a0, kOne);
        a01 = sub_if_below(x, a01, kOne);
      }
      r0 = (int)(a0 >> kShift);
      r1 = (int)(a01 >> kShift) - r0;
      draws = D;
    } else {
      // Two strata: the biased phase over B0 = r_a + r2 messages, then the
      // tail from the preferred class. ⊥ loses the biased picks that are
      // not a; the outputs do not read it.
      const uint32_t pref = pref_of(p, recv, minority);
      const int B0 = (pref == 0u ? r1 : r0) + r2;
      const int n1 = D < B0 ? D : B0;
      uint32_t aa = (uint32_t)(pref == 0u ? r1 : r0) << kShift;
      const uint32_t Rend = (uint32_t)(B0 - n1);
#pragma unroll 4
      for (uint32_t R = (uint32_t)B0; R > Rend; --R) {
        s = s * kLcgA + kLcgC;
        aa = sub_if_below(urn_scaled<PACK>(s, R), aa, kOne);
      }
      const int ra = (int)(aa >> kShift);
      if (pref == 0u) {
        r0 -= D - n1;
        r1 = ra;
      } else {
        r1 -= D - n1;
        r0 = ra;
      }
      draws = n1;
    }
  }
  *c0 = r0 + (own == 0u ? 1 : 0);
  *c1 = r1 + (own == 1u ? 1 : 0);
  return draws;
}

}  // namespace brc
