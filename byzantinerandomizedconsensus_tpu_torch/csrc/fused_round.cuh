// Per-replica arithmetic of the fused round kernel (fused_round.cu).
//
// Everything a thread computes between two block reductions lives here, in
// functions that compile for the device (nvcc) and for the host (g++), so the
// CPU tests can build this header behind fused_round_host.cpp and check it
// bit for bit against the port's plain torch functions and the reference.
// The PRF is in prf.cuh.
//
// All arithmetic is uint32 with wraparound, as the spec (spec/PROTOCOL.md §2,
// §4b-v2, §5.2) defines it. Only packing law v1 (n <= 1024) is implemented.
#pragma once

#include <stdint.h>

#include "prf.cuh"

namespace brc {

// The resident state word (prf.FUSED_STATE_BITS): est bits 0-1, decided
// bit 2, decided_val bits 3-4, phase bits 8-31.
BRC_HD uint32_t word_est(uint32_t w) { return w & 3u; }
BRC_HD uint32_t word_decided(uint32_t w) { return (w >> 2) & 1u; }
BRC_HD uint32_t word_decided_val(uint32_t w) { return (w >> 3) & 3u; }
BRC_HD uint32_t word_phase(uint32_t w) { return w >> 8; }

BRC_HD int min3(int a, int b, int c) {
  const int ab = a < b ? a : b;
  return ab < c ? ab : c;
}

// One §4b-v2 segment for one receiver: d ~ HG(Lr, m, Dr) by the
// corner-minimal conditional-Bernoulli chain (ops/urn2.py::_chain). The
// chain runs this receiver's own K = min(m, Lr-m, Dr) draws; with K = 0 the
// segment's seed word is never used, so it is not drawn.
BRC_HD int urn2_chain(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                      uint32_t t, uint32_t recv, uint32_t seg, int m, int Lr,
                      int Dr) {
  const int comp = Lr - m;
  const bool is_item = (m <= comp) && (m <= Dr);
  const bool is_draw = !is_item && (Dr <= comp);
  const bool is_comp = !is_item && !is_draw;
  const int K = min3(m, comp, Dr);
  const uint32_t P = is_draw ? (uint32_t)m : (uint32_t)Dr;
  uint32_t a = 0;
  if (K > 0) {
    uint32_t s = prf_u32(k0, k1, inst, rnd, t, recv, seg, kUrn2);
    for (int j = 0; j < K; ++j) {
      s = s * kLcgA + kLcgC;
      const uint32_t u = s ^ (s >> 16);
      const uint32_t q = ((u >> 10) * (uint32_t)(Lr - j)) >> 22;
      a += (q < P - a) ? 1u : 0u;
    }
  }
  return is_comp ? Dr - (int)a : (int)a;
}

// One receiver's delivered counts (c0, c1) of one broadcast step under
// §4b-v2 (ops/urn2.py::counts_fn, non-adaptive). M0..M2 are the live class
// totals over all senders; the receiver's own live message is taken out of
// its urn and its own value added back after the draw.
BRC_HD void urn2_counts(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                        uint32_t t, uint32_t recv, uint32_t own, bool own_live,
                        int M0, int M1, int M2, int n, int f, int* c0, int* c1) {
  const int m0 = M0 - (own_live && own == 0u ? 1 : 0);
  const int m1 = M1 - (own_live && own == 1u ? 1 : 0);
  const int m2 = M2 - (own_live && own == 2u ? 1 : 0);
  const int L = m0 + m1 + m2;
  const int D = L - (n - f - 1) > 0 ? L - (n - f - 1) : 0;
  const int d0 = urn2_chain(k0, k1, inst, rnd, t, recv, 2u, m0, L, D);
  const int d1 = urn2_chain(k0, k1, inst, rnd, t, recv, 3u, m1, L - m0, D - d0);
  *c0 = m0 - d0 + (own == 0u ? 1 : 0);
  *c1 = m1 - d1 + (own == 1u ? 1 : 0);
}

// What the kernel needs to know about the config.
struct Params {
  uint32_t k0, k1;
  int n, f, round_cap;
  int init_code;  // 0 random, 1 all0, 2 all1, 3 split (spec §3.1)
  int coin_code;  // 0 local, 1 shared (spec §5.3)
};

// Initial estimate of replica v (models/state.py::init_est).
BRC_HD uint32_t init_est(const Params& p, uint32_t inst, uint32_t v) {
  switch (p.init_code) {
    case 1: return 0u;
    case 2: return 1u;
    case 3: return v & 1u;
    default: return prf_u32(p.k0, p.k1, inst, 0u, 0u, v, 0u, kInitEst) & 1u;
  }
}

// Step 0 (Bracha §5.2): broadcast est, take the majority of what was
// delivered, ties to 1. g00/g01 count est == 0/1 over all replicas.
BRC_HD uint32_t step0_vote(const Params& p, uint32_t inst, uint32_t rnd,
                           uint32_t v, uint32_t est, int g00, int g01) {
  int c0, c1;
  urn2_counts(p.k0, p.k1, inst, rnd, 0u, v, est, true, g00, g01, 0, p.n, p.f,
              &c0, &c1);
  return c1 >= c0 ? 1u : 0u;
}

// Step-1 validity of value x (§5.1b), from the step-0 global counts.
BRC_HD bool step1_valid(const Params& p, uint32_t x, int g00, int g01) {
  const int q = p.n - p.f;
  return x == 1u ? g01 >= (q + 1) / 2 : g00 >= q / 2 + 1;
}

// Step 1: broadcast x; a decide-proposal needs an absolute > n/2 quorum.
// g10/g11 count the valid step-1 messages of value 0/1.
BRC_HD uint32_t step1_vote(const Params& p, uint32_t inst, uint32_t rnd,
                           uint32_t v, uint32_t x, bool live, int g10, int g11) {
  int c0, c1;
  urn2_counts(p.k0, p.k1, inst, rnd, 1u, v, x, live, g10, g11, 0, p.n, p.f,
              &c0, &c1);
  return 2 * c1 > p.n ? 1u : (2 * c0 > p.n ? 0u : 2u);
}

// Step-2 validity of value z (§5.1b), from the valid step-1 counts.
BRC_HD bool step2_valid(const Params& p, uint32_t z, int g10, int g11) {
  const int q = p.n - p.f, half = p.n / 2;
  if (z == 1u) return g11 >= half + 1;
  if (z == 0u) return g10 >= half + 1;
  // z = bot: some q-subset of the valid step-1 messages has no > n/2 majority.
  int lo = q - g10 > 0 ? q - g10 : 0;
  lo = lo > q - half ? lo : q - half;
  int hi = g11 < q ? g11 : q;
  hi = hi < half ? hi : half;
  return lo <= hi;
}

// Step 2 and the round's end: broadcast z (bot is not counted), adopt at
// f+1, decide at 2f+1, else take the coin. M20..M22 count the valid step-2
// messages of value 0/1/2. Decided replicas keep their word (and skip the
// draw, whose counts only their own update reads); phase counts undecided
// rounds only.
BRC_HD uint32_t round_update(const Params& p, uint32_t inst, uint32_t rnd,
                             uint32_t v, uint32_t word, uint32_t z, bool live,
                             int M20, int M21, int M22) {
  if (word_decided(word)) return word;
  int c0, c1;
  urn2_counts(p.k0, p.k1, inst, rnd, 2u, v, z, live, M20, M21, M22, p.n, p.f,
              &c0, &c1);
  const uint32_t w = c1 >= c0 ? 1u : 0u;
  const int c = w ? c1 : c0;
  const bool decide_now = c >= 2 * p.f + 1;
  const bool adopt = c >= p.f + 1;
  uint32_t coin;
  if (p.coin_code == 1)
    coin = prf_u32(p.k0, p.k1, inst, rnd, kCoinStep, 0u, 0u, kSharedCoin) & 1u;
  else
    coin = prf_u32(p.k0, p.k1, inst, rnd, kCoinStep, v, 0u, kLocalCoin) & 1u;
  const uint32_t est = adopt ? w : coin;
  const uint32_t dval = decide_now ? w : 0u;
  return est | ((decide_now ? 1u : 0u) << 2) | (dval << 3) |
         ((word_phase(word) + 1u) << 8);
}

}  // namespace brc
