// Per-replica arithmetic of the fused round kernel (fused_round.cu).
//
// Everything a thread computes between two block reductions lives here, in
// functions that compile for the device (nvcc) and for the host (g++), so the
// CPU tests can build this header behind fused_round_host.cpp and check it
// bit for bit against the port's plain torch functions and the reference.
// The PRF is in prf.cuh.
//
// All arithmetic is uint32 with wraparound, as the spec (spec/PROTOCOL.md §2,
// §4b-v2, §4c, §5, §6, §9, §10) defines it. Every function that draws takes
// the packing law as its template argument PACK (prf.cuh), 1 by default: the
// kernel of fused_round.cu runs v1 only, the wide kernel
// (fused_round_wide.cuh) v1, v2 and v3.
#pragma once

#include <stdint.h>

#include "prf.cuh"

namespace brc {

// Protocol, adversary and fault-schedule codes of the kernel's
// instantiations (ops/fused_round.py: _PROTOCOL_CODES, _ADVERSARY_CODES,
// _FAULT_CODES). kNone is also "no fault schedule".
namespace fused {
constexpr int kBenOr = 0;
constexpr int kBracha = 1;
constexpr int kNone = 0;
constexpr int kCrash = 1;
constexpr int kByzantine = 2;
constexpr int kAdaptive = 3;
constexpr int kAdaptiveMin = 4;
constexpr int kRecover = 1;
constexpr int kPartition = 2;
constexpr int kOmission = 3;
}  // namespace fused

// The resident state word (prf.FUSED_STATE_BITS): est bits 0-1, decided
// bit 2, decided_val bits 3-4, phase bits 8-31.
BRC_HD uint32_t word_est(uint32_t w) { return w & 3u; }
BRC_HD uint32_t word_decided(uint32_t w) { return (w >> 2) & 1u; }
BRC_HD uint32_t word_decided_val(uint32_t w) { return (w >> 3) & 3u; }
BRC_HD uint32_t word_phase(uint32_t w) { return w >> 8; }
// The word with only those fields: the wide kernel keeps a step's honest
// value (bits 5-6) and committee membership (bit 7) in it between steps.
// The state_out plane holds these words.
constexpr uint32_t kStateWordMask = 0xFFFFFF1Fu;
BRC_HD uint32_t state_word(uint32_t w) { return w & kStateWordMask; }

BRC_HD int min3(int a, int b, int c) {
  const int ab = a < b ? a : b;
  return ab < c ? ab : c;
}

// One §4b-v2 segment for one receiver: d ~ HG(Lr, m, Dr) by the
// corner-minimal conditional-Bernoulli chain (ops/urn2.py::_chain). The
// chain runs this receiver's own K = min(m, Lr-m, Dr) draws; with K = 0 the
// segment's seed word is never used, so it is not drawn. The range
// reduction's shifts are prf.RED_SHIFTS of the law.
template <int PACK = 1>
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
    constexpr int kPre = PACK == 1 ? 10 : 12, kPost = PACK == 1 ? 22 : 20;
    uint32_t s = prf<PACK>(k0, k1, inst, rnd, t, recv, seg, kUrn2);
    for (int j = 0; j < K; ++j) {
      s = s * kLcgA + kLcgC;
      const uint32_t u = s ^ (s >> 16);
      const uint32_t q = ((u >> kPre) * (uint32_t)(Lr - j)) >> kPost;
      a += (q < P - a) ? 1u : 0u;
    }
  }
  return is_comp ? Dr - (int)a : (int)a;
}

// A receiver's urn of one broadcast step: the live class totals M0..M2 over
// all senders (of the receiver's class) less its own live message, their
// sum L, and the D = max(L - k, 0) messages it drops for its quota k
// (n - f - 1 under the full-mesh laws, k_C under the committee family).
struct Urn {
  int m0, m1, m2, L, D;
};

// A receiver's urn with delivery quota k: the class totals less its own
// live message, and D = max(L - k, 0) drops.
BRC_HD Urn urn_quota(uint32_t own, bool own_live, int M0, int M1, int M2, int k) {
  Urn u;
  u.m0 = M0 - (own_live && own == 0u ? 1 : 0);
  u.m1 = M1 - (own_live && own == 1u ? 1 : 0);
  u.m2 = M2 - (own_live && own == 2u ? 1 : 0);
  u.L = u.m0 + u.m1 + u.m2;
  u.D = u.L - k > 0 ? u.L - k : 0;
  return u;
}

// The full-mesh urn: quota n - f - 1 (spec §4b).
BRC_HD Urn urn_of(uint32_t own, bool own_live, int M0, int M1, int M2, int n, int f) {
  return urn_quota(own, own_live, M0, M1, M2, n - f - 1);
}

// One receiver's delivered counts (c0, c1) of one broadcast step under
// §4b-v2 (ops/urn2.py::counts_fn, without strata); its own value is added
// back after the draw.
template <int PACK = 1>
BRC_HD void urn2_counts(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                        uint32_t t, uint32_t recv, uint32_t own, bool own_live,
                        int M0, int M1, int M2, int n, int f, int* c0, int* c1) {
  const Urn u = urn_of(own, own_live, M0, M1, M2, n, f);
  const int m0 = u.m0, m1 = u.m1, L = u.L, D = u.D;
  const int d0 = urn2_chain<PACK>(k0, k1, inst, rnd, t, recv, 2u, m0, L, D);
  const int d1 = urn2_chain<PACK>(k0, k1, inst, rnd, t, recv, 3u, m1, L - m0, D - d0);
  *c0 = m0 - d0 + (own == 0u ? 1 : 0);
  *c1 = m1 - d1 + (own == 1u ? 1 : 0);
}

// The same under the adaptive family's two strata (ops/urn2.py::counts_fn
// with strata). The biased stratum holds ⊥ and the value other than the
// receiver's preferred value `pref`; it absorbs Db = min(D, Lb) of the
// drops over segments 0 and 1 (values 0, then 1; the preferred value's
// segment is empty and draws nothing), the rest of the urn the other D - Db
// over segments 2 and 3.
template <int PACK = 1>
BRC_HD void urn2_counts_strata(uint32_t k0, uint32_t k1, uint32_t inst,
                               uint32_t rnd, uint32_t t, uint32_t recv,
                               uint32_t own, bool own_live, int M0, int M1,
                               int M2, int n, int f, uint32_t pref, int* c0,
                               int* c1) {
  const Urn u = urn_of(own, own_live, M0, M1, M2, n, f);
  const int m0 = u.m0, m1 = u.m1, m2 = u.m2, L = u.L, D = u.D;
  const int mb0 = pref != 0u ? m0 : 0;
  const int mb1 = pref != 1u ? m1 : 0;
  const int Lb = mb0 + mb1 + m2;
  const int Db = D < Lb ? D : Lb;
  const int db0 = urn2_chain<PACK>(k0, k1, inst, rnd, t, recv, 0u, mb0, Lb, Db);
  const int db1 = urn2_chain<PACK>(k0, k1, inst, rnd, t, recv, 1u, mb1, Lb - mb0, Db - db0);
  const int mu0 = m0 - mb0, Lu = L - Lb, Du = D - Db;
  const int du0 = urn2_chain<PACK>(k0, k1, inst, rnd, t, recv, 2u, mu0, Lu, Du);
  const int du1 = urn2_chain<PACK>(k0, k1, inst, rnd, t, recv, 3u, m1 - mb1, Lu - mu0,
                                   Du - du0);
  *c0 = m0 - db0 - du0 + (own == 0u ? 1 : 0);
  *c1 = m1 - db1 - du1 + (own == 1u ? 1 : 0);
}

// One §4c segment (ops/urn3.py::_cheap): the rounded hypergeometric mean
// Dr·m/Lr plus popcount(nibble seg of u) - 2, clamped to the support
// [max(Dr - (Lr - m), 0), min(m, Dr)]. All operands are non-negative and
// Dr <= Lr; with Dr = 0 the result is 0 whatever u is.
BRC_HD int cheap(uint32_t u, uint32_t seg, int m, int Lr, int Dr) {
  const uint32_t nib = (u >> (8u * seg)) & 0xFu;
  const int pop = (int)((nib & 1u) + ((nib >> 1) & 1u) + ((nib >> 2) & 1u) + ((nib >> 3) & 1u));
  const int den = Lr > 1 ? Lr : 1;
  const int base = (2 * Dr * m + den) / (2 * den);
  const int lo = Dr - (Lr - m) > 0 ? Dr - (Lr - m) : 0;
  const int hi = m < Dr ? m : Dr;
  const int d = base + pop - 2 > lo ? base + pop - 2 : lo;
  return d < hi ? d : hi;
}

// The drops (d0, d1) of values 0 and 1 from a receiver's urn (m0, m1, m2,
// L, D) by the cheap law on the word u (ops/urn3.py::cheap_split): without
// strata nibbles 2 and 3 split D; with them (STRATA, the adaptive family,
// preferred value `pref`) the biased stratum absorbs min(D, Lb) over
// nibbles 0 and 1 and the rest of the urn the remainder over 2 and 3.
template <bool STRATA>
BRC_HD void cheap_split(uint32_t u, int m0, int m1, int m2, int L, int D, uint32_t pref,
                        int* d0, int* d1) {
  if constexpr (STRATA) {
    const int mb0 = pref != 0u ? m0 : 0;
    const int mb1 = pref != 1u ? m1 : 0;
    const int Lb = mb0 + mb1 + m2;
    const int Db = D < Lb ? D : Lb;
    const int db0 = cheap(u, 0u, mb0, Lb, Db);
    const int db1 = cheap(u, 1u, mb1, Lb - mb0, Db - db0);
    const int mu0 = m0 - mb0, Lu = L - Lb, Du = D - Db;
    const int du0 = cheap(u, 2u, mu0, Lu, Du);
    const int du1 = cheap(u, 3u, m1 - mb1, Lu - mu0, Du - du0);
    *d0 = db0 + du0;
    *d1 = db1 + du1;
  } else {
    *d0 = cheap(u, 2u, m0, L, D);
    *d1 = cheap(u, 3u, m1, L - m0, D - *d0);
  }
}

// One receiver's counts (c0, c1) under §4c (ops/urn3.py::counts_fn): the
// quota n - f - 1, one URN3 word, drawn only when something is dropped; its
// own value added back.
template <int PACK, bool STRATA>
BRC_HD void urn3_counts(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                        uint32_t t, uint32_t recv, uint32_t own, bool own_live,
                        int M0, int M1, int M2, int n, int f, uint32_t pref,
                        int* c0, int* c1) {
  const Urn u = urn_of(own, own_live, M0, M1, M2, n, f);
  int d0 = 0, d1 = 0;
  if (u.D > 0)
    cheap_split<STRATA>(prf<PACK>(k0, k1, inst, rnd, t, recv, 0u, kUrn3), u.m0, u.m1,
                        u.m2, u.L, u.D, pref, &d0, &d1);
  *c0 = u.m0 - d0 + (own == 0u ? 1 : 0);
  *c1 = u.m1 - d1 + (own == 1u ? 1 : 0);
}

// One receiver's counts (c0, c1) under the committee law, spec §10.2
// (ops/committee.py::counts_fn): the totals range over live committee
// senders; the quota is k_C; the drop word is COMMITTEE send=1, drawn only
// when something is dropped; the own message is delivered only to a member.
template <int PACK, bool STRATA>
BRC_HD void committee_counts(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                             uint32_t t, uint32_t recv, uint32_t own, bool own_live,
                             bool member, int M0, int M1, int M2, int kq, uint32_t pref,
                             int* c0, int* c1) {
  const Urn u = urn_quota(own, own_live, M0, M1, M2, kq);
  int d0 = 0, d1 = 0;
  if (u.D > 0)
    cheap_split<STRATA>(prf<PACK>(k0, k1, inst, rnd, t, recv, 1u, kCommittee), u.m0, u.m1,
                        u.m2, u.L, u.D, pref, &d0, &d1);
  *c0 = u.m0 - d0 + (member && own == 0u ? 1 : 0);
  *c1 = u.m1 - d1 + (member && own == 1u ? 1 : 0);
}

// Committee membership of replica v at step t (spec §10.1,
// ops/committee.py::membership_plane): its COMMITTEE send=0 word mod n < C.
template <int PACK>
BRC_HD bool committee_member(uint32_t k0, uint32_t k1, uint32_t inst, uint32_t rnd,
                             uint32_t t, uint32_t v, int n, int csize) {
  return prf<PACK>(k0, k1, inst, rnd, t, v, 0u, kCommittee) % (uint32_t)n < (uint32_t)csize;
}

// What the kernel needs to know about the config. nq and fq are the (n, f)
// the protocol thresholds are evaluated over: (C, f_C) under the committee
// family (spec §10.3), else (n, f). kq is the committee's delivery quota
// k_C = C - f_C - 1 and csize its size C (spec §10.1), read by the committee
// law only.
struct Params {
  uint32_t k0, k1;
  int n, f, round_cap;
  int init_code;  // 0 random, 1 all0, 2 all1, 3 split (spec §3.1)
  int coin_code;  // 0 local, 1 shared (spec §5.3)
  int nq, fq, kq, csize;
};

// Initial estimate of replica v (models/state.py::init_est).
template <int PACK = 1>
BRC_HD uint32_t init_est(const Params& p, uint32_t inst, uint32_t v) {
  switch (p.init_code) {
    case 1: return 0u;
    case 2: return 1u;
    case 3: return v & 1u;
    default: return prf<PACK>(p.k0, p.k1, inst, 0u, 0u, v, 0u, kInitEst) & 1u;
  }
}

// The coin of replica v in round rnd (models/coins.py).
template <int PACK = 1>
BRC_HD uint32_t coin_bit(const Params& p, uint32_t inst, uint32_t rnd, uint32_t v) {
  if (p.coin_code == 1)
    return prf<PACK>(p.k0, p.k1, inst, rnd, kCoinStep, 0u, 0u, kSharedCoin) & 1u;
  return prf<PACK>(p.k0, p.k1, inst, rnd, kCoinStep, v, 0u, kLocalCoin) & 1u;
}

// The round's end of an undecided replica: adopt w, else take the coin;
// decide on w; phase counts undecided rounds.
BRC_HD uint32_t next_word(uint32_t word, bool adopt, bool decide_now, uint32_t w,
                          uint32_t coin) {
  const uint32_t est = adopt ? w : coin;
  const uint32_t dval = decide_now ? w : 0u;
  return est | ((decide_now ? 1u : 0u) << 2) | (dval << 3) |
         ((word_phase(word) + 1u) << 8);
}

// What replica v knows of one broadcast step: its own message as its
// receiver class sees it (the value and whether it is live) and the live
// class totals of its class over all senders. `pref` is its preferred value
// under the adaptive family (its strata), else unused. Under a §9 partition
// U0..U2 are the totals over the senders of its own side, which its urn
// ranges over; the §5.1b validation keeps reading M0..M2.
struct Sent {
  uint32_t own;
  bool live;
  int M0, M1, M2;
  uint32_t pref;
  int U0, U1, U2;
};

// What the §9 fault schedule does to replica v in one round: `silent`, its
// messages are suppressed (recover, omission); `side1`, it is on the
// isolated side of a partition whose epoch holds this round.
struct Fault {
  bool silent;
  bool side1;
};

// recover (spec §9): a fault-prone replica is silent in its outage window
// [down_at, up_at) (models/faults.py::round_masks).
BRC_HD bool recover_silent(bool fprone, int down_at, int up_at, int rnd) {
  return fprone && down_at <= rnd && rnd < up_at;
}

// omission: the per-(instance, round) burst gate, prf(send 1) & 3 == 0, one
// word per instance and round (models/faults.py::omission_gate).
template <int PACK = 1>
BRC_HD bool omission_burst(const Params& p, uint32_t inst, uint32_t rnd) {
  return (prf<PACK>(p.k0, p.k1, inst, rnd, 0u, 0u, 1u, kFaultOmit) & 3u) == 0u;
}

// omission: in a burst round a fault-prone replica is silent by its own bit,
// prf(recv v) & 1; the word is drawn only then (models/faults.py::omission_bits).
template <int PACK = 1>
BRC_HD bool omission_silent(const Params& p, uint32_t inst, uint32_t rnd, uint32_t v,
                            bool fprone, bool burst) {
  return fprone && burst && (prf<PACK>(p.k0, p.k1, inst, rnd, 0u, v, 0u, kFaultOmit) & 1u);
}

// partition: the instance's epoch [part_start, part_heal) holds round rnd.
BRC_HD bool partition_cut(int part_start, int part_heal, int rnd) {
  return part_start <= rnd && rnd < part_heal;
}

// The totals of a receiver's own side, from the global totals M0..M2 and the
// side-1 totals S0..S2: a side-1 receiver hears side 1, the others the rest
// (ops/urn.py::lane_setup with fside).
BRC_HD void own_side_totals(Sent& s, bool side1, int S0, int S1, int S2) {
  s.U0 = side1 ? S0 : s.M0 - S0;
  s.U1 = side1 ? S1 : s.M1 - S1;
  s.U2 = side1 ? S2 : s.M2 - S2;
}

// What a sender puts on the wire under a per-sender adversary (spec §3.3,
// §6.3; models/adversaries.py::inject): a faulty sender under crash is
// silent from its crash round on; a faulty sender under Bracha's Byzantine
// pairing draws one word b = prf_sender(tag 0) & 3 and is silent (b = 0),
// sends 0 (b = 1), 1 (b = 2) or its honest value (b = 3). Everyone else sends
// the honest value.
template <int PROTO, int ADV, int PACK = 1>
BRC_HD Sent inject(const Params& p, uint32_t inst, uint32_t rnd, uint32_t t,
                   uint32_t v, uint32_t honest, bool faulty, int crash_round) {
  Sent s{honest, true, 0, 0, 0, 0u};
  if constexpr (ADV == fused::kCrash) {
    s.live = !(faulty && (int)rnd >= crash_round);
  } else if constexpr (ADV == fused::kByzantine && PROTO == fused::kBracha) {
    if (faulty) {
      const uint32_t b = prf_sender<PACK>(p.k0, p.k1, inst, rnd, t, 0u, v, kByzValue) & 3u;
      s.live = b != 0u;
      s.own = b == 1u ? 0u : (b == 2u ? 1u : honest);
    }
  }
  return s;
}

// The value a faulty sender shows receiver class h under Ben-Or's Byzantine
// pairing (ops/urn.py::byz_class_values): prf_sender(tag h) % 3, where 2 is
// ⊥, a live message that is not counted.
template <int PACK = 1>
BRC_HD uint32_t two_faced_value(const Params& p, uint32_t inst, uint32_t rnd,
                                uint32_t t, uint32_t v, uint32_t h) {
  return prf_sender<PACK>(p.k0, p.k1, inst, rnd, t, h, v, kByzValue) % 3u;
}

// The minority of the honest non-faulty votes h0 (of 0) and h1 (of 1),
// ties to 1 (models/adversaries.py::observed_minority).
BRC_HD uint32_t minority(int h0, int h1) { return h1 <= h0 ? 1u : 0u; }

// A step under the adaptive family (spec §6.4, §6.4b): faulty senders push
// the minority `mn` of the honest non-faulty votes, so the wire totals come
// from the honest counts h0..h2 over the non-faulty senders and the F
// faulty ones. Nobody is silent; validation is a function of the value, so
// a value's class is valid whole or not at all (valid0..valid2). The
// receiver's preferred value is its lane's class under adaptive and the
// minority under adaptive_min.
template <int ADV>
BRC_HD Sent adaptive_sent(uint32_t v, int n, uint32_t honest, bool faulty, int F,
                          int h0, int h1, int h2, bool valid0, bool valid1,
                          bool valid2) {
  const uint32_t mn = minority(h0, h1);
  Sent s;
  s.own = faulty ? mn : honest;
  s.live = s.own == 0u ? valid0 : (s.own == 1u ? valid1 : valid2);
  s.M0 = valid0 ? h0 + (mn == 0u ? F : 0) : 0;
  s.M1 = valid1 ? h1 + (mn == 1u ? F : 0) : 0;
  s.M2 = valid2 ? h2 : 0;
  if constexpr (ADV == fused::kAdaptive)
    s.pref = v >= (uint32_t)(n + 1) / 2 ? 1u : 0u;
  else
    s.pref = mn;
  return s;
}

// The wire message of sender v under the adaptive family with a §9 fault
// schedule, from the honest non-faulty votes h0 (of 0) and h1 (of 1): a
// faulty sender pushes their minority, the others send the honest value;
// live until the caller applies the silences. `pref` as in adaptive_sent.
template <int ADV>
BRC_HD Sent adaptive_wire(uint32_t v, int n, uint32_t honest, bool faulty, int h0,
                          int h1) {
  const uint32_t mn = minority(h0, h1);
  Sent s{faulty ? mn : honest, true, 0, 0, 0, 0u, 0, 0, 0};
  if constexpr (ADV == fused::kAdaptive)
    s.pref = v >= (uint32_t)(n + 1) / 2 ? 1u : 0u;
  else
    s.pref = mn;
  return s;
}

// One receiver's delivered counts (c0, c1) of a step it was sent; under a
// partition its urn ranges over its own side's totals.
template <int ADV, int FAULT = fused::kNone>
BRC_HD void deliver(const Params& p, uint32_t inst, uint32_t rnd, uint32_t t,
                    uint32_t v, const Sent& s, int* c0, int* c1) {
  constexpr bool kCut = FAULT == fused::kPartition;
  const int M0 = kCut ? s.U0 : s.M0, M1 = kCut ? s.U1 : s.M1, M2 = kCut ? s.U2 : s.M2;
  if constexpr (ADV == fused::kAdaptive || ADV == fused::kAdaptiveMin)
    urn2_counts_strata(p.k0, p.k1, inst, rnd, t, v, s.own, s.live, M0, M1, M2, p.n,
                       p.f, s.pref, c0, c1);
  else
    urn2_counts(p.k0, p.k1, inst, rnd, t, v, s.own, s.live, M0, M1, M2, p.n, p.f,
                c0, c1);
}

// Bracha (§5.2). Step 0: the majority of what was delivered, ties to 1.
BRC_HD uint32_t bracha_vote0(int c0, int c1) { return c1 >= c0 ? 1u : 0u; }

// Step-1 validity of value x (§5.1b), from the step-0 live counts.
BRC_HD bool step1_valid(const Params& p, uint32_t x, int g00, int g01) {
  const int q = p.n - p.f;
  return x == 1u ? g01 >= (q + 1) / 2 : g00 >= q / 2 + 1;
}

// Step 1: a decide-proposal needs an absolute > n/2 quorum.
BRC_HD uint32_t bracha_vote1(const Params& p, int c0, int c1) {
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

// Step 2 and the round's end of an undecided replica, from its step-2
// counts (⊥ is not counted): adopt at f+1, decide at 2f+1, else the coin.
template <int PACK = 1>
BRC_HD uint32_t bracha_update(const Params& p, uint32_t inst, uint32_t rnd,
                              uint32_t v, uint32_t word, int c0, int c1) {
  const uint32_t w = c1 >= c0 ? 1u : 0u;
  const int c = w ? c1 : c0;
  return next_word(word, c >= p.f + 1, c >= 2 * p.f + 1, w, coin_bit<PACK>(p, inst, rnd, v));
}

// Ben-Or (§5.1). Report: the value delivered by more than half of n (of
// n + f under a lying adversary, Protocol B), else ⊥.
BRC_HD uint32_t benor_report(const Params& p, bool lying, int r0, int r1) {
  const int rhs = lying ? p.n + p.f : p.n;
  return 2 * r1 > rhs ? 1u : (2 * r0 > rhs ? 0u : 2u);
}

// Propose and the round's end of an undecided replica, from its step-1
// counts (⊥ is not counted): w = p1 >= p0; adopt w at 1 delivered vote (f+1
// under Protocol B), decide at f+1 (2c > n+f), else take the coin.
template <int PACK = 1>
BRC_HD uint32_t benor_update(const Params& p, bool lying, uint32_t inst,
                             uint32_t rnd, uint32_t v, uint32_t word, int p0, int p1) {
  const uint32_t w = p1 >= p0 ? 1u : 0u;
  const int c = w ? p1 : p0;
  const bool adopt = c >= (lying ? p.f + 1 : 1);
  const bool decide_now = lying ? 2 * c > p.n + p.f : c >= p.f + 1;
  return next_word(word, adopt, decide_now, w, coin_bit<PACK>(p, inst, rnd, v));
}

}  // namespace brc
