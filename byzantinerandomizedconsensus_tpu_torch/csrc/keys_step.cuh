// Per-thread arithmetic of the keys step kernel (keys_step.cu).
//
// What a lane computes between two warp reductions lives here, in functions
// that compile for the device (nvcc) and for the host (g++), so the CPU tests
// can build this header behind keys_step_host.cpp and check it bit for bit
// against the port's plain torch version (ops/masks.py + ops/tally.py) and
// the reference. Packing laws v1 (n <= 1024) and v2 (n <= 4096): the
// functions that depend on the law take it as the template argument PACK,
// v1 by default.
//
// The selection works by key class. A key's top two bits are its class,
// silent << 1 | bias, so every key of a lower class sorts before every key of
// a higher one. The class of each sender is known without hashing; only the
// class in which the n - f threshold falls (the crossing class) needs its
// PRF bits, and inside it a histogram on the PRF's top bits finds the bin
// that holds the threshold, and an exact finish ranks that bin's few keys.
//
// Ben-Or's Byzantine pairing (spec §6.3) shows each receiver its own value of
// a faulty sender, one more PRF word per (receiver, faulty sender) pair
// (equivocation_value). It leaves the sender's class alone: the pairing has
// no bias, and its silences are the planes'. A table entry of a faulty
// sender carries the value code kEquivocates, which the class counts skip,
// and each row adds the values its own faulty senders show it.
#pragma once

#include <stdint.h>

#include "prf.cuh"

namespace brc {

// The spec §4 combined key: silent(1) | bias(1) | prf(20) | sender(10)
// under law v1 (prf.KEY_LOW_BITS[1] = 10), prf(18) | sender(12) under v2.
// Inside one class the order is that of the low 30 bits, prf << low |
// sender, so ties in the PRF go in sender order.
template <int PACK>
constexpr int kKeyLowOf = PACK == 1 ? 10 : 12;
constexpr int kKeyLow = kKeyLowOf<1>;
constexpr int kKeyPrf = 30 - kKeyLow;
constexpr uint32_t kPadKey = 0xFFFFFFFFu;

// Adversary codes of the per-step kernels (ops/_step.py::adversary_code).
// Crash and Bracha's Byzantine pairing act through the silent and values
// planes alone, so they run as kAdvNone; kAdvTwoFaced is Ben-Or's pairing,
// which the launch maps to its own instantiation.
constexpr int kAdvNone = 0;
constexpr int kAdvAdaptive = 1;
constexpr int kAdvAdaptiveMin = 2;
constexpr int kAdvTwoFaced = 3;

// The value code of a faulty sender's entry under Ben-Or's pairing.
constexpr uint32_t kEquivocates = 3u;

struct StepParams {
  uint32_t k0, k1;
  int n, f;
  uint32_t rnd, step;
  int adversary;  // kAdvNone, kAdvAdaptive or kAdvAdaptiveMin
};

// The §6.4 observation: the minority among the honest non-⊥ votes, ties to 1.
BRC_HD uint32_t minority_of(int h0, int h1) { return h1 <= h0 ? 1u : 0u; }

// The value the adversary lets through first at receiver recv: §6.4
// (adaptive, receiver v prefers 1 iff v >= (n+1)/2) or §6.4b (adaptive_min,
// the minority). Unused under kAdvNone.
BRC_HD uint32_t pref_of(const StepParams& p, uint32_t recv, uint32_t minority) {
  return p.adversary == kAdvAdaptive ? (recv >= (uint32_t)(p.n + 1) / 2 ? 1u : 0u)
                                     : minority;
}

// The class tables a CTA builds: one per preference under adaptive, one
// otherwise. Table t holds the classes under preference t (adaptive) or the
// minority (adaptive_min); under none every live sender is class 0.
BRC_HD int table_count(const StepParams& p) {
  return p.adversary == kAdvAdaptive ? 2 : 1;
}
BRC_HD int table_of(const StepParams& p, uint32_t recv) {
  return p.adversary == kAdvAdaptive ? (int)pref_of(p, recv, 0u) : 0;
}
BRC_HD uint32_t table_pref(const StepParams& p, int table, uint32_t minority) {
  return p.adversary == kAdvAdaptive ? (uint32_t)table : minority;
}

// Scheduling bias of a wire value under preference pref. Bias 1 sorts after
// every bias-0 key.
BRC_HD uint32_t bias_of(const StepParams& p, uint32_t value, uint32_t pref) {
  if (p.adversary == kAdvNone) return 0u;
  return (value == 2u || value != pref) ? 1u : 0u;
}

// A key's class, its top two bits: silent << 1 | bias. Classes 0 and 1 are
// live; 2 and 3 are silent and never delivered.
BRC_HD uint32_t key_class(const StepParams& p, uint32_t value, bool silent,
                          uint32_t pref) {
  return (silent ? 2u : 0u) | bias_of(p, value, pref);
}

// The combined key of (recv, send) (ops/masks.py::combined_keys): the own
// message's key is recv, a padded sender's the largest word.
template <int PACK = 1>
BRC_HD uint32_t combined_key(const StepParams& p, uint32_t inst, uint32_t recv,
                             uint32_t send, uint32_t value, bool silent,
                             uint32_t minority) {
  constexpr int kLow = kKeyLowOf<PACK>;
  if (send >= (uint32_t)p.n) return kPadKey;
  if (send == recv) return recv;
  const uint32_t sched = prf<PACK>(p.k0, p.k1, inst, p.rnd, p.step, recv, send, kSched);
  return (key_class(p, value, silent, pref_of(p, recv, minority)) << 30) |
         ((sched >> (32 - (30 - kLow))) << kLow) | send;
}

// The value faulty sender `send` shows receiver `recv` under Ben-Or's
// Byzantine pairing (models/adversaries.py::equivocation_values): one PRF
// word, % 3, where 2 is ⊥, a live message that is not counted.
template <int PACK = 1>
BRC_HD uint32_t equivocation_value(const StepParams& p, uint32_t inst, uint32_t recv,
                                   uint32_t send) {
  return prf<PACK>(p.k0, p.k1, inst, p.rnd, p.step, recv, send, kByzValue) % 3u;
}

// The live class counts of one table over every sender of an instance, own
// message included: members, and members of wire value 0 and of value 1.
struct ClassTable {
  int m[2], v0[2], v1[2];
};

BRC_HD void class_add(ClassTable& t, uint32_t cls, uint32_t value) {
  if (cls > 1u) return;
  t.m[cls] += 1;
  t.v0[cls] += value == 0u ? 1 : 0;
  t.v1[cls] += value == 1u ? 1 : 0;
}

// One receiver row's plan, from its table and its own message (value and
// natural class). The own key, recv, has class 0, PRF field 0 and sender
// field recv whatever the sender's silence or bias: it leaves its natural
// class and joins class 0. With k = n - f:
//   cross = 0: k < m0, the k smallest of class 0 (own included) are selected;
//   cross = 1: class 0 whole, then the kp = k - m0 smallest of class 1;
//   cross = 2: every live key is selected, no PRF word is needed.
// c0, c1 start with the own value and the classes below the crossing class.
// Only a row with kp > 0 hashes (kp = 0 under cross = 1 when k == m0).
struct RowPlan {
  int cross, kp, c0, c1;
};

BRC_HD RowPlan row_plan(const ClassTable& t, uint32_t own_value,
                        uint32_t own_class, int k) {
  const int in0 = own_class == 0u ? 1 : 0, in1 = own_class == 1u ? 1 : 0;
  const int own0 = own_value == 0u ? 1 : 0, own1 = own_value == 1u ? 1 : 0;
  const int m0 = t.m[0] - in0 + 1, m1 = t.m[1] - in1;
  RowPlan r{2, 0, own0, own1};
  if (k < m0) {
    r.cross = 0;
    r.kp = k;
    return r;
  }
  r.c0 += t.v0[0] - in0 * own0;
  r.c1 += t.v1[0] - in0 * own1;
  if (k < m0 + m1) {
    r.cross = 1;
    r.kp = k - m0;
    return r;
  }
  r.c0 += t.v0[1] - in1 * own0;
  r.c1 += t.v1[1] - in1 * own1;
  return r;
}

// An entry of a row's crossing-class list: value(2) | prf(20) | sender(10)
// under v1, value(2) | prf(18) | sender(12) under v2. The low 30 bits are
// the key inside the class. The own message's entry has key recv and value
// field 3, so the tally skips it (its value is counted once, by row_plan).
template <int PACK = 1>
BRC_HD uint32_t list_entry(uint32_t value, uint32_t sched, uint32_t send) {
  constexpr int kLow = kKeyLowOf<PACK>;
  return (value << 30) | ((sched >> (32 - (30 - kLow))) << kLow) | send;
}
BRC_HD uint32_t own_entry(uint32_t recv) { return (3u << 30) | recv; }
BRC_HD uint32_t entry_key(uint32_t e) { return e & 0x3FFFFFFFu; }
BRC_HD uint32_t entry_value(uint32_t e) { return e >> 30; }

// The histogram select: 256 bins on the PRF field's top 8 bits (the key's
// bits 22-29 under both laws). Under v1 a bin word is a u32 that packs
// count(11) | value-0 count(10) << 11 | value-1 count(10) << 21, so a sum of
// bin words is the packed sum of the fields: a list holds at most n <= 1024
// entries, of which at most 1023 have a value 0 or 1 (the own entry has
// neither), so no field carries into the next. Under v2 a list holds up to
// 4096 entries, which the three fields cannot share in 32 bits: the word is
// a u64 of three 16-bit fields (BinLaw<2>).
constexpr int kBinBits = 8;
constexpr int kBins = 1 << kBinBits;
constexpr int kBinsPerLane = kBins / 32;
constexpr int kBinLow = 30 - kBinBits;

BRC_HD uint32_t entry_bin(uint32_t e) { return (e >> kBinLow) & (kBins - 1); }
BRC_HD uint32_t bin_word(uint32_t e) {
  const uint32_t v = entry_value(e);
  return 1u | (v == 0u ? 1u << 11 : 0u) | (v == 1u ? 1u << 21 : 0u);
}
BRC_HD int bin_count(uint32_t w) { return (int)(w & 0x7FFu); }
BRC_HD int bin_v0(uint32_t w) { return (int)((w >> 11) & 0x3FFu); }
BRC_HD int bin_v1(uint32_t w) { return (int)(w >> 21); }

// The bin word of each law: BinLaw<1> is the u32 above, BinLaw<2> a u64 of
// count | value-0 count << 16 | value-1 count << 32.
template <int PACK>
struct BinLaw {
  using Word = uint32_t;
  static BRC_HD Word word(uint32_t e) { return bin_word(e); }
  static BRC_HD int count(Word w) { return bin_count(w); }
  static BRC_HD int v0(Word w) { return bin_v0(w); }
  static BRC_HD int v1(Word w) { return bin_v1(w); }
};
template <>
struct BinLaw<2> {
  using Word = unsigned long long;
  static BRC_HD Word word(uint32_t e) {
    const uint32_t v = entry_value(e);
    return 1ull | (v == 0u ? 1ull << 16 : 0ull) | (v == 1u ? 1ull << 32 : 0ull);
  }
  static BRC_HD int count(Word w) { return (int)(w & 0xFFFFull); }
  static BRC_HD int v0(Word w) { return (int)((w >> 16) & 0xFFFFull); }
  static BRC_HD int v1(Word w) { return (int)((w >> 32) & 0xFFFFull); }
};

// A lane's slice of kBinsPerLane bins, with `before` the packed sum of every
// bin below the slice: the slice's bin that holds the kp-th smallest key
// (kBinsPerLane if none does), with in *below the packed sum of the bins
// below it and in *word its own bin word.
template <int PACK = 1, typename Word = typename BinLaw<PACK>::Word>
BRC_HD int crossing_bin(const Word* w, Word before, int kp, Word* below, Word* word) {
  int bin = kBinsPerLane;
  Word acc = before;
#pragma unroll
  for (int j = 0; j < kBinsPerLane; ++j) {
    if (bin == kBinsPerLane && BinLaw<PACK>::count(acc + w[j]) >= kp) {
      bin = j;
      *below = acc;
      *word = w[j];
    }
    acc += w[j];
  }
  return bin;
}

// The exact finish inside the crossing bin, which holds kpp = kp - (keys
// below it) selected keys. Up to kFinishSlots keys are ranked directly (rank
// = keys of the bin smaller than this one; keys are distinct); a fuller bin
// runs the MSB-first search for the kpp-th smallest key over the bits below
// the bin (search_cand, search_step, from the bin's first key).
constexpr int kFinishSlots = 32;

BRC_HD uint32_t search_start(uint32_t bin) { return bin << kBinLow; }
BRC_HD uint32_t search_cand(uint32_t T, int b) { return T | ((1u << b) - 1u); }
BRC_HD uint32_t search_step(uint32_t T, int b, int cnt, int k) {
  return cnt >= k ? T : T | (1u << b);
}

}  // namespace brc
