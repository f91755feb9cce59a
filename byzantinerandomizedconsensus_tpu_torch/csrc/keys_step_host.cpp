// Host build of the keys step kernel's per-lane arithmetic, for the CPU tests:
// g++ compiles keys_step.cuh behind this extern "C" shim
// (ops/_build.py::load_host), and tests/test_torch_kernel_host.py holds it
// against the port's plain torch version, the reference and an argsort.
//
// brc_host_keys_step runs the kernel's work in the kernel's order: per
// instance the minority and the class tables, per receiver row the plan, the
// hashing of the crossing class only, the histogram select and the exact
// finish (host_select), with each warp reduction, scan and ballot written as
// a loop over the lanes or the list in order; under packing law v2 (n >
// 1024) with the v2 key fields and bin words, under Ben-Or's Byzantine
// pairing with its per-row values; brc_host_keys_step_shard over a receiver
// range (the kernel's recv_offset and n_recv). brc_deliver_row drives the same row work
// on a row given as top fields (v1).
#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "keys_step.cuh"

namespace {

// Steps 3 and 4 of the kernel on a row's crossing-class list of m entries:
// adds the selected entries' value-0 and value-1 counts to *c0, *c1, and
// when sel is not null marks each entry selected or not.
template <int PACK = 1>
void host_select(const uint32_t* list, int m, int kp, int* c0, int* c1,
                 uint8_t* sel) {
  using Bins = brc::BinLaw<PACK>;
  using Word = typename Bins::Word;
  Word hist[brc::kBins] = {};
  for (int i = 0; i < m; ++i) hist[brc::entry_bin(list[i])] += Bins::word(list[i]);
  // The warp scan: the first lane whose slice holds the crossing bin.
  Word before = 0u, below = 0u, word = 0u;
  uint32_t bstar = 0u;
  for (int lane = 0; lane < 32; ++lane) {
    const Word* w = hist + lane * brc::kBinsPerLane;
    const int j = brc::crossing_bin<PACK>(w, before, kp, &below, &word);
    if (j < brc::kBinsPerLane) {
      bstar = (uint32_t)(lane * brc::kBinsPerLane + j);
      break;
    }
    for (int q = 0; q < brc::kBinsPerLane; ++q) before += w[q];
  }
  *c0 += Bins::v0(below);
  *c1 += Bins::v1(below);
  const int kpp = kp - Bins::count(below);
  const int cbin = Bins::count(word);
  if (sel)
    for (int i = 0; i < m; ++i) sel[i] = brc::entry_bin(list[i]) < bstar ? 1 : 0;
  if (cbin <= brc::kFinishSlots) {
    uint32_t slots[brc::kFinishSlots];
    int at[brc::kFinishSlots];
    int c = 0;
    for (int i = 0; i < m; ++i) {
      if (brc::entry_bin(list[i]) == bstar) {
        at[c] = i;
        slots[c++] = list[i];
      }
    }
    for (int a = 0; a < c; ++a) {
      int rank = 0;
      for (int q = 0; q < c; ++q)
        rank += brc::entry_key(slots[q]) < brc::entry_key(slots[a]) ? 1 : 0;
      const bool s = rank < kpp;
      *c0 += s && brc::entry_value(slots[a]) == 0u ? 1 : 0;
      *c1 += s && brc::entry_value(slots[a]) == 1u ? 1 : 0;
      if (sel) sel[at[a]] = s ? 1 : 0;
    }
  } else {
    uint32_t T = brc::search_start(bstar);
    for (int bit = brc::kBinLow - 1; bit >= 0; --bit) {
      const uint32_t cand = brc::search_cand(T, bit);
      int cnt = 0;
      for (int i = 0; i < m; ++i)
        cnt += brc::entry_bin(list[i]) == bstar && brc::entry_key(list[i]) <= cand ? 1 : 0;
      T = brc::search_step(T, bit, cnt, kpp);
    }
    for (int i = 0; i < m; ++i) {
      if (brc::entry_bin(list[i]) != bstar) continue;
      const bool s = brc::entry_key(list[i]) <= T;
      *c0 += s && brc::entry_value(list[i]) == 0u ? 1 : 0;
      *c1 += s && brc::entry_value(list[i]) == 1u ? 1 : 0;
      if (sel) sel[i] = s ? 1 : 0;
    }
  }
}

// One receiver row after its plan: the crossing class's entries, members of
// class plan.cross other than recv in sender order, made by entry(s), then
// the own entry under cross 0; then host_select. Returns the PRF words made
// (the members hashed); *c0, *c1 end as the row's counts, and deliv (when
// not null) as the delivered flag of every sender.
template <int PACK = 1, typename Entry>
int host_row(const brc::RowPlan& plan, const uint32_t* cls, int n, uint32_t recv,
             Entry entry, std::vector<uint32_t>& list, int* c0, int* c1,
             uint8_t* deliv) {
  *c0 = plan.c0;
  *c1 = plan.c1;
  if (deliv)
    for (int s = 0; s < n; ++s)
      deliv[s] = (uint32_t)s == recv || (int)cls[s] < plan.cross ? 1 : 0;
  if (plan.kp == 0) return 0;
  list.clear();
  std::vector<int> who;
  for (int s = 0; s < n; ++s) {
    if ((int)cls[s] != plan.cross || (uint32_t)s == recv) continue;
    list.push_back(entry((uint32_t)s));
    who.push_back(s);
  }
  const int hashed = (int)list.size();
  if (plan.cross == 0) {
    list.push_back(brc::own_entry(recv));
    who.push_back((int)recv);
  }
  std::vector<uint8_t> sel(list.size());
  host_select<PACK>(list.data(), (int)list.size(), plan.kp, c0, c1, sel.data());
  if (deliv)
    for (size_t i = 0; i < list.size(); ++i)
      if ((uint32_t)who[i] != recv) deliv[who[i]] = sel[i];
  return hashed;
}

}  // namespace

extern "C" {

uint32_t brc_combined_key(uint32_t k0, uint32_t k1, int n, int rnd, int step,
                          int adversary, uint32_t inst, uint32_t recv,
                          uint32_t send, uint32_t value, int silent,
                          uint32_t minority) {
  const brc::StepParams p{k0, k1, n, 0, (uint32_t)rnd, (uint32_t)step, adversary};
  if (n > 1024) return brc::combined_key<2>(p, inst, recv, send, value, silent != 0, minority);
  return brc::combined_key<1>(p, inst, recv, send, value, silent != 0, minority);
}

uint32_t brc_equivocation_value(uint32_t k0, uint32_t k1, int n, int rnd, int step,
                                uint32_t inst, uint32_t recv, uint32_t send) {
  const brc::StepParams p{k0, k1, n, 0, (uint32_t)rnd, (uint32_t)step, brc::kAdvNone};
  if (n > 1024) return brc::equivocation_value<2>(p, inst, recv, send);
  return brc::equivocation_value<1>(p, inst, recv, send);
}

// The kernel's row on one row of n natural top fields (class(2) | prf(20) of
// each sender as if it were not the receiver; top[recv] gives the own
// sender's natural class) and wire values: deliv[s] the delivered flags,
// out[0], out[1] the counts c0, c1. Returns the PRF words the row needs.
int brc_deliver_row(const uint32_t* top, const uint8_t* values, int n,
                    int recv, int k, uint8_t* deliv, int32_t* out) {
  brc::ClassTable tab{{0, 0}, {0, 0}, {0, 0}};
  std::vector<uint32_t> cls(n);
  for (int s = 0; s < n; ++s) {
    cls[s] = top[s] >> brc::kKeyPrf;
    brc::class_add(tab, cls[s], values[s]);
  }
  const brc::RowPlan plan = brc::row_plan(tab, values[recv], cls[recv], k);
  const uint32_t prf_mask = (1u << brc::kKeyPrf) - 1u;
  std::vector<uint32_t> list;
  int c0, c1;
  const int hashed = host_row(
      plan, cls.data(), n, (uint32_t)recv,
      [&](uint32_t s) {
        return brc::list_entry(values[s], (top[s] & prf_mask) << (32 - brc::kKeyPrf), s);
      },
      list, &c0, &c1, deliv);
  out[0] = c0;
  out[1] = c1;
  return hashed;
}

}  // extern "C"

namespace {

// One step for B instances under law PACK, as the kernel computes it (EQUIV:
// Ben-Or's Byzantine pairing). Returns the PRF words computed: the
// crossing-class pairs of every row, and under EQUIV the values of the
// faulty senders each row hashes.
template <int PACK, bool EQUIV>
long long host_keys_step(const int32_t* inst_ids, const uint8_t* values,
                         const uint8_t* silent, const uint8_t* faulty, int32_t* c0_out,
                         int32_t* c1_out, int B, const brc::StepParams& p,
                         int recv_offset, int n_recv) {
  const int n = p.n, f = p.f;
  const int tables = brc::table_count(p);
  std::vector<uint32_t> cls(2 * (size_t)n), list;
  std::vector<uint8_t> val(n);
  long long hashed = 0;
  for (int b = 0; b < B; ++b) {
    const uint8_t* wire = values + (size_t)b * n;
    const uint8_t* sil = silent + (size_t)b * n;
    const uint8_t* fa = faulty + (size_t)b * n;
    const uint32_t inst = (uint32_t)inst_ids[b];
    for (int s = 0; s < n; ++s) val[s] = EQUIV && fa[s] ? (uint8_t)brc::kEquivocates : wire[s];
    int h0 = 0, h1 = 0;
    if (p.adversary == brc::kAdvAdaptiveMin) {
      for (int s = 0; s < n; ++s) {
        if (!fa[s]) {
          h0 += wire[s] == 0 ? 1 : 0;
          h1 += wire[s] == 1 ? 1 : 0;
        }
      }
    }
    const uint32_t minority = brc::minority_of(h0, h1);
    brc::ClassTable tab[2] = {};
    for (int t = 0; t < tables; ++t) {
      const uint32_t pref = brc::table_pref(p, t, minority);
      for (int s = 0; s < n; ++s) {
        cls[(size_t)t * n + s] = brc::key_class(p, val[s], sil[s] != 0, pref);
        brc::class_add(tab[t], cls[(size_t)t * n + s], val[s]);
      }
    }
    for (int recv = recv_offset; recv < recv_offset + n_recv; ++recv) {
      const uint32_t r = (uint32_t)recv;
      const int t = brc::table_of(p, r);
      const uint32_t* tc = cls.data() + (size_t)t * n;
      const brc::RowPlan plan = brc::row_plan(tab[t], val[recv], tc[recv], n - f);
      auto value = [&](uint32_t s) -> uint32_t {
        if (EQUIV && val[s] == brc::kEquivocates) {
          ++hashed;
          return brc::equivocation_value<PACK>(p, inst, r, s);
        }
        return val[s];
      };
      int c0, c1, e0 = 0, e1 = 0;
      if (EQUIV) {
        if (val[recv] == brc::kEquivocates) {
          const uint32_t x = value(r);
          e0 += x == 0u ? 1 : 0;
          e1 += x == 1u ? 1 : 0;
        }
        for (int s = 0; s < n; ++s) {
          if (s == recv || (int)tc[s] >= plan.cross || tc[s] > 1u) continue;
          if (val[s] != brc::kEquivocates) continue;
          const uint32_t y = value((uint32_t)s);
          e0 += y == 0u ? 1 : 0;
          e1 += y == 1u ? 1 : 0;
        }
      }
      hashed += host_row<PACK>(
          plan, tc, n, r,
          [&](uint32_t s) {
            const uint32_t v = value(s);
            return brc::list_entry<PACK>(
                v, brc::prf<PACK>(p.k0, p.k1, inst, p.rnd, p.step, r, s, brc::kSched), s);
          },
          list, &c0, &c1, nullptr);
      c0_out[(size_t)b * n_recv + (recv - recv_offset)] = c0 + e0;
      c1_out[(size_t)b * n_recv + (recv - recv_offset)] = c1 + e1;
    }
  }
  return hashed;
}

}  // namespace

extern "C" {

// One step for B instances, as the kernel computes it, under the kernel's
// adversary codes (kAdvTwoFaced: Ben-Or's Byzantine pairing) and the
// packing law of n, over the receivers recv_offset .. recv_offset + n_recv
// - 1 (c0_out, c1_out (B, n_recv)). Returns the PRF words computed
// (host_keys_step).
long long brc_host_keys_step_shard(const int32_t* inst_ids, const uint8_t* values,
                                   const uint8_t* silent, const uint8_t* faulty,
                                   int32_t* c0_out, int32_t* c1_out, int B, int n, int f,
                                   int rnd, int step, int adversary, uint32_t k0,
                                   uint32_t k1, int recv_offset, int n_recv) {
  const bool equiv = adversary == brc::kAdvTwoFaced;
  const brc::StepParams p{k0, k1, n, f, (uint32_t)rnd, (uint32_t)step,
                          equiv ? brc::kAdvNone : adversary};
  const int o = recv_offset, r = n_recv;
  if (n <= 1024)
    return equiv ? host_keys_step<1, true>(inst_ids, values, silent, faulty, c0_out,
                                           c1_out, B, p, o, r)
                 : host_keys_step<1, false>(inst_ids, values, silent, faulty, c0_out,
                                            c1_out, B, p, o, r);
  return equiv ? host_keys_step<2, true>(inst_ids, values, silent, faulty, c0_out, c1_out,
                                         B, p, o, r)
               : host_keys_step<2, false>(inst_ids, values, silent, faulty, c0_out,
                                          c1_out, B, p, o, r);
}

// The same over every receiver (c0_out, c1_out (B, n)).
long long brc_host_keys_step(const int32_t* inst_ids, const uint8_t* values,
                             const uint8_t* silent, const uint8_t* faulty,
                             int32_t* c0_out, int32_t* c1_out, int B, int n,
                             int f, int rnd, int step, int adversary,
                             uint32_t k0, uint32_t k1) {
  return brc_host_keys_step_shard(inst_ids, values, silent, faulty, c0_out, c1_out, B, n,
                                  f, rnd, step, adversary, k0, k1, 0, n);
}

}  // extern "C"
