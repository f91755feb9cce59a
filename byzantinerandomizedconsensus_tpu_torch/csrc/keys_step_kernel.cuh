// The keys step kernel's template and launch (keys_step.cu says what it
// computes and how): one instantiation per (packing law, Ben-Or's
// equivocation). keys_step.cu instantiates law v1 without equivocation, the
// config-5 kernel, alone in its module; keys_step_wide.cu the other three.
// A module that holds more kernels calling the same inline functions
// compiles the v1 kernel's PRF word with its ORs in another order (a
// different SASS), so the two stay apart.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "keys_step.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 8;
constexpr int kMaxN = 4096;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Dynamic shared memory of a CTA at n senders under law PACK: per warp a
// histogram, the finish slots and a list of n entries (u32); the class
// lists, two tables of two classes of n entries (u16); the values and
// silences (u8).
template <int PACK>
size_t smem_bytes(int n) {
  return (size_t)kWarps * (brc::kBins * sizeof(typename brc::BinLaw<PACK>::Word) +
                           (brc::kFinishSlots + n) * 4) +
         (size_t)4 * n * 2 + (size_t)2 * n;
}

template <int PACK, bool EQUIV>
__global__ void __launch_bounds__(kThreads)
keys_step_kernel(const int32_t* __restrict__ inst_ids,
                 const uint8_t* __restrict__ values,
                 const uint8_t* __restrict__ silent,
                 const uint8_t* __restrict__ faulty,
                 int32_t* __restrict__ c0_out, int32_t* __restrict__ c1_out,
                 brc::StepParams p, int groups, int recv_offset, int n_recv) {
  using Bins = brc::BinLaw<PACK>;
  using Word = typename Bins::Word;
  constexpr int kLow = brc::kKeyLowOf<PACK>;
  constexpr uint32_t kSendMask = (1u << kLow) - 1u;
  extern __shared__ uint4 smem[];
  __shared__ brc::ClassTable s_tab[2];
  __shared__ int s_honest[2];
  const int n = p.n;
  Word* s_hist = reinterpret_cast<Word*>(smem);
  uint32_t* s_slots = reinterpret_cast<uint32_t*>(s_hist + kWarps * brc::kBins);
  uint32_t* s_list = s_slots + kWarps * brc::kFinishSlots;
  uint16_t* s_class = reinterpret_cast<uint16_t*>(s_list + kWarps * n);
  uint8_t* s_val = reinterpret_cast<uint8_t*>(s_class + 4 * n);
  uint8_t* s_sil = s_val + n;

  const int b = blockIdx.x / groups;
  const int g = blockIdx.x - b * groups;
  const size_t row = (size_t)b * n;
  const size_t out_row = (size_t)b * n_recv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;

  if (threadIdx.x < 2) {
    s_tab[threadIdx.x] = brc::ClassTable{{0, 0}, {0, 0}, {0, 0}};
    s_honest[threadIdx.x] = 0;
  }
  for (int i = threadIdx.x; i < kWarps * brc::kBins; i += kThreads) s_hist[i] = 0u;
  int h0 = 0, h1 = 0;
  for (int s = threadIdx.x; s < n; s += kThreads) {
    const uint8_t v = values[row + s];
    if constexpr (EQUIV)
      s_val[s] = faulty[row + s] ? (uint8_t)brc::kEquivocates : v;
    else
      s_val[s] = v;
    s_sil[s] = silent[row + s];
    if (p.adversary == brc::kAdvAdaptiveMin && !faulty[row + s]) {
      h0 += v == 0 ? 1 : 0;
      h1 += v == 1 ? 1 : 0;
    }
  }
  __syncthreads();
  if (p.adversary == brc::kAdvAdaptiveMin) {
    h0 = __reduce_add_sync(kFull, h0);
    h1 = __reduce_add_sync(kFull, h1);
    if (lane == 0) {
      atomicAdd(&s_honest[0], h0);
      atomicAdd(&s_honest[1], h1);
    }
    __syncthreads();
  }
  const uint32_t minority = brc::minority_of(s_honest[0], s_honest[1]);

  // The class tables and the live classes' sender lists, in any order: the
  // selection orders by key, not by list position.
  for (int t = 0; t < brc::table_count(p); ++t) {
    const uint32_t pref = brc::table_pref(p, t, minority);
    for (int base = warp * 32; base < n; base += kThreads) {
      const int s = base + lane;
      const uint32_t v = s < n ? s_val[s] : 2u;
      const uint32_t cls = s < n ? brc::key_class(p, v, s_sil[s] != 0, pref) : 3u;
#pragma unroll
      for (uint32_t x = 0; x < 2; ++x) {
        const unsigned in = __ballot_sync(kFull, cls == x);
        const unsigned z = __ballot_sync(kFull, cls == x && v == 0u);
        const unsigned o = __ballot_sync(kFull, cls == x && v == 1u);
        int at = 0;
        if (lane == 0 && in) {
          at = atomicAdd(&s_tab[t].m[x], __popc(in));
          atomicAdd(&s_tab[t].v0[x], __popc(z));
          atomicAdd(&s_tab[t].v1[x], __popc(o));
        }
        at = __shfl_sync(kFull, at, 0);
        if (cls == x)
          s_class[(t * 2 + x) * n + at + __popc(in & lower)] = (uint16_t)(v << kLow | s);
      }
    }
  }
  __syncthreads();

  Word* hist = s_hist + warp * brc::kBins;
  uint32_t* slots = s_slots + warp * brc::kFinishSlots;
  uint32_t* list = s_list + warp * n;
  const uint32_t inst = (uint32_t)inst_ids[b];
  const int k = n - p.f;
  const int r_end = min(n_recv, (g + 1) * kRows);
  for (int r = g * kRows + warp; r < r_end; r += kWarps) {
    // The row's global receiver: the own message, the PRF word's receiver
    // field, the send != recv exclusion and the equivocation read it; the
    // local row r indexes the (B, n_recv) outputs.
    const uint32_t recv = (uint32_t)(recv_offset + r);
    const int t = brc::table_of(p, recv);
    const brc::ClassTable tab = s_tab[t];
    const uint32_t own = s_val[recv];
    const brc::RowPlan plan = brc::row_plan(
        tab, own, brc::key_class(p, own, s_sil[recv] != 0, brc::table_pref(p, t, minority)), k);
    int c0 = plan.c0, c1 = plan.c1;
    if constexpr (EQUIV) {
      // The own value a faulty receiver shows itself, then the faulty
      // members of the classes below the crossing class, which the row
      // delivers whole (both live classes when every live key fits).
      if (own == brc::kEquivocates && lane == 0) {
        const uint32_t x = brc::equivocation_value<PACK>(p, inst, recv, recv);
        c0 += x == 0u ? 1 : 0;
        c1 += x == 1u ? 1 : 0;
      }
      int e0 = 0, e1 = 0;
      for (int x = 0; x < plan.cross && x < 2; ++x) {
        const uint16_t* members = s_class + x * n;
        for (int i = lane; i < tab.m[x]; i += 32) {
          const uint32_t e = members[i];
          const uint32_t send = e & kSendMask;
          if ((e >> kLow) != brc::kEquivocates || send == recv) continue;
          const uint32_t y = brc::equivocation_value<PACK>(p, inst, recv, send);
          e0 += y == 0u ? 1 : 0;
          e1 += y == 1u ? 1 : 0;
        }
      }
      c0 += __reduce_add_sync(kFull, e0);
      c1 += __reduce_add_sync(kFull, e1);
    }
    if (plan.kp > 0) {
      // 2. Hash the crossing class into the warp's list and histogram.
      const uint16_t* members = s_class + (t * 2 + plan.cross) * n;
      const int len = tab.m[plan.cross];
      int m = 0;
      for (int base = 0; base < len; base += 32) {
        const int i = base + lane;
        const uint32_t e = i < len ? members[i] : 0u;
        const uint32_t send = e & kSendMask;
        const bool keep = i < len && send != recv;
        const unsigned bal = __ballot_sync(kFull, keep);
        if (keep) {
          uint32_t value = e >> kLow;
          if constexpr (EQUIV) {
            if (value == brc::kEquivocates)
              value = brc::equivocation_value<PACK>(p, inst, recv, send);
          }
          const uint32_t w = brc::list_entry<PACK>(
              value, brc::prf<PACK>(p.k0, p.k1, inst, p.rnd, p.step, recv, send, brc::kSched),
              send);
          list[m + __popc(bal & lower)] = w;
          atomicAdd(&hist[brc::entry_bin(w)], Bins::word(w));
        }
        m += __popc(bal);
      }
      if (plan.cross == 0) {
        if (lane == 0) {
          const uint32_t w = brc::own_entry(recv);
          list[m] = w;
          atomicAdd(&hist[brc::entry_bin(w)], Bins::word(w));
        }
        m += 1;
      }
      __syncwarp();

      // 3. The crossing bin: a warp scan of the packed bin words.
      Word w[brc::kBinsPerLane];
      constexpr int kVecs = brc::kBinsPerLane * (int)sizeof(Word) / 16;
      uint4* mine = reinterpret_cast<uint4*>(hist + lane * brc::kBinsPerLane);
      if constexpr (PACK == 1) {
#pragma unroll
        for (int q = 0; q < brc::kBinsPerLane / 4; ++q) {
          const uint4 x = mine[q];
          w[4 * q] = x.x;
          w[4 * q + 1] = x.y;
          w[4 * q + 2] = x.z;
          w[4 * q + 3] = x.w;
          mine[q] = make_uint4(0u, 0u, 0u, 0u);  // clear for the next row
        }
      } else {
#pragma unroll
        for (int q = 0; q < kVecs; ++q) {
          const uint4 x = mine[q];
          w[2 * q] = (Word)x.x | (Word)x.y << 32;
          w[2 * q + 1] = (Word)x.z | (Word)x.w << 32;
          mine[q] = make_uint4(0u, 0u, 0u, 0u);  // clear for the next row
        }
      }
      Word incl = 0u;
#pragma unroll
      for (int j = 0; j < brc::kBinsPerLane; ++j) incl += w[j];
      const Word local = incl;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const Word up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      Word below = 0u, word = 0u;
      const int j = brc::crossing_bin<PACK>(w, incl - local, plan.kp, &below, &word);
      const int owner = __ffs(__ballot_sync(kFull, j < brc::kBinsPerLane)) - 1;
      const uint32_t bstar = __shfl_sync(kFull, (uint32_t)(lane * brc::kBinsPerLane + j), owner);
      below = __shfl_sync(kFull, below, owner);
      word = __shfl_sync(kFull, word, owner);
      c0 += Bins::v0(below);
      c1 += Bins::v1(below);
      const int kpp = plan.kp - Bins::count(below);
      const int cbin = Bins::count(word);

      // 4. The exact finish inside the crossing bin.
      if (cbin <= brc::kFinishSlots) {
        int slot = 0;
        for (int base = 0; base < m; base += 32) {
          const int i = base + lane;
          const uint32_t e = i < m ? list[i] : 0u;
          const bool cand = i < m && brc::entry_bin(e) == bstar;
          const unsigned bal = __ballot_sync(kFull, cand);
          if (cand) slots[slot + __popc(bal & lower)] = e;
          slot += __popc(bal);
        }
        __syncwarp();
        const uint32_t e = lane < cbin ? slots[lane] : 0u;
        int rank = 0;
        for (int q = 0; q < cbin; ++q)
          rank += brc::entry_key(__shfl_sync(kFull, e, q)) < brc::entry_key(e) ? 1 : 0;
        const bool sel = lane < cbin && rank < kpp;
        c0 += __popc(__ballot_sync(kFull, sel && brc::entry_value(e) == 0u));
        c1 += __popc(__ballot_sync(kFull, sel && brc::entry_value(e) == 1u));
      } else {
        uint32_t T = brc::search_start(bstar);
        for (int bit = brc::kBinLow - 1; bit >= 0; --bit) {
          const uint32_t cand = brc::search_cand(T, bit);
          int cnt = 0;
          for (int i = lane; i < m; i += 32)
            cnt += brc::entry_bin(list[i]) == bstar && brc::entry_key(list[i]) <= cand ? 1 : 0;
          T = brc::search_step(T, bit, __reduce_add_sync(kFull, cnt), kpp);
        }
        int s0 = 0, s1 = 0;
        for (int i = lane; i < m; i += 32) {
          const uint32_t e = list[i];
          const bool sel = brc::entry_bin(e) == bstar && brc::entry_key(e) <= T;
          s0 += sel && brc::entry_value(e) == 0u ? 1 : 0;
          s1 += sel && brc::entry_value(e) == 1u ? 1 : 0;
        }
        c0 += __reduce_add_sync(kFull, s0);
        c1 += __reduce_add_sync(kFull, s1);
      }
      __syncwarp();  // the list and the slots are rewritten by the next row
    }
    if (lane == 0) {
      c0_out[out_row + r] = c0;
      c1_out[out_row + r] = c1;
    }
  }
}

// One step for B instances over the receivers recv_offset .. recv_offset +
// n_recv - 1 (a replica shard; 0 and n for all of them).
template <int PACK, bool EQUIV>
int launch(const int32_t* inst_ids, const uint8_t* values, const uint8_t* silent,
           const uint8_t* faulty, int32_t* c0, int32_t* c1, int B, const brc::StepParams& p,
           int recv_offset, int n_recv, cudaStream_t stream) {
  const size_t smem = smem_bytes<PACK>(p.n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        keys_step_kernel<PACK, EQUIV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (n_recv + kRows - 1) / kRows;
  keys_step_kernel<PACK, EQUIV><<<B * groups, kThreads, smem, stream>>>(
      inst_ids, values, silent, faulty, c0, c1, p, groups, recv_offset, n_recv);
  return (int)cudaGetLastError();
}

}  // namespace
